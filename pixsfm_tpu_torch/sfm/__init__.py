"""Reconstruction data model (numpy) and synthetic scenes."""

from .model import Image, Point3D, Reconstruction  # noqa: F401
from .synthetic import synthetic_reconstruction  # noqa: F401
