"""Reconstruction data model (numpy), synthetic scenes and triangulation
with known poses."""

from .model import Image, Point3D, Reconstruction  # noqa: F401
from .synthetic import synthetic_reconstruction  # noqa: F401
from .triangulation import (triangulate_reconstruction,  # noqa: F401
                            triangulate_tracks)
