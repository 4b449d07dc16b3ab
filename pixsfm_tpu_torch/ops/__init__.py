"""Batched LM and the CUDA kernels' wrappers (K1 interpolation, K2 PCG)."""

from .lm import LMOptions, LMSummary, lm_solve  # noqa: F401
