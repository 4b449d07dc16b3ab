"""Batched LM and the CUDA kernels' wrappers (K1 interpolation, K2 PCG)."""
