"""Batched Jacobi-preconditioned CG on dense SPD systems (kernel K2).

Counterpart of ``pixsfm_tpu/ops/cg_pallas.py`` (``pcg_solve_pallas``) and of
the XLA CG scan in ``pixsfm_tpu/ops/lm.py:150-229``, which is the JAX default
path. On a CUDA tensor :func:`pcg_solve` launches ``kernels/csrc/pcg.cu``;
on a CPU tensor it runs :func:`pcg_solve_plain`, the scan written out in
PyTorch. A CUDA tensor never takes the plain path: a kernel that fails to
build or launch, or a system too large for one block's shared memory,
raises. The kernel has a register variant (N a multiple of 4 up to 128,
the system in registers) and a general one (any N that fits one block's
shared memory); the C entry point chooses, :func:`kernel_variant` reports
its choice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["pcg_solve", "pcg_solve_plain", "jacobi_inverse", "kernel_variant",
           "launches"]

# Number of kernel launches since the last reset (set it to 0 to reset).
launches = 0


def jacobi_inverse(H, damp: Optional[torch.Tensor]):
    """1 / max(diag(H) + damp, 1e-12) (``lm.py:186-190``)."""
    d = torch.diagonal(H, dim1=1, dim2=2)
    if damp is not None:
        d = d + damp
    return 1.0 / torch.clamp(d, min=1e-12)


def pcg_solve_plain(H, g, iters: int, damp: Optional[torch.Tensor] = None,
                    prec=None):
    """Solve ``(H + diag(damp)) dx = -g`` by ``iters`` Jacobi-PCG steps from
    zero, on any device. ``damp=None`` means ``H`` is already damped.
    ``prec(v)`` replaces the Jacobi preconditioner (``ops/lm.py``'s
    block-Jacobi)."""
    if prec is None:
        dinv = jacobi_inverse(H, damp)

        def prec(v):
            return dinv * v

    def mv(v):
        Av = torch.einsum("pij,pj->pi", H, v)
        return Av if damp is None else Av + damp * v

    x = torch.zeros_like(g)
    r = -g
    z = prec(r)
    p = z
    rz = torch.sum(r * z, dim=1)
    for _ in range(int(iters)):
        Ap = mv(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap, dim=1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = prec(r)
        rz_new = torch.sum(r * z, dim=1)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def _lib():
    from .. import kernels
    lib = kernels.load("pcg")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pixsfm_pcg.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.pixsfm_pcg_max_n.argtypes = []
        lib.pixsfm_pcg_variant.argtypes = [i]
        for f in (lib.pixsfm_pcg, lib.pixsfm_pcg_max_n,
                  lib.pixsfm_pcg_variant):
            f.restype = i
        lib._typed = True
    return lib


VARIANTS = ("register", "general")


def kernel_variant(N: int) -> str:
    """The variant the C entry point takes for systems of N unknowns on a
    16-byte aligned H (as torch allocates it): ``register`` (N a multiple
    of 4 up to 128: H in registers, a float4 of 16 rows per lane) or
    ``general`` (every other N, H in shared memory; a misaligned H takes it
    too)."""
    return VARIANTS[_lib().pixsfm_pcg_variant(int(N))]


def pcg_solve(H, g, iters: int, damp: Optional[torch.Tensor] = None, *,
              variant: Optional[str] = None):
    """``dx [P, N]`` with ``(H + diag(damp)) dx ~= -g`` after ``iters``
    Jacobi-PCG steps. ``H [P, N, N]``, ``g/damp [P, N]``, float32.
    ``variant`` forces ``register`` or ``general`` on the card (for checks
    and timing); ``None`` is the C entry point's own choice."""
    global launches
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"pcg_solve: unknown variant {variant!r}")
    if not H.is_cuda:
        return pcg_solve_plain(H, g, iters, damp)
    P, N = g.shape
    if H.shape != (P, N, N):
        raise ValueError(f"pcg_solve: H must be [{P}, {N}, {N}], got "
                         f"{tuple(H.shape)}")
    lib = _lib()
    if N > lib.pixsfm_pcg_max_n():
        raise ValueError(f"pcg_solve: N={N} does not fit one block's shared "
                         f"memory (max {lib.pixsfm_pcg_max_n()})")
    dev = H.device
    tensors = [t.to(device=dev, dtype=torch.float32).contiguous()
               for t in (H, g)]
    if variant == "register" and (kernel_variant(N) != "register"
                                  or tensors[0].data_ptr() % 16):
        raise ValueError(f"pcg_solve: the register variant does not take "
                         f"N={N} or an H that is not 16-byte aligned")
    if damp is not None:
        damp = damp.to(device=dev, dtype=torch.float32).contiguous()
        if damp.shape != (P, N):
            raise ValueError("pcg_solve: damp must be [P, N]")
    dx = torch.empty((P, N), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pixsfm_pcg(tensors[0].data_ptr(),
                             None if damp is None else damp.data_ptr(),
                             tensors[1].data_ptr(), dx.data_ptr(), P, N,
                             int(iters),
                             -1 if variant is None
                             else VARIANTS.index(variant), stream)
    if err:
        raise RuntimeError(f"pcg_solve: kernel launch failed (cudaError {err})")
    launches += 1
    return dx
