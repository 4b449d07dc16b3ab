"""Schur-complement kernels of the grid-regime CG Schur solve (K3a/b/c).

Counterpart of ``pixsfm_tpu/ops/schur_pallas.py``. The observation axis is
packed point-major (observation slot ``o = point * T + rank``) and repacked
by :func:`pack_grid_blocks` into ``Btr [T, 3*NR, Ppad]`` (NR = 6 + k rows of
each observation's W block, points on the minor axis) plus index rows
``[T, Ppad]`` and inverse point blocks ``[3, 3, Ppad]``. Three kernels read
that layout:

- :func:`schur_term_matvec` (K3a): ``(W V^-1 W^T) v`` into ``[6, I]`` pose
  and ``[k, Nc]`` camera planes, once per CG iteration;
- :func:`schur_rhs` (K3b): ``W V^-1 g_x`` into the same planes, once per
  Schur step;
- :func:`schur_backsub` (K3c): ``W^T`` (gathered rows of v) per point,
  ``[3, Ppad]``, once per Schur step.

On CUDA tensors each wrapper launches ``kernels/csrc/schur.cu``; on CPU
tensors it runs its plain PyTorch version (gathers, einsums,
``index_add_``). A CUDA tensor never takes the plain path: a kernel that
fails to build or launch raises. The JAX package gates its kernels on the
TPU backend and VMEM size (``schur_pallas.enabled``); the CUDA kernels take
any I, Nc and T, so the grid path always uses them. K3a and K3b each have a
fused variant (T <= 16, Btr read once, one kernel body for both) and one
for any T (K3a two-pass, K3b one-pass), with their tables in shared or
global memory; the C entry point chooses, :func:`matvec_variant` and
:func:`rhs_variant` report its choice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

__all__ = ["pack_grid_blocks", "schur_term_matvec", "schur_rhs",
           "schur_backsub", "schur_term_matvec_plain", "schur_rhs_plain",
           "schur_backsub_plain", "schur_term_matvec_ref", "matvec_variant",
           "rhs_variant", "launches", "DEFAULT_TILE"]

# Kernel launches since the last reset, per kernel (set an entry to 0 to
# reset it).
launches = {"matvec": 0, "rhs": 0, "backsub": 0}

# points per tile of the packed layout (the kernels' thread-block size)
DEFAULT_TILE = 128


def pack_grid_blocks(Bt, img_idx, cam_idx, Vinv_t, T: int,
                     tile: int = DEFAULT_TILE):
    """Repack the grid-ordered system for the kernels.

    ``Bt [NR*3, O]`` with obs slot ``o = point*T + rank`` -> ``Btr [T, NR*3,
    Ppad]`` (``Ppad = ceil(Np/tile)*tile``, zero-padded so tail points add
    exactly nothing); index rows ``[T, Ppad]`` int32; ``Vinv [3, 3, Ppad]``.
    Returns ``(Btr, img_r, cam_r, Vinv, Ppad)``."""
    R3, O = Bt.shape
    Np = O // T
    Ppad = -(-max(Np, 1) // tile) * tile
    if Ppad * T != O:
        Bt = torch.cat([Bt, Bt.new_zeros((R3, Ppad * T - O))], dim=1)
        img_idx = torch.cat([img_idx, img_idx.new_zeros(Ppad * T - O)])
        cam_idx = torch.cat([cam_idx, cam_idx.new_zeros(Ppad * T - O)])
    Btr = Bt.reshape(R3, Ppad, T).permute(2, 0, 1).contiguous()
    img_r = img_idx.reshape(Ppad, T).t().to(torch.int32).contiguous()
    cam_r = cam_idx.reshape(Ppad, T).t().to(torch.int32).contiguous()
    if Vinv_t.shape[2] != Ppad:
        Vinv_t = torch.cat([Vinv_t, Vinv_t.new_zeros(
            (3, 3, Ppad - Vinv_t.shape[2]))], dim=2)
    return Btr, img_r, cam_r, Vinv_t.contiguous(), Ppad


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device)
# ---------------------------------------------------------------------------

def _gather_rows(vpT, vcT, img_r, cam_r):
    """[T, P, NR] pose/camera rows of each observation."""
    return torch.cat([vpT.t()[img_r.long()], vcT.t()[cam_r.long()]], dim=-1)


def _scatter_rows(u, img_r, cam_r, I: int, Nc: int):
    """u [T, NR, P] summed into ([6, I], [k, Nc]) by image / camera slot."""
    T, NR, P = u.shape
    flat = u.permute(1, 0, 2).reshape(NR, T * P)
    up = u.new_zeros((6, I)).index_add_(1, img_r.long().reshape(-1), flat[:6])
    uc = u.new_zeros((NR - 6, Nc)).index_add_(1, cam_r.long().reshape(-1),
                                              flat[6:])
    return up, uc


def schur_term_matvec_plain(vpT, vcT, Btr, img_r, cam_r, Vinv_pad):
    """Plain version of K3a: ``(up [6, I], uc [k, Nc])``."""
    T, R3, P = Btr.shape
    b = Btr.reshape(T, R3 // 3, 3, P)
    t = torch.einsum("jacp,jpa->cp", b, _gather_rows(vpT, vcT, img_r, cam_r))
    w = torch.einsum("abp,bp->ap", Vinv_pad, t)
    u = torch.einsum("jacp,cp->jap", b, w)
    return _scatter_rows(u, img_r, cam_r, vpT.shape[1], vcT.shape[1])


def schur_rhs_plain(Btr, img_r, cam_r, Vinv_pad, gxt_pad, I: int, Nc: int):
    """Plain version of K3b: ``(up [6, I], uc [k, Nc])``."""
    T, R3, P = Btr.shape
    b = Btr.reshape(T, R3 // 3, 3, P)
    w = torch.einsum("abp,bp->ap", Vinv_pad, gxt_pad)
    u = torch.einsum("jacp,cp->jap", b, w)
    return _scatter_rows(u, img_r, cam_r, I, Nc)


def schur_backsub_plain(vpT, vcT, Btr, img_r, cam_r):
    """Plain version of K3c: ``t [3, Ppad]``."""
    T, R3, P = Btr.shape
    b = Btr.reshape(T, R3 // 3, 3, P)
    return torch.einsum("jacp,jpa->cp", b,
                        _gather_rows(vpT, vcT, img_r, cam_r))


def schur_term_matvec_ref(vpT, vcT, Btr, img_r, cam_r, Vinv_pad):
    """Oracle of K3a in the JAX package's form (``schur_pallas.py:317``):
    the same algebra with one-hot matmul reductions, for parity tests."""
    T, R3, P = Btr.shape
    b = Btr.reshape(T, R3 // 3, 3, P)
    rows = _gather_rows(vpT, vcT, img_r, cam_r)
    t = torch.einsum("jacp,jpa->cp", b, rows)
    w = torch.einsum("abp,bp->ap", Vinv_pad, t)
    u = torch.einsum("jacp,cp->jap", b, w)
    I, Nc = vpT.shape[1], vcT.shape[1]
    up = vpT.new_zeros((6, I))
    uc = vcT.new_zeros((vcT.shape[0], Nc))
    for j in range(T):
        oh_i = torch.nn.functional.one_hot(img_r[j].long(), I).to(u.dtype)
        oh_c = torch.nn.functional.one_hot(cam_r[j].long(), Nc).to(u.dtype)
        up = up + u[j, :6] @ oh_i
        uc = uc + u[j, 6:] @ oh_c
    return up, uc


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _lib():
    from .. import kernels
    lib = kernels.load("schur")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pixsfm_schur_matvec.argtypes = [p] * 6 + [i] * 5 + [p] * 3
        lib.pixsfm_schur_rhs.argtypes = [p] * 5 + [i] * 6 + [p] * 3
        lib.pixsfm_schur_backsub.argtypes = [p] * 5 + [i] * 5 + [p] * 2
        lib.pixsfm_schur_matvec_variant.argtypes = [i] * 5
        lib.pixsfm_schur_rhs_variant.argtypes = [i] * 5
        for f in (lib.pixsfm_schur_matvec, lib.pixsfm_schur_rhs,
                  lib.pixsfm_schur_backsub, lib.pixsfm_schur_max_k,
                  lib.pixsfm_schur_matvec_variant,
                  lib.pixsfm_schur_rhs_variant):
            f.restype = i
        lib.pixsfm_schur_max_k.argtypes = []
        lib._typed = True
    return lib


def _check(Btr, img_r, cam_r, T: int, k: int):
    if Btr.dtype != torch.float32 or Btr.dim() != 3 \
            or tuple(Btr.shape[:2]) != (T, 3 * (6 + k)):
        raise ValueError(f"schur kernels: Btr must be float32 [{T}, "
                         f"{3 * (6 + k)}, P], got {tuple(Btr.shape)} "
                         f"{Btr.dtype}")
    P = Btr.shape[2]
    for name, idx in (("img_r", img_r), ("cam_r", cam_r)):
        if idx.dtype != torch.int32 or tuple(idx.shape) != (T, P):
            raise ValueError(f"schur kernels: {name} must be int32 "
                             f"[{T}, {P}], got {tuple(idx.shape)} "
                             f"{idx.dtype}")
    if k > _lib().pixsfm_schur_max_k():
        raise ValueError(f"schur kernels: k={k} camera parameters exceed "
                         f"the kernels' {_lib().pixsfm_schur_max_k()}")
    return P


def _f32(t, dev):
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _zero_planes(I: int, Nc: int, k: int, dev):
    """Zeroed accumulators ``up [6, I]`` and ``uc [k, Nc]``, views of one
    buffer so that one fill kernel clears both."""
    buf = torch.zeros(6 * I + k * Nc, device=dev)
    return buf[:6 * I].view(6, I), buf[6 * I:].view(k, Nc)


def _run(name, fn, *args):
    dev = args[0].device if isinstance(args[0], torch.Tensor) else None
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"schur {name}: kernel launch failed "
                           f"(cudaError {err})")
    launches[name] += 1


def _variant_name(code: int, names) -> str:
    return names[code & 3] + ("/shared" if code & 4 else "/global")


def matvec_variant(T: int, k: int, I: int, Nc: int, P: int) -> str:
    """The K3a variant the C entry point takes for this shape: ``fused1`` /
    ``fused2`` (Btr read once, one / two ranks per warp) or ``twopass``
    (T > 16, or a rank block of 2^31 floats or more), with ``/shared`` or
    ``/global`` for where the pose and camera tables and accumulators
    live."""
    return _variant_name(_lib().pixsfm_schur_matvec_variant(T, k, I, Nc, P),
                         ("fused1", "fused2", "twopass"))


def rhs_variant(T: int, k: int, I: int, Nc: int, P: int) -> str:
    """The K3b variant the C entry point takes for this shape: ``fused1`` /
    ``fused2`` (K3a's fused kernel in its right-hand-side mode, one / two
    ranks per warp) or ``onepass`` (one thread per point: T > 16, or a rank
    block of 2^31 floats or more), with ``/shared`` or ``/global`` for where
    the accumulators live."""
    return _variant_name(_lib().pixsfm_schur_rhs_variant(T, k, I, Nc, P),
                         ("fused1", "fused2", "onepass"))


def schur_term_matvec(vpT, vcT, Btr, img_r, cam_r, Vinv_pad, *, T: int,
                      I: int, Nc: int, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W V^-1 W^T) v accumulated to camera planes: ``[6, I], [k, Nc]``."""
    if not Btr.is_cuda:
        return schur_term_matvec_plain(vpT, vcT, Btr, img_r, cam_r, Vinv_pad)
    P = _check(Btr, img_r, cam_r, T, k)
    dev = Btr.device
    vpT, vcT, Vinv_pad = (_f32(x, dev) for x in (vpT, vcT, Vinv_pad))
    up, uc = _zero_planes(I, Nc, k, dev)
    lib = _lib()
    _run("matvec", lib.pixsfm_schur_matvec, vpT, vcT, Btr.contiguous(),
         img_r.contiguous(), cam_r.contiguous(), Vinv_pad, T, k, I, Nc, P,
         up, uc)
    return up, uc


def schur_rhs(Btr, img_r, cam_r, Vinv_pad, gxt_pad, *, T: int, I: int,
              Nc: int, k: int, variant: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W V^-1 g_x) reduced to camera planes: ``[6, I], [k, Nc]``.
    ``variant="onepass"`` forces the one-pass kernel on the card (for checks
    and timing); ``None`` is the C entry point's own choice."""
    if variant not in (None, "onepass"):
        raise ValueError(f"schur_rhs: unknown variant {variant!r}")
    if not Btr.is_cuda:
        return schur_rhs_plain(Btr, img_r, cam_r, Vinv_pad, gxt_pad, I, Nc)
    P = _check(Btr, img_r, cam_r, T, k)
    dev = Btr.device
    up, uc = _zero_planes(I, Nc, k, dev)
    lib = _lib()
    _run("rhs", lib.pixsfm_schur_rhs, Btr.contiguous(), img_r.contiguous(),
         cam_r.contiguous(), _f32(Vinv_pad, dev), _f32(gxt_pad, dev), T, k,
         I, Nc, P, int(variant == "onepass"), up, uc)
    return up, uc


def schur_backsub(vpT, vcT, Btr, img_r, cam_r, *, T: int, I: int, Nc: int,
                  k: int) -> torch.Tensor:
    """W^T (gathered rows of v) reduced per point: ``[3, Ppad]``."""
    if not Btr.is_cuda:
        return schur_backsub_plain(vpT, vcT, Btr, img_r, cam_r)
    P = _check(Btr, img_r, cam_r, T, k)
    dev = Btr.device
    t = torch.empty((3, P), device=dev)
    lib = _lib()
    _run("backsub", lib.pixsfm_schur_backsub, _f32(vpT, dev), _f32(vcT, dev),
         Btr.contiguous(), img_r.contiguous(), cam_r.contiguous(), T, k, I,
         Nc, P, t)
    return t
