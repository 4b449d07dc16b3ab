"""Fused bicubic window interpolation + L2 chain rule (kernel K1).

Counterpart of ``pixsfm_tpu/ops/interpolate_pallas.py``
(``interpolate_rows_pallas``). On a CUDA tensor :func:`interpolate_rows`
launches ``kernels/csrc/interpolate.cu``; on a CPU tensor it runs the plain
PyTorch version (``base.interpolation.bicubic_window_eval_rows`` +
``l2_normalize_with_grad``). A CUDA tensor never takes the plain path: a
kernel that fails to build or launch raises.

The CUDA source holds four variants (:data:`VARIANTS`): ``vector`` (16-byte
loads, a lane per 16 bytes of a pixel, for bf16 or f32 rows of 64 or 128
channels on a 16-byte aligned base: S2DNet, DSIFT and R2D2 at 128,
VGGNet's first level at 64), ``wide`` (the same loads for 256 or 512
channels: VGGNet's and D2-Net's wider maps), ``narrow`` (one thread per
query for 1 to 8 channels at any alignment: the images' 1-3) and
``general`` (one warp per query, everything else up to 512 channels). The C
entry point chooses; :func:`kernel_variant` reports its choice, and
``interpolate_rows(..., variant=)`` forces one for checks and timing.

:func:`interpolate_node_rows` reads node windows (patch-warp BA and its
references): the node offsets of every query expand into one launch on
that query's patch row; the narrow variant serves their 3-channel raw
intensities.

:func:`interpolate` and :func:`interpolate_nodes` are the one route that
every feature read of the solvers takes for an ``InterpolationConfig``:
BICUBIC / CERES_BICUBIC with one node is one :func:`interpolate_rows` call,
with several nodes one :func:`interpolate_node_rows` call followed by the
NCC normalization when configured; BILINEAR, NEARESTNEIGHBOR and
BICUBICCHAIN are the plain PyTorch reads of ``base/interpolation.py`` on
every device (they are XLA in the JAX package) and never reach the kernel.
:func:`interpolate_fwd` is :func:`interpolate`'s value with its forward-mode
derivative ``dfdr * dr + dfdc * dc`` (the JAX package's custom JVP), so
``torch.func.jvp`` / ``vmap`` over a residual that reads it take the
kernel's own derivatives.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..base.interpolation import (InterpolationConfig,
                                  bicubic_window_eval_rows,
                                  interpolate_node_rows_with_grad,
                                  interpolate_rows_with_grad,
                                  l2_normalize_with_grad,
                                  ncc_normalize_with_grad, node_queries)

__all__ = ["interpolate_rows", "interpolate_rows_plain",
           "interpolate_node_rows", "interpolate", "interpolate_nodes",
           "interpolate_fwd", "kernel_variant", "VARIANTS", "launches",
           "launches_by_channels"]

# Number of kernel launches since the last reset (set it to 0 to reset),
# and the same split by channel count (clear it to reset).
launches = 0
launches_by_channels = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K1's variants, indexed by their code in the C entry points.
VARIANTS = ("general", "vector", "wide", "narrow")


def interpolate_rows_plain(rows, H: int, W: int, C: int, row_base, r, c,
                           l2_normalize: bool, dtype=torch.float32):
    """Plain PyTorch version of the kernel, on any device; ``dtype=
    torch.float64`` computes it in float64 (a reference for the float32
    kernel and plain version, outputs float64)."""
    f, dfdr, dfdc = bicubic_window_eval_rows(rows, H, W, C, row_base, r, c,
                                             dtype)
    if l2_normalize:
        f, (dfdr, dfdc) = l2_normalize_with_grad(f, (dfdr, dfdc))
    return f, dfdr, dfdc


def _lib():
    from .. import kernels
    lib = kernels.load("interpolate")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pixsfm_interp_rows.argtypes = [p, i, p, p, p, i, i, i, i, i,
                                           p, p, p, i, p]
        lib.pixsfm_interp_rows.restype = i
        lib.pixsfm_interp_max_channels.argtypes = []
        lib.pixsfm_interp_max_channels.restype = i
        lib.pixsfm_interp_variant.argtypes = [p, i, i, p, p, p]
        lib.pixsfm_interp_variant.restype = i
        lib.pixsfm_interp_takes.argtypes = [i, p, i, i, p, p, p]
        lib.pixsfm_interp_takes.restype = i
        lib._typed = True
    return lib


def kernel_variant(rows) -> str:
    """One of :data:`VARIANTS`: the variant the C entry point takes for
    these CUDA ``rows [NR, W, C]`` (outputs come from ``torch.empty`` and
    are always aligned): ``narrow`` for C <= 8; ``vector`` for C = 64 or
    128 and ``wide`` for C = 256 or 512 on a 16-byte aligned base;
    ``general`` otherwise."""
    return VARIANTS[_lib().pixsfm_interp_variant(
        rows.data_ptr(), _DTYPES[rows.dtype], rows.shape[-1], 0, 0, 0)]


def interpolate_rows(rows, H: int, W: int, C: int, row_base, r, c,
                     l2_normalize: bool, *, variant: Optional[str] = None):
    """``(f, dfdr, dfdc)`` ``[N, C]`` float32 at patch coordinates (r, c).

    ``rows [NR, W, C]`` (float32 or bfloat16) is the flat row view of the
    packed ``[B, H, W, C]`` patches, ``row_base [N]`` the first row of each
    query's patch (``patch_row * H``), ``r, c [N]`` float32. ``variant``
    forces one of :data:`VARIANTS` on the card (for checks and timing; it
    raises where that variant does not take these rows); ``None`` is the C
    entry point's own choice.
    """
    global launches
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"interpolate_rows: unknown variant {variant!r}")
    if not rows.is_cuda:
        return interpolate_rows_plain(rows, H, W, C, row_base, r, c,
                                      l2_normalize)
    if rows.dtype not in _DTYPES:
        raise TypeError(f"interpolate_rows: rows must be float32 or bfloat16, "
                        f"got {rows.dtype}")
    if rows.dim() != 3 or tuple(rows.shape[1:]) != (W, C) \
            or not rows.is_contiguous():
        raise ValueError(f"interpolate_rows: rows must be a contiguous "
                         f"[NR, {W}, {C}] tensor, got {tuple(rows.shape)}")
    if H < 1 or rows.shape[0] % H:
        raise ValueError(f"interpolate_rows: {rows.shape[0]} rows are not a "
                         f"whole number of {H}-row patches")
    lib = _lib()
    if C > lib.pixsfm_interp_max_channels():
        raise ValueError(f"interpolate_rows: C={C} exceeds the kernel's "
                         f"{lib.pixsfm_interp_max_channels()} channels")
    code = -1 if variant is None else VARIANTS.index(variant)
    if code >= 0 and not lib.pixsfm_interp_takes(
            code, rows.data_ptr(), _DTYPES[rows.dtype], C, 0, 0, 0):
        where = "" if rows.data_ptr() % 16 == 0 else \
            " on a base that is not 16-byte aligned"
        raise ValueError(f"interpolate_rows: the {variant} variant does not "
                         f"take {str(rows.dtype)[6:]} rows of C={C}{where}")
    dev = rows.device
    row_base = row_base.to(device=dev, dtype=torch.int32).contiguous()
    r = r.to(device=dev, dtype=torch.float32).contiguous()
    c = c.to(device=dev, dtype=torch.float32).contiguous()
    N = r.shape[0]
    if row_base.shape != (N,) or c.shape != (N,):
        raise ValueError("interpolate_rows: row_base, r, c must be [N]")
    f = torch.empty((N, C), device=dev, dtype=torch.float32)
    dfdr = torch.empty_like(f)
    dfdc = torch.empty_like(f)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pixsfm_interp_rows(
            rows.data_ptr(), _DTYPES[rows.dtype], row_base.data_ptr(),
            r.data_ptr(), c.data_ptr(), N, H, W, C, int(bool(l2_normalize)),
            f.data_ptr(), dfdr.data_ptr(), dfdc.data_ptr(), code, stream)
    if err:
        raise RuntimeError(f"interpolate_rows: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    launches_by_channels[C] = launches_by_channels.get(C, 0) + 1
    return f, dfdr, dfdc


def interpolate_node_rows(rows, H: int, W: int, C: int, row_base, r, c,
                          nodes, l2_normalize: bool):
    """Node windows ``(f, dfdr, dfdc)``, each ``[N, n_nodes, C]`` float32:
    the ``N * n_nodes`` queries at the offsets ``nodes [n_nodes, 2]`` ``(dx,
    dy)`` around each of the ``N`` queries (``base.interpolation.
    node_queries``, all on the query's own patch row) in one
    :func:`interpolate_rows` call. NCC is the caller's
    (``base.interpolation.ncc_normalize_with_grad``); the plain version is
    ``base.interpolation.interpolate_node_rows_with_grad``."""
    n = len(nodes)
    out = interpolate_rows(rows, H, W, C, *node_queries(row_base, r, c,
                                                        nodes),
                           l2_normalize)
    return tuple(o.reshape(-1, n, C) for o in out)


def _on_kernel(config: InterpolationConfig) -> bool:
    return config.mode in ("BICUBIC", "CERES_BICUBIC")


def interpolate_nodes(rows, H: int, W: int, C: int, row_base, r, c,
                      config: InterpolationConfig):
    """Node windows ``(f, dfdr, dfdc)``, each ``[N, n_nodes, D]``, of any
    feature config (one node included), NCC-normalized across the nodes
    when configured: the JAX package's ``interpolate_nodes_with_grad``.
    BICUBIC / CERES_BICUBIC read through :func:`interpolate_node_rows`
    (kernel K1 on CUDA, one launch), the other modes plain PyTorch."""
    if not _on_kernel(config):
        return interpolate_node_rows_with_grad(rows, H, W, C, row_base, r, c,
                                               config)
    f, dfdr, dfdc = interpolate_node_rows(rows, H, W, C, row_base, r, c,
                                          config.nodes, config.l2_normalize)
    if config.ncc_normalize:
        f, (dfdr, dfdc) = ncc_normalize_with_grad(f, (dfdr, dfdc))
    return f, dfdr, dfdc


def interpolate(rows, H: int, W: int, C: int, row_base, r, c,
                config: InterpolationConfig):
    """``(f, dfdr, dfdc)``, each ``[N, D]``: the JAX package's node-aware
    ``interpolate_with_grad`` (``base.interpolation.
    interpolate_rows_with_grad``) through the kernel where it applies: the
    flattened node window (node-major) with several nodes, one point
    otherwise (NCC has no effect on one point, as there)."""
    if not _on_kernel(config):
        return interpolate_rows_with_grad(rows, H, W, C, row_base, r, c,
                                          config)
    if config.n_nodes > 1:
        out = interpolate_nodes(rows, H, W, C, row_base, r, c, config)
        return tuple(a.reshape(a.shape[0], -1) for a in out)
    return interpolate_rows(rows, H, W, C, row_base, r, c,
                            config.l2_normalize)


class _Interpolate(torch.autograd.Function):
    """:func:`interpolate`'s value with the forward-mode rule ``dfdr * dr +
    dfdc * dc``. The read runs once, on plain tensors (the kernel cannot
    see ``torch.func``'s wrappers); its derivatives come from the same
    read."""

    @staticmethod
    def forward(r, c, rows, row_base, H, W, C, config):
        return interpolate(rows, H, W, C, row_base, r, c, config)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, dfdr, dfdc = output
        ctx.save_for_forward(dfdr, dfdc)
        ctx.mark_non_differentiable(dfdr, dfdc)

    @staticmethod
    def jvp(ctx, dr, dc, *_):
        dfdr, dfdc = ctx.saved_tensors
        tan = None
        if dr is not None:
            tan = dfdr * dr[:, None]
        if dc is not None:
            tc = dfdc * dc[:, None]
            tan = tc if tan is None else tan + tc
        if tan is None:
            tan = torch.zeros_like(dfdr)
        return tan, None, None

    @staticmethod
    def vmap(info, in_dims, r, c, rows, row_base, H, W, C, config):
        if any(d is not None for d in in_dims):
            raise NotImplementedError(
                "interpolate_fwd: vmap over the queries is not supported; "
                "pass the batch of queries as one call")
        out = _Interpolate.apply(r, c, rows, row_base, H, W, C, config)
        return out, (None, None, None)


def interpolate_fwd(rows, H: int, W: int, C: int, row_base, r, c,
                    config: InterpolationConfig):
    """:func:`interpolate`'s value ``[N, D]``, differentiable in forward
    mode in ``(r, c)`` through the read's own derivatives (the custom JVP
    of the JAX package's ``interpolate_autodiff``). ``torch.func.jvp``
    under ``torch.func.vmap`` over the tangents runs the read once."""
    return _Interpolate.apply(r, c, rows, row_base, H, W, C, config)[0]
