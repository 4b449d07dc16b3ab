"""Fused feature-reference BA evaluation (kernel K4).

One launch of ``kernels/csrc/ba_eval.cu`` evaluates a whole observation
axis of :func:`ops.schur.ba_solve` for the feature-reference residual
(``bundle_adjustment/main.py``): projection with its closed-form Jacobian,
patch coordinates, K1's bicubic read with the L2 chain rule, the target,
the ``check_bounds`` row, the loss and its IRLS weight, and the normal-
equation terms, which follow from six channel sums (the Gram matrix of the
rows ``J[c] = a[c] Jc + b[c] Jr``; the source explains). It replaces the
chunk loop's per-chunk PyTorch chain where :func:`takes` holds; every other
input keeps the chunk loop.

:func:`ba_eval` launches the kernel; :func:`ba_eval_plain` is its plain
PyTorch version, on any device, for checks (it holds ``[n, C]`` tensors, so
it is meant for small inputs). Both take the same arguments and return
``{"cost"}`` in mode ``"cost"``, also ``"ptv" [n, 12]`` (each slot's point
block and gradient) in mode ``"points"``, and also ``"B" [n, 6+k, 3]``,
``"img" [I, 42+6k]`` and ``"cam" [Nc, k*k+k]`` (the image and camera rows
of the normal equations, summed) in mode ``"full"``: the layout of
``ba_solve``'s chunk loop.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..base.interpolation import InterpolationConfig
from ..base.projection import project_with_jac
from .interpolate_cuda import interpolate_rows_plain

__all__ = ["MODES", "MODELS", "LOSSES", "takes_config", "takes", "ba_eval",
           "ba_eval_plain", "launches"]

# Number of kernel launches since the last reset (set it to 0 to reset).
launches = 0

MODES = ("cost", "points", "full")
# the camera models and losses K4 computes, by their code in the source
MODELS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3}
LOSSES = {"trivial": 0, "scaled": 1, "huber": 2, "soft_l1": 3, "softlone": 3,
          "softl1": 3, "cauchy": 4, "arctan": 5, "tukey": 6}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def takes_config(model, interp: InterpolationConfig, loss) -> bool:
    """Whether K4 computes this residual: one camera model of
    :data:`MODELS` (a tuple of models, as mixed scenes give, is not), a
    BICUBIC / CERES_BICUBIC read at the single node ``[0, 0]`` without NCC,
    and a loss of :data:`LOSSES`."""
    return (isinstance(model, str) and model in MODELS
            and interp.mode in ("BICUBIC", "CERES_BICUBIC")
            and [list(n) for n in interp.nodes] == [[0.0, 0.0]]
            and not interp.ncc_normalize
            and str(loss.name).lower() in LOSSES)


def _lib():
    from .. import kernels
    lib = kernels.load("ba_eval")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pixsfm_ba_eval_blocks.argtypes = [ctypes.c_longlong, i, i]
        lib.pixsfm_ba_eval_blocks.restype = i
        lib.pixsfm_ba_eval.argtypes = [ctypes.POINTER(_Params), i, i, i, p]
        lib.pixsfm_ba_eval.restype = i
        lib._typed = True
    return lib


def takes(model, interp: InterpolationConfig, loss, rows) -> bool:
    """:func:`takes_config`, and patch rows ``[NR, W, C]`` that K4 reads:
    a contiguous CUDA tensor of bf16 or f32 with C = 64 or 128 on a 16-byte
    aligned base (K1's vector read)."""
    return (takes_config(model, interp, loss) and rows.is_cuda
            and rows.dtype in _DTYPES and rows.dim() == 3
            and rows.shape[-1] in (64, 128) and rows.is_contiguous()
            and rows.data_ptr() % 16 == 0)


class _Params(ctypes.Structure):
    """``BaEvalParams`` of ``ba_eval.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "valid", "img", "cam", "pt", "row", "qvec", "tvec", "cams", "xyz",
        "corners", "scales", "ups", "target", "rows", "cost", "ptv", "B",
        "img_acc", "cam_acc")] + [("n", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in (
            "mode", "model", "k", "check_bounds", "l2", "loss", "h", "w")] + [
        (name, ctypes.c_float) for name in ("loss_a", "loss_a2",
                                            "loss_scale")]


def _loss_args(loss):
    a = float(loss.params[0]) if loss.params else 0.0
    return LOSSES[str(loss.name).lower()], a, a * a, float(loss.scale)


def ba_eval(mode: str, model: str, interp: InterpolationConfig, loss, state,
            img_idx, cam_idx, pt_idx, valid, row, target, patches) -> Dict:
    """One K4 launch over the ``n`` observation slots.

    ``state``: ``(qvec [I, 4], tvec [I, 3], cams [Nc, k], xyz [Np, 3])``
    float32; ``img_idx``, ``cam_idx``, ``pt_idx``, ``row [n]`` int64 (the
    patch of each slot), ``valid [n]`` bool, ``target [n, C]`` float32;
    ``patches``: the packed patches as the reads take them (``rows [B*H, W,
    C]``, ``H``, ``W``, ``corners [B, 2]``, ``scales [B, 2]``, ``ups [B]``),
    which :func:`takes` accepts. Returns the dictionary of the module
    docstring, on the rows' device, with no host sync."""
    global launches
    if mode not in MODES:
        raise ValueError(f"ba_eval: unknown mode {mode!r}")
    qvec, tvec, cams, xyz = (a.contiguous() for a in state)
    rows = patches.rows
    dev, C = rows.device, rows.shape[-1]
    n = img_idx.shape[0]
    Nc, k = cams.shape
    I = qvec.shape[0]
    NR = 6 + k
    lib = _lib()
    dtype = _DTYPES[rows.dtype]
    blocks = lib.pixsfm_ba_eval_blocks(n, dtype, C)
    if blocks < 0:
        raise RuntimeError(f"ba_eval: no launch grid (cudaError {-blocks})")
    partial = torch.empty(blocks, device=dev, dtype=torch.float64)
    out: Dict = {}
    empty = torch.empty(0, device=dev)
    ptv = B = img = cam = empty
    if mode != "cost":
        ptv = out["ptv"] = torch.empty((n, 12), device=dev)
    if mode == "full":
        B = out["B"] = torch.empty((n, NR, 3), device=dev)
        img = out["img"] = torch.zeros((I, 42 + 6 * k), device=dev)
        cam = out["cam"] = torch.zeros((Nc, k * k + k), device=dev)
    target = target.contiguous()
    idx = [a.to(torch.long).contiguous() for a in (img_idx, cam_idx, pt_idx,
                                                   row)]
    valid = valid.to(torch.bool).contiguous()
    place = [patches.corners.contiguous(), patches.scales.contiguous(),
             patches.ups.contiguous()]
    loss_id, a, a2, scale = _loss_args(loss)
    p = _Params(valid.data_ptr(), *(t.data_ptr() for t in idx),
                qvec.data_ptr(), tvec.data_ptr(), cams.data_ptr(),
                xyz.data_ptr(), *(t.data_ptr() for t in place),
                target.data_ptr(), rows.data_ptr(), partial.data_ptr(),
                ptv.data_ptr(), B.data_ptr(), img.data_ptr(), cam.data_ptr(),
                n, MODES.index(mode), MODELS[model], k,
                int(bool(interp.check_bounds)), int(bool(interp.l2_normalize)),
                loss_id, patches.H, patches.W, a, a2, scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pixsfm_ba_eval(ctypes.byref(p), dtype, C, blocks, stream)
    if err:
        raise RuntimeError(f"ba_eval: kernel launch failed (cudaError {err})")
    launches += 1
    out["cost"] = (0.5 * partial.sum()).to(torch.float32)
    return out


def ba_eval_plain(mode: str, model: str, interp: InterpolationConfig, loss,
                  state, img_idx, cam_idx, pt_idx, valid, row, target,
                  patches) -> Dict:
    """Plain PyTorch version of :func:`ba_eval` (same arguments and
    results), on any device: the same projection, read and structured Gram
    matrix as the kernel (its six sums and entries in float64), whole-axis
    tensor ops."""
    if mode not in MODES:
        raise ValueError(f"ba_eval_plain: unknown mode {mode!r}")
    qvec, tvec, cams, xyz = state
    rows, H, W = patches.rows, patches.H, patches.W
    n, C = target.shape[0], rows.shape[-1]
    I, (Nc, k) = qvec.shape[0], cams.shape
    NR = 6 + k
    D = NR + 3
    pix, Jp, Jcam, Jx = project_with_jac(model, cams[cam_idx], qvec[img_idx],
                                         tvec[img_idx], xyz[pt_idx])
    sc, up = patches.scales[row], patches.ups[row][:, None]
    pc = (pix * sc - 0.5 - patches.corners[row]) * up
    su = sc * up
    Jpix = torch.cat([Jp, Jcam, Jx], dim=-1)                  # [n, 2, D]
    Jc = su[:, 0, None] * Jpix[:, 0]
    Jr = su[:, 1, None] * Jpix[:, 1]
    f, dfdr, dfdc = interpolate_rows_plain(rows, H, W, C, row * H, pc[:, 1],
                                           pc[:, 0], interp.l2_normalize)
    a, b, r = dfdc, dfdr, f - target
    if interp.check_bounds:
        rr, cc = pc[:, 1], pc[:, 0]
        viol = (torch.clamp(rr - (H - 1.0), min=0.0)
                + torch.clamp(-rr, min=0.0)
                + torch.clamp(cc - (W - 1.0), min=0.0)
                + torch.clamp(-cc, min=0.0))
        dv_dr = (rr > H - 1.0).float() - (rr < 0.0).float()
        dv_dc = (cc > W - 1.0).float() - (cc < 0.0).float()
        a = torch.cat([a, dv_dc[:, None]], dim=1)
        b = torch.cat([b, dv_dr[:, None]], dim=1)
        r = torch.cat([r, viol[:, None]], dim=1)
    sq = torch.sum(r * r, dim=1)
    zero = torch.zeros_like(sq)
    out: Dict = {"cost": 0.5 * torch.sum(torch.where(valid, loss(sq), zero))}
    if mode == "cost":
        return out
    w = torch.where(valid, loss.weight(sq), zero).double()
    # the six sums and the entries in float64, as the kernel takes them
    a, b, r, Jc, Jr = (x.double() for x in (a, b, r, Jc, Jr))
    Saa, Sab, Sbb, Sar, Sbr = (torch.sum(x * y, dim=1) for x, y in (
        (a, a), (a, b), (b, b), (a, r), (b, r)))
    G = w[:, None, None] * (
        Saa[:, None, None] * Jc[:, :, None] * Jc[:, None, :]
        + Sab[:, None, None] * (Jc[:, :, None] * Jr[:, None, :]
                                + Jr[:, :, None] * Jc[:, None, :])
        + Sbb[:, None, None] * Jr[:, :, None] * Jr[:, None, :])
    g = w[:, None] * (Sar[:, None] * Jc + Sbr[:, None] * Jr)   # [n, D]
    G = torch.where(valid[:, None, None], G, 0.0).float()
    g = torch.where(valid[:, None], g, 0.0).float()
    px = NR
    out["ptv"] = torch.cat([G[:, px:, px:].reshape(n, 9), g[:, px:]], dim=1)
    if mode == "points":
        return out
    out["B"] = G[:, :px, px:D].contiguous()
    out["img"] = torch.zeros((I, 42 + 6 * k), device=G.device).index_add_(
        0, img_idx, torch.cat([G[:, :6, :6].reshape(n, 36), g[:, :6],
                               G[:, :6, 6:px].reshape(n, 6 * k)], dim=1))
    out["cam"] = torch.zeros((Nc, k * k + k), device=G.device).index_add_(
        0, cam_idx, torch.cat([G[:, 6:px, 6:px].reshape(n, k * k),
                               g[:, 6:px]], dim=1))
    return out
