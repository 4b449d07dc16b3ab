"""Feature-patch interpolation (reference: pixsfm/base/src/interpolation.h).

Port of the bicubic window path of ``pixsfm_tpu/base/interpolation.py``: the
separable Catmull-Rom weights, the border-clamped dense column taps and the
4-row window evaluation with analytic derivatives, plus the L2-normalization
chain rule. :func:`bicubic_window_eval_rows` followed by
:func:`l2_normalize_with_grad` is the plain PyTorch version of the CUDA
kernel in ``ops/interpolate_cuda.py``; it runs on the CPU and is what the
kernel is checked against on the card.

:func:`bicubic_window_eval_rows_d2` adds the second derivatives, from
which query bundle adjustment builds its exact Newton Hessian;
:func:`bounds_violation` is the ``check_bounds`` hinge.

Only BICUBIC / CERES_BICUBIC with one node and without NCC are ported; the
other modes (bilinear, nearest, gradient fields), node windows and NCC come
with ROADMAP.md item 'The other BA strategies' and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

__all__ = [
    "InterpolationConfig", "INTERPOLATOR_TYPES", "catmull_rom_weights",
    "bicubic_window_eval_rows", "l2_normalize_with_grad",
    "bicubic_window_eval_rows_d2", "check_window_config",
    "bounds_violation",
]

INTERPOLATOR_TYPES = (
    "BICUBIC", "BILINEAR", "NEARESTNEIGHBOR",
    "POLYGRADIENTFIELD", "BICUBICGRADIENTFIELD", "BICUBICCHAIN",
    "CERES_BICUBIC",
)


@dataclass
class InterpolationConfig:
    """Mirrors InterpolationConfig (interpolation.h:39-51)."""
    mode: str = "BICUBIC"
    l2_normalize: bool = True
    ncc_normalize: bool = False
    nodes: Sequence[Sequence[float]] = field(default_factory=lambda: [[0.0, 0.0]])
    fill_channel_differences: bool = True
    check_bounds: bool = False
    use_float_simd: bool = False  # accepted for config parity; no-op

    def __post_init__(self):
        mode = str(self.mode).upper()
        if mode not in INTERPOLATOR_TYPES:
            raise ValueError(f"unknown interpolation mode {self.mode!r}")
        self.mode = mode
        self.nodes = [list(map(float, n)) for n in self.nodes]

    @classmethod
    def from_conf(cls, conf) -> "InterpolationConfig":
        if isinstance(conf, InterpolationConfig):
            return conf
        if conf is None:
            return cls()
        d = conf.to_dict() if hasattr(conf, "to_dict") else dict(conf)
        known = {k: v for k, v in d.items()
                 if k in ("mode", "l2_normalize", "ncc_normalize", "nodes",
                          "fill_channel_differences", "check_bounds",
                          "use_float_simd") and v is not None}
        return cls(**known)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)


def check_window_config(interp: InterpolationConfig) -> None:
    """Raise for configs outside the ported bicubic window path."""
    if interp.mode not in ("BICUBIC", "CERES_BICUBIC"):
        raise NotImplementedError(
            f"interpolation mode {interp.mode} is not ported yet; see "
            "ROADMAP.md section 1, 'The other BA strategies'")
    if interp.ncc_normalize or interp.n_nodes != 1:
        raise NotImplementedError(
            "NCC normalization and multi-node interpolation are not ported "
            "yet; see ROADMAP.md section 1, 'The other BA strategies'")


def catmull_rom_weights(t):
    """Weights for taps p0..p3 at fractional offset t in [0,1), plus d/dt weights."""
    t2 = t * t
    t3 = t2 * t
    w = torch.stack([
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    ], dim=-1)
    dw = torch.stack([
        -1.5 * t2 + 2.0 * t - 0.5,
        4.5 * t2 - 5.0 * t,
        -4.5 * t2 + 4.0 * t + 0.5,
        1.5 * t2 - t,
    ], dim=-1)
    return w, dw


def _dense_taps(x, size: int, taps, tap_weights):
    """Scatter ``tap_weights`` at clamped tap positions into a dense length-``size``
    vector. Clamping duplicates collapse by summation == Grid2D clamped reads."""
    base = torch.floor(x).to(torch.int64)
    idx = torch.clamp(base[..., None] + taps, 0, size - 1)          # (..., T)
    iota = torch.arange(size, device=x.device)
    onehot = (idx[..., None] == iota).to(tap_weights.dtype)       # (..., T, size)
    return torch.einsum("...t,...ts->...s", tap_weights, onehot)


def bicubic_window_eval_rows(rows, H: int, W: int, C: int, row_base, r, c):
    """Window eval against a flat ``[total_rows, W, C]`` row view.

    ``row_base[n]`` is the first row of query n's patch (``patch_row * H``).
    Returns ``(f, dfdr, dfdc)``, each ``[N, C]`` float32. Row taps are a
    4-row gather clamped inside the patch; column taps are dense clamped
    weights, so duplicated border taps accumulate (== Grid2D clamped reads).
    """
    taps = torch.arange(-1, 3, device=r.device)
    fr = torch.floor(r)
    wr, dwr = catmull_rom_weights(r - fr)                  # [N, 4]
    wc4, dwc4 = catmull_rom_weights(c - torch.floor(c))
    wc = _dense_taps(c, W, taps, wc4)                      # [N, W]
    dwc = _dense_taps(c, W, taps, dwc4)
    ri = torch.clamp(fr.to(torch.int64)[:, None] + taps, 0, H - 1)
    idx = row_base.to(torch.int64)[:, None] + ri           # [N, 4]
    win = rows[idx].to(torch.float32)                      # [N, 4, W, C]
    wcs = torch.stack([wc, dwc], dim=1)                    # [N, 2, W]
    mix = torch.einsum("nawc,nsw->nsac", win, wcs)         # [N, 2, 4, C]
    colmix, dcolmix = mix[:, 0], mix[:, 1]
    f = torch.einsum("nac,na->nc", colmix, wr)
    dfdr = torch.einsum("nac,na->nc", colmix, dwr)
    dfdc = torch.einsum("nac,na->nc", dcolmix, wr)
    return f, dfdr, dfdc


def bicubic_window_eval_rows_d2(rows, H: int, W: int, C: int, row_base, r,
                                c):
    """:func:`bicubic_window_eval_rows` with the second derivatives: ``(f,
    f_r, f_c, f_rr, f_rc, f_cc)``, each ``[N, C]`` float32. They are the
    derivatives of the Catmull-Rom window within a cell (the tap indices
    come from ``floor``), the ones that differentiating the JAX package's
    analytic ``(dfdr, dfdc)`` once more gives. Query bundle adjustment
    builds its exact Hessian from them."""
    taps = torch.arange(-1, 3, device=r.device)
    fr, fc = torch.floor(r), torch.floor(c)
    wr, dwr = catmull_rom_weights(r - fr)
    wc, dwc = catmull_rom_weights(c - fc)
    rw = torch.stack([wr, dwr, _catmull_rom_second(r - fr)], dim=1)
    cw = torch.stack([wc, dwc, _catmull_rom_second(c - fc)], dim=1)
    ci = torch.clamp(fc.to(torch.int64)[:, None] + taps, 0, W - 1)
    onehot = (ci[..., None] == torch.arange(W, device=c.device)).to(
        cw.dtype)                                           # [N, 4, W]
    cw = torch.einsum("nkt,ntw->nkw", cw, onehot)           # [N, 3, W]
    ri = torch.clamp(fr.to(torch.int64)[:, None] + taps, 0, H - 1)
    win = rows[row_base.to(torch.int64)[:, None] + ri].to(torch.float32)
    colmix = torch.einsum("nawc,nkw->nkac", win, cw)        # [N, 3, 4, C]
    m = torch.einsum("nkac,nja->nkjc", colmix, rw)          # [N, 3, 3, C]
    return m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 0, 2], m[:, 1, 1], \
        m[:, 2, 0]


def _catmull_rom_second(t):
    """d^2/dt^2 of the Catmull-Rom tap weights."""
    return torch.stack([-3.0 * t + 2.0, 9.0 * t - 5.0, -9.0 * t + 4.0,
                        3.0 * t - 1.0], dim=-1)


def l2_normalize_with_grad(f, derivs):
    """L2-normalize f and apply the chain rule to each derivative array.

    The norm is clamped at 1e-20, as the XLA form of the JAX package does
    (the Pallas kernel instead clamps the squared norm at 1e-24; the port
    follows the XLA default path)."""
    norm_inv = 1.0 / torch.clamp(torch.linalg.vector_norm(f, dim=-1,
                                                          keepdim=True),
                                 min=1e-20)
    fn = f * norm_inv
    out = []
    for d in derivs:
        if d is None:
            out.append(None)
            continue
        dn = d * norm_inv
        dn = dn - torch.sum(fn * dn, dim=-1, keepdim=True) * fn
        out.append(dn)
    return fn, out


def bounds_violation(r, c, H: int, W: int):
    """Hinge distance (in patch pixels) outside the extent [0, H-1] x
    [0, W-1]; 0 inside (``base/interpolation.py:556`` of the JAX package).
    Solvers with ``check_bounds`` add its square to a residual's squared
    norm, so a step that pushes a reprojection out of its patch raises the
    cost and is rejected, where the reference's cost functor fails."""
    zero = torch.zeros_like(r)
    return (torch.maximum(r - (H - 1.0), zero) + torch.maximum(-r, zero)
            + torch.maximum(c - (W - 1.0), zero) + torch.maximum(-c, zero))
