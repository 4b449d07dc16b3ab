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

The gradient-field modes (``POLYGRADIENTFIELD``, ``BICUBICGRADIENTFIELD``)
interpolate the 3- or 4-channel cost patches of costmap BA, batched over
observations: :func:`gradient_field_eval` returns the value and the
derivatives d/dr, d/dc, d/drdc (one channel each), what the JAX package's
``interpolate_residual_with_grad`` returns for them plus the cross
derivative.

Node windows (:func:`interpolate_node_rows_with_grad`): every query is
evaluated at ``config.nodes`` offsets ``(dx, dy)`` around it, and with
``ncc_normalize`` each channel is brought to mean 0 / std 1 across the
nodes with the chain rule through the derivatives
(:func:`ncc_normalize_with_grad`, the reference's sigma := 1 where sigma
is 0). KA, QKA, QBA, feature-reference and patch-warp BA and the
references read them; for BICUBIC one K1 launch serves all nodes of a
batch (``ops/interpolate_cuda.interpolate_node_rows``).

The other feature modes (BILINEAR, NEARESTNEIGHBOR, BICUBICCHAIN) are
plain PyTorch on every device, as they are XLA in the JAX package:
:func:`mode_eval_rows` gives their value and derivatives (bilinear and
nearest with the reference's forward differences, BICUBICCHAIN's value
from channel 0 and its derivatives from channels 1 and 2 of a bicubic
read). :func:`interpolate_rows_with_grad` is the JAX package's node-aware
``interpolate_with_grad`` over a flat row view: the flattened ``[N,
n_nodes * C]`` node window when ``n_nodes > 1`` (NCC across the nodes when
configured), the single point otherwise (where NCC is ignored, as there);
:func:`interpolate_node_rows_with_grad` evaluates the node window for one
node too (``interpolate_nodes``, the reference extraction's read).

The patch API of the JAX package (:func:`interpolate`,
:func:`interpolate_with_grad`, :func:`interpolate_nodes`,
:func:`interpolate_nodes_with_grad`, :func:`bicubic_window_eval`,
:func:`inbounds_weight`) reads one ``[H, W, C]`` patch (or ``bicubic_window_eval``
a stack of them) at queries ``r, c`` that are scalars (JAX's single query,
outputs ``[D]``) or tensors of one shape ``[...]`` (what JAX users get with
``vmap``, outputs ``[..., D]``). Patches of any storage dtype are read in
float32, as there. BICUBIC / CERES_BICUBIC reads of a CUDA patch go through
kernel K1 (``ops/interpolate_cuda``), one launch per call; the other modes,
``cross=True`` (K1 computes no second derivative) and CPU patches take the
plain row functions above.

:func:`check_window_config` refuses the gradient-field modes on feature
patches (``ValueError``): they read the cost patches of costmap BA.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..util.profiling import to_device

__all__ = [
    "InterpolationConfig", "INTERPOLATOR_TYPES", "catmull_rom_weights",
    "bicubic_window_eval_rows", "l2_normalize_with_grad",
    "bicubic_window_eval_rows_d2", "check_window_config",
    "bounds_violation", "gradient_field_eval", "ncc_normalize",
    "ncc_normalize_with_grad", "node_queries",
    "interpolate_node_rows_with_grad", "GRADIENT_FIELD_MODES", "output_dim",
    "mode_eval_rows", "point_eval_rows", "interpolate_rows_with_grad",
    "check_residual_config", "interpolate", "interpolate_with_grad",
    "interpolate_nodes", "interpolate_nodes_with_grad", "bicubic_window_eval",
    "inbounds_weight",
]

# scalar-output modes, which ignore node windows and the L2 normalization
# (``GRADIENT_FIELD_MODES`` of the JAX package)
GRADIENT_FIELD_MODES = ("POLYGRADIENTFIELD", "BICUBICGRADIENTFIELD",
                        "BICUBICCHAIN")

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

    def nodes_array(self) -> np.ndarray:
        return np.asarray(self.nodes, dtype=np.float32)


def check_window_config(interp: InterpolationConfig) -> None:
    """Raise ``ValueError`` for the gradient-field modes, which interpolate
    the cost patches of costmap BA (:func:`gradient_field_eval`), not
    feature patches. Every other config is read by the feature paths."""
    if interp.mode in ("POLYGRADIENTFIELD", "BICUBICGRADIENTFIELD"):
        raise ValueError(
            f"interpolation mode {interp.mode} interpolates the cost patches "
            "of costmap BA (gradient_field_eval), not feature patches")


def check_residual_config(interp: InterpolationConfig) -> None:
    """The refusal of the JAX package's ``interpolate_residual_with_grad``
    (``base/interpolation.py:607-610``): single-point NCC has no analytic
    residual path there."""
    if interp.ncc_normalize and not _node_path(interp):
        raise NotImplementedError(
            "interpolate_residual_with_grad: single-point NCC configs use "
            "the autodiff path")


def output_dim(mode: str, channels: int, n_nodes: int = 1) -> int:
    """Descriptor length of a read (gradient-field modes are scalar; node
    windows concatenate), as the JAX package's ``output_dim``."""
    return 1 if mode in GRADIENT_FIELD_MODES else channels * max(n_nodes, 1)


def _node_path(interp: InterpolationConfig) -> bool:
    """Whether a read evaluates the node window (``interpolate`` of the JAX
    package: more than one node, and not a scalar mode)."""
    return interp.n_nodes > 1 and interp.mode not in GRADIENT_FIELD_MODES


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


def bicubic_window_eval_rows(rows, H: int, W: int, C: int, row_base, r, c,
                             dtype=torch.float32):
    """Window eval against a flat ``[total_rows, W, C]`` row view.

    ``row_base[n]`` is the first row of query n's patch (``patch_row * H``).
    Returns ``(f, dfdr, dfdc)``, each ``[N, C]`` in ``dtype``, the type the
    queries and the window are read and summed in (float32; float64 gives a
    reference for the float32 reads). Row taps are a 4-row gather clamped
    inside the patch; column taps are dense clamped weights, so duplicated
    border taps accumulate (== Grid2D clamped reads).
    """
    r, c = r.to(dtype), c.to(dtype)
    taps = torch.arange(-1, 3, device=r.device)
    fr = torch.floor(r)
    wr, dwr = catmull_rom_weights(r - fr)                  # [N, 4]
    wc4, dwc4 = catmull_rom_weights(c - torch.floor(c))
    wc = _dense_taps(c, W, taps, wc4)                      # [N, W]
    dwc = _dense_taps(c, W, taps, dwc4)
    ri = torch.clamp(fr.to(torch.int64)[:, None] + taps, 0, H - 1)
    idx = row_base.to(torch.int64)[:, None] + ri           # [N, 4]
    win = rows[idx].to(dtype)                              # [N, 4, W, C]
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


def ncc_normalize(f_nodes, eps=0.0):
    """Per-channel mean 0 / std 1 across the node axis -2 of ``[...,
    n_nodes, C]`` (interpolation.h:54-85); sigma := 1 where it is 0."""
    mu = torch.mean(f_nodes, dim=-2, keepdim=True)
    sigma = torch.sqrt(torch.mean((f_nodes - mu) ** 2, dim=-2, keepdim=True))
    sigma = torch.where(sigma > 0.0, sigma, torch.ones_like(sigma))
    return (f_nodes - mu) / sigma


def ncc_normalize_with_grad(f_nodes, derivs):
    """:func:`ncc_normalize` with the chain rule applied to each array of
    ``derivs`` (each broadcastable against ``f_nodes``: a Jacobian keeps its
    columns on an axis before the node axis, against a unit axis of
    ``f_nodes``): per channel ``g = (f - mu) / sigma`` and ``dg =
    (df - dmu) / sigma - g dsigma / sigma``, ``dsigma = mean((f - mu)(df -
    dmu)) / sigma``; where sigma is 0, sigma := 1 and dsigma := 0 (the
    centred derivative), as the JAX package does."""
    mu = torch.mean(f_nodes, dim=-2, keepdim=True)
    fc = f_nodes - mu
    sigma = torch.sqrt(torch.mean(fc * fc, dim=-2, keepdim=True))
    ok = sigma > 0.0
    sigma = torch.where(ok, sigma, torch.ones_like(sigma))
    g = fc / sigma
    out = []
    for d in derivs:
        if d is None:
            out.append(None)
            continue
        dc = d - torch.mean(d, dim=-2, keepdim=True)
        dsigma = torch.where(ok, torch.mean(fc * dc, dim=-2, keepdim=True)
                             / sigma, torch.zeros_like(sigma))
        out.append(dc / sigma - g * dsigma / sigma)
    return g, out


def node_queries(row_base, r, c, nodes):
    """The ``N * n_nodes`` window queries of node windows around ``N``
    queries, node-major within each query: ``(row_base, r + dy, c + dx)``
    for the node offsets ``nodes [n_nodes, 2]`` ``(dx, dy)``."""
    nodes = to_device(np.asarray(nodes, np.float32), r.device)
    n = nodes.shape[0]
    return (row_base.repeat_interleave(n), (r[:, None] + nodes[:, 1])
            .reshape(-1), (c[:, None] + nodes[:, 0]).reshape(-1))


def _cell_rows(rows, H: int, W: int, row_base, ri, ci):
    """``rows[row_base + clamp(ri), clamp(ci)]`` as float32: the pixels at
    integer patch coordinates ``ri [N, a]``, ``ci [N, b]`` -> ``[N, a, b,
    C]``, clamped into the patch (Grid2D's clamped reads)."""
    ri = torch.clamp(ri, 0, H - 1)
    ci = torch.clamp(ci, 0, W - 1)
    idx = row_base.to(torch.int64)[:, None] + ri
    return rows[idx[:, :, None], ci[:, None, :]].to(torch.float32)


def _bilinear_value_rows(rows, H: int, W: int, row_base, r, c):
    """Bilinear value ``[N, C]`` with clamped taps (a duplicated border tap
    reads the border pixel with both weights, as the JAX package's dense
    taps do)."""
    fr, fc = torch.floor(r), torch.floor(c)
    taps = torch.arange(0, 2, device=r.device)
    tr, tc = r - fr, c - fc
    win = _cell_rows(rows, H, W, row_base, fr.to(torch.int64)[:, None] + taps,
                     fc.to(torch.int64)[:, None] + taps)      # [N, 2, 2, C]
    wr = torch.stack([1.0 - tr, tr], dim=1)
    wc = torch.stack([1.0 - tc, tc], dim=1)
    return torch.einsum("nabc,na,nb->nc", win, wr, wc)


def _nearest_value_rows(rows, H: int, W: int, row_base, r, c):
    """The pixel nearest to ``(r, c)`` (rounded half to even, clamped)."""
    ri = torch.round(r).to(torch.int64)[:, None]
    ci = torch.round(c).to(torch.int64)[:, None]
    return _cell_rows(rows, H, W, row_base, ri, ci)[:, 0, 0]


def mode_eval_rows(rows, H: int, W: int, C: int, row_base, r, c, mode: str):
    """``(f, dfdr, dfdc)`` of one feature mode at patch coordinates ``(r,
    c)`` of a flat row view (``row_base`` as for
    :func:`bicubic_window_eval_rows`), before any normalization
    (``_MODE_FULL`` of the JAX package, batched): BICUBIC / CERES_BICUBIC
    the Catmull-Rom window with analytic derivatives; BILINEAR and
    NEARESTNEIGHBOR the value and forward differences ``f(r + 1, c) - f``,
    ``f(r, c + 1) - f`` (interpolation.h:543-560); BICUBICCHAIN ``[N, 1]``
    outputs, the bicubic read's channels 0, 1, 2."""
    if mode in ("BICUBIC", "CERES_BICUBIC"):
        return bicubic_window_eval_rows(rows, H, W, C, row_base, r, c)
    if mode == "BICUBICCHAIN":
        f3, _, _ = bicubic_window_eval_rows(rows, H, W, C, row_base, r, c)
        return f3[:, :1], f3[:, 1:2], f3[:, 2:3]
    if mode == "BILINEAR":
        value = _bilinear_value_rows
    elif mode == "NEARESTNEIGHBOR":
        value = _nearest_value_rows
    else:
        check_window_config(InterpolationConfig(mode=mode))
        raise ValueError(f"unknown feature interpolation mode {mode!r}")
    f = value(rows, H, W, row_base, r, c)
    return (f, value(rows, H, W, row_base, r + 1.0, c) - f,
            value(rows, H, W, row_base, r, c + 1.0) - f)


def point_eval_rows(rows, H: int, W: int, C: int, row_base, r, c,
                    config: InterpolationConfig):
    """One point per query, L2-normalized with the chain rule when the
    config asks and the mode is not scalar (``_interpolate_point_with_grad``
    of the JAX package): ``(f, dfdr, dfdc)``, each ``[N, D]``."""
    f, dfdr, dfdc = mode_eval_rows(rows, H, W, C, row_base, r, c,
                                   config.mode)
    if config.l2_normalize and config.mode not in GRADIENT_FIELD_MODES:
        f, (dfdr, dfdc) = l2_normalize_with_grad(f, (dfdr, dfdc))
    return f, dfdr, dfdc


def interpolate_node_rows_with_grad(rows, H: int, W: int, C: int, row_base,
                                    r, c, config: InterpolationConfig):
    """Node windows ``(f, dfdr, dfdc)``, each ``[N, n_nodes, D]`` float32,
    at patch coordinates ``(r, c)`` of the flat row view ``rows [NR, W,
    C]`` (``row_base`` as for :func:`bicubic_window_eval_rows`): every node
    read by :func:`point_eval_rows`, then NCC-normalized across the nodes
    when ``config.ncc_normalize`` (the JAX package's
    ``interpolate_nodes_with_grad``, batched). For BICUBIC and
    CERES_BICUBIC it is the plain version of
    ``ops/interpolate_cuda.interpolate_node_rows`` plus the NCC."""
    n = config.n_nodes
    out = point_eval_rows(rows, H, W, C,
                          *node_queries(row_base, r, c, config.nodes), config)
    f, dfdr, dfdc = (a.reshape(-1, n, a.shape[-1]) for a in out)
    if config.ncc_normalize:
        f, (dfdr, dfdc) = ncc_normalize_with_grad(f, (dfdr, dfdc))
    return f, dfdr, dfdc


def interpolate_rows_with_grad(rows, H: int, W: int, C: int, row_base, r, c,
                               config: InterpolationConfig):
    """The JAX package's node-aware ``interpolate_with_grad`` over a flat
    row view: ``(f, dfdr, dfdc)``, each ``[N, D]`` with ``D =
    output_dim(mode, C, n_nodes)``: the flattened node window (node-major,
    NCC chain-ruled) when there are several nodes and the mode is not
    scalar, else one point (NCC has no effect on one point, as there).
    Plain PyTorch on any device; ``ops/interpolate_cuda.interpolate`` routes
    BICUBIC reads on the card through kernel K1."""
    if _node_path(config):
        out = interpolate_node_rows_with_grad(rows, H, W, C, row_base, r, c,
                                              config)
        return tuple(a.reshape(a.shape[0], -1) for a in out)
    return point_eval_rows(rows, H, W, C, row_base, r, c, config)


def bounds_violation(r, c, H: int, W: int):
    """Hinge distance (in patch pixels) outside the extent [0, H-1] x
    [0, W-1]; 0 inside (``base/interpolation.py:556`` of the JAX package).
    Solvers with ``check_bounds`` add its square to a residual's squared
    norm, so a step that pushes a reprojection out of its patch raises the
    cost and is rejected, where the reference's cost functor fails."""
    zero = torch.zeros_like(r)
    return (torch.maximum(r - (H - 1.0), zero) + torch.maximum(-r, zero)
            + torch.maximum(c - (W - 1.0), zero) + torch.maximum(-c, zero))


# ---------------------------------------------------------------------------
# the patch API of the JAX package (one patch, scalar or batched queries)
# ---------------------------------------------------------------------------

def inbounds_weight(r, c, H: int, W: int):
    """1.0 inside the patch extent [0, H-1] x [0, W-1], else 0.0 (float32,
    the shape of ``r``)."""
    inside = (r >= 0.0) & (r <= H - 1.0) & (c >= 0.0) & (c <= W - 1.0)
    return torch.as_tensor(inside).to(torch.float32)


def _readable(patch):
    """``patch`` in a storage type the reads take: float32 and bfloat16 as
    they are, anything else in float32 (the JAX package reads every type
    in float32)."""
    if patch.dtype in (torch.float32, torch.bfloat16):
        return patch.contiguous()
    return patch.to(torch.float32).contiguous()


def _queries(patch, r, c):
    """Flat float32 queries ``r, c [n]`` on the patch's device, the shape
    they broadcast to, and a zero ``row_base [n]``."""
    r = torch.as_tensor(r, dtype=torch.float32, device=patch.device)
    c = torch.as_tensor(c, dtype=torch.float32, device=patch.device)
    r, c = torch.broadcast_tensors(r, c)
    shape = tuple(r.shape)
    r, c = r.reshape(-1), c.reshape(-1)
    return r, c, torch.zeros_like(r, dtype=torch.int32), shape


def _on_k1(mode: str) -> bool:
    return mode in ("BICUBIC", "CERES_BICUBIC")


def _point_with_cross(patch, row_base, r, c, config: InterpolationConfig):
    """``(f, dfdr, dfdc, dfdrc)``, each ``[n, D]``, of one point per query,
    L2-normalized with the chain rule on the first three where the config
    asks (the JAX package does not chain-rule dfdrc), plain PyTorch."""
    H, W, C = patch.shape
    if config.mode in _GRADIENT_FIELDS:
        return gradient_field_eval(patch[None], row_base, r, c, config.mode)
    if _on_k1(config.mode):
        f, dfdr, dfdc, _, dfdrc, _ = bicubic_window_eval_rows_d2(
            patch, H, W, C, row_base, r, c)
    else:
        f, dfdr, dfdc = mode_eval_rows(patch, H, W, C, row_base, r, c,
                                       config.mode)
        dfdrc = torch.zeros_like(f)
    if config.l2_normalize and config.mode not in GRADIENT_FIELD_MODES:
        f, (dfdr, dfdc) = l2_normalize_with_grad(f, (dfdr, dfdc))
    return f, dfdr, dfdc, dfdrc


def _point_reads(patch, row_base, r, c, config: InterpolationConfig):
    """``(f, dfdr, dfdc)``, each ``[n, D]``, of one point per query: K1
    for BICUBIC (its plain version on a CPU patch), else plain."""
    if _on_k1(config.mode):
        from ..ops import interpolate_cuda
        H, W, C = patch.shape
        return interpolate_cuda.interpolate_rows(patch, H, W, C, row_base,
                                                 r, c, config.l2_normalize)
    return _point_with_cross(patch, row_base, r, c, config)[:3]


def _node_reads(patch, row_base, r, c, config: InterpolationConfig):
    """``(f, dfdr, dfdc)``, each ``[n, n_nodes, D]``: every node of every
    query in one read (one K1 launch for BICUBIC on the card), then NCC
    across the nodes when configured."""
    n, n_nodes = r.shape[0], config.n_nodes
    if _on_k1(config.mode):
        from ..ops import interpolate_cuda
        H, W, C = patch.shape
        return interpolate_cuda.interpolate_nodes(patch, H, W, C, row_base,
                                                  r, c, config)
    out = _point_reads(patch, *node_queries(row_base, r, c, config.nodes),
                       config)
    f, dfdr, dfdc = (a.reshape(n, n_nodes, a.shape[-1]) for a in out)
    if config.ncc_normalize:
        f, (dfdr, dfdc) = ncc_normalize_with_grad(f, (dfdr, dfdc))
    return f, dfdr, dfdc


def interpolate_nodes_with_grad(patch, r, c, config: InterpolationConfig):
    """Node windows of one ``[H, W, C]`` patch: ``(f, dfdr, dfdc)``, each
    ``[..., n_nodes, D]`` float32, every node ``(dx, dy)`` read at ``(r +
    dy, c + dx)`` (interpolation.h:708-717), NCC-normalized across the
    nodes with the chain rule when configured (the JAX package's
    ``interpolate_nodes_with_grad``)."""
    patch = _readable(patch)
    r, c, row_base, shape = _queries(patch, r, c)
    out = _node_reads(patch, row_base, r, c, config)
    return tuple(a.reshape(*shape, *a.shape[1:]) for a in out)


def interpolate_nodes(patch, r, c, config: InterpolationConfig):
    """The values of :func:`interpolate_nodes_with_grad`, ``[...,
    n_nodes, D]``."""
    return interpolate_nodes_with_grad(patch, r, c, config)[0]


def interpolate_with_grad(patch, r, c, config=None, cross: bool = False):
    """``(f, dfdr, dfdc)`` (and ``dfdrc`` with ``cross``), each ``[...,
    D]`` float32, with the normalization chain rule: the flattened
    node-major window ``D = n_nodes * C`` (NCC chain-ruled) when the config
    has several nodes and a feature mode, one point otherwise
    (``interpolate_with_grad`` of the JAX package). ``cross`` reads one
    point and returns the mixed derivative, which L2 leaves alone, as
    there; the gradient-field modes ignore nodes and L2."""
    config = config or InterpolationConfig()
    patch = _readable(patch)
    r, c, row_base, shape = _queries(patch, r, c)
    if cross:
        out = _point_with_cross(patch, row_base, r, c, config)
    elif _node_path(config):
        out = (a.reshape(a.shape[0], -1)
               for a in _node_reads(patch, row_base, r, c, config))
    else:
        out = _point_reads(patch, row_base, r, c, config)
    return tuple(a.reshape(*shape, a.shape[-1]) for a in out)


def interpolate(patch, r, c, config=None):
    """The value of :func:`interpolate_with_grad`, ``[..., D]``: the
    (optionally normalized) descriptor at ``(r, c)``, or the flattened
    node window (``interpolate`` of the JAX package)."""
    return interpolate_with_grad(patch, r, c, config)[0]


def bicubic_window_eval(patches, r, c):
    """Bicubic reads with derivatives of a stack of patches: ``patches [N,
    H, W, C]`` (any storage dtype), query n on patch n at ``(r[n], c[n])``
    -> ``(f, dfdr, dfdc)``, each ``[N, C]`` float32, no normalization (the
    JAX package's ``bicubic_window_eval``). One K1 launch on the card."""
    from ..ops import interpolate_cuda
    N, H, W, C = patches.shape
    rows = _readable(patches).reshape(N * H, W, C)
    row_base = torch.arange(N, dtype=torch.int32, device=rows.device) * H
    r = torch.as_tensor(r, dtype=torch.float32, device=rows.device)
    c = torch.as_tensor(c, dtype=torch.float32, device=rows.device)
    return interpolate_cuda.interpolate_rows(rows, H, W, C, row_base, r, c,
                                             False)


# ---------------------------------------------------------------------------
# gradient-field modes (cost patches of costmap BA), batched over queries
# ---------------------------------------------------------------------------

def _fit_cubic_poly(p0, p1, s0, s1):
    """Cubic a+bx+cx^2+dx^3 with p(0)=p0, p(1)=p1, p'(0)=s0, p'(1)=s1."""
    a = p0
    b = s0
    c = 3.0 * (p1 - p0) - 2.0 * s0 - s1
    d = 2.0 * (p0 - p1) + s0 + s1
    return a, b, c, d


def _bilinear_cell(patches, row, r, c):
    """Corner values ``ll, lr, ul, ur [n, C]`` of each query's cell, read
    with the indices clamped into the patch, and the fractional offsets
    ``dy, dx [n]``. ``patches [B, H, W, C]``, ``row, r, c [n]``."""
    H, W = patches.shape[1], patches.shape[2]
    fr, fc = torch.floor(r), torch.floor(c)
    r0, c0 = fr.to(torch.int64), fc.to(torch.int64)
    row = row.to(torch.int64)

    def at(rr, cc):
        return patches[row, torch.clamp(rr, 0, H - 1),
                       torch.clamp(cc, 0, W - 1)].to(torch.float32)

    return (at(r0, c0), at(r0, c0 + 1), at(r0 + 1, c0), at(r0 + 1, c0 + 1),
            r - fr, c - fc)


def _poly_gradient_field(patches, row, r, c):
    """PolyGradientFieldInterpolator (interpolation.h:297-362): channels
    (cost, d/dr, d/dc); horizontal cubics from the values and d/dc at the
    cell corners, a vertical cubic from the two horizontal values and the
    lerped d/dr. ``(f, dfdr, dfdc, dfdrc)``, each ``[n]``; dfdrc is 0."""
    ll, lr, ul, ur, dy, dx = _bilinear_cell(patches, row, r, c)

    def horiz(a, b):
        co = _fit_cubic_poly(a[:, 0], b[:, 0], a[:, 2], b[:, 2])
        f = co[0] + dx * (co[1] + dx * (co[2] + co[3] * dx))
        dfdx = co[1] + dx * (2.0 * co[2] + 3.0 * dx * co[3])
        return f, dfdx

    lf, lower_dfdc = horiz(ll, lr)
    uf, upper_dfdc = horiz(ul, ur)
    lower_dfdr = ll[:, 1] * (1.0 - dx) + lr[:, 1] * dx
    upper_dfdr = ul[:, 1] * (1.0 - dx) + ur[:, 1] * dx
    co = _fit_cubic_poly(lf, uf, lower_dfdr, upper_dfdr)
    f = co[0] + dy * (co[1] + dy * (co[2] + co[3] * dy))
    dfdr = co[1] + dy * (2.0 * co[2] + 3.0 * dy * co[3])
    dfdc = upper_dfdc * dy + (1.0 - dy) * lower_dfdc
    return f, dfdr, dfdc, torch.zeros_like(f)


def _bicubic_fit_matrix_np() -> np.ndarray:
    """16x16 inverse that fits a bicubic surface to the values and the
    derivatives at the 4 cell corners (interpolation.h:364-386), built in
    float64 and stored as float32, as the JAX package stores it. Rows of
    the constraint matrix: values, d/dy, d/dx, d2/dxdy at the corners
    (x, y) in (0,0), (1,0), (0,1), (1,1); columns the monomials x^i y^j,
    j-major."""
    corners = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]

    def mono(i, j, x, y, dx, dy):
        def d(e, x, n):
            coef = 1.0
            for _ in range(n):
                coef *= e
                e -= 1
            return coef * (x ** e) if e >= 0 else 0.0
        return d(i, x, dx) * d(j, y, dy)

    A = np.array([[mono(i, j, x, y, dx, dy)
                   for j in range(4) for i in range(4)]
                  for dx, dy in [(0, 0), (0, 1), (1, 0), (1, 1)]
                  for (x, y) in corners], dtype=np.float64)
    return np.linalg.inv(A).astype(np.float32)


_BICUBIC_FIT_A_INV = torch.from_numpy(_bicubic_fit_matrix_np())


def _bicubic_gradient_field(patches, row, r, c):
    """BiCubicGradientFieldInterpolator (interpolation.h:364-477): channels
    (cost, d/dr, d/dc, d/drdc); a 16-coefficient bicubic surface per cell.
    ``(f, dfdr, dfdc, dfdrc)``, each ``[n]``."""
    ll, lr, ul, ur, dy, dx = _bilinear_cell(patches, row, r, c)
    # [ll, lr, ul, ur] of each channel in turn: the constraint rows' order
    rhs = torch.stack([ll[:, :4], lr[:, :4], ul[:, :4], ur[:, :4]],
                      dim=2).reshape(-1, 16)
    a_inv = _BICUBIC_FIT_A_INV.to(rhs.device)
    C4 = (rhs @ a_inv.T).reshape(-1, 4, 4)        # [n, j, i]
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    xp = torch.stack([one, dx, dx * dx, dx * dx * dx], dim=1)
    yp = torch.stack([one, dy, dy * dy, dy * dy * dy], dim=1)
    dxp = torch.stack([zero, one, 2.0 * dx, 3.0 * dx * dx], dim=1)
    dyp = torch.stack([zero, one, 2.0 * dy, 3.0 * dy * dy], dim=1)
    Cx = torch.einsum("nji,ni->nj", C4, xp)
    Cdx = torch.einsum("nji,ni->nj", C4, dxp)
    return ((yp * Cx).sum(1), (dyp * Cx).sum(1), (yp * Cdx).sum(1),
            (dyp * Cdx).sum(1))


_GRADIENT_FIELDS = {"POLYGRADIENTFIELD": _poly_gradient_field,
                    "BICUBICGRADIENTFIELD": _bicubic_gradient_field}


def gradient_field_eval(patches, row, r, c, mode: str):
    """``(f, dfdr, dfdc, dfdrc)``, each ``[n, 1]`` float32: the
    gradient-field interpolation of cost patches ``[B, H, W, 3|4]`` at
    patch coordinates ``(r[n], c[n])`` of patch ``row[n]`` (the JAX
    package's ``interpolate_with_grad(..., cross=True)`` for these modes,
    one query at a time). Cell corners are read clamped into the patch;
    POLYGRADIENTFIELD gives dfdrc = 0."""
    if mode not in _GRADIENT_FIELDS:
        raise ValueError(f"interpolation mode {mode} is not a gradient "
                         "field of cost patches")
    return tuple(o[:, None] for o in _GRADIENT_FIELDS[mode](patches, row,
                                                             r, c))

