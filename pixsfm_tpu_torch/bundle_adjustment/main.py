"""Bundle adjustment orchestration (reference: pixsfm/bundle_adjustment/main.py).

Port of ``pixsfm_tpu/bundle_adjustment/main.py`` for the ``geometric``,
``feature_reference``, ``costmaps`` and ``patch_warp`` strategies. All
funnel into :func:`pixsfm_tpu_torch.ops.schur.ba_solve` with batched
residual closures and closed-form Jacobians (``project_with_jac`` + the
analytic interpolation derivatives). The featuremetric reads take
``ops/interpolate_cuda.interpolate`` for any feature config: kernel K1 for
BICUBIC (one query per observation, or one per node and observation with
node windows), plain PyTorch for BILINEAR, NEARESTNEIGHBOR and
BICUBICCHAIN. Under NCC ``feature_reference`` has no closed-form Jacobian
(as in the JAX package, whose builder returns None there): ``ba_solve``
takes forward mode over the residual, whose read
(``interpolate_fwd``) carries its own derivatives. The
costmap residual interpolates the float32 cost patches with the gradient
field of ``base/interpolation.py`` (``bundle_adjustment/costmaps.py``
extracts them); the patch-warp residual (``bundle_adjustment/
patch_warp.py``) reads K1 at the warped nodes, and in its joint mode each
observation carries its source view's pose as a second pose block
(``src_idx``).

``_run_ba_cached`` pads and lays out the problem exactly as the JAX package
does (power-of-two buckets, the dense/CG switch by problem size with the
track pairs of the dense step, the point-major grid layout past the one-hot
budget), so both packages pick the same regime for the same scene, and
dispatches the LM in segments when ``segment_iterations > 0``. Scenes with
several camera models carry each observation's model index; a chunk's
observations are projected in groups of one model each (the JAX package
switches per observation with ``lax.switch``).

``parallel: {enabled, n_devices}`` gives a device mesh
(``parallel/sharded.py``): ``_run_ba_cached`` pads the observation axis to
a multiple of the mesh size and ``ba_solve`` splits it into one shard per
device, in the flat regime (as in the JAX package, the grid layout needs
one device). Under a mesh every featuremetric strategy takes its
``*_window`` layout (``feature_reference_window``, ``costmap_window``,
``patch_warp_window``): each observation carries its own patch window,
corner, scale and upsampling in its data, so the feature payload splits
with the observations and each shard reads only its own windows (K1 for
BICUBIC, each window one row block).
"""

from __future__ import annotations

import dataclasses
from copy import deepcopy
from typing import Dict

import numpy as np
import torch

from .. import logger, resolve_device
from ..base import interpolation_default_conf, solver_default_conf
from ..base.cameras import CAMERA_MODELS, img_from_cam
from ..base.geometry import apply_pose
from ..base.interpolation import (InterpolationConfig, check_residual_config,
                                  check_window_config, gradient_field_eval,
                                  output_dim)
from ..base.losses import make_loss
from ..base.projection import project_with_jac
from ..config import merge
from ..features.featuremaps import FeatureView
from ..ops import ba_eval_cuda, schur
from ..ops.interpolate_cuda import interpolate, interpolate_fwd
from ..util.misc import bucket
from ..util.profiling import host, span, to_device
from ..ops.schur import (BAObservations, BAOptions, BAState, ba_solve,
                         make_pair_list)
from ..parallel.sharded import parallel_mesh
from .patch_warp import (build_patch_warp_residual,
                         build_patch_warp_residual_jac, patch_warp_ba)
from .problem import PackedBA, pack_ba_problem

__all__ = ["BundleAdjuster", "GeometricBundleAdjuster",
           "FeatureReferenceBundleAdjuster", "CostMapBundleAdjuster",
           "PatchWarpBundleAdjuster"]


# Bytes of float32 temporaries a featuremetric BA evaluation chunk may hold
# (the residual's Jacobian J [n, D, 6+k+3], J with the residual column and
# its weighted copy, i.e. ~3 * 4 * D * (10 + k) bytes per observation). A
# node window multiplies D (16 nodes at 128 channels: D = 2048, ~0.9 GB for
# the default 8192 observations): the chunk is cut to the largest power of
# two under this budget; at one node (D = 128) the default chunk fits.
_EVAL_CHUNK_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# batched residuals: fn(q [n,4], t [n,3], cam [n,k], X [n,3], obs_slice, ctx)
# ---------------------------------------------------------------------------

def _safe_project(model, cam, qvec, tvec, X):
    x_cam = apply_pose(qvec, tvec, X)
    z = x_cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    return img_from_cam(model, cam, x_cam[..., :2] / z)


def _model_groups(mi, n_models: int):
    """Observation indices of a chunk per camera model: ``[(model index,
    indices)]`` for the models present (one host sync per chunk)."""
    order = torch.argsort(mi, stable=True)
    counts = torch.bincount(mi, minlength=n_models).tolist()
    out, s = [], 0
    for m, c in enumerate(counts):
        if c:
            out.append((m, order[s:s + c]))
        s += c
    return out


def _project(model, cam, qvec, tvec, X, mi=None):
    """Pixels of a chunk. ``model``: a camera-model name, or a tuple of
    names with ``mi`` each observation's index into it (mixed models: each
    group of one model is projected with its own code and scattered back
    in order, ``cam`` padded to the widest model)."""
    if mi is None:
        return _safe_project(model, cam, qvec, tvec, X)
    parts, order = [], []
    for m, idx in _model_groups(mi, len(model)):
        km = CAMERA_MODELS[model[m]].num_params
        parts.append(_safe_project(model[m], cam[idx, :km], qvec[idx],
                                   tvec[idx], X[idx]))
        order.append(idx)
    # out of place (a concatenation put back in order), so forward mode
    # under torch.func.vmap sees no in-place write
    return torch.cat(parts)[torch.argsort(torch.cat(order))]


def _project_jac(model, cam, qvec, tvec, X, mi=None):
    """Pixels and the Jacobian ``[n, 2, 6 + k + 3]`` of a chunk (``model``
    and ``mi`` as for :func:`_project`; the intrinsics columns of a model
    with fewer than ``k`` parameters are padded with zeros on the right)."""
    if mi is None:
        pix, Jp, Jc, Jx = project_with_jac(model, cam, qvec, tvec, X)
        return pix, torch.cat([Jp, Jc, Jx], dim=-1)
    k = cam.shape[-1]
    pix = X.new_empty(X.shape[:-1] + (2,))
    J = X.new_zeros(X.shape[:-1] + (2, 9 + k))
    for m, idx in _model_groups(mi, len(model)):
        km = CAMERA_MODELS[model[m]].num_params
        p, Jp, Jc, Jx = project_with_jac(model[m], cam[idx, :km], qvec[idx],
                                         tvec[idx], X[idx])
        pix[idx] = p
        J[idx] = torch.cat([Jp, Jc, Jc.new_zeros(Jc.shape[:-1] + (k - km,)),
                            Jx], dim=-1)
    return pix, J


def _split_models(model, obs_slice, n_data: int):
    """``(model, data, mi)``: with a tuple of models (``_pack`` gives one
    for several), each observation's model index is the last entry of
    ``obs_slice``."""
    if isinstance(model, tuple):
        return model, obs_slice[:n_data], obs_slice[n_data]
    return model, obs_slice[:n_data], None


def _build_geometric(model):
    def residual_fn(qvec, tvec, cam, X, obs_slice, ctx):
        m, (xy_obs,), mi = _split_models(model, obs_slice, 1)
        return _project(m, cam, qvec, tvec, X, mi) - xy_obs
    return residual_fn


def _build_geometric_jac(model):
    def residual_jac_fn(qvec, tvec, cam, X, obs_slice, ctx):
        m, (xy_obs,), mi = _split_models(model, obs_slice, 1)
        pix, J = _project_jac(m, cam, qvec, tvec, X, mi)
        return pix - xy_obs, J
    return residual_jac_fn


class _Patches:
    """The placement of a featuremetric solve's packed patches: corner,
    scale and upsampling of each."""

    def __init__(self, pf, dev):
        _, self.H, self.W, self.C = pf.patches.shape
        self.corners = to_device(pf.corners, dev, torch.float32)
        self.scales = to_device(pf.scales, dev, torch.float32)
        self.ups = to_device(pf.upsampling, dev, torch.float32)

    def coords(self, row, pix):
        """Patch coords ``pc [n, 2]`` of ``pix`` and ``d pc / d pix``."""
        sc, up = self.scales[row], self.ups[row][:, None]
        return (pix * sc - 0.5 - self.corners[row]) * up, sc * up


class _PatchRows(_Patches):
    """The packed feature patches as the reads take them: the flat ``[B*H,
    W, C]`` row view."""

    def __init__(self, pf, dev):
        super().__init__(pf, dev)
        self.rows = pf.patches.reshape(-1, self.W, self.C)

    def read(self, row, pix, interp: InterpolationConfig):
        """``(pc [n, 2], d pc / d pix [n, 2], f, dfdr, dfdc)``: the patch
        coords of ``pix`` and the read there (``[n, D]`` each)."""
        pc, su = self.coords(row, pix)
        f, dfdr, dfdc = interpolate(self.rows, self.H, self.W, self.C,
                                    row * self.H, pc[:, 1], pc[:, 0], interp)
        return pc, su, f, dfdr, dfdc

    def value(self, row, pix, interp: InterpolationConfig):
        """``(pc, f)``: the read's value, forward-differentiable in ``pix``
        through its own derivatives (``interpolate_fwd``)."""
        pc, _ = self.coords(row, pix)
        return pc, interpolate_fwd(self.rows, self.H, self.W, self.C,
                                   row * self.H, pc[:, 1], pc[:, 0], interp)


class _Windows(_PatchRows):
    """The patch windows ``[n, H, W, C]`` that a chunk's observations
    carry in the ``*_window`` layouts, with each one's corner, scale and
    upsampling; observation ``i`` reads window ``i``."""

    def __init__(self, windows, corners, scales, ups):
        n, self.H, self.W, self.C = windows.shape
        self.corners, self.scales, self.ups = corners, scales, ups
        self.rows = windows.reshape(n * self.H, self.W, self.C)


class _CostPatches(_Patches):
    """The float32 cost patches ``[B, H, W, 3|4]`` of a costmap solve, read
    with their gradient field (``[n, 1]`` values)."""

    def __init__(self, pf, dev):
        super().__init__(pf, dev)
        self.patches = pf.patches.to(device=dev, dtype=torch.float32)

    def read(self, row, pix, interp: InterpolationConfig):
        pc, su = self.coords(row, pix)
        f, dfdr, dfdc, _ = gradient_field_eval(self.patches, row, pc[:, 1],
                                               pc[:, 0], interp.mode)
        return pc, su, f, dfdr, dfdc

    def value(self, row, pix, interp: InterpolationConfig):
        pc, _, f, _, _ = self.read(row, pix, interp)
        return pc, f


class _CostWindows(_CostPatches):
    """The cost patches a chunk's observations carry (``costmap_window``),
    read as :class:`_CostPatches` reads its stack."""

    def __init__(self, windows, corners, scales, ups):
        _, self.H, self.W, self.C = windows.shape
        self.corners, self.scales, self.ups = corners, scales, ups
        self.patches = windows


def window_obs_data(pf, rows, obs_data):
    """The ``*_window`` layout of a row-layout ``obs_data`` whose first
    entry is each observation's patch row in ``pf``: that row's window,
    corner, scale and upsampling in its place (the windows where the
    patches are; ``ba_solve`` moves each shard's part to its device)."""
    rows = np.asarray(rows, np.int64)
    t = torch.as_tensor(rows)
    return (pf.patches.index_select(0, t.to(pf.patches.device)),
            pf.corners[rows].astype(np.float32),
            pf.scales[rows].astype(np.float32),
            pf.upsampling[rows].astype(np.float32), *obs_data[1:])


def _windowed(build, windows_cls):
    """The ``*_window`` layout of a residual builder (``main.py:156-217``
    of the JAX package): ``obs_slice`` starts with the observations' own
    ``(window, corner, scale, ups)`` in place of their patch rows, and
    observation ``i`` of a chunk reads window ``i``; ``ctx`` is unused."""
    def builder(*key):
        fn = build(*key)
        if fn is None:
            return None

        def window_fn(*args):
            *params, obs_slice, _ = args
            window, corner, scale, ups, *rest = obs_slice
            row = torch.arange(window.shape[0], device=window.device)
            return fn(*params, (row, *rest),
                      windows_cls(window, corner, scale, ups))
        return window_fn
    return builder


def _bounds_violation(pc, H: int, W: int):
    """Hinge distance (patch pixels) outside [0, H-1] x [0, W-1] (the
    ``check_bounds`` residual channel of ``base/interpolation.py:556``)."""
    r, c = pc[:, 1], pc[:, 0]
    return (torch.clamp(r - (H - 1.0), min=0.0) + torch.clamp(-r, min=0.0)
            + torch.clamp(c - (W - 1.0), min=0.0) + torch.clamp(-c, min=0.0))


def _interp_residual(interp: InterpolationConfig, ctx, row, pix,
                     target=None):
    """The interpolated patch value at ``pix`` ``[n, D]`` (less ``target``
    when given), with the ``check_bounds`` violation as one more column."""
    pc, f = ctx.value(row, pix, interp)
    if target is not None:
        f = f - target
    if interp.check_bounds:
        f = torch.cat([f, _bounds_violation(pc, ctx.H, ctx.W)[:, None]],
                      dim=1)
    return f


def _interp_residual_jac(interp: InterpolationConfig, ctx, row, pix, Jpix,
                         target=None):
    """:func:`_interp_residual` and its Jacobian ``[n, D(+1), 6+k+3]``
    from the pixel Jacobian ``Jpix [n, 2, 6+k+3]``: the shared tail of the
    featuremetric builders (``_interp_residual_jac``, ``main.py:297`` of
    the JAX package, which reads ``interpolate_residual_with_grad`` there
    and refuses its single-point NCC)."""
    check_residual_config(interp)
    pc, su, f, dfdr, dfdc = ctx.read(row, pix, interp)
    if target is not None:
        f = f - target
    Jc_ = (su[:, 0, None] * Jpix[:, 0])[:, None, :]
    Jr_ = (su[:, 1, None] * Jpix[:, 1])[:, None, :]
    J = dfdc[:, :, None] * Jc_ + dfdr[:, :, None] * Jr_
    if J.shape[1] != f.shape[1]:
        # a scalar read against a longer target broadcasts, as in JAX
        J = J.expand(-1, f.shape[1], -1)
    if interp.check_bounds:
        H, W = ctx.H, ctx.W
        r_, c_ = pc[:, 1], pc[:, 0]
        dv_dr = (r_ > H - 1.0).float() - (r_ < 0.0).float()
        dv_dc = (c_ > W - 1.0).float() - (c_ < 0.0).float()
        Jv = dv_dc[:, None, None] * Jc_ + dv_dr[:, None, None] * Jr_
        f = torch.cat([f, _bounds_violation(pc, H, W)[:, None]], dim=1)
        J = torch.cat([J, Jv], dim=1)
    return f, J


def _build_feature_reference(model, interp: InterpolationConfig):
    def residual_fn(qvec, tvec, cam, X, obs_slice, ctx):
        m, (row, target), mi = _split_models(model, obs_slice, 2)
        return _interp_residual(interp, ctx, row,
                                _project(m, cam, qvec, tvec, X, mi), target)
    return residual_fn


def _build_feature_reference_jac(model, interp: InterpolationConfig):
    """The closed-form Jacobian builder; None under NCC, whose normalization
    it does not chain (``main.py:324-330`` of the JAX package): ``ba_solve``
    then takes forward mode over the residual."""
    if interp.ncc_normalize:
        return None

    def residual_jac_fn(qvec, tvec, cam, X, obs_slice, ctx):
        m, (row, target), mi = _split_models(model, obs_slice, 2)
        pix, Jpix = _project_jac(m, cam, qvec, tvec, X, mi)  # [n, 2, 6+k+3]
        return _interp_residual_jac(interp, ctx, row, pix, Jpix, target)
    return residual_jac_fn


def _build_feature_reference_fused(model, interp: InterpolationConfig, ctx,
                                   loss):
    """The whole-axis evaluator of ``feature_reference`` that
    :func:`ops.schur.ba_solve` takes in place of its chunk loop: one launch
    of kernel K4 (``ops/ba_eval_cuda.ba_eval``) per evaluation, for inputs
    that ``ba_eval_cuda.takes`` accepts."""
    def fused_eval(state, sh, mode):
        row, target = sh.obs_data
        return ba_eval_cuda.ba_eval(mode, model, interp, loss, state,
                                    sh.img_idx, sh.cam_idx, sh.pt_idx,
                                    sh.valid, row, target, ctx)
    return fused_eval


def _build_costmap(model, interp: InterpolationConfig):
    def residual_fn(qvec, tvec, cam, X, obs_slice, ctx):
        m, (row,), mi = _split_models(model, obs_slice, 1)
        return _interp_residual(interp, ctx, row,
                                _project(m, cam, qvec, tvec, X, mi))
    return residual_fn


def _build_costmap_jac(model, interp: InterpolationConfig):
    def residual_jac_fn(qvec, tvec, cam, X, obs_slice, ctx):
        m, (row,), mi = _split_models(model, obs_slice, 1)
        pix, Jpix = _project_jac(m, cam, qvec, tvec, X, mi)
        return _interp_residual_jac(interp, ctx, row, pix, Jpix)
    return residual_jac_fn


_RESIDUAL_BUILDERS = {
    "geometric": (_build_geometric, _build_geometric_jac),
    "feature_reference": (_build_feature_reference,
                          _build_feature_reference_jac),
    "costmap": (_build_costmap, _build_costmap_jac),
    "patch_warp": (build_patch_warp_residual, build_patch_warp_residual_jac),
}
for _key, _cls in (("feature_reference", _Windows), ("costmap", _CostWindows),
                   ("patch_warp", _Windows)):
    _RESIDUAL_BUILDERS[_key + "_window"] = tuple(
        _windowed(b, _cls) for b in _RESIDUAL_BUILDERS[_key])


class BundleAdjuster:
    default_conf = {
        "strategy": "feature_reference",
        "apply": True,
        "interpolation": interpolation_default_conf,
        "level_indices": None,
        "max_tracks_per_problem": 10,
        "num_threads": -1,
        "optimizer": {
            "loss": {"name": "cauchy", "params": [0.25]},
            "solver": {**solver_default_conf, "parameter_tolerance": 0.0,
                       "use_inner_iterations": True, "num_threads": -1},
            "print_summary": False,
            "refine_focal_length": True,
            "refine_principal_point": False,
            "refine_extra_params": True,
            "refine_extrinsics": True,
        },
        "references": {
            "loss": {"name": "cauchy", "params": [0.25]},
            "iters": 100,
            "keep_observations": False,
            "compute_offsets3D": False,
            "num_threads": -1,
        },
        "repeats": 1,
        "parallel": {"enabled": False, "n_devices": None},
    }

    def __init__(self, conf=None, device=None):
        self.conf = merge(self.default_conf, conf or {})
        self.device = resolve_device(device)

    @classmethod
    def create(cls, conf=None, device=None):
        strategy = cls.default_conf["strategy"]
        if conf is not None and "strategy" in conf:
            strategy = conf["strategy"]
        strategy_to_solver = {
            "feature_reference": FeatureReferenceBundleAdjuster,
            "geometric": GeometricBundleAdjuster,
            "costmaps": CostMapBundleAdjuster,
            "patch_warp": PatchWarpBundleAdjuster,
        }
        return strategy_to_solver[strategy](conf, device=device)

    # -- shared -------------------------------------------------------------
    def _optimizer_flags(self):
        opt = self.conf.optimizer
        return dict(
            refine_focal_length=bool(opt.get("refine_focal_length", True)),
            refine_principal_point=bool(opt.get("refine_principal_point",
                                                False)),
            refine_extra_params=bool(opt.get("refine_extra_params", True)),
            refine_extrinsics=bool(opt.get("refine_extrinsics", True)),
        )

    def _ba_options(self, **overrides) -> BAOptions:
        return BAOptions.from_solver_conf(self.conf.optimizer.get("solver"),
                                          **overrides)

    def _parallel_mesh(self):
        """The device mesh of ``parallel.enabled`` when more than one
        device is available, else None (``parallel.sharded.parallel_mesh``):
        every strategy's ``_run_ba_cached`` then shards its observations."""
        return parallel_mesh(self.conf.get("parallel"), self.device)

    def _pack(self, reconstruction, problem_setup):
        """``(packed, model, mi)``: the packed problem, its camera model (a
        tuple of the models when there are several) and, then, each
        observation's index into that tuple (else None)."""
        packed = pack_ba_problem(reconstruction, problem_setup,
                                 **self._optimizer_flags())
        if len(packed.cam_models) > 1:
            return (packed, packed.cam_models,
                    packed.cam_model_idx[packed.obs_cam].astype(np.int64))
        return packed, packed.cam_model, None

    def _run_ba_cached(self, reconstruction, packed: PackedBA, residual_key,
                       obs_data, ctx, loss, opts: BAOptions,
                       obs_valid=None, src_idx=None,
                       eval_bytes_per_obs: int = 0) -> Dict:
        """Lay the problem out as the JAX package does and run
        :func:`ba_solve` (``pixsfm_tpu/bundle_adjustment/main.py:540``).
        ``src_idx``: each observation's second pose block (patch-warp
        joint source poses); the grid layout is not taken with it.
        ``eval_bytes_per_obs``: the float32 temporaries one observation's
        Jacobian evaluation holds; once the layout is chosen (with
        ``obs_chunk``, as in the JAX package) the evaluation chunk is cut
        to the largest power of two under ``_EVAL_CHUNK_BYTES``.
        The summary's ``time`` is the duration of its three spans,
        ``ba.layout``, ``ba.lm`` and ``ba.unpack``."""
        with span("ba.layout", timed=True) as layout:
            laid = self._layout(packed, residual_key, obs_data, ctx, loss,
                                opts, obs_valid, src_idx, eval_bytes_per_obs)
        if laid is None:
            logger.info("BA: empty problem (no observations); skipping.")
            return dict(initial_cost=0.0, final_cost=0.0, iterations=0,
                        time=layout.seconds)
        solve, state0, opts, Np = laid
        with span("ba.lm", timed=True) as lm:
            seg = int(opts.segment_iterations)
            if seg <= 0:
                state, summary = solve(state0, opts)
                out = {k: v for k, v in summary.items()
                       if k not in ("lam", "done")}
            else:
                state, out = self._run_segments(solve, state0, opts, seg)
        with span("ba.unpack", timed=True) as unpack:
            packed.unpack_into(
                reconstruction,
                *(host(a, "sync.unpack").numpy() for a in (
                    state.qvec, state.tvec, state.cams, state.xyz[:Np])))
        out["linear_solver"] = opts.linear_solver
        out["obs_grid_T"] = int(opts.obs_grid_T)
        out["time"] = layout.seconds + lm.seconds + unpack.seconds
        logger.info("BA Time: %.3fs, cost change: %.6g --> %.6g (%d iters, "
                    "%d CG steps)", out["time"], out["initial_cost"],
                    out["final_cost"], int(out["iterations"]),
                    int(out["cg_iterations"]))
        self._maybe_print_summary(out, packed)
        return out

    def _layout(self, packed: PackedBA, residual_key, obs_data, ctx, loss,
                opts: BAOptions, obs_valid, src_idx, eval_bytes_per_obs):
        """The padded layout of :meth:`_run_ba_cached` on the device:
        ``(solve(state, opts, **kw), state0, opts, Np)``, or None for a
        problem with no observation."""
        dev = self.device
        mesh = self._parallel_mesh()
        ndev = 1 if mesh is None else mesh.size
        O = len(packed.obs_img)
        Np = len(packed.point_ids)
        if O == 0 or Np == 0:
            return None
        O_pad = bucket(O + 1)          # always >= 1 padded slot (pair pad)
        O_pad = -(-O_pad // ndev) * ndev     # a shardable observation axis
        Np_pad = bucket(Np, minimum=4)

        # solver-by-size switch (reference bundle_optimizer.h:180-191): the
        # dense step for small camera systems, CG beyond
        M = 6 * len(packed.image_ids) + packed.cams.size
        track_lens = np.bincount(packed.obs_pt, minlength=max(Np, 1))
        n_pairs = int(np.sum(track_lens.astype(np.int64) ** 2))
        if opts.linear_solver == "dense" and (M > 1500 or n_pairs > 20_000):
            opts = dataclasses.replace(opts, linear_solver="cg")
        pairs = None
        if opts.linear_solver == "dense":
            # padded pairs point at the invalid slot O
            pairs = []
            for p in make_pair_list(packed.obs_pt, Np):
                Q_pad = bucket(len(p), minimum=4)
                pairs.append(np.concatenate(
                    [p, np.full(Q_pad - len(p), O, np.int32)]))

        # large-Np regime: the point-major GRID layout (slot = point*T +
        # rank, exactly Np_pad*T slots) when it does not inflate the obs
        # axis beyond 2x and tiles the obs chunks; the JAX package's
        # [Np, T] table regime is the flat index_add_ layout here
        T_max = int(track_lens.max(initial=1))
        T_b = max(1 << int(np.ceil(np.log2(max(T_max, 1)))), 4)
        large_pts = Np_pad * opts.obs_chunk > schur._ONEHOT_BUDGET
        O_grid = Np_pad * T_b
        real_valid = (np.ones(O, bool) if obs_valid is None
                      else np.asarray(obs_valid, bool))
        if opts.linear_solver == "cg" and large_pts and src_idx is None \
                and ndev == 1 and O_grid <= 2 * O_pad \
                and O_grid % opts.obs_chunk == 0:
            order = np.argsort(packed.obs_pt, kind="stable")
            sorted_pts = np.asarray(packed.obs_pt)[order]
            starts = np.searchsorted(sorted_pts, np.arange(Np_pad),
                                     side="left")
            slot = sorted_pts * T_b + (np.arange(O) - starts[sorted_pts])
            src = np.zeros(O_grid, np.int64)          # holes copy obs 0
            valid = np.zeros(O_grid, bool)
            src[slot] = order
            valid[slot] = real_valid[order]
            opts = dataclasses.replace(opts, obs_grid_T=T_b)
            pt_idx = np.arange(O_grid) // T_b

            def prep(a):
                return np.asarray(a)[src]
        else:
            valid = np.zeros(O_pad, bool)
            valid[:O] = real_valid

            def prep(a):
                a = np.asarray(a)
                return np.concatenate([a, np.zeros((O_pad - O,) + a.shape[1:],
                                                   a.dtype)])
            pt_idx = prep(packed.obs_pt)

        if eval_bytes_per_obs:
            fit = max(_EVAL_CHUNK_BYTES // int(eval_bytes_per_obs), 1)
            opts = dataclasses.replace(opts, obs_chunk=int(max(min(
                opts.obs_chunk, 1 << (int(fit).bit_length() - 1)), 256)))

        def put(a, dtype=None, device=dev):
            return to_device(np.ascontiguousarray(a), device, dtype)

        # under a mesh the host arrays stay on the host: ba_solve moves
        # each shard's slice to its own device
        obs_dev = dev if mesh is None else torch.device("cpu")

        def put_obs(a, dtype=None):
            if isinstance(a, torch.Tensor):     # patch windows, where made
                return torch.cat([a, a.new_zeros((O_pad - O,)
                                                 + tuple(a.shape[1:]))])
            return put(prep(a), dtype, obs_dev)

        obs = BAObservations(
            img_idx=put_obs(packed.obs_img, torch.long),
            cam_idx=put_obs(packed.obs_cam, torch.long),
            pt_idx=put(pt_idx, torch.long, obs_dev),
            obs_data=tuple(put_obs(a) for a in obs_data),
            valid=put(valid, device=obs_dev),
            pair_o1=None if pairs is None else put(pairs[0], torch.long),
            pair_o2=None if pairs is None else put(pairs[1], torch.long),
            src_idx=None if src_idx is None
            else put_obs(np.asarray(src_idx), torch.long))
        if mesh is not None:
            logger.info("BA: sharding %d observations over %d devices.", O,
                        ndev)
        xyz = np.concatenate([packed.xyz, np.zeros((Np_pad - Np, 3))]) \
            .astype(np.float32)
        xyz[Np:] = [0.0, 0.0, 10.0]   # padded points safely in front
        state0 = BAState(put(packed.qvec, torch.float32),
                         put(packed.tvec, torch.float32),
                         put(packed.cams, torch.float32),
                         put(xyz))
        point_free = np.zeros(Np_pad, bool)
        point_free[:Np] = packed.point_free
        free = (put(packed.pose_free), put(packed.tvec_free),
                put(packed.cam_free), put(point_free))
        build, build_jac = _RESIDUAL_BUILDERS[residual_key[0]]
        # K4 evaluates feature_reference on one device where it takes the
        # inputs (ba_eval_cuda.takes: one camera model of its four, BICUBIC
        # at the single node without NCC, a loss it knows, bf16 / f32 patch
        # rows of 64 / 128 channels on the card); every other residual, a
        # mesh and every other input keep ba_solve's chunk loop
        fused_eval = (_build_feature_reference_fused(*residual_key[1:], ctx,
                                                     loss)
                      if residual_key[0] == "feature_reference"
                      and mesh is None and ba_eval_cuda.takes(
                          *residual_key[1:], loss, ctx.rows) else None)

        def solve(state, opts, **kw):
            return ba_solve(
                build(*residual_key[1:]), state, obs, loss, *free, opts=opts,
                ctx=ctx, residual_jac_fn=build_jac(*residual_key[1:]),
                mesh=mesh, fused_eval=fused_eval, **kw)

        return solve, state0, opts, Np

    @staticmethod
    def _run_segments(solve, state, opts: BAOptions, seg: int):
        """Segmented dispatch (``pixsfm_tpu/bundle_adjustment/main.py:
        720-768``): the LM runs ``seg`` iterations at a time, λ carried
        from one segment to the next; it stops on ``done`` or a short
        segment. Ctrl-C lands between segments and keeps the state of the
        last completed one (``interrupted`` in the summary)."""
        seg_opts = dataclasses.replace(opts, max_iterations=seg)
        lam = opts.initial_lambda
        out: Dict = {}
        iters_total = cg_total = 0
        interrupted = False
        try:
            while iters_total < opts.max_iterations:
                cap = min(seg, opts.max_iterations - iters_total)
                state_n, s = solve(state, seg_opts, lam0=lam, max_iters=cap)
                state, lam = state_n, s["lam"]
                iters_total += int(s["iterations"])
                cg_total += int(s["cg_iterations"])
                out.setdefault("initial_cost", s["initial_cost"])
                out["final_cost"] = s["final_cost"]
                logger.info("BA progress: cost %.6g (%d/%d iterations)",
                            s["final_cost"], iters_total,
                            opts.max_iterations)
                if s["done"] or int(s["iterations"]) < cap:
                    break
        except KeyboardInterrupt:
            interrupted = True
            logger.warning("BA interrupted; keeping the state of the last "
                           "completed segment (%d iterations).", iters_total)
        out.setdefault("initial_cost", float("nan"))
        out.setdefault("final_cost", out["initial_cost"])
        out.update(iterations=iters_total, cg_iterations=cg_total,
                   interrupted=interrupted)
        return state, out

    def _maybe_print_summary(self, out, packed):
        if not self.conf.optimizer.get("print_summary"):
            return
        logger.info(
            "BA summary:\n  images: %d (cameras: %d)\n  points: %d\n"
            "  observations: %d\n  initial cost: %.6g\n  final cost: %.6g\n"
            "  cost change: %.3f%%\n  iterations: %d\n  wall time: %.3fs",
            len(packed.image_ids), len(packed.camera_ids),
            len(packed.point_ids), len(packed.obs_img),
            out["initial_cost"], out["final_cost"],
            100.0 * (out["initial_cost"] - out["final_cost"])
            / max(out["initial_cost"], 1e-12),
            int(out["iterations"]), out["time"])

    def refine(self, reconstruction, *args, **kwargs) -> Dict:
        raise NotImplementedError

    def refine_multilevel(self, reconstruction, feature_manager,
                          problem_setup=None) -> Dict:
        level_indices = self.conf.get("level_indices")
        levels = (level_indices if level_indices not in (None, "all")
                  else list(reversed(range(feature_manager.num_levels))))
        outputs: Dict[str, list] = {}
        with span("ba"):
            for _ in range(int(self.conf.get("repeats", 1))):
                for level in levels:
                    with span("ba.level"):
                        out = self.refine(reconstruction,
                                          feature_manager.fset(level),
                                          problem_setup=problem_setup)
                    for k, v in out.items():
                        outputs.setdefault(k, []).append(v)
        return outputs


class GeometricBundleAdjuster(BundleAdjuster):
    """Reprojection-error BA (reference: geometric_bundle_optimizer.h:12-88).
    Loss default trivial like COLMAP."""

    default_conf = deepcopy(BundleAdjuster.default_conf)
    default_conf["strategy"] = "geometric"
    default_conf["optimizer"]["loss"] = {"name": "trivial", "params": []}

    def refine(self, reconstruction, feature_set=None,
               problem_setup=None) -> Dict:
        with span("ba.pack"):
            packed, model, mi = self._pack(reconstruction, problem_setup)
            obs_data = (np.asarray(packed.obs_xy, np.float32),)
        return self._run_ba_cached(
            reconstruction, packed, ("geometric", model),
            obs_data if mi is None else obs_data + (mi,), None,
            make_loss(self.conf.optimizer.get("loss")), self._ba_options())

    def refine_multilevel(self, reconstruction, feature_manager=None,
                          problem_setup=None) -> Dict:
        with span("ba"), span("ba.level"):
            out = self.refine(reconstruction, None,
                              problem_setup=problem_setup)
        return {k: [v] for k, v in out.items()}


class FeatureReferenceBundleAdjuster(BundleAdjuster):
    """Featuremetric BA toward per-track robust references (reference:
    feature_reference_bundle_optimizer.h:21-149, ba/main.py:105-154)."""

    default_conf = deepcopy(BundleAdjuster.default_conf)
    default_conf["strategy"] = "feature_reference"

    def refine(self, reconstruction, feature_set, problem_setup=None,
               references=None) -> Dict:
        from .references import extract_references

        with span("ba.pack"):
            packed, model, mi = self._pack(reconstruction, problem_setup)
            interp = InterpolationConfig.from_conf(
                self.conf.get("interpolation"))
            check_window_config(interp)
            view = FeatureView.from_reconstruction(feature_set,
                                                   reconstruction,
                                                   packed.point_ids)
            pf = view.packed
        with span("ba.references", timed=True) as refs:
            if references is None:
                references = extract_references(
                    reconstruction, feature_set, view, self.conf.references,
                    interp, point3D_ids=packed.point_ids,
                    mesh=self._parallel_mesh())

        # per-observation patch row + target descriptor; observations
        # without an extracted patch or a reference get weight 0
        with span("ba.pack"):
            O = len(packed.obs_img)
            names = {iid: im.name
                     for iid, im in reconstruction.images.items()}
            rows = np.asarray([pf.row_or(names[int(iid)], int(p2d))
                               for iid, p2d in zip(packed.obs_image_id,
                                                   packed.obs_p2D_idx)],
                              np.int64).reshape(O)
            D = output_dim(interp.mode, pf.channels, interp.n_nodes)
            desc = np.zeros((len(packed.point_ids), D), np.float32)
            has_ref = np.zeros(len(packed.point_ids), bool)
            for s, pid in enumerate(packed.point_ids):
                ref = references.get(int(pid))
                if ref is not None:
                    desc[s] = ref.descriptor
                    has_ref[s] = True
            obs_valid = (rows >= 0) & has_ref[packed.obs_pt]
            if not obs_valid.all():
                logger.warning("feature_reference BA: %d/%d observations "
                               "have no patch/reference; excluded.",
                               int((~obs_valid).sum()), O)
            rows = np.where(obs_valid, rows, 0)
            targets = np.where(obs_valid[:, None], desc[packed.obs_pt], 0.0)
            obs_data = (rows, targets.astype(np.float32))
            if mi is not None:
                obs_data += (mi,)
        with span("ba.layout"):
            key, ctx = "feature_reference", _PatchRows(pf, self.device)
            if self._parallel_mesh() is not None:
                # the multi-device payload layout: each observation carries
                # its own window, so the feature payload splits with the
                # shards
                key, ctx = key + "_window", ()
                obs_data = window_obs_data(pf, rows, obs_data)
        out = self._run_ba_cached(
            reconstruction, packed, (key, model, interp), obs_data, ctx,
            make_loss(self.conf.optimizer.get("loss")), self._ba_options(),
            obs_valid=obs_valid,
            eval_bytes_per_obs=4 * (D + int(interp.check_bounds))
            * (10 + packed.cams.shape[1]) * 3)
        out["references_time"] = refs.seconds
        return out


class CostMapBundleAdjuster(BundleAdjuster):
    """BA over precomputed costmaps (reference:
    costmap_bundle_optimizer.h:17-132); ``costmaps.py`` extracts them and
    wires the solve."""

    default_conf = deepcopy(BundleAdjuster.default_conf)
    default_conf["strategy"] = "costmaps"
    default_conf["costmaps"] = {
        "loss": {"name": "cauchy", "params": [0.25]},
        "as_gradientfield": True,
        "compute_cross_derivative": False,
        "num_threads": -1,
        "dense_cut_size": 100,
        "upsampling_factor": 1,
    }

    def refine(self, reconstruction, feature_set, problem_setup=None
               ) -> Dict:
        from .costmaps import costmap_ba
        return costmap_ba(self, reconstruction, feature_set, problem_setup)


class PatchWarpBundleAdjuster(BundleAdjuster):
    """Patch-warping BA (reference: patch_warp_bundle_optimizer.h:21-61);
    ``patch_warp.py`` builds the residual and wires the solve. The source
    poses are a second optimized block (``optimize_source_poses``) when
    ``refine_extrinsics`` is on."""

    default_conf = deepcopy(BundleAdjuster.default_conf)
    default_conf["strategy"] = "patch_warp"
    default_conf["interpolation"] = {
        "nodes": [[float(dx), float(dy)] for dy in (-1.5, -0.5, 0.5, 1.5)
                  for dx in (-1.5, -0.5, 0.5, 1.5)],
        "mode": "BICUBIC", "l2_normalize": False, "ncc_normalize": True,
    }
    default_conf["optimizer"]["regularize_source"] = {"n_nodes": 0}
    default_conf["optimizer"]["optimize_source_poses"] = True

    def refine(self, reconstruction, feature_set, problem_setup=None
               ) -> Dict:
        return patch_warp_ba(self, reconstruction, feature_set,
                             problem_setup)
