"""Bundle adjustment orchestration (reference: pixsfm/bundle_adjustment/main.py).

Port of ``pixsfm_tpu/bundle_adjustment/main.py`` for the ``geometric`` and
``feature_reference`` strategies. Both funnel into
:func:`pixsfm_tpu_torch.ops.schur.ba_solve` with batched residual closures
and closed-form Jacobians (``project_with_jac`` + the analytic
interpolation derivatives). The featuremetric window reads go through
kernel K1 (``ops/interpolate_cuda.py``), one query per observation.

``_run_ba_cached`` pads and lays out the problem exactly as the JAX package
does (power-of-two buckets, the dense/CG switch by problem size, the
point-major grid layout past the one-hot budget), so both packages pick the
same regime for the same scene. Not ported yet (each raises
``NotImplementedError``): the ``costmaps`` and ``patch_warp`` strategies,
mixed camera models, ``parallel`` sharding, segmented dispatch
(``segment_iterations > 0``) and the dense Schur step.
"""

from __future__ import annotations

import dataclasses
import time
from copy import deepcopy
from typing import Dict

import numpy as np
import torch

from .. import logger, resolve_device
from ..base import interpolation_default_conf, solver_default_conf
from ..base.cameras import img_from_cam
from ..base.geometry import apply_pose
from ..base.interpolation import InterpolationConfig, check_window_config
from ..base.losses import make_loss
from ..base.projection import project_with_jac
from ..config import merge
from ..features.featuremaps import FeatureView
from ..ops import schur
from ..ops.interpolate_cuda import interpolate_rows
from ..util.misc import bucket
from ..ops.schur import BAObservations, BAOptions, BAState, ba_solve
from .problem import PackedBA, pack_ba_problem

__all__ = ["BundleAdjuster", "GeometricBundleAdjuster",
           "FeatureReferenceBundleAdjuster"]


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md "
                               f"section 1, '{item}'")


# ---------------------------------------------------------------------------
# batched residuals: fn(q [n,4], t [n,3], cam [n,k], X [n,3], obs_slice, ctx)
# ---------------------------------------------------------------------------

def _safe_project(model, cam, qvec, tvec, X):
    x_cam = apply_pose(qvec, tvec, X)
    z = x_cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    return img_from_cam(model, cam, x_cam[..., :2] / z)


def _build_geometric(model):
    def residual_fn(qvec, tvec, cam, X, obs_slice, ctx):
        return _safe_project(model, cam, qvec, tvec, X) - obs_slice[0]
    return residual_fn


def _build_geometric_jac(model):
    def residual_jac_fn(qvec, tvec, cam, X, obs_slice, ctx):
        pix, Jp, Jc, Jx = project_with_jac(model, cam, qvec, tvec, X)
        return pix - obs_slice[0], torch.cat([Jp, Jc, Jx], dim=-1)
    return residual_jac_fn


class _PatchRows:
    """The packed patches of a feature-reference solve as K1 reads them:
    the flat ``[B*H, W, C]`` row view plus per-patch placement."""

    def __init__(self, pf, dev):
        B, self.H, self.W, self.C = pf.patches.shape
        self.rows = pf.patches.reshape(B * self.H, self.W, self.C)
        self.corners = torch.as_tensor(pf.corners, dtype=torch.float32,
                                       device=dev)
        self.scales = torch.as_tensor(pf.scales, dtype=torch.float32,
                                      device=dev)
        self.ups = torch.as_tensor(pf.upsampling, dtype=torch.float32,
                                   device=dev)

    def read(self, row, pix, l2: bool):
        """Patch coords of ``pix`` and the K1 read there:
        ``(pc [n, 2], su [n, 2], f, dfdr, dfdc)``."""
        sc, up = self.scales[row], self.ups[row][:, None]
        pc = (pix * sc - 0.5 - self.corners[row]) * up
        f, dfdr, dfdc = interpolate_rows(self.rows, self.H, self.W, self.C,
                                         row * self.H, pc[:, 1], pc[:, 0],
                                         l2)
        return pc, sc * up, f, dfdr, dfdc


def _bounds_violation(pc, H: int, W: int):
    """Hinge distance (patch pixels) outside [0, H-1] x [0, W-1] (the
    ``check_bounds`` residual channel of ``base/interpolation.py:556``)."""
    r, c = pc[:, 1], pc[:, 0]
    return (torch.clamp(r - (H - 1.0), min=0.0) + torch.clamp(-r, min=0.0)
            + torch.clamp(c - (W - 1.0), min=0.0) + torch.clamp(-c, min=0.0))


def _build_feature_reference(model, interp: InterpolationConfig):
    def residual_fn(qvec, tvec, cam, X, obs_slice, ctx):
        row, target = obs_slice
        xy = _safe_project(model, cam, qvec, tvec, X)
        pc, _, f, _, _ = ctx.read(row, xy, interp.l2_normalize)
        r = f - target
        if interp.check_bounds:
            r = torch.cat([r, _bounds_violation(pc, ctx.H, ctx.W)[:, None]],
                          dim=1)
        return r
    return residual_fn


def _build_feature_reference_jac(model, interp: InterpolationConfig):
    def residual_jac_fn(qvec, tvec, cam, X, obs_slice, ctx):
        row, target = obs_slice
        pix, Jp, Jc, Jx = project_with_jac(model, cam, qvec, tvec, X)
        Jpix = torch.cat([Jp, Jc, Jx], dim=-1)              # [n, 2, 6+k+3]
        pc, su, f, dfdr, dfdc = ctx.read(row, pix, interp.l2_normalize)
        # chain rule of _interp_residual_jac (main.py:297-321)
        Jc_ = (su[:, 0, None] * Jpix[:, 0])[:, None, :]
        Jr_ = (su[:, 1, None] * Jpix[:, 1])[:, None, :]
        J = dfdc[:, :, None] * Jc_ + dfdr[:, :, None] * Jr_
        r = f - target
        if interp.check_bounds:
            H, W = ctx.H, ctx.W
            r_, c_ = pc[:, 1], pc[:, 0]
            dv_dr = (r_ > H - 1.0).float() - (r_ < 0.0).float()
            dv_dc = (c_ > W - 1.0).float() - (c_ < 0.0).float()
            Jv = dv_dc[:, None, None] * Jc_ + dv_dr[:, None, None] * Jr_
            r = torch.cat([r, _bounds_violation(pc, H, W)[:, None]], dim=1)
            J = torch.cat([J, Jv], dim=1)
        return r, J
    return residual_jac_fn


_RESIDUAL_BUILDERS = {
    "geometric": (_build_geometric, _build_geometric_jac),
    "feature_reference": (_build_feature_reference,
                          _build_feature_reference_jac),
}


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
        if (self.conf.get("parallel") or {}).get("enabled"):
            raise _not_ported("multi-device BA (parallel.enabled)",
                              "Sharding")
        self.device = resolve_device(device)

    @classmethod
    def create(cls, conf=None, device=None):
        strategy = cls.default_conf["strategy"]
        if conf is not None and "strategy" in conf:
            strategy = conf["strategy"]
        if strategy in ("costmaps", "patch_warp"):
            raise _not_ported(f"the {strategy} BA strategy",
                              "The other BA strategies")
        strategy_to_solver = {
            "feature_reference": FeatureReferenceBundleAdjuster,
            "geometric": GeometricBundleAdjuster,
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

    def _pack(self, reconstruction, problem_setup) -> PackedBA:
        packed = pack_ba_problem(reconstruction, problem_setup,
                                 **self._optimizer_flags())
        if len(packed.cam_models) > 1:
            raise _not_ported("BA over mixed camera models",
                              "Mixed camera models and segmented dispatch")
        return packed

    def _run_ba_cached(self, reconstruction, packed: PackedBA, residual_key,
                       obs_data, ctx, loss, opts: BAOptions,
                       obs_valid=None) -> Dict:
        """Lay the problem out as the JAX package does and run
        :func:`ba_solve` (``pixsfm_tpu/bundle_adjustment/main.py:540``)."""
        t0 = time.time()
        dev = self.device
        O = len(packed.obs_img)
        Np = len(packed.point_ids)
        if O == 0 or Np == 0:
            logger.info("BA: empty problem (no observations); skipping.")
            return dict(initial_cost=0.0, final_cost=0.0, iterations=0,
                        time=time.time() - t0)
        if int(opts.segment_iterations) > 0:
            raise _not_ported("segmented BA dispatch (segment_iterations)",
                              "Mixed camera models and segmented dispatch")
        O_pad = bucket(O + 1)
        Np_pad = bucket(Np, minimum=4)

        # solver-by-size switch (reference bundle_optimizer.h:180-191)
        M = 6 * len(packed.image_ids) + packed.cams.size
        track_lens = np.bincount(packed.obs_pt, minlength=max(Np, 1))
        n_pairs = int(np.sum(track_lens.astype(np.int64) ** 2))
        if opts.linear_solver == "dense" and (M > 1500 or n_pairs > 20_000):
            opts = dataclasses.replace(opts, linear_solver="cg")
        if opts.linear_solver != "cg":
            raise _not_ported("the dense Schur step (small camera systems: "
                              f"M={M} <= 1500 and {n_pairs} track pairs "
                              "<= 20000)", "The dense Schur step")

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
        if large_pts and O_grid <= 2 * O_pad \
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

        def put(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        obs = BAObservations(
            img_idx=put(prep(packed.obs_img), torch.long),
            cam_idx=put(prep(packed.obs_cam), torch.long),
            pt_idx=put(pt_idx, torch.long),
            obs_data=tuple(put(prep(a)) for a in obs_data),
            valid=put(valid))
        xyz = np.concatenate([packed.xyz, np.zeros((Np_pad - Np, 3))]) \
            .astype(np.float32)
        xyz[Np:] = [0.0, 0.0, 10.0]   # padded points safely in front
        state0 = BAState(put(packed.qvec, torch.float32),
                         put(packed.tvec, torch.float32),
                         put(packed.cams, torch.float32),
                         put(xyz))
        point_free = np.zeros(Np_pad, bool)
        point_free[:Np] = packed.point_free
        build, build_jac = _RESIDUAL_BUILDERS[residual_key[0]]
        state, summary = ba_solve(
            build(*residual_key[1:]), state0, obs, loss,
            put(packed.pose_free), put(packed.tvec_free),
            put(packed.cam_free), put(point_free), opts=opts, ctx=ctx,
            residual_jac_fn=build_jac(*residual_key[1:]))
        out = {k: v for k, v in summary.items() if k not in ("lam", "done")}
        packed.unpack_into(reconstruction, state.qvec.cpu().numpy(),
                           state.tvec.cpu().numpy(),
                           state.cams.cpu().numpy(),
                           state.xyz.cpu().numpy()[:Np])
        out["obs_grid_T"] = int(opts.obs_grid_T)
        out["time"] = time.time() - t0
        logger.info("BA Time: %.3fs, cost change: %.6g --> %.6g (%d iters, "
                    "%d CG steps)", out["time"], out["initial_cost"],
                    out["final_cost"], int(out["iterations"]),
                    int(out["cg_iterations"]))
        self._maybe_print_summary(out, packed)
        return out

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
        for _ in range(int(self.conf.get("repeats", 1))):
            for level in levels:
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
        packed = self._pack(reconstruction, problem_setup)
        return self._run_ba_cached(
            reconstruction, packed, ("geometric", packed.cam_model),
            (np.asarray(packed.obs_xy, np.float32),), None,
            make_loss(self.conf.optimizer.get("loss")), self._ba_options())

    def refine_multilevel(self, reconstruction, feature_manager=None,
                          problem_setup=None) -> Dict:
        out = self.refine(reconstruction, None, problem_setup=problem_setup)
        return {k: [v] for k, v in out.items()}


class FeatureReferenceBundleAdjuster(BundleAdjuster):
    """Featuremetric BA toward per-track robust references (reference:
    feature_reference_bundle_optimizer.h:21-149, ba/main.py:105-154)."""

    default_conf = deepcopy(BundleAdjuster.default_conf)
    default_conf["strategy"] = "feature_reference"

    def refine(self, reconstruction, feature_set, problem_setup=None,
               references=None) -> Dict:
        from .references import extract_references

        packed = self._pack(reconstruction, problem_setup)
        interp = InterpolationConfig.from_conf(self.conf.get("interpolation"))
        check_window_config(interp)
        view = FeatureView.from_reconstruction(feature_set, reconstruction,
                                               packed.point_ids)
        pf = view.packed
        t_ref = time.time()
        if references is None:
            references = extract_references(
                reconstruction, feature_set, view, self.conf.references,
                interp, point3D_ids=packed.point_ids)
        t_ref = time.time() - t_ref

        # per-observation patch row + target descriptor; observations
        # without an extracted patch or a reference get weight 0
        O = len(packed.obs_img)
        names = {iid: im.name for iid, im in reconstruction.images.items()}
        rows = np.asarray([pf.row_or(names[int(iid)], int(p2d)) for iid, p2d
                           in zip(packed.obs_image_id, packed.obs_p2D_idx)],
                          np.int64).reshape(O)
        C = pf.channels
        desc = np.zeros((len(packed.point_ids), C), np.float32)
        has_ref = np.zeros(len(packed.point_ids), bool)
        for s, pid in enumerate(packed.point_ids):
            ref = references.get(int(pid))
            if ref is not None:
                desc[s] = ref.descriptor
                has_ref[s] = True
        obs_valid = (rows >= 0) & has_ref[packed.obs_pt]
        if not obs_valid.all():
            logger.warning("feature_reference BA: %d/%d observations have no "
                           "patch/reference; excluded.",
                           int((~obs_valid).sum()), O)
        rows = np.where(obs_valid, rows, 0)
        targets = np.where(obs_valid[:, None], desc[packed.obs_pt], 0.0)
        out = self._run_ba_cached(
            reconstruction, packed,
            ("feature_reference", packed.cam_model, interp),
            (rows, targets.astype(np.float32)), _PatchRows(pf, self.device),
            make_loss(self.conf.optimizer.get("loss")), self._ba_options(),
            obs_valid=obs_valid)
        out["references_time"] = t_ref
        return out
