"""Query localization: QKA -> PnP -> QBA (reference:
pixsfm/localization/main.py).

Port of ``pixsfm_tpu/localization/main.py``:

- ``QueryKeypointAdjuster`` (QKA): refine the query's 2D keypoints against
  reference descriptors of their matched 3D points before PnP — batched
  fixed-target LM problems (``keypoint_adjustment.solver
  .solve_target_problems``, whose system reads K1 on CUDA).
- ``QueryBundleAdjuster`` (QBA): refine the query pose (points constant)
  after PnP — a fixed number of damped Newton steps over the 6-DoF tangent
  (plus the intrinsics the config frees). Its Hessian is the exact one of
  the cost, as ``jax.hessian`` gives it in the JAX package. For one
  BICUBIC node (the default) it is built from analytic second derivatives
  of the window, the L2 normalization, the loss and the rotation, and
  ``torch.func`` derivatives of the camera model (:func:`_qba_system_fn`);
  for node windows, NCC and the other modes by ``torch.func`` forward mode
  over the gradient (:func:`_autodiff_system`), whose read carries its own
  first derivatives and differentiates them once more, as ``jax.hessian``
  does through the JAX package's custom JVP. The second derivatives are
  plain PyTorch reads on every device (K1 returns first derivatives only).
- The "full" reference mode (``target_reference: full``): the references
  are ``Reference`` objects with ``node_offsets3D``, and QBA is the
  patch-warp pose refinement (:meth:`QueryBundleAdjuster.
  _refine_patch_warp`): the query is read at the reprojections of ``X +
  node_offsets3D`` (NCC across the nodes when configured) against each
  reference's node descriptor. ``refine_batch`` runs such queries one by
  one, as the JAX package does.
- ``QueryLocalizer``: reference management (nearest / robust_mean /
  all_observations / full), unique-inlier selection and the ``localize``
  flow (QKA -> RANSAC PnP -> QBA), single-query and batched.

The JAX package pads correspondences, patches and queries to power-of-two
buckets (its compile keys); eager torch pads only where queries of one
batch differ in size, with weight-0 copies of a real row.

``parallel: {enabled, n_devices}`` gives ``localize_batch`` a device mesh
(``parallel/sharded.py``): the QKA problems, each PnP group's queries and
the QBA queries (padded to a multiple of the mesh size, as in the JAX
package) split into one contiguous shard per device, each solved there.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import logger, resolve_device
from ..base import interpolation_default_conf, solver_default_conf
from ..base.cameras import (CAMERA_MODELS, Camera, img_from_cam,
                            img_from_cam_with_jac)
from ..base.geometry import exp_quat, quat_mul, quat_normalize, quat_rotate
from ..base.interpolation import (InterpolationConfig,
                                  bicubic_window_eval_rows_d2,
                                  bounds_violation, check_window_config,
                                  interpolate_rows_with_grad,
                                  ncc_normalize)
from ..base.losses import RobustLoss, make_loss
from ..base.projection import world_to_pixel
from ..config import merge
from ..features.featuremaps import FeatureMap, FeatureView, kDensePatchId
from ..keypoint_adjustment.solver import (_run_target_chunk,
                                          evaluate_descriptors,
                                          solve_target_problems)
from ..ops.lm import LMOptions
from ..parallel.sharded import (device_scope, parallel_mesh, replicate,
                                shard_bounds)
from ..sfm.model import Reconstruction
from .pnp import (STAGE1_MAX_SAMPLES, _gen_samples, _pnp_core,
                  _stage_accept, absolute_pose_estimation_batch,
                  finalize_device_pose, project_np)

__all__ = [
    "QueryKeypointAdjuster", "QueryBundleAdjuster", "QueryLocalizer",
    "find_unique_inliers", "find_unique_min_reproj_inliers",
    "compute_reprojection_errors", "find_nearest_references",
]


# ---------------------------------------------------------------------------
# inlier utilities (reference: localization/main.py:20-86), host numpy
# ---------------------------------------------------------------------------

def compute_reprojection_errors(points2D, points3D, qvec, tvec,
                                camera: Camera) -> np.ndarray:
    """Per-correspondence reprojection error (px); +inf behind the camera.
    float64 numpy for the standard models; the others project in float32
    torch on the CPU, as the JAX package falls back to its (float32)
    projection."""
    X = np.asarray(points3D, np.float64).reshape(-1, 3)
    q = np.asarray(qvec, np.float64)
    try:
        proj, depths = project_np(camera, q / np.linalg.norm(q), tvec, X)
    except ValueError:  # camera model without a numpy fast path
        def t32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32)
        qt, tt = t32(q / np.linalg.norm(q)), t32(tvec)
        proj = world_to_pixel(camera.model, t32(camera.params), qt, tt,
                              t32(X)).numpy()
        from ..base.geometry import quat_to_rotmat
        depths = (quat_to_rotmat(qt).numpy() @ X.T).T[:, 2] \
            + np.asarray(tvec)[2]
    err = np.linalg.norm(proj - np.asarray(points2D).reshape(-1, 2), axis=1)
    return np.where(np.asarray(depths) <= 0, np.inf, err)


def find_feature_inliers(points2D, query_fmap: FeatureMap, references,
                         interp: InterpolationConfig, thresh: float = -1,
                         point2D_idxs=None, device=None) -> List[bool]:
    """Drop correspondences whose query descriptor is farther than ``thresh``
    from the reference (reference: localization/main.py:20-35)."""
    n = len(points2D)
    if thresh < 0:
        return [True] * n
    patches, corners, scales, ups, row_of = _pack_query_fmap(query_fmap,
                                                             device)
    rows = _rows_for(row_of, point2D_idxs if point2D_idxs is not None
                     else range(n))
    qd = evaluate_descriptors(patches, rows, np.asarray(points2D, np.float64),
                              corners[rows], scales[rows], ups[rows], interp)
    inliers = []
    for i in range(n):
        ref = np.asarray(references[i])
        if ref.ndim == 1:
            inliers.append(bool(np.linalg.norm(qd[i] - ref) <= thresh))
        else:
            d = np.linalg.norm(ref.reshape(-1, qd.shape[-1]) - qd[i], axis=1)
            inliers.append(bool(d.min() <= thresh))
    return inliers


def find_unique_inliers(idxs, pre_inliers=None) -> List[bool]:
    unique = [False] * len(idxs)
    seen = set()
    for i, idx in enumerate(idxs):
        if pre_inliers is not None and not pre_inliers[i]:
            continue
        if idx not in seen:
            seen.add(idx)
            unique[i] = True
    return unique


def _unique_min_by_group(errors, idxs, pre_inliers=None) -> List[bool]:
    if pre_inliers is None:
        pre_inliers = [True] * len(idxs)
    by_group = defaultdict(list)
    for i, (gid, err) in enumerate(zip(idxs, errors)):
        if pre_inliers[i]:
            by_group[gid].append((i, err))
    keep = [min(v, key=lambda t: t[1])[0] for v in by_group.values()]
    out = np.zeros(len(idxs), bool)
    out[keep] = True
    return list(out)


def find_unique_min_reproj_inliers(points3D_id, qvec, tvec, camera,
                                   points2D, points3D, pre_inliers=None,
                                   point2D_idxs=None) -> List[bool]:
    errors = compute_reprojection_errors(points2D, points3D, qvec, tvec,
                                         camera)
    inliers = pre_inliers
    for idxs in (points3D_id, point2D_idxs):
        if idxs is None:
            continue
        inliers = _unique_min_by_group(errors, idxs, pre_inliers=inliers)
    return inliers


# ---------------------------------------------------------------------------
# query featuremap packing
# ---------------------------------------------------------------------------

def _pack_query_fmap(fmap: FeatureMap, device=None):
    """FeatureMap -> (patches [N, ps, ps, C] on ``device``, corners, scales,
    ups, {p2D_idx -> row}), rows in ascending keypoint id.

    The result is cached on the instance per device: one query's map is
    packed for QKA, the nearest-reference lookup and QBA. Localization maps
    are not changed once extracted; code that changes ``fmap.patches``
    afterwards must delete ``_qloc_pack_cache``."""
    dev = resolve_device(device) if device is not None \
        else fmap.patches.device
    cache = fmap.__dict__.setdefault("_qloc_pack_cache", {})
    if str(dev) in cache:
        return cache[str(dev)]
    ids = np.asarray(fmap.keypoint_ids(), np.int64)
    order = np.argsort(ids, kind="stable")
    patches = fmap.patches.to(dev)
    if not (order == np.arange(len(ids))).all():
        patches = patches.index_select(0, torch.as_tensor(order, device=dev))
    corners = fmap.corners[order].astype(np.float32)
    scales = np.tile(fmap.scale.astype(np.float32), (len(ids), 1))
    ups = np.full(len(ids), fmap.upsampling_factor, np.float32)
    row_of = {int(ids[i]): r for r, i in enumerate(order)}
    cache[str(dev)] = out = (patches, corners, scales, ups, row_of)
    return out


def _rows_for(row_of, point2D_idxs) -> np.ndarray:
    """Packed rows of keypoints; a dense map's one row serves them all."""
    if kDensePatchId in row_of:
        return np.full(len(point2D_idxs), row_of[kDensePatchId], np.int64)
    return np.asarray([row_of[int(i)] for i in point2D_idxs], np.int64)


def find_nearest_references(query_fmap: FeatureMap, references: Dict,
                            points2D, points3D_id,
                            interp: InterpolationConfig,
                            patch_idxs=None, device=None) -> List[np.ndarray]:
    """Per correspondence: the stored track-observation descriptor closest
    to the query descriptor at the current keypoint (reference:
    localization/src/nearest_references.h:20-52). The query descriptors
    come from K1 in one launch per 1024 correspondences."""
    patches, corners, scales, ups, row_of = _pack_query_fmap(query_fmap,
                                                             device)
    rows = _rows_for(row_of, patch_idxs if patch_idxs is not None
                     else range(len(points2D)))
    qd = evaluate_descriptors(patches, rows, np.asarray(points2D, np.float64),
                              corners[rows], scales[rows], ups[rows], interp)
    out = []
    for i, pid in enumerate(points3D_id):
        ref = references[pid]
        if ref.track_descriptors is None:
            out.append(ref.descriptor)
            continue
        d2 = np.sum((ref.track_descriptors - qd[i]) ** 2, axis=1)
        out.append(ref.track_descriptors[int(np.argmin(d2))])
    return out


def _levels(conf, n_levels: int) -> List[int]:
    levels = conf.get("level_indices")
    if levels in (None, "all"):
        levels = list(reversed(range(n_levels)))
    return list(levels)


# ---------------------------------------------------------------------------
# QKA
# ---------------------------------------------------------------------------

class QueryKeypointAdjuster:
    """QKA (reference: localization/main.py:89-192), on ``device`` (``cuda``
    unless ``"cpu"`` is passed)."""

    default_conf = {
        "apply": True,
        "feature_inlier_thresh": -1,
        "interpolation": interpolation_default_conf,
        "level_indices": None,
        "stack_correspondences": False,
        "optimizer": {
            "loss": {"name": "trivial", "params": []},
            "solver": {**solver_default_conf, "parameter_tolerance": 1.0e-5},
            "print_summary": False,
            "bound": 4.0,
        },
    }

    def __init__(self, conf=None, device=None):
        self.conf = merge(self.default_conf, conf or {})
        self.device = resolve_device(device)

    def _options(self):
        interp = InterpolationConfig.from_conf(self.conf.get("interpolation"))
        opt = self.conf.optimizer
        return (interp, make_loss(opt.get("loss")),
                LMOptions.from_solver_conf(opt.get("solver")),
                float(opt.get("bound", 4.0)))

    def _build_problems(self, keypoints: np.ndarray, query_fmap: FeatureMap,
                        references: List, point2D_idxs: Sequence[int],
                        interp: InterpolationConfig, bound: float):
        """Pack one query's correspondences as fixed-target LM problems.

        Returns (kp0, rows, corner, scale, up, targets, tw, lo, hi, patches,
        writeback), where ``writeback(kp_new, keypoints)`` scatters refined
        keypoints back (it undoes the stacked-correspondence dedup) and
        ``rows`` index ``patches``."""
        thresh = float(self.conf.get("feature_inlier_thresh", -1) or -1)
        feat_inliers = find_feature_inliers(
            keypoints, query_fmap, references, interp, thresh=thresh,
            point2D_idxs=point2D_idxs, device=self.device)

        patches, corners, scales, ups, row_of = _pack_query_fmap(
            query_fmap, self.device)
        # keypoints are (x, y): the patch box extent is (W, H)
        ext = np.array([patches.shape[2], patches.shape[1]], np.float64)

        if self.conf.get("stack_correspondences"):
            kp_map: Dict[int, List[int]] = defaultdict(list)
            for i, p2D in enumerate(point2D_idxs):
                kp_map[int(p2D)].append(i)
            uniq = sorted(kp_map.keys())
            T = max(len(v) for v in kp_map.values())
            n = len(uniq)
            kp0 = np.stack([
                keypoints[kp_map[u][0]] for u in uniq]).astype(np.float64)
            targets = np.zeros((n, T, len(references[0])), np.float32)
            tw = np.zeros((n, T), np.float32)
            rows = _rows_for(row_of, uniq)
            for j, u in enumerate(uniq):
                for t, i in enumerate(kp_map[u]):
                    targets[j, t] = references[i]
                    tw[j, t] = 1.0 if feat_inliers[i] else 0.0
        else:
            n = len(point2D_idxs)
            uniq = None
            kp0 = np.asarray(keypoints, np.float64).copy()
            rows = _rows_for(row_of, point2D_idxs)
            refs = [np.asarray(r) for r in references]
            C = refs[0].reshape(-1).shape[0] if refs[0].ndim == 1 \
                else refs[0].shape[-1]
            T = max(1, max(r.reshape(-1, C).shape[0] for r in refs))
            targets = np.zeros((n, T, C), np.float32)
            tw = np.zeros((n, T), np.float32)
            for i, r in enumerate(refs):
                r2 = r.reshape(-1, C)
                targets[i, :len(r2)] = r2
                tw[i, :len(r2)] = 1.0 if feat_inliers[i] else 0.0

        corner = corners[rows]
        scale = scales[rows]
        up = ups[rows]
        lo = (corner + 0.5) / scale
        hi = lo + ext / scale
        if bound > 0:
            lo = np.maximum(lo, kp0 - bound / scale)
            hi = np.minimum(hi, kp0 + bound / scale)

        if uniq is not None:
            def writeback(kp_new, kps):
                for j, u in enumerate(uniq):
                    for i in kp_map[u]:
                        kps[i] = kp_new[j]
        else:
            def writeback(kp_new, kps):
                kps[:] = kp_new

        return (kp0, rows, corner, scale, up, targets, tw, lo, hi, patches,
                writeback)

    def refine(self, keypoints: np.ndarray, query_fmap: FeatureMap,
               references: List, point2D_idxs: Sequence[int]) -> Dict:
        """Refine ``keypoints`` (modified in place) of the correspondences."""
        interp, loss, lm_opts, bound = self._options()
        (kp0, rows, corner, scale, up, targets, tw, lo, hi, patches,
         writeback) = self._build_problems(keypoints, query_fmap, references,
                                           point2D_idxs, interp, bound)
        kp_new, summary = solve_target_problems(
            kp0, rows, corner, scale, up, targets, tw, lo, hi, patches,
            interp, loss, lm_opts)
        writeback(kp_new, keypoints)
        return summary

    def refine_batch(self, items: List[Tuple[np.ndarray, FeatureMap, List,
                                             Sequence[int]]],
                     mesh=None) -> Dict:
        """Refine several queries' keypoints in one batched solve.

        ``items``: (keypoints, query_fmap, references, point2D_idxs) per
        query; the keypoint arrays are modified in place. The fixed-target
        problems concatenate along the problem axis, the patch stacks with
        row offsets. ``mesh``: the problem axis splits over its devices
        (``solve_target_problems``)."""
        interp, loss, lm_opts, bound = self._options()
        built = [self._build_problems(kps, fmap, refs, p2D, interp, bound)
                 for (kps, fmap, refs, p2D) in items]
        shapes = {tuple(b[9].shape[1:]) for b in built}
        if len(shapes) > 1:
            raise ValueError(
                f"refine_batch needs uniform patch shapes, got {shapes}")
        T = max(b[5].shape[1] for b in built)

        def padT(a):
            if a.shape[1] == T:
                return a
            pad = [(0, 0)] * a.ndim
            pad[1] = (0, T - a.shape[1])
            return np.pad(a, pad)

        rows_all, row_off = [], 0
        for b in built:
            rows_all.append(np.asarray(b[1]) + row_off)
            row_off += b[9].shape[0]
        patches_cat = torch.cat([b[9] for b in built]) if len(built) > 1 \
            else built[0][9]
        kp_new, summary = solve_target_problems(
            np.concatenate([b[0] for b in built]), np.concatenate(rows_all),
            np.concatenate([b[2] for b in built]),
            np.concatenate([b[3] for b in built]),
            np.concatenate([b[4] for b in built]),
            np.concatenate([padT(b[5]) for b in built]),
            np.concatenate([padT(b[6]) for b in built]),
            np.concatenate([b[7] for b in built]),
            np.concatenate([b[8] for b in built]),
            patches_cat, interp, loss, lm_opts, mesh=mesh)
        start = 0
        for b, (kps, *_rest) in zip(built, items):
            n = b[0].shape[0]
            b[10](kp_new[start:start + n], kps)
            start += n
        return summary

    def refine_multilevel(self, keypoints, query_fmaps, query_references,
                          point2D_idxs) -> Dict:
        out: Dict = {}
        for level in _levels(self.conf, len(query_fmaps)):
            s = self.refine(keypoints, query_fmaps[level],
                            query_references[level], point2D_idxs)
            for k, v in s.items():
                out.setdefault(k, []).append(v)
        return out


# ---------------------------------------------------------------------------
# QBA
# ---------------------------------------------------------------------------

def _qba_system_fn(model: str, interp: InterpolationConfig,
                   loss: RobustLoss, cam_mask, patches, rows, corner, scale,
                   up, X, targets, tw):
    """The QBA cost of ``B`` queries with its gradient and exact Hessian in
    the tangent ``D = (omega, dt, dc)`` at D = 0 (``residual_cost``,
    ``jax.grad`` and ``jax.hessian`` of the JAX package's ``_qba_inner``):
    ``system(q [B, 4], t [B, 3], c [B, k]) -> (cost [B], g [B, 6 + k], H
    [B, 6 + k, 6 + k])``. ``patches [Np, H, W, C]`` are shared, per query
    ``rows [B, n]`` index them, ``corner / scale [B, n, 2]``, ``up [B, n]``,
    ``X [B, n, 3]``, ``targets [B, n, T, C]``, ``tw [B, n, T]`` (0 =
    padding); ``cam_mask [k]`` marks the intrinsics that move.

    Per correspondence the cost is a function of its patch coordinates u,
    and u of D: ``H = sum J_u^T (d2 cost/du2) J_u + sum (d cost/du) d2u/dD2``.
    The first factor is analytic: the window's first and second
    derivatives (``bicubic_window_eval_rows_d2``), the L2 normalization's,
    the loss's ``rho'`` and ``rho''``. So is the rotation's second
    derivative (``exp([omega]x) Y`` at omega = 0) and the perspective
    division's; the camera model's second derivatives in the normalized
    point and the intrinsics are forward mode (``torch.func.jacfwd``) over
    its analytic first derivatives (``img_from_cam_with_jac``)."""
    Np, H, W, C = patches.shape
    rows_view = patches.reshape(Np * H, W, C)
    B, n = rows.shape
    M = B * n
    k = cam_mask.shape[0]
    NP = 6 + k
    dev, f32 = X.device, X.dtype
    row_base = (rows * H).reshape(-1)
    su = (scale * up[..., None]).reshape(M, 2)     # d u / d xy, per axis
    T = targets.shape[2]
    tgt = targets.reshape(M, T, C)
    twf = tw.reshape(M, T)
    # d w / d D for w = (normalized point, intrinsics): the intrinsics rows
    # do not depend on the state
    Jw0 = torch.zeros((M, 2 + k, NP), dtype=f32, device=dev)
    Jw0[:, 2:, 6:] = torch.diag(cam_mask)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    Jx_cam = torch.zeros((M, 3, k), dtype=f32, device=dev)

    def first(w):          # one point: (uv [2], c [k]) -> d xy / d w [2, 2+k]
        # as a batch of one: forward-mode AD promotes the tangent of a 0-d
        # tensor plus a Python float to float64
        _, J_uv, J_cam = img_from_cam_with_jac(model, w[None, 2:],
                                               w[None, :2])
        J = torch.cat([J_uv[0], J_cam[0]], -1)
        return J, J

    d_first = torch.func.vmap(torch.func.jacfwd(first, has_aux=True))

    def system(q, t, c):
        Y = quat_rotate(q[:, None], X).reshape(M, 3)     # R(q) X
        Xc = Y + t.repeat_interleave(n, 0)
        cm = c.repeat_interleave(n, 0)
        iz = 1.0 / Xc[:, 2]
        uv = Xc[:, :2] * iz[:, None]
        xy = img_from_cam(model, cm, uv)
        # the camera model: analytic first derivatives in w, forward mode
        # over them for the second
        Hw, Jw = d_first(torch.cat([uv, cm], 1))  # [M,2,2+k,2+k], [M,2,2+k]
        # the camera point Xc = exp([omega]x) Y + t + dt:
        # d Xc / d omega = -[Y]x, d2 Xc_m / d omega_a d omega_b =
        # (d_mb Y_a + d_ma Y_b) / 2 - Y_m d_ab, the rest linear
        y0, y1, y2 = Y.unbind(1)
        zero = torch.zeros_like(y0)
        Jx = torch.cat([torch.stack([
            torch.stack([zero, y2, -y1], 1), torch.stack([-y2, zero, y0], 1),
            torch.stack([y1, -y0, zero], 1)], 1),
            eye3.expand(M, 3, 3), Jx_cam], 2)               # [M, 3, NP]
        Trot = 0.5 * (eye3[None, :, None, :] * Y[:, None, :, None]
                      + eye3[None, :, :, None] * Y[:, None, None, :]) \
            - Y[:, :, None, None] * eye3[None, None]        # [M, 3, 3, 3]
        # the perspective division uv = (X / Z, Y / Z)
        x_, y_ = uv.unbind(1)
        iz2 = iz * iz
        Duv = torch.stack([torch.stack([iz, zero, -x_ * iz], 1),
                           torch.stack([zero, iz, -y_ * iz], 1)], 1)
        Huv = torch.stack([
            torch.stack([torch.stack([zero, zero, -iz2], 1),
                         torch.stack([zero, zero, zero], 1),
                         torch.stack([-iz2, zero, 2.0 * x_ * iz2], 1)], 1),
            torch.stack([torch.stack([zero, zero, zero], 1),
                         torch.stack([zero, zero, -iz2], 1),
                         torch.stack([zero, -iz2, 2.0 * y_ * iz2], 1)], 1)],
            1)                                              # [M, 2, 3, 3]
        Jw_D = Jw0.clone()
        Jw_D[:, :2] = Duv @ Jx                              # d w / d D
        H_uv = torch.einsum("mva,mjvw,mwb->mjab", Jx, Huv, Jx)
        H_uv[:, :, :3, :3] += torch.einsum("mjq,mqab->mjab", Duv, Trot)
        Jxy = Jw @ Jw_D                                     # [M, 2, NP]
        Hxy = torch.einsum("mva,mjvw,mwb->mjab", Jw_D, Hw, Jw_D) \
            + torch.einsum("mjv,mvab->mjab", Jw[:, :, :2], H_uv)
        Ju = su[..., None] * Jxy                            # u = (c, r)
        Hu = su[..., None, None] * Hxy

        pc = (xy.reshape(B, n, 2) * scale - 0.5 - corner) * up[..., None]
        pr, pcc = pc[..., 1].reshape(-1), pc[..., 0].reshape(-1)
        f, f_r, f_c, f_rr, f_rc, f_cc = bicubic_window_eval_rows_d2(
            rows_view, H, W, C, row_base, pr, pcc)
        F1 = torch.stack([f_c, f_r], 1)                     # [M, 2, C]
        F2 = torch.stack([torch.stack([f_cc, f_rc], 1),
                          torch.stack([f_rc, f_rr], 1)], 1)  # [M, 2, 2, C]
        if interp.l2_normalize:
            nrm = torch.clamp(torch.linalg.vector_norm(f, dim=-1,
                                                       keepdim=True),
                              min=1e-20)                    # [M, 1]
            g = f / nrm
            gf1 = torch.einsum("mc,mac->ma", g, F1)
            G1 = (F1 - g[:, None] * gf1[..., None]) / nrm[..., None]
            gf2 = torch.einsum("mc,mabc->mab", g, F2)
            gbfa = torch.einsum("mbc,mac->mab", G1, F1)
            G2 = (F2 - G1[:, None] * gf1[:, :, None, None]
                  - g[:, None, None] * (gbfa + gf2)[..., None]
                  - G1[:, :, None] * gf1[:, None, :, None]) / nrm[..., None,
                                                               None]
        else:
            g, G1, G2 = f, F1, F2
        e = g[:, None] - tgt                                # [M, T, C]
        s = torch.sum(e * e, dim=-1)                        # [M, T]
        s1 = 2.0 * torch.einsum("mtc,mac->mta", e, G1)
        s2 = 2.0 * (torch.einsum("mac,mbc->mab", G1, G1)[:, None]
                    + torch.einsum("mtc,mabc->mtab", e, G2))
        if interp.check_bounds:
            viol = bounds_violation(pr, pcc, H, W)
            dviol = torch.stack([
                (pcc > W - 1.0).to(f32) - (pcc < 0.0).to(f32),
                (pr > H - 1.0).to(f32) - (pr < 0.0).to(f32)], 1)
            s = s + (viol * viol)[:, None]
            s1 = s1 + (2.0 * viol[:, None] * dviol)[:, None]
            s2 = s2 + (2.0 * dviol[:, :, None] * dviol[:, None])[:, None]
        r1 = twf * loss.weight(s)
        r2 = twf * loss.weight_derivative(s)
        phi1 = 0.5 * torch.einsum("mt,mta->ma", r1, s1)
        phi2 = 0.5 * (torch.einsum("mt,mta,mtb->mab", r2, s1, s1)
                      + torch.einsum("mt,mtab->mab", r1, s2))
        cost = 0.5 * torch.sum(twf * loss(s), dim=1)
        grad = torch.einsum("map,ma->mp", Ju, phi1)
        hess = torch.einsum("map,mab,mbq->mpq", Ju, phi2, Ju) \
            + torch.einsum("ma,mapq->mpq", phi1, Hu)
        return (cost.reshape(B, n).sum(1), grad.reshape(B, n, NP).sum(1),
                hess.reshape(B, n, NP, NP).sum(1))

    return system


def _autodiff_system(coords, read, psi, n_params: int):
    """The Newton system ``system(*state) -> (cost [B], g [B, NP], H [B,
    NP, NP])`` at the tangent ``d = 0`` of a cost ``psi(f, pc)`` over a
    feature read, by ``torch.func``: ``coords(d, *state) -> pc [M, 2]``
    the patch coordinates ``(c, r)`` of every read, ``read(pc) -> (f,
    dfdr, dfdc)`` in differentiable plain PyTorch, ``psi(f, pc) -> cost
    [B]``. The gradient routes through the read's own derivatives (``d
    cost / d pc = psi_f . (dfdc, dfdr) + psi_pc``, then the transpose of
    ``d pc / d d``), as the JAX package's custom JVP does; the Hessian is
    forward mode over that gradient, which differentiates ``f``, ``dfdr``
    and ``dfdc`` as plain functions, as ``jax.hessian`` differentiates the
    custom rule's body (for BICUBIC the two derivatives of ``f`` agree;
    bilinear's forward differences do not). The tangents ``e_j`` go into
    every query at once (queries are independent, so the column ``j`` of
    each query's Hessian comes out of one pass): ``jax.hessian``'s
    forward-over-reverse, ``H[p, q] = d g_p / d d_q``."""

    def grad_fn(d, state):
        pc = coords(d, *state)
        f, dfdr, dfdc = read(pc)
        g_f, g_pc = torch.func.grad(lambda f_, p_: psi(f_, p_).sum(),
                                    argnums=(0, 1))(f, pc)
        g_pc = g_pc + torch.stack([torch.sum(g_f * dfdc, -1),
                                   torch.sum(g_f * dfdr, -1)], -1)
        _, pull = torch.func.vjp(lambda d_: coords(d_, *state), d)
        return pull(g_pc)[0]

    def system(*state):
        B = state[0].shape[0]
        d0 = state[0].new_zeros((B, n_params))
        basis = torch.eye(n_params, dtype=d0.dtype, device=d0.device)[
            :, None, :].expand(n_params, B, n_params)
        g, Hcols = torch.func.vmap(
            lambda tan: torch.func.jvp(lambda d: grad_fn(d, state), (d0,),
                                       (tan,)),
            out_dims=(None, 0))(basis)
        pc = coords(d0, *state)
        cost = psi(read(pc)[0], pc)
        return cost, g, Hcols.permute(1, 2, 0)

    return system


def _read_fn(patches, rows, interp: InterpolationConfig):
    """``read(pc [M, 2]) -> (f, dfdr, dfdc)`` for :func:`_autodiff_system`
    on the query patches ``[Np, H, W, C]`` at the patch rows ``rows
    [M]``."""
    Np, H, W, C = patches.shape
    rows_view = patches.reshape(Np * H, W, C)
    row_base = rows.reshape(-1) * H

    def read(pc):
        return interpolate_rows_with_grad(rows_view, H, W, C, row_base,
                                          pc[:, 1], pc[:, 0], interp)

    return read


def _qba_autodiff_system_fn(model: str, interp: InterpolationConfig,
                            loss: RobustLoss, cam_mask, patches, rows,
                            corner, scale, up, X, targets, tw):
    """:func:`_qba_system_fn`'s system for any feature config (node
    windows, NCC, BILINEAR, NEARESTNEIGHBOR, BICUBICCHAIN): the JAX
    package's ``residual_cost`` of ``_qba_inner`` with ``jax.grad`` /
    ``jax.hessian``, through :func:`_autodiff_system`. The data as
    :func:`_qba_system_fn` takes it; ``targets [B, n, T, D]`` with ``D`` the
    read's length (``n_nodes * C`` with node windows)."""
    Np, H, W, C = patches.shape
    B, n = rows.shape
    T = targets.shape[2]
    NP = 6 + cam_mask.shape[0]

    def coords(d, q, t, c):
        qd = quat_normalize(quat_mul(exp_quat(d[:, :3]), q))
        td = t + d[:, 3:6]
        cd = c + d[:, 6:] * cam_mask
        xy = world_to_pixel(model, cd[:, None], qd[:, None], td[:, None], X)
        return ((xy * scale - 0.5 - corner) * up[..., None]).reshape(-1, 2)

    def psi(f, pc):
        e = f.reshape(B, n, 1, -1) - targets
        s = torch.sum(e * e, dim=-1)                         # [B, n, T]
        if interp.check_bounds:
            v = bounds_violation(pc[:, 1], pc[:, 0], H, W).reshape(B, n, 1)
            s = s + v * v
        return 0.5 * torch.sum(tw * loss(s), dim=(1, 2))

    return _autodiff_system(coords, _read_fn(patches, rows, interp), psi,
                            NP)


def _patch_warp_system_fn(model: str, interp: InterpolationConfig,
                          loss: RobustLoss, cam_params, patches, rows,
                          corner, scale, up, X, offs, targets, w):
    """The patch-warp QBA system of one query (``_compiled_patch_warp_qba``
    of the JAX package): per correspondence the one-point reads (mode and
    L2 of ``interp``) at the reprojections of ``X + offs`` (``offs [n,
    n_nodes, 3]``), NCC-normalized across the nodes when configured, less
    the reference's node descriptor ``targets [n, n_nodes * D]``, weighted
    ``w [n]`` and robustified; the tangent is the 6-DoF pose (``system(q
    [1, 4], t [1, 3])``), the camera constant."""
    n, N = offs.shape[:2]
    single = InterpolationConfig(mode=interp.mode,
                                 l2_normalize=interp.l2_normalize)
    Xn = (X[:, None] + offs).reshape(1, n * N, 3)
    sc = scale.repeat_interleave(N, 0)
    co = corner.repeat_interleave(N, 0)
    u = up.repeat_interleave(N, 0)[:, None]

    def coords(d, q, t):
        qd = quat_normalize(quat_mul(exp_quat(d[:, :3]), q))
        xy = world_to_pixel(model, cam_params[None, None], qd[:, None],
                            (t + d[:, 3:6])[:, None], Xn)[0]
        return (xy * sc - 0.5 - co) * u

    def psi(f, pc):
        f = f.reshape(n, N, -1)
        if interp.ncc_normalize:
            f = ncc_normalize(f)
        r = f.reshape(n, -1) - targets
        return 0.5 * torch.sum(w * loss(torch.sum(r * r, -1)))[None]

    return _autodiff_system(coords, _read_fn(
        patches, rows.repeat_interleave(N, 0), single), psi, 6)


def _qba_run(system, max_iters: int, q0, t0, cams, cam_mask):
    """Damped Newton on the query poses (and the intrinsics ``cam_mask``
    frees) of ``B`` queries at once (``_qba_inner`` of the JAX package,
    vmapped there as ``_compiled_qba_batch``); ``system(q, t, c) -> (cost
    [B], g [B, NP], H [B, NP, NP])`` at the tangent 0 (or ``system(q, t)``
    when ``cams`` has no column, the patch-warp pose refinement).
    ``max_iters`` steps, each: the LM-damped step from the gradient and
    exact Hessian at the current state (lambda_0 = 1e-4, diagonal clipped
    to [1e-8, 1e32], / 3 on acceptance, x 4 on rejection), kept where it
    lowers the cost; the system at the new state is computed once and
    carried where it is kept. No host sync in the loop. Returns one ``[B,
    4 + 3 + k + 2]`` tensor: q, t, intrinsics, initial and final cost."""
    NP = 6 + cams.shape[1]
    free = torch.cat([cam_mask.new_ones(6), cam_mask])
    ff = free[:, None] * free[None, :]
    fixed = torch.diag(1.0 - free) + 1e-8 * torch.eye(NP, device=free.device)
    state = (lambda q, t, c: (q, t, c)) if cams.shape[1] else \
        (lambda q, t, c: (q, t))
    q, t, c = q0, t0, cams
    lam = q0.new_full((q0.shape[0],), 1e-4)
    cost0, g, Hm = system(*state(q, t, c))
    cost = cost0
    for _ in range(max_iters):
        gf, Hf = g * free, Hm * ff
        Dg = torch.clamp(torch.diagonal(Hf, dim1=-2, dim2=-1), 1e-8, 1e32)
        Hd = Hf + lam[:, None, None] * torch.diag_embed(Dg) + fixed
        d = -torch.linalg.solve_ex(Hd, gf)[0] * free
        q_new = quat_normalize(quat_mul(exp_quat(d[:, :3]), q))
        t_new = t + d[:, 3:6]
        c_new = c + d[:, 6:] * cam_mask
        new_cost, g_new, H_new = system(*state(q_new, t_new, c_new))
        accept = new_cost < cost
        a1 = accept[:, None]
        q = torch.where(a1, q_new, q)
        t = torch.where(a1, t_new, t)
        c = torch.where(a1, c_new, c)
        g = torch.where(a1, g_new, g)
        Hm = torch.where(accept[:, None, None], H_new, Hm)
        lam = torch.where(accept, lam / 3.0, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return torch.cat([q, t, c, cost0[:, None], cost[:, None]], dim=1)


def _analytic_qba(interp: InterpolationConfig) -> bool:
    """Whether :func:`_qba_system_fn` (one BICUBIC node) covers the config;
    NCC has no effect on one node, as in the JAX package."""
    return interp.mode in ("BICUBIC", "CERES_BICUBIC") and interp.n_nodes == 1


class QueryBundleAdjuster:
    """Pose-only featuremetric refinement (reference:
    localization/main.py:194-258 + single_query_bundle_optimizer.h:27-170),
    on ``device`` (``cuda`` unless ``"cpu"`` is passed)."""

    default_conf = {
        "apply": True,
        "interpolation": interpolation_default_conf,
        "level_indices": None,
        "optimizer": {
            "loss": {"name": "cauchy", "params": [0.25]},
            "solver": {**solver_default_conf, "parameter_tolerance": 0.0,
                       "use_nonmonotonic_steps": False},
            "print_summary": False,
            "refine_focal_length": False,
            "refine_principal_point": False,
            "refine_extra_params": False,
        },
    }

    def __init__(self, conf=None, device=None):
        self.conf = merge(self.default_conf, conf or {})
        self.device = resolve_device(device)

    def _options(self):
        interp = InterpolationConfig.from_conf(self.conf.get("interpolation"))
        check_window_config(interp)
        opt = self.conf.optimizer
        return (interp, make_loss(opt.get("loss")),
                int(opt.solver.get("max_num_iterations", 100)))

    def _cam_mask(self, camera: Camera) -> np.ndarray:
        """Intrinsics refinement subset (reference ParameterizeQuery)."""
        opt = self.conf.optimizer
        spec = CAMERA_MODELS[camera.model]
        cam_mask = np.zeros(spec.num_params, np.float32)
        if opt.get("refine_focal_length"):
            cam_mask[list(spec.focal_idxs)] = 1.0
        if opt.get("refine_principal_point"):
            cam_mask[list(spec.pp_idxs)] = 1.0
        if opt.get("refine_extra_params") and spec.extra_idxs:
            cam_mask[list(spec.extra_idxs)] = 1.0
        return cam_mask

    def _build_arrays(self, points3D, query_fmap, references, sel,
                      point2D_idxs):
        """Per-query QBA arrays (patches, rows, corner, scale, up, X,
        targets [n, T, D], tw [n, T])."""
        patches, corners, scales, ups, row_of = _pack_query_fmap(
            query_fmap, self.device)
        rows = _rows_for(row_of, [point2D_idxs[i] for i in sel]
                         if point2D_idxs is not None else sel)
        X = np.asarray([points3D[i] for i in sel], np.float32)
        refs = [np.asarray(references[i], np.float32) for i in sel]
        C = refs[0].reshape(-1, refs[0].shape[-1]).shape[-1] \
            if refs[0].ndim > 1 else refs[0].shape[0]
        T = max(1, max(r.reshape(-1, C).shape[0] for r in refs))
        targets = np.zeros((len(sel), T, C), np.float32)
        tw = np.zeros((len(sel), T), np.float32)
        for i, r in enumerate(refs):
            r2 = r.reshape(-1, C)
            targets[i, :len(r2)] = r2
            tw[i, :len(r2)] = 1.0
        return (patches, rows, corners[rows], scales[rows], ups[rows], X,
                targets, tw)

    def refine(self, qvec, tvec, camera: Camera, points3D, query_fmap,
               references, inliers=None, point2D_idxs=None) -> Dict:
        out = self.refine_batch([dict(
            qvec=qvec, tvec=tvec, camera=camera, points3D=points3D,
            query_fmap=query_fmap, references=references, inliers=inliers,
            point2D_idxs=point2D_idxs)])
        return out[0]

    def refine_batch(self, items: List[Dict], mesh=None) -> List[Dict]:
        """Refine several query poses in one batched solve.

        ``items``: per query a dict with keys qvec, tvec, camera, points3D,
        query_fmap, references, inliers (optional), point2D_idxs
        (optional). All queries share the camera model (group upstream);
        intrinsics values stay per query. Queries pad to the batch's
        largest correspondence and target counts with weight-0 copies of
        their first row, and their patch stacks concatenate. Returns one
        result dict per query (``skipped`` where no inlier is left).

        ``mesh``: the query axis, padded to a multiple of the mesh size
        with weight-0 copies of the first query (``:792-793`` of the JAX
        package), splits into one contiguous shard per device, each
        solved there with the patch stack copied to it."""
        from ..bundle_adjustment.references import Reference
        interp, loss, max_iters = self._options()
        prepared, results = [], [None] * len(items)
        for qi, it in enumerate(items):
            n = len(it["points3D"])
            inl = it.get("inliers")
            sel = [i for i in range(n) if inl is None or inl[i]]
            if not sel:
                results[qi] = dict(qvec=it["qvec"], tvec=it["tvec"],
                                   skipped=True)
                continue
            if isinstance(it["references"][sel[0]], Reference):
                # the "full" mode: one query at a time, as the JAX package
                results[qi] = self._refine_patch_warp(
                    it["qvec"], it["tvec"], it["camera"], it["points3D"],
                    it["query_fmap"], it["references"], sel,
                    it.get("point2D_idxs"), interp, loss, max_iters)
                continue
            prepared.append((qi, it, self._build_arrays(
                it["points3D"], it["query_fmap"], it["references"], sel,
                it.get("point2D_idxs"))))
        if not prepared:
            return results
        models = {it["camera"].model for _, it, _ in prepared}
        if len(models) > 1:
            raise ValueError(f"refine_batch needs one camera model, "
                             f"got {models}")
        camera0 = prepared[0][1]["camera"]
        cam_mask = self._cam_mask(camera0)
        k = len(camera0.params)
        Q = len(prepared)
        N = max(len(a[1]) for _, _, a in prepared)
        T = max(a[6].shape[1] for _, _, a in prepared)
        C = prepared[0][2][6].shape[2]

        rows_b = np.zeros((Q, N), np.int64)
        corner_b = np.zeros((Q, N, 2), np.float32)
        scale_b = np.ones((Q, N, 2), np.float32)
        up_b = np.ones((Q, N), np.float32)
        X_b = np.zeros((Q, N, 3), np.float32)
        tgt_b = np.zeros((Q, N, T, C), np.float32)
        tw_b = np.zeros((Q, N, T), np.float32)
        pose_b = np.zeros((Q, 7 + k), np.float32)
        off = 0
        for j, (qi, it, a) in enumerate(prepared):
            (patches, rows, corner, scale, up, X, targets, tw) = a
            n = len(rows)
            fill = np.r_[np.arange(n), np.zeros(N - n, np.int64)]
            rows_b[j] = rows[fill] + off
            corner_b[j] = corner[fill]
            scale_b[j] = scale[fill]
            up_b[j] = up[fill]
            X_b[j] = X[fill]
            tgt_b[j, :, :targets.shape[1]] = targets[fill]
            tw_b[j, :n, :tw.shape[1]] = tw
            pose_b[j] = np.concatenate([
                np.asarray(it["qvec"], np.float32),
                np.asarray(it["tvec"], np.float32),
                np.asarray(it["camera"].params, np.float32)])
            off += patches.shape[0]
        patches_all = torch.cat([a[0] for _, _, a in prepared]) \
            if Q > 1 else prepared[0][2][0]

        devices = (self.device,) if mesh is None else mesh.devices
        Qp = -(-Q // len(devices)) * len(devices)     # mesh-divisible pad
        if Qp > Q:
            tw_b = np.concatenate([tw_b, np.zeros((Qp - Q,) + tw_b.shape[1:],
                                                  tw_b.dtype)])  # no cost
        arrays = [np.concatenate([a, np.repeat(a[:1], Qp - Q, 0)])
                  if len(a) < Qp else a
                  for a in (rows_b, corner_b, scale_b, up_b, X_b, tgt_b, tw_b,
                            pose_b)]
        system_fn = _qba_system_fn if _analytic_qba(interp) \
            else _qba_autodiff_system_fn
        parts = []
        for (s, e), d in zip(shard_bounds(Qp, len(devices)), devices):
            *data, pose_d = (torch.as_tensor(a[s:e], device=d)
                             for a in arrays)
            cm = torch.as_tensor(cam_mask, device=d)
            with device_scope(d):
                out = _qba_run(
                    system_fn(camera0.model, interp, loss, cm,
                              replicate(patches_all, d), *data),
                    max_iters, pose_d[:, :4], pose_d[:, 4:7], pose_d[:, 7:],
                    cm)
            parts.append(out.cpu().numpy())             # one fetch a shard
        packed = np.concatenate(parts)[:Q].astype(np.float64)
        q, t, c = packed[:, :4], packed[:, 4:7], packed[:, 7:7 + k]
        c0, c1 = packed[:, 7 + k], packed[:, 8 + k]
        for j, (qi, it, _a) in enumerate(prepared):
            if cam_mask.any():
                it["camera"].params = c[j].copy()
            results[qi] = dict(qvec=q[j], tvec=t[j], camera_params=c[j],
                               initial_cost=float(c0[j]),
                               final_cost=float(c1[j]))
        return results

    def _refine_patch_warp(self, qvec, tvec, camera: Camera, points3D,
                           query_fmap, references, sel, point2D_idxs,
                           interp: InterpolationConfig, loss,
                           max_iters: int) -> Dict:
        """Patch-warp QBA of one query ("full" reference mode,
        ``_refine_patch_warp`` of the JAX package): the correspondences
        ``sel`` whose references carry ``node_offsets3D``, each read at the
        reprojections of ``X + node_offsets3D`` against the reference's
        node descriptor, over damped Newton steps in the 6-DoF pose with
        the JAX package's lambda schedule (:func:`_patch_warp_system_fn`).
        Skipped when no reference has offsets
        (``references.compute_offsets3D: false``)."""
        patches, corners, scales, ups, row_of = _pack_query_fmap(
            query_fmap, self.device)
        rows = _rows_for(row_of, [point2D_idxs[i] for i in sel]
                         if point2D_idxs is not None else sel)
        keep = [j for j, i in enumerate(sel)
                if references[i].node_offsets3D is not None]
        if not keep:
            logger.warning("patch-warp QBA: references carry no "
                           "node_offsets3D (set references."
                           "compute_offsets3D=True); skipping")
            return dict(qvec=qvec, tvec=tvec, skipped=True)
        rows = rows[keep]
        idx = [sel[j] for j in keep]
        X = np.asarray([points3D[i] for i in idx], np.float32)
        offs = np.stack([references[i].node_offsets3D
                         for i in idx]).astype(np.float32)
        targets = np.stack([references[i].descriptor
                            for i in idx]).astype(np.float32)

        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=self.device)

        system = _patch_warp_system_fn(
            camera.model, interp, loss, put(camera.params), patches,
            put(rows, torch.int64), put(corners[rows]), put(scales[rows]),
            put(ups[rows]), put(X), put(offs), put(targets),
            put(np.ones(len(idx))))
        out = _qba_run(system, max_iters, put(qvec)[None], put(tvec)[None],
                       put(np.zeros((1, 0))), put(np.zeros(0)))
        out = out[0].cpu().numpy().astype(np.float64)     # one fetch
        return dict(qvec=out[:4], tvec=out[4:7], initial_cost=float(out[7]),
                    final_cost=float(out[8]))

    def refine_multilevel(self, qvec, tvec, camera, points3D, query_fmaps,
                          query_references, inliers=None,
                          point2D_idxs=None) -> Dict:
        out: Dict = {"qvec": qvec, "tvec": tvec}
        for level in _levels(self.conf, len(query_fmaps)):
            s = self.refine(out["qvec"], out["tvec"], camera, points3D,
                            query_fmaps[level], query_references[level],
                            inliers=inliers, point2D_idxs=point2D_idxs)
            out.update(s)
        return out


# ---------------------------------------------------------------------------
# QueryLocalizer
# ---------------------------------------------------------------------------

class QueryLocalizer:
    """Full localization flow (reference: localization/main.py:261-537), on
    ``device`` (``cuda`` unless ``"cpu"`` is passed)."""

    default_conf = {
        "dense_features": {},
        "overwrite_features_sparse": None,
        "interpolation": interpolation_default_conf,
        "target_reference": "nearest",
        "unique_inliers": "min_error",
        "references": {
            "loss": {"name": "cauchy", "params": [0.25]},
            "iters": 100,
            "keep_observations": True,
            "compute_offsets3D": False,
            "num_threads": -1,
        },
        "max_tracks_per_problem": 50,
        "QKA": QueryKeypointAdjuster.default_conf,
        "PnP": {"estimation": {"ransac": {"max_error": 12}},
                "refinement": {}},
        "QBA": QueryBundleAdjuster.default_conf,
        # multi-device serving: the query batch of ``localize_batch``
        # sharded over a device mesh (n_devices=None: every card)
        "parallel": {"enabled": False, "n_devices": None},
    }

    def __init__(self, reconstruction: Reconstruction, conf=None,
                 dense_features=None, image_dir=None, references=None,
                 extractor=None, device=None):
        conf = conf or {}
        if "localization" in conf:
            conf = conf["localization"]
        if hasattr(conf, "to_dict"):
            # resolve ``${..interpolation}`` against the tree it came from
            conf = conf.to_dict()
        self.conf = merge(self.default_conf, conf)
        self.device = resolve_device(device)
        self.reconstruction = reconstruction
        self.extractor = extractor
        self.qka = QueryKeypointAdjuster(self.conf.QKA, device=self.device)
        self.qba = QueryBundleAdjuster(self.conf.QBA, device=self.device)
        self.interp = InterpolationConfig.from_conf(
            self.conf.get("interpolation"))

        self.target_reference_funcs = {
            "nearest": self._nearest_refs,
            "robust_mean": self._robust_mean_refs,
            "all_observations": self._all_obs_refs,
            "full": self._full_refs,
        }
        if self.conf.target_reference == "full" and self.conf.QKA.apply:
            # the JAX package's QKA takes descriptors: its "full" mode fails
            # on the Reference objects there too
            raise ValueError("target_reference 'full' gives Reference "
                             "objects, which only patch-warp QBA reads; set "
                             "QKA.apply: false")
        self.get_query_references = \
            self.target_reference_funcs[self.conf.target_reference]

        self.references = references
        if self.references is None and (self.conf.QKA.apply
                                        or self.conf.QBA.apply):
            from ..bundle_adjustment.references import extract_references
            if dense_features is None:
                if image_dir is None:
                    raise ValueError(
                        "need dense_features or image_dir to build references")
                from ..extract import features_from_reconstruction
                dense_features = features_from_reconstruction(
                    self._extractor(), reconstruction, image_dir)
            elif isinstance(dense_features, (str, Path)):
                from ..features.featuremaps import FeatureManager
                dense_features = FeatureManager.from_cache(
                    dense_features, device=self.device)
            self.references = []
            for lvl in range(dense_features.num_levels):
                fset = dense_features.fset(lvl)
                view = FeatureView.from_reconstruction(fset, reconstruction)
                self.references.append(extract_references(
                    reconstruction, fset, view, self.conf.references,
                    self.interp))

    def _parallel_mesh(self):
        """The device mesh of ``parallel.enabled`` when more than one
        device is available, else None (the knob of the adjusters)."""
        return parallel_mesh(self.conf.get("parallel"), self.device)

    def _extractor(self):
        if self.extractor is None:
            from ..features.extractor import FeatureExtractor
            self.extractor = FeatureExtractor(self.conf.dense_features,
                                              device=self.device)
        return self.extractor

    # -- reference modes ----------------------------------------------------
    def _nearest_refs(self, p3D_ids, query_fmaps, points2D, patch_idxs):
        return [find_nearest_references(query_fmaps[lvl],
                                        self.references[lvl], points2D,
                                        p3D_ids, self.interp,
                                        patch_idxs=patch_idxs,
                                        device=self.device)
                for lvl in range(len(self.references))]

    def _robust_mean_refs(self, p3D_ids, *args):
        return [[refs[p].descriptor for p in p3D_ids]
                for refs in self.references]

    def _all_obs_refs(self, p3D_ids, *args):
        out = []
        for refs in self.references:
            level = []
            for p in p3D_ids:
                if refs[p].track_descriptors is None:
                    raise RuntimeError(
                        "references.keep_observations must be True for "
                        "all_observations mode")
                level.append(refs[p].track_descriptors)
            out.append(level)
        return out

    def _full_refs(self, p3D_ids, *args):
        return [[refs[p] for p in p3D_ids] for refs in self.references]

    def extract_query_fmaps(self, keypoints: np.ndarray, pnp_point2D_idxs,
                            image_path):
        """Features at the query keypoints that the correspondences use.
        ``image_path``: a file or a decoded ``[H, W, 3]`` uint8 array.
        Extracting a superset of keypoints is safe: QKA and QBA look
        patches up by keypoint id. ``overwrite_features_sparse: false``
        keeps the query's whole map (a dense ``FeatureMap``)."""
        keypoints = np.array(keypoints, np.float64)
        required = sorted(set(int(i) for i in pnp_point2D_idxs))
        return self._extractor()(
            image_path, keypoints=keypoints[required], keypoint_ids=required,
            overwrite_sparse=self.conf.get("overwrite_features_sparse"))

    def _drop_unreferenced(self, p2D, p3D):
        """Drop correspondences to points without references (tracks whose
        observations were never extracted)."""
        keep = [i for i, pid in enumerate(p3D)
                if all(pid in refs for refs in self.references)]
        if len(keep) < len(p3D):
            logger.warning(
                "localize: dropping %d/%d correspondences without "
                "references.", len(p3D) - len(keep), len(p3D))
            p2D = [p2D[i] for i in keep]
            p3D = [p3D[i] for i in keep]
        return p2D, p3D

    def _unique_inliers(self, inliers, p3D, pose, camera, points2D,
                        points3D, p2D):
        mode = self.conf.get("unique_inliers")
        if mode == "random":
            return find_unique_inliers(p3D, pre_inliers=inliers)
        if mode == "min_error":
            return find_unique_min_reproj_inliers(
                p3D, pose["qvec"], pose["tvec"], camera, points2D, points3D,
                pre_inliers=inliers, point2D_idxs=p2D)
        if mode:
            logger.warning("Unknown unique_inlier method %s", mode)
        return inliers

    # -- main entry ---------------------------------------------------------
    def localize(self, keypoints: np.ndarray, pnp_point2D_idxs,
                 pnp_points3D_id, query_camera: Camera, image_path=None,
                 query_fmaps=None) -> Dict:
        if len(pnp_point2D_idxs) == 0:
            return {"success": False}
        if len(pnp_point2D_idxs) != len(pnp_points3D_id):
            raise ValueError("pnp_point2D_idxs and pnp_points3D_id differ "
                             "in length")
        keypoints = np.array(keypoints, np.float64)

        require_feats = self.conf.QKA.apply or self.conf.QBA.apply
        if require_feats and self.references is not None:
            pnp_point2D_idxs, pnp_points3D_id = self._drop_unreferenced(
                list(pnp_point2D_idxs), list(pnp_points3D_id))
            if len(pnp_point2D_idxs) == 0:
                return {"success": False}
        pnp_points3D = [self.reconstruction.points3D[p].xyz
                        for p in pnp_points3D_id]
        if query_fmaps is None and require_feats:
            query_fmaps = self.extract_query_fmaps(keypoints,
                                                   pnp_point2D_idxs,
                                                   image_path)

        pnp_points2D = keypoints[np.asarray(pnp_point2D_idxs, np.int64)]
        if require_feats:
            query_references = self.get_query_references(
                pnp_points3D_id, query_fmaps, pnp_points2D, pnp_point2D_idxs)

        max_error = float(self.conf.PnP.estimation.ransac.max_error)
        # always polish: QBA's featuremetric basin is about the
        # interpolation window, and the unpolished RANSAC pose starts
        # outside it (the JAX package measured it on ETH3D synth)
        polish = True
        pose_dict = None
        if self.conf.QKA.apply:
            levels = _levels(self.qka.conf, len(query_fmaps))
            if (len(pnp_points2D) >= 6
                    and not self.conf.QKA.get("stack_correspondences")):
                pose_dict = self._localize_qka_pnp_fused(
                    levels, pnp_points2D, pnp_point2D_idxs,
                    query_fmaps, query_references, pnp_points3D,
                    query_camera, max_error, polish)
            else:
                self.qka.refine_multilevel(pnp_points2D, query_fmaps,
                                           query_references,
                                           point2D_idxs=pnp_point2D_idxs)

        if pose_dict is None:
            logger.info("Running PnP with %d correspondences.",
                        len(pnp_points2D))
            pose_dict = absolute_pose_estimation_batch(
                [dict(points2D=pnp_points2D,
                      points3D=np.asarray(pnp_points3D),
                      camera=query_camera)],
                max_error_px=max_error, polish=polish, device=self.device)[0]
        if not pose_dict["success"]:
            return pose_dict

        inliers = self._unique_inliers(
            pose_dict["inliers"], pnp_points3D_id, pose_dict, query_camera,
            pnp_points2D, pnp_points3D, pnp_point2D_idxs)

        if self.conf.QBA.apply:
            out = self.qba.refine_multilevel(
                pose_dict["qvec"], pose_dict["tvec"], query_camera,
                pnp_points3D, query_fmaps, query_references,
                inliers=inliers, point2D_idxs=pnp_point2D_idxs)
            pose_dict["qvec"] = out["qvec"]
            pose_dict["tvec"] = out["tvec"]
            if "initial_cost" in out:
                pose_dict["QBA"] = {"initial_cost": out["initial_cost"],
                                    "final_cost": out["final_cost"]}

        errors = compute_reprojection_errors(
            pnp_points2D, pnp_points3D, pose_dict["qvec"],
            pose_dict["tvec"], query_camera)
        pose_dict["inliers"] = [bool(e < max_error) for e in errors]
        pose_dict["num_inliers"] = int(np.sum(pose_dict["inliers"]))
        return pose_dict

    def _localize_qka_pnp_fused(self, levels, pnp_points2D, pnp_point2D_idxs,
                                query_fmaps, query_references, pnp_points3D,
                                query_camera, max_error: float,
                                polish: bool):
        """The single-query QKA -> PnP chain (``_compiled_qka_pnp`` of the
        JAX package, one fused program there): per level one fixed-target
        LM solve over all correspondences, its bound boxes centred on the
        running keypoints (level l starts from level l-1's output); then
        the stage-1 P3P RANSAC on the refined keypoints with the samples of
        ``np.random.default_rng(0)``; escalation to the full staged RANSAC
        when its consensus misses the acceptance bar. Refines
        ``pnp_points2D`` in place and returns the PnP pose dict. The
        keypoints stay on the device between the stages; one fetch at the
        end."""
        interp, loss, lm_opts, bound = self.qka._options()
        dev = self.device
        P = len(pnp_points2D)

        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        level_args = []
        kp0 = writeback = None
        for level in levels:
            (kp0, rows, corner, scale, up, targets, tw, _lo, _hi, patches,
             writeback) = self.qka._build_problems(
                pnp_points2D, query_fmaps[level], query_references[level],
                pnp_point2D_idxs, interp, bound)
            n_p, H, W, C = patches.shape
            ext = np.array([W, H], np.float64)
            plo = (corner + 0.5) / scale
            phi = plo + ext / scale
            bscale = (bound / scale if bound > 0
                      else np.full_like(scale, np.inf))
            level_args.append((
                (patches.reshape(n_p * H, W, C), H, W, C),
                (put(rows, torch.int64), put(corner), put(scale), put(up),
                 put(targets), put(tw)),
                put(plo), put(phi),
                put(np.nan_to_num(np.asarray(bscale, np.float32),
                                  posinf=1e30))))
        pmask = torch.ones(P, dtype=torch.bool, device=dev)
        fmask = pmask[:, None].expand(-1, 2)
        kp = put(kp0)
        for rows_spec, data, plo, phi, bscale in level_args:
            lower = torch.maximum(plo, kp - bscale)
            upper = torch.minimum(phi, kp + bscale)
            kp, _ = _run_target_chunk(rows_spec, interp, loss, lm_opts, kp,
                                      data, lower, upper, pmask, fmask)

        n = P
        samples = _gen_samples(np.random.default_rng(0), n,
                               STAGE1_MAX_SAMPLES)
        bq, bt, binl, bcnt = _pnp_core(
            query_camera.model, put(pnp_points3D)[None], kp[None],
            torch.ones((1, n), dtype=torch.bool, device=dev),
            put(query_camera.params)[None], put(samples, torch.int64)[None],
            float(max_error), families="p3p")
        res = torch.cat([kp.reshape(-1), bq[0], bt[0],
                         bcnt.to(kp.dtype), binl[0].to(kp.dtype)])
        res = res.cpu().numpy()                         # one fetch
        writeback(res[:2 * P].reshape(P, 2), pnp_points2D)
        q, t = res[2 * P:2 * P + 4], res[2 * P + 4:2 * P + 7]
        cnt = int(res[2 * P + 7])
        inl = res[2 * P + 8:] > 0.5
        logger.info("Running PnP with %d correspondences (after QKA).", n)
        if not _stage_accept(cnt, n, 0.0):
            # hard query: the P3P stage missed the acceptance bar; run the
            # full staged RANSAC on the (written back) refined keypoints
            logger.debug("QKA -> PnP below acceptance bar (%d/%d inliers), "
                         "escalating to full RANSAC.", cnt, n)
            return absolute_pose_estimation_batch(
                [dict(points2D=np.asarray(pnp_points2D, np.float64),
                      points3D=np.asarray(pnp_points3D, np.float64),
                      camera=query_camera)],
                max_error_px=max_error, polish=polish, device=dev)[0]
        return finalize_device_pose(
            query_camera, q.astype(np.float64), t.astype(np.float64), inl,
            cnt, np.asarray(pnp_points2D, np.float64),
            np.asarray(pnp_points3D, np.float64), max_error, polish=polish)

    def localize_batch(self, queries: List[Dict]) -> List[Dict]:
        """Localize several queries with batched device programs.

        ``queries``: per query a dict with keys ``keypoints``,
        ``pnp_point2D_idxs``, ``pnp_points3D_id``, ``query_camera``, and
        ``image_path`` or ``query_fmaps``. The per-query semantics of
        :meth:`localize`, but QKA solves all queries' fixed-target problems
        in one LM per level, PnP runs one RANSAC program per size group,
        and QBA runs one batched solve per camera model and level; with
        ``parallel.enabled`` each splits its batch over the device mesh."""
        mesh = self._parallel_mesh()
        require_feats = self.conf.QKA.apply or self.conf.QBA.apply
        results: List[Optional[Dict]] = [None] * len(queries)
        prep: List[Dict] = []
        for qi, q in enumerate(queries):
            p2D = list(q["pnp_point2D_idxs"])
            p3D = list(q["pnp_points3D_id"])
            if len(p2D) == 0:
                results[qi] = {"success": False}
                continue
            if len(p2D) != len(p3D):
                raise ValueError("pnp_point2D_idxs and pnp_points3D_id "
                                 "differ in length")
            kps = np.array(q["keypoints"], np.float64)
            if require_feats and self.references is not None:
                p2D, p3D = self._drop_unreferenced(p2D, p3D)
                if not p2D:
                    results[qi] = {"success": False}
                    continue
            fmaps = q.get("query_fmaps")
            if fmaps is None and require_feats:
                fmaps = self.extract_query_fmaps(kps, p2D,
                                                 q.get("image_path"))
            points3D = [self.reconstruction.points3D[p].xyz for p in p3D]
            points2D = kps[np.asarray(p2D, np.int64)]
            refs = (self.get_query_references(p3D, fmaps, points2D, p2D)
                    if require_feats else None)
            prep.append(dict(qi=qi, camera=q["query_camera"], p2D=p2D,
                             p3D=p3D, fmaps=fmaps, points3D=points3D,
                             points2D=points2D, refs=refs))

        # ---- QKA: one batched solve per level ------------------------------
        if self.conf.QKA.apply and prep:
            for level in _levels(self.qka.conf, len(prep[0]["fmaps"])):
                self.qka.refine_batch(
                    [(p["points2D"], p["fmaps"][level], p["refs"][level],
                      p["p2D"]) for p in prep], mesh=mesh)

        # ---- PnP: one RANSAC program per size group (always polished) ----
        max_error = float(self.conf.PnP.estimation.ransac.max_error)
        survivors = []
        poses = absolute_pose_estimation_batch(
            [dict(points2D=p["points2D"], points3D=np.asarray(p["points3D"]),
                  camera=p["camera"]) for p in prep],
            max_error_px=max_error, polish=True, mesh=mesh,
            device=self.device)
        for p, pose in zip(prep, poses):
            if not pose["success"]:
                results[p["qi"]] = pose
                continue
            p["pose"] = pose
            p["inliers"] = self._unique_inliers(
                pose["inliers"], p["p3D"], pose, p["camera"], p["points2D"],
                p["points3D"], p["p2D"])
            survivors.append(p)

        # ---- QBA: one batched solve per camera model and level ------------
        if self.conf.QBA.apply and survivors:
            groups: Dict[str, List[Dict]] = {}
            for p in survivors:
                groups.setdefault(p["camera"].model, []).append(p)
            for level in _levels(self.qba.conf, len(survivors[0]["fmaps"])):
                for group in groups.values():
                    outs = self.qba.refine_batch([
                        dict(qvec=p["pose"]["qvec"], tvec=p["pose"]["tvec"],
                             camera=p["camera"], points3D=p["points3D"],
                             query_fmap=p["fmaps"][level],
                             references=p["refs"][level],
                             inliers=p["inliers"], point2D_idxs=p["p2D"])
                        for p in group], mesh=mesh)
                    for p, out in zip(group, outs):
                        if out.get("skipped"):
                            continue
                        p["pose"]["qvec"] = out["qvec"]
                        p["pose"]["tvec"] = out["tvec"]
                        p["pose"]["QBA"] = {
                            "initial_cost": out["initial_cost"],
                            "final_cost": out["final_cost"]}

        for p in survivors:
            pose = p["pose"]
            errors = compute_reprojection_errors(
                p["points2D"], p["points3D"], pose["qvec"], pose["tvec"],
                p["camera"])
            pose["inliers"] = [bool(e < max_error) for e in errors]
            pose["num_inliers"] = int(np.sum(pose["inliers"]))
            results[p["qi"]] = pose
        return results
