"""Robust per-track reference descriptors (reference:
pixsfm/bundle_adjustment/src/reference_extractor.h:57-363 +
base/src/irls_optim.h:23-71).

Port of ``pixsfm_tpu/bundle_adjustment/references.py``. For every 3D point:
interpolate each track observation's descriptor at the point's reprojected
location, compute a robust (IRLS) mean over the track, and keep the
observation whose descriptor is closest to that mean.

The descriptor reads take ``ops/interpolate_cuda.interpolate_nodes`` (the
JAX package's ``interpolate_nodes``), once for all observations straight
from the packed patch rows: for BICUBIC one K1 launch, one query per
observation, or with node windows one per node and observation; BILINEAR,
NEARESTNEIGHBOR and BICUBICCHAIN in plain PyTorch. The ``n_nodes x D``
descriptor is NCC-normalized across the nodes when the config asks. The
IRLS runs batched over all points at once on the device; with a device
mesh both stages run shard by shard over contiguous slices of the points.
``compute_offsets3D`` lifts each node at the source observation's depth
(``Reference.node_offsets3D``), vectorised over points per camera model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import logger
from ..base.cameras import img_from_cam
from ..base.geometry import apply_pose, quat_normalize
from ..base.interpolation import InterpolationConfig, check_window_config
from ..base.losses import RobustLoss, make_loss
from ..base.projection import pixel_to_world, project_np
from ..ops.interpolate_cuda import interpolate_nodes
from ..parallel.sharded import shard_bounds
from ..util.misc import bucket

__all__ = ["Reference", "extract_references", "node_offsets3D",
           "robust_mean_irls"]


@dataclass
class Reference:
    """Per-point3D reference (reference: features/src/references.{h,cc})."""
    source: Tuple[int, int]               # (image_id, p2D_idx) of chosen obs
    descriptor: np.ndarray                # [n_nodes * C], node-major
    node_offsets3D: Optional[np.ndarray] = None   # [n_nodes, 3]
    observations: Optional[List[Tuple[int, int]]] = None
    costs: Optional[np.ndarray] = None    # [T] distance to robust mean
    track_descriptors: Optional[np.ndarray] = None  # [T, C]


def robust_mean_irls(descriptors, valid, loss: RobustLoss, iters: int,
                     l2_normalize: bool = True):
    """IRLS robust mean over axis -2 of ``[..., T, D]`` descriptors
    (irls_optim.h:23-71); ``valid [..., T]`` masks padded track slots. The
    mean is re-normalized every iteration when ``l2_normalize``."""
    v = valid.to(descriptors.dtype)

    def normalize(m):
        if l2_normalize:
            return m / torch.clamp(torch.linalg.vector_norm(
                m, dim=-1, keepdim=True), min=1e-12)
        return m

    mean = normalize(torch.sum(descriptors * v[..., None], dim=-2)
                     / torch.clamp(torch.sum(v, dim=-1, keepdim=True),
                                   min=1.0))
    for _ in range(int(iters)):
        d2 = torch.sum((descriptors - mean[..., None, :]) ** 2, dim=-1)
        w = loss.weight(d2) * v
        mean = normalize(torch.sum(descriptors * w[..., None], dim=-2)
                         / torch.clamp(torch.sum(w, dim=-1, keepdim=True),
                                       min=1e-12))
    return mean


def _track_stage(rows_view, H: int, W: int, obs_row, pc, flat, n_points: int,
                 T: int, loss: RobustLoss, iters: int,
                 interp: InterpolationConfig, dev):
    """The device stages of ``n_points`` points on ``dev``: the read of
    their observations (``obs_row``, patch coords ``pc``; ``flat`` = local
    point * T + track slot of each), the IRLS robust mean over each track
    and the observation closest to it. Returns host ``(track_desc [n, T,
    D], d2 [n, T], best [n])``."""
    C = rows_view.shape[-1]
    desc, _, _ = interpolate_nodes(
        rows_view, H, W, C,
        torch.as_tensor(obs_row * H, dtype=torch.int32, device=dev),
        torch.as_tensor(pc[:, 1], device=dev),
        torch.as_tensor(pc[:, 0], device=dev), interp)
    desc = desc.reshape(desc.shape[0], -1)
    D = desc.shape[1]
    flat = torch.as_tensor(flat, device=dev)
    track_desc = desc.new_zeros((n_points * T, D))
    track_desc[flat] = desc
    track_desc = track_desc.reshape(n_points, T, D)
    track_valid = torch.zeros(n_points * T, dtype=torch.bool, device=dev)
    track_valid[flat] = True
    track_valid = track_valid.reshape(n_points, T)
    means = robust_mean_irls(track_desc, track_valid, loss, iters,
                             l2_normalize=interp.l2_normalize)

    # per point: the observation closest to the robust mean
    d2 = torch.sum((track_desc - means[:, None, :]) ** 2, dim=2)
    d2 = torch.where(track_valid, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(d2, dim=1)
    return track_desc.cpu().numpy(), d2.cpu().numpy(), best.cpu().numpy()


def extract_references(reconstruction, feature_set, view, conf,
                       interp: InterpolationConfig,
                       point3D_ids: Optional[Sequence[int]] = None,
                       keep_observations: Optional[bool] = None,
                       mesh=None) -> Dict[int, Reference]:
    """References for all (or the given) points. ``conf`` is the
    ``references`` config subtree ({loss, iters, keep_observations,
    compute_offsets3D}); everything runs on the device of ``view``'s
    packed patches.

    ``mesh`` (a ``parallel.Mesh``): the points split into one contiguous
    shard per mesh device, each with its tracks' observations; the reads
    and the IRLS of a shard run on its device with the patches copied
    there (both stages are per point or per observation: no cross-shard
    step; ``sharding`` of the JAX package)."""
    t0 = time.time()
    get = conf.get if hasattr(conf, "get") else lambda k, d=None: d
    loss = make_loss(get("loss", {"name": "cauchy", "params": [0.25]}))
    iters = int(get("iters", 100) or 100)
    if keep_observations is None:
        keep_observations = bool(get("keep_observations", False))
    compute_offsets = bool(get("compute_offsets3D", False))
    check_window_config(interp)

    pids = list(point3D_ids if point3D_ids is not None
                else sorted(reconstruction.points3D.keys()))
    if not pids:
        return {}
    pf = view.packed

    # flatten all track observations; reprojected locations batched per image
    per_image: Dict[int, list] = {}
    for s, pid in enumerate(pids):
        for (iid, p2D_idx) in reconstruction.points3D[pid].track:
            per_image.setdefault(iid, []).append((s, pid, int(p2D_idx)))
    obs_pt, obs_row, obs_xy, obs_track = [], [], [], []
    for iid, items in per_image.items():
        im = reconstruction.images[iid]
        cam = reconstruction.cameras[im.camera_id]
        X = np.stack([reconstruction.points3D[pid].xyz for _, pid, _ in items])
        xy, depth = project_np(cam, im.qvec, im.tvec, X)
        for (s, pid, p2D_idx), xyi, z in zip(items, xy, depth):
            if z <= 1e-6:
                continue
            row = pf.row_or(im.name, p2D_idx)
            if row < 0:       # observation was never extracted
                continue
            obs_pt.append(s)
            obs_row.append(row)
            obs_xy.append(xyi)
            obs_track.append((iid, p2D_idx))
    if not obs_pt:
        return {}
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_row = np.asarray(obs_row, np.int64)
    obs_xy = np.asarray(obs_xy, np.float64)

    # descriptor at each reprojection: one read over the node queries of
    # every observation (one node by default), then the IRLS over the
    # points, on each shard of points in turn (one shard without a mesh)
    B, H, W, C = pf.patches.shape
    # patch coordinates in float32, as the JAX package rounds them (a
    # pixel of ~1000 carries 6e-5 px of float32 rounding, which NCC
    # scales by 1 / sigma)
    f32 = np.float32
    pc = ((obs_xy.astype(f32) * pf.scales[obs_row].astype(f32) - f32(0.5)
           - pf.corners[obs_row].astype(f32))
          * pf.upsampling[obs_row].astype(f32)[:, None])
    rows_view = pf.patches.reshape(B * H, W, C)

    # tracks padded to T (power of two)
    counts = np.bincount(obs_pt, minlength=len(pids))
    T = bucket(int(counts.max()), minimum=2)
    order = np.argsort(obs_pt, kind="stable")
    sorted_pt = obs_pt[order]
    starts = np.searchsorted(sorted_pt, np.arange(len(pids)), side="left")
    obs_slot = np.empty(len(obs_pt), np.int64)
    obs_slot[order] = np.arange(len(obs_pt)) - starts[sorted_pt]

    devices = (pf.patches.device,) if mesh is None else mesh.devices
    parts = []
    for (s0, s1), dev in zip(shard_bounds(len(pids), len(devices)),
                             devices):
        sel = np.nonzero((obs_pt >= s0) & (obs_pt < s1))[0]
        if s1 > s0:
            parts.append(_track_stage(
                rows_view.to(dev), H, W, obs_row[sel], pc[sel],
                (obs_pt[sel] - s0) * T + obs_slot[sel], s1 - s0, T, loss,
                iters, interp, dev))
    track_desc, d2, best = (np.concatenate(p) for p in zip(*parts))

    track_elems: Dict[Tuple[int, int], Tuple[int, int]] = {
        (int(s), int(t)): e for s, t, e in zip(obs_pt, obs_slot, obs_track)}
    if compute_offsets:
        has = np.nonzero(counts > 0)[0]
        offsets = dict(zip(has, node_offsets3D(
            reconstruction, [track_elems[(int(s), int(best[s]))]
                             for s in has],
            [pids[s] for s in has], pf, interp)))
    refs: Dict[int, Reference] = {}
    for s, pid in enumerate(pids):
        if counts[s] == 0:
            continue
        b = int(best[s])
        ref = Reference(source=track_elems[(s, b)],
                        descriptor=track_desc[s, b].copy())
        if keep_observations:
            n = int(counts[s])
            ref.observations = [track_elems[(s, t)] for t in range(n)]
            ref.costs = d2[s, :n].copy()
            ref.track_descriptors = track_desc[s, :n].copy()
        if compute_offsets:
            ref.node_offsets3D = offsets[s]
        refs[pid] = ref
    logger.info("Reference extraction: %.3fs (%d points)",
                time.time() - t0, len(refs))
    return refs


def node_offsets3D(reconstruction, sources: Sequence[Tuple[int, int]],
                   point3D_ids: Sequence[int], pf,
                   interp: InterpolationConfig) -> np.ndarray:
    """``[P, n_nodes, 3]``: each node offset ``(dx, dy) / scale`` around the
    source observation's reprojection lifted at its depth, less the lifted
    reprojection (reference: reference_extractor.h:331-363; the JAX
    package's ``_node_offsets3D`` one point and one node at a time, here
    all points of a camera model at once, in float64 on the host)."""
    nodes = torch.as_tensor(interp.nodes_array(), dtype=torch.float64)
    zero = torch.zeros((1, 2), dtype=torch.float64)
    nodes = torch.cat([zero, nodes])               # node 0: the reprojection
    P = len(sources)
    out = np.zeros((P, interp.n_nodes, 3))
    models: Dict[str, List[int]] = {}
    for j, (iid, _) in enumerate(sources):
        cam = reconstruction.cameras[reconstruction.images[iid].camera_id]
        models.setdefault(cam.model, []).append(j)
    for model, idx in models.items():
        ims = [reconstruction.images[sources[j][0]] for j in idx]
        params = torch.as_tensor(np.stack(
            [reconstruction.cameras[im.camera_id].params for im in ims]))
        q = torch.as_tensor(np.stack([im.qvec for im in ims]))
        t = torch.as_tensor(np.stack([im.tvec for im in ims]))
        X = torch.as_tensor(np.stack([reconstruction.points3D[
            point3D_ids[j]].xyz for j in idx]))
        x_cam = apply_pose(quat_normalize(q), t, X)
        depth = x_cam[:, 2]
        xy = img_from_cam(model, params, x_cam[:, :2] / depth[:, None])
        rows = np.asarray([pf.row_or(ims[i].name, sources[j][1])
                           for i, j in enumerate(idx)])
        scale = torch.as_tensor(pf.scales[rows])[:, None]     # [p, 1, 2]
        xy_n = xy[:, None] + nodes[None] / scale
        Xn = pixel_to_world(model, params[:, None], q[:, None], t[:, None],
                            xy_n, depth[:, None].expand(-1, len(nodes)))
        out[idx] = (Xn[:, 1:] - Xn[:, :1]).numpy()
    return out
