"""Robust per-track reference descriptors (reference:
pixsfm/bundle_adjustment/src/reference_extractor.h:57-363 +
base/src/irls_optim.h:23-71).

Port of ``pixsfm_tpu/bundle_adjustment/references.py``. For every 3D point:
interpolate each track observation's descriptor at the point's reprojected
location, compute a robust (IRLS) mean over the track, and keep the
observation whose descriptor is closest to that mean.

The descriptor reads go through kernel K1 (``ops/interpolate_cuda.py``),
one query per observation straight from the packed patch rows; the IRLS
runs batched over all points at once on the device. Only the default
single-node BICUBIC config is ported: other modes, node windows and
``compute_offsets3D`` (patch-warp BA) raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import logger
from ..base.interpolation import InterpolationConfig, check_window_config
from ..base.losses import RobustLoss, make_loss
from ..ops.interpolate_cuda import interpolate_rows
from ..util.misc import bucket

__all__ = ["Reference", "extract_references", "robust_mean_irls"]


@dataclass
class Reference:
    """Per-point3D reference (reference: features/src/references.{h,cc})."""
    source: Tuple[int, int]               # (image_id, p2D_idx) of chosen obs
    descriptor: np.ndarray                # [C]
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


def extract_references(reconstruction, feature_set, view, conf,
                       interp: InterpolationConfig,
                       point3D_ids: Optional[Sequence[int]] = None,
                       keep_observations: Optional[bool] = None
                       ) -> Dict[int, Reference]:
    """References for all (or the given) points. ``conf`` is the
    ``references`` config subtree ({loss, iters, keep_observations,
    compute_offsets3D}); everything runs on the device of ``view``'s
    packed patches."""
    t0 = time.time()
    get = conf.get if hasattr(conf, "get") else lambda k, d=None: d
    loss = make_loss(get("loss", {"name": "cauchy", "params": [0.25]}))
    iters = int(get("iters", 100) or 100)
    if keep_observations is None:
        keep_observations = bool(get("keep_observations", False))
    if bool(get("compute_offsets3D", False)):
        raise NotImplementedError(
            "compute_offsets3D (patch-warp BA) is not ported yet; see "
            "ROADMAP.md section 1, 'The other BA strategies'")
    check_window_config(interp)

    pids = list(point3D_ids if point3D_ids is not None
                else sorted(reconstruction.points3D.keys()))
    if not pids:
        return {}
    pf = view.packed

    # flatten all track observations; reprojected locations batched per image
    from ..base.projection import project_np

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

    # descriptor at each reprojection: one K1 query per observation
    dev = pf.patches.device
    B, H, W, C = pf.patches.shape
    pc = ((obs_xy * pf.scales[obs_row] - 0.5 - pf.corners[obs_row])
          * pf.upsampling[obs_row][:, None]).astype(np.float32)
    rows_view = pf.patches.reshape(B * H, W, C)
    row_base = torch.as_tensor(obs_row * H, dtype=torch.int32, device=dev)
    desc, _, _ = interpolate_rows(
        rows_view, H, W, C, row_base,
        torch.as_tensor(pc[:, 1], device=dev),
        torch.as_tensor(pc[:, 0], device=dev), bool(interp.l2_normalize))

    # pad tracks to T (power of two) and run IRLS batched over points
    counts = np.bincount(obs_pt, minlength=len(pids))
    T = bucket(int(counts.max()), minimum=2)
    order = np.argsort(obs_pt, kind="stable")
    sorted_pt = obs_pt[order]
    starts = np.searchsorted(sorted_pt, np.arange(len(pids)), side="left")
    obs_slot = np.empty(len(obs_pt), np.int64)
    obs_slot[order] = np.arange(len(obs_pt)) - starts[sorted_pt]
    flat = torch.as_tensor(obs_pt * T + obs_slot, device=dev)
    track_desc = desc.new_zeros((len(pids) * T, C))
    track_desc[flat] = desc
    track_desc = track_desc.reshape(len(pids), T, C)
    track_valid = torch.zeros(len(pids) * T, dtype=torch.bool, device=dev)
    track_valid[flat] = True
    track_valid = track_valid.reshape(len(pids), T)
    means = robust_mean_irls(track_desc, track_valid, loss, iters,
                             l2_normalize=interp.l2_normalize)

    # per point: the observation closest to the robust mean
    d2 = torch.sum((track_desc - means[:, None, :]) ** 2, dim=2)
    d2 = torch.where(track_valid, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(d2, dim=1).cpu().numpy()
    track_desc = track_desc.cpu().numpy()
    d2 = d2.cpu().numpy()

    track_elems: Dict[Tuple[int, int], Tuple[int, int]] = {
        (int(s), int(t)): e for s, t, e in zip(obs_pt, obs_slot, obs_track)}
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
        refs[pid] = ref
    logger.info("Reference extraction: %.3fs (%d points)",
                time.time() - t0, len(refs))
    return refs
