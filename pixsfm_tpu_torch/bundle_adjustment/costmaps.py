"""Costmap extraction + costmap BA (reference:
pixsfm/bundle_adjustment/src/costmap_extractor.h:39-435 and
costmap_bundle_optimizer.h:17-132).

Port of ``pixsfm_tpu/bundle_adjustment/costmaps.py``. Costmaps shrink the BA
residual from C = 128 channels to 1 and let the feature patches be freed
after extraction (the ``low_memory`` preset). Per observation the cost patch
stores ``(cost, dcost/dr, dcost/dc[, d2cost/drdc])`` with ``cost = 0.5 *
rho(||f - ref||^2)`` over the feature patch, the derivatives from central
differences of the (optionally L2-normalized) feature channels dotted with
the residual. Costmap BA then runs the Schur LM of ``ops/schur.py`` with a
1-D gradient-field residual (``POLYGRADIENTFIELD``, or
``BICUBICGRADIENTFIELD`` with the cross derivative; no normalization).

The extraction runs on the device of the feature patches in chunks of
observations bounded by ``_CHUNK_BYTES`` of float32 temporaries (done
whole, one ``[O, ps, ps, C]`` float32 temporary of a 240 000-observation
scene is 7.9 GB). The host bookkeeping is vectorised over observations and
keeps the JAX package's order: points in packed order, each track in order,
one map per image in the order of first appearance. ``rho''`` of the cross
derivative is the loss's closed form (``RobustLoss.weight_derivative``),
where the JAX package takes a ``jax.jvp`` of the weight. The upsampled
variant reads the feature patches at ``1/up`` steps through kernel K1
(``ops/interpolate_cuda.interpolate_rows``).
"""

from __future__ import annotations

import time
from itertools import chain
from typing import Dict, Tuple

import numpy as np
import torch

from .. import logger
from ..base.interpolation import InterpolationConfig
from ..base.losses import RobustLoss, make_loss
from ..features.featuremaps import FeatureMap, FeatureSet, FeatureView
from ..ops.interpolate_cuda import interpolate_rows
from .references import extract_references

__all__ = ["extract_costmaps", "costmap_ba", "costmap_solve",
           "costmap_patches"]

# bytes of float32 temporaries one extraction chunk may hold
_CHUNK_BYTES = 1 << 30


def _shifted(n: int, d: int, device):
    """Indices ``i + d`` clamped into ``[0, n)`` (edge padding)."""
    return torch.clamp(torch.arange(n, device=device) + d, 0, n - 1)


def _costmap_kernel(patches, refs, loss: RobustLoss, l2_normalize: bool,
                    compute_cross: bool):
    """patches ``[n, ps, ps, C]`` (storage dtype), refs ``[n, C]`` ->
    ``[n, ps, ps, 3|4]`` float32 (``costmaps.py:39`` of the JAX package:
    central differences with edge clamping)."""
    f = patches.to(torch.float32)
    if l2_normalize:
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                            min=1e-20)
    ps_r, ps_c = f.shape[1], f.shape[2]
    up_r, dn_r = _shifted(ps_r, 1, f.device), _shifted(ps_r, -1, f.device)
    up_c, dn_c = _shifted(ps_c, 1, f.device), _shifted(ps_c, -1, f.device)
    dfdr = 0.5 * (f[:, up_r] - f[:, dn_r])
    dfdc = 0.5 * (f[:, :, up_c] - f[:, :, dn_c])
    res = f - refs[:, None, None, :]
    del f
    s = torch.sum(res * res, dim=-1)
    cost = 0.5 * loss(s)
    w = loss.weight(s)
    rdotr = torch.sum(res * dfdr, dim=-1)
    rdotc = torch.sum(res * dfdc, dim=-1)
    small = cost <= 1e-8
    zero = torch.zeros_like(cost)
    chans = [cost, torch.where(small, zero, w * rdotr),
             torch.where(small, zero, w * rdotc)]
    if compute_cross:
        # d2cost/drdc = rho''(s) 2 (res.f_c)(res.f_r)
        #             + rho'(s) (f_r.f_c + res.f_rc)
        f_rc = 0.5 * (dfdr[:, :, up_c] - dfdr[:, :, dn_c])
        dcostdrc = (loss.weight_derivative(s) * 2.0 * rdotc * rdotr
                    + w * (torch.sum(dfdr * dfdc, dim=-1)
                           + torch.sum(res * f_rc, dim=-1)))
        chans.append(torch.where(small, zero, dcostdrc))
    return torch.stack(chans, dim=-1)


def _costmap_kernel_upsampled(patches, refs, loss: RobustLoss,
                              l2_normalize: bool, up: int):
    """The cost patch sampled at ``1/up`` pixel steps (``costmaps.py:85``
    of the JAX package): bicubic values and derivatives of the feature
    patch at those points, read through K1, ``dcost/dr = rho' (res .
    dfdr)``. patches ``[n, ps, ps, C]``, refs ``[n, C]`` -> ``[n, ps*up,
    ps*up, 3]`` float32."""
    n, ps, _, C = patches.shape
    out = ps * up
    dev = patches.device
    g = torch.arange(out, dtype=torch.float32, device=dev) / up
    Q = out * out
    r = g[:, None].expand(out, out).reshape(1, Q).expand(n, Q).reshape(-1)
    c = g[None, :].expand(out, out).reshape(1, Q).expand(n, Q).reshape(-1)
    row_base = torch.arange(n, device=dev, dtype=torch.int32).mul_(ps) \
        .repeat_interleave(Q)
    f, dfdr, dfdc = interpolate_rows(patches.contiguous().reshape(n * ps,
                                                                  ps, C),
                                     ps, ps, C, row_base, r, c,
                                     bool(l2_normalize))
    res = f.reshape(n, Q, C) - refs[:, None, :]
    s = torch.sum(res * res, dim=-1)
    cost = 0.5 * loss(s)
    w = loss.weight(s)
    small = cost <= 1e-8
    zero = torch.zeros_like(cost)
    dr = torch.where(small, zero,
                     w * torch.sum(res * dfdr.reshape(n, Q, C), dim=-1))
    dc = torch.where(small, zero,
                     w * torch.sum(res * dfdc.reshape(n, Q, C), dim=-1))
    return torch.stack([cost, dr, dc], dim=-1).reshape(n, out, out, 3)


def costmap_patches(patches, rows, targets, loss: RobustLoss,
                    l2_normalize: bool, compute_cross: bool = False,
                    up: int = 1):
    """Cost patches ``[O, ps*up, ps*up, 3|4]`` float32 of the observations
    whose feature patches are ``patches[rows]`` (``patches [B, ps, ps, C]``
    in the storage dtype, ``rows [O]``, ``targets [O, C]``, all on one
    device), computed in chunks of at most ``_CHUNK_BYTES`` of float32
    temporaries."""
    _, ps, _, C = patches.shape
    dev = patches.device
    O = int(rows.shape[0])
    out_c = 4 if (compute_cross and up == 1) else 3
    out = torch.empty((O, ps * up, ps * up, out_c), dtype=torch.float32,
                      device=dev)
    if up == 1:   # f, its two differences, res, the products, f_rc
        per_obs = 8 * ps * ps * C * 4
    else:         # per query: f, dfdr, dfdc, res, the products and the
        # plain version's [4, ps, C] window
        per_obs = (ps * up) ** 2 * C * 4 * (6 + 4 * ps)
    n = max(1, _CHUNK_BYTES // per_obs)
    for s in range(0, O, n):
        e = min(s + n, O)
        p = patches.index_select(0, rows[s:e])
        if up > 1:
            out[s:e] = _costmap_kernel_upsampled(p, targets[s:e], loss,
                                                 l2_normalize, up)
        else:
            out[s:e] = _costmap_kernel(p, targets[s:e], loss, l2_normalize,
                                       compute_cross)
    return out


def _by_image(image_ids):
    """``[(image id, observation indices)]`` in the order of each image's
    first observation, the indices in order."""
    uniq, first, inv = np.unique(image_ids, return_index=True,
                                 return_inverse=True)
    order = np.argsort(inv, kind="stable")
    groups = np.split(order, np.cumsum(np.bincount(
        inv, minlength=len(uniq)))[:-1])
    return [(int(uniq[k]), groups[k]) for k in np.argsort(first)]


def _rows_by_image(pf, names, image_ids, p2D_idxs) -> np.ndarray:
    """Packed rows of observations ``(image_ids[i], p2D_idxs[i])``, -1
    where an observation has no packed patch (one lookup per image)."""
    rows = np.full(len(image_ids), -1, np.int64)
    for iid, idx in _by_image(image_ids):
        rows[idx] = pf.rows_or_for_image(names[iid], p2D_idxs[idx])
    return rows


def extract_costmaps(reconstruction, feature_set: FeatureSet, conf,
                     references_conf, interp: InterpolationConfig,
                     point3D_ids=None) -> Tuple[FeatureSet, Dict, Dict]:
    """A costmap :class:`FeatureSet` (one float32 cost patch per
    observation, on the device of ``feature_set``), the references used,
    extracted inline as in the reference (costmap_extractor.h:186-189),
    and the seconds of the ``references`` and of the ``costmaps``
    proper."""
    t0 = time.time()
    get = conf.get if hasattr(conf, "get") else lambda k, d=None: d
    loss = make_loss(get("loss", {"name": "cauchy", "params": [0.25]}))
    compute_cross = bool(get("compute_cross_derivative", False))

    packed_ids = (sorted(reconstruction.points3D.keys())
                  if point3D_ids is None else list(point3D_ids))
    view = FeatureView.from_reconstruction(feature_set, reconstruction,
                                           packed_ids)
    refs = extract_references(reconstruction, feature_set, view,
                              references_conf, interp,
                              point3D_ids=packed_ids)
    t_refs = time.time() - t0

    # observations: points in packed order (those with a reference), each
    # track in order; one whose patch was never extracted is skipped
    pf = view.packed
    pts = [pid for pid in packed_ids if pid in refs]
    tracks = [reconstruction.points3D[pid].track for pid in pts]
    lens = np.fromiter(map(len, tracks), np.int64, len(tracks))
    el = np.fromiter(chain.from_iterable(chain.from_iterable(tracks)),
                     np.int64, 2 * int(lens.sum())).reshape(-1, 2)
    obs_pt = np.repeat(np.arange(len(pts)), lens)
    names = {iid: im.name for iid, im in reconstruction.images.items()}
    rows = _rows_by_image(pf, names, el[:, 0], el[:, 1])
    keep = rows >= 0
    el, obs_pt, rows = el[keep], obs_pt[keep], rows[keep]
    if not len(rows):
        return (FeatureSet(3, feature_set.patch_size, "float32"), refs,
                dict(references=t_refs, costmaps=0.0))

    dev = pf.patches.device
    desc = torch.as_tensor(np.stack([refs[pid].descriptor for pid in pts]),
                           dtype=torch.float32, device=dev)
    up = int(get("upsampling_factor", 1) or 1)
    cost = costmap_patches(
        pf.patches, torch.as_tensor(rows, device=dev),
        desc[torch.as_tensor(obs_pt, device=dev)], loss,
        bool(interp.l2_normalize), compute_cross, up)

    cset = FeatureSet(int(cost.shape[-1]), feature_set.patch_size * up,
                      "float32")
    for iid, idx in _by_image(el[:, 0]):
        r = rows[idx]
        cset.emplace(names[iid], FeatureMap(
            cost.index_select(0, torch.as_tensor(idx, device=dev)),
            el[idx, 1].tolist(), pf.corners[r], pf.scales[r[0]],
            upsampling_factor=float(pf.upsampling[r[0]]) * up))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings = dict(references=t_refs, costmaps=time.time() - t0 - t_refs)
    logger.info("Costmap extraction: %.3fs (%d patches)", time.time() - t0,
                len(rows))
    return cset, refs, timings


def _required_from_packed(reconstruction, packed) -> Dict[str, list]:
    """``{image name: [p2D_idx, ...]}`` of the packed observations, in
    their order."""
    return {reconstruction.images[iid].name:
            packed.obs_p2D_idx[idx].tolist()
            for iid, idx in _by_image(packed.obs_image_id)}


def costmap_ba(adjuster, reconstruction, feature_set: FeatureSet,
               problem_setup=None) -> Dict:
    """Costmap BA strategy driver (reference: ba/main.py:243-286): extract
    the costmaps, then :func:`costmap_solve`; the summary adds
    ``references_time`` and ``costmap_time`` (seconds)."""
    conf = adjuster.conf
    cset, _, timings = extract_costmaps(
        reconstruction, feature_set, conf.get("costmaps", {}),
        conf.references,
        InterpolationConfig.from_conf(conf.get("interpolation")))
    out = costmap_solve(adjuster, reconstruction, cset, problem_setup)
    out["references_time"] = timings["references"]
    out["costmap_time"] = timings["costmaps"]
    return out


def costmap_solve(adjuster, reconstruction, cset: FeatureSet,
                  problem_setup=None) -> Dict:
    """The Schur LM of ``adjuster`` over the cost patches ``cset`` of
    :func:`extract_costmaps`, on ``adjuster.device``."""
    from .main import _CostPatches

    packed, model, mi = adjuster._pack(reconstruction, problem_setup)
    loss = make_loss(adjuster.conf.optimizer.get("loss"))
    # costmap interpolation: gradient field, no normalization
    interp_cm = InterpolationConfig(
        mode="BICUBICGRADIENTFIELD" if cset.channels == 4
        else "POLYGRADIENTFIELD", l2_normalize=False)

    # an observation without a cost patch gets weight 0 (an image none of
    # whose observations has one holds no map)
    required = {name: ids for name, ids in
                _required_from_packed(reconstruction, packed).items()
                if name in cset.maps}
    pf = FeatureView(cset, required).packed
    names = {iid: im.name for iid, im in reconstruction.images.items()}
    rows = _rows_by_image(pf, names, packed.obs_image_id,
                          packed.obs_p2D_idx)
    obs_valid = rows >= 0
    rows = np.where(obs_valid, rows, 0)
    return adjuster._run_ba_cached(
        reconstruction, packed, ("costmap", model, interp_cm),
        (rows,) if mi is None else (rows, mi),
        _CostPatches(pf, adjuster.device), loss, adjuster._ba_options(),
        obs_valid=obs_valid)
