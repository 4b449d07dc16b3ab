"""Multi-view triangulation with known poses (the hloc triangulation flow).

Port of ``pixsfm_tpu/sfm/triangulation.py``. Tracks come from the match
graph (``compute_track_labels``, maximum-similarity spanning forest); each
track is triangulated by the DLT, the smallest right singular vector of its
stacked ``[2T, 4]`` projection constraints, all tracks in one batched
``torch.linalg.svd`` on the device; observations are then accepted on the
host in numpy by reprojection error, triangulation angle and track length,
the acceptance rules of COLMAP's triangulator.

The JAX package pads the track length ``T`` to a power of two (a recompile
bucket); eager torch needs none, and zero constraint rows leave the
smallest right singular vector unchanged, so the port pads each track only
to the longest one of the batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import logger, resolve_device
from ..base.cameras import cam_from_img
from ..base.graph import Graph, compute_track_labels
from ..base.projection import reproj_errors_np
from .model import Image, Point3D, Reconstruction

__all__ = ["triangulate_tracks", "triangulate_reconstruction"]


def triangulate_batch(A: torch.Tensor) -> torch.Tensor:
    """DLT of a batch of constraint stacks ``A [N, R, 4]`` (zero rows for
    missing observations): the smallest right singular vector of each,
    dehomogenized with ``|w|`` kept from 0 (``1e-12``). Returns ``[N, 3]``
    in ``A``'s dtype and device."""
    if A.shape[1] < 4:     # fewer rows than unknowns: Vh would lose a row
        A = torch.cat([A, A.new_zeros((A.shape[0], 4 - A.shape[1], 4))], 1)
    X = torch.linalg.svd(A, full_matrices=False)[2][:, -1]
    w = X[:, 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[:, :3] / w[:, None]


def triangulate_tracks(
        reconstruction: Reconstruction,
        graph: Graph,
        keypoints: Dict[str, np.ndarray],
        track_labels: Optional[np.ndarray] = None,
        max_reproj_error: float = 4.0,
        min_tri_angle_deg: float = 1.5,
        min_track_length: int = 2,
        device=None) -> Reconstruction:
    """Triangulate all graph tracks into ``reconstruction`` (poses must be
    set). The undistortion and the DLT run on ``device`` (``cuda`` unless
    ``"cpu"`` is passed) in float32, as the JAX package's do.

    Observations failing the reprojection-error test are dropped; tracks
    with fewer than ``min_track_length`` surviving observations or a too
    small maximum triangulation angle are rejected."""
    dev = resolve_device(device)
    if graph.num_nodes == 0:
        return reconstruction
    if track_labels is None:
        track_labels = compute_track_labels(graph)
    image_ids_arr, feature_idxs = graph.nodes_array()
    image_ids_arr = np.asarray(image_ids_arr, np.int64)
    feature_idxs = np.asarray(feature_idxs, np.int64)
    labels = np.asarray(track_labels, np.int64)
    name_to_image = {im.name: im for im in reconstruction.images.values()}

    # the graph's images in the reconstruction that have keypoints: camera-
    # plane keypoints (one device call per image), [R | t], centers
    names = [graph.image_id_to_name[g] for g in range(len(
        graph.image_id_to_name))]
    usable = np.array([n in name_to_image and n in keypoints
                       and len(keypoints[n]) > 0 for n in names], bool)
    P = np.zeros((len(names), 3, 4))
    centers = np.zeros((len(names), 3))
    uv_of: Dict[int, np.ndarray] = {}
    for g, name in enumerate(names):
        if not usable[g]:
            continue
        im = name_to_image[name]
        cam = reconstruction.cameras[im.camera_id]
        P[g] = np.hstack([im.rotation_matrix(), im.tvec[:, None]])
        centers[g] = im.projection_center()
        uv_of[g] = cam_from_img(
            cam.model, torch.as_tensor(cam.params, dtype=torch.float32,
                                       device=dev),
            torch.as_tensor(np.asarray(keypoints[name]), dtype=torch.float32,
                            device=dev)).cpu().numpy().astype(np.float64)

    # tracks in label order, nodes in id order within each (the order of
    # the JAX package's per-track lists); tracks shorter than
    # min_track_length are not triangulated
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    kept = np.nonzero(sizes >= min_track_length)[0]
    N = len(kept)
    if N == 0:
        logger.info("Triangulated 0 / 0 tracks.")
        return reconstruction
    T = int(sizes[kept].max())
    rank = np.arange(len(order)) - starts[labels[order]]
    sel = sizes[labels[order]] >= min_track_length
    nodes = order[sel]                               # node ids, track-major
    track_of = np.searchsorted(kept, labels[nodes])  # [n] track index
    k_of = rank[sel]                                 # [n] rank in track
    img_g = image_ids_arr[nodes]
    valid_n = usable[img_g]
    uv = np.zeros((len(nodes), 2))
    for g in np.unique(img_g[valid_n]):
        m = valid_n & (img_g == g)
        uv[m] = uv_of[g][feature_idxs[nodes[m]]]
    Pn = P[img_g]               # [n, 3, 4]; zero rows where not usable
    rows = np.zeros((N, T, 2, 4))
    rows[track_of, k_of, 0] = uv[:, 0:1] * Pn[:, 2] - Pn[:, 0]
    rows[track_of, k_of, 1] = uv[:, 1:2] * Pn[:, 2] - Pn[:, 1]

    X = triangulate_batch(torch.as_tensor(
        rows.reshape(N, 2 * T, 4), dtype=torch.float32, device=dev)
    ).cpu().numpy().astype(np.float64)

    # acceptance on the host: reprojection error per observation (one numpy
    # call per image), then track length and the largest pairwise angle
    finite = np.isfinite(X).all(1)
    err = np.full(len(nodes), np.inf)
    cand = valid_n & finite[track_of]
    for g in np.unique(img_g[cand]):
        m = cand & (img_g == g)
        im = name_to_image[names[g]]
        cam = reconstruction.cameras[im.camera_id]
        err[m] = reproj_errors_np(
            cam, im.qvec, im.tvec, X[track_of[m]],
            np.asarray(keypoints[names[g]])[feature_idxs[nodes[m]]])
    ok = cand & ~(err > max_reproj_error)
    n_ok = np.bincount(track_of[ok], minlength=N)
    # largest angle = arccos of the smallest cosine over the track's pairs
    d = X[track_of[ok]] - centers[img_g[ok]]
    dirs = np.zeros((N, T, 3))
    mask = np.zeros((N, T), bool)
    mask[track_of[ok], k_of[ok]] = True
    with np.errstate(invalid="ignore", divide="ignore"):
        dirs[track_of[ok], k_of[ok]] = d / np.linalg.norm(d, axis=1,
                                                          keepdims=True)
        cos = np.clip(np.einsum("nad,nbd->nab", dirs, dirs), -1, 1)
        cos = np.where(mask[:, :, None] & mask[:, None, :], cos, 1.0)
        max_angle = np.arccos(np.min(cos.reshape(N, -1), axis=1))
    accept = finite & (n_ok >= min_track_length) \
        & ~(max_angle < np.deg2rad(min_tri_angle_deg))

    next_pid = (max(reconstruction.points3D.keys()) + 1
                if reconstruction.points3D else 0)
    obs_of = np.split(np.nonzero(ok)[0],
                      np.searchsorted(track_of[ok], np.arange(1, N)))
    for ti in np.nonzero(accept)[0]:
        pid = next_pid
        next_pid += 1
        track = [(name_to_image[names[img_g[j]]].image_id,
                  int(feature_idxs[nodes[j]])) for j in obs_of[ti]]
        reconstruction.add_point3D(Point3D(pid, X[ti], track=track))
        for iid, p2D_idx in track:
            im = reconstruction.images[iid]
            if p2D_idx >= len(im.point3D_ids):
                pad = p2D_idx + 1 - len(im.point3D_ids)
                im.point3D_ids = np.concatenate(
                    [im.point3D_ids, np.full(pad, -1, np.int64)])
                im.xys = np.vstack([im.xys, np.zeros((pad, 2))])
            im.point3D_ids[p2D_idx] = pid
            im.xys[p2D_idx] = keypoints[im.name][p2D_idx]
    logger.info("Triangulated %d / %d tracks.", int(accept.sum()), N)
    return reconstruction


def triangulate_reconstruction(
        reference_model: Reconstruction,
        graph: Graph,
        keypoints: Dict[str, np.ndarray],
        device=None,
        **kwargs) -> Reconstruction:
    """Fresh reconstruction with poses/cameras from ``reference_model`` and
    points triangulated from the match graph (the hloc triangulation flow
    with known poses). ``device``: as for :func:`triangulate_tracks`."""
    dev = resolve_device(device)
    rec = Reconstruction()
    for cam in reference_model.cameras.values():
        rec.add_camera(cam)
    for im in reference_model.images.values():
        new = Image(im.image_id, im.name, im.camera_id, im.qvec.copy(),
                    im.tvec.copy())
        kps = keypoints.get(im.name)
        if kps is not None:
            new.xys = np.asarray(kps, np.float64).copy()
            new.point3D_ids = np.full(len(kps), -1, np.int64)
        rec.add_image(new)
    return triangulate_tracks(rec, graph, keypoints, device=dev, **kwargs)
