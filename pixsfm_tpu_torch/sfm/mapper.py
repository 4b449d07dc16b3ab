"""Lite incremental Structure-from-Motion mapper.

Port of ``pixsfm_tpu/sfm/mapper.py``. The reference shells out to COLMAP's
incremental mapper via hloc (``hloc.reconstruction.main``; reference
refine_hloc.py:94-115); this compact standalone mapper drives the
KA -> SfM -> BA pipeline end to end:

1. Bougnoux focal seeds from pairwise fundamental matrices (unknown
   intrinsics), then the initial pair: most matches with enough parallax,
   the relative pose from the normalized 8-point essential matrix or a
   calibrated homography (planar scenes), swept over focal factors;
2. incremental registration: next image by 2D-3D correspondence count, PnP
   (``localization/pnp.py``, RANSAC + LO on the device), retriangulation of
   the tracks (``sfm/triangulation.py``, DLT on the device), global
   geometric BA (the LM of ``ops/schur.py``, on the device), a rescue pass
   for stragglers and a re-registration sweep against the final structure;
3. up to ``n_restarts`` further attempts from the next-ranked initial
   pairs; the best-scoring map wins.

The host drives the loop in numpy, as in the JAX package; the numpy helpers
of the two-view initialization are copies, so both packages draw the same
RANSAC samples. ``device`` (``cuda`` unless ``"cpu"`` is passed) is where
PnP, the triangulation and the BA run. The rays of the initial pair are
undistorted in float32, as the JAX package's ``Camera.cam_from_img``
computes them; the second image's rotation of the initial pair becomes a
quaternion in float64 (the JAX package rounds it through float32).
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import PIL.Image

from .. import logger, resolve_device
from ..base.cameras import Camera
from ..base.geometry import rotmat_to_quat_np
from ..base.graph import Graph, compute_track_labels
from .model import Image, Reconstruction
from .triangulation import triangulate_tracks

__all__ = ["incremental_mapping", "mapper_ba_conf"]


def _fit_E(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    A = np.einsum("ni,nj->nij", x2, x1).reshape(len(x1), 9)
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(E)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt2


def _sampson(E, x1, x2):
    Ex1 = x1 @ E.T
    Etx2 = x2 @ E
    num = np.einsum("ni,ni->n", x2, Ex1) ** 2
    den = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2
           + Etx2[:, 1] ** 2)
    return num / np.maximum(den, 1e-18)


def _essential_from_matches(uv1: np.ndarray, uv2: np.ndarray,
                            iters: int = 1000, thresh: float = 2e-3,
                            seed: int = 0):
    """LO-RANSAC normalized 8-point E; returns (R, t, inliers) with
    x2 ~ R x1 + t (world = camera 1)."""
    n = len(uv1)
    if n < 8:
        return None
    x1 = np.hstack([uv1, np.ones((n, 1))])
    x2 = np.hstack([uv2, np.ones((n, 1))])
    rng = np.random.default_rng(seed)
    best = (0, None, None)
    t2 = thresh ** 2
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        E = _fit_E(x1[idx], x2[idx])
        inl = _sampson(E, x1, x2) < t2
        if inl.sum() > best[0]:
            # local optimization: refit on inliers until stable
            for _ in range(3):
                if inl.sum() < 8:
                    break
                E = _fit_E(x1[inl], x2[inl])
                new_inl = _sampson(E, x1, x2) < t2
                if new_inl.sum() <= inl.sum():
                    break
                inl = new_inl
            if inl.sum() > best[0]:
                best = (int(inl.sum()), E, inl)
    if best[1] is None or best[0] < 12:
        return None
    E, inl = best[1], best[2]

    # decompose: 4 candidates, pick by cheirality on inliers
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            cands.append((R, t))

    scored = [(_count_front(uv1, uv2, R, t, inl), R, t) for R, t in cands]
    front, R, t = max(scored, key=lambda s: s[0])
    return R, t, inl, front


def _count_front(uv1, uv2, R, t, inl, max_pts: int = 50) -> int:
    """Triangulate a subset of inliers and count positive depths in both
    views (cheirality scoring for two-view pose candidates)."""
    sel = np.nonzero(inl)[0][:max_pts]
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t[:, None]])
    good = 0
    for i in sel:
        A = np.stack([
            uv1[i, 0] * P1[2] - P1[0], uv1[i, 1] * P1[2] - P1[1],
            uv2[i, 0] * P2[2] - P2[0], uv2[i, 1] * P2[2] - P2[1]])
        _, _, Vt3 = np.linalg.svd(A)
        X = Vt3[-1]
        X = X[:3] / X[3] if abs(X[3]) > 1e-12 else X[:3]
        z1 = X[2]
        z2 = (R @ X + t)[2]
        good += int(z1 > 0 and z2 > 0)
    return good


def _homography_pose_from_matches(uv1: np.ndarray, uv2: np.ndarray,
                                  iters: int = 500, thresh: float = 2e-3,
                                  seed: int = 0):
    """Two-view pose from a calibrated homography (planar scenes, where the
    8-point E is degenerate — COLMAP similarly selects H vs E/F by support).

    RANSAC 4-point homography on normalized coords, then the Faugeras SVD
    decomposition H ~ R + t n^T/d (4 sign solutions), cheirality-scored.
    Returns (R, t, inliers, n_front) or None.
    """
    n = len(uv1)
    if n < 8:
        return None
    rng = np.random.default_rng(seed)
    x1 = np.hstack([uv1, np.ones((n, 1))])
    best = (0, None, None)

    def fit_H(i1, i2):
        m = len(i1)
        A = np.zeros((2 * m, 9))
        A[0::2, 0:3] = i1
        A[0::2, 6:9] = -i2[:, 0:1] * i1
        A[1::2, 3:6] = i1
        A[1::2, 6:9] = -i2[:, 1:2] * i1
        _, _, Vt = np.linalg.svd(A)
        return Vt[-1].reshape(3, 3)

    def transfer_err(H):
        p = x1 @ H.T
        p = p[:, :2] / np.where(np.abs(p[:, 2:]) < 1e-12, 1e-12, p[:, 2:])
        return np.sum((p - uv2) ** 2, axis=1)

    t2 = thresh ** 2
    for _ in range(iters):
        idx = rng.choice(n, 4, replace=False)
        H = fit_H(x1[idx], uv2[idx])
        inl = transfer_err(H) < t2
        if inl.sum() > best[0]:
            for _ in range(3):
                if inl.sum() < 4:
                    break
                H = fit_H(x1[inl], uv2[inl])
                new = transfer_err(H) < t2
                if new.sum() <= inl.sum():
                    break
                inl = new
            if inl.sum() > best[0]:
                best = (int(inl.sum()), H, inl)
    if best[1] is None or best[0] < 12:
        return None
    H, inl = best[1], best[2]

    # Faugeras decomposition
    U, S, Vt = np.linalg.svd(H)
    l1, l2, l3 = S / max(S[1], 1e-12)
    if l1 - l3 < 1e-6:       # pure rotation / no parallax
        return None
    s = np.linalg.det(U) * np.linalg.det(Vt)
    x1c = np.sqrt(max((l1 * l1 - 1.0), 0.0) / (l1 * l1 - l3 * l3))
    x3c = np.sqrt(max((1.0 - l3 * l3), 0.0) / (l1 * l1 - l3 * l3))
    sin_t = (l1 - l3) * x1c * x3c
    cos_t = l1 * x3c * x3c + l3 * x1c * x1c
    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = np.array([[cos_t, 0, -st], [0, 1, 0], [st, 0, cos_t]])
            tp = (l1 - l3) * np.array([e1 * x1c, 0.0, -e3 * x3c])
            R = s * U @ Rp @ Vt
            t = U @ tp
            nt = np.linalg.norm(t)
            if nt < 1e-9:
                continue
            t = t / nt
            cands.append((R, t))
            cands.append((R, -t))
    if not cands:
        return None
    scored = [(_count_front(uv1, uv2, R, t, inl), R, t) for R, t in cands]
    front, R, t = max(scored, key=lambda c: c[0])
    return R, t, inl, front


def _image_sizes(names, image_dir) -> Dict[str, Tuple[int, int]]:
    """(width, height) per image: from the file in ``image_dir``, or from the
    array of a mapping ``{name: [H, W, 3] array}`` of decoded images;
    1600 x 1200 when the image is absent."""
    sizes = {}
    for name in names:
        if isinstance(image_dir, Mapping):
            arr = image_dir.get(name)
            sizes[name] = ((arr.shape[1], arr.shape[0]) if arr is not None
                           else (1600, 1200))
            continue
        p = Path(image_dir) / name
        if p.exists():
            with PIL.Image.open(p) as im:
                sizes[name] = im.size
        else:
            sizes[name] = (1600, 1200)
    return sizes


def _default_params(camera_model: str, w: int, h: int):
    f0 = 1.2 * max(w, h)  # COLMAP's default focal prior
    return {"SIMPLE_PINHOLE": [f0, w / 2, h / 2],
            "SIMPLE_RADIAL": [f0, w / 2, h / 2, 0.0],
            "PINHOLE": [f0, f0, w / 2, h / 2],
            "RADIAL": [f0, w / 2, h / 2, 0.0, 0.0]}[camera_model]


def mapper_ba_conf(known_intrinsics: bool) -> Dict:
    """The geometric BA the mapper runs after registrations: a robust loss
    (COLMAP's mapper BAs use a robust kernel; with a trivial loss one weak
    registration's residual tail bends the whole map before retriangulation
    can filter it), 25 LM iterations, intrinsics refined when unknown."""
    return {"optimizer": {"loss": {"name": "cauchy", "params": [1.0]},
                          "solver": {"max_num_iterations": 25,
                                     "use_inner_iterations": False},
                          "refine_principal_point": False,
                          "refine_focal_length": not known_intrinsics,
                          "refine_extra_params": not known_intrinsics}}


class _Stats:
    """Counters and host wall times of one mapping run (``stats``)."""

    KEYS = ("attempts", "registrations", "pnp_calls", "ba_calls",
            "triangulations", "pnp_time", "ba_time", "triangulation_time")

    def __init__(self, out: Optional[Dict]):
        self.out = {} if out is None else out
        for k in self.KEYS:
            self.out.setdefault(k, 0)

    def timed(self, key: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        self.out[f"{key}_time"] += time.perf_counter() - t0
        self.out[{"pnp": "pnp_calls", "ba": "ba_calls",
                  "triangulation": "triangulations"}[key]] += 1
        return res


def incremental_mapping(graph: Graph, keypoints: Dict[str, np.ndarray],
                        image_dir, camera_model: str = "SIMPLE_RADIAL",
                        shared_camera: bool = False,
                        max_reproj_error: float = 4.0,
                        ba_every: int = 1,
                        cameras: Optional[Dict[str, Camera]] = None,
                        min_reg_inliers: int = 30,
                        n_restarts: int = 2,
                        device=None,
                        stats: Optional[Dict] = None,
                        _attempt: Optional[Tuple[int, int]] = None
                        ) -> Reconstruction:
    """Incremental SfM from a match graph and keypoints (COLMAP
    coordinates); ``image_dir`` (a directory or a mapping of decoded
    images) gives the image sizes.

    ``cameras``: optional known per-image intrinsics; when absent,
    intrinsics start from a focal prior (Bougnoux seeds where pairs allow)
    and are refined by focal sweeps and BA. ``min_reg_inliers``: the
    registration bar (COLMAP's abs_pose_min_num_inliers=30); images below
    it are deferred and only taken in a final rescue pass at 6 inliers.
    ``n_restarts``: extra attempts from the next-ranked initial pairs when
    the first map is not clean (every image registered and a mean
    reprojection error <= 0.6 px); the best map wins (registered images,
    then observations, then mean reprojection error). ``device``: where
    PnP, triangulation and BA run (``cuda`` unless ``"cpu"`` is passed).
    ``stats``: a dict filled with the run's counts (attempts,
    registrations, PnP, BA and triangulation calls), the host wall time of
    each of the last three, each attempt's initial pair (``init_pairs``)
    and the attempt whose map won (``best_attempt``)."""
    from ..bundle_adjustment import GeometricBundleAdjuster
    from ..localization.pnp import (absolute_pose_estimation,
                                    _reproj_errors as _reproj_errors_cam)
    from ..localization.pnp import _cam_from_img32

    dev = resolve_device(device)
    st = _Stats(stats)
    if _attempt is None and n_restarts > 0:
        best_rec, best_key = None, None
        for k in range(n_restarts + 1):
            r = incremental_mapping(
                graph, keypoints, image_dir, camera_model=camera_model,
                shared_camera=shared_camera,
                max_reproj_error=max_reproj_error, ba_every=ba_every,
                cameras=cameras, min_reg_inliers=min_reg_inliers,
                n_restarts=n_restarts, device=dev, stats=st.out,
                _attempt=(k, k))
            n_reg = r.num_reg_images
            n_obs = sum(len(p.track) for p in r.points3D.values())
            err = r.mean_reprojection_error() if r.points3D else 99.0
            logger.info("mapper: attempt %d -> %d registered, %d obs, "
                        "%.3f px mean reproj", k, n_reg, n_obs, err)
            key = (n_reg, n_obs, -err)
            if best_key is None or key > best_key:
                best_rec, best_key = r, key
                st.out["best_attempt"] = k
            if n_reg == len(keypoints) and err <= 0.6:
                break
        return best_rec
    att_rank, att_seed = _attempt if _attempt is not None else (0, 0)
    st.out["attempts"] += 1
    if _attempt is None:
        st.out["best_attempt"] = 0

    names = sorted(keypoints.keys())
    sizes = _image_sizes(names, image_dir)
    rec = Reconstruction()
    known_intrinsics = cameras is not None

    # one camera per image (internet-photo default) unless shared_camera
    name_to_id = {}
    cam_of: Dict[str, Camera] = {}
    for i, name in enumerate(names):
        iid = i + 1
        name_to_id[name] = iid
        w, h = sizes[name]
        if known_intrinsics and name in cameras:
            src_cam = cameras[name]
            cam_id = src_cam.camera_id if src_cam.camera_id > 0 else iid
            if cam_id not in rec.cameras:
                rec.add_camera(Camera(cam_id, src_cam.model, src_cam.width,
                                      src_cam.height, src_cam.params.copy()))
        elif shared_camera:
            cam_id = 1
            if cam_id not in rec.cameras:
                rec.add_camera(Camera(
                    cam_id, camera_model, w, h,
                    np.asarray(_default_params(camera_model, w, h),
                               np.float64)))
        else:
            cam_id = iid
            rec.add_camera(Camera(
                cam_id, camera_model, w, h,
                np.asarray(_default_params(camera_model, w, h), np.float64)))
        cam_of[name] = rec.cameras[cam_id]
        im = Image(iid, name, cam_id, registered=False)
        im.xys = np.asarray(keypoints[name], np.float64).copy()
        im.point3D_ids = np.full(len(im.xys), -1, np.int64)
        rec.add_image(im)

    # pairwise match counts from the graph
    src, dst, _ = graph.edges_array()
    image_ids_arr, feature_idxs = graph.nodes_array()
    pair_matches: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
    for e in range(graph.num_edges):
        n1, n2 = int(src[e]), int(dst[e])
        name1 = graph.image_id_to_name[int(image_ids_arr[n1])]
        name2 = graph.image_id_to_name[int(image_ids_arr[n2])]
        if name1 == name2:
            continue
        key = (name1, name2) if name1 < name2 else (name2, name1)
        m = ((int(feature_idxs[n1]), int(feature_idxs[n2]))
             if name1 < name2 else (int(feature_idxs[n2]),
                                    int(feature_idxs[n1])))
        pair_matches.setdefault(key, []).append(m)

    if not pair_matches:
        logger.warning("mapper: no pairwise matches; nothing to reconstruct")
        return rec

    # --- Bougnoux two-view self-calibration: seed each camera with the
    # median of its pairwise focal estimates
    seeded: set = set()
    if not known_intrinsics:
        from .two_view import estimate_pair_focal
        est_by_cam: Dict[int, Tuple[Camera, List[float], List[str]]] = {}
        pairs_by_size = sorted(pair_matches.items(), key=lambda kv: -len(kv[1]))
        for (na_, nb_), ms_ in pairs_by_size[:30]:
            if len(ms_) < 50:
                continue
            ca_, cb_ = cam_of[na_], cam_of[nb_]
            f1, f2, ninl = estimate_pair_focal(
                keypoints[na_], keypoints[nb_], np.asarray(ms_),
                (ca_.width / 2, ca_.height / 2),
                (cb_.width / 2, cb_.height / 2))
            if ninl < 30:
                continue
            for name_, cam_, f_ in ((na_, ca_, f1), (nb_, cb_, f2)):
                lim = max(cam_.width, cam_.height)
                if np.isfinite(f_) and 0.25 * lim < f_ < 8 * lim:
                    ent = est_by_cam.setdefault(id(cam_), (cam_, [], []))
                    ent[1].append(f_)
                    ent[2].append(name_)
        for cam_, ests, names_ in est_by_cam.values():
            if len(ests) >= 2:
                cam_.params[0] = float(np.median(ests))
                seeded.update(names_)
        if seeded:
            logger.info("mapper: Bougnoux focal seeds for %d image(s)",
                        len(seeded))

    # --- initial pair: sweep focal factors per image (no EXIF; COLMAP
    # similarly samples focals when priors are absent). With known
    # intrinsics the sweep collapses to the identity factor.
    FOCAL_FACTORS = (1.0,) if known_intrinsics else (0.6, 0.85, 1.2, 1.7)
    # rank candidate pairs by their own matches plus their connectivity to the
    # rest of the scene (a well-connected init pair registers more images)
    conn = {}
    for (a, b), ms in pair_matches.items():
        conn[a] = conn.get(a, 0) + len(ms)
        conn[b] = conn.get(b, 0) + len(ms)

    def pair_rank(kv):
        (a, b), ms = kv
        return -(len(ms) + 0.25 * (conn[a] + conn[b] - 2 * len(ms)))

    top_pairs = sorted(pair_matches.items(), key=pair_rank)[:3 + att_rank]
    init_cands: List[Tuple[int, tuple]] = []   # (score, candidate) per pair
    for (na, nb), ms in top_pairs:
        ms = np.asarray(ms)
        # the blind prior (1.2*max(w,h)) is biased high -> centre the sweep
        # lower; a Bougnoux-seeded or known focal is already centred
        fa0 = cam_of[na].params[0] / (
            1.0 if known_intrinsics or na in seeded else 1.2)
        fb0 = cam_of[nb].params[0] / (
            1.0 if known_intrinsics or nb in seeded else 1.2)
        pair_best = None
        for fa in FOCAL_FACTORS:
            for fb in FOCAL_FACTORS:
                ca = Camera(0, cam_of[na].model, cam_of[na].width,
                            cam_of[na].height, cam_of[na].params.copy())
                cb = Camera(0, cam_of[nb].model, cam_of[nb].width,
                            cam_of[nb].height, cam_of[nb].params.copy())
                ca.params[0] = fa * fa0
                cb.params[0] = fb * fb0
                uv1 = _cam_from_img32(ca, keypoints[na][ms[:, 0]])
                uv2 = _cam_from_img32(cb, keypoints[nb][ms[:, 1]])
                # model selection: E (general) vs calibrated homography. A
                # planar scene satisfies the epipolar constraint for a WRONG
                # pose with full support, so, like COLMAP, prefer H whenever
                # its support is comparable (H_inl >= 0.85 * E_inl).
                solE = _essential_from_matches(uv1, uv2, iters=400,
                                               seed=att_seed)
                solH = _homography_pose_from_matches(uv1, uv2, iters=300,
                                                     seed=att_seed)
                sol = solE
                if solH is not None and (
                        solE is None
                        or int(solH[2].sum()) >= 0.85 * int(solE[2].sum())):
                    sol = solH
                if sol is None:
                    continue
                R, t, inl, front = sol
                # score: inliers that also triangulate in front of both
                score = min(int(inl.sum()), 2 * front)
                if pair_best is None or score > pair_best[0]:
                    pair_best = (score, (na, nb, R, t, fa * fa0, fb * fb0))
        if pair_best is not None:
            init_cands.append(pair_best)
        # stop scanning once enough strong candidates exist for this attempt
        if (len(init_cands) > att_rank
                and init_cands[0][0] >= 0.6 * len(ms)):
            break
    init_cands.sort(key=lambda c: -c[0])
    init_cands = [c for c in init_cands if c[0] >= 15]
    if not init_cands:
        logger.warning("mapper: no valid initial pair found")
        return rec
    best_score, chosen = init_cands[min(att_rank, len(init_cands) - 1)]
    na, nb, R, t, fa, fb = chosen
    cam_of[na].params[0] = fa
    cam_of[nb].params[0] = fb
    logger.info("mapper: init focals %.0f / %.0f (%d inliers)", fa, fb,
                best_score)

    ia, ib = name_to_id[na], name_to_id[nb]
    rec.images[ia].qvec = np.array([1.0, 0, 0, 0])
    rec.images[ia].tvec = np.zeros(3)
    rec.images[ia].registered = True
    rec.images[ib].qvec = rotmat_to_quat_np(R)
    rec.images[ib].tvec = t
    rec.images[ib].registered = True
    st.out.setdefault("init_pairs", []).append((na, nb))
    logger.info("mapper: initialized with pair (%s, %s)", na, nb)

    track_labels = compute_track_labels(graph)

    def retriangulate():
        # clear and re-triangulate over currently registered images
        rec.points3D.clear()
        for im in rec.images.values():
            im.point3D_ids[:] = -1
        sub = Reconstruction()
        sub.cameras = rec.cameras
        sub.images = {iid: im for iid, im in rec.images.items()
                      if im.registered}
        st.timed("triangulation", triangulate_tracks, sub, graph, keypoints,
                 track_labels=track_labels,
                 max_reproj_error=max_reproj_error, device=dev)
        rec.points3D = sub.points3D

    def refine():
        st.timed("ba", ba.refine, rec)

    def pnp(xy, X, cam, max_err):
        # polish=False: registration poses are refined by the global BA
        # right after
        return st.timed("pnp", absolute_pose_estimation, xy, X, cam,
                        max_error_px=max_err, polish=False, seed=att_seed,
                        device=dev)

    retriangulate()
    ba = GeometricBundleAdjuster(mapper_ba_conf(known_intrinsics),
                                 device=dev)
    # refine the two-view structure before attempting registrations
    if len(rec.points3D) >= 8:
        refine()
        retriangulate()

    registered = {na, nb}
    n_since_ba = 0
    attempts: Dict[str, int] = {}
    MAX_ATTEMPTS = 3
    rescue_pass = False   # final best-effort pass: bar drops to 6 inliers
    while True:
        # 2D-3D correspondences via graph tracks: map track label ->
        # point3D through a registered observation
        label_to_pid = {}
        for pid, p in rec.points3D.items():
            for iid, p2D_idx in p.track:
                nm = rec.images[iid].name
                gid = graph.image_name_to_id.get(nm)
                if gid is None:
                    continue
                nid = graph._node_map.get((gid, p2D_idx))
                if nid is not None:
                    label_to_pid[track_labels[nid]] = pid
                    break
        cand: Dict[str, List[Tuple[int, int]]] = {}
        for nid in range(graph.num_nodes):
            lbl = track_labels[nid]
            pid = label_to_pid.get(lbl)
            if pid is None:
                continue
            nm = graph.image_id_to_name[int(image_ids_arr[nid])]
            if nm in registered or attempts.get(nm, 0) >= MAX_ATTEMPTS:
                continue
            cand.setdefault(nm, []).append((int(feature_idxs[nid]), pid))
        cand = {n: c for n, c in cand.items() if len(c) >= 6}
        if not cand:
            remaining = [n for n in names if n not in registered]
            if remaining and not rescue_pass:
                # best-effort rescue: images that never cleared the bar get
                # one more round with the floor acceptance (6)
                rescue_pass = True
                attempts.clear()
                refine()
                retriangulate()
                continue
            break
        # fewest prior attempts first, then most correspondences
        next_name, corrs = min(
            cand.items(), key=lambda kv: (attempts.get(kv[0], 0),
                                          -len(kv[1])))
        p2D_idxs = [c[0] for c in corrs]
        p3D_ids = [c[1] for c in corrs]
        xy = keypoints[next_name][p2D_idxs]
        X = np.stack([rec.points3D[p].xyz for p in p3D_ids])
        cam_n = cam_of[next_name]
        # escalate the tolerance ONE step across retries
        max_err = 12.0 * (2.0 if attempts.get(next_name, 0) > 0 else 1.0)
        min_inl = 6 if rescue_pass else max(6, int(min_reg_inliers))
        pose = pnp(xy, X, cam_n, max_err)
        if (not pose["success"] or pose["num_inliers"] < 12) and \
                len(xy) >= 12 and not known_intrinsics:
            # focal sweep retry (unknown intrinsics)
            f0 = cam_n.params[0]
            for ff in (0.6, 0.85, 1.7, 2.4):
                cam_try = Camera(0, cam_n.model, cam_n.width, cam_n.height,
                                 cam_n.params.copy())
                cam_try.params[0] = ff * f0 / 1.2
                alt = pnp(xy, X, cam_try, max_err)
                if alt["success"] and alt["num_inliers"] > \
                        pose.get("num_inliers", 0):
                    pose = alt
                    cam_n.params[0] = cam_try.params[0]
        if not pose["success"] or pose["num_inliers"] < min_inl:
            attempts[next_name] = attempts.get(next_name, 0) + 1
            logger.info("mapper: failed to register %s (attempt %d, "
                        "%d inliers < %d)", next_name, attempts[next_name],
                        int(pose.get("num_inliers", 0)), min_inl)
            # refine the current structure before the next try: failures are
            # usually coarse two-view geometry, not bad correspondences
            refine()
            retriangulate()
            continue
        im = rec.images[name_to_id[next_name]]
        im.qvec = pose["qvec"]
        im.tvec = pose["tvec"]
        im.registered = True
        registered.add(next_name)
        st.out["registrations"] += 1
        attempts.clear()  # structure will improve; allow failed images again
        logger.info("mapper: registered %s (%d inliers)", next_name,
                    pose["num_inliers"])
        retriangulate()
        n_since_ba += 1
        if n_since_ba >= ba_every:
            refine()
            retriangulate()
            n_since_ba = 0

    refine()
    retriangulate()

    # re-registration sweep: re-seat each camera against the final
    # structure and keep the new pose when it explains at least as many
    # observations
    for name in sorted(registered):
        im = rec.images[name_to_id[name]]
        sel = np.nonzero(im.point3D_ids >= 0)[0]
        if len(sel) < 6:
            continue
        pids = im.point3D_ids[sel]
        xy = keypoints[name][sel]
        X = np.stack([rec.points3D[int(p)].xyz for p in pids])
        old_err = _reproj_errors_cam(cam_of[name], im.qvec, im.tvec, X, xy)
        old_ni = int((old_err < 12.0).sum())
        pose = pnp(xy, X, cam_of[name], 12.0)
        if pose["success"] and pose["num_inliers"] >= max(old_ni, 6):
            im.qvec = pose["qvec"]
            im.tvec = pose["tvec"]
    retriangulate()
    refine()
    retriangulate()
    refine()
    logger.info("mapper: %d registered images, %d points",
                rec.num_reg_images, len(rec.points3D))
    return rec
