"""Synthetic reconstruction generator for tests and benchmarks.

Copy of ``pixsfm_tpu/sfm/synthetic.py`` (numpy only); the same seed gives
the same scene in both packages. Same role as the reference's synthetic-scene fixture in its BA differential test
(pixsfm/bundle_adjustment/src/bundle_optimizer_test.cc:61-134): random 3D points,
cameras on a ring looking at the centroid, observations = noisy projections.
"""

from __future__ import annotations

import numpy as np

from ..base.cameras import Camera
from ..base.geometry import rotmat_to_quat_np
from .model import Image, Point3D, Reconstruction

__all__ = ["synthetic_reconstruction"]


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera rotation with +z toward target."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    if abs(np.dot(up, z)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])  # rows = camera axes in world coords


def synthetic_reconstruction(
        n_images: int = 4, n_points: int = 100, seed: int = 0,
        model: str = "SIMPLE_RADIAL", noise_px: float = 0.5,
        shared_camera: bool = True, width: int = 1024, height: int = 768,
        point_noise: float = 0.0) -> Reconstruction:
    rng = np.random.default_rng(seed)
    rec = Reconstruction()

    pts = rng.uniform(-2, 2, size=(n_points, 3))
    center = pts.mean(axis=0)

    f = 1.2 * max(width, height)
    def make_params():
        if model == "SIMPLE_PINHOLE":
            return np.array([f, width / 2, height / 2])
        if model == "PINHOLE":
            return np.array([f, f, width / 2, height / 2])
        if model == "SIMPLE_RADIAL":
            return np.array([f, width / 2, height / 2, 0.02])
        if model == "RADIAL":
            return np.array([f, width / 2, height / 2, 0.02, -0.005])
        if model == "OPENCV":
            return np.array([f, f, width / 2, height / 2, 0.02, -0.005,
                             1e-4, -1e-4])
        raise ValueError(model)

    if shared_camera:
        rec.add_camera(Camera(1, model, width, height, make_params()))

    for i in range(n_images):
        ang = 2 * np.pi * i / max(n_images, 1) * 0.25
        eye = center + np.array([8 * np.sin(ang), 1.5 * rng.uniform(-1, 1),
                                 -8 * np.cos(ang)])
        R = _look_at(eye, center)
        qvec = rotmat_to_quat_np(R)
        tvec = -R @ eye
        cam_id = 1 if shared_camera else i + 1
        if not shared_camera:
            rec.add_camera(Camera(cam_id, model, width, height, make_params()))
        rec.add_image(Image(i + 1, f"image{i + 1}.jpg", cam_id, qvec, tvec))

    # project all points into all images at once
    from ..base.projection import project_np

    tracks = {pid: [] for pid in range(n_points)}
    for im in rec.images.values():
        cam_i = rec.cameras[im.camera_id]
        xy, depth = project_np(cam_i, im.qvec, im.tvec, pts)
        xy = xy + rng.normal(0, noise_px, xy.shape)
        ok = (depth > 0.1) & (xy[:, 0] >= 0) & (xy[:, 0] < width) \
            & (xy[:, 1] >= 0) & (xy[:, 1] < height)
        sel = np.nonzero(ok)[0]
        im.xys = xy[sel]
        im.point3D_ids = sel.astype(np.int64)
        for p2D_idx, pid in enumerate(sel):
            tracks[int(pid)].append((im.image_id, p2D_idx))
    for pid, X in enumerate(pts):
        track = tracks[pid]
        if len(track) >= 2:
            xyz = X + (rng.normal(0, point_noise, 3) if point_noise else 0.0)
            rec.add_point3D(Point3D(pid, xyz, track=track))
        else:
            for iid, p2D_idx in track:
                rec.images[iid].point3D_ids[p2D_idx] = -1
    # drop dangling observations of removed points
    valid = set(rec.points3D.keys())
    for im in rec.images.values():
        for j, pid in enumerate(im.point3D_ids):
            if pid >= 0 and pid not in valid:
                im.point3D_ids[j] = -1
    return rec
