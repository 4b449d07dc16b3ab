"""A synthetic scene as the program's inputs: a COLMAP-style
reconstruction."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..reference.geometry import quat_mul, small_rotation
from .synthetic import Scene


def _camera(scene: Scene):
    from pixsfm_tpu_torch.base.cameras import Camera
    return Camera(1, scene.model, scene.W, scene.H, scene.params.copy())


def tracks_of(scene: Scene, views=None) -> List[List[Tuple[int, int]]]:
    """Per point, its ``(image_id, keypoint index)`` observations in
    ``views`` (all views by default)."""
    tracks: List[List[Tuple[int, int]]] = [[] for _ in scene.points]
    for v in (range(len(scene.names)) if views is None else views):
        for j, p in enumerate(scene.obs_pts[v].tolist()):
            tracks[p].append((v + 1, j))
    return tracks


def reconstruction(scene: Scene, seed: int | None = None):
    """The scene's reconstruction; with ``seed``, every pose but the first
    is perturbed by N(0, 3e-4) rad and N(0, 1e-3) and every point by
    N(0, 1e-3), as a BA input."""
    from pixsfm_tpu_torch.sfm.model import Image, Point3D, Reconstruction
    rec = Reconstruction()
    rec.add_camera(_camera(scene))
    rng = None if seed is None else np.random.default_rng(seed)
    for v, name in enumerate(scene.names):
        q, t = scene.qvecs[v].copy(), scene.tvecs[v].copy()
        if rng is not None and v > 0:
            q = quat_mul(small_rotation(rng.normal(0, 3e-4, 3)), q)
            q /= np.linalg.norm(q)
            t = t + rng.normal(0, 1e-3, 3)
        rec.add_image(Image(v + 1, name, 1, q, t, scene.obs_xy[v].copy(),
                            scene.obs_pts[v].astype(np.int64)))
    pts = scene.points.copy()
    if rng is not None:
        pts = pts + rng.normal(0, 1e-3, pts.shape)
    for p, track in enumerate(tracks_of(scene)):
        rec.add_point3D(Point3D(p, pts[p], track=track))
    return rec
