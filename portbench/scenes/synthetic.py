"""Seeded synthetic scenes, rendered on the device.

The ``plane`` geometry, as the repository's chip smoke test drew it: the
textured plane z = 0 (8 plane waves of 20-100 cycles per unit mixed into
RGB), seen by SIMPLE_RADIAL cameras of focal 1.2 W on a ring 1.8-2.4 units
away, tilted 10-35 degrees; views rendered through the plane-to-image
homographies.

Each point's track is a random subset of ``min_track``-``max_track`` of the
views that see it ``margin`` px inside the image; its keypoints are the
true projections plus N(0, ``noise_px``). Everything comes from ``seed``:
the same seed gives the same scene. The scene is plain numpy (and the
views uint8 arrays); ``scenes/program.py`` turns it into the program's
objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..reference.geometry import look_at, project, rotmat_to_quat

@dataclass
class Scene:
    W: int
    H: int
    model: str
    params: np.ndarray                 # camera parameters, shared
    names: List[str]                   # view names, view v has image id v+1
    qvecs: np.ndarray                  # [V, 4] true poses (world -> camera)
    tvecs: np.ndarray                  # [V, 3]
    points: np.ndarray                 # [P, 3] true points
    obs_pts: List[np.ndarray]          # per view: the point of each keypoint
    obs_xy: List[np.ndarray]           # per view: keypoints (noisy)
    views: Dict[str, np.ndarray] = field(repr=False, default_factory=dict)


def _poses(rng, n_views):
    poses = []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views + rng.uniform(-0.2, 0.2)
        tilt = rng.uniform(0.17, 0.61)
        target = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                           0.0])
        eye = target + rng.uniform(1.8, 2.4) * np.array(
            [np.sin(tilt) * np.cos(ang), np.sin(tilt) * np.sin(ang),
             np.cos(tilt)])
        R = look_at(eye, target)
        poses.append((R, -R @ eye))
    return poses


def _texture(rng, n_waves=8):
    mix = rng.normal(0, 1, (n_waves, 3))
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))
    return mix


def _pixel_grid(W, H, dev):
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    return xs + 0.5, ys + 0.5


def _shade(coords, waves, phase, mix, dev):
    """RGB of 127.5 + sum_k sin(2 pi <coords, wave_k> + phase_k) mix_k."""
    arg = 2 * np.pi * (coords @ torch.as_tensor(waves.T, device=dev)) \
        + torch.as_tensor(phase, device=dev)
    img = 127.5 + torch.sin(arg) @ torch.as_tensor(mix, device=dev)
    return img.clamp(0, 255).to(torch.uint8)


def _tracks(rng, vis, proj, n_points, min_track, max_track, noise_px):
    keep = np.nonzero(vis.sum(1) >= min_track)[0][:n_points]
    if len(keep) < n_points:
        raise RuntimeError(f"scene: only {len(keep)} points are seen by "
                           f"{min_track} views")
    vis, proj = vis[keep], proj[keep]
    L = np.minimum(rng.integers(min_track, max_track + 1, n_points),
                   vis.sum(1))
    keys = np.where(vis, rng.random(vis.shape), np.inf)
    chosen = np.argsort(keys, axis=1)
    in_track = np.zeros_like(vis)
    rows = np.repeat(np.arange(n_points), L)
    cols = chosen[rows, np.concatenate([np.arange(n) for n in L])]
    in_track[rows, cols] = True
    obs_pts, obs_xy = [], []
    for v in range(vis.shape[1]):
        pts = np.nonzero(in_track[:, v])[0]
        obs_pts.append(pts)
        obs_xy.append(proj[pts, v] + rng.normal(0, noise_px, (len(pts), 2)))
    return keep, obs_pts, obs_xy


def make_scene(kind: str, seed: int, n_views: int, n_points: int, W: int,
               H: int, device, min_track=3, max_track=8, margin=24,
               noise_px=1.0) -> Scene:
    """A ``plane`` scene (see the module docstring)."""
    if kind != "plane":
        raise ValueError(f"no scene geometry {kind!r}")
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    f = 1.2 * W
    params = np.array([f, W / 2, H / 2, 0.0])
    poses = _poses(rng, n_views)
    n_waves = 8
    freq = rng.uniform(20, 100, n_waves) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, n_waves))
    waves = np.stack([freq.real, freq.imag], 1)
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    mix = _texture(rng, n_waves)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    xs, ys = _pixel_grid(W, H, dev)
    names = [f"view{v:03d}.jpg" for v in range(n_views)]
    views = {}
    for v, (R, t) in enumerate(poses):
        Hm = K @ np.stack([R[:, 0], R[:, 1], t], 1)         # plane -> image
        Hi = torch.as_tensor(np.linalg.inv(Hm), device=dev)
        q = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ Hi.T
        coords = q[..., :2] / q[..., 2:]
        views[names[v]] = _shade(coords, waves, phase, mix, dev).cpu().numpy()

    n_cand = 2 * n_points
    x = rng.uniform(-0.8, 0.8, n_cand)
    y = rng.uniform(-0.8, 0.8, n_cand)
    P3 = np.stack([x, y, np.zeros(n_cand)], 1)
    vis = np.zeros((n_cand, n_views), bool)
    proj = np.zeros((n_cand, n_views, 2))
    qvecs, tvecs = [], []
    for v, (R, t) in enumerate(poses):
        qv = rotmat_to_quat(R)
        qvecs.append(qv)
        tvecs.append(t)
        xy, depth = project("SIMPLE_RADIAL", params, qv, t, P3)
        proj[:, v] = xy
        vis[:, v] = (depth > 0) & (xy[:, 0] >= margin) \
            & (xy[:, 0] < W - margin) & (xy[:, 1] >= margin) \
            & (xy[:, 1] < H - margin)
    keep, obs_pts, obs_xy = _tracks(
        rng, vis, proj, n_points, min_track, max_track, noise_px)
    return Scene(W, H, "SIMPLE_RADIAL", params, names, np.stack(qvecs),
                 np.stack(tvecs), P3[keep], obs_pts, obs_xy, views)
