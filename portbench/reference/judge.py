"""The plain reference's readings of a run's answers.

Each reading compares what the timed path produced with what the plain
reference (``features.py``, ``geometry.py``) computes from the inputs the
benchmark made:

- ``window_flips``: the share of the stored feature values (bfloat16) at
  sampled keypoint windows that differ from the reference's own;
- ``ba_grad_ratios``: bundle adjustment judged by first-order optimality
  of its featuremetric objective, as the reference evaluates it in float32
  on its own dense maps, in each kind of leaf it frees (points, poses,
  camera parameters): the norm of the objective's gradient at the answer
  over the same at the input (near 0 for a solved stage, 1 for one that
  leaves its input unchanged).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from . import features, geometry


def read_views(weights, images: Dict[str, np.ndarray],
               requests: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Per view, the reference's features ``[N, C]`` at image points
    ``requests[view] [N, 2]``: one dense map at a time."""
    out = {}
    for name, xy in requests.items():
        fmap = features.dense_map(weights, images[name])
        out[name] = features.read(fmap, xy)
        del fmap
    return out


def window_flips(weights, images, samples: Iterable[Tuple[str, np.ndarray,
                                                          torch.Tensor]],
                 ps: int) -> Tuple[float, int]:
    """``samples``: (view, keypoints [K, 2], the program's stored windows
    ``[K, ps, ps, C]``). Returns (share of values that differ, values
    compared); a window whose shape differs counts as all wrong. With
    nothing to compare the share is None, which no limit accepts."""
    diff, total = 0, 0
    for name, kps, got in samples:
        fmap = features.dense_map(weights, images[name])
        want = features.windows(fmap, kps, ps, dtype=got.dtype)
        del fmap
        got = got.to(want.device)
        total += want.numel()
        if got.shape != want.shape:
            diff += want.numel()
            continue
        diff += int((got != want).sum())
    return (diff / total if total else None), total


def rho(s: torch.Tensor, a: float) -> torch.Tensor:
    """Cauchy's loss of squared norms ``s`` at scale ``a``; ``a = 0`` is
    the trivial loss."""
    if not a:
        return s
    return a * a * torch.log1p(s / (a * a))


def _ratio(g_before: torch.Tensor, g_after: torch.Tensor) -> float:
    b = float(torch.linalg.vector_norm(g_before, dim=-1).sum())
    a = float(torch.linalg.vector_norm(g_after, dim=-1).sum())
    return a / max(b, 1e-30)


def robust_reference(desc: torch.Tensor, valid: torch.Tensor, loss: float,
                     iters: int = 100) -> torch.Tensor:
    """Per track ``[P, T, C]`` (``valid [P, T]``): the observation closest
    to the IRLS robust mean (Cauchy weights, the mean re-normalized each
    step), as the feature-reference strategy defines its references."""
    v = valid.to(desc.dtype)

    def normalize(m):
        return m / torch.clamp(torch.linalg.vector_norm(m, dim=-1,
                                                        keepdim=True), 1e-12)
    mean = normalize((desc * v[..., None]).sum(1))
    for _ in range(iters):
        d2 = ((desc - mean[:, None]) ** 2).sum(-1)
        w = v / (1.0 + d2 / (loss * loss)) if loss else v
        mean = normalize((desc * w[..., None]).sum(1))
    d2 = ((desc - mean[:, None]) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    return desc[torch.arange(len(desc), device=desc.device),
                d2.argmin(1)]


def _steps(model: str, params, free: Sequence[str], h_px: float,
           radius: float) -> Dict[int, float]:
    """Camera parameter index -> a step that moves a pixel at normalized
    radius ``radius`` by about ``h_px`` px, for each parameter of the kinds
    ``free`` names (``focal``, ``principal_point``, ``extra``)."""
    f = float(params[0])
    per_unit = {"focal": radius, "principal_point": 1.0,
                "extra": f * radius ** 3}
    return {i: h_px / per_unit[kind] for kind in free
            for i in geometry.PARAMS[model][kind]}


def ba_grad_ratios(weights, images, camera, obs: Dict[str, np.ndarray],
                   poses_before, poses_after, X_before: np.ndarray,
                   X_after: np.ndarray, loss: float, params_after=None,
                   free_params: Sequence[str] = (), fixed_pose=None,
                   fixed_tvec=(None, ()), h_px: float = 0.05
                   ) -> Dict[str, float]:
    """Feature-reference bundle adjustment, judged by first-order
    optimality in every leaf it frees. Per point, the reference descriptor
    is :func:`robust_reference` of its observations' features at the
    input's projections; the objective is the sum over observations of
    rho(||f(pi(X)) - reference||^2). Its gradient, by central differences
    whose steps each move a projection by about ``h_px`` px, is taken at
    the answer (its points, poses and camera) and at the input, and each
    reading is the norm at the answer over the norm at the input:

    - ``ba_grad``: per point (3 coordinates), norms summed;
    - ``pose_grad``: per view (a rotation and a translation of the camera,
      3 + 3), norms summed over the views whose pose is free: every view
      but ``fixed_pose``, and ``fixed_tvec = (view, coordinates)`` without
      those translation coordinates (the gauge);
    - ``cam_grad``: the camera parameters of the kinds ``free_params``
      names, shared by every view (absent when none is free).

    ``obs``: view -> point rows into X."""
    model, params = camera
    params = np.asarray(params, np.float64)
    params_after = params if params_after is None else \
        np.asarray(params_after, np.float64)
    P = len(X_before)
    f = float(params[0])
    depth, radius = [], []
    for name, rows in obs.items():
        q, t = poses_before[name]
        Xc = X_before[rows] @ geometry.quat_to_rotmat(q).T + np.asarray(t)
        depth.append(np.abs(Xc[:, 2]))
        radius.append(np.linalg.norm(Xc[:, :2] / Xc[:, 2:3], axis=1))
    z = float(np.median(np.concatenate(depth)))
    h_x = h_px * z / f                 # a point or a camera centre
    h_r = h_px / f                     # a rotation
    steps = _steps(model, params, free_params, h_px,
                   max(float(np.median(np.concatenate(radius))), 1e-3))
    eye = np.eye(3)

    def states(q, t, prm, X):
        """The projections' inputs: the state, then each point stepped,
        the camera rotated and moved, and each free parameter stepped."""
        out = [(q, t, prm, X)]
        out += [(q, t, prm, X + s * h_x * e) for e in eye for s in (1, -1)]
        out += [(geometry.quat_mul(geometry.small_rotation(s * h_r * e), q),
                 t, prm, X) for e in eye for s in (1, -1)]
        out += [(q, np.asarray(t) + s * h_x * e, prm, X) for e in eye
                for s in (1, -1)]
        for i, h in steps.items():
            for s in (1, -1):
                p = prm.copy()
                p[i] += s * h
                out.append((q, t, p, X))
        return out

    req = {}
    for name, rows in obs.items():
        pts = []
        for (q, t), prm, X in ((poses_before[name], params, X_before),
                               (poses_after[name], params_after, X_after)):
            for sq, st, sp, sX in states(q, t, prm, X[rows]):
                pts.append(geometry.project(model, sp, sq, st, sX)[0])
        req[name] = np.concatenate(pts)
    S = 19 + 2 * len(steps)
    feats = read_views(weights, images, req)
    dev = next(iter(feats.values())).device
    C = next(iter(feats.values())).shape[1]
    T = np.zeros(P, np.int64)
    slot = {}
    for name, rows in obs.items():
        slot[name] = T[rows].copy()
        T[rows] += 1
    desc = torch.zeros((P, max(int(T.max(initial=1)), 1), C), device=dev)
    valid = torch.zeros(desc.shape[:2], dtype=torch.bool, device=dev)
    for name, rows in obs.items():
        r = torch.as_tensor(rows, device=dev)
        s = torch.as_tensor(slot[name], device=dev)
        desc[r, s] = feats[name][:len(rows)]
        valid[r, s] = True
    ref = robust_reference(desc, valid, loss)
    g_pts = [torch.zeros((P, 3), device=dev) for _ in (0, 1)]
    g_pose = [[], []]
    g_cam = [torch.zeros(len(steps), device=dev) for _ in (0, 1)]
    for name, rows in obs.items():
        n = len(rows)
        r = torch.as_tensor(rows, device=dev)
        mask = torch.ones(6, device=dev)
        if name == fixed_tvec[0]:
            for c in fixed_tvec[1]:
                mask[3 + c] = 0.0
        for k in (0, 1):
            F = feats[name].view(2, S, n, C)[k]
            c = rho(((F - ref[r][None]) ** 2).sum(-1), loss)   # [S, n]
            d = c[1::2] - c[2::2]                              # [S // 2, n]
            for axis in range(3):
                g_pts[k][:, axis].index_add_(0, r, d[axis] / (2 * h_x))
            if name != fixed_pose:
                g_pose[k].append(d[3:9].sum(1) / (2 * h_px) * mask)
            g_cam[k] += d[9:].sum(1) / (2 * h_px)
    out = {"ba_grad": _ratio(g_pts[0], g_pts[1]),
           "pose_grad": _ratio(torch.stack(g_pose[0]),
                               torch.stack(g_pose[1]))}
    if steps:
        out["cam_grad"] = _ratio(g_cam[0][None], g_cam[1][None])
    return out
