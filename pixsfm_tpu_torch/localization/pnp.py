"""Absolute pose estimation: RANSAC PnP with LO refinement (reference:
``pycolmap.absolute_pose_estimation``, pixsfm/localization/main.py:458-461).

Port of the part of ``pixsfm_tpu/localization/pnp.py`` that the incremental
mapper calls, in two halves:

- on the host, in float64 numpy (copies of the JAX package's functions, so
  both packages compute the same numbers): the projection and reprojection
  errors of whole point sets, the quaternion helpers, the Cauchy-weighted
  Gauss-Newton polish :func:`_pose_refinement_np`, the SVD-based minimal
  solvers and the adaptive host RANSAC :func:`_absolute_pose_estimation_host`
  (the plain version the tests hold the device program to), and the
  hypothesis sampler :func:`_gen_samples` (``np.random.default_rng``, drawn
  in the JAX package's order);
- on the device, in float32 torch: the batched minimal solvers (Grunert
  P3P through a branch-free Ferrari quartic, the 6-point DLT and the planar
  homography decomposition, whose null vectors come from inverse power
  iteration) and :func:`_pnp_core`, which scores every hypothesis of every
  query at once, takes the first best and runs the LO rounds of damped
  Gauss-Newton steps. The JAX package ``vmap``s one query's program over a
  batch; here every tensor carries a leading query axis, and the
  ``lax.scan`` loops are Python loops over tensors with no host sync inside.

The JAX package pads each query to a power of two (a recompile bucket);
eager torch needs none, so a group of queries is padded only to its
largest one. The padding rows are invalid and never sampled in both.
``bucket(n, minimum=16)`` stays the grouping key, so the samples are drawn
in the JAX package's order. The 12x12 and 9x9 null-space solves keep the
JAX package's column Cholesky with its ``1e-30`` pivot clamp (the
ridge-shifted normal matrix of an exact minimal sample is indefinite in
float32 rounding, where LAPACK's factorization stops) and solve with
``torch.cholesky_solve``; the 6x6 Gauss-Newton systems factor with
``torch.linalg.cholesky_ex``, a failed factorization giving a rejected step.
:func:`pose_refinement` is the pose-only damped Gauss-Newton of the JAX
package (``pnp.py:361``) as a fixed-length batched torch loop: a
``torch.func`` forward-mode Jacobian and an LU solve per step, acceptance by
``torch.where``, one fetch at the end.
Not ported: the mesh fan-out over devices (it waits for sharding), and
``_dlt_pose``, which nothing calls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import logger, resolve_device
from ..base.cameras import Camera, cam_from_img, img_from_cam
from ..base.geometry import (exp_quat, quat_mul, quat_normalize,
                             rotmat_to_quat)
from ..base.projection import calculate_depth, project_with_jac, \
    world_to_pixel
from ..util.misc import bucket

__all__ = ["absolute_pose_estimation", "absolute_pose_estimation_batch",
           "finalize_device_pose", "pose_refinement"]


# ---------------------------------------------------------------------------
# host, float64 numpy (copies of the JAX package's functions)
# ---------------------------------------------------------------------------

def _cam_from_img32(camera: Camera, xy) -> np.ndarray:
    """``Camera.cam_from_img`` as the JAX package computes it: in float32
    (its arrays are float32 by default), on the CPU."""
    return cam_from_img(
        camera.model, torch.as_tensor(camera.params, dtype=torch.float32),
        torch.as_tensor(np.asarray(xy), dtype=torch.float32)
    ).numpy().astype(np.float64)


def _dlt_pose_batch(uv: np.ndarray, X: np.ndarray):
    """Batched minimal-sample DLT: uv [B, m, 2], X [B, m, 3] ->
    (R [B,3,3], t [B,3], ok [B]). One batched SVD for all hypotheses."""
    B, m, _ = uv.shape
    A = np.zeros((B, 2 * m, 12))
    Xh = np.concatenate([X, np.ones((B, m, 1))], axis=2)
    A[:, 0::2, 0:4] = Xh
    A[:, 0::2, 8:12] = -uv[:, :, 0:1] * Xh
    A[:, 1::2, 4:8] = Xh
    A[:, 1::2, 8:12] = -uv[:, :, 1:2] * Xh
    _, _, Vt = np.linalg.svd(A)
    P = Vt[:, -1, :].reshape(B, 3, 4)
    # cheirality: sign so that projective depths are positive
    w = np.einsum("bmi,bi->bm", Xh, P[:, 2])
    sign = np.where(np.median(w, axis=1) < 0, -1.0, 1.0)
    P = P * sign[:, None, None]
    M = P[:, :, :3]
    U, S, Vt2 = np.linalg.svd(M)
    ok = S[:, -1] > 1e-10 * np.maximum(S[:, 0], 1e-12)
    det = np.linalg.det(np.einsum("bij,bjk->bik", U, Vt2))
    D = np.zeros((B, 3, 3))
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = det
    R = np.einsum("bij,bjk,bkl->bil", U, D, Vt2)
    t = P[:, :, 3] / np.maximum(S.mean(axis=1), 1e-12)[:, None]
    return R, t, ok


def _homography_pose_batch(uv: np.ndarray, X: np.ndarray):
    """Planar-safe pose hypotheses by homography decomposition: per sample,
    fit the best plane to the 3D points, fit uv ~ H [w, 1] (normalized DLT)
    in in-plane coordinates w, and decompose H = [R e1, R e2, R c + t] up to
    scale (e1/e2 = plane axes, c = centroid).

    uv: [B, N, 2] normalized camera coords, X: [B, N, 3]. Returns (R [B,3,3],
    t [B,3], ok [B])."""
    B, N, _ = uv.shape
    c = X.mean(axis=1, keepdims=True)
    Xc = X - c
    # plane axes: top-2 right singular vectors of the centered points
    _, S3, Vt3 = np.linalg.svd(Xc, full_matrices=False)
    e1 = Vt3[:, 0]                             # [B, 3]
    e2 = Vt3[:, 1]
    n = np.cross(e1, e2)
    w = np.stack([np.einsum("bnj,bj->bn", Xc, e1),
                  np.einsum("bnj,bj->bn", Xc, e2)], axis=-1)  # [B, N, 2]

    # normalized homography DLT: uv ~ H [w, 1]
    def norm_pts(p):
        m = p.mean(axis=1, keepdims=True)
        s = np.sqrt(2.0) / np.maximum(
            np.linalg.norm(p - m, axis=2).mean(axis=1), 1e-12)
        return (p - m) * s[:, None, None], m[:, 0], s

    wn, wm, ws = norm_pts(w)
    un, um, us = norm_pts(uv)
    wh = np.concatenate([wn, np.ones((B, N, 1))], axis=-1)
    A = np.zeros((B, 2 * N, 9))
    A[:, 0::2, 0:3] = wh
    A[:, 0::2, 6:9] = -un[:, :, 0:1] * wh
    A[:, 1::2, 3:6] = wh
    A[:, 1::2, 6:9] = -un[:, :, 1:2] * wh
    _, Sh, Vth = np.linalg.svd(A)
    Hn = Vth[:, -1, :].reshape(B, 3, 3)
    # denormalize: uv = Tun^-1 Hn Twn with Tw = [ws*(w - wm)]
    Tu_inv = np.zeros((B, 3, 3))
    Tu_inv[:, 0, 0] = 1.0 / us
    Tu_inv[:, 1, 1] = 1.0 / us
    Tu_inv[:, 2, 2] = 1.0
    Tu_inv[:, 0, 2] = um[:, 0]
    Tu_inv[:, 1, 2] = um[:, 1]
    Tw = np.zeros((B, 3, 3))
    Tw[:, 0, 0] = ws
    Tw[:, 1, 1] = ws
    Tw[:, 2, 2] = 1.0
    Tw[:, 0, 2] = -ws * wm[:, 0]
    Tw[:, 1, 2] = -ws * wm[:, 1]
    H = np.einsum("bij,bjk,bkl->bil", Tu_inv, Hn, Tw)

    # cheirality: third column maps the centroid -> (R c + t); depth > 0
    sign = np.where(H[:, 2, 2] < 0, -1.0, 1.0)
    H = H * sign[:, None, None]
    # scale so the rotation columns are unit
    lam = 2.0 / np.maximum(np.linalg.norm(H[:, :, 0], axis=1)
                           + np.linalg.norm(H[:, :, 1], axis=1), 1e-12)
    H = H * lam[:, None, None]
    r1 = H[:, :, 0]
    r2 = H[:, :, 1]
    # orthonormalize (closest rotation to [r1 r2 r1xr2])
    Q = np.stack([r1, r2, np.cross(r1, r2)], axis=-1)
    Uq, Sq, Vtq = np.linalg.svd(Q)
    detq = np.linalg.det(np.einsum("bij,bjk->bik", Uq, Vtq))
    Dq = np.zeros((B, 3, 3))
    Dq[:, 0, 0] = 1.0
    Dq[:, 1, 1] = 1.0
    Dq[:, 2, 2] = detq
    Qr = np.einsum("bij,bjk,bkl->bil", Uq, Dq, Vtq)   # = R [e1 e2 n]
    E = np.stack([e1, e2, n], axis=-1)                 # [B, 3, 3] columns
    R = np.einsum("bij,bkj->bik", Qr, E)               # R = Qr E^T
    t = H[:, :, 2] - np.einsum("bij,bj->bi", R, c[:, 0])
    ok = (Sh[:, -2] > 1e-12) & np.isfinite(t).all(axis=1)
    return R, t, ok


def _reproj_errors_Rt(camera: Camera, R, t, X, xy):
    """Reprojection errors for a rotation-matrix pose (numpy, no quat detour)."""
    x_cam = (R @ np.atleast_2d(X).T).T + t
    z = x_cam[:, 2]
    uv = x_cam[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None]
    xy_proj = _apply_intrinsics_np(camera, uv)
    err = np.linalg.norm(xy_proj - xy, axis=1)
    err[z <= 0] = np.inf
    return err


def _apply_intrinsics_np(camera: Camera, uv: np.ndarray):
    p = camera.params
    model = camera.model
    u, v = uv[:, 0], uv[:, 1]
    if model == "SIMPLE_PINHOLE":
        d = uv; fx = fy = p[0]; cx, cy = p[1], p[2]
    elif model == "PINHOLE":
        d = uv; fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    elif model == "SIMPLE_RADIAL":
        r2 = u * u + v * v
        d = uv * (1.0 + p[3] * r2)[:, None]
        fx = fy = p[0]; cx, cy = p[1], p[2]
    elif model == "RADIAL":
        r2 = u * u + v * v
        d = uv * (1.0 + r2 * (p[3] + p[4] * r2))[:, None]
        fx = fy = p[0]; cx, cy = p[1], p[2]
    elif model == "OPENCV":
        k1, k2, p1, p2 = p[4], p[5], p[6], p[7]
        r2 = u * u + v * v
        radial = 1.0 + r2 * (k1 + k2 * r2)
        du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
        dv = v * radial + p1 * (r2 + 2 * v * v) + 2 * p2 * u * v
        d = np.stack([du, dv], axis=1)
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    else:
        raise ValueError(f"unsupported model {model}")
    return np.stack([fx * d[:, 0] + cx, fy * d[:, 1] + cy], axis=1)


def _quat_to_rotmat_np(q):
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def project_np(camera: Camera, qvec, tvec, X):
    """float64 numpy projection (forward distortion only) of a point set:
    ``(xy [N, 2], depth [N])``."""
    R = _quat_to_rotmat_np(qvec)
    x_cam = (R @ np.atleast_2d(X).T).T + np.asarray(tvec)
    z = x_cam[:, 2]
    uv = x_cam[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None]
    return _apply_intrinsics_np(camera, uv), z


def _reproj_errors(camera: Camera, qvec, tvec, X, xy):
    """Reprojection errors in pixels; points behind the camera are inf."""
    proj, depths = project_np(camera, qvec, tvec, X)
    err = np.linalg.norm(proj - xy, axis=1)
    err[depths <= 0] = np.inf
    return err


def _rotmat_to_quat_np(R):
    """Shepperd's method in numpy ([w,x,y,z])."""
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(max(tr + 1.0, 1e-12)) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s,
             (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 1e-12)) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s,
             (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(max(1.0 + R[1, 1] - R[0, 0] - R[2, 2], 1e-12)) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
             0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(max(1.0 + R[2, 2] - R[0, 0] - R[1, 1], 1e-12)) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def _exp_quat_np(phi):
    """so(3) tangent -> unit quaternion ([w,x,y,z])."""
    theta = np.linalg.norm(phi)
    if theta < 1e-6:
        k = 0.5 - theta * theta / 48.0
        w = 1.0 - theta * theta / 8.0
    else:
        k = np.sin(0.5 * theta) / theta
        w = np.cos(0.5 * theta)
    q = np.concatenate([[w], k * np.asarray(phi, np.float64)])
    return q / np.linalg.norm(q)


def _quat_mul_np(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _pose_refinement_np(camera: Camera, qvec, tvec, X, xy,
                        iters: int = 30, loss_scale_px: float = None) -> Dict:
    """Host-side pose-only damped Gauss-Newton (central-difference Jacobian
    over the 6-DoF tangent, float64).

    ``loss_scale_px``: when set, minimize a Cauchy robust cost at that pixel
    scale via IRLS (COLMAP's RefineAbsolutePose uses CauchyLoss at scale 1)."""
    q = np.asarray(qvec, np.float64)
    q = q / np.linalg.norm(q)
    t = np.asarray(tvec, np.float64).copy()
    X = np.asarray(X, np.float64)
    xy = np.asarray(xy, np.float64)
    c2 = None if loss_scale_px is None else float(loss_scale_px) ** 2

    def step(q, t, d):
        return (_quat_mul_np(_exp_quat_np(d[:3]), q), t + d[3:6])

    def resid(q, t):
        proj, _ = project_np(camera, q, t, X)
        return (proj - xy).ravel()

    def robust_cost(r):
        if c2 is None:
            return 0.5 * float(r @ r)
        s = r.reshape(-1, 2)
        s = s[:, 0] ** 2 + s[:, 1] ** 2              # per-point squared norm
        return 0.5 * float(np.sum(c2 * np.log1p(s / c2)))

    def irls_w(r):
        """Per-residual sqrt-weights: Cauchy rho'(s) = 1/(1+s/c^2)."""
        if c2 is None:
            return None
        s = r.reshape(-1, 2)
        s = s[:, 0] ** 2 + s[:, 1] ** 2
        return np.sqrt(np.repeat(1.0 / (1.0 + s / c2), 2))

    r = resid(q, t)
    cost = robust_cost(r)
    lam = 1e-4
    eps = 1e-6
    for _ in range(iters):
        J = np.empty((r.size, 6))
        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            J[:, k] = (resid(*step(q, t, d)) - resid(*step(q, t, -d))) \
                / (2 * eps)
        w = irls_w(r)
        rw, Jw = (r, J) if w is None else (r * w, J * w[:, None])
        g = Jw.T @ rw
        H = Jw.T @ Jw
        D = np.clip(np.diag(H), 1e-8, 1e32)
        try:
            d = -np.linalg.solve(H + lam * np.diag(D), g)
        except np.linalg.LinAlgError:
            break
        qn, tn = step(q, t, d)
        rn = resid(qn, tn)
        cn = robust_cost(rn)
        if cn < cost:
            q, t, r, cost = qn, tn, rn, cn
            lam = max(lam / 3.0, 1e-12)
            if np.linalg.norm(d) < 1e-12:
                break
        else:
            lam = min(lam * 4.0, 1e16)
    return {"qvec": q, "tvec": t}


def _gen_samples(rng, n: int, H: int) -> np.ndarray:
    """[H, 6] distinct indices in [0, n) per row (vectorized host sampling)."""
    r = rng.random((H, n))
    return np.argpartition(r, 5, axis=1)[:, :6].astype(np.int32)


# ---------------------------------------------------------------------------
# device, float32 torch: batched linear algebra and minimal solvers
# ---------------------------------------------------------------------------

def _chol_batch(A):
    """Batched Cholesky of PSD ``A [..., d, d]``, column by column with each
    pivot clamped at ``1e-30`` (``pnp.py:444``): a ridge-shifted Gram matrix
    whose rounding made it indefinite still factors, and inverse power
    iteration then amplifies exactly its near-null direction."""
    d = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(d):
        r = A[..., j, j] - (L[..., j, :j] ** 2).sum(-1)
        ljj = torch.sqrt(torch.clamp(r, min=1e-30))
        L[..., j, j] = ljj
        if j + 1 < d:
            L[..., j + 1:, j] = (A[..., j + 1:, j] - (
                L[..., j + 1:, :j] @ L[..., j, :j, None])[..., 0]) \
                / ljj[..., None]
    return L


def _chol_solve(L, b):
    """Solve ``(L L^T) x = b`` for lower ``L [..., d, d]``, ``b [..., d]``."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _smallest_evec(G, iters: int = 8):
    """Smallest eigenvector of PSD ``G [..., d, d]`` by inverse power
    iteration on a ridge-shifted Cholesky factorization."""
    d = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    ridge = (1e-7 * tr / d + 1e-20)[..., None, None]
    L = _chol_batch(G + ridge * torch.eye(d, dtype=G.dtype, device=G.device))
    x = torch.ones(G.shape[:-1], dtype=G.dtype, device=G.device) / np.sqrt(d)
    for _ in range(iters):
        x = _chol_solve(L, x)
        # a clamped pivot makes x ~ 1e30: scaled by its largest entry first,
        # its squares stay finite (JAX's norm overflows there, and its null
        # vector collapses to zero)
        x = x / torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-30)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                            min=1e-30)
    return x


def _det3(M):
    """Closed-form 3x3 determinant ``r0 . (r1 x r2)`` of the rows."""
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :],
                                              dim=-1)).sum(-1)


def _inv3(M, eps=1e-30):
    """Closed-form 3x3 inverse via the adjugate, whose columns are the cross
    products of the rows; ``|det| < eps`` is replaced by ``eps``."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r1, r2, dim=-1)
    adj = torch.stack([c0, torch.linalg.cross(r2, r0, dim=-1),
                       torch.linalg.cross(r0, r1, dim=-1)], dim=-1)
    d = (r0 * c0).sum(-1)[..., None, None]
    return adj / torch.where(torch.abs(d) < eps, torch.full_like(d, eps), d)


def _project_so3(M, iters: int = 9):
    """Nearest rotation by Newton polar iteration X <- (X + X^-T) / 2, ``M``
    sign-flipped to det > 0 first."""
    flip = 1.0 - 2.0 * (_det3(M) < 0).to(M.dtype)
    M = M * flip[..., None, None]
    nrm = torch.clamp(torch.linalg.matrix_norm(M)[..., None, None], min=1e-20)
    X = M / nrm * np.sqrt(3.0)
    for _ in range(iters):
        X = 0.5 * (X + _inv3(X).transpose(-2, -1))
    return X


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _solve_quartic_real(c4, c3, c2, c1, c0):
    """Batched real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0: Ferrari's
    method with a Cardano/trigonometric resolvent cubic, branch-free (every
    branch computed, the valid one picked with ``where``), then two Newton
    steps on the original quartic. Returns ``[B, 4]`` roots with NaN marking
    complex or absent ones."""
    nan = torch.full_like(c4, float("nan"))
    bad = torch.abs(c4) < 1e-14
    c4s = torch.where(bad, torch.ones_like(c4), c4)
    a3, a2 = c3 / c4s, c2 / c4s
    a1, a0 = c1 / c4s, c0 / c4s
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a3/4
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + a3 ** 3 / 8.0
    r = a0 - a3 * a1 / 4.0 + a3 * a3 * a2 / 16.0 - 3.0 * a3 ** 4 / 256.0
    # resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0
    b, c_, d = p, p * p / 4.0 - r, -q * q / 8.0
    ps = c_ - b * b / 3.0
    qs = 2.0 * b ** 3 / 27.0 - b * c_ / 3.0 + d
    disc = (qs / 2.0) ** 2 + (ps / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s_one = _cbrt(-qs / 2.0 + sq) + _cbrt(-qs / 2.0 - sq)
    # three-real-root branch: largest root via the trig form
    pc = torch.clamp(ps, max=-1e-30)
    acos_arg = torch.clamp(3.0 * qs / (2.0 * pc) * torch.sqrt(-3.0 / pc),
                           -1.0, 1.0)
    s_tri = 2.0 * torch.sqrt(-pc / 3.0) * torch.cos(torch.acos(acos_arg)
                                                    / 3.0)
    m = torch.where(disc >= 0, s_one, s_tri) - b / 3.0
    m = torch.clamp(m, min=1e-12)
    # (y^2 + p/2 + m)^2 = 2m y^2 - q y + q^2/(8m)  ->  two quadratics
    s2m = torch.sqrt(2.0 * m)
    h = q / (2.0 * s2m)
    roots = []
    for sign in (1.0, -1.0):
        # y^2 - sign*s2m*y + (p/2 + m + sign*h) = 0
        A = p / 2.0 + m + sign * h
        dq = s2m * s2m - 4.0 * A
        sd = torch.sqrt(torch.clamp(dq, min=0.0))
        for pm in (1.0, -1.0):
            y = (sign * s2m + pm * sd) / 2.0
            roots.append(torch.where((dq >= 0) & ~bad, y - a3 / 4.0, nan))
    x = torch.stack(roots, dim=-1)                          # [B, 4]
    # two Newton steps on the original quartic: Ferrari's cancellations cost
    # several float32 digits near clustered roots
    c4e, c3e, c2e, c1e, c0e = (c[..., None] for c in (c4, c3, c2, c1, c0))
    for _ in range(2):
        fx = (((c4e * x + c3e) * x + c2e) * x + c1e) * x + c0e
        dfx = ((4.0 * c4e * x + 3.0 * c3e) * x + 2.0 * c2e) * x + c1e
        dfx = torch.where(torch.abs(dfx) < 1e-12, torch.full_like(dfx, 1e-12),
                          dfx)
        x = x - fx / dfx
    return x


def _normalized(v, eps):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def _p3p_batch(su, sx):
    """Batched Grunert P3P: ``su [B, >=3, 2]`` normalized image rays (the
    first 3 used), ``sx [B, >=3, 3]`` world points -> ``(R [4B, 3, 3],
    t [4B, 3], ok [4B])``, up to 4 pose solutions per sample, sample-major
    (Haralick et al., 'Review and analysis of solutions of the three point
    perspective pose estimation problem')."""
    B = su.shape[0]
    f = torch.cat([su[:, :3], torch.ones_like(su[:, :3, :1])], -1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)   # [B, 3, 3]
    f1, f2, f3 = f[:, 0], f[:, 1], f[:, 2]
    X1, X2, X3 = sx[:, 0], sx[:, 1], sx[:, 2]
    ca = (f2 * f3).sum(-1)          # cos(alpha): angle at rays (2,3)
    cb = (f1 * f3).sum(-1)          # cos(beta):  rays (1,3)
    cg = (f1 * f2).sum(-1)          # cos(gamma): rays (1,2)
    a2 = ((X2 - X3) ** 2).sum(-1)
    b2 = ((X1 - X3) ** 2).sum(-1)
    c2 = ((X1 - X2) ** 2).sum(-1)
    ok0 = (b2 > 1e-12) & (a2 > 1e-12) & (c2 > 1e-12)
    b2s = torch.where(ok0, b2, torch.ones_like(b2))
    aq = a2 / b2s
    cq = c2 / b2s
    amc = aq - cq
    apc = aq + cq
    A4 = (amc - 1.0) ** 2 - 4.0 * cq * ca * ca
    A3 = 4.0 * (amc * (1.0 - amc) * cb - (1.0 - apc) * ca * cg
                + 2.0 * cq * ca * ca * cb)
    A2 = 2.0 * (amc * amc - 1.0 + 2.0 * amc * amc * cb * cb
                + 2.0 * (1.0 - cq) * ca * ca
                - 4.0 * apc * ca * cb * cg + 2.0 * (1.0 - aq) * cg * cg)
    A1 = 4.0 * (-amc * (1.0 + amc) * cb + 2.0 * aq * cg * cg * cb
                - (1.0 - apc) * ca * cg)
    A0 = (1.0 + amc) ** 2 - 4.0 * aq * cg * cg
    v = _solve_quartic_real(A4, A3, A2, A1, A0)             # [B, 4]

    # back-substitution per root: u then the three ray distances
    caE, cbE, cgE = ca[:, None], cb[:, None], cg[:, None]
    den = 2.0 * (cgE - v * caE)
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12),
                      den)
    u = ((-1.0 + amc[:, None]) * v * v - 2.0 * amc[:, None] * cbE * v
         + 1.0 + amc[:, None]) / den
    s1sq = b2s[:, None] / torch.clamp(1.0 + v * v - 2.0 * v * cbE, min=1e-12)
    s1 = torch.sqrt(torch.clamp(s1sq, min=0.0))
    s2 = u * s1
    s3 = v * s1
    ok = (ok0[:, None] & torch.isfinite(v) & (v > 1e-9) & (u > 1e-9)
          & (s1 > 1e-9))                                    # [B, 4]

    # camera-frame points + 3-point absolute orientation via orthonormal
    # triads (exact for minimal, noise-free triplets)
    Y1 = s1[..., None] * f1[:, None, :]                     # [B, 4, 3]
    Y2 = s2[..., None] * f2[:, None, :]
    Y3 = s3[..., None] * f3[:, None, :]

    def triad(p1, p2, p3):
        e1 = _normalized(p2 - p1, 1e-12)
        w = p3 - p1
        e2 = _normalized(w - (w * e1).sum(-1, keepdim=True) * e1, 1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)            # [..., 3, 3]

    Mw = triad(X1[:, None], X2[:, None], X3[:, None])       # [B, 1, 3, 3]
    Mc = triad(Y1, Y2, Y3)                                  # [B, 4, 3, 3]
    R = Mc @ Mw.transpose(-2, -1)
    t = Y1 - (R @ X1[:, None, :, None])[..., 0]
    ok = ok & torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
    return (R.reshape(4 * B, 3, 3), t.reshape(4 * B, 3), ok.reshape(4 * B))


def _dlt_batch(su, sx):
    """Minimal-sample DLT: ``su [B, m, 2]`` normalized rays, ``sx [B, m, 3]``
    3D points -> ``(R [B, 3, 3], t [B, 3], ok [B])``. The 3D points are
    centered and scaled per sample so the 12x12 normal matrix is well
    conditioned in float32; the null vector comes from inverse power
    iteration."""
    B, m, _ = su.shape
    c = sx.mean(1, keepdim=True)
    s = torch.clamp(torch.linalg.vector_norm(sx - c, dim=2).mean(1),
                    min=1e-9)
    xn = (sx - c) / s[:, None, None]
    xh = torch.cat([xn, torch.ones_like(xn[..., :1])], 2)
    z = torch.zeros_like(xh)
    r0 = torch.cat([xh, z, -su[:, :, 0:1] * xh], 2)
    r1 = torch.cat([z, xh, -su[:, :, 1:2] * xh], 2)
    A = torch.cat([r0, r1], 1)                              # [B, 2m, 12]
    G = A.transpose(1, 2) @ A
    P = _smallest_evec(G).reshape(B, 3, 4)
    # cheirality: homogeneous sign making the sample's projective depths > 0;
    # the median of an even count is the mean of the two middle values, as
    # jnp.median computes it (torch.median would take the lower one)
    w = (xh @ P[:, 2, :, None])[..., 0]
    flip = 1.0 - 2.0 * (torch.quantile(w, 0.5, dim=1) < 0).to(P.dtype)
    P = P * flip[:, None, None]
    M = P[:, :, :3]
    R = _project_so3(M)
    # RMS singular value ~ ||M||_F / sqrt(3) replaces S.mean
    scale = torch.clamp(torch.linalg.matrix_norm(M) / np.sqrt(3.0),
                        min=1e-12)
    tn = P[:, :, 3] / scale[:, None]
    # un-normalize: uv ~ R (x-c)/s + tn  =>  t = s*tn - R c (R scale-free)
    t = s[:, None] * tn - (R @ c[:, 0, :, None])[..., 0]
    ok = torch.abs(_det3(M)) > (1e-18 * torch.clamp(scale, min=1e-12) ** 3)
    return R, t, ok


def _plane_basis(xc):
    """Orthonormal (e1, e2, n) for the best-fit plane of centered points
    ``xc [B, N, 3]``: n the smallest eigenvector of the 3x3 scatter (inverse
    power iteration), e1/e2 a Gram-Schmidt completion."""
    C = xc.transpose(1, 2) @ xc
    n = _smallest_evec(C, iters=6)                          # [B, 3]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ax = torch.where(torch.abs(n[:, 0:1]) < 0.7, ex, ey)
    e1 = _normalized(ax - (ax * n).sum(-1, keepdim=True) * n, 1e-20)
    e2 = torch.linalg.cross(n, e1, dim=-1)
    return e1, e2, n


def _homography_batch(su, sx):
    """Planar-safe pose hypotheses (the device form of
    :func:`_homography_pose_batch`): per sample fit the best plane, fit
    uv ~ H [w, 1] by normalized DLT (inverse power iteration on the 9x9
    normal matrix), decompose H = [R e1, R e2, R c + t]."""
    B, N, _ = su.shape
    c = sx.mean(1, keepdim=True)
    xc = sx - c
    e1, e2, nrm = _plane_basis(xc)
    w = torch.stack([(xc * e1[:, None]).sum(-1), (xc * e2[:, None]).sum(-1)],
                    dim=-1)

    def norm_pts(p):
        m = p.mean(1, keepdim=True)
        s = np.sqrt(2.0) / torch.clamp(
            torch.linalg.vector_norm(p - m, dim=2).mean(1), min=1e-12)
        return (p - m) * s[:, None, None], m[:, 0], s

    wn, wm, ws = norm_pts(w)
    un, um, us = norm_pts(su)
    wh = torch.cat([wn, torch.ones_like(wn[..., :1])], -1)
    z = torch.zeros_like(wh)
    r0 = torch.cat([wh, z, -un[:, :, 0:1] * wh], 2)
    r1 = torch.cat([z, wh, -un[:, :, 1:2] * wh], 2)
    A = torch.cat([r0, r1], 1)                              # [B, 2N, 9]
    Hn = _smallest_evec(A.transpose(1, 2) @ A).reshape(B, 3, 3)
    zero = torch.zeros_like(us)
    one = torch.ones_like(us)
    Tu_inv = torch.stack([
        torch.stack([1.0 / us, zero, um[:, 0]], -1),
        torch.stack([zero, 1.0 / us, um[:, 1]], -1),
        torch.stack([zero, zero, one], -1)], 1)
    Tw = torch.stack([
        torch.stack([ws, zero, -ws * wm[:, 0]], -1),
        torch.stack([zero, ws, -ws * wm[:, 1]], -1),
        torch.stack([zero, zero, one], -1)], 1)
    H = Tu_inv @ Hn @ Tw
    H = H * (1.0 - 2.0 * (H[:, 2, 2] < 0).to(H.dtype))[:, None, None]
    lam = 2.0 / torch.clamp(torch.linalg.vector_norm(H[:, :, 0], dim=1)
                            + torch.linalg.vector_norm(H[:, :, 1], dim=1),
                            min=1e-12)
    H = H * lam[:, None, None]
    r1c, r2c = H[:, :, 0], H[:, :, 1]
    Q = torch.stack([r1c, r2c, torch.linalg.cross(r1c, r2c, dim=-1)], dim=-1)
    Qr = _project_so3(Q)       # det(Q) > 0 by the cross-product completion
    E = torch.stack([e1, e2, nrm], dim=-1)
    R = Qr @ E.transpose(1, 2)
    t = H[:, :, 2] - (R @ c[:, 0, :, None])[..., 0]
    # degenerate fits give non-finite or badly scoring hypotheses that the
    # scoring rejects
    ok = torch.isfinite(t).all(1) & torch.isfinite(R).all(2).all(1)
    return R, t, ok


# ---------------------------------------------------------------------------
# device: the RANSAC + LO program over a batch of queries
# ---------------------------------------------------------------------------

def _reproj_err_Rt(model, params, R, t, X, xy, valid):
    """``R [B, h, 3, 3]``, ``t [B, h, 3]`` -> errors ``[B, h, n]``, inf
    behind the camera and on invalid rows."""
    xc = R @ X[:, None].transpose(-2, -1) + t[..., None]    # [B, h, 3, n]
    zd = xc[:, :, 2]
    zs = torch.where(torch.abs(zd) < 1e-12, torch.full_like(zd, 1e-12), zd)
    uv = (xc[:, :, :2] / zs[:, :, None]).transpose(-2, -1)  # [B, h, n, 2]
    pix = img_from_cam(model, params[:, None, None, :], uv)
    err = torch.linalg.vector_norm(pix - xy[:, None], dim=-1)
    return torch.where((zd > 0) & valid[:, None], err,
                       torch.full_like(err, float("inf")))


def _reproj_err_q(model, params, q, t, X, xy, valid):
    """Errors ``[B, n]`` of the poses ``q [B, 4]``, ``t [B, 3]``."""
    P, qb, tb = params[:, None, :], q[:, None, :], t[:, None, :]
    pix = world_to_pixel(model, P, qb, tb, X)
    zd = calculate_depth(qb, tb, X)
    err = torch.linalg.vector_norm(pix - xy, dim=-1)
    return torch.where((zd > 0) & valid, err,
                       torch.full_like(err, float("inf")))


def _gn_refine(model, params, X, xy, q, t, w, iters: int):
    """``iters`` damped Gauss-Newton steps on the weighted reprojection cost
    of every query (closed-form pose Jacobian of ``project_with_jac``), each
    step kept only where it lowers the cost."""
    P = params[:, None, :]
    wv = w[..., None]

    def weighted_cost(q, t):
        proj = world_to_pixel(model, P, q[:, None], t[:, None], X)
        return 0.5 * (((proj - xy) * wv) ** 2).sum((-2, -1))

    lam = torch.full_like(q[:, 0], 1e-3)
    cost = weighted_cost(q, t)
    for _ in range(iters):
        pix, J_pose, _, _ = project_with_jac(model, P, q[:, None],
                                             t[:, None], X)
        r = (pix - xy) * wv                                 # [B, n, 2]
        J = (J_pose * wv[..., None]).flatten(1, 2)          # [B, 2n, 6]
        Hm = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r.flatten(1, 2)[..., None])[..., 0]
        D = torch.clamp(torch.diagonal(Hm, dim1=-2, dim2=-1), 1e-8, 1e32)
        L, info = torch.linalg.cholesky_ex(Hm + lam[:, None, None]
                                           * torch.diag_embed(D))
        d = -_chol_solve(L, g)
        d = torch.where((info == 0)[:, None], d,
                        torch.full_like(d, float("nan")))
        q_new = quat_normalize(quat_mul(exp_quat(d[:, :3]), q))
        t_new = t + d[:, 3:]
        new_cost = weighted_cost(q_new, t_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost) \
            & torch.isfinite(d).all(-1)
        q = torch.where(accept[:, None], q_new, q)
        t = torch.where(accept[:, None], t_new, t)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return q, t


def _pnp_core(model: str, X, xy, valid, params, samples, max_err: float,
              lo_rounds: int = 4, gn_iters: int = 8, families: str = "full"):
    """RANSAC + LO over ``B`` queries of ``n`` padded correspondences and
    ``H`` minimal samples (``pnp.py:787``): ``X [B, n, 3]``, ``xy [B, n, 2]``
    pixels, ``valid [B, n]``, ``params [B, k]``, ``samples [B, H, 6]``.
    Returns ``(q [B, 4], t [B, 3], inliers [B, n], count [B])``.

    ``families``: ``"full"``, 6H hypotheses per query (P3P's 4H, then the
    DLT's H, then the homography's H: ``argmax`` takes the first of tied
    counts, so the order is the JAX package's); ``"p3p"``, P3P's 4H only."""
    B, n, _ = X.shape
    H = samples.shape[1]
    uv = cam_from_img(model, params[:, None, :], xy)        # [B, n, 2]
    bi = torch.arange(B, device=X.device)[:, None, None]
    su = uv[bi, samples].reshape(B * H, 6, 2)
    sx = X[bi, samples].reshape(B * H, 6, 3)
    R0, t0_, ok0 = _p3p_batch(su, sx)
    R, t, ok = (R0.reshape(B, 4 * H, 3, 3), t0_.reshape(B, 4 * H, 3),
                ok0.reshape(B, 4 * H))
    if families != "p3p":
        R1, t1, ok1 = _dlt_batch(su, sx)
        R2, t2, ok2 = _homography_batch(su, sx)
        R = torch.cat([R, R1.reshape(B, H, 3, 3), R2.reshape(B, H, 3, 3)], 1)
        t = torch.cat([t, t1.reshape(B, H, 3), t2.reshape(B, H, 3)], 1)
        ok = torch.cat([ok, ok1.reshape(B, H), ok2.reshape(B, H)], 1)
    ok = ok & torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
    R = torch.where(ok[..., None, None], R,
                    torch.eye(3, dtype=R.dtype, device=R.device))
    t = torch.where(ok[..., None], t, torch.zeros_like(t))
    err = _reproj_err_Rt(model, params, R, t, X, xy, valid)  # [B, h, n]
    inl = (err < max_err) & ok[..., None]
    cnt = inl.sum(-1)
    best = torch.argmax(cnt, dim=1)
    ar = torch.arange(B, device=X.device)
    q0 = quat_normalize(rotmat_to_quat(R[ar, best]))
    t0 = t[ar, best]
    inl0 = inl[ar, best]
    cnt0 = cnt[ar, best]

    valid_f = valid.to(uv.dtype)
    q, tt, inl_m = q0, t0, inl0
    bq, bt, binl, bcnt = q0, t0, inl0, cnt0
    for _ in range(lo_rounds):
        w = inl_m.to(uv.dtype) * valid_f
        enough = w.sum(-1) >= 6.0
        q2, t2 = _gn_refine(model, params, X, xy, q, tt, w, gn_iters)
        # a refine on <6 points (or one that diverged) must not poison
        q2 = torch.where((enough & torch.isfinite(q2).all(-1))[:, None],
                         q2, q)
        t2 = torch.where((enough & torch.isfinite(t2).all(-1))[:, None],
                         t2, tt)
        inl2 = _reproj_err_q(model, params, q2, t2, X, xy, valid) < max_err
        cnt2 = inl2.sum(-1)
        better = cnt2 > bcnt
        bq = torch.where(better[:, None], q2, bq)
        bt = torch.where(better[:, None], t2, bt)
        binl = torch.where(better[:, None], inl2, binl)
        bcnt = torch.maximum(cnt2, bcnt)
        q, tt, inl_m = q2, t2, inl2
    return bq, bt, binl, bcnt


def _jacfwd_per_query(fn, D):
    """``(fn(D), J)`` for a function of ``D [B, NP]`` whose row b depends
    on ``D[b]`` alone: ``J [B, ..., NP]`` holds each query's own Jacobian.
    Forward mode with the NP unit tangents shared by all queries (one
    ``jvp`` per parameter, vmapped), where a plain ``jacfwd`` over the
    stacked ``D`` would push B * NP tangents."""
    NP = D.shape[-1]
    basis = torch.eye(NP, dtype=D.dtype, device=D.device)[:, None, :] \
        .expand(NP, *D.shape)
    out, cols = torch.func.vmap(
        lambda t: torch.func.jvp(fn, (D,), (t,)), out_dims=(None, 0))(basis)
    return out, cols.movedim(0, -1)


def _pose_refine_batch(model: str, params, q0, t0, X, xy, w, iters: int):
    """``iters`` damped Gauss-Newton steps on the weighted reprojection
    residuals of ``B`` queries (``_compiled_pose_refine`` of the JAX
    package): ``params [B, k]``, ``q0 [B, 4]``, ``t0 [B, 3]``, ``X [B, n,
    3]``, ``xy [B, n, 2]``, ``w [B, n]``. Returns ``(q, t, cost)``."""
    P = params[:, None, :]

    def residuals(D, q, t):
        qq = quat_normalize(quat_mul(exp_quat(D[:, :3]), q))
        tt = t + D[:, 3:]
        proj = world_to_pixel(model, P, qq[:, None], tt[:, None], X)
        return ((proj - xy) * w[..., None]).flatten(1)      # [B, 2n]

    B = q0.shape[0]
    zero = q0.new_zeros((B, 6))
    q, t = q0, t0
    lam = q0.new_full((B,), 1e-3)
    cost = 0.5 * (residuals(zero, q, t) ** 2).sum(-1)
    for _ in range(iters):
        r, J = _jacfwd_per_query(lambda D: residuals(D, q, t), zero)
        Hm = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        D = torch.clamp(torch.diagonal(Hm, dim1=-2, dim2=-1), 1e-8, 1e32)
        d = -torch.linalg.solve_ex(Hm + lam[:, None, None]
                                   * torch.diag_embed(D), g)[0]
        q_new = quat_normalize(quat_mul(exp_quat(d[:, :3]), q))
        t_new = t + d[:, 3:]
        new_cost = 0.5 * (residuals(zero, q_new, t_new) ** 2).sum(-1)
        accept = new_cost < cost
        q = torch.where(accept[:, None], q_new, q)
        t = torch.where(accept[:, None], t_new, t)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return q, t, cost


def pose_refinement(camera: Camera, qvec, tvec, X, xy, iters: int = 30,
                    device=None) -> Dict:
    """Pose-only damped Gauss-Newton on reprojection error (the refinement
    stage of ``pycolmap.absolute_pose_estimation``), float32 on ``device``
    (``cuda`` unless ``"cpu"`` is passed). The JAX package pads the points
    to a power-of-two bucket with weight-0 rows; eager torch needs no
    padding, so every weight is 1."""
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]

    X = np.asarray(X, np.float64).reshape(-1, 3)
    q, t, cost = _pose_refine_batch(
        camera.model, put(camera.params), put(qvec), put(tvec), put(X),
        put(np.asarray(xy).reshape(-1, 2)),
        torch.ones((1, len(X)), device=dev), iters)
    out = torch.cat([q[0], t[0], cost]).cpu().numpy().astype(np.float64)
    return dict(qvec=out[:4], tvec=out[4:7], cost=float(out[7]))


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

# Staged-RANSAC acceptance bar: a stage-1 (P3P-only) pose is final when its
# LO-refined consensus is BOTH large in absolute count and a healthy fraction
# of the correspondences; queries below the bar re-run the full
# P3P+DLT+homography program at full hypothesis count.
STAGE_ACCEPT_RATIO = 0.4
STAGE_MIN_INLIERS = 12
STAGE1_MAX_SAMPLES = 256  # w^3 clean-sample odds need fewer samples than w^6


def _stage_accept(cnt: int, n: int, min_inlier_ratio: float) -> bool:
    return (cnt >= max(6, STAGE_MIN_INLIERS)
            and cnt >= min_inlier_ratio * n
            and cnt >= STAGE_ACCEPT_RATIO * n)


def _run_pnp_groups(groups, H: int, max_error_px: float, rng, device,
                    families: str):
    """Pack and run one program per (model, size bucket) group.

    ``groups``: {(model, bucket): [(qi, xy, X, cam), ...]}; a group is
    padded to its largest query. One host-to-device copy per input and one
    device-to-host copy of all results per group. Returns {qi: (qvec_f64,
    tvec_f64, inliers[:n], cnt)}."""
    out = {}
    for (model, _), items in groups.items():
        B = len(items)
        n_max = max(len(it[1]) for it in items)
        X_b = np.zeros((B, n_max, 3), np.float32)
        X_b[..., 2] = 10.0
        xy_b = np.zeros((B, n_max, 2), np.float32)
        valid_b = np.zeros((B, n_max), bool)
        par_b = np.stack([np.asarray(it[3].params, np.float32)
                          for it in items])
        samp_b = np.zeros((B, H, 6), np.int64)
        for bi, (qi, xy, X, cam) in enumerate(items):
            n = len(xy)
            X_b[bi, :n] = X
            xy_b[bi, :n] = xy
            valid_b[bi, :n] = True
            samp_b[bi] = _gen_samples(rng, n, H)
        args = [torch.as_tensor(a).to(device)
                for a in (X_b, xy_b, valid_b, par_b, samp_b)]
        q, t, inl, cnt = _pnp_core(model, *args, float(max_error_px),
                                   families=families)
        res = torch.cat([q, t, cnt[:, None].to(q.dtype), inl.to(q.dtype)],
                        1).cpu().numpy()
        for bi, (qi, xy, X, cam) in enumerate(items):
            n = len(xy)
            out[qi] = (res[bi, :4].astype(np.float64),
                       res[bi, 4:7].astype(np.float64),
                       res[bi, 8:8 + n] > 0.5, int(res[bi, 7]))
    return out


def absolute_pose_estimation_batch(queries, max_error_px: float = 12.0,
                                   max_iterations: int = 1000,
                                   seed: int = 0,
                                   min_inlier_ratio: float = 0.0,
                                   polish: bool = True,
                                   mesh=None,
                                   staged: bool = True,
                                   device=None):
    """Batched RANSAC PnP: one program per (camera model, size bucket) group
    of the query batch, on ``device`` (``cuda`` unless ``"cpu"`` is passed).
    ``queries``: list of dicts with keys ``points2D`` [n,2], ``points3D``
    [n,3], ``camera``. Returns one {success, qvec, tvec, num_inliers,
    inliers} per query.

    ``staged`` (default): stage 1 runs the P3P-only program
    (<= ``STAGE1_MAX_SAMPLES`` samples) for all queries; queries whose LO
    consensus misses :func:`_stage_accept` run the full program at the full
    sample count. The device loop is float32; with ``polish`` the pose is
    re-refined on the inlier set by the float64 host Gauss-Newton
    (:func:`finalize_device_pose`). ``mesh`` (fan-out over devices) is not
    ported."""
    if mesh is not None:
        raise NotImplementedError(
            "the PnP mesh fan-out over devices is not ported yet; see "
            "ROADMAP.md section 1, 'Sharding'")
    dev = resolve_device(device)
    H = int(min(512, max(64, bucket(min(max_iterations, 512), minimum=64))))
    rng = np.random.default_rng(seed)
    results: list = [None] * len(queries)
    groups: Dict[tuple, list] = {}
    sizes: Dict[int, int] = {}
    for qi, q in enumerate(queries):
        xy = np.asarray(q["points2D"], np.float64).reshape(-1, 2)
        X = np.asarray(q["points3D"], np.float64).reshape(-1, 3)
        n = len(xy)
        if n < 6:
            results[qi] = dict(success=False, num_inliers=0,
                               inliers=np.zeros(n, bool))
            continue
        cam = q["camera"]
        sizes[qi] = n
        groups.setdefault((cam.model, bucket(n, minimum=16)), []).append(
            (qi, xy, X, cam))

    item_of = {it[0]: it for items in groups.values() for it in items}
    if staged:
        poses = _run_pnp_groups(groups, min(H, STAGE1_MAX_SAMPLES),
                                max_error_px, rng, dev, "p3p")
        retry: Dict[tuple, list] = {}
        for key, items in groups.items():
            for it in items:
                qi = it[0]
                if not _stage_accept(poses[qi][3], sizes[qi],
                                     min_inlier_ratio):
                    retry.setdefault(key, []).append(it)
        if retry:
            logger.debug("PnP stage 2: %d/%d queries below the P3P "
                         "acceptance bar, running full program.",
                         sum(len(v) for v in retry.values()), len(item_of))
            poses.update(_run_pnp_groups(retry, H, max_error_px, rng, dev,
                                         "full"))
    else:
        poses = _run_pnp_groups(groups, H, max_error_px, rng, dev, "full")

    for qi, (qv, tv, inl, cnt) in poses.items():
        _, xy, X, cam = item_of[qi]
        results[qi] = finalize_device_pose(
            cam, qv, tv, inl, cnt, xy, X, max_error_px, polish=polish,
            min_inlier_ratio=min_inlier_ratio)
    return results


def finalize_device_pose(cam, qvec, tvec, inliers, num_inliers, xy, X,
                         max_error_px: float, polish: bool = True,
                         min_inlier_ratio: float = 0.0) -> Dict:
    """Host-side finalization of a device RANSAC pose: success checks and
    the optional float64 polish on the winning inlier set, a Cauchy loss at
    the scale 1.48 * MAD of the inlier residuals (at least 1 px); the
    polished pose is kept only if it does not shrink the consensus set."""
    n = len(xy)
    qvec = np.asarray(qvec, np.float64)
    ni = int(num_inliers)
    if ni < 6 or ni < min_inlier_ratio * n or not np.isfinite(qvec).all():
        return dict(success=False, num_inliers=0, inliers=np.zeros(n, bool))
    qv = qvec / np.linalg.norm(qvec)
    tv = np.asarray(tvec, np.float64)
    inl = np.asarray(inliers).astype(bool)
    if polish:
        err0 = _reproj_errors(cam, qv, tv, X, xy)
        scale = max(1.0, 1.48 * float(np.median(err0[inl])))
        ref = _pose_refinement_np(cam, qv, tv, X[inl], xy[inl],
                                  loss_scale_px=scale)
        err_p = _reproj_errors(cam, ref["qvec"], ref["tvec"], X, xy)
        inl_p = err_p < max_error_px
        ni_p = int(inl_p.sum())
        if ni_p >= ni:
            qv, tv, inl, ni = ref["qvec"], ref["tvec"], inl_p, ni_p
    return dict(success=True, qvec=qv, tvec=tv, num_inliers=ni, inliers=inl)


def absolute_pose_estimation(points2D: np.ndarray, points3D: np.ndarray,
                             camera: Camera, max_error_px: float = 12.0,
                             min_inlier_ratio: float = 0.01,
                             max_iterations: int = 1000,
                             confidence: float = 0.9999,
                             seed: int = 0, polish: bool = True,
                             device=None) -> Dict:
    """RANSAC PnP of one query (:func:`absolute_pose_estimation_batch` with
    a batch of one). Returns {success, qvec, tvec, num_inliers, inliers}.
    The hypothesis count is fixed at min(max_iterations, 512) samples, all
    scored in one program: ``confidence`` caps nothing and is accepted for
    signature compatibility; ``min_inlier_ratio`` is enforced post hoc."""
    xy = np.asarray(points2D, np.float64).reshape(-1, 2)
    n = len(xy)
    if n < 6:
        return dict(success=False, num_inliers=0, inliers=np.zeros(n, bool))
    return absolute_pose_estimation_batch(
        [dict(points2D=points2D, points3D=points3D, camera=camera)],
        max_error_px=max_error_px, max_iterations=max_iterations,
        seed=seed, min_inlier_ratio=min_inlier_ratio, polish=polish,
        device=device)[0]


def _absolute_pose_estimation_host(points2D: np.ndarray, points3D: np.ndarray,
                                   camera: Camera, max_error_px: float = 12.0,
                                   min_inlier_ratio: float = 0.01,
                                   max_iterations: int = 1000,
                                   confidence: float = 0.9999,
                                   seed: int = 0) -> Dict:
    """Host-numpy RANSAC PnP (float64, adaptive termination; the rays come
    from a float32 undistortion, as in the JAX package): the plain version
    the device program is held to."""
    xy = np.asarray(points2D, np.float64).reshape(-1, 2)
    X = np.asarray(points3D, np.float64).reshape(-1, 3)
    n = len(xy)
    if n < 6:
        return dict(success=False, num_inliers=0, inliers=np.zeros(n, bool))

    uv = _cam_from_img32(camera, xy)

    rng = np.random.default_rng(seed)
    best = dict(num_inliers=0, inliers=np.zeros(n, bool), qvec=None,
                tvec=None)
    # batched RANSAC: all minimal-sample DLTs solved with one batched SVD,
    # scoring vectorized per batch of hypotheses
    BATCH = 128
    tried = 0
    max_iter = max_iterations
    while tried < max_iter:
        b = min(BATCH, max_iter - tried)
        tried += b
        samples = np.stack([rng.choice(n, 6, replace=False)
                            for _ in range(b)])
        # two hypothesis families per sample: 11-DoF DLT (general scenes)
        # and homography decomposition (planar scenes)
        Rs, ts, ok = _dlt_pose_batch(uv[samples], X[samples])
        Rh, th, okh = _homography_pose_batch(uv[samples], X[samples])
        for Rc, tc, okc in ((Rs, ts, ok), (Rh, th, okh)):
            for bi in np.nonzero(okc)[0]:
                err = _reproj_errors_Rt(camera, Rc[bi], tc[bi], X, xy)
                inl = err < max_error_px
                ni = int(inl.sum())
                if ni > best["num_inliers"]:
                    qvec = _rotmat_to_quat_np(Rc[bi])
                    best = dict(num_inliers=ni, inliers=inl, qvec=qvec,
                                tvec=tc[bi])
                    ratio = max(ni / n, min_inlier_ratio)
                    denom = np.log(max(1.0 - ratio ** 6, 1e-12))
                    if denom < 0:
                        max_iter = min(max_iterations,
                                       int(np.ceil(np.log(1 - confidence)
                                                   / denom)))
    if best["num_inliers"] < 6:
        return dict(success=False, num_inliers=0, inliers=np.zeros(n, bool))

    # LO-RANSAC: refine on the inlier set and re-expand it until the
    # consensus stops growing (COLMAP's LORANSAC equivalent)
    inl = best["inliers"]
    qv, tv = best["qvec"], best["tvec"]
    best_lo = (int(inl.sum()), qv, tv, inl)
    for _ in range(8):
        ref = _pose_refinement_np(camera, qv, tv, X[inl], xy[inl])
        qv, tv = ref["qvec"], ref["tvec"]
        err = _reproj_errors(camera, qv, tv, X, xy)
        new_inl = err < max_error_px
        ni = int(new_inl.sum())
        if ni > best_lo[0]:
            best_lo = (ni, qv, tv, new_inl)
        if ni <= int(inl.sum()):
            break
        inl = new_inl
    ni, qv, tv, inl = best_lo
    return dict(success=True, qvec=qv, tvec=tv,
                num_inliers=ni, inliers=inl)
