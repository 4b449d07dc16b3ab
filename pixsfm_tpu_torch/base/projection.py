"""Projection helpers (reference: pixsfm/base/src/projection.h).

Port of ``pixsfm_tpu/base/projection.py`` in torch (broadcasting over
leading axes), plus :func:`project_np`, the float64 numpy projection of a
whole image's points that host code uses (a copy of the JAX package's
``localization/pnp.py:project_np``).
"""

from __future__ import annotations

import numpy as np
import torch

from .cameras import CAMERA_MODELS, Camera, img_from_cam, img_from_cam_with_jac
from .geometry import apply_pose, quat_to_rotmat_np

__all__ = ["project_with_jac", "world_to_pixel", "calculate_depth",
           "project_np", "reproj_errors_np"]


def project_with_jac(model: str, cam_params, qvec, tvec, X, z_eps=1e-8):
    """World point -> pixel, with the closed-form observation Jacobian.

    Returns ``(pix [..., 2], J_pose [..., 2, 6], J_cam [..., 2, k],
    J_X [..., 2, 3])`` for the LM tangent ``[omega(3), dt(3)]`` applied as
    ``q' = exp(omega) q, t' = t + dt``: ``d x_cam/d omega = -[R X]_x``,
    ``d x_cam/dt = I``, ``d x_cam/dX = R``, composed with the perspective
    divide and the camera model's analytic derivative. Written scalar-
    expanded over the last axis like the JAX form (``:21``), so a batch of
    observations is plain elementwise vector work."""
    w, x, y, z = qvec.unbind(-1)
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    R = ((1.0 - (yy + zz), xy - wz, xz + wy),
         (xy + wz, 1.0 - (xx + zz), yz - wx),
         (xz - wy, yz + wx, 1.0 - (xx + yy)))
    X0, X1, X2 = X.unbind(-1)
    RX = [R[i][0] * X0 + R[i][1] * X1 + R[i][2] * X2 for i in range(3)]
    xc = [RX[i] + tvec[..., i] for i in range(3)]
    zc = torch.where(torch.abs(xc[2]) < z_eps,
                     torch.full_like(xc[2], z_eps), xc[2])
    iz = 1.0 / zc
    u, v = xc[0] * iz, xc[1] * iz
    pix, J_uv, J_cam = img_from_cam_with_jac(model, cam_params,
                                             torch.stack([u, v], dim=-1))
    Juv = ((J_uv[..., 0, 0], J_uv[..., 0, 1]),
           (J_uv[..., 1, 0], J_uv[..., 1, 1]))
    # A = J_uv @ duv/dx_cam, duv/dx_cam = [[iz, 0, -u iz], [0, iz, -v iz]]
    A = [[Juv[i][0] * iz, Juv[i][1] * iz,
          -(Juv[i][0] * u + Juv[i][1] * v) * iz] for i in range(2)]
    a, b, c = RX
    # J_w = -A @ skew(RX); skew = [[0,-c,b],[c,0,-a],[-b,a,0]]
    Jw = [[-(A[i][1] * c - A[i][2] * b),
           -(-A[i][0] * c + A[i][2] * a),
           -(A[i][0] * b - A[i][1] * a)] for i in range(2)]
    JX = [[A[i][0] * R[0][j] + A[i][1] * R[1][j] + A[i][2] * R[2][j]
           for j in range(3)] for i in range(2)]
    J_pose = torch.stack([torch.stack(Jw[i] + A[i], dim=-1)
                          for i in range(2)], dim=-2)
    J_X = torch.stack([torch.stack(JX[i], dim=-1) for i in range(2)], dim=-2)
    return pix, J_pose, J_cam, J_X


def world_to_pixel(model: str, cam_params, qvec, tvec, X):
    """Project world point(s) to pixel coords (projection.h:60-75)."""
    x_cam = apply_pose(qvec, tvec, X)
    return img_from_cam(model, cam_params, x_cam[..., :2] / x_cam[..., 2:3])


def calculate_depth(qvec, tvec, X):
    """Depth of world point(s) in the camera frame (projection.h:20-38)."""
    return apply_pose(qvec, tvec, X)[..., 2]


def project_np(camera: Camera, qvec, tvec, X):
    """float64 numpy projection of many points into one image (forward
    distortion only): ``(xy [N, 2], depth [N])``."""
    R = quat_to_rotmat_np(qvec)
    x_cam = (R @ np.atleast_2d(X).T).T + np.asarray(tvec)
    z = x_cam[:, 2]
    uv = x_cam[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None]
    if camera.model not in CAMERA_MODELS or camera.model == "OPENCV_FISHEYE":
        raise ValueError(f"unsupported model {camera.model}")
    return camera.img_from_cam(uv), z


def reproj_errors_np(camera: Camera, qvec, tvec, X, xy) -> np.ndarray:
    """Reprojection errors in pixels; points behind the camera are inf."""
    proj, depths = project_np(camera, qvec, tvec, X)
    err = np.linalg.norm(proj - xy, axis=1)
    err[depths <= 0] = np.inf
    return err
