"""Quaternion / SO(3) utilities (COLMAP conventions), in torch and numpy.

Port of ``pixsfm_tpu/base/geometry.py``. COLMAP stores world-to-camera
rotations as ``qvec = [w, x, y, z]`` and translations ``tvec`` with
``x_cam = R(qvec) @ x_world + tvec``. The torch functions broadcast over
leading axes; the ``*_np`` helpers are the float64 host-side forms used by
the numpy data model (``sfm/``) and the projection of whole images.

Pose updates in the BA solver use a left-multiplicative so(3) perturbation
``q' = exp_quat(delta) * q`` (reference:
pixsfm/bundle_adjustment/src/bundle_optimizer.h:366-397).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "quat_normalize", "quat_mul", "quat_conj", "quat_rotate",
    "quat_to_rotmat", "rotmat_to_quat", "exp_quat", "log_quat",
    "apply_pose", "invert_pose", "pose_update", "angle_between_quats",
    "quat_to_rotmat_np", "rotmat_to_quat_np", "exp_quat_np",
    "qvec_from_numpy",
]


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product, [w,x,y,z] convention."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q, v):
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:].expand(v.shape)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_to_rotmat(q):
    w, x, y, z = q.unbind(-1)
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def rotmat_to_quat(R):
    """Shepperd's method (numerically stable), returns [w,x,y,z] with w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2

    s0 = root(tr + 1.0)
    c0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = root(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = root(1.0 + m11 - m00 - m22)
    c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = root(1.0 + m22 - m00 - m11)
    c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                      (m12 + m21) / s3, 0.25 * s3], dim=-1)
    use0 = tr > 0
    use1 = (~use0) & (m00 >= m11) & (m00 >= m22)
    use2 = (~use0) & (~use1) & (m11 >= m22)
    q = torch.where(use0[..., None], c0,
                    torch.where(use1[..., None], c1,
                                torch.where(use2[..., None], c2, c3)))
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def exp_quat(phi):
    """so(3) tangent (..., 3) -> unit quaternion; small-angle safe (the
    Taylor branch below theta^2 = 1e-12, as the JAX package)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def log_quat(q):
    """Unit quaternion -> so(3) tangent (..., 3)."""
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-9, torch.full_like(vn, 2.0),
                        theta / torch.clamp(vn, min=1e-12))
    return scale[..., None] * q[..., 1:]


def apply_pose(qvec, tvec, X):
    """World point -> camera frame: R(q) X + t."""
    return quat_rotate(qvec, X) + tvec


def invert_pose(qvec, tvec):
    """The camera-to-world pose ``(q^-1, -R(q^-1) t)``."""
    qinv = quat_conj(quat_normalize(qvec))
    return qinv, -quat_rotate(qinv, tvec)


def pose_update(qvec, tvec, delta):
    """Apply 6-DoF tangent delta = [dphi(3), dt(3)]: q'=exp(dphi)q, t'=t+dt."""
    q_new = quat_normalize(quat_mul(exp_quat(delta[..., :3]), qvec))
    return q_new, tvec + delta[..., 3:]


def angle_between_quats(q1, q2):
    """Rotation angle between two orientations, in radians."""
    d = torch.abs(torch.sum(quat_normalize(q1) * quat_normalize(q2), dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))


# ---------------------------------------------------------------------------
# float64 numpy forms (host-side data model)
# ---------------------------------------------------------------------------

def quat_to_rotmat_np(q) -> np.ndarray:
    """Rotation matrix of a (normalized) quaternion, float64."""
    return quat_to_rotmat(torch.as_tensor(qvec_from_numpy(q))).numpy()


def rotmat_to_quat_np(R) -> np.ndarray:
    return rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float64))).numpy()


def exp_quat_np(phi) -> np.ndarray:
    return exp_quat(torch.as_tensor(np.asarray(phi, np.float64))).numpy()


def qvec_from_numpy(q) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q)
