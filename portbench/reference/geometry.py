"""Plain float64 camera geometry: COLMAP quaternions (w, x, y, z), the
SIMPLE_RADIAL / SIMPLE_PINHOLE / PINHOLE projections, the DLT.

Written from COLMAP's camera models; it shares no code with the program.
"""

from __future__ import annotations

import numpy as np


def quat_to_rotmat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rotmat_to_quat(R) -> np.ndarray:
    """Shepperd's method; the sign makes w >= 0."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = 2.0 * np.sqrt(1.0 + t)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q, np.float64)
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def small_rotation(phi) -> np.ndarray:
    """The quaternion of the rotation vector ``phi``."""
    phi = np.asarray(phi, np.float64)
    a = np.linalg.norm(phi)
    if a < 1e-15:
        q = np.array([1.0, *(0.5 * phi)])
        return q / np.linalg.norm(q)
    return np.concatenate([[np.cos(a / 2)], np.sin(a / 2) * phi / a])


def quat_mul(a, b) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def look_at(eye, target) -> np.ndarray:
    """Rows: the camera's x, y, z axes in world coordinates (y down)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


# per camera model, the indices of its parameters of each kind (COLMAP's
# camera models)
PARAMS = {
    "SIMPLE_PINHOLE": {"focal": (0,), "principal_point": (1, 2),
                       "extra": ()},
    "PINHOLE": {"focal": (0, 1), "principal_point": (2, 3), "extra": ()},
    "SIMPLE_RADIAL": {"focal": (0,), "principal_point": (1, 2),
                      "extra": (3,)},
}


def img_from_cam(model: str, params, uv) -> np.ndarray:
    """Normalized camera-plane points ``uv [N, 2]`` to pixels."""
    p = np.asarray(params, np.float64)
    u, v = uv[:, 0], uv[:, 1]
    if model == "SIMPLE_PINHOLE":
        return np.stack([p[0] * u + p[1], p[0] * v + p[2]], 1)
    if model == "PINHOLE":
        return np.stack([p[0] * u + p[2], p[1] * v + p[3]], 1)
    if model == "SIMPLE_RADIAL":
        d = 1.0 + p[3] * (u * u + v * v)
        return np.stack([p[0] * u * d + p[1], p[0] * v * d + p[2]], 1)
    raise ValueError(f"model {model} is not in the plain reference")


def project(model: str, params, qvec, tvec, X):
    """``(xy [N, 2], depth [N])`` of world points ``X [N, 3]``."""
    Xc = np.atleast_2d(X) @ quat_to_rotmat(qvec).T + np.asarray(tvec)
    z = Xc[:, 2]
    uv = Xc[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None]
    return img_from_cam(model, params, uv), z
