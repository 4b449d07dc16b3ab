"""COLMAP-compatible camera models in torch, with analytic Jacobians.

Port of ``pixsfm_tpu/base/cameras.py``: each model maps normalized camera
coordinates ``(u, v) = (x/z, y/z)`` to pixels (``img_from_cam``, COLMAP
``WorldToImage``), with closed-form Jacobians for the BA residuals, and
back (``cam_from_img``, COLMAP ``ImageToWorld``), where the inverse
distortion is a fixed number of Newton steps with the closed-form 2x2
distortion Jacobian. Every function broadcasts over leading axes:
``params [..., k]``, ``uv [..., 2]``.

====  ====================  =========================================
 id   name                  params
====  ====================  =========================================
 0    SIMPLE_PINHOLE        f, cx, cy
 1    PINHOLE               fx, fy, cx, cy
 2    SIMPLE_RADIAL         f, cx, cy, k
 3    RADIAL                f, cx, cy, k1, k2
 4    OPENCV                fx, fy, cx, cy, k1, k2, p1, p2
 5    OPENCV_FISHEYE        fx, fy, cx, cy, k1, k2, k3, k4
====  ====================  =========================================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = [
    "CAMERA_MODELS", "CAMERA_MODEL_IDS", "CameraModelSpec", "Camera",
    "img_from_cam", "cam_from_img", "distort_with_jac",
    "img_from_cam_with_jac", "focal_param_idxs", "principal_point_idxs",
    "extra_param_idxs",
]


NEWTON_UNDISTORT_ITERS = 25


@dataclass(frozen=True)
class CameraModelSpec:
    model_id: int
    name: str
    num_params: int
    focal_idxs: Tuple[int, ...]
    pp_idxs: Tuple[int, ...]
    extra_idxs: Tuple[int, ...]


_SPECS: List[CameraModelSpec] = [
    CameraModelSpec(0, "SIMPLE_PINHOLE", 3, (0,), (1, 2), ()),
    CameraModelSpec(1, "PINHOLE", 4, (0, 1), (2, 3), ()),
    CameraModelSpec(2, "SIMPLE_RADIAL", 4, (0,), (1, 2), (3,)),
    CameraModelSpec(3, "RADIAL", 5, (0,), (1, 2), (3, 4)),
    CameraModelSpec(4, "OPENCV", 8, (0, 1), (2, 3), (4, 5, 6, 7)),
    CameraModelSpec(5, "OPENCV_FISHEYE", 8, (0, 1), (2, 3), (4, 5, 6, 7)),
]

CAMERA_MODELS: Dict[str, CameraModelSpec] = {s.name: s for s in _SPECS}
CAMERA_MODEL_IDS: Dict[int, CameraModelSpec] = {s.model_id: s for s in _SPECS}


def focal_param_idxs(model: str) -> Tuple[int, ...]:
    return CAMERA_MODELS[model].focal_idxs


def principal_point_idxs(model: str) -> Tuple[int, ...]:
    return CAMERA_MODELS[model].pp_idxs


def extra_param_idxs(model: str) -> Tuple[int, ...]:
    return CAMERA_MODELS[model].extra_idxs


def _focal_pp(model: str, params):
    spec = CAMERA_MODELS[model]
    fx = params[..., spec.focal_idxs[0]]
    fy = params[..., spec.focal_idxs[-1]]
    return fx, fy, params[..., spec.pp_idxs[0]], params[..., spec.pp_idxs[1]]


def distort_with_jac(model: str, params, uv):
    """Distortion with hand-written Jacobians.

    Returns ``(d [..., 2], J_uv [..., 2, 2], J_extra [..., 2, n_extra])``:
    the distorted normalized coordinates, ``dd/duv`` and the columns of the
    model's extra (distortion) parameters."""
    u, v = uv[..., 0], uv[..., 1]
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)

    def mat2(a, b, c, d):
        return torch.stack([torch.stack([a, b], -1),
                            torch.stack([c, d], -1)], -2)

    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return uv, mat2(one, zero, zero, one), uv.new_zeros(uv.shape + (0,))
    r2 = u * u + v * v
    if model in ("SIMPLE_RADIAL", "RADIAL"):
        if model == "SIMPLE_RADIAL":
            k = params[..., 3]
            radial = 1.0 + k * r2
            drad = k
            J_extra = (uv * r2[..., None])[..., None]
        else:
            k1, k2 = params[..., 3], params[..., 4]
            radial = 1.0 + r2 * (k1 + k2 * r2)
            drad = k1 + 2.0 * k2 * r2
            J_extra = torch.stack([uv * r2[..., None],
                                   uv * (r2 * r2)[..., None]], dim=-1)
        J_uv = mat2(radial + 2.0 * drad * u * u, 2.0 * drad * u * v,
                    2.0 * drad * u * v, radial + 2.0 * drad * v * v)
        return uv * radial[..., None], J_uv, J_extra
    if model == "OPENCV":
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        radial = 1.0 + r2 * (k1 + k2 * r2)
        drad = k1 + 2.0 * k2 * r2
        du = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        dv = v * radial + p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
        ddu_du = radial + 2.0 * u * u * drad + 2.0 * p1 * v + 6.0 * p2 * u
        ddv_dv = radial + 2.0 * v * v * drad + 6.0 * p1 * v + 2.0 * p2 * u
        off = 2.0 * u * v * drad + 2.0 * p1 * u + 2.0 * p2 * v
        J_extra = torch.stack([
            torch.stack([u * r2, u * r2 * r2, 2.0 * u * v, r2 + 2.0 * u * u],
                        -1),
            torch.stack([v * r2, v * r2 * r2, r2 + 2.0 * v * v, 2.0 * u * v],
                        -1)], -2)
        return (torch.stack([du, dv], -1), mat2(ddu_du, off, off, ddv_dv),
                J_extra)
    if model == "OPENCV_FISHEYE":
        k1, k2 = params[..., 4], params[..., 5]
        k3, k4 = params[..., 6], params[..., 7]
        r = torch.sqrt(torch.clamp(r2, min=1e-24))
        theta = torch.atan(r)
        t2 = theta * theta
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        theta_d = theta * poly
        scale = torch.where(r > 1e-8, theta_d / r, one)
        dtd_dt = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (
            7.0 * k3 + t2 * 9.0 * k4)))
        dt_dr = 1.0 / (1.0 + r2)
        # d(scale)/dr / r, with the r -> 0 limit 2 (k1 - 1/3)
        ds = torch.where(r > 1e-6, dtd_dt * dt_dr / r2 - theta_d / (r2 * r),
                         2.0 * (k1 - 1.0 / 3.0))
        J_uv = mat2(scale + ds * u * u, ds * u * v, ds * u * v,
                    scale + ds * v * v)
        tpow = torch.where(r > 1e-8, 1.0 / r, zero)[..., None] * torch.stack(
            [theta ** 3, theta ** 5, theta ** 7, theta ** 9], -1)
        J_extra = uv[..., :, None] * tpow[..., None, :]
        return uv * scale[..., None], J_uv, J_extra
    raise ValueError(f"unknown camera model {model}")


def img_from_cam(model: str, params, uv):
    """Normalized camera coords (..., 2) -> pixel coords (..., 2)."""
    d = distort_with_jac(model, params, uv)[0]
    fx, fy, cx, cy = _focal_pp(model, params)
    return torch.stack([fx * d[..., 0] + cx, fy * d[..., 1] + cy], dim=-1)


def _undistort(model: str, params, uv_dist):
    """Inverse of the distortion by ``NEWTON_UNDISTORT_ITERS`` Newton steps
    from the distorted point, each a 2x2 Cramer solve with the determinant
    kept away from 0 (``pixsfm_tpu/base/cameras.py:118-146``). The step
    count is fixed, as in the JAX package: a tolerance would move the
    keypoints that feed the triangulation."""
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return uv_dist
    x = uv_dist
    for _ in range(NEWTON_UNDISTORT_ITERS):
        d, J, _ = distort_with_jac(model, params, x)
        r = d - uv_dist
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(torch.abs(det) < 1e-18,
                          torch.full_like(det, 1e-18), det)
        x = x - torch.stack([
            (J[..., 1, 1] * r[..., 0] - J[..., 0, 1] * r[..., 1]) / det,
            (J[..., 0, 0] * r[..., 1] - J[..., 1, 0] * r[..., 0]) / det],
            dim=-1)
    return x


def cam_from_img(model: str, params, xy):
    """Pixel coords (..., 2) -> normalized camera coords (..., 2). COLMAP
    ``ImageToWorld``."""
    fx, fy, cx, cy = _focal_pp(model, params)
    uv_dist = torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy],
                          dim=-1)
    return _undistort(model, params, uv_dist)


def img_from_cam_with_jac(model: str, params, uv):
    """``img_from_cam`` with analytic Jacobians: ``(pix [..., 2],
    J_uv [..., 2, 2], J_cam [..., 2, k])``, the columns of all k camera
    parameters filled per the model's layout."""
    spec = CAMERA_MODELS[model]
    d, Jd_uv, Jd_extra = distort_with_jac(model, params, uv)
    fx, fy, cx, cy = _focal_pp(model, params)
    f = torch.stack([fx, fy], dim=-1)
    pix = f * d + torch.stack([cx, cy], dim=-1)
    J_uv = f[..., :, None] * Jd_uv
    J_cam = uv.new_zeros(uv.shape[:-1] + (2, spec.num_params))
    if len(spec.focal_idxs) == 1:
        J_cam[..., :, spec.focal_idxs[0]] = d
    else:
        J_cam[..., 0, spec.focal_idxs[0]] = d[..., 0]
        J_cam[..., 1, spec.focal_idxs[1]] = d[..., 1]
    J_cam[..., 0, spec.pp_idxs[0]] = 1.0
    J_cam[..., 1, spec.pp_idxs[1]] = 1.0
    if spec.extra_idxs:
        # a slice (the extra parameters are contiguous in every model): a
        # list index would copy an index tensor to the device at each call
        J_cam[..., spec.extra_idxs[0]:spec.extra_idxs[-1] + 1] = \
            f[..., :, None] * Jd_extra
    return pix, J_uv, J_cam


@dataclass
class Camera:
    """Host-side camera (COLMAP Reconstruction camera record)."""
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def __post_init__(self):
        self.params = np.asarray(self.params, dtype=np.float64)
        spec = CAMERA_MODELS[self.model]
        if len(self.params) != spec.num_params:
            raise ValueError(f"{self.model} expects {spec.num_params} "
                             f"params, got {len(self.params)}")

    @property
    def model_id(self) -> int:
        return CAMERA_MODELS[self.model].model_id

    @property
    def mean_focal_length(self) -> float:
        idxs = CAMERA_MODELS[self.model].focal_idxs
        return float(np.mean([self.params[i] for i in idxs]))

    def img_from_cam(self, uv) -> np.ndarray:
        return img_from_cam(self.model, torch.as_tensor(self.params),
                            torch.as_tensor(np.asarray(uv, np.float64))
                            ).numpy()

    def cam_from_img(self, xy) -> np.ndarray:
        return cam_from_img(self.model, torch.as_tensor(self.params),
                            torch.as_tensor(np.asarray(xy, np.float64))
                            ).numpy()
