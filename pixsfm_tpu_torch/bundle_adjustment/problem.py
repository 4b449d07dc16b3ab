"""BA problem setup and host-side packing (copy of
``pixsfm_tpu/bundle_adjustment/problem.py``, numpy only; reference:
pixsfm/bundle_adjustment/src/bundle_adjustment_options.h:28-42 + bundle_optimizer.h
problem assembly :139-165, :247-313).

``BundleAdjustmentSetup`` mirrors colmap::BundleAdjustmentConfig semantics: image set,
constant poses, constant tvec coordinates (gauge fixing), variable/constant points.
``pack_ba_problem`` flattens a Reconstruction into the arrays
:func:`pixsfm_tpu_torch.ops.schur.ba_solve` consumes. Observations from registered images
outside the image set are added with constant pose when they observe a variable point
(AddPointToProblem path, bundle_optimizer.h:283-313).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..base.cameras import CAMERA_MODELS
from ..sfm.model import Reconstruction

__all__ = ["BundleAdjustmentSetup", "default_problem_setup", "PackedBA",
           "pack_ba_problem", "find_problem_labels"]


class BundleAdjustmentSetup:
    """Which images/points participate and what stays constant."""

    def __init__(self):
        self.image_ids: Set[int] = set()
        self.constant_poses: Set[int] = set()
        self.constant_tvecs: Dict[int, List[int]] = {}
        self.variable_points: Set[int] = set()
        self.constant_points: Set[int] = set()

    # colmap-like API
    def add_image(self, image_id: int):
        self.image_ids.add(image_id)

    def add_images(self, image_ids):
        self.image_ids.update(int(i) for i in image_ids)

    def set_constant_pose(self, image_id: int):
        self.constant_poses.add(image_id)

    def set_constant_tvec(self, image_id: int, coords: Sequence[int]):
        self.constant_tvecs[image_id] = list(coords)

    def add_variable_point(self, point3D_id: int):
        self.variable_points.add(point3D_id)

    def add_constant_point(self, point3D_id: int):
        self.constant_points.add(point3D_id)

    def has_image(self, image_id: int) -> bool:
        return image_id in self.image_ids


def default_problem_setup(reconstruction: Reconstruction
                          ) -> BundleAdjustmentSetup:
    """All registered images; first pose constant; tvec[0] of the second constant
    — fixes the 7-DoF gauge (reference: ba/main.py:12-18)."""
    setup = BundleAdjustmentSetup()
    reg = [im.image_id for im in reconstruction.images.values()
           if im.registered]
    reg.sort()
    setup.add_images(reg)
    if reg:
        setup.set_constant_pose(reg[0])
    if len(reg) > 1:
        setup.set_constant_tvec(reg[1], [0])
    return setup


def find_problem_labels(reconstruction: Reconstruction,
                        max_tracks_per_problem: int) -> Dict[int, int]:
    """p3D -> problem bin (fixed-size binning, reference ba/main.py:21-27).
    Used to chunk reference/costmap extraction, not the BA solve itself."""
    labels = {}
    for i, pid in enumerate(sorted(reconstruction.points3D.keys())):
        labels[pid] = i // max(max_tracks_per_problem, 1)
    return labels


@dataclass
class PackedBA:
    """Flat arrays for the Schur solver + bookkeeping to write results back."""
    qvec: np.ndarray         # [I, 4]
    tvec: np.ndarray         # [I, 3]
    cams: np.ndarray         # [Nc, k] (params padded to the widest model)
    xyz: np.ndarray          # [Np, 3]
    cam_model: str           # first model (the only one when homogeneous)
    cam_models: tuple        # all distinct models, sorted
    cam_model_idx: np.ndarray  # [Nc] index into cam_models
    # observations
    obs_img: np.ndarray      # [O] image slot
    obs_cam: np.ndarray      # [O] camera slot
    obs_pt: np.ndarray       # [O] point slot
    obs_xy: np.ndarray       # [O, 2] measured keypoints
    obs_image_id: np.ndarray  # [O] original image id
    obs_p2D_idx: np.ndarray  # [O]
    # masks
    pose_free: np.ndarray    # [I]
    tvec_free: np.ndarray    # [I, 3]
    cam_free: np.ndarray     # [Nc, k]
    point_free: np.ndarray   # [Np]
    # id maps
    image_ids: List[int]
    camera_ids: List[int]
    point_ids: List[int]

    def unpack_into(self, reconstruction: Reconstruction, qvec, tvec, cams,
                    xyz) -> None:
        for slot, iid in enumerate(self.image_ids):
            im = reconstruction.images[iid]
            im.qvec = np.asarray(qvec[slot], np.float64)
            im.tvec = np.asarray(tvec[slot], np.float64)
        for slot, cid in enumerate(self.camera_ids):
            cam = reconstruction.cameras[cid]
            kc = CAMERA_MODELS[cam.model].num_params
            cam.params = np.asarray(cams[slot][:kc], np.float64)
        for slot, pid in enumerate(self.point_ids):
            reconstruction.points3D[pid].xyz = np.asarray(xyz[slot],
                                                          np.float64)


def pack_ba_problem(reconstruction: Reconstruction,
                    setup: Optional[BundleAdjustmentSetup] = None,
                    refine_focal_length: bool = True,
                    refine_principal_point: bool = False,
                    refine_extra_params: bool = True,
                    refine_extrinsics: bool = True,
                    min_track_length: int = 0,
                    point3D_ids: Optional[Sequence[int]] = None) -> PackedBA:
    if setup is None:
        setup = default_problem_setup(reconstruction)

    # points in the problem
    if point3D_ids is not None:
        pids = [p for p in point3D_ids if p in reconstruction.points3D]
    else:
        pids = sorted(reconstruction.points3D.keys())
    point_ids = pids  # constancy is handled by point_free below
    pt_slot = {p: i for i, p in enumerate(point_ids)}

    # images: those in setup plus any registered image observing a problem point
    image_set = set(setup.image_ids)
    extra_images = set()
    for pid in point_ids:
        for iid, _ in reconstruction.points3D[pid].track:
            if iid not in image_set:
                extra_images.add(iid)
    image_ids = sorted(image_set | extra_images)
    img_slot = {i: s for s, i in enumerate(image_ids)}

    camera_ids = sorted({reconstruction.images[i].camera_id
                         for i in image_ids})
    cam_slot = {c: s for s, c in enumerate(camera_ids)}
    models = sorted({reconstruction.cameras[c].model for c in camera_ids})
    model = models[0]
    # mixed models: pad every camera's params to the widest model; the
    # residual selects the projection branch per observation via
    # cam_model_idx (lax.switch)
    k = max(CAMERA_MODELS[m].num_params for m in models)
    cam_model_idx = np.array(
        [models.index(reconstruction.cameras[c].model) for c in camera_ids],
        np.int32)

    I, Nc, Np = len(image_ids), len(camera_ids), len(point_ids)
    qvec = np.stack([reconstruction.images[i].qvec for i in image_ids])
    tvec = np.stack([reconstruction.images[i].tvec for i in image_ids])
    cams = np.zeros((Nc, k))
    for s, c in enumerate(camera_ids):
        p = reconstruction.cameras[c].params
        cams[s, :len(p)] = p
    xyz = np.stack([reconstruction.points3D[p].xyz for p in point_ids]) \
        if Np else np.zeros((0, 3))

    obs_img, obs_cam, obs_pt, obs_xy = [], [], [], []
    obs_image_id, obs_p2D = [], []
    for pid in point_ids:
        for iid, p2D_idx in reconstruction.points3D[pid].track:
            im = reconstruction.images.get(iid)
            if im is None or not im.registered:
                continue
            obs_img.append(img_slot[iid])
            obs_cam.append(cam_slot[im.camera_id])
            obs_pt.append(pt_slot[pid])
            obs_xy.append(im.xys[p2D_idx])
            obs_image_id.append(iid)
            obs_p2D.append(p2D_idx)

    pose_free = np.array([
        refine_extrinsics and (i in setup.image_ids)
        and (i not in setup.constant_poses) for i in image_ids])
    tvec_free = np.ones((I, 3), bool)
    for iid, coords in setup.constant_tvecs.items():
        if iid in img_slot:
            for c in coords:
                tvec_free[img_slot[iid], c] = False

    cam_free = np.zeros((Nc, k), bool)
    for s, c in enumerate(camera_ids):
        spec = CAMERA_MODELS[reconstruction.cameras[c].model]
        if refine_focal_length:
            cam_free[s, list(spec.focal_idxs)] = True
        if refine_principal_point:
            cam_free[s, list(spec.pp_idxs)] = True
        if refine_extra_params and spec.extra_idxs:
            cam_free[s, list(spec.extra_idxs)] = True

    point_free = np.array([
        (p not in setup.constant_points)
        and reconstruction.points3D[p].track_length >= min_track_length
        for p in point_ids])

    return PackedBA(
        qvec=qvec.astype(np.float32), tvec=tvec.astype(np.float32),
        cams=cams.astype(np.float32),
        xyz=xyz.astype(np.float32), cam_model=model,
        cam_models=tuple(models), cam_model_idx=cam_model_idx,
        obs_img=np.asarray(obs_img, np.int32),
        obs_cam=np.asarray(obs_cam, np.int32),
        obs_pt=np.asarray(obs_pt, np.int32),
        obs_xy=np.asarray(obs_xy, np.float64).reshape(-1, 2),
        obs_image_id=np.asarray(obs_image_id, np.int64),
        obs_p2D_idx=np.asarray(obs_p2D, np.int64),
        pose_free=pose_free, tvec_free=tvec_free, cam_free=cam_free,
        point_free=point_free,
        image_ids=image_ids, camera_ids=camera_ids, point_ids=point_ids)
