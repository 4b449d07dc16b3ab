"""Reconstruction data model + COLMAP-format IO.

Copy of ``pixsfm_tpu/sfm/model.py`` (numpy only): a standalone equivalent of
``pycolmap.Reconstruction`` with read/write support for COLMAP's public
sparse-model formats (cameras/images/points3D in ``.txt`` and ``.bin``), so
models written by either package read back in the other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base.cameras import CAMERA_MODEL_IDS, Camera
from ..base.geometry import quat_to_rotmat_np

__all__ = ["Image", "Point3D", "Reconstruction", "INVALID_POINT3D"]

INVALID_POINT3D = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class Image:
    image_id: int
    name: str
    camera_id: int
    qvec: np.ndarray = field(default_factory=lambda: np.array([1., 0., 0., 0.]))
    tvec: np.ndarray = field(default_factory=lambda: np.zeros(3))
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    registered: bool = True

    def __post_init__(self):
        self.qvec = np.asarray(self.qvec, dtype=np.float64).reshape(4)
        self.tvec = np.asarray(self.tvec, dtype=np.float64).reshape(3)
        self.xys = np.asarray(self.xys, dtype=np.float64).reshape(-1, 2)
        self.point3D_ids = np.asarray(self.point3D_ids, dtype=np.int64)

    @property
    def num_points2D(self) -> int:
        return len(self.xys)

    @property
    def num_points3D(self) -> int:
        return int(np.sum(self.point3D_ids >= 0))

    def rotation_matrix(self) -> np.ndarray:
        return quat_to_rotmat_np(self.qvec)

    def projection_center(self) -> np.ndarray:
        R = self.rotation_matrix()
        return -R.T @ self.tvec

    def world_to_camera(self, X: np.ndarray) -> np.ndarray:
        R = self.rotation_matrix()
        return (R @ np.atleast_2d(X).T).T + self.tvec

    def has_point3D(self, p2D_idx: int) -> bool:
        return self.point3D_ids[p2D_idx] >= 0


@dataclass
class Point3D:
    point3D_id: int
    xyz: np.ndarray
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.uint8))
    error: float = -1.0
    track: List[Tuple[int, int]] = field(default_factory=list)  # (image_id, p2D)

    def __post_init__(self):
        self.xyz = np.asarray(self.xyz, dtype=np.float64).reshape(3)
        self.color = np.asarray(self.color, dtype=np.uint8).reshape(3)

    @property
    def track_length(self) -> int:
        return len(self.track)


class Reconstruction:
    """cameras / images / points3D with COLMAP text+binary IO."""

    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.points3D: Dict[int, Point3D] = {}

    # -- construction -------------------------------------------------------
    def add_camera(self, camera: Camera):
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: Image):
        self.images[image.image_id] = image

    def add_point3D(self, point: Point3D):
        self.points3D[point.point3D_id] = point

    def image_by_name(self, name: str) -> Optional[Image]:
        for im in self.images.values():
            if im.name == name:
                return im
        return None

    @property
    def num_reg_images(self) -> int:
        return sum(1 for im in self.images.values() if im.registered)

    def mean_track_length(self) -> float:
        if not self.points3D:
            return 0.0
        return float(np.mean([p.track_length
                              for p in self.points3D.values()]))

    def mean_reprojection_error(self) -> float:
        from ..base.projection import reproj_errors_np

        per_image: Dict[int, list] = {}
        for pid, p in self.points3D.items():
            for image_id, p2D_idx in p.track:
                per_image.setdefault(image_id, []).append((pid, p2D_idx))
        errs = []
        for iid, items in per_image.items():
            im = self.images[iid]
            cam = self.cameras[im.camera_id]
            X = np.stack([self.points3D[pid].xyz for pid, _ in items])
            xy = im.xys[[k for _, k in items]]
            e = reproj_errors_np(cam, im.qvec, im.tvec, X, xy)
            errs.extend(e[np.isfinite(e)].tolist())
        return float(np.mean(errs)) if errs else 0.0

    def copy(self) -> "Reconstruction":
        rec = Reconstruction()
        for cid, cam in self.cameras.items():
            rec.cameras[cid] = Camera(cam.camera_id, cam.model, cam.width,
                                      cam.height, cam.params.copy())
        for iid, im in self.images.items():
            rec.images[iid] = Image(im.image_id, im.name, im.camera_id,
                                    im.qvec.copy(), im.tvec.copy(),
                                    im.xys.copy(), im.point3D_ids.copy(),
                                    im.registered)
        for pid, p in self.points3D.items():
            rec.points3D[pid] = Point3D(p.point3D_id, p.xyz.copy(),
                                        p.color.copy(), p.error,
                                        list(p.track))
        return rec

    # -- text IO ------------------------------------------------------------
    def write_text(self, path):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "cameras.txt", "w") as f:
            f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            for cam in self.cameras.values():
                params = " ".join(repr(float(p)) for p in cam.params)
                f.write(f"{cam.camera_id} {cam.model} {cam.width} "
                        f"{cam.height} {params}\n")
        with open(path / "images.txt", "w") as f:
            f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                    "CAMERA_ID, NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
            for im in self.images.values():
                if not im.registered:
                    continue
                q = [repr(float(v)) for v in im.qvec]
                t = [repr(float(v)) for v in im.tvec]
                f.write(f"{im.image_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                        f"{t[0]} {t[1]} {t[2]} {im.camera_id} {im.name}\n")
                parts = []
                for (x, y), pid in zip(im.xys, im.point3D_ids):
                    parts.append(f"{float(x)!r} {float(y)!r} "
                                 f"{pid if pid >= 0 else -1}")
                f.write(" ".join(parts) + "\n")
        with open(path / "points3D.txt", "w") as f:
            f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                    "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
            for p in self.points3D.values():
                xyz = " ".join(repr(float(v)) for v in p.xyz)
                rgb = " ".join(str(int(v)) for v in p.color)
                track = " ".join(f"{iid} {pi}" for iid, pi in p.track)
                f.write(f"{p.point3D_id} {xyz} {rgb} {float(p.error)!r} {track}\n")

    @classmethod
    def read_text(cls, path) -> "Reconstruction":
        path = Path(path)
        rec = cls()
        with open(path / "cameras.txt") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                el = line.split()
                rec.add_camera(Camera(int(el[0]), el[1], int(el[2]),
                                      int(el[3]),
                                      np.array([float(x) for x in el[4:]])))
        with open(path / "images.txt") as f:
            lines = [ln.strip() for ln in f
                     if ln.strip() and not ln.startswith("#")]
        for head, pts in zip(lines[0::2], lines[1::2]):
            el = head.split()
            image = Image(int(el[0]), el[9], int(el[8]),
                          np.array([float(x) for x in el[1:5]]),
                          np.array([float(x) for x in el[5:8]]))
            pel = pts.split()
            n = len(pel) // 3
            xys = np.zeros((n, 2))
            pids = np.full(n, -1, dtype=np.int64)
            for i in range(n):
                xys[i] = [float(pel[3 * i]), float(pel[3 * i + 1])]
                pids[i] = int(pel[3 * i + 2])
            image.xys = xys
            image.point3D_ids = pids
            rec.add_image(image)
        with open(path / "points3D.txt") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                el = line.split()
                track = [(int(el[i]), int(el[i + 1]))
                         for i in range(8, len(el), 2)]
                rec.add_point3D(Point3D(
                    int(el[0]), np.array([float(x) for x in el[1:4]]),
                    np.array([int(x) for x in el[4:7]], dtype=np.uint8),
                    float(el[7]), track))
        return rec

    # -- binary IO (COLMAP sparse model binary format) ----------------------
    def write_binary(self, path):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(self.cameras)))
            for cam in self.cameras.values():
                f.write(struct.pack("<ii", cam.camera_id, cam.model_id))
                f.write(struct.pack("<QQ", cam.width, cam.height))
                f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))
        with open(path / "images.bin", "wb") as f:
            reg = [im for im in self.images.values() if im.registered]
            f.write(struct.pack("<Q", len(reg)))
            for im in reg:
                f.write(struct.pack("<i", im.image_id))
                f.write(struct.pack("<4d", *im.qvec))
                f.write(struct.pack("<3d", *im.tvec))
                f.write(struct.pack("<i", im.camera_id))
                f.write(im.name.encode() + b"\x00")
                f.write(struct.pack("<Q", im.num_points2D))
                for (x, y), pid in zip(im.xys, im.point3D_ids):
                    upid = np.uint64(pid) if pid >= 0 else INVALID_POINT3D
                    f.write(struct.pack("<ddQ", x, y, int(upid)))
        with open(path / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(self.points3D)))
            for p in self.points3D.values():
                f.write(struct.pack("<Q", p.point3D_id))
                f.write(struct.pack("<3d", *p.xyz))
                f.write(struct.pack("<3B", *p.color))
                f.write(struct.pack("<d", p.error))
                f.write(struct.pack("<Q", len(p.track)))
                for iid, pi in p.track:
                    f.write(struct.pack("<ii", iid, pi))

    @classmethod
    def read_binary(cls, path) -> "Reconstruction":
        path = Path(path)
        rec = cls()
        with open(path / "cameras.bin", "rb") as f:
            n = struct.unpack("<Q", f.read(8))[0]
            for _ in range(n):
                cid, mid = struct.unpack("<ii", f.read(8))
                w, h = struct.unpack("<QQ", f.read(16))
                spec = CAMERA_MODEL_IDS[mid]
                params = struct.unpack(f"<{spec.num_params}d",
                                       f.read(8 * spec.num_params))
                rec.add_camera(Camera(cid, spec.name, w, h,
                                      np.array(params)))
        with open(path / "images.bin", "rb") as f:
            n = struct.unpack("<Q", f.read(8))[0]
            for _ in range(n):
                iid = struct.unpack("<i", f.read(4))[0]
                qvec = np.array(struct.unpack("<4d", f.read(32)))
                tvec = np.array(struct.unpack("<3d", f.read(24)))
                cam_id = struct.unpack("<i", f.read(4))[0]
                name = b""
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    name += c
                n2d = struct.unpack("<Q", f.read(8))[0]
                data = np.frombuffer(
                    f.read(24 * n2d),
                    dtype=np.dtype([("x", "<f8"), ("y", "<f8"),
                                    ("pid", "<u8")]))
                xys = np.stack([data["x"], data["y"]], axis=1)
                pids = data["pid"].astype(np.int64)
                pids[data["pid"] == INVALID_POINT3D] = -1
                rec.add_image(Image(iid, name.decode(), cam_id, qvec, tvec,
                                    xys, pids))
        with open(path / "points3D.bin", "rb") as f:
            n = struct.unpack("<Q", f.read(8))[0]
            for _ in range(n):
                pid = struct.unpack("<Q", f.read(8))[0]
                xyz = np.array(struct.unpack("<3d", f.read(24)))
                rgb = np.array(struct.unpack("<3B", f.read(3)), dtype=np.uint8)
                err = struct.unpack("<d", f.read(8))[0]
                tl = struct.unpack("<Q", f.read(8))[0]
                tr = np.frombuffer(f.read(8 * tl), dtype="<i4").reshape(-1, 2)
                rec.add_point3D(Point3D(int(pid), xyz, rgb, err,
                                        [(int(a), int(b)) for a, b in tr]))
        return rec

    def write(self, path, binary: bool = True):
        if binary:
            self.write_binary(path)
        else:
            self.write_text(path)

    @classmethod
    def read(cls, path) -> "Reconstruction":
        path = Path(path)
        if (path / "cameras.bin").exists():
            return cls.read_binary(path)
        return cls.read_text(path)

    def __repr__(self):
        return (f"Reconstruction(num_cameras={len(self.cameras)}, "
                f"num_images={len(self.images)}, "
                f"num_points3D={len(self.points3D)})")
