"""Synthetic ETH3D-layout scene for exercising the evaluation harnesses in a
zero-egress environment (the real dataset needs eth3d.net downloads).

A random reconstruction is rendered to images by stamping a unique random
texture at every ground-truth projection of each 3D point — the same texture
across views, so descriptor-based front-ends (SIFT & friends) produce
repeatable detections that match across images. The scene is written in the
ETH3D directory layout the harnesses expect (reference
pixsfm/eval/eth3d/utils.py dataset layout):

    scene/images/*.png
    scene/dslr_calibration_undistorted/{cameras,images,points3D}.txt
    scene/scan_clean.ply

Port of ``pixsfm_tpu/eval/eth3d/synthetic.py`` on the port's
``sfm.synthetic`` and ``localization.pnp.project_np``: one seed writes the
same images and model as the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["render_scene", "write_ply", "make_synthetic_scene"]


def render_scene(rec, image_dir: Path, rng, patch: int = 15):
    """Stamp a unique random texture at every projection of each 3D point."""
    import PIL.Image

    from ...localization.pnp import project_np

    patterns = {pid: rng.integers(40, 255, (patch, patch))
                for pid in rec.points3D}
    h = patch // 2
    for im in rec.images.values():
        cam = rec.cameras[im.camera_id]
        H, W = cam.height, cam.width
        canvas = rng.integers(0, 25, (H, W)).astype(np.uint8)
        pids = [pid for pid, p in rec.points3D.items()
                if any(iid == im.image_id for iid, _ in p.track)]
        if pids:
            X = np.stack([rec.points3D[p].xyz for p in pids])
            xy, z = project_np(cam, im.qvec, im.tvec, X)
            for pid, (x, y), zz in zip(pids, xy, z):
                if zz <= 0:
                    continue
                cx, cy = int(round(x)), int(round(y))
                if h <= cx < W - h and h <= cy < H - h:
                    canvas[cy - h:cy + h + 1, cx - h:cx + h + 1] = \
                        patterns[pid]
        PIL.Image.fromarray(canvas).save(image_dir / im.name)


def write_ply(path: Path, pts: np.ndarray):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def make_synthetic_scene(scene_dir: Path, n_images: int = 5,
                         n_points: int = 50, seed: int = 5,
                         width: int = 480, height: int = 360,
                         model: str = "SIMPLE_PINHOLE", patch: int = 15):
    """Build a full ETH3D-layout synthetic scene; returns the GT model.
    ``patch``: the side of the stamped textures in pixels (odd)."""
    from ...sfm.synthetic import synthetic_reconstruction

    rng = np.random.default_rng(seed)
    rec = synthetic_reconstruction(n_images=n_images, n_points=n_points,
                                   noise_px=0.0, seed=seed, width=width,
                                   height=height, model=model)
    scene_dir = Path(scene_dir)
    (scene_dir / "images").mkdir(parents=True, exist_ok=True)
    render_scene(rec, scene_dir / "images", rng, patch=patch)
    rec.write_text(scene_dir / "dslr_calibration_undistorted")
    write_ply(scene_dir / "scan_clean.ply",
              np.stack([p.xyz for p in rec.points3D.values()]))
    return rec
