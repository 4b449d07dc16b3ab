"""Port parity of the incremental mapper's flows against the JAX package
on the CPU (moved out of ``tests/test_torch_mapper.py`` so that the test
suite's workers share the long tests).

- ``incremental_mapping`` on a ring of 6 views of 150 points with unknown
  SIMPLE_RADIAL intrinsics (0.3 px keypoint noise, blank PNGs for the image
  sizes): the same registered images and the same number of attempts,
  point counts within 2 %, and after a similarity alignment (the gauge is
  the first registered camera, which the float32 re-registration sweep
  re-seats, so the two maps differ by a similarity of its rounding's size)
  rotations within 0.05 degrees and camera centres within 1e-3 of the
  scene's extent; the focal lengths within 1e-4 relative.
- The ``reconstructor`` command of ``refine_hloc`` with ``--device cpu`` on
  a tiny rendered scene of two planes (``PixSfM.reconstruction`` against
  JAX is in ``tests/test_torch_reconstruction.py``).
"""

import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.base.graph import Graph as JGraph
from pixsfm_tpu.sfm import mapper as jmapper
from pixsfm_tpu_torch.base.graph import Graph
from pixsfm_tpu_torch.sfm import mapper as tmapper
from pixsfm_tpu_torch.sfm.model import Reconstruction
from tests.test_torch_mapper import _write_two_plane_scene, aligned_pose_errors


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in ``tests/test_torch_mapper.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(tmp_path, I=6, Np=150, seed=42, W=1024, H=768, f=1000.0, k=0.02,
          noise=0.3):
    """``tests/test_mapper_scale.py``'s ring at 6 views and 150 points:
    SIMPLE_RADIAL views of a point cloud, exhaustive matches (score 1),
    blank PNGs of the image size. Both packages' graphs."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (Np, 3))
    xyz[:, 2] *= 0.6
    names = [f"im{i:02d}.png" for i in range(I)]
    blank = PIL.Image.new("RGB", (W, H))
    keypoints, kp_of = {}, {}
    for i, a in enumerate(np.linspace(0, 2 * np.pi, I, endpoint=False)):
        c = np.array([3.5 * np.cos(a), 0.5 * np.sin(2 * a), 3.5 * np.sin(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        xc = (xyz - c) @ R.T
        uv = xc[:, :2] / xc[:, 2:]
        xy = f * uv * (1 + k * (uv ** 2).sum(1))[:, None] + [W / 2, H / 2]
        vis = (xc[:, 2] > 0.5) & (xy > 10).all(1) & (xy < [W - 10, H - 10]
                                                      ).all(1)
        idx = np.nonzero(vis)[0]
        keypoints[names[i]] = xy[idx] + rng.normal(0, noise, (len(idx), 2))
        kp_of[names[i]] = {int(p): j for j, p in enumerate(idx)}
        blank.save(tmp_path / names[i])
    graphs = (JGraph(), Graph())
    for a in range(I):
        for b in range(a + 1, I):
            na, nb = names[a], names[b]
            shared = sorted(set(kp_of[na]) & set(kp_of[nb]))
            if len(shared) < 30:
                continue
            m = np.asarray([[kp_of[na][p], kp_of[nb][p]] for p in shared])
            for g in graphs:
                g.register_matches(na, nb, m, np.ones(len(m)))
    return keypoints, graphs


def test_incremental_mapping_matches_jax(tmp_path):
    keypoints, (gj, gt) = _ring(tmp_path)
    rj = jmapper.incremental_mapping(gj, {k: v.copy() for k, v in
                                          keypoints.items()}, tmp_path)
    stats = {}
    rt = tmapper.incremental_mapping(gt, {k: v.copy() for k, v in
                                          keypoints.items()}, tmp_path,
                                     device="cpu", stats=stats)
    assert {i for i, im in rt.images.items() if im.registered} == \
        {i for i, im in rj.images.items() if im.registered}
    assert rt.num_reg_images == len(keypoints)
    assert abs(len(rt.points3D) - len(rj.points3D)) <= 0.02 * len(
        rj.points3D)
    rot, cen, _ = aligned_pose_errors(rt, rj)
    assert rot.max() < 0.05 and cen.max() < 1e-3, (rot, cen)
    for cid, cam in rj.cameras.items():
        np.testing.assert_allclose(rt.cameras[cid].params[0], cam.params[0],
                                   rtol=1e-4)
    assert stats["attempts"] >= 1 and stats["pnp_calls"] >= 6
    assert stats["registrations"] >= 4 and stats["ba_calls"] >= 4
    assert len(stats["init_pairs"]) == stats["attempts"]


def test_reconstructor_cli_on_cpu(tmp_path):
    """The ``reconstructor`` command on the CPU registers every view and
    writes a finite model of every track (the port's own S2DNet weights)."""
    from pixsfm_tpu_torch.refine_hloc import main as hloc_main
    P3, (pairs, feats, matches) = _write_two_plane_scene(tmp_path, n_views=5,
                                                         n_points=80)
    hloc_main(["reconstructor", "--image_dir", str(tmp_path),
               "--features_path", str(feats), "--pairs_path", str(pairs),
               "--matches_path", str(matches), "--output_dir",
               str(tmp_path / "sfm"), "--device", "cpu",
               "mapping.BA.optimizer.solver.max_num_iterations=3"])
    rec = Reconstruction.read(tmp_path / "sfm")
    assert rec.num_reg_images == 5
    assert len(rec.points3D) >= 0.95 * len(P3)
    assert all(np.isfinite(p.xyz).all() for p in rec.points3D.values())
