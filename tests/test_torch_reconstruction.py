"""Port parity: ``PixSfM.reconstruction`` (KA -> incremental mapper -> BA)
on hloc files against the JAX package on the CPU.

The scene is ``tests/test_torch_mapper.py::_write_two_plane_scene`` (eight
views of 320x240 on a 46-degree arc around two textured planes meeting at
an angle, 150 points; a single plane is degenerate for self-calibration,
and its two-view homography has two valid decompositions), with the JAX
S2DNet weights carried across by ``params_from_flax`` and float32
features. Limits: refined keypoints atol 1e-2 px (keypoints of this scene
slide to the 4 px bound along flat valleys of the random-weight features,
where the two LMs stop up to 4.4e-3 px apart; ``run_ka``'s 1e-3 px holds on
the scene of ``tests/test_torch_ka.py``); the same registered images and
tracks; after the similarity that maps the port's camera centres onto
JAX's (the gauge is a camera that the float32 re-registration sweep
re-seats), rotations within 0.05 degrees, centres within 1e-3 of their
extent and points within 2e-3 of it (the featuremetric BA moves points
along the same flat valleys; measured 1.3e-3); KA and BA costs rtol 1e-3.

Marked ``slow``: ~100 s alone on an 8-core CPU, and five times that among
the fast lane's six workers, where it would hold the lane's tail (the
mapper against JAX stays in the fast lane through
``tests/test_torch_mapper.py``). Run it with
``python -m pytest tests/test_torch_reconstruction.py -m slow``.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu_torch.sfm.model import Reconstruction
from tests.test_torch_ka import _pipelines
from tests.test_torch_mapper import (_write_two_plane_scene,
                                     aligned_pose_errors)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: these tests run many small
    ops, and among the fast lane's parallel workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_reconstruction_hloc_matches_jax(tmp_path):
    P3, paths = _write_two_plane_scene(tmp_path)
    jsfm, tsfm = _pipelines({"dense_features": {"dtype": "float"}})
    jrec, jout = jsfm.reconstruction(tmp_path / "out_j", tmp_path, *paths)
    trec, tout = tsfm.reconstruction(tmp_path / "out_t", tmp_path, *paths)
    assert tout["SfM"]["num_reg_images"] == jout["SfM"]["num_reg_images"] \
        == len(jrec.images)
    assert tout["SfM"]["time"] > 0 and tout["SfM"]["pnp_calls"] > 0
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].xys, im.xys, atol=1e-2)
    assert trec.points3D.keys() == jrec.points3D.keys()
    rot, cen, (s, R, t, ext) = aligned_pose_errors(trec, jrec)
    assert rot.max() < 0.05 and cen.max() < 1e-3, (rot, cen)
    for pid, p in jrec.points3D.items():
        assert trec.points3D[pid].track == p.track
        moved = s * R @ trec.points3D[pid].xyz + t
        assert np.linalg.norm(moved - p.xyz) < 2e-3 * ext
    for stage in ("KA", "BA"):
        for k in ("initial_cost", "final_cost"):
            np.testing.assert_allclose(tout[stage][k], jout[stage][k],
                                       rtol=1e-3)
        assert tout[stage]["final_cost"][0] < tout[stage]["initial_cost"][0]
    written = Reconstruction.read(tmp_path / "out_t")
    assert written.points3D.keys() == trec.points3D.keys()
