"""Port parity: ``PixSfM.triangulation`` on hloc files of a small rendered
scene against the JAX package's, with the JAX S2DNet weights carried across
by ``params_from_flax`` and float32 feature storage: refined keypoints atol
1e-3 px (``run_ka``'s tolerance in ``tests/test_torch_ka.py``), triangulated
points atol 1e-3, costs rtol 1e-4; and the ``triangulator`` and
``reconstructor`` commands on the CPU. Moved out of
``tests/test_torch_sfm.py`` (whose scene writer they use) so that the test
suite's workers share the long tests.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.sfm.model import Reconstruction as JRec
from pixsfm_tpu_torch.sfm.model import Reconstruction
from tests.test_torch_ka import _pipelines
from tests.test_torch_sfm import _write_plane_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in ``tests/test_torch_sfm.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_triangulation_hloc_matches_jax(tmp_path):
    """KA -> triangulation -> BA (``PixSfM.triangulation``) on hloc files
    against the JAX package's, with the default config (float32 features);
    the BA takes the dense step on both sides."""
    keypoints, P3, paths = _write_plane_scene(tmp_path)
    jsfm, tsfm = _pipelines({"dense_features": {"dtype": "float"}})
    jrec, jout = jsfm.triangulation(tmp_path / "out_j", tmp_path / "ref",
                                    tmp_path, *paths)
    trec, tout = tsfm.triangulation(tmp_path / "out_t", tmp_path / "ref",
                                    tmp_path, *paths)
    assert tout["BA"]["linear_solver"] == ["dense"]
    assert tout["triangulation"]["num_points3D"] == len(P3)
    assert trec.points3D.keys() == jrec.points3D.keys()
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].xys, im.xys, atol=1e-3)
    for pid, p in jrec.points3D.items():
        assert trec.points3D[pid].track == p.track
        np.testing.assert_allclose(trec.points3D[pid].xyz, p.xyz, atol=1e-3)
    for stage in ("KA", "BA"):
        for k in ("initial_cost", "final_cost"):
            np.testing.assert_allclose(tout[stage][k], jout[stage][k],
                                       rtol=1e-4)
        assert tout[stage]["final_cost"][0] < tout[stage]["initial_cost"][0]
    written = JRec.read(tmp_path / "out_t")
    assert written.points3D.keys() == trec.points3D.keys()
    # keypoint k of every view is point k of the plane
    err = np.mean([np.linalg.norm(p.xyz - P3[p.track[0][1]])
                   for p in trec.points3D.values()])
    assert err < 0.01


def test_triangulator_cli_on_cpu(tmp_path):
    """The ``triangulator`` command of ``refine_hloc`` on the CPU writes a
    refined model of every track (the port's own S2DNet weights); the
    ``reconstructor`` command, on the same files, runs the mapper and writes
    a model too."""
    from pixsfm_tpu_torch.refine_hloc import main as hloc_main
    keypoints, P3, (pairs, feats, matches) = _write_plane_scene(tmp_path)
    common = ["--image_dir", str(tmp_path), "--features_path", str(feats),
              "--pairs_path", str(pairs), "--matches_path", str(matches),
              "--device", "cpu"]
    hloc_main(["triangulator", "--reference_model_path",
               str(tmp_path / "ref"), "--output_dir", str(tmp_path / "out"),
               *common, "mapping.BA.optimizer.solver.max_num_iterations=3"])
    rec = Reconstruction.read(tmp_path / "out")
    assert len(rec.points3D) == len(P3)
    assert all(np.isfinite(p.xyz).all() and p.track_length == 4
               for p in rec.points3D.values())
    hloc_main(["reconstructor", "--output_dir", str(tmp_path / "sfm"),
               *common, "mapping.BA.optimizer.solver.max_num_iterations=3"])
    rec = Reconstruction.read(tmp_path / "sfm")
    assert rec.num_reg_images >= 2 and len(rec.points3D) > 0
    assert all(np.isfinite(p.xyz).all() for p in rec.points3D.values())
