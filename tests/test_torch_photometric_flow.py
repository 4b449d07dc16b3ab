"""Port parity: ``PixSfM("photometric").triangulation`` (dense image maps
-> no KA -> triangulation -> points-only patch-warp BA with 16 NCC nodes)
on hloc files of a small rendered scene (4 views, 12 points) against the
JAX package's on the CPU: the same tracks, the BA's initial cost rtol
1e-4, its final cost rtol 1e-3, points atol 1e-4 (measured: the final
costs 1.1e-6 apart, the points 8.6e-6; the two LM runs stop an iteration
apart, 26 and 27 of the preset's 30, as inner point iterations take or
refuse steps on float32 noise at the optimum), and the ``triangulator``
command with ``--config_path photometric --device cpu``. (Moved out of
``tests/test_torch_dense_features.py`` so that the test suite's workers
share the long tests.)
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.config import load_config as j_load_config
from pixsfm_tpu.refine_hloc import PixSfM as JPixSfM
from pixsfm_tpu.sfm.model import Reconstruction as JRec
from pixsfm_tpu_torch.refine_hloc import PixSfM
from tests.test_torch_sfm import _write_plane_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side, as in
    ``tests/test_torch_dense_features.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_photometric_triangulation_matches_jax(tmp_path):
    keypoints, P3, paths = _write_plane_scene(tmp_path, n_points=12)
    conf = j_load_config("photometric").to_dict()
    jsfm, tsfm = JPixSfM(conf), PixSfM(conf, device="cpu")
    assert type(tsfm.bundle_adjuster).__name__ == "PatchWarpBundleAdjuster"
    jrec, jout = jsfm.triangulation(tmp_path / "out_j", tmp_path / "ref",
                                    tmp_path, *paths)
    trec, tout = tsfm.triangulation(tmp_path / "out_t", tmp_path / "ref",
                                    tmp_path, *paths)
    assert tout["KA"] == jout["KA"] == {}
    assert set(jout["BA"]) <= set(tout["BA"])
    assert tout["BA"]["joint_source_poses"] == [False]
    assert tout["triangulation"]["num_points3D"] == len(P3)
    assert trec.points3D.keys() == jrec.points3D.keys()
    for pid, p in jrec.points3D.items():
        assert trec.points3D[pid].track == p.track
        np.testing.assert_allclose(trec.points3D[pid].xyz, p.xyz, atol=1e-4)
    np.testing.assert_allclose(tout["BA"]["initial_cost"],
                               jout["BA"]["initial_cost"], rtol=1e-4)
    np.testing.assert_allclose(tout["BA"]["final_cost"],
                               jout["BA"]["final_cost"], rtol=1e-3)
    assert tout["BA"]["final_cost"][0] < tout["BA"]["initial_cost"][0]
    # the command line on the CPU writes the refined model
    from pixsfm_tpu_torch.refine_hloc import main as hloc_main
    pairs, feats, matches = paths
    hloc_main(["triangulator", "--image_dir", str(tmp_path),
               "--features_path", str(feats), "--pairs_path", str(pairs),
               "--matches_path", str(matches), "--reference_model_path",
               str(tmp_path / "ref"), "--output_dir", str(tmp_path / "cli"),
               "--config_path", "photometric", "--device", "cpu",
               "mapping.BA.optimizer.solver.max_num_iterations=3"])
    assert JRec.read(tmp_path / "cli").points3D.keys() == \
        trec.points3D.keys()
