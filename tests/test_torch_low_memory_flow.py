"""Port parity: ``PixSfM("low_memory").triangulation`` against the JAX
package's at the tolerances of ``tests/test_torch_sfm_flow.py::
test_triangulation_hloc_matches_jax``, except the costmap BA's final cost
(rtol 1e-3; the test says why). Moved out of
``tests/test_torch_costmaps.py`` so that the test suite's workers share the
long tests.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side, as in the file this test
    came from: among the fast lane's parallel workers, torch's default
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_low_memory_triangulation_matches_jax(tmp_path):
    """``PixSfM("low_memory").triangulation`` (topological_reference KA ->
    triangulation -> points-only costmap BA) on hloc files against the JAX
    package's, float32 feature storage, the JAX S2DNet weights carried
    across: refined keypoints atol 1e-3 px, points atol 1e-3, KA costs and
    the BA's initial cost rtol 1e-4 (``tests/test_torch_sfm.py::
    test_triangulation_hloc_matches_jax``). The BA's final cost is held at
    rtol 1e-3: after the preset's 100 LM iterations with inner iterations
    the points agree within 8e-5, but costmap BA's near-singular steps
    (``tests/test_torch_ba.py::test_adjuster_refine_matches``) leave its
    flat final cost 6e-4 apart (1.5e-7 of 2.4e-4)."""
    from pixsfm_tpu.config import load_config as j_load_config
    from tests.test_torch_ka import _pipelines
    from tests.test_torch_sfm import _write_plane_scene
    keypoints, P3, paths = _write_plane_scene(tmp_path)
    conf = j_load_config("low_memory", extra={"dense_features": {
        "dtype": "float"}}).to_dict()
    jsfm, tsfm = _pipelines(conf)
    assert type(tsfm.bundle_adjuster).__name__ == "CostMapBundleAdjuster"
    jrec, jout = jsfm.triangulation(tmp_path / "out_j", tmp_path / "ref",
                                    tmp_path, *paths)
    trec, tout = tsfm.triangulation(tmp_path / "out_t", tmp_path / "ref",
                                    tmp_path, *paths)
    assert tout["triangulation"]["num_points3D"] == len(P3)
    assert trec.points3D.keys() == jrec.points3D.keys()
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].xys, im.xys, atol=1e-3)
    for pid, p in jrec.points3D.items():
        assert trec.points3D[pid].track == p.track
        np.testing.assert_allclose(trec.points3D[pid].xyz, p.xyz, atol=1e-3)
    for stage, k, rtol in (("KA", "initial_cost", 1e-4),
                           ("KA", "final_cost", 1e-4),
                           ("BA", "initial_cost", 1e-4),
                           ("BA", "final_cost", 1e-3)):
        np.testing.assert_allclose(tout[stage][k], jout[stage][k], rtol=rtol)
    for stage in ("KA", "BA"):
        assert tout[stage]["final_cost"][0] < tout[stage]["initial_cost"][0]
