"""Port parity: multilevel KA on VGGNet's 64 / 256 / 512-channel levels
against the JAX package on the CPU (moved out of
``tests/test_torch_detectors.py`` so that the test suite's workers share
the long tests).
"""

import jax
import numpy as np
import pytest
import torch

from pixsfm_tpu_torch.features.models import vggnet


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side, as in the file this test
    came from: among the fast lane's parallel workers, torch's default
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vggnet_multilevel_ka_matches_jax(tmp_path):
    """KA on VGGNet's three levels of 64 / 256 / 512 channels (float32
    patches, so the two packages read the same features): keypoints within
    1e-4 px of JAX's."""
    from pixsfm_tpu.refine_colmap import PixSfM as JaxPixSfM
    from pixsfm_tpu_torch.refine_colmap import PixSfM
    from tests.test_torch_ka import _write_scene

    keypoints, matches = _write_scene(tmp_path, np.random.default_rng(9),
                                      n_kps=10, H=192, W=256)
    conf = {"dense_features": {"model": {"name": "vggnet",
                                         "pretrained": None},
                               "dtype": "float"},
            "mapping": {"KA": {"optimizer": {"solver": {
                "max_num_iterations": 10}}}}}
    jsfm = JaxPixSfM(conf)
    tsfm = PixSfM(conf, device="cpu")
    tsfm.extractor.model.load_state_dict(vggnet.params_from_flax(
        jax.tree.map(np.asarray, jsfm.extractor.model.variables)))
    assert tsfm.extractor.channels_per_level == [64, 256, 512]
    kj, oj = jsfm.run_ka({k: v.copy() for k, v in keypoints.items()},
                         tmp_path, matches=matches)
    kt, ot = tsfm.run_ka({k: v.copy() for k, v in keypoints.items()},
                         tmp_path, matches=matches)
    assert len(ot["final_cost"]) == 3
    np.testing.assert_allclose(ot["final_cost"], oj["final_cost"],
                               rtol=1e-4)
    for n in keypoints:
        np.testing.assert_allclose(kt[n], kj[n], atol=1e-4)
