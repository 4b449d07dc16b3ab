"""Port parity: both ETH3D harnesses with ``--method loftr`` against the
JAX package's on the CPU (moved out of ``tests/test_torch_eth3d.py`` so
that the test suite's workers share the long tests).

The scene is ``tests/test_torch_eth3d.py``'s at 3 views instead of 5: the
harnesses run LoFTR on every pair (3 pairs instead of 10), in both
packages, and the run's outcome (random weights pass no pair at the
default threshold) does not depend on the count. torch keeps its default
threads: LoFTR's convolutions use them.
"""

import json

import pytest

from tests.test_torch_eth3d import HARNESS_CONF, LOC_CONF, TOLERANCES


@pytest.fixture(scope="module")
def loftr_scene(tmp_path_factory):
    pytest.importorskip("cv2")
    from pixsfm_tpu_torch.eval.eth3d.synthetic import make_synthetic_scene
    root = tmp_path_factory.mktemp("eth3d_loftr")
    make_synthetic_scene(root / "synthetic_scene", n_images=3, n_points=50,
                         seed=5, width=480, height=360)
    return root


def test_run_scene_loftr_matches_jax(loftr_scene):
    """The detector-free method at the harnesses' defaults (match
    threshold 0.2): random LoFTR weights pass no pair in either package, so
    both triangulation runs end with the same number of points (0), write
    their results and raise nowhere on the empty graph; the localization
    harness ends with every query unlocalized."""
    scene = loftr_scene
    from pixsfm_tpu.eval.eth3d.triangulation import run_scene as jrun
    from pixsfm_tpu_torch.eval.eth3d.localization import \
        run_scene_localization as tloc
    from pixsfm_tpu_torch.eval.eth3d.triangulation import run_scene as trun
    mj = jrun(scene / "synthetic_scene", scene / "loftr_j",
              conf=HARNESS_CONF, tolerances=TOLERANCES, method="loftr")
    stats = {}
    mt = trun(scene / "synthetic_scene", scene / "loftr_t",
              conf=HARNESS_CONF, tolerances=TOLERANCES, method="loftr",
              device="cpu", stats=stats)
    assert mt["num_points"] == mj["num_points"] == 0
    assert mt == pytest.approx(mj)
    assert stats["matched_pairs"] == stats["num_pairs"] == 0
    assert json.loads((scene / "loftr_t" / "results.json").read_text()) == \
        pytest.approx(mt)
    rt = tloc(scene / "synthetic_scene", scene / "loftr_loc_t",
              conf=LOC_CONF, num_holdout=1, method="loftr", device="cpu")
    assert rt["num_queries"] == 1 and rt["errors_m"] == [None]
    assert (scene / "loftr_loc_t" / "results_localization.json").exists()
