"""Port parity of patch-warp BA, points only: the counterparts of
``tests/test_costmap_patchwarp_ba.py::test_patch_warp_ba_aligns_points``
and ``tests/test_mixed_fm_ba.py::test_mixed_patch_warp_ba``, with JAX's
assertions and the port's final cost against JAX's at rtol 1e-4 (moved out
of ``tests/test_torch_patch_warp.py``, whose helpers they use, so that the
test suite's workers share the long tests).
"""

import numpy as np
import pytest

from tests.test_costmap_patchwarp_ba import track_consistency
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_mixed_fm_ba import split_cameras_mixed
from tests.test_torch_ba import _one_torch_thread  # noqa: F401
from tests.test_torch_patch_warp import NODES16, _conf, _refine_both


@pytest.mark.parametrize("mixed", [False, True], ids=["aligns_points",
                                                      "mixed_models"])
def test_patch_warp_ba_aligns_points(mixed):
    """``test_patch_warp_ba_aligns_points`` and, with half the views on a
    RADIAL camera, ``test_mixed_patch_warp_ba``: points only, the track
    spread falls below 0.6x."""
    rng = np.random.default_rng(0)
    jrec, jfset = featuremetric_scene(seed=9)
    if mixed:
        split_cameras_mixed(jrec)
    for p in jrec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.008, 3)
    out, trec, spread0 = _refine_both(_conf(NODES16, False, 25, 10),
                                      jrec, jfset)
    assert out["joint_source_poses"] is False
    assert len({c.model for c in trec.cameras.values()}) == 1 + mixed
    assert track_consistency(trec) < spread0 * 0.6
