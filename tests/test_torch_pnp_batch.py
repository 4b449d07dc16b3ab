"""Port parity of PnP's host oracle (the float64 RANSAC of a query, its rays
taken from JAX's float32 undistortion) and of the batched entry point
(``absolute_pose_estimation_batch``: mixed size buckets, a 4-point query, a
query of 70 % outliers) against the JAX package on the CPU, at
``tests/test_torch_pnp.py``'s limits. Moved out of that file, whose helpers
they use, so that the test suite's workers share the long tests.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.localization import pnp as jpnp
from pixsfm_tpu.sfm.synthetic import synthetic_reconstruction as j_synth
from pixsfm_tpu_torch.localization import pnp as tpnp
from tests.test_torch_pnp import (_assert_pose_parity, _cams, _jcam,
                                  _project_all, _scene_queries)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in ``tests/test_torch_pnp.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_oracle_matches_jax(monkeypatch):
    """The rays are JAX's float32 undistortion on both sides: its last bits
    differ between XLA and torch on distorted models, and the LO polish
    stops within its own tolerance (~1e-8) of where it starts. The rest is
    float64 numpy, the same arithmetic in both packages."""
    monkeypatch.setattr(tpnp, "_cam_from_img32",
                        lambda cam, xy: _jcam(cam).cam_from_img(xy))
    for name, xy, X, model, params, max_err in _scene_queries():
        jcam, tcam = _cams(model, params)
        oj = jpnp._absolute_pose_estimation_host(xy, X, jcam,
                                                 max_error_px=max_err)
        ot = tpnp._absolute_pose_estimation_host(xy, X, tcam,
                                                 max_error_px=max_err)
        assert ot["success"] and oj["success"], name
        np.testing.assert_array_equal(ot["inliers"], oj["inliers"])
        np.testing.assert_allclose(ot["qvec"], oj["qvec"], atol=1e-9)
        np.testing.assert_allclose(ot["tvec"], oj["tvec"], atol=1e-9)


def test_batch_matches_jax():
    """Mixed sizes (two size buckets), a query of 4 points, and a query with
    70 % outliers that misses the stage-1 bar and runs the full program:
    each query as JAX's, and the samples drawn in the same order."""
    rec = j_synth(n_images=6, n_points=90, noise_px=0.2, seed=22)
    rng = np.random.default_rng(4)
    jq, tq = [], []
    for iid, im in list(rec.images.items())[:5]:
        cam = rec.cameras[im.camera_id]
        X, xy = _project_all(rec, im)
        keep = len(xy) - (iid % 3) * 30
        xy, X = xy[:keep].copy(), X[:keep]
        if iid == 4:
            n_out = int(0.7 * keep)
            xy[:n_out] += rng.uniform(40, 150, (n_out, 2))
        jcam, tcam = _cams(cam.model, cam.params)
        jq.append(dict(points2D=xy, points3D=X, camera=jcam))
        tq.append(dict(points2D=xy, points3D=X, camera=tcam))
    for q, cam in ((jq, jq[0]["camera"]), (tq, tq[0]["camera"])):
        q.insert(2, dict(points2D=np.zeros((4, 2)), points3D=np.zeros((4, 3)),
                         camera=cam))
    assert tpnp._stage_accept(0, 60, 0.0) is False
    for polish in (False, True):
        oj = jpnp.absolute_pose_estimation_batch(jq, max_error_px=6.0,
                                                 polish=polish)
        ot = tpnp.absolute_pose_estimation_batch(tq, max_error_px=6.0,
                                                 polish=polish, device="cpu")
        assert not ot[2]["success"] and not oj[2]["success"]
        for a, b, q in zip(ot, oj, tq):
            _assert_pose_parity(a, b, q["points3D"], polish)
        assert all(o["success"] for i, o in enumerate(ot) if i != 2)
