"""Port parity of patch-warp BA with joint source poses (the counterpart of
``tests/test_costmap_patchwarp_ba.py::test_patch_warp_joint_source_poses``,
the port's final cost against JAX's at rtol 1e-4) and of the node-window
references with NCC and ``compute_offsets3D`` (sources equal, descriptors
and node offsets atol 1e-5). Moved out of ``tests/test_torch_patch_warp.py``,
whose helpers they use, so that the test suite's workers share the long
tests.
"""

import numpy as np

from pixsfm_tpu.bundle_adjustment import extract_references as j_refs
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.features.featuremaps import FeatureView as JView
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.bundle_adjustment import extract_references as t_refs
from pixsfm_tpu_torch.features import featuremaps as tfm
from tests.test_bundle_adjustment import perturb
from tests.test_costmap_patchwarp_ba import track_consistency
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _one_torch_thread  # noqa: F401
from tests.test_torch_ba import _port_fset, _to_port
from tests.test_torch_patch_warp import (NODES16, _conf, _pinhole_halves,
                                        _refine_both, _textured)


def test_extract_references_nodes_match():
    """16 NCC nodes (the photometric preset's) with ``compute_offsets3D``,
    on two camera models: sources equal, descriptors atol 1e-5, node
    offsets atol 1e-5."""
    jrec, jfset = _textured(*featuremetric_scene(seed=9, n_images=4,
                                                 n_points=10))
    _pinhole_halves(jrec)
    perturb(jrec, np.random.default_rng(3), pose_rot=0.002, pose_t=0.004,
            point_sigma=0.004)
    trec, tfset = _to_port(jrec), _port_fset(jfset, 8, 16)
    conf = {"iters": 10, "compute_offsets3D": True,
            "keep_observations": True}
    pids = sorted(jrec.points3D)
    kw = dict(mode="BICUBIC", l2_normalize=False, ncc_normalize=True,
              nodes=NODES16)
    jr = j_refs(jrec, jfset, JView.from_reconstruction(jfset, jrec, pids),
                conf, JInterp(**kw))
    tr = t_refs(trec, tfset, tfm.FeatureView.from_reconstruction(
        tfset, trec, pids), conf, InterpolationConfig(**kw))
    assert jr.keys() == tr.keys()
    for pid in jr:
        assert tr[pid].source == jr[pid].source
        assert tr[pid].descriptor.shape == (16 * 8,)
        np.testing.assert_allclose(tr[pid].descriptor, jr[pid].descriptor,
                                   atol=1e-5)
        assert tr[pid].node_offsets3D.shape == (16, 3)
        np.testing.assert_allclose(tr[pid].node_offsets3D,
                                   jr[pid].node_offsets3D, atol=1e-5)


def test_patch_warp_joint_source_poses():
    """``test_patch_warp_joint_source_poses``: poses and points perturbed,
    the source poses a second block; spread below 0.6x and the mean
    translation error falls."""
    rng = np.random.default_rng(0)
    jrec, jfset = featuremetric_scene(seed=10)
    true_t = {iid: im.tvec.copy() for iid, im in jrec.images.items()}
    perturb(jrec, rng, pose_rot=0.002, pose_t=0.004, point_sigma=0.004)
    err0 = np.mean([np.linalg.norm(im.tvec - true_t[i])
                    for i, im in jrec.images.items()])
    out, trec, spread0 = _refine_both(_conf(NODES16, True, 30, 10),
                                      jrec, jfset)
    assert out["joint_source_poses"] is True
    assert track_consistency(trec) < spread0 * 0.6
    assert np.mean([np.linalg.norm(im.tvec - true_t[i])
                    for i, im in trec.images.items()]) < err0
