"""Port parity: dense feature maps and the ``photometric`` preset, against
the JAX package on the CPU with the same inputs.

- Dense extraction with the ``image`` model (``sparse: false``, bfloat16
  storage, a LANCZOS resize to ``max_edge``), and the dense fallback of
  sparse extraction (more keypoint windows than the map holds): the same
  map, scale and corner (exact: both packages resize with PIL and round
  to bfloat16 the same way).
- ``FeatureView`` over dense maps: windows cut around the keypoints
  (integer corners clipped into the map, repeated and border keypoints),
  and the whole map as one row for an image without keypoints: index,
  corners, scales and windows equal (exact).
- ``PixSfM("photometric").triangulation`` (dense image maps -> no KA ->
  triangulation -> points-only patch-warp BA with 16 NCC nodes) on hloc
  files of a small rendered scene (4 views, 12 points): the same tracks,
  the BA's initial cost rtol 1e-4, its final cost rtol 1e-3, points atol
  1e-4 (measured: the final costs 1.1e-6 apart, the points 8.6e-6; the two
  LM runs stop an iteration apart, 26 and 27 of the preset's 30, as inner
  point iterations take or refuse steps on float32 noise at the optimum),
  and the ``triangulator`` command with ``--config_path photometric
  --device cpu``.
"""

import ml_dtypes
import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.config import load_config as j_load_config
from pixsfm_tpu.features import featuremaps as jfm
from pixsfm_tpu.features.extractor import FeatureExtractor as JExtractor
from pixsfm_tpu.refine_hloc import PixSfM as JPixSfM
from pixsfm_tpu.sfm.model import Reconstruction as JRec
from pixsfm_tpu_torch.config import load_config
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.features.extractor import FeatureExtractor
from pixsfm_tpu_torch.refine_hloc import PixSfM
from tests.test_torch_sfm import _write_plane_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: among the fast lane's
    parallel workers, torch's default threads only contend for the cores
    (as in ``tests/test_torch_ba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_image(path, rng, W=240, H=180):
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    PIL.Image.fromarray(img).save(path)
    return path


def _dense_confs():
    photometric = j_load_config("photometric").dense_features.to_dict()
    return {
        # the preset's maps, resized (LANCZOS) to a max_edge of 160 px
        "photometric": {**photometric, "max_edge": 160},
        # sparse, but more keypoint windows than the map holds: dense
        "fallback": {"model": {"name": "image", "grayscale": False},
                     "sparse": True, "patch_size": 16, "l2_normalize": True,
                     "dtype": "float", "max_edge": 1600},
    }


def _as_float(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("which", ["photometric", "fallback"])
def test_dense_extraction_matches_jax(tmp_path, which):
    rng = np.random.default_rng(30)
    path = _write_image(tmp_path / "im.png", rng)
    conf = _dense_confs()[which]
    # 200 windows of 16 x 16 x 3 hold more than the 240 x 180 x 3 map
    kps = rng.uniform(0, 180, (200, 2))
    j_map = JExtractor(conf)(path, keypoints=kps)[0]
    t_map = FeatureExtractor(conf, device="cpu")(path, keypoints=kps)[0]
    assert j_map.is_dense and t_map.is_dense and not t_map.is_sparse
    assert t_map.keypoint_ids() == [tfm.kDensePatchId] == [jfm.kDensePatchId]
    patch = j_map.get_patch(jfm.kDensePatchId)
    assert t_map.patches.dtype == (torch.bfloat16 if which == "photometric"
                                   else torch.float32)
    assert tuple(t_map.patches.shape) == (1,) + patch.data.shape
    np.testing.assert_array_equal(_as_float(t_map.patches[0].float()),
                                  _as_float(patch.data))
    np.testing.assert_array_equal(t_map.corners, [patch.corner])
    np.testing.assert_array_equal(t_map.scale, patch.scale)
    assert t_map.row_of(12345) == 0


def _dense_sets(rng, names=("a", "b"), shape=(40, 56, 3)):
    """The same dense bf16 maps in both packages' feature sets."""
    jset = jfm.FeatureSet(shape[-1], 16, "half")
    tset = tfm.FeatureSet(shape[-1], 16, "half")
    for k, name in enumerate(names):
        data = rng.normal(0, 1, shape).astype(ml_dtypes.bfloat16)
        scale = np.array([0.5, 0.5 + 0.25 * k])
        jset.emplace(name, jfm.FeatureMap.from_arrays(
            data[None], [jfm.kDensePatchId], np.zeros((1, 2), np.int32),
            scale, is_sparse=False))
        tset.emplace(name, tfm.FeatureMap(
            torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)[None],
            [tfm.kDensePatchId], np.zeros((1, 2)), scale, is_sparse=False))
    return jset, tset


def _assert_packed_equal(tp, jp):
    np.testing.assert_array_equal(_as_float(tp.patches.float()),
                                  _as_float(jp.patches))
    np.testing.assert_array_equal(tp.corners, jp.corners)
    np.testing.assert_array_equal(tp.scales, jp.scales)
    np.testing.assert_array_equal(tp.upsampling, jp.upsampling)
    assert tp.index == jp.index and tp.dense_images == jp.dense_images


def test_dense_feature_view_matches_jax():
    """Windows around keypoints (repeated ids, keypoints past every border
    of the map) and whole-map rows for images without keypoints."""
    rng = np.random.default_rng(31)
    jset, tset = _dense_sets(rng)
    kps = {"a": rng.uniform(-20, 130, (12, 2)),
           "b": np.array([[0.0, 0.0], [111.9, 79.9], [200.0, -5.0],
                          [55.5, 40.25], [16.5, 16.5]])}
    required = {"a": [3, 0, 3, 11, 7], "b": [4, 2, 0, 1, 3]}
    jp = jfm.FeatureView(jset, required, keypoints=kps).packed
    tp = tfm.FeatureView(tset, required, keypoints=kps).packed
    assert tuple(tp.patches.shape) == (9, 16, 16, 3)     # one id repeats
    _assert_packed_equal(tp, jp)
    for name in required:
        np.testing.assert_array_equal(tp.rows_for_image(name, [0, 3]),
                                      jp.rows_for_image(name, [0, 3]))
    # no keypoints: each dense map is one shared row
    jp = jfm.FeatureView(jset, required).packed
    tp = tfm.FeatureView(tset, required).packed
    assert tp.dense_images == {"a": 0, "b": 1}
    _assert_packed_equal(tp, jp)
    assert tp.row_or("b", 17) == 1
    np.testing.assert_array_equal(tp.rows_or_for_image("a", [5, 9]), [0, 0])


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


def test_photometric_preset_builds():
    """The preset loads with the JAX package's values and builds dense
    image-model extraction, no KA and patch-warp BA (constant source) on
    the CPU when asked; by default it runs on ``cuda``, and without a GPU
    it refuses instead of falling back."""
    from pixsfm_tpu_torch.bundle_adjustment import BundleAdjuster
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PixSfM("photometric")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BundleAdjuster.create({"strategy": "patch_warp"})
    conf = load_config("photometric")
    assert conf.to_dict() == j_load_config("photometric").to_dict()
    sfm = PixSfM("photometric", device="cpu")
    assert not sfm.extractor.conf.sparse
    assert not sfm.keypoint_adjuster.conf.apply
    ba = sfm.bundle_adjuster
    assert ba.conf.interpolation.ncc_normalize
    assert len(ba.conf.interpolation.nodes) == 16
    assert not ba._optimizer_flags()["refine_extrinsics"]
    assert ba.conf.references.compute_offsets3D
