"""Port parity of the feature containers and the extractor's window cut.

- ``FeatureView`` packs the same rows, in the same order, with the same
  corners/scales/index as the JAX package (exact).
- ``FeatureExtractor._to_fmap`` cuts the same keypoint windows from one
  feature map, L2-normalizes and casts them: float32 storage within 1e-6,
  bfloat16 storage within one bf16 rounding step (4e-3 at unit norm)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.features import extractor as jextractor
from pixsfm_tpu.features import featuremaps as jfm
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.features.extractor import FeatureExtractor


def _fsets(rng, names=("a", "b", "c"), n=9, ps=8, C=4):
    jset = jfm.FeatureSet(C, ps, "float32")
    tset = tfm.FeatureSet(C, ps, "float32")
    for k, name in enumerate(names):
        patches = rng.normal(0, 1, (n, ps, ps, C)).astype(np.float32)
        ids = list(range(0, 2 * n, 2))             # even keypoint ids only
        corners = rng.integers(0, 50, (n, 2))
        scale = np.array([0.5 + k, 1.0])
        jset.emplace(name, jfm.FeatureMap.from_arrays(patches, ids, corners,
                                                      scale))
        tset.emplace(name, tfm.FeatureMap.from_arrays(patches, ids, corners,
                                                      scale))
    return jset, tset


def test_feature_view_packs_like_jax():
    rng = np.random.default_rng(0)
    jset, tset = _fsets(rng)
    # repeated, unordered and missing (odd) keypoint ids; one full map
    required = {"b": [4, 0, 4, 3, 16], "a": list(range(0, 18, 2)),
                "c": [10]}
    jp = jfm.FeatureView(jset, required).packed
    tp = tfm.FeatureView(tset, required).packed
    np.testing.assert_array_equal(tp.patches.numpy(), jp.patches)
    np.testing.assert_array_equal(tp.corners, jp.corners)
    np.testing.assert_array_equal(tp.scales, jp.scales)
    np.testing.assert_array_equal(tp.upsampling, jp.upsampling)
    assert tp.index == jp.index
    np.testing.assert_array_equal(tp.rows_for_image("b", [16, 0]),
                                  jp.rows_for_image("b", [16, 0]))


@pytest.mark.parametrize("dtype,atol", [("float", 1e-6), ("half", 4e-3)])
def test_window_cut_matches_jax(dtype, atol):
    rng = np.random.default_rng(1)
    h, w, C, ps = 40, 56, 128, 16
    fmap = rng.normal(0, 1, (h, w, C)).astype(np.float32)
    image_size = (2 * w, 2 * h)                  # featuremap at scale 1/2
    kps = rng.uniform(0, [2 * w, 2 * h], (6, 2))
    kps[0] = [0.0, 0.0]                          # corners clipped to the map
    kps[1] = [2 * w - 1.0, 2 * h - 1.0]
    ids = [3, 1, 4, 15, 9, 2]
    conf = {"dtype": dtype, "patch_size": ps}
    jx = jextractor.FeatureExtractor(conf)
    tx = FeatureExtractor(conf, device="cpu")
    jm = jx._to_fmap(jnp.asarray(fmap), image_size, kps, ids, False, None)
    tm = tx._to_fmap(torch.from_numpy(fmap).permute(2, 0, 1), image_size,
                     kps, ids)
    assert tm.keypoint_ids() == ids
    jpatch = np.stack([jm.get_patch(i).data for i in ids]).astype(
        np.float32)
    np.testing.assert_allclose(tm.patches.float().numpy(), jpatch,
                               atol=atol)
    np.testing.assert_array_equal(
        tm.corners, np.stack([jm.get_patch(i).corner for i in ids]))
    np.testing.assert_allclose(tm.scale, jm.get_patch(ids[0]).scale)
