"""Port parity of the rest of the extraction layer.

- Batched extraction: ``batch_size: 3`` over five images of two sizes (a
  group flushed by count, one by size, one at the end) equals
  ``batch_size: 1`` within one bf16 rounding step (4e-3 at unit norm), and
  the JAX package's batched run within ``test_torch_s2dnet.py``'s S2DNet
  tolerance (atol 1e-4, float32 storage, the JAX weights carried across).
- ``combine``: the bicubic resize equals ``jax.image.resize(...,
  "bicubic")`` within 1e-5 at integer and non-integer ratios, and
  ``S2DNet(combine=True, num_layers=3)`` the JAX model within 1e-4.
- ``keep_on_device`` emits ``DeviceFeatureMap``s that pack in
  ``FeatureView`` exactly as the default maps; ``get_patch`` / ``to_host``
  / ``__contains__`` behave as the JAX package's.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.extract import features_from_image_list as jfeatures
from pixsfm_tpu.features import featuremaps as jfm
from pixsfm_tpu.features.extractor import FeatureExtractor as JExtractor
from pixsfm_tpu.features.models.s2dnet import S2DNet as JS2DNet
from pixsfm_tpu_torch.extract import features_from_image_list
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.features.extractor import FeatureExtractor
from pixsfm_tpu_torch.features.models.s2dnet import (S2DNet,
                                                     params_from_flax,
                                                     resize_bicubic)

S2D = {"name": "s2dnet", "num_layers": 1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _five_images(tmp_path):
    """Four 48x36 views and one 40x32 view, with keypoints."""
    rng = np.random.default_rng(0)
    names, kps = [], {}
    for i, (w, h) in enumerate([(48, 36)] * 4 + [(40, 32)]):
        name = f"v{i}.png"
        PIL.Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(tmp_path / name)
        names.append(name)
        kps[name] = rng.uniform([1, 1], [w - 1, h - 1], (4, 2))
    return names, kps


def _batches(monkeypatch, cls):
    """Record the group sizes that reach ``extract_batch``."""
    sizes = []
    batch = cls.extract_batch

    def counted(self, images, *a, **k):
        sizes.append(len(images))
        return batch(self, images, *a, **k)

    monkeypatch.setattr(cls, "extract_batch", counted)
    return sizes


def test_batched_extraction_matches_unbatched_and_jax(tmp_path, monkeypatch):
    names, kps = _five_images(tmp_path)
    one = features_from_image_list(
        FeatureExtractor({"model": S2D}, device="cpu"), names, tmp_path, kps)
    sizes = _batches(monkeypatch, FeatureExtractor)
    three = features_from_image_list(
        FeatureExtractor({"model": S2D, "batch_size": 3}, device="cpu"),
        names, tmp_path, kps)
    # [v0 v1 v2] flushed by count, [v3] by size, [v4] at the end
    assert sizes == [3, 1, 1]
    for name in names:
        a, b = one.fset(0).get_map(name), three.fset(0).get_map(name)
        assert a.keypoint_ids() == b.keypoint_ids()
        np.testing.assert_array_equal(a.corners, b.corners)
        np.testing.assert_allclose(b.patches.float().numpy(),
                                   a.patches.float().numpy(), atol=4e-3)

    jext = JExtractor({"model": S2D, "batch_size": 3, "dtype": "float"})
    text = FeatureExtractor({"model": S2D, "batch_size": 3,
                             "dtype": "float"}, device="cpu")
    variables = jax.tree.map(np.asarray,
                             flax.core.unfreeze(jext.model.variables))
    text.model.load_state_dict(params_from_flax(variables))
    jman = jfeatures(jext, names, tmp_path, kps)
    tman = features_from_image_list(text, names, tmp_path, kps)
    for name in names:
        jmap, tmap = jman.fset(0).get_map(name), tman.fset(0).get_map(name)
        ids = tmap.keypoint_ids()
        want = np.stack([jmap.get_patch(i).data for i in ids])
        np.testing.assert_allclose(tmap.patches.numpy(), want, atol=1e-4)
        np.testing.assert_array_equal(
            tmap.corners, np.stack([jmap.get_patch(i).corner for i in ids]))


def test_extract_batch_refuses_mixed_sizes():
    ext = FeatureExtractor({"model": S2D}, device="cpu")
    imgs = [np.zeros((32, 40, 3), np.uint8), np.zeros((36, 40, 3), np.uint8)]
    with pytest.raises(ValueError, match="equal image sizes"):
        ext.extract_batch(imgs, [np.ones((1, 2))] * 2)


@pytest.mark.parametrize("src,dst", [((13, 18), (52, 72)), ((3, 4), (52, 72)),
                                     ((5, 7), (23, 31)), ((10, 10), (10, 17)),
                                     ((9, 6), (4, 6))])
def test_resize_bicubic_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = rng.normal(0, 1, (2, *src, 5)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bicubic")
    out = resize_bicubic(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_s2dnet_combine_matches_jax():
    """72x52: conv3_3 at 18x13 (ratio 4) and conv5_3 at 4x3 (ratios 18
    and 17.3) are upsampled onto conv1_2 and summed."""
    rng = np.random.default_rng(3)
    jm = JS2DNet({"num_layers": 3, "combine": True})
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(jm.variables))
    tm = S2DNet({"num_layers": 3, "combine": True}, device="cpu")
    tm.load_state_dict(params_from_flax(variables))
    assert tm.output_dims == [128] and tm.scales == [1]
    image = rng.uniform(0, 1, (52, 72, 3)).astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(image[None]))[0])[0]
    with torch.no_grad():
        out = tm(torch.from_numpy(image).permute(2, 0, 1)[None])
    assert len(out) == 1 and out[0].shape == (1, 128, 52, 72)
    np.testing.assert_allclose(out[0][0].permute(1, 2, 0).numpy(), ref,
                               atol=1e-4)


def test_keep_on_device_packs_like_default_maps(tmp_path):
    names, kps = _five_images(tmp_path)
    for sparse in (True, False):
        conf = {"model": S2D, "sparse": sparse}
        plain = features_from_image_list(
            FeatureExtractor(conf, device="cpu"), names, tmp_path, kps)
        dev = features_from_image_list(
            FeatureExtractor({**conf, "keep_on_device": True}, device="cpu"),
            names, tmp_path, kps)
        for name in names:
            assert isinstance(dev.fset(0).get_map(name),
                              tfm.DeviceFeatureMap)
        required = {n: list(range(4)) for n in names}
        a = tfm.FeatureView(plain.fset(0), required, keypoints=kps).packed
        b = tfm.FeatureView(dev.fset(0), required, keypoints=kps).packed
        assert torch.equal(a.patches, b.patches)
        np.testing.assert_array_equal(a.corners, b.corners)
        assert a.index == b.index and a.dense_images == b.dense_images


def test_device_feature_map_api_matches_jax():
    rng = np.random.default_rng(4)
    patches = rng.normal(0, 1, (3, 4, 4, 2)).astype(np.float32)
    ids, corners, scale = [7, 2, 5], rng.integers(0, 9, (3, 2)), [0.5, 0.25]
    jd = jfm.DeviceFeatureMap(jnp.asarray(patches), ids, corners, scale)
    td = tfm.DeviceFeatureMap(torch.from_numpy(patches), ids, corners, scale)
    assert td.keypoint_ids() == jd.keypoint_ids() and len(td) == len(jd)
    for kid in (7, 2, 5, 3):
        assert (kid in td) == (kid in jd)
    for kid in ids:
        jp, tp = jd.get_patch(kid), td.get_patch(kid)
        np.testing.assert_array_equal(tp.data.numpy(), jp.data)
        np.testing.assert_array_equal(tp.corner, jp.corner)
        np.testing.assert_array_equal(tp.scale, jp.scale)
        xy = np.array([3.0, 5.0])
        np.testing.assert_allclose(tp.to_pixel_coordinates(xy),
                                   jp.to_pixel_coordinates(xy))
        np.testing.assert_allclose(tp.to_image_coordinates(xy),
                                   jp.to_image_coordinates(xy))
    with pytest.raises(KeyError):
        td.get_patch(3)
    host = td.to_host()
    assert type(host) is tfm.FeatureMap and host.patches.device.type == "cpu"
    assert torch.equal(host.patches, td.batch)

    dense = rng.normal(0, 1, (6, 5, 2)).astype(np.float32)
    jdd = jfm.DeviceFeatureMap(jnp.asarray(dense), None, None, scale,
                               is_sparse=False, corner=(1, 2))
    tdd = tfm.DeviceFeatureMap(torch.from_numpy(dense), None, None, scale,
                               is_sparse=False, corner=(1, 2))
    assert tdd.is_dense and (12345 in tdd) and (12345 in jdd)
    assert tdd.keypoint_ids() == jdd.keypoint_ids()
    np.testing.assert_array_equal(tdd.get_patch(0).data.numpy(),
                                  jdd.get_patch(0).data)
    np.testing.assert_array_equal(tdd.corner, jdd.corner)
    jh, th = jdd.to_host(), tdd.to_host()
    assert th.is_dense and th.keypoint_ids() == jh.keypoint_ids()
    np.testing.assert_array_equal(
        th.get_patch(tfm.kDensePatchId).data.numpy(),
        jh.get_patch(jfm.kDensePatchId).data)
    with pytest.raises(ValueError, match="ids"):
        tfm.DeviceFeatureMap(torch.from_numpy(patches), None, None, scale)
