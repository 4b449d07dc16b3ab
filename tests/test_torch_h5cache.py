"""Port parity of the H5 feature and reference caches.

- A cache written by the JAX package's ``features_from_image_list`` (S2DNet
  on two small images) loads in the port with equal ids, corners and scales
  and bitwise equal bf16 patches, in both ``cache_format``s; a cache
  written by the port's loads in the JAX package the same way, sparse and
  dense.
- The dense-stored / sparse-loaded mode loads as the windows at the stored
  corners (the JAX package's loader fails on such a file: ROADMAP.md
  section 3).
- The port and its cache modules import without ``h5py``; the reference
  cache round-trips both ways.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.bundle_adjustment.references import Reference as JReference
from pixsfm_tpu.extract import features_from_image_list as jfeatures
from pixsfm_tpu.features import h5cache as jh5
from pixsfm_tpu.features.extractor import FeatureExtractor as JExtractor
from pixsfm_tpu.features.extractor import extract_patches_numpy
from pixsfm_tpu.features.featuremaps import FeatureManager as JManager
from pixsfm_tpu.features.store_references import (
    load_references_cache as jload_refs, write_references_cache as jwrite_refs)
from pixsfm_tpu_torch.bundle_adjustment.references import Reference
from pixsfm_tpu_torch.extract import (features_from_image_list,
                                      load_features_from_cache)
from pixsfm_tpu_torch.features import h5cache
from pixsfm_tpu_torch.features.extractor import FeatureExtractor
from pixsfm_tpu_torch.features.featuremaps import (FeatureManager,
                                                   FeatureView, kDensePatchId)
from pixsfm_tpu_torch.features.store_references import (
    load_references_cache, write_references_cache)

ROOT = Path(__file__).resolve().parents[1]
S2D = {"name": "s2dnet", "num_layers": 1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(tmp_path, sizes=((64, 48), (56, 40))):
    rng = np.random.default_rng(0)
    names, kps = [], {}
    for i, (w, h) in enumerate(sizes):
        name = f"im{i}.png"
        PIL.Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(tmp_path / name)
        names.append(name)
        kps[name] = rng.uniform([2, 2], [w - 2, h - 2], (5, 2))
    return names, kps


def _bits(patches) -> np.ndarray:
    """uint16 bits of bf16 patches (a tensor or an ml_dtypes array)."""
    if isinstance(patches, torch.Tensor):
        return patches.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(patches).view(np.uint16)


def _jax_rows(jmap, ids):
    return (np.stack([jmap.patches[i].data for i in ids]),
            np.stack([jmap.patches[i].corner for i in ids]),
            jmap.patches[ids[0]].scale)


@pytest.mark.parametrize("fmt", ["chunked", "grouped"])
def test_jax_cache_loads_in_port(tmp_path, fmt):
    names, kps = _images(tmp_path)
    path = tmp_path / "jax.h5"
    jfeatures(JExtractor({"model": S2D, "use_cache": True,
                          "cache_format": fmt}), names, tmp_path, kps,
              cache_path=path)
    jman = JManager.from_cache(path)
    tman = load_features_from_cache(path, device="cpu")
    assert tman.channels_per_level == [128] and tman.patch_size == 16
    fset = tman.fset(0)
    assert fset.image_names() == sorted(names)
    assert fset.has_image(names[0]) and not fset.has_image("x.png")
    for name in names:
        tmap = fset.get_map(name)
        assert tmap.patches.dtype == torch.bfloat16 and tmap.is_sparse
        ids = sorted(tmap.keypoint_ids())
        assert ids == list(range(5))
        patches, corners, scale = _jax_rows(jman.fset(0).get_map(name), ids)
        rows = [tmap.row_of(i) for i in ids]
        np.testing.assert_array_equal(_bits(tmap.patches[rows]),
                                      _bits(patches))
        np.testing.assert_array_equal(tmap.corners[rows], corners)
        np.testing.assert_array_equal(tmap.scale, scale)
    # a subset loads only the required rows
    sub = fset.get_map(names[1], required_ids=[3, 1])
    assert sorted(sub.keypoint_ids()) == [1, 3]
    assert not fset.maps                      # loaded on demand, not kept


@pytest.mark.parametrize("fmt,sparse", [("chunked", True), ("grouped", True),
                                        ("chunked", False)])
def test_port_cache_loads_in_jax(tmp_path, fmt, sparse):
    names, kps = _images(tmp_path)
    conf = {"model": S2D, "use_cache": True, "cache_format": fmt,
            "sparse": sparse}
    ext = FeatureExtractor(conf, device="cpu")
    path = tmp_path / "port.h5"
    cached = features_from_image_list(ext, names, tmp_path, kps,
                                      cache_path=path)
    plain = features_from_image_list(ext, names, tmp_path, kps)
    assert cached.fset(0).h5_path == path and not cached.fset(0).maps
    for name in names:
        ref = plain.fset(0).get_map(name)
        jmap = jh5.load_featuremap(path, "level_0", name)
        tmap = cached.fset(0).get_map(name)
        ids = ref.keypoint_ids()
        assert sorted(jmap.patches) == sorted(ids) == sorted(
            tmap.keypoint_ids())
        patches, corners, scale = _jax_rows(jmap, ids)
        np.testing.assert_array_equal(_bits(patches), _bits(ref.patches))
        np.testing.assert_array_equal(corners, ref.corners)
        np.testing.assert_array_equal(scale, ref.scale)
        np.testing.assert_array_equal(
            _bits(tmap.patches[[tmap.row_of(i) for i in ids]]),
            _bits(ref.patches))
        assert tmap.is_dense == (not sparse) == (ids == [kDensePatchId])
    # the cache is a resume point: a second call loads it
    again = features_from_image_list(ext, names, tmp_path, kps,
                                     cache_path=path)
    assert again.fset(0).image_names() == sorted(names)


def test_dense_stored_sparse_loaded(tmp_path):
    """More keypoint windows than the map holds: with a cache the map is
    stored dense with one corner per keypoint, and loads as the windows at
    those corners (JAX's ``extract_patches_numpy`` on the stored map)."""
    rng = np.random.default_rng(1)
    PIL.Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
                        ).save(tmp_path / "a.png")
    kps = {"a.png": rng.uniform([1, 1], [31, 23], (16, 2))}
    ids = [int(i) for i in rng.permutation(20)[:16]]
    ext = FeatureExtractor({"model": S2D, "use_cache": True,
                            "patch_size": 8}, device="cpu")
    path = tmp_path / "c.h5"
    man = features_from_image_list(ext, ["a.png"], tmp_path, kps,
                                   keypoint_ids_per_image={"a.png": ids},
                                   cache_path=path)
    import h5py
    with h5py.File(path, "r") as f:
        g = f["level_0"]["a.png"]
        assert not g.attrs["is_sparse"] and g["patches"].shape[0] == 1
        stored = g["patches"][0].view(np.uint16)
        corners = g["corners"][...]
    want_ids = ids[5:8]
    fmap = man.fset(0).get_map("a.png", required_ids=want_ids)
    assert fmap.is_sparse and sorted(fmap.keypoint_ids()) == sorted(want_ids)
    for kid in want_ids:
        r = ids.index(kid)
        want = extract_patches_numpy(stored, corners[r:r + 1], 8)[0]
        np.testing.assert_array_equal(
            _bits(fmap.get_patch(kid).data), want)
        np.testing.assert_array_equal(fmap.get_patch(kid).corner, corners[r])
    with pytest.raises(IndexError):
        jh5.load_featuremap(path, "level_0", "a.png")


def test_cache_backed_view_and_manager_api(tmp_path):
    names, kps = _images(tmp_path)
    ext = FeatureExtractor({"model": S2D, "use_cache": True}, device="cpu")
    path = tmp_path / "c.h5"
    features_from_image_list(ext, names, tmp_path, kps, cache_path=path)
    man = FeatureManager.from_cache(path, device="cpu")
    view = FeatureView.from_image_list(man.fset(0), names)
    packed = view.packed
    assert packed.num_patches == 10 and packed.patches.device.type == "cpu"
    assert packed.row(names[1], 0) == 5
    np.testing.assert_array_equal(
        packed.rows([(names[0], 4), (names[1], 2)]), [4, 7])
    fset = man.fset(0)
    fset.emplace("extra.png", fset.get_map(names[0]))
    assert fset.image_names() == sorted(names + ["extra.png"])
    assert fset.flush() is None
    fset.unload("extra.png")
    assert "extra.png" not in fset.image_names()
    fset.emplace("extra.png", fset.get_map(names[0]))
    fset.unload()
    assert not fset.maps and fset.image_names() == sorted(names)
    with pytest.raises(KeyError):
        FeatureManager([8], 8).fset(0).get_map("nothing")


def test_modules_import_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import pixsfm_tpu_torch\n"
            "from pixsfm_tpu_torch.features import h5cache, store_references\n"
            "import pixsfm_tpu_torch.extract, pixsfm_tpu_torch.refine_hloc\n"
            "try:\n"
            "    h5cache.init_cache('x.h5', [1], 8, 'half')\n"
            "except ImportError:\n"
            "    print('needs h5py')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "needs h5py"


def _references(cls, rng, full: bool):
    refs = {}
    for pid in (3, 11, 40):
        ref = cls(source=(int(rng.integers(1, 5)), int(rng.integers(0, 50))),
                  descriptor=rng.normal(0, 1, 16).astype(np.float32))
        if full:
            ref.node_offsets3D = rng.normal(0, 1, (4, 3))
            ref.observations = [(1, 2), (3, 4)]
            ref.costs = rng.uniform(0, 1, 2).astype(np.float32)
            ref.track_descriptors = rng.normal(0, 1, (2, 16)).astype(
                np.float32)
        refs[pid] = ref
    return refs


def _same_refs(a, b):
    assert a.keys() == b.keys()
    for pid in a:
        assert tuple(a[pid].source) == tuple(b[pid].source)
        np.testing.assert_array_equal(a[pid].descriptor, b[pid].descriptor)
        for k in ("node_offsets3D", "costs", "track_descriptors"):
            if getattr(a[pid], k) is None:
                assert getattr(b[pid], k) is None
            else:
                np.testing.assert_array_equal(getattr(a[pid], k),
                                              getattr(b[pid], k))
        assert a[pid].observations == b[pid].observations


def test_references_cache_round_trips_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    port = [_references(Reference, rng, False),
            _references(Reference, rng, True)]
    write_references_cache(tmp_path / "t.h5", port)
    for got in (jload_refs(tmp_path / "t.h5"),
                load_references_cache(tmp_path / "t.h5")):
        for a, b in zip(port, got):
            _same_refs(a, b)
    jax = [_references(JReference, rng, True)]
    jwrite_refs(tmp_path / "j.h5", jax)
    _same_refs(jax[0], load_references_cache(tmp_path / "j.h5")[0])


def test_h5cache_write_load_round_trip_keeps_dtypes(tmp_path):
    path = tmp_path / "c.h5"
    h5cache.init_cache(path, [3], 4, "float")
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        x = torch.randn(2, 4, 4, 3).to(dtype)
        h5cache.write_featuremap(path, "level_0", f"d/{dtype}", x, [7, 2],
                                 np.array([[1, 2], [3, 4]]), [0.5, 0.25])
        m = h5cache.load_featuremap(path, "level_0", f"d/{dtype}")
        assert m.patches.dtype == dtype and torch.equal(m.patches, x)
        assert m.keypoint_ids() == [7, 2]
    assert h5cache.read_cache_metadata(path) == ([3], 4, "float")
    assert sorted(h5cache.cache_image_names(path, "level_0"))[0].startswith(
        "d/")
    assert not h5cache.cache_has_image(path, "level_0", "nope")
    assert not h5cache.cache_has_image(tmp_path / "none.h5", "level_0", "x")
