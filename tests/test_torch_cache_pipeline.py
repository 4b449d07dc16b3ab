"""The H5 feature cache through the port's entry points, and the host helpers.

- ``PixSfM.triangulation`` with ``use_cache: true`` and a ``cache_path`` on
  ``tests/test_torch_sfm.py::_write_plane_scene``: the first call extracts
  and writes the cache, the second loads it and extracts nothing; both give
  the same model. KA equals the run without a cache exactly (the cache holds
  the bits it extracted); BA, which reads the cached KA windows instead of
  windows at the reprojections (the JAX package's cache semantics), agrees
  with it within 1e-3 (points of a unit-scale scene) and its cost within
  rtol 1e-3.
- ``QueryLocalizer(dense_features=<cache path>)`` builds the references the
  in-memory features give.
- ``util/visualize.py`` (Agg; ``epipolar_line`` equal to JAX's), the
  ``util/misc.py`` memory helpers and ``eval/eth3d/download.ensure_dataset``.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.util import misc as jmisc
from pixsfm_tpu.util import visualize as jvis
from pixsfm_tpu_torch import util
from pixsfm_tpu_torch.eval.eth3d.download import ensure_dataset
from pixsfm_tpu_torch.extract import features_from_graph
from pixsfm_tpu_torch.features.extractor import FeatureExtractor
from pixsfm_tpu_torch.keypoint_adjustment import build_matching_graph
from pixsfm_tpu_torch.localization import QueryLocalizer
from pixsfm_tpu_torch.refine_hloc import PixSfM
from pixsfm_tpu_torch.util import misc, visualize
from pixsfm_tpu_torch.util.hloc import (read_image_pairs, read_keypoints_hloc,
                                        read_matches_hloc)
from tests.test_torch_sfm import _write_plane_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_extractions(monkeypatch):
    calls = []
    call = FeatureExtractor.__call__

    def counted(self, *a, **k):
        calls.append(1)
        return call(self, *a, **k)

    monkeypatch.setattr(FeatureExtractor, "__call__", counted)
    return calls


def _same_models(a, b):
    assert a.points3D.keys() == b.points3D.keys()
    for pid, p in a.points3D.items():
        np.testing.assert_array_equal(b.points3D[pid].xyz, p.xyz)
    for iid, im in a.images.items():
        np.testing.assert_array_equal(b.images[iid].xys, im.xys)


def test_triangulation_with_cache_path(tmp_path, monkeypatch):
    keypoints, P3, paths = _write_plane_scene(tmp_path, n_points=12)
    ref = tmp_path / "ref"
    plain_rec, plain = PixSfM({}, device="cpu").triangulation(
        tmp_path / "o0", ref, tmp_path, *paths)
    sfm = PixSfM({"dense_features": {"use_cache": True}}, device="cpu")
    cache = sfm.resolve_cache_path(output_dir=tmp_path / "cache")
    assert cache == tmp_path / "cache" / "s2dnet_featuremaps_sparse.h5"
    cache.parent.mkdir()
    calls = _count_extractions(monkeypatch)
    rec1, out1 = sfm.triangulation(tmp_path / "o1", ref, tmp_path, *paths,
                                   cache_path=cache)
    assert len(calls) == 4 and cache.exists()      # KA's four views only
    rec2, out2 = sfm.triangulation(tmp_path / "o2", ref, tmp_path, *paths,
                                   cache_path=cache)
    assert len(calls) == 4                          # nothing extracted
    _same_models(rec1, rec2)
    assert out1["BA"]["final_cost"] == out2["BA"]["final_cost"]
    assert out1["KA"]["final_cost"] == plain["KA"]["final_cost"]
    for iid, im in plain_rec.images.items():
        np.testing.assert_array_equal(rec1.images[iid].xys, im.xys)
    assert rec1.points3D.keys() == plain_rec.points3D.keys()
    for pid, p in plain_rec.points3D.items():
        np.testing.assert_allclose(rec1.points3D[pid].xyz, p.xyz, atol=1e-3)
    np.testing.assert_allclose(out1["BA"]["final_cost"],
                               plain["BA"]["final_cost"], rtol=1e-3)

    # the localizer's references from the cache path equal those of the
    # same features held in memory
    pairs = read_image_pairs(paths[0])
    kps = read_keypoints_hloc(paths[1])
    for k in kps:
        kps[k] = kps[k] + 0.5
    mlist, slist = read_matches_hloc(paths[2], pairs)
    graph = build_matching_graph(dict(zip(map(tuple, pairs), mlist)),
                                 dict(zip(map(tuple, pairs), slist)))
    memory = features_from_graph(sfm.extractor, tmp_path, graph, kps)
    a = QueryLocalizer(rec1, dense_features=cache, device="cpu").references
    b = QueryLocalizer(rec1, dense_features=memory, device="cpu").references
    assert len(a) == len(b) == 1 and a[0].keys() == b[0].keys()
    for pid in b[0]:
        assert a[0][pid].source == b[0][pid].source
        np.testing.assert_array_equal(a[0][pid].descriptor,
                                      b[0][pid].descriptor)


def test_visualize_writes_files_and_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    F = rng.normal(0, 1, (3, 3))
    for xy in ([10.0, 20.0], [3.0, -4.0]):
        for a, b in zip(visualize.epipolar_line(F, np.array(xy), 64),
                        jvis.epipolar_line(F, np.array(xy), 64)):
            np.testing.assert_array_equal(a, b)
    F[1] = 0.0                                  # a vertical line
    for a, b in zip(visualize.epipolar_line(F, np.array([1.0, 2.0]), 64),
                    jvis.epipolar_line(F, np.array([1.0, 2.0]), 64)):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
    before = rng.uniform(0, 48, (10, 2))
    visualize.plot_keypoint_displacements(img, before, before + 0.5,
                                          path=tmp_path / "kp.png")
    assert (tmp_path / "kp.png").stat().st_size > 0
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    visualize.draw_epipolar_lines(ax, F, before[:3], 64)
    assert len(ax.lines) == 3
    plt.close(fig)
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=3, n_points=30, seed=1)
    visualize.plot_reconstruction_3d(rec, path=tmp_path / "rec.html")
    assert (tmp_path / "rec.png").exists() or (tmp_path / "rec.html").exists()


def test_misc_helpers_and_ensure_dataset(tmp_path):
    assert misc.total_memory() == jmisc.total_memory() > 0
    assert 0 < misc.free_memory() <= misc.total_memory()
    assert util.free_memory is misc.free_memory
    misc.check_memory(float("nan"))
    misc.check_memory(2.0 ** 60)
    for lv in (None, "all", [1, 0], [2]):
        assert misc.resolve_level_indices(lv, 3) == \
            jmisc.resolve_level_indices(lv, 3)
    assert misc.to_ctr({"a": 1}) == jmisc.to_ctr({"a": 1}) == {"a": 1}
    from pixsfm_tpu_torch.config import merge
    assert misc.to_ctr(merge({"a": {"b": 2}})) == {"a": {"b": 2}}
    (tmp_path / "courtyard").mkdir()
    assert ensure_dataset(tmp_path, ["courtyard"])
    assert not ensure_dataset(tmp_path, ["courtyard", "facade"])
