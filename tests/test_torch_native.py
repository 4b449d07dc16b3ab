"""Port parity of the native graph core (``pixsfm_tpu_torch/native``).

The port builds ``graph_core.cpp`` with g++ at first use and runs the track,
score and root labelings and the FFD packing above 10 000 tracks in it. On
random graphs with many tied similarities the native labels, the port's
numpy plain versions and the JAX package's labels are equal exactly; a build
that fails raises with the compiler's output.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.base import graph as jgraph
from pixsfm_tpu.keypoint_adjustment import main as jmain
from pixsfm_tpu_torch import native
from pixsfm_tpu_torch.base import graph as tgraph
from pixsfm_tpu_torch.keypoint_adjustment import main as tmain


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tied_matches(rng, n_images=6, n_kp=60, n_levels=4):
    """Pairwise matches whose similarities take only ``n_levels`` values, so
    most edges tie and the order of (sim, src, dst) decides the forest.
    The values are dyadic (``n_levels`` a power of two): the core sums a
    node's scores in edge order, numpy by source then destination, and
    dyadic sums are exact in any order, so scores and roots compare
    exactly."""
    names = [f"im{i}.jpg" for i in range(n_images)]
    matches, scores = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            m = np.stack([rng.permutation(n_kp)[:40],
                          rng.permutation(n_kp)[:40]], axis=1)
            matches[(a, b)] = m
            scores[(a, b)] = rng.integers(1, n_levels + 1, len(m)) / n_levels
    return matches, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_native_numpy_and_jax_equal(seed):
    rng = np.random.default_rng(seed)
    matches, scores = _tied_matches(rng, n_levels=2 ** seed)
    tg = tmain.build_matching_graph(matches, scores)
    jg = jmain.build_matching_graph(matches, scores)
    tl = tgraph.compute_track_labels(tg)
    np.testing.assert_array_equal(tl, tgraph.compute_track_labels_numpy(tg))
    np.testing.assert_array_equal(tl, jgraph.compute_track_labels(jg))
    sc = tgraph.compute_score_labels(tg, tl)
    np.testing.assert_array_equal(
        sc, tgraph.compute_score_labels_numpy(tg, tl))
    np.testing.assert_array_equal(sc, jgraph.compute_score_labels(jg, tl))
    rt = tgraph.compute_root_labels(tg, tl, sc)
    np.testing.assert_array_equal(
        rt, tgraph.compute_root_labels_numpy(tg, tl, sc))
    np.testing.assert_array_equal(rt, jgraph.compute_root_labels(jg, tl, sc))
    assert rt.sum() == tl.max() + 1


def test_tied_edges_resolve_in_reverse_lexicographic_order():
    """Equal similarities: the edge with the larger (src, dst) merges
    first, as ``np.lexsort((dst, src, sim))[::-1]`` orders them. Nodes 0
    and 2 lie in one image, so only one of the two tied edges to node 1 can
    merge: (2, 1) does."""
    graph = tgraph.Graph()
    graph.register_matches("a", "b", np.array([[0, 0]]), np.array([1.0]))
    graph.register_matches("a", "b", np.array([[1, 0]]), np.array([1.0]))
    a, b = graph.image_name_to_id["a"], graph.image_name_to_id["b"]
    src, dst, _ = graph.edges_array()
    assert list(graph.node_image_ids) == [a, b, a]
    assert sorted(zip(src.tolist(), dst.tolist())) == [(0, 1), (2, 1)]
    labels = tgraph.compute_track_labels(graph)
    np.testing.assert_array_equal(labels,
                                  tgraph.compute_track_labels_numpy(graph))
    assert labels[2] == labels[1] != labels[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_ffd_packing_above_10000_tracks_matches_jax(seed):
    """More than 10 000 tracks take the native packing in both packages;
    the labels in first-appearance order (which the Python loop would
    break ties by) equal JAX's, and the native packing equals its plain
    version."""
    rng = np.random.default_rng(seed)
    n_tracks = 12000
    labels = rng.permutation(np.repeat(np.arange(n_tracks),
                                       rng.integers(1, 7, n_tracks)))
    got = tmain.find_problem_labels(labels, 50)
    want = jmain.find_problem_labels(labels, 50)
    assert got[0] == want[0] and got[1] == want[1]
    counts = np.bincount(labels, minlength=n_tracks)
    t2p, n_bins = native.ffd_bin_packing_native(counts, 50)
    p2p, p_bins = tmain.ffd_bin_packing_numpy(counts, 50)
    np.testing.assert_array_equal(t2p, p2p)
    assert n_bins == p_bins == len(got[1])
    assert max(got[1]) <= 50


def test_build_at_first_use_and_failures_raise(tmp_path):
    """The library is built into a fresh directory at first use and keyed
    by the source's hash; a missing source or a missing compiler raises
    with what the compiler said."""
    src = tmp_path / "core.cpp"
    src.write_text(native.SOURCE.read_text())
    out = native.build(src, tmp_path / "build")
    assert out.exists() and out.parent == tmp_path / "build"
    assert native.build(src, tmp_path / "build") == out
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.build(src, tmp_path / "build") != out
    with pytest.raises(RuntimeError, match="failed to build") as err:
        native.build(tmp_path / "missing.cpp", tmp_path / "build")
    assert "missing.cpp" in str(err.value)
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build(src, tmp_path / "other", cxx=str(tmp_path / "no-g++"))


def test_native_validates_its_arguments():
    with pytest.raises(ValueError, match="node range"):
        native.compute_track_labels_native([0], [5], [1.0], [0, 1])
    with pytest.raises(ValueError, match="differ in length"):
        native.compute_score_labels_native(2, [0], [1, 0], [1.0], [0, 0])
    with pytest.raises(ValueError, match="track label"):
        native.compute_root_labels_native([0, -1], [1.0, 2.0])
