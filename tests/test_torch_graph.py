"""Port parity of the host layer: match graph, track/score/root labels,
first-fit-decreasing problem labels and the default configuration.

These are exact: the port keeps numpy copies of the JAX package's host
code, so labels and configs must be equal, scores equal to float64
rounding.
"""

import numpy as np
import pytest

from pixsfm_tpu.base import graph as jgraph
from pixsfm_tpu.config import load_config as jload_config
from pixsfm_tpu.keypoint_adjustment import main as jmain
from pixsfm_tpu_torch.base import graph as tgraph
from pixsfm_tpu_torch.config import load_config
from pixsfm_tpu_torch.keypoint_adjustment import main as tmain


def _random_matches(rng, n_images=5, n_kp=40):
    """Random pairwise matches with similarities; many of them conflict
    (two keypoints of one image pulled into one track)."""
    names = [f"im{i}.jpg" for i in range(n_images)]
    matches, scores = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            m = np.stack([rng.permutation(n_kp)[:25],
                          rng.permutation(n_kp)[:25]], axis=1)
            matches[(a, b)] = m
            scores[(a, b)] = rng.uniform(0.2, 1.0, len(m))
    return matches, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_labels_match_jax(seed):
    rng = np.random.default_rng(seed)
    matches, scores = _random_matches(rng)
    jg = jmain.build_matching_graph(matches, scores)
    tg = tmain.build_matching_graph(matches, scores)
    for a, b in zip(jg.nodes_array() + jg.edges_array(),
                    tg.nodes_array() + tg.edges_array()):
        np.testing.assert_array_equal(a, b)
    jt = jgraph.compute_track_labels(jg)
    tt = tgraph.compute_track_labels(tg)
    np.testing.assert_array_equal(tt, jt)
    js = jgraph.compute_score_labels(jg, jt)
    ts = tgraph.compute_score_labels(tg, tt)
    np.testing.assert_allclose(ts, js, rtol=1e-12)
    np.testing.assert_array_equal(tgraph.compute_root_labels(tg, tt, ts),
                                  jgraph.compute_root_labels(jg, jt, js))
    # one keypoint per image per track
    img, _ = tg.nodes_array()
    for t in np.unique(tt):
        assert len(set(img[tt == t])) == int((tt == t).sum())


@pytest.mark.parametrize("max_per_problem", [4, 7, 50, -1])
def test_problem_labels_match_jax(max_per_problem):
    rng = np.random.default_rng(2)
    tracks = rng.integers(0, 60, 400)
    jl, jb = jmain.find_problem_labels(tracks, max_per_problem)
    tl, tb = tmain.find_problem_labels(tracks, max_per_problem)
    assert tl == jl and tb == jb


def test_default_configs_match_jax():
    assert load_config("default").to_dict() == \
        jload_config("default").to_dict()
    jka = jmain.KeypointAdjuster.create(None)
    tka = tmain.KeypointAdjuster.create(None, device="cpu")
    assert type(tka).__name__ == type(jka).__name__
    assert tka.conf.to_dict() == jka.conf.to_dict()


def test_unported_strategies_raise():
    """Multi-device KA builds its mesh from the knob (CPU shards here);
    ``topological_reference`` is ported and dispatches to its adjuster, as
    in the JAX package."""
    ka = tmain.KeypointAdjuster.create({"strategy": "topological_reference"},
                                       device="cpu")
    assert type(ka).__name__ == type(jmain.KeypointAdjuster.create(
        {"strategy": "topological_reference"})).__name__
    mesh = tmain.KeypointAdjuster(
        {"parallel": {"enabled": True, "n_devices": 4}},
        device="cpu")._parallel_mesh()
    assert mesh is not None and mesh.size == 4
