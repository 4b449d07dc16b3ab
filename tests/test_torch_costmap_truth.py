"""Costmap BA with poses free against the truth, the port held to the JAX
package's runs as a distribution (moved out of ``tests/test_torch_ba.py``,
whose helpers it uses, so that the test suite's workers share the long
tests).
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu_torch.features import featuremaps as tfm
from tests.test_bundle_adjustment import perturb
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _to_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side, as in the file these tests
    came from: among the fast lane's parallel workers, torch's default
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_costmaps(jset):
    """The JAX package's costmap FeatureSet as the port's (CPU)."""
    out = tfm.FeatureSet(jset.channels, jset.patch_size, "float32")
    for name, jmap in jset.maps.items():
        ids = list(jmap.patches)
        ps = [jmap.patches[i] for i in ids]
        out.emplace(name, tfm.FeatureMap.from_arrays(
            np.stack([p.data for p in ps]), ids,
            np.stack([p.corner for p in ps]), ps[0].scale,
            upsampling_factor=ps[0].upsampling_factor))
    return out


@pytest.mark.parametrize("seed", [6, 0])
def test_costmap_ba_poses_free_to_truth(seed):
    """Costmap BA with poses free (the default optimizer flags, inner
    iterations on) over 15 LM iterations on ``featuremetric_scene`` (6
    views, 100 points; its truth is the unperturbed scene), from JAX's
    cost patches: JAX with its default ``obs_chunk`` and with 32, and the
    port. With seed 6 the three runs stay together; with seed 0 they part
    (JAX's two final costs 21 % apart), each keeping the median point
    error near its start while a few points leave the basin of their cost
    patches (zero gradient there) and fly off, so the mean error grows
    several-fold in JAX as in the port. Held as a distribution: the port's
    median error to the truth within 20 % of the range of JAX's two runs,
    and no more points than 2x JAX's most plus 2 end farther than 3x the
    starting mean error (``-s`` prints the readings)."""
    from pixsfm_tpu.bundle_adjustment import CostMapBundleAdjuster as JCM
    from pixsfm_tpu.bundle_adjustment.costmaps import \
        extract_costmaps as j_extract
    from pixsfm_tpu_torch.bundle_adjustment import CostMapBundleAdjuster
    from pixsfm_tpu_torch.bundle_adjustment.costmaps import costmap_solve

    class JRechunked(JCM):
        def _ba_options(self, **overrides):
            return super()._ba_options(obs_chunk=32, **overrides)

    conf = {"optimizer": {"solver": {"max_num_iterations": 15}},
            "interpolation": {"mode": "BICUBIC", "l2_normalize": False},
            "references": {"loss": {"name": "cauchy", "params": [0.25]},
                           "iters": 20}}
    truth, jfset = featuremetric_scene(seed=seed, n_images=6, n_points=100)

    def start():
        rec = truth.copy()
        perturb(rec, np.random.default_rng(seed), pose_rot=0.002, pose_t=0.01,
                point_sigma=0.02)
        return rec

    def errors(rec):
        return np.array([np.linalg.norm(rec.points3D[p].xyz - q.xyz)
                         for p, q in truth.points3D.items()])

    e0 = errors(start())
    jrec, jrec32, trec = start(), start(), _to_port(start())
    adj = JCM(conf)
    # the cost patches JAX's refine extracts (a deterministic function)
    cset = _port_costmaps(j_extract(
        jrec, jfset, adj.conf.costmaps, adj.conf.references,
        JInterp(mode="BICUBIC", l2_normalize=False))[0])
    outs = {"jax": (jrec, adj.refine(jrec, jfset)),
            "port": (trec, costmap_solve(
                CostMapBundleAdjuster(conf, device="cpu"), trec, cset)),
            "jax obs_chunk 32": (jrec32, JRechunked(conf).refine(jrec32,
                                                                 jfset))}
    runs = {}
    for name, (rec, out) in outs.items():
        assert out["iterations"] == 15
        assert out["final_cost"] < out["initial_cost"]
        e = errors(rec)
        assert np.isfinite(e).all()
        runs[name] = (float(np.median(e)), int((e > 3 * e0.mean()).sum()),
                      float(e.mean()), out["final_cost"])
    print(f"costmap BA, poses free, 15 LM iterations: start median "
          f"{np.median(e0):.5f} / mean {e0.mean():.5f}; " + "; ".join(
              f"{k}: median {m:.5f}, {n} beyond 3x, mean {a:.5f}, cost "
              f"{c:.6g}" for k, (m, n, a, c) in runs.items()))
    jm = [runs[k][0] for k in runs if k != "port"]
    assert 0.8 * min(jm) <= runs["port"][0] <= 1.2 * max(jm)
    assert runs["port"][1] <= 2 * max(runs[k][1] for k in runs
                                      if k != "port") + 2
