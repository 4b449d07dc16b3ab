"""Port parity: keypoint adjustment with the interpolation configs and
solver options beyond the default, against the JAX package on the CPU.

- 16-node NCC KA on the scene of JAX's ``test_multinode_ncc_ka_consensus``
  (a textured 1-channel field, where one point is an aperture problem):
  JAX's own assertions on the port (the cost below 1 % of the initial one,
  the track spread below 5 % of the initial one), and the keypoints within
  1e-3 px of the JAX package's.
- ``solve_ka_problems`` with BILINEAR, NEARESTNEIGHBOR and BICUBICCHAIN
  (plain PyTorch reads, never kernel K1) and with 2x2 NCC node windows
  on ``tests/test_torch_ka.py``'s smooth-field scene: the read at the
  start keypoints within 1e-5 of JAX's node-aware
  ``interpolate_with_grad``, keypoints within 1e-3 px and costs rtol
  1e-4, as that file's BICUBIC case (BICUBICCHAIN 1e-2 px and rtol 1e-3:
  see the test). Node windows without NCC: JAX's KA ignores them (a fault
  of the reference); the port's read is held to JAX's node-aware one.
- The fixed-target solver (QKA, ``topological_reference`` KA) with 2x2
  node windows: ``evaluate_descriptors`` within 1e-5, refined keypoints
  within 1e-4 px, costs rtol 1e-5, as ``tests/test_torch_localization.py``.
- Convergence compaction: ``compaction_segment = 5`` against 0 within
  0.05 px and 5 % of the final cost (JAX's
  ``test_ka_compaction_matches_plain``: warm-restarted damping changes the
  trajectory, not the optimum), and against the JAX package's segmented
  solve within 1e-3 px and rtol 1e-4.
- One block-Jacobi LM step (``cg_block_size`` 2: closed-form block
  inverses; 4: Cholesky) of ``solve_ka_problems`` (N = 48, the CG path)
  against the JAX package's: keypoints within 1e-4 px, costs rtol 1e-4.
"""

from dataclasses import asdict

import numpy as np
import pytest

from pixsfm_tpu.base import solver_default_conf
from pixsfm_tpu.base.graph import (compute_root_labels, compute_score_labels,
                                   compute_track_labels)
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.features.featuremaps import FeatureMap as JFeatureMap
from pixsfm_tpu.features.featuremaps import FeatureSet as JFeatureSet
from pixsfm_tpu.features.featuremaps import FeatureView
from pixsfm_tpu.keypoint_adjustment import \
    FeatureMetricKeypointAdjuster as JFKA
from pixsfm_tpu.keypoint_adjustment import (build_matching_graph,
                                            find_problem_labels)
from pixsfm_tpu.keypoint_adjustment import solver as jsolver
from pixsfm_tpu.ops.lm import LMOptions as JLMOptions
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.keypoint_adjustment import main as tmain
from pixsfm_tpu_torch.keypoint_adjustment import solver as tsolver
from pixsfm_tpu_torch.ops import interpolate_cuda
from pixsfm_tpu_torch.ops.lm import LMOptions
from tests.test_keypoint_adjustment import make_scene
from tests.test_torch_ba import _port_fset
from tests.test_torch_ka import _field_scene
from tests.test_torch_localization import _one_torch_thread  # noqa: F401

NODES4 = [[-0.5, -0.5], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]
NODES16 = [[dx, dy] for dy in (-1.5, -0.5, 0.5, 1.5)
           for dx in (-1.5, -0.5, 0.5, 1.5)]


class _Manager:
    num_levels = 1

    def __init__(self, fset):
        self._fset = fset

    def fset(self, level):
        return self._fset


def test_multinode_ncc_ka_matches_jax():
    rng = np.random.default_rng(0)
    n_kps, ps = 20, 16
    H = W = 96
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    field = (np.sin(0.37 * xx) * np.sin(0.41 * yy)
             + 0.3 * np.sin(0.13 * xx + 0.2 * yy))[..., None].astype(
        np.float32)
    true_xy = rng.uniform(ps, min(H, W) - ps, size=(n_kps, 2))
    names = [f"im{i}.jpg" for i in range(3)]
    fset = JFeatureSet(channels=1, patch_size=ps, dtype="float32")
    kps0 = {}
    for name in names:
        kp = true_xy + rng.uniform(-1.0, 1.0, true_xy.shape)
        corners = np.floor(kp - ps / 2).astype(np.int64)
        patches = np.stack([field[cy:cy + ps, cx:cx + ps]
                            for cx, cy in corners])
        fset.emplace(name, JFeatureMap.from_arrays(
            patches, list(range(n_kps)), corners, np.array([1.0, 1.0])))
        kps0[name] = kp.astype(np.float64)
    matches = {(names[i], names[j]): np.stack([np.arange(n_kps)] * 2, 1)
               for i in range(3) for j in range(i + 1, 3)}
    graph = build_matching_graph(matches)
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": False,
                              "ncc_normalize": True, "nodes": NODES16},
            "optimizer": {"loss": {"name": "trivial", "params": []},
                          "bound": 4.0},
            "max_kps_per_problem": 8}
    kps_t = {k: v.copy() for k, v in kps0.items()}
    out = tmain.FeatureMetricKeypointAdjuster(conf, device="cpu") \
        .refine_multilevel(kps_t, _Manager(_port_fset(fset, 1, ps)), graph)
    kps_j = {k: v.copy() for k, v in kps0.items()}
    JFKA(conf).refine_multilevel(kps_j, _Manager(fset), graph)
    assert np.sum(out["final_cost"]) < 0.01 * np.sum(out["initial_cost"])

    def spread(kd):
        a = np.stack([kd[n] for n in names])
        return np.linalg.norm(a - a.mean(0), axis=-1).mean()

    assert spread(kps_t) < 0.05 * spread(kps0)
    for n in names:
        np.testing.assert_allclose(kps_t[n], kps_j[n], atol=1e-3)


def _ka_problems():
    from pixsfm_tpu.keypoint_adjustment.solver import build_ka_problems
    keypoints, maps, matches = _field_scene(np.random.default_rng(5))
    fset = JFeatureSet(channels=16, patch_size=16, dtype="float32")
    for name, (patches, corners) in maps.items():
        fset.emplace(name, JFeatureMap.from_arrays(
            patches, list(range(len(patches))), corners, np.ones(2)))
    graph = build_matching_graph(matches)
    tracks = compute_track_labels(graph)
    roots = compute_root_labels(graph, tracks,
                                compute_score_labels(graph, tracks))
    labels, _ = find_problem_labels(tracks, 21)     # K = 24, N = 48: CG
    labels = np.asarray(labels)
    packed = FeatureView.from_graph(fset, graph, np.nonzero(labels >= 0)[0],
                                    keypoints=keypoints).packed
    return build_ka_problems(keypoints, graph, labels, roots, packed,
                             bound=4.0), packed


def _solve_both(problems, packed, interp, solver=None, **kw):
    solver_conf = dict(solver_default_conf, **(solver or {}))
    kp_j, sum_j = jsolver.solve_ka_problems(
        problems, packed.patches, JInterp(**interp), JLoss("cauchy", [0.25]),
        JLMOptions.from_solver_conf(solver_conf), chunk=2, **kw)
    kp_t, sum_t = tsolver.solve_ka_problems(
        tsolver.KAProblems(**asdict(problems)), packed.patches,
        InterpolationConfig(**interp), RobustLoss("cauchy", [0.25]),
        LMOptions.from_solver_conf(solver_conf), chunk=2, device="cpu", **kw)
    return (kp_t, sum_t), (kp_j, sum_j)


def _assert_ka_same(t, j, problems, atol=1e-3, rtol=1e-4):
    """Keypoints within ``atol``, costs within ``rtol``; the final cost
    also within 1e-6 of the initial one (these noise-free scenes reach
    float32's floor)."""
    (kp_t, sum_t), (kp_j, sum_j) = t, j
    valid = problems.kp_valid
    np.testing.assert_allclose(kp_t[valid], kp_j[valid], atol=atol)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(sum_t[k], sum_j[k], rtol=rtol,
                                   atol=1e-6 * sum_j["initial_cost"])
    assert sum_t["final_cost"] < sum_t["initial_cost"]


def _eval_both(problems, packed, interp):
    """``(f, dfdx, dfdy)`` at the start keypoints: the port's
    ``_eval_keypoints`` and the JAX package's node-aware
    ``interpolate_with_grad`` per keypoint (its generic KA read)."""
    import jax
    import jax.numpy as jnp
    import torch
    from pixsfm_tpu.base.interpolation import interpolate_with_grad
    P, K, _ = problems.kp0.shape
    patches = np.asarray(packed.patches)
    n, H, W, C = patches.shape
    kp = problems.kp0.astype(np.float32)
    uv = (kp * problems.scale - 0.5 - problems.corner) \
        * problems.ups[..., None]
    cfg = JInterp(**interp)
    f, dfdr, dfdc = jax.vmap(jax.vmap(
        lambda p, r, c: interpolate_with_grad(p, r, c, cfg)))(
        jnp.asarray(patches[problems.patch_row]), jnp.asarray(uv[..., 1]),
        jnp.asarray(uv[..., 0]))
    su = (problems.scale * problems.ups[..., None]).astype(np.float32)
    want = (np.asarray(f), np.asarray(dfdc) * su[..., 0:1],
            np.asarray(dfdr) * su[..., 1:2])
    T = torch.from_numpy
    got = tsolver._eval_keypoints(
        (T(patches).reshape(n * H, W, C), H, W, C,
         T(problems.patch_row.astype(np.int64))), T(kp),
        T(problems.corner.astype(np.float32)),
        T(problems.scale.astype(np.float32)),
        T(problems.ups.astype(np.float32)), InterpolationConfig(**interp))
    return [a.numpy() for a in got], want


@pytest.mark.parametrize("interp,atol,rtol", [
    (dict(mode="BILINEAR"), 1e-3, 1e-4),
    (dict(mode="NEARESTNEIGHBOR"), 1e-3, 1e-4),
    (dict(mode="BICUBICCHAIN"), 1e-2, 1e-3),
    (dict(mode="BICUBIC", l2_normalize=False, ncc_normalize=True,
          nodes=NODES4), 1e-3, 1e-4)],
    ids=["bilinear", "nearest", "chain", "nodes_ncc"])
def test_ka_modes_match_jax(monkeypatch, interp, atol, rtol):
    """The read at the start keypoints within 1e-5 (NCC 1e-4), then whole
    solves. BICUBICCHAIN on a feature map takes channels 1 and 2 as the
    derivatives of channel 0, which they are not: its normal equations
    are ill-conditioned and its 3 px steps carry float32 rounding of the
    two packages' CG to ~6e-3 px, so its solve is held at 1e-2 px and
    rtol 1e-3."""
    problems, packed = _ka_problems()
    got, want = _eval_both(problems, packed, interp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4 if interp.get(
            "ncc_normalize") else 1e-5)
    calls = []
    orig = interpolate_cuda.interpolate_rows
    monkeypatch.setattr(interpolate_cuda, "interpolate_rows",
                        lambda *a: calls.append(1) or orig(*a))
    t, j = _solve_both(problems, packed, interp)
    _assert_ka_same(t, j, problems, atol=atol, rtol=rtol)
    # only the Catmull-Rom configs reach the kernel's wrapper
    assert bool(calls) == (interp["mode"] == "BICUBIC")


def test_ka_nodes_without_ncc_read_the_window():
    """Node windows without NCC: the JAX package's KA takes its one-point
    BICUBIC branch (``keypoint_adjustment/solver.py:232`` checks the mode
    and NCC, not the nodes), so its solve is the one-node solve; the port
    reads the node window, held to JAX's node-aware
    ``interpolate_with_grad`` (1e-5). A fault of the reference, ROADMAP.md
    section 3: JAX's node solve lands on the port's one-node solve (1e-3
    px, as the solves of ``tests/test_torch_ka.py``)."""
    problems, packed = _ka_problems()
    interp = dict(mode="BICUBIC", l2_normalize=True, nodes=NODES4)
    got, want = _eval_both(problems, packed, interp)
    assert got[0].shape[-1] == 4 * 16
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5)
    (kp_t, sum_t), (kp_j, sum_j) = _solve_both(problems, packed, interp)
    # JAX's node solve is the one-node solve (the port's one-node solve is
    # held to JAX's in tests/test_torch_ka.py)
    kp_1, _ = tsolver.solve_ka_problems(
        tsolver.KAProblems(**asdict(problems)), packed.patches,
        InterpolationConfig(mode="BICUBIC"), RobustLoss("cauchy", [0.25]),
        LMOptions.from_solver_conf(dict(solver_default_conf)), chunk=2,
        device="cpu")
    valid = problems.kp_valid
    np.testing.assert_allclose(kp_j[valid], kp_1[valid], atol=1e-3)
    assert sum_t["final_cost"] < sum_t["initial_cost"]
    assert abs(sum_t["initial_cost"] - sum_j["initial_cost"]) \
        > 0.1 * sum_j["initial_cost"]


def test_target_problems_nodes_match_jax():
    """QKA's / topological_reference's fixed-target solver with 2x2 node
    windows: the node descriptors of perturbed keypoints against those of
    the true ones."""
    rng = np.random.default_rng(3)
    field = make_scene(seed=3)[0].astype(np.float32)
    n = 24
    true_xy = rng.uniform(16, 48, (n, 2))
    kp0 = true_xy + rng.uniform(-1.0, 1.0, (n, 2))
    corners = np.floor(kp0 - 8).astype(np.int64)
    patches = np.stack([field[cy:cy + 16, cx:cx + 16] for cx, cy in corners])
    rows = np.arange(n)
    scales = np.ones((n, 2), np.float32)
    ups = np.ones(n, np.float32)
    conf = dict(mode="BICUBIC", l2_normalize=True, nodes=NODES4)
    args = (patches, rows, true_xy, corners.astype(np.float32), scales, ups)
    tgt_j = jsolver.evaluate_descriptors(*args, JInterp(**conf))
    tgt_t = tsolver.evaluate_descriptors(*args, InterpolationConfig(**conf),
                                         device="cpu")
    assert tgt_t.shape == (n, 4 * patches.shape[-1])
    np.testing.assert_allclose(tgt_t, tgt_j, atol=1e-5)
    lo = (corners + 0.5).astype(np.float64)
    hi = lo + 16.0
    common = (kp0, rows.astype(np.int32), corners.astype(np.float32), scales,
              ups, tgt_j[:, None], np.ones((n, 1), np.float32), lo, hi,
              patches)
    opts = dict(solver_default_conf, max_num_iterations=20)
    kp_j, s_j = jsolver.solve_target_problems(
        *common, JInterp(**conf), JLoss("trivial", []),
        JLMOptions.from_solver_conf(opts))
    kp_t, s_t = tsolver.solve_target_problems(
        *common, InterpolationConfig(**conf), RobustLoss("trivial", []),
        LMOptions.from_solver_conf(opts), device="cpu")
    np.testing.assert_allclose(kp_t, kp_j, atol=1e-4)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(s_t[k], s_j[k], rtol=1e-5,
                                   atol=1e-6 * s_j["initial_cost"])
    assert np.abs(kp_t - true_xy).max() < 0.1 * np.abs(kp0 - true_xy).max()


def test_ka_compaction_matches_plain_and_jax():
    _, _, jfset, keypoints, matches, names = make_scene(seed=5)
    graph = build_matching_graph(matches)
    tfset = _port_fset(jfset, jfset.channels, 16)
    results = {}
    for seg in (0, 5):
        kps = {k: v.copy() for k, v in keypoints.items()}
        out = tmain.FeatureMetricKeypointAdjuster(
            {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
             "compaction_segment": seg}, device="cpu").refine_multilevel(
            kps, _Manager(tfset), graph)
        results[seg] = (kps, out["final_cost"][0])
    kps_j = {k: v.copy() for k, v in keypoints.items()}
    out_j = JFKA({"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
                  "compaction_segment": 5}).refine_multilevel(
        kps_j, _Manager(jfset), graph)
    for n in names:
        np.testing.assert_allclose(results[0][0][n], results[5][0][n],
                                   atol=0.05)
        np.testing.assert_allclose(results[5][0][n], kps_j[n], atol=1e-3)
    assert abs(results[0][1] - results[5][1]) < 0.05 * max(results[0][1],
                                                           1e-6)
    np.testing.assert_allclose(results[5][1], out_j["final_cost"][0],
                               rtol=1e-4)


@pytest.mark.parametrize("bs", [2, 4])
def test_block_jacobi_lm_step_matches_jax(bs):
    problems, packed = _ka_problems()
    assert problems.kp0.shape[1] * 2 % bs == 0
    t, j = _solve_both(problems, packed, dict(mode="BICUBIC"),
                       solver=dict(max_num_iterations=1, cg_block_size=bs,
                                   linear_solver="cg"))
    _assert_ka_same(t, j, problems, atol=1e-4)
