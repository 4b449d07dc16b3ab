"""Port parity: multi-device sharding (``pixsfm_tpu_torch/parallel``) on the
CPU, where a mesh of ``n`` shards names the CPU ``n`` times and its shards
run in turn (the counterpart of the JAX tests' 8 virtual host devices).

- ``sharded_ba_solve`` against the port's unsharded ``ba_solve`` and the JAX
  package's ``sharded_ba_solve`` on its 8 devices, on
  ``tests/test_sharded_ba.py``'s problem and limits (cost rtol 1e-3,
  ``xyz`` / ``tvec`` atol 1e-3);
- ``sharded_ka_solve`` on ``test_sharded_ka_matches_single_device``'s
  problem against JAX's ``sharded_ka_solve`` and the port's unsharded solve
  (keypoints atol 5e-4, cost rtol 1e-4);
- ``sharded_reference_extraction`` equal to ``extract_references`` (1e-5);
- the ``parallel`` knob of every BA strategy (``feature_reference`` in its
  window layout, ``patch_warp`` with joint source poses, ``costmap``), of
  KA and of ``localize_batch`` against the port's unsharded run, with
  ``tests/test_parallel_pipeline.py``'s limits;
- the knob flowing from ``mapping.parallel`` to both strategies;
- shards that are real: no residual evaluation, and no KA chunk solve,
  sees more than one shard's share of the observations or problems.
"""

import copy

import numpy as np
import pytest
import torch

from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.bundle_adjustment import (
    CostMapBundleAdjuster, FeatureReferenceBundleAdjuster,
    PatchWarpBundleAdjuster, extract_references)
from pixsfm_tpu_torch.bundle_adjustment.main import (_build_geometric,
                                                     _build_geometric_jac)
from pixsfm_tpu_torch.bundle_adjustment.problem import pack_ba_problem
from pixsfm_tpu_torch.features.featuremaps import FeatureView
from pixsfm_tpu_torch.keypoint_adjustment import solver as tsolver
from pixsfm_tpu_torch.ops.lm import LMOptions
from pixsfm_tpu_torch.ops.schur import (BAObservations, BAOptions, BAState,
                                        ba_solve, make_pair_list)
from pixsfm_tpu_torch.parallel import (Mesh, make_mesh, parallel_mesh,
                                       shard_ka_chunk, sharded_ba_solve,
                                       sharded_ka_solve,
                                       sharded_reference_extraction)
from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _port_fset, _to_port
from tests.test_torch_localization import _port_camera

MESH8 = make_mesh(8, "cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small-op solves (as in
    ``tests/test_torch_ba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Manager:
    num_levels = 1

    def __init__(self, fset):
        self._fset = fset

    def fset(self, level):
        return self._fset


def _knob(conf, n=8):
    return dict(copy.deepcopy(conf),
                parallel={"enabled": True, "n_devices": n})


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_and_shard_ka_chunk():
    """A mesh is its ordered devices (one may repeat); ``make_mesh(n,
    "cpu")`` names the CPU n times; ``shard_ka_chunk`` splits a batch as
    ``PartitionSpec(axis)`` splits a mesh-divisible one: contiguous slices
    of ``ceil(n / size)`` in order, each on its shard's device."""
    mesh = Mesh(["cpu", torch.device("cpu")], axis="q")
    assert mesh.size == 2 and mesh.axis_names == ("q",)
    assert make_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu").size == 1
    place = shard_ka_chunk(Mesh(["cpu"] * 4))
    parts = place(np.arange(10), dtype=torch.int64)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                           [9]]
    assert [p.shape[0] for p in place(torch.zeros(8, 2))] == [2, 2, 2, 2]
    with pytest.raises(ValueError):
        Mesh([])


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

def _ba_problem():
    """``tests/test_sharded_ba.py``'s problem in the port's arrays."""
    rec = synthetic_reconstruction(n_images=4, n_points=30, noise_px=0.5,
                                   seed=55)
    packed = pack_ba_problem(rec)
    po1, po2 = make_pair_list(packed.obs_pt, len(packed.point_ids))

    def T(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    obs = BAObservations(
        T(packed.obs_img, torch.long), T(packed.obs_cam, torch.long),
        T(packed.obs_pt, torch.long), (T(packed.obs_xy, torch.float32),),
        torch.ones(len(packed.obs_img), dtype=torch.bool),
        T(po1, torch.long), T(po2, torch.long))
    state0 = BAState(*(T(a, torch.float32) for a in (
        packed.qvec, packed.tvec, packed.cams, packed.xyz)))
    free = (T(packed.pose_free), T(packed.tvec_free), T(packed.cam_free),
            T(packed.point_free))
    return packed, obs, state0, free


@pytest.mark.parametrize("against", ["port", "port-cg", "jax"])
def test_sharded_ba_solve_matches(against):
    """The port's ``sharded_ba_solve`` over 8 CPU shards against the port's
    unsharded solve (the dense step, whose pairs read across shards; and
    flat CG with inner point iterations), and against the JAX package's
    ``sharded_ba_solve`` on its 8 virtual devices (dense): cost rtol 1e-3,
    ``xyz`` / ``tvec`` atol 1e-3."""
    packed, obs, state0, free = _ba_problem()
    model = packed.cam_model
    cg = against == "port-cg"
    opts = BAOptions(max_iterations=5, obs_chunk=64, use_inner_iterations=cg,
                     linear_solver="cg" if cg else "dense")
    state_sh, sum_sh = sharded_ba_solve(
        _build_geometric(model), state0, obs, RobustLoss("trivial"), *free,
        opts, MESH8, residual_jac_fn=_build_geometric_jac(model))
    if against != "jax":
        ref, sum_ref = ba_solve(
            _build_geometric(model), state0, obs, RobustLoss("trivial"),
            *free, opts=opts, residual_jac_fn=_build_geometric_jac(model))
        ref_xyz, ref_tvec = ref.xyz.numpy(), ref.tvec.numpy()
    else:
        import jax
        from pixsfm_tpu.base.losses import RobustLoss as JLoss
        from pixsfm_tpu.ops import schur as jschur
        from pixsfm_tpu.parallel.sharded import make_mesh as j_mesh
        from pixsfm_tpu.parallel.sharded import sharded_ba_solve as j_solve
        from tests.test_sharded_ba import _problem
        assert len(jax.devices()) >= 8
        jpacked, j_residual, jobs, jstate0 = _problem()
        jref, sum_ref = j_solve(
            j_residual, jstate0, jobs, JLoss("trivial"), jpacked.pose_free,
            jpacked.tvec_free, jpacked.cam_free, jpacked.point_free,
            jschur.BAOptions(max_iterations=5, obs_chunk=64,
                             use_inner_iterations=False), j_mesh(8))
        ref_xyz, ref_tvec = np.asarray(jref.xyz), np.asarray(jref.tvec)
    assert sum_sh["final_cost"] < sum_sh["initial_cost"]
    np.testing.assert_allclose(float(sum_sh["final_cost"]),
                               float(sum_ref["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(state_sh.xyz.numpy(), ref_xyz, atol=1e-3)
    np.testing.assert_allclose(state_sh.tvec.numpy(), ref_tvec, atol=1e-3)


def _ka_problem():
    """``test_sharded_ka_matches_single_device``'s problem (numpy)."""
    rng = np.random.default_rng(3)
    P, K, E, C, ps = 12, 6, 10, 8, 16
    field = rng.normal(0, 1, (ps, ps, C)).astype(np.float32)
    patches = (field[None] + 0.05 * rng.normal(
        0, 1, (P * K, ps, ps, C))).astype(np.float32)
    kp0 = rng.uniform(5.0, 11.0, (P, K, 2)).astype(np.float32)
    arrays = dict(
        kp0=kp0,
        patch_row=np.arange(P * K, dtype=np.int32).reshape(P, K),
        corner=np.zeros((P, K, 2), np.float32),
        scale=np.ones((P, K, 2), np.float32),
        ups=np.ones((P, K), np.float32),
        kp_free=np.ones((P, K), bool),
        kp_valid=np.ones((P, K), bool),
        edge_i=rng.integers(0, K, (P, E)).astype(np.int32),
        edge_j=(rng.integers(1, K, (P, E))
                + np.arange(P)[:, None] * 0).astype(np.int32) % K,
        edge_w=np.ones((P, E), np.float32),
        lower=kp0 - 3.0, upper=kp0 + 3.0,
        node_problem=np.zeros(1, np.int64),
        node_slot=np.zeros(1, np.int64),
        node_ids=np.zeros(1, np.int64))
    return arrays, patches


def test_sharded_ka_solve_matches():
    """``sharded_ka_solve`` over 8 CPU shards against the JAX package's
    over its 8 devices and the port's unsharded ``solve_ka_problems``:
    keypoints atol 5e-4, final cost rtol 1e-4."""
    import jax
    from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
    from pixsfm_tpu.base.losses import RobustLoss as JLoss
    from pixsfm_tpu.keypoint_adjustment.solver import KAProblems
    from pixsfm_tpu.ops.lm import LMOptions as JLMOptions
    from pixsfm_tpu.parallel.sharded import make_mesh as j_mesh
    from pixsfm_tpu.parallel.sharded import sharded_ka_solve as j_solve

    arrays, patches = _ka_problem()
    interp = InterpolationConfig(mode="BICUBIC", l2_normalize=True)
    loss = RobustLoss("cauchy", [0.25])
    opts = LMOptions(max_iterations=15, parameter_tolerance=1e-6)
    problems = tsolver.KAProblems(**arrays)
    kp_sh, sum_sh = sharded_ka_solve(problems, patches, interp, loss, opts,
                                     MESH8)
    kp_one, sum_one = tsolver.solve_ka_problems(
        problems, patches, interp, loss, opts, chunk=12, device="cpu")
    kp_j, sum_j = j_solve(
        KAProblems(**arrays), patches,
        JInterp(mode="BICUBIC", l2_normalize=True), JLoss("cauchy", [0.25]),
        JLMOptions(max_iterations=15, parameter_tolerance=1e-6),
        j_mesh(len(jax.devices())))
    assert sum_sh["final_cost"] < sum_sh["initial_cost"]
    for kp, s in ((kp_one, sum_one), (kp_j, sum_j)):
        np.testing.assert_allclose(kp_sh, kp, atol=5e-4)
        np.testing.assert_allclose(sum_sh["final_cost"], s["final_cost"],
                                   rtol=1e-4)
    assert sum_sh["num_problems"] == sum_j["num_problems"] == 12


def test_sharded_reference_extraction_matches():
    """References with both device stages over 8 CPU shards of the points
    equal the unsharded ones (descriptors and costs within 1e-5, the same
    source observations)."""
    jrec, jfset = featuremetric_scene(seed=11, n_images=4, n_points=24)
    rec, fset = _to_port(jrec), _port_fset(jfset, 8, 16)
    view = FeatureView.from_reconstruction(fset, rec,
                                           pack_ba_problem(rec).point_ids)
    interp = InterpolationConfig(mode="BICUBIC", l2_normalize=False)
    conf = {"loss": {"name": "cauchy", "params": [0.25]}, "iters": 10,
            "keep_observations": True}
    one = extract_references(rec, fset, view, conf, interp)
    sharded = sharded_reference_extraction(rec, fset, view, conf, interp,
                                           MESH8)
    assert set(one) == set(sharded) and len(one) == 24
    for pid, a in one.items():
        b = sharded[pid]
        assert a.source == b.source
        np.testing.assert_allclose(b.descriptor, a.descriptor, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(b.costs, a.costs, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the parallel knob of the adjusters
# ---------------------------------------------------------------------------

def _registered(rec):
    return {im.name: (np.asarray(im.qvec), np.asarray(im.tvec))
            for im in rec.images.values()}


_FM_BASE = {
    "interpolation": {"mode": "BICUBIC", "l2_normalize": False},
    "optimizer": {"loss": {"name": "cauchy", "params": [0.25]},
                  "solver": {"max_num_iterations": 10}},
    "references": {"loss": {"name": "cauchy", "params": [0.25]},
                   "iters": 10},
}
_PW_BASE = {
    "interpolation": {"mode": "BICUBIC", "l2_normalize": False,
                      "ncc_normalize": False,
                      "nodes": [[float(dx), float(dy)] for dy in (-1.5, 0.5)
                                for dx in (-0.5, 1.5)]},
    "optimizer": {"loss": {"name": "trivial", "params": []},
                  "refine_extrinsics": True, "refine_focal_length": False,
                  "refine_extra_params": False,
                  "solver": {"max_num_iterations": 8,
                             "use_inner_iterations": False}},
    "references": {"loss": {"name": "cauchy", "params": [0.25]},
                   "iters": 5, "compute_offsets3D": False},
}
_CM_BASE = {
    "interpolation": {"mode": "BICUBIC", "l2_normalize": False},
    "optimizer": {"loss": {"name": "trivial", "params": []},
                  "refine_extrinsics": False, "refine_focal_length": False,
                  "refine_extra_params": False,
                  "solver": {"max_num_iterations": 10,
                             "use_inner_iterations": False}},
    "references": {"loss": {"name": "cauchy", "params": [0.25]},
                   "iters": 5},
    "costmaps": {"loss": {"name": "trivial", "params": []}},
}
# (adjuster, conf, scene seed, images, points, point jitter seed, layout)
_STRATEGIES = {
    "feature_reference": (FeatureReferenceBundleAdjuster, _FM_BASE, 7, 4, 30,
                          None, "feature_reference_window"),
    "patch_warp": (PatchWarpBundleAdjuster, _PW_BASE, 13, 3, 14, 3,
                   "patch_warp_window"),
    "costmap": (CostMapBundleAdjuster, _CM_BASE, 21, 3, 12, 4,
                "costmap_window"),
}
_STRATEGIES["patch_warp-cg"] = _STRATEGIES["patch_warp"]


@pytest.mark.parametrize("strategy", list(_STRATEGIES))
def test_ba_knob_matches_unsharded(monkeypatch, strategy):
    """``parallel: {enabled: true, n_devices: 8}`` on each BA strategy
    (its ``*_window`` layout, the observations over 8 CPU shards, the
    references of ``feature_reference`` too; these small scenes take the
    dense step, and ``patch_warp-cg`` forces flat CG, whose matvec then
    applies each shard's per-observation source-pose blocks) against the
    unsharded run, with ``tests/test_parallel_pipeline.py``'s limits:
    final cost rtol 1e-3, qvec atol 2e-4, tvec atol 2e-3, points atol
    5e-3."""
    from pixsfm_tpu_torch.bundle_adjustment import main as tmain
    cls, base, seed, n_images, n_points, jitter, layout = \
        _STRATEGIES[strategy]
    if strategy.endswith("-cg"):
        class cls(cls):
            def _ba_options(self, **overrides):
                return super()._ba_options(linear_solver="cg", **overrides)
    jrec, jfset = featuremetric_scene(seed=seed, n_images=n_images,
                                      n_points=n_points)
    if jitter is not None:
        rng = np.random.default_rng(jitter)
        for p in jrec.points3D.values():
            p.xyz = p.xyz + rng.normal(0, 0.005, 3)
    fset = _port_fset(jfset, 8, 16)
    rec_a, rec_b = _to_port(jrec), _to_port(jrec)
    out_a = cls(base, device="cpu").refine(rec_a, fset)

    keys = []
    run = tmain.BundleAdjuster._run_ba_cached

    def spy(self, rec, packed, residual_key, *args, **kw):
        keys.append(residual_key[0])
        return run(self, rec, packed, residual_key, *args, **kw)

    monkeypatch.setattr(tmain.BundleAdjuster, "_run_ba_cached", spy)
    adj = cls(_knob(base), device="cpu")
    assert adj._parallel_mesh().size == 8
    out_b = adj.refine(rec_b, fset)
    assert keys == [layout]
    assert out_b["linear_solver"] == out_a["linear_solver"] == (
        "cg" if strategy.endswith("-cg") else "dense")
    assert out_b["final_cost"] < out_b["initial_cost"]
    np.testing.assert_allclose(out_b["final_cost"], out_a["final_cost"],
                               rtol=1e-3)
    pa, pb = _registered(rec_a), _registered(rec_b)
    for name in pa:
        np.testing.assert_allclose(pb[name][0], pa[name][0], atol=2e-4)
        np.testing.assert_allclose(pb[name][1], pa[name][1], atol=2e-3)
    xa = np.stack([p.xyz for p in rec_a.points3D.values()])
    xb = np.stack([p.xyz for p in rec_b.points3D.values()])
    np.testing.assert_allclose(xb, xa, atol=5e-3)


def test_ka_knob_matches_unsharded(monkeypatch):
    """KA with ``parallel.n_devices: 8`` (the problem axis over 8 CPU
    shards; one track per problem and a per-device chunk of 8 problems,
    so that two shards work) against the unsharded solve: total final cost
    rtol 1e-3, keypoints atol 5e-3
    (``test_ka_parallel_conf_matches_single_device``)."""
    from pixsfm_tpu_torch.keypoint_adjustment import (
        FeatureMetricKeypointAdjuster, build_matching_graph)
    from tests.test_keypoint_adjustment import make_scene

    base = {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
            "optimizer": {"loss": {"name": "trivial", "params": []}},
            "max_kps_per_problem": 3, "problem_chunk_size": 8}
    _, _, jfset, kps0, matches, names = make_scene(seed=11)
    fset = _port_fset(jfset, jfset.channels, jfset.patch_size)
    outs, kps = [], []
    sizes = []
    run = tsolver._run_chunk

    def spy(*args, **kw):
        sizes.append(args[5].shape[0])
        return run(*args, **kw)

    monkeypatch.setattr(tsolver, "_run_chunk", spy)
    for conf in (base, _knob(base)):
        k = {n: v.copy() for n, v in kps0.items()}
        outs.append(FeatureMetricKeypointAdjuster(conf, device="cpu")
                    .refine_multilevel(k, _Manager(fset),
                                       build_matching_graph(matches)))
        kps.append(k)
    assert sizes == [8, 8, 8, 8]     # 12 problems: 2 chunks, then 2 shards
    np.testing.assert_allclose(np.sum(outs[1]["final_cost"]),
                               np.sum(outs[0]["final_cost"]), rtol=1e-3)
    for name in names:
        np.testing.assert_allclose(kps[1][name], kps[0][name], atol=5e-3)


def test_localize_batch_knob_matches_unsharded():
    """``QueryLocalizer.localize_batch`` with ``parallel.n_devices: 8``
    (QKA problems, PnP queries and QBA queries over 8 CPU shards) against
    the unsharded batch: both succeed, qvec atol 2e-4, tvec atol 2e-3,
    inliers within 10 % (``test_localize_batch_parallel_matches_single_
    device``)."""
    from pixsfm_tpu_torch.localization.main import QueryLocalizer

    jrec, jfset = featuremetric_scene(seed=33, n_images=6, n_points=50)
    fset = _port_fset(jfset, 8, 16)
    qids = [5, 6]
    rec2 = jrec.copy()
    for p in rec2.points3D.values():
        p.track = [(i, j) for (i, j) in p.track if i not in qids]
    for qid in qids:
        del rec2.images[qid]
    rec2.points3D = {pid: p for pid, p in rec2.points3D.items()
                     if p.track_length >= 2}
    trec2 = _to_port(rec2)
    base = {
        "interpolation": {"mode": "BICUBIC", "l2_normalize": False},
        "target_reference": "robust_mean",
        "references": {"loss": {"name": "cauchy", "params": [0.25]},
                       "iters": 10, "keep_observations": True},
        "QKA": {"apply": True,
                "optimizer": {"solver": {"max_num_iterations": 10}}},
        "QBA": {"apply": True,
                "optimizer": {"solver": {"max_num_iterations": 10}}},
    }
    rng = np.random.default_rng(33)
    queries = []
    for qid in qids:
        im = jrec.images[qid]
        p2D = [i for i, pid in enumerate(im.point3D_ids)
               if pid >= 0 and pid in rec2.points3D]
        noisy = im.xys.copy()
        noisy[p2D] += rng.uniform(-0.8, 0.8, (len(p2D), 2))
        queries.append(dict(
            keypoints=noisy, pnp_point2D_idxs=p2D,
            pnp_points3D_id=[int(im.point3D_ids[i]) for i in p2D],
            query_camera=_port_camera(jrec.cameras[im.camera_id]),
            query_fmaps=[fset.get_map(im.name)]))

    def run(conf):
        loc = QueryLocalizer(trec2, conf=conf, dense_features=_Manager(fset),
                             device="cpu")
        return loc.localize_batch([dict(q, keypoints=q["keypoints"].copy())
                                   for q in queries])

    single, par = run(base), run(_knob(base))
    for s, p in zip(single, par):
        assert s["success"] and p["success"]
        np.testing.assert_allclose(p["qvec"], s["qvec"], atol=2e-4)
        np.testing.assert_allclose(p["tvec"], s["tvec"], atol=2e-3)
        assert p["num_inliers"] >= 0.9 * s["num_inliers"]


def test_pixsfm_parallel_knob_flows_to_strategies(monkeypatch):
    """``mapping.parallel`` reaches both the KA and the BA conf through
    ``PixSfM(conf)``, a strategy's own ``parallel`` beats it, and the mesh
    follows the JAX package's rule on CUDA (the card count monkeypatched):
    ``n_devices`` clamped to the cards, none for one card; on the CPU
    ``n_devices`` CPU shards."""
    from pixsfm_tpu_torch.refine_colmap import PixSfM

    sfm = PixSfM({"mapping": {"parallel": {"enabled": True,
                                           "n_devices": 4}}}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, size in ((8, 4), (2, 2), (1, None)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        for adj in (sfm.keypoint_adjuster, sfm.bundle_adjuster):
            par = adj.conf.get("parallel")
            assert par and bool(par["enabled"]) and int(par["n_devices"]) == 4
            assert adj._parallel_mesh().devices == (torch.device("cpu"),) * 4
            mesh = parallel_mesh(par, "cuda")
            if size is None:
                assert mesh is None
            else:
                assert mesh.devices == tuple(torch.device("cuda", i)
                                             for i in range(size))
    sfm0 = PixSfM({}, device="cpu")
    assert sfm0.bundle_adjuster._parallel_mesh() is None
    assert sfm0.keypoint_adjuster._parallel_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    sfm1 = PixSfM({"mapping": {"parallel": {"enabled": True},
                               "BA": {"parallel": {"enabled": False}}}},
                  device="cpu")
    assert parallel_mesh(sfm1.bundle_adjuster.conf.parallel, "cuda") is None
    assert parallel_mesh(sfm1.keypoint_adjuster.conf.parallel,
                         "cuda").size == 8
    # without n_devices the CPU runs unsharded, as one JAX device does
    assert sfm1.keypoint_adjuster._parallel_mesh() is None


# ---------------------------------------------------------------------------
# the shards are real
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["ba", "ka"])
def test_no_call_sees_more_than_a_shard(monkeypatch, solver):
    """A wrapped residual (BA) and a wrapped chunk solve (KA) record the
    batch each call receives over 8 CPU shards: no call sees more than
    one shard's share (``L / 8`` observation slots, or the per-device chunk
    of problems), and every slot or problem is seen in each pass."""
    sizes = []
    if solver == "ba":
        packed, obs, state0, free = _ba_problem()
        model = packed.cam_model
        fn, jac = _build_geometric(model), _build_geometric_jac(model)

        def residual_fn(*args):
            sizes.append(args[0].shape[0])
            return fn(*args)

        def residual_jac_fn(*args):
            sizes.append(args[0].shape[0])
            return jac(*args)

        sharded_ba_solve(residual_fn, state0, obs, RobustLoss("trivial"),
                         *free, BAOptions(max_iterations=2, obs_chunk=8192),
                         MESH8, residual_jac_fn=residual_jac_fn)
        O = len(packed.obs_img)
        share = (O // 8 + 1)
        assert max(sizes) == share
        assert len(sizes) % 8 == 0 and sum(sizes) == share * len(sizes)
    else:
        run = tsolver._run_chunk

        def spy(*args, **kw):
            sizes.append(args[5].shape[0])
            return run(*args, **kw)

        monkeypatch.setattr(tsolver, "_run_chunk", spy)
        arrays, patches = _ka_problem()
        sharded_ka_solve(tsolver.KAProblems(**arrays), patches,
                         InterpolationConfig(mode="BICUBIC"),
                         RobustLoss("trivial"), LMOptions(max_iterations=3),
                         Mesh(["cpu"] * 8))
        # 12 problems, a per-device chunk of 8: two shards at work, the
        # second one's 4 problems padded to the chunk (as in JAX)
        assert sizes == [8, 8]
