"""The fused feature-reference BA evaluation (kernel K4,
``pixsfm_tpu_torch/ops/ba_eval_cuda.py``).

On the CPU: K4's plain PyTorch version (``ba_eval_plain``: the structured
Gram matrix from six channel sums) against ``ba_solve``'s chunk loop
(``ops.schur._eval_chunks``) on the same inputs, in the three modes of an
evaluation, on the flat and the grid layouts with holes, with and without
``check_bounds`` and L2, for each camera model K4 computes, three losses
and 64 / 128 channels; which inputs take K4 and which the chunk loop, and
the counters of each evaluation; the adjuster with the plain version in
K4's place against the chunk loop. On the card (``cuda`` marker, skipped
without a GPU): the kernel against the plain version and the chunk loop,
and a whole ``ba_solve`` on a small grid problem against the chunk loop's.

This file imports neither JAX nor the JAX package, so on a machine with a
GPU it runs with ``--noconftest``:

    python -m pytest tests/test_torch_ba_fused.py -m cuda --noconftest
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import make_loss
from pixsfm_tpu_torch.base.projection import project_with_jac
from pixsfm_tpu_torch.bundle_adjustment import main as ba_main
from pixsfm_tpu_torch.config import merge
from pixsfm_tpu_torch.ops import ba_eval_cuda, schur
from pixsfm_tpu_torch.ops.interpolate_cuda import interpolate_rows_plain
from pixsfm_tpu_torch.ops.schur import BAObservations, BAOptions, BAState
from pixsfm_tpu_torch.util import profiling


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: among the fast lane's parallel workers, torch's
    default threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAMERAS = {"SIMPLE_PINHOLE": [500.0, 320.0, 240.0],
           "PINHOLE": [500.0, 520.0, 320.0, 240.0],
           "SIMPLE_RADIAL": [500.0, 320.0, 240.0, 0.05],
           "RADIAL": [500.0, 320.0, 240.0, 0.05, -0.02]}
LOSSES = {"trivial": {"name": "trivial", "params": []},
          "cauchy": {"name": "cauchy", "params": [0.25]},
          "huber": {"name": "huber", "params": [0.5]}}
MODES = (("cost", False, False), ("points", True, True),
         ("full", True, False))


@dataclasses.dataclass
class _Packed:
    """What ``_PatchRows`` reads of a ``PackedFeatures``."""
    patches: torch.Tensor
    corners: np.ndarray
    scales: np.ndarray
    upsampling: np.ndarray


def _quat(g, n, sigma):
    q = np.c_[np.ones(n), g.normal(0, sigma, (n, 3))]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _problem(model, C, grid, seed=0, dtype=torch.float32, dev="cpu",
             n_images=5, n_points=24, ps=16, smooth=False, track=(2, 5)):
    """A small feature-reference problem: ``(state, obs, ctx)``. Points in
    front of ``n_images`` cameras (two cameras of ``model``), each seen by
    ``track`` images; a patch of random features per observation around
    its projection (scale 1 or 0.5, upsampling 1 or 2, a few patches placed
    so that the projection falls outside, where ``check_bounds`` acts),
    random targets. ``grid``: the point-major layout of 8 slots a point,
    holes copying observation 0 as ``_layout`` makes them; else the flat
    one with padding slots. Two real observations are invalid either way.
    ``smooth``: for solves, patches at scale 1 whose features vary linearly
    and quadratically around the true projection, every projection inside,
    and targets the L2-normalized read there, so the optimum lies near the
    truth."""
    g = np.random.default_rng(seed)
    I, Np, Nc = n_images, n_points, 2
    k = len(CAMERAS[model])
    xyz = np.c_[g.uniform(-1, 1, (Np, 2)), g.uniform(4, 6, Np)]
    qvec, tvec = _quat(g, I, 0.02), g.normal(0, 0.1, (I, 3))
    cams = np.asarray(CAMERAS[model])[None] * (1 + 0.01 * g.normal(
        size=(Nc, k)))
    cam_of_img = np.arange(I) % Nc
    obs_img, obs_pt = [], []
    for p in range(Np):
        seen = g.choice(I, size=g.integers(track[0], track[1] + 1),
                        replace=False)
        obs_img += list(seen)
        obs_pt += [p] * len(seen)
    obs_img, obs_pt = np.asarray(obs_img), np.asarray(obs_pt)
    obs_cam = cam_of_img[obs_img]
    n_obs = len(obs_img)
    t = torch.as_tensor
    pix = project_with_jac(model, t(cams)[obs_cam], t(qvec)[obs_img],
                           t(tvec)[obs_img], t(xyz)[obs_pt])[0].numpy()
    scales = np.where(g.random(n_obs)[:, None] < 0.3, 0.5, 1.0) * np.ones(2)
    ups = np.where(g.random(n_obs) < 0.2, 2.0, 1.0).astype(np.float32)
    shift = g.integers(-3, 4, (n_obs, 2))
    shift[g.random(n_obs) < 0.1] += ps + 2             # outside the patch
    if smooth:
        scales, ups = np.ones((n_obs, 2)), np.ones(n_obs, np.float32)
        shift = np.clip(shift, -3, 3)
    corners = (np.floor(pix * scales - 0.5) - ps // 2 + shift).astype(
        np.int64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    patches = torch.randn((n_obs, ps, ps, C), device=dev, generator=gen)
    target = g.normal(0, 0.3, (n_obs, C)).astype(np.float32)
    if smooth:
        # value, gradient and curvature of each observation's point at its
        # true patch coordinates (x, y)
        xy = t((pix * scales - 0.5 - corners) * ups[:, None],
               dtype=torch.float32, device=dev)
        sig = patches[:, 0, 0]
        grad = 0.3 * patches[:, 1, :2]
        curv = 0.02 * patches[:, 2, 0]
        ax = torch.arange(ps, device=dev, dtype=torch.float32)
        dx = ax[None, None, :] - xy[:, 0, None, None]
        dy = ax[None, :, None] - xy[:, 1, None, None]
        patches = (sig[:, None, None] + grad[:, None, None, 0] * dx[..., None]
                   + grad[:, None, None, 1] * dy[..., None]
                   + curv[:, None, None] * (dx * dx + dy * dy)[..., None])
        rows = patches.reshape(n_obs * ps, ps, C).to(dtype)
        target = interpolate_rows_plain(
            rows, ps, ps, C, torch.arange(n_obs, device=dev) * ps,
            xy[:, 1], xy[:, 0], True)[0].cpu().numpy()
    patches = patches.to(dtype)
    row = np.arange(n_obs)
    real_valid = np.ones(n_obs, bool)
    real_valid[g.choice(n_obs, 2, replace=False)] = False
    if grid:
        T = 8
        order = np.argsort(obs_pt, kind="stable")
        starts = np.searchsorted(obs_pt[order], np.arange(Np))
        slot = obs_pt[order] * T + (np.arange(n_obs)
                                    - starts[obs_pt[order]])
        src = np.zeros(Np * T, np.int64)
        valid = np.zeros(Np * T, bool)
        src[slot] = order
        valid[slot] = real_valid[order]
        pt_idx = np.arange(Np * T) // T
    else:
        src = np.r_[np.arange(n_obs), np.zeros(6, np.int64)]
        valid = np.r_[real_valid, np.zeros(6, bool)]
        pt_idx = obs_pt[src]
    obs = BAObservations(
        img_idx=t(obs_img[src], device=dev), cam_idx=t(obs_cam[src],
                                                       device=dev),
        pt_idx=t(pt_idx, device=dev),
        obs_data=(t(row[src], device=dev), t(target[src], device=dev)),
        valid=t(valid, device=dev))
    # the state the solve starts from: the truth, perturbed (unit
    # quaternions, as the solver keeps them)
    q0 = qvec + g.normal(0, 1e-3, (I, 4))
    state = BAState(
        t(q0 / np.linalg.norm(q0, axis=1, keepdims=True),
          dtype=torch.float32, device=dev),
        t(tvec + g.normal(0, 1e-2, (I, 3)), dtype=torch.float32,
          device=dev),
        t(cams, dtype=torch.float32, device=dev),
        t(xyz + g.normal(0, 1e-2, (Np, 3)), dtype=torch.float32,
          device=dev))
    ctx = ba_main._PatchRows(_Packed(patches, corners.astype(
        np.float64), scales, ups), dev)
    return state, obs, ctx


def _interp(l2, check_bounds):
    return InterpolationConfig(mode="BICUBIC", l2_normalize=l2,
                               check_bounds=check_bounds)


def _shard(obs, ctx, chunk=40):
    return schur._observation_shards(obs, None, obs.img_idx.device, ctx,
                                     chunk)[0]


def _chunk_loop(model, interp, loss, state, sh, mode):
    _, with_jac, points_only = next(m for m in MODES if m[0] == mode)
    return schur._eval_chunks(
        ba_main._build_feature_reference(model, interp),
        ba_main._build_feature_reference_jac(model, interp), loss, state,
        sh, state.qvec.shape[0], with_jac, points_only)


def _fused(fn, model, interp, loss, state, sh, mode):
    return fn(mode, model, interp, loss, state, sh.img_idx, sh.cam_idx,
              sh.pt_idx, sh.valid, *sh.obs_data, sh.ctx)


def _assert_evals_close(got, ref, valid, rtol=1e-4, scale=2e-5):
    """Each result of an evaluation within ``rtol`` and ``scale`` times the
    largest entry of the reference (the Gram matrix's entries span orders
    of magnitude); holes exactly zero."""
    assert set(got) == set(ref)
    for key, want in ref.items():
        have = got[key].to(want.device)
        assert have.shape == want.shape, key
        atol = scale * max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(have, want, rtol=rtol, atol=atol,
                                   msg=lambda m, key=key: f"{key}: {m}")
        if key in ("ptv", "B"):
            assert bool((have[~valid.to(have.device)] == 0).all()), key


_CASES = [(m, lay, ls, C) for m in CAMERAS for lay in ("flat", "grid")
          for ls in LOSSES for C in (64, 128)]


@pytest.mark.parametrize("check_bounds", [False, True])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("model,layout,loss_name,C", _CASES,
                         ids=[f"{m}-{lay}-{ls}-C{C}"
                              for m, lay, ls, C in _CASES])
def test_plain_matches_chunk_loop(model, layout, loss_name, C, l2,
                                  check_bounds):
    """K4's plain version against the chunk loop: cost, point rows, B
    blocks, image and camera rows in each mode (bf16 rows at C = 128, f32
    at 64)."""
    dtype = torch.bfloat16 if C == 128 else torch.float32
    state, obs, ctx = _problem(model, C, layout == "grid", seed=C + l2,
                               dtype=dtype)
    interp, loss = _interp(l2, check_bounds), make_loss(LOSSES[loss_name])
    sh = _shard(obs, ctx)
    for mode, _, _ in MODES:
        ref = _chunk_loop(model, interp, loss, state, sh, mode)
        got = _fused(ba_eval_cuda.ba_eval_plain, model, interp, loss, state,
                     sh, mode)
        _assert_evals_close(got, ref, sh.valid)


def test_takes_config():
    """Which residual configs K4 computes: one camera model of its four,
    BICUBIC / CERES_BICUBIC at the single node [0, 0] without NCC, a known
    loss; mixed models, OPENCV and the fisheye, other reads, several nodes
    and NCC take the chunk loop."""
    takes = ba_eval_cuda.takes_config
    cauchy = make_loss(LOSSES["cauchy"])
    base = _interp(True, False)
    for model in CAMERAS:
        assert takes(model, base, cauchy)
    assert takes("SIMPLE_RADIAL", InterpolationConfig(mode="CERES_BICUBIC"),
                 make_loss({"name": "tukey", "params": [1.0]}))
    for name in ("trivial", "scaled", "huber", "soft_l1", "softlone",
                 "cauchy", "arctan", "tukey"):
        assert takes("PINHOLE", base, make_loss({"name": name,
                                                 "params": [0.5]}))
    assert not takes(("SIMPLE_RADIAL", "RADIAL"), base, cauchy)
    assert not takes("OPENCV", base, cauchy)
    assert not takes("OPENCV_FISHEYE", base, cauchy)
    for mode in ("BILINEAR", "NEARESTNEIGHBOR", "BICUBICCHAIN"):
        assert not takes("SIMPLE_RADIAL", InterpolationConfig(mode=mode),
                         cauchy)
    assert not takes("SIMPLE_RADIAL", InterpolationConfig(
        nodes=[[0.0, 0.0], [1.0, 0.0]]), cauchy)
    assert not takes("SIMPLE_RADIAL", InterpolationConfig(
        nodes=[[0.5, 0.0]]), cauchy)
    assert not takes("SIMPLE_RADIAL", InterpolationConfig(
        ncc_normalize=True), cauchy)


def test_takes_refuses_rows_off_the_card():
    """The CPU keeps the chunk loop: ``takes`` hands K4 no patch rows that
    are not on a GPU (the adjuster asks it alone, so it loads no kernel;
    ``test_adjuster_dispatch`` runs the adjuster on the CPU)."""
    state, obs, ctx = _problem("SIMPLE_RADIAL", 128, False)
    interp, loss = _interp(True, False), make_loss(LOSSES["cauchy"])
    assert ba_eval_cuda.takes_config("SIMPLE_RADIAL", interp, loss)
    assert not ba_eval_cuda.takes("SIMPLE_RADIAL", interp, loss, ctx.rows)


def _free(state):
    """Everything free but the gauge (pixsfm's: the first pose, and the
    second one's x translation)."""
    dev = state.xyz.device
    pose = torch.ones(state.qvec.shape[0], dtype=torch.bool, device=dev)
    tvec = torch.ones(state.tvec.shape, dtype=torch.bool, device=dev)
    pose[0] = False
    tvec[1, 0] = False
    return (pose, tvec, torch.ones(state.cams.shape, dtype=torch.bool,
                                   device=dev),
            torch.ones(state.xyz.shape[0], dtype=torch.bool, device=dev))


def _solve(model, interp, loss, state, obs, ctx, opts, fused_eval=None,
           cams_free=True):
    pose, tvec, cams, pts = _free(state)
    return schur.ba_solve(
        ba_main._build_feature_reference(model, interp), state, obs, loss,
        pose, tvec, cams & cams_free, pts, opts=opts, ctx=ctx,
        residual_jac_fn=ba_main._build_feature_reference_jac(model, interp),
        fused_eval=fused_eval)


def _assert_solves_match(got_state, got, ref_state, ref, state, path=True):
    """Two solves from ``state`` reach the problem's floor (under 1 % of the
    initial cost) at the same cost, to 2e-4 of the initial one; with
    ``path``, also at the same parameters, to within 1 % of each parameter
    block's move."""
    for out in (got, ref):
        assert out["final_cost"] < 0.01 * out["initial_cost"]
    np.testing.assert_allclose(got["initial_cost"], ref["initial_cost"],
                               rtol=1e-5)
    assert abs(got["final_cost"] - ref["final_cost"]) \
        <= 2e-4 * ref["initial_cost"]
    assert got["iterations"] == ref["iterations"]
    if not path:
        return
    for a, b, a0 in zip(got_state, ref_state, state):
        moved = float((b - a0).abs().max())
        assert float((a - b).abs().max()) <= 0.01 * moved + 1e-6


@pytest.mark.parametrize("inner", [False, True])
def test_counters_count_each_evaluation(inner):
    """``ba.eval.fused`` / ``ba.eval.chunked``: one count per evaluation of
    ``ba_solve``, on the path it takes (a mesh or a source pose would
    refuse an evaluator; none here)."""
    model = "SIMPLE_RADIAL"
    state, obs, ctx = _problem(model, 64, True)
    interp, loss = _interp(True, False), make_loss(LOSSES["cauchy"])
    opts = BAOptions(max_iterations=3, linear_solver="cg", obs_grid_T=8,
                     obs_chunk=64, use_inner_iterations=inner)
    calls = []

    def fused_eval(st, sh, mode):
        calls.append(mode)
        return _fused(ba_eval_cuda.ba_eval_plain, model, interp, loss, st,
                      sh, mode)

    counted = []
    for fe in (fused_eval, None):
        profiling.clear_recorded()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("ba"):
                _solve(model, interp, loss, state, obs, ctx, opts, fe)
            counted.append(profiling.recorded().counts("ba.eval.",
                                                       within="ba"))
    assert counted[0] == {"ba.eval.fused": len(calls)}
    modes = {"cost", "points", "full"} if inner else {"full"}
    assert set(calls) == modes
    assert set(counted[1]) == {"ba.eval.chunked"}
    assert counted[1]["ba.eval.chunked"] > 0


@pytest.mark.parametrize("layout", ["flat", "grid"])
def test_solve_with_plain_evaluator_matches_chunk_loop(layout):
    """A whole ``ba_solve`` (CG step, inner iterations) with K4's plain
    version as the evaluator ends where the chunk loop's does."""
    model = "RADIAL"
    state, obs, ctx = _problem(model, 128, layout == "grid",
                               dtype=torch.bfloat16, smooth=True)
    interp, loss = _interp(True, False), make_loss(LOSSES["cauchy"])
    opts = BAOptions(max_iterations=6, linear_solver="cg", obs_chunk=64,
                     use_inner_iterations=True,
                     obs_grid_T=8 if layout == "grid" else 0)
    ref_state, ref = _solve(model, interp, loss, state, obs, ctx, opts)
    got_state, got = _solve(
        model, interp, loss, state, obs, ctx, opts,
        lambda st, sh, mode: _fused(ba_eval_cuda.ba_eval_plain, model,
                                    interp, loss, st, sh, mode))
    _assert_solves_match(got_state, got, ref_state, ref, state)


def test_solve_refuses_an_evaluator_it_cannot_take():
    """``ba_solve`` raises on a whole-shard evaluator given with a source
    pose per observation (or a mesh) rather than drop it."""
    model = "SIMPLE_RADIAL"
    state, obs, ctx = _problem(model, 64, False)
    interp, loss = _interp(True, False), make_loss(LOSSES["cauchy"])
    opts = BAOptions(max_iterations=1, linear_solver="cg", obs_chunk=64)
    with pytest.raises(ValueError, match="fused_eval"):
        _solve(model, interp, loss, state, obs._replace(
            src_idx=obs.img_idx), ctx, opts, lambda st, sh, mode: None)


def _scene(model, seed=3, C=64, ps=16, device="cpu", mixed=False,
           perturb=True, xys=None):
    """A small featuremetric scene of the port: ``synthetic_reconstruction``
    (its keypoints replaced by ``xys[image_id]`` where given) with a patch
    per observation whose features vary linearly around the keypoint (as
    ``tests/test_feature_reference_ba.py`` builds them), then poses and
    points perturbed (unless not ``perturb``). ``mixed``: a camera per
    image, the first one RADIAL with the same projection (its second
    coefficient 0), so the scene mixes two camera models."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap, FeatureSet
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=4, n_points=40, seed=seed,
                                   model=model, noise_px=0.0,
                                   shared_camera=not mixed)
    if mixed:
        cam = rec.cameras[1]
        rec.cameras[1] = Camera(1, "RADIAL", cam.width, cam.height,
                                np.r_[cam.params, 0.0])
    for iid, xy in (xys or {}).items():
        rec.images[iid].xys = np.asarray(xy)
    g = np.random.default_rng(seed)
    sig = {pid: g.normal(0, 1, C) for pid in rec.points3D}
    grad = {pid: g.normal(0, 0.1, (C, 2)) for pid in rec.points3D}
    fset = FeatureSet(channels=C, patch_size=ps, dtype="float32")
    rr, cc = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    for im in rec.images.values():
        ids, patches, corners = [], [], []
        for p2d, pid in enumerate(im.point3D_ids):
            if pid < 0:
                continue
            xy = im.xys[p2d]
            corner = np.floor(xy - ps / 2).astype(np.int64)
            dx = corner[0] + cc + 0.5 - xy[0]
            dy = corner[1] + rr + 0.5 - xy[1]
            patches.append(sig[pid] + grad[pid][:, 0] * dx[..., None]
                           + grad[pid][:, 1] * dy[..., None])
            ids.append(p2d)
            corners.append(corner)
        fset.emplace(im.name, FeatureMap.from_arrays(
            np.stack(patches).astype(np.float32), ids, np.stack(corners),
            np.ones(2), device=device))
    if not perturb:
        return rec, fset
    for im in list(rec.images.values())[1:]:
        im.qvec = im.qvec + g.normal(0, 2e-3, 4)
        im.qvec /= np.linalg.norm(im.qvec)
        im.tvec = im.tvec + g.normal(0, 1e-2, 3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + g.normal(0, 2e-2, 3)
    return rec, fset


# The JAX package's ``FeatureReferenceBundleAdjuster`` on the CPU, on the
# scene of ``tests/test_feature_reference_ba.featuremetric_scene(seed=6,
# n_images=4, n_points=40, C=128)`` perturbed as
# ``tests/test_torch_ba.py::test_feature_reference_refine_matches`` perturbs
# it: its keypoints (JAX's synthetic views, within 1e-6 px of the port's)
# and perturbed poses and points (``input``) and, with L2 on (the default),
# the costs and refined parameters JAX returns. With L2 off one point of
# this scene drifts along its ray: noise of 1e-6 of each evaluation moves
# it by 0.55 and the final cost by 2.4e-3 on the CPU, an end point that no
# tolerance of the parity tests can hold, so L2 off is held element by
# element (``test_k4_matches_plain``). ``tests/test_torch_ba.py::
# test_jax_record_of_k4_scene`` reruns JAX and holds this file to it, so
# that the card, which has no JAX, can hold K4's whole solve to JAX.
JAX_RECORD = Path(__file__).with_name("ba_fused_jax_record.json")


def jax_record_conf():
    """The adjuster's config of the record: the parity test's, with K4's
    read and loss (BICUBIC with L2, Cauchy(0.25)) and up to 60 LM
    iterations (it converges in 22); the grid regime is forced apart."""
    return {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
            "optimizer": {"solver": {"max_num_iterations": 60,
                                     "use_inner_iterations": False,
                                     "max_linear_solver_iterations": 200}},
            "references": {"loss": {"name": "cauchy", "params": [0.25]},
                           "iters": 20}}


def jax_record_scene(record, device="cpu"):
    """The record's scene in the port's data model, with no JAX: the same
    views, tracks and 128-channel float32 patches as the JAX package's
    ``featuremetric_scene(seed=6, ...)``, keypoints, poses and points from
    ``record["input"]``."""
    rec, fset = _scene("SIMPLE_RADIAL", seed=6, C=128, device=device,
                       perturb=False, xys={
                           int(i): xy
                           for i, xy in record["input"]["xys"].items()})
    for iid, im in rec.images.items():
        im.qvec = np.asarray(record["input"]["qvec"][str(iid)])
        im.tvec = np.asarray(record["input"]["tvec"][str(iid)])
    for pid, p in rec.points3D.items():
        p.xyz = np.asarray(record["input"]["xyz"][str(pid)])
    return rec, fset


def grid_cg_options(adj):
    """Have ``adj`` solve with CG steps in chunks of 128 (with
    ``schur._ONEHOT_BUDGET`` at 1: the grid layout), as the record's JAX
    run does."""
    base = adj._ba_options()
    adj._ba_options = lambda **kw: dataclasses.replace(
        base, linear_solver="cg", obs_chunk=128)


def refined(rec, out):
    """The record's ``output`` fields of an adjuster's answer."""
    return {"initial_cost": float(out["initial_cost"]),
            "final_cost": float(out["final_cost"]),
            "qvec": {str(i): im.qvec.tolist() for i, im in rec.images.items()},
            "tvec": {str(i): im.tvec.tolist() for i, im in rec.images.items()},
            "xyz": {str(i): p.xyz.tolist() for i, p in rec.points3D.items()}}


def assert_refined_close(got, want, rtol=1e-4, atol=1e-3):
    """Costs within ``rtol``, poses and points within ``atol``."""
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)
    for key in ("qvec", "tvec", "xyz"):
        assert got[key].keys() == want[key].keys(), key
        for i in want[key]:
            np.testing.assert_allclose(got[key][i], want[key][i], rtol=0,
                                       atol=atol, err_msg=f"{key} {i}")


_PATCH_WARP = {"strategy": "patch_warp", "interpolation": {
    "ncc_normalize": False}, "optimizer": {"refine_extrinsics": False}}
_ADJUSTER_CASES = {
    "fused": ("SIMPLE_RADIAL", {}, "ba.eval.fused"),
    "mixed": ("SIMPLE_RADIAL", {}, "ba.eval.chunked"),
    "opencv": ("OPENCV", {}, "ba.eval.chunked"),
    "bilinear": ("SIMPLE_RADIAL", {"interpolation": {"mode": "BILINEAR"}},
                 "ba.eval.chunked"),
    "ncc": ("SIMPLE_RADIAL", {"interpolation": {"ncc_normalize": True}},
            "ba.eval.chunked"),
    "window": ("SIMPLE_RADIAL", {"parallel": {"enabled": True,
                                              "n_devices": 2}},
               "ba.eval.chunked"),
    "patch_warp": ("SIMPLE_RADIAL", _PATCH_WARP, "ba.eval.chunked"),
}


@pytest.mark.parametrize("case", list(_ADJUSTER_CASES))
def test_adjuster_dispatch(monkeypatch, case):
    """The adjuster's ``refine`` with K4 standing in for a card (``takes``
    asks only the config, ``ba_eval`` is the plain version): the default
    feature-reference config takes it at every evaluation, from the chunk
    loop's initial cost; mixed camera models, OPENCV, a BILINEAR read, NCC,
    the sharded ``_window`` layout and the patch-warp strategy keep the
    chunk loop at every evaluation. End states are compared in
    ``test_solve_with_plain_evaluator_matches_chunk_loop``:
    this scene's solve is chaotic (noise of 1e-6 of each Gram entry moves
    the chunk loop's own final cost by up to 25 %)."""
    model, conf, path = _ADJUSTER_CASES[case]
    conf = merge({"optimizer": {"solver": {"max_num_iterations": 4}},
                  "references": {"iters": 10},
                  "interpolation": {"l2_normalize": False}}, conf)
    rec, fset = _scene(model, mixed=case == "mixed")
    outs = []
    for fake_card in (True, False):
        with monkeypatch.context() as m:
            if fake_card:
                m.setattr(ba_eval_cuda, "takes",
                          lambda model, interp, loss, rows:
                          ba_eval_cuda.takes_config(model, interp, loss))
                m.setattr(ba_eval_cuda, "ba_eval", ba_eval_cuda.ba_eval_plain)
            adj = ba_main.BundleAdjuster.create(conf, device="cpu")
            profiling.clear_recorded()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]):
                outs.append(adj.refine(rec.copy(), fset))
                counts = profiling.recorded().counts("ba.eval.")
        assert set(counts) == {path if fake_card else "ba.eval.chunked"}
    got, ref = outs
    if path == "ba.eval.chunked":       # the same code both times
        assert got["final_cost"] == ref["final_cost"]
        return
    for out in outs:
        assert out["final_cost"] < 0.5 * out["initial_cost"]
    np.testing.assert_allclose(got["initial_cost"], ref["initial_cost"],
                               rtol=1e-5)


def test_plain_refine_matches_jax_record(monkeypatch):
    """The adjuster with K4's plain version standing in for the card, on
    the CPU, against the JAX package's adjuster (``JAX_RECORD``): costs
    within 1e-4, refined poses and points within 1e-3, as the card test
    ``test_k4_refine_matches_jax_record`` holds K4 itself."""
    with open(JAX_RECORD) as fh:
        record = json.load(fh)
    rec, fset = jax_record_scene(record)
    monkeypatch.setattr(schur, "_ONEHOT_BUDGET", 1)
    monkeypatch.setattr(ba_eval_cuda, "takes",
                        lambda model, interp, loss, rows:
                        ba_eval_cuda.takes_config(model, interp, loss))
    calls = []
    monkeypatch.setattr(ba_eval_cuda, "ba_eval",
                        lambda *a: calls.append(1)
                        or ba_eval_cuda.ba_eval_plain(*a))
    adj = ba_main.FeatureReferenceBundleAdjuster(jax_record_conf(),
                                                 device="cpu")
    grid_cg_options(adj)
    out = adj.refine(rec, fset)
    assert out["obs_grid_T"] > 0 and calls
    assert_refined_close(refined(rec, out), record["output"])


def test_fused_share_metric_reads_the_counters():
    """The benchmark's ``ba_fused_share.map``: 100 * fused / (fused +
    chunked) of the counters inside the traced job's ``ba`` span; None
    where the program counted neither (a program without the counters)."""
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace
    path = (Path(__file__).resolve().parents[1] / "portbench" / "metrics"
            / "ba_fused_share.map.py")
    spec = importlib.util.spec_from_file_location("ba_fused_share", path)
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)

    def read(counts):
        profiling.clear_recorded()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("ba"):
                for name, n in counts.items():
                    profiling.count(name, n)
            profiling.count("ba.eval.chunked", 5)      # outside ``ba``
        tracer = SimpleNamespace(traced_ns=(0, 1 << 62), marks=[])
        return metric.read(SimpleNamespace(tracer=tracer))

    assert read({"ba.eval.fused": 61}) == 100.0
    assert read({"ba.eval.fused": 2, "ba.eval.chunked": 2}) == 50.0
    assert read({"ba.eval.chunked": 3}) == 0.0
    assert read({}) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


_K4_CASES = [(m, lay, C, dt) for m in CAMERAS for lay in ("flat", "grid")
             for C, dt in ((128, torch.bfloat16), (64, torch.float32),
                           (128, torch.float32), (64, torch.bfloat16))]


def _check_k4(dev, model, layout, C, dtype, l2, check_bounds, loss_conf,
              against="plain", seed=0, **size):
    state, obs, ctx = _problem(model, C, layout == "grid", seed=seed,
                               dtype=dtype, dev=dev, **size)
    interp, loss = _interp(l2, check_bounds), make_loss(loss_conf)
    assert ba_eval_cuda.takes(model, interp, loss, ctx.rows)
    sh = _shard(obs, ctx, chunk=8192)
    for mode, _, _ in MODES:
        before = ba_eval_cuda.launches
        got = _fused(ba_eval_cuda.ba_eval, model, interp, loss, state, sh,
                     mode)
        assert ba_eval_cuda.launches == before + 1
        ref = (_chunk_loop(model, interp, loss, state, sh, mode)
               if against == "chunks" else _fused(
                   ba_eval_cuda.ba_eval_plain, model, interp, loss, state,
                   sh, mode))
        torch.cuda.synchronize()
        # K4 projects with fused multiply-adds, so its patch coordinates lie
        # within about an ulp of PyTorch's (3e-5 px at 320 px); on random
        # features, whose derivatives change by their own size within a
        # pixel, that moves some Gram entries by 1e-3 of themselves. Beyond
        # that, K4 against the plain version needs at most 9.4e-6 of the
        # largest entry over every case of test_k4_matches_plain and
        # test_k4_losses_match_plain on an H100 (2.8e-7 on smooth features);
        # float32 sums, or float32 sums and entries, read the same there
        _assert_evals_close(got, ref, sh.valid, rtol=1e-3, scale=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("l2,check_bounds", [(True, False), (False, True)])
@pytest.mark.parametrize("model,layout,C,dtype", _K4_CASES,
                         ids=[f"{m}-{lay}-C{C}-{str(dt)[6:]}"
                              for m, lay, C, dt in _K4_CASES])
def test_k4_matches_plain(dev, model, layout, C, dtype, l2, check_bounds):
    """K4 against its plain version in the three modes: each camera model,
    both layouts with holes, bf16 and f32 rows of 64 and 128 channels."""
    loss = list(LOSSES.values())[list(CAMERAS).index(model) % len(LOSSES)]
    _check_k4(dev, model, layout, C, dtype, l2, check_bounds, loss)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trivial", "scaled", "huber", "soft_l1",
                                  "cauchy", "arctan", "tukey"])
def test_k4_losses_match_plain(dev, name):
    """Each loss K4 computes, scaled, against the plain version."""
    loss = {"name": name, "params": [0.5]}
    _check_k4(dev, "SIMPLE_RADIAL", "grid", 128, torch.bfloat16, True,
              False, loss)


@pytest.mark.cuda
@pytest.mark.parametrize("model,layout,C,dtype,l2,check_bounds,loss", [
    ("SIMPLE_RADIAL", "grid", 128, torch.bfloat16, True, False, "cauchy"),
    ("PINHOLE", "flat", 64, torch.float32, False, True, "huber"),
    ("RADIAL", "flat", 128, torch.float32, True, True, "trivial"),
])
def test_k4_matches_chunk_loop(dev, model, layout, C, dtype, l2,
                               check_bounds, loss):
    """K4 against the chunk loop on the card (whose reads are K1's)."""
    _check_k4(dev, model, layout, C, dtype, l2, check_bounds, LOSSES[loss],
              against="chunks")


@pytest.mark.cuda
def test_k4_many_tiles_a_warp(dev):
    """160 000 grid slots: more tiles than the card holds warps, so each
    warp walks several."""
    _check_k4(dev, "SIMPLE_RADIAL", "grid", 128, torch.bfloat16, True, False,
              LOSSES["cauchy"], n_images=20, n_points=20000)


@pytest.mark.cuda
def test_k4_solve_matches_chunk_loop(dev):
    """A whole ``ba_solve`` on a small grid problem (CG step, inner
    iterations) with K4 as the evaluator reaches the chunk loop's final
    cost and parameters: poses and points within 1 % of each block's move.
    The cameras are held: free, their focal lengths and the depths trade
    along a direction the smooth problem barely fixes, which rounding alone
    moves (on the CPU the plain version and the chunk loop end a focal
    length's whole move apart after 20 iterations, and 1.2e-3 of the
    points' move apart with the cameras held)."""
    model = "SIMPLE_RADIAL"
    state, obs, ctx = _problem(model, 128, True, dtype=torch.bfloat16,
                               dev=dev, smooth=True)
    interp, loss = _interp(True, False), make_loss(LOSSES["cauchy"])
    opts = BAOptions(max_iterations=12, linear_solver="cg", obs_chunk=64,
                     use_inner_iterations=True, obs_grid_T=8)
    outs = []
    for fused in (True, False):
        fe = (lambda st, sh, mode: _fused(ba_eval_cuda.ba_eval, model,
                                          interp, loss, st, sh, mode)) \
            if fused else None
        outs.append(_solve(model, interp, loss, state, obs, ctx, opts, fe,
                           cams_free=False))
    (got_state, got), (ref_state, ref) = outs
    _assert_solves_match(got_state, got, ref_state, ref, state)


@pytest.mark.cuda
def test_k4_refine_matches_jax_record(dev, monkeypatch):
    """``FeatureReferenceBundleAdjuster`` on the card, where every
    evaluation takes K4 (float32 patches of 128 channels; the chunk loop
    never runs), against the JAX package's adjuster on the CPU on the same
    scene (``JAX_RECORD``): initial and final costs within 1e-4, refined
    poses and points within 1e-3, the tolerances of
    ``tests/test_torch_ba.py``'s parity tests, which the port's chunk loop
    meets on the CPU (``test_jax_record_of_k4_scene``)."""
    with open(JAX_RECORD) as fh:
        record = json.load(fh)
    rec, fset = jax_record_scene(record, device="cuda")
    monkeypatch.setattr(schur, "_ONEHOT_BUDGET", 1)
    chunk_loop = schur._eval_chunks
    chunked = []
    monkeypatch.setattr(schur, "_eval_chunks",
                        lambda *a: chunked.append(1) or chunk_loop(*a))
    adj = ba_main.FeatureReferenceBundleAdjuster(jax_record_conf(),
                                                 device="cuda")
    grid_cg_options(adj)
    before = ba_eval_cuda.launches
    out = adj.refine(rec, fset)
    assert out["obs_grid_T"] > 0
    assert ba_eval_cuda.launches > before and not chunked
    assert_refined_close(refined(rec, out), record["output"])


@pytest.mark.cuda
def test_adjuster_takes_k4_on_the_card(dev, monkeypatch):
    """``FeatureReferenceBundleAdjuster`` on the card takes K4 at every
    evaluation (bf16 patches of 128 channels: K4 launches, the chunk loop
    never runs), from the chunk loop's initial cost on the CPU. No profiler
    runs here: the counters are checked on the CPU, and a profiler session
    in this process would change what a later one records."""
    conf = {"optimizer": {"solver": {"max_num_iterations": 4}},
            "references": {"iters": 10},
            "interpolation": {"l2_normalize": True}}
    chunk_loop = schur._eval_chunks
    outs = []
    for device in ("cuda", "cpu"):
        rec, fset = _scene("SIMPLE_RADIAL", C=128, device=device)
        adj = ba_main.FeatureReferenceBundleAdjuster(conf, device=device)
        chunked = []
        with monkeypatch.context() as m:
            m.setattr(schur, "_eval_chunks",
                      lambda *a: chunked.append(1) or chunk_loop(*a))
            before = ba_eval_cuda.launches
            outs.append(adj.refine(rec, fset))
        fused = ba_eval_cuda.launches - before
        if device == "cuda":
            assert fused > 0 and not chunked
        else:
            assert chunked and fused == 0
    got, ref = outs
    assert got["final_cost"] < 0.5 * got["initial_cost"]
    np.testing.assert_allclose(got["initial_cost"], ref["initial_cost"],
                               rtol=1e-4)
