"""Port parity: patch-warp BA (``bundle_adjustment/patch_warp.py``), the
second pose block of ``ba_solve`` (``src_idx``) and the node-window
references, against the JAX package on the CPU with the same numpy inputs.

Tolerances:
- the per-observation bookkeeping (source poses, cameras, scales, model
  indices, targets, validity, ``src_idx``) equal, target windows equal;
  the residual and its closed-form Jacobian against ``jax.jacfwd`` of JAX's
  ``build_patch_warp_residual`` (jitted, as its BA runs it): 1e-4 of the
  largest entry, with NCC 5e-4 (NCC divides each node's float32 rounding
  by its channel's spread across the nodes; JAX's jitted and op-by-op
  residuals differ by the same order there);
- ``ba_solve`` with ``src_idx`` on the flat CG layout and on the dense step:
  final cost rtol 1e-5, states atol 1e-4 (as
  ``tests/test_torch_ba_inner.py::test_ba_solve_inner_iterations``);
- ``extract_references`` with 16 NCC nodes and ``compute_offsets3D``:
  sources equal, descriptors atol 1e-5, offsets atol 1e-5;
- the counterparts of ``tests/test_costmap_patchwarp_ba.py::
  test_patch_warp_{ba_aligns_points,joint_source_poses,constant_source_flag}``
  and ``tests/test_mixed_fm_ba.py::test_mixed_patch_warp_ba`` keep JAX's
  assertions and add the port's final cost against JAX's at rtol 1e-4.

The references test and the longer adjuster tests live in
``tests/test_torch_patch_warp_flow.py`` and
``tests/test_torch_patch_warp_poses.py`` (so that the test suite's workers
share the long tests), with this file's helpers.

The scenes are ``tests/test_feature_reference_ba.featuremetric_scene``;
where NCC is on, each channel also gets a strong ramp and a slight
curvature (:func:`_textured`): a pure ramp NCC-normalizes to one pattern
at every reprojection, so the references of the plain scene tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.cameras import Camera as JCam
from pixsfm_tpu.base.geometry import exp_quat, quat_mul, quat_normalize
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.bundle_adjustment.main import \
    PatchWarpBundleAdjuster as JPW
from pixsfm_tpu.bundle_adjustment.patch_warp import \
    build_patch_warp_residual as j_build
from pixsfm_tpu.bundle_adjustment.problem import pack_ba_problem as j_pack
from pixsfm_tpu.ops import schur as jschur
from pixsfm_tpu.sfm.synthetic import synthetic_reconstruction as j_synth
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.base.projection import project_with_jac
from pixsfm_tpu_torch.bundle_adjustment import PatchWarpBundleAdjuster
from pixsfm_tpu_torch.bundle_adjustment.main import (_RESIDUAL_BUILDERS,
                                                     BundleAdjuster)
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.ops import schur as tschur
from tests.test_bundle_adjustment import perturb
from tests.test_costmap_patchwarp_ba import track_consistency
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _one_torch_thread  # noqa: F401
from tests.test_torch_ba import _port_fset, _to_port

NODES16 = [[float(dx), float(dy)] for dy in (-1.5, -0.5, 0.5, 1.5)
           for dx in (-1.5, -0.5, 0.5, 1.5)]
NODES4 = [[-0.5, -0.5], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]


def _T(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _textured(rec, fset):
    """Add to every channel of every patch a ramp of slope 0.2-0.4 and a
    curvature of N(0, 0.01), both functions of the offset from the point's
    true projection (``featuremetric_scene``'s convention), so the views of
    a track stay consistent."""
    for im in rec.images.values():
        for kid, p in fset.maps[im.name].patches.items():
            H, W, C = p.data.shape
            rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
            dx = (p.corner[0] + cc + 0.5 - im.xys[kid][0])[..., None]
            dy = (p.corner[1] + rr + 0.5 - im.xys[kid][1])[..., None]
            g = np.random.default_rng(int(im.point3D_ids[kid]))
            a, th = g.uniform(0.2, 0.4, C), g.uniform(0.0, 2 * np.pi, C)
            h = g.normal(0.0, 0.01, (2, C))
            p.data = (p.data + a * (np.cos(th) * dx + np.sin(th) * dy)
                      + h[0] * dx ** 2 + h[1] * dx * dy).astype(np.float32)
    return rec, fset


def _pinhole_halves(rec):
    """Every second view on a PINHOLE camera of its own (fy = 1.01 f, no
    distortion): the scene then holds PINHOLE and SIMPLE_RADIAL."""
    shared = rec.cameras[min(rec.cameras)]
    f, cx, cy = shared.params[:3]
    for j, iid in enumerate(sorted(rec.images)):
        if j % 2:
            rec.add_camera(JCam(50 + j, "PINHOLE", shared.width,
                                shared.height, [f, 1.01 * f, cx, cy]))
            rec.images[iid].camera_id = 50 + j
    return rec


def _capture(monkeypatch):
    """Replace both adjusters' ``_run_ba_cached`` by a recorder: the
    packed problem, residual key, per-observation data, context, validity
    and ``src_idx`` each package hands to its solver."""
    seen = {}

    def grab(name):
        def run(self, rec, packed, key, obs_data, ctx, loss, opts,
                obs_valid=None, src_idx=None):
            seen[name] = dict(packed=packed, key=key, obs_data=obs_data,
                              ctx=ctx, valid=obs_valid, src_idx=src_idx)
            return {}
        return run

    monkeypatch.setattr(JPW, "_run_ba_cached", grab("jax"))
    monkeypatch.setattr(BundleAdjuster, "_run_ba_cached", grab("port"))
    return seen


def _jax_residual_jac(J, joint):
    """JAX's residual and ``jax.jacfwd`` over the solver's tangent (``obs_
    residual`` of ``pixsfm_tpu/ops/schur.py``) at every observation."""
    packed = J["packed"]
    res = j_build(J["key"][1], J["key"][2], joint)
    k = packed.cams.shape[1]
    P = (12 if joint else 6) + k + 3
    q0, t0, c0, x0 = (jnp.asarray(a, jnp.float32) for a in (
        packed.qvec, packed.tvec, packed.cams, packed.xyz))
    img, cam, pt = (jnp.asarray(a) for a in (packed.obs_img, packed.obs_cam,
                                             packed.obs_pt))
    src = None if J["src_idx"] is None else jnp.asarray(J["src_idx"])

    def one(d, o, sl):
        q = quat_normalize(quat_mul(exp_quat(d[:3]), q0[img[o]]))
        t = t0[img[o]] + d[3:6]
        if joint:
            s = src[o]
            qs = quat_normalize(quat_mul(exp_quat(d[6:9]), q0[s]))
            ts = t0[s] + d[9:12]
            r = res(q, t, qs, ts, c0[cam[o]] + d[12:12 + k],
                    x0[pt[o]] + d[12 + k:], sl, ())
        else:
            r = res(q, t, c0[cam[o]] + d[6:6 + k], x0[pt[o]] + d[6 + k:],
                    sl, ())
        return r, r

    @jax.jit
    def run(*sl):
        return jax.vmap(lambda o, *s: jax.jacfwd(
            lambda d: one(d, o, s), has_aux=True)(jnp.zeros(P)))(
            jnp.arange(len(packed.obs_img)), *sl)
    Jj, rj = run(*(jnp.asarray(a) for a in J["obs_data"]))
    return np.asarray(rj), np.asarray(Jj)


_RES_CASES = [  # joint, two models, NCC, check_bounds
    (False, False, True, False), (True, False, False, True),
    (False, True, False, True), (True, True, True, False)]


@pytest.mark.parametrize("joint,mixed,ncc,check_bounds", _RES_CASES)
def test_patch_warp_residual_jac_matches(monkeypatch, joint, mixed, ncc,
                                         check_bounds):
    """Both adjusters' bookkeeping on one scene, then the port's residual
    and closed-form Jacobian against ``jax.jacfwd`` of JAX's residual, in
    the constant and the joint source mode, with one camera model and with
    two (PINHOLE + SIMPLE_RADIAL), NCC and ``check_bounds`` each on and
    off: 1e-4 of the largest entry; with NCC 5e-4 (see below). The NCC
    cases keep the JAX tests' perturbation, so that every node stays in
    its window: a window read wholly in its clamped border is flat, and NCC
    then divides rounding by a spread of ~0."""
    jrec, jfset = _textured(*featuremetric_scene(seed=9, n_images=4,
                                                 n_points=10))
    if mixed:
        _pinhole_halves(jrec)
    scale = 1.0 if ncc else 5.0
    perturb(jrec, np.random.default_rng(3), pose_rot=0.002 * scale ** 0.5,
            pose_t=0.004 * scale, point_sigma=0.004 * scale)
    trec = _to_port(jrec)
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": False,
                              "ncc_normalize": ncc, "nodes": NODES16,
                              "check_bounds": check_bounds},
            "optimizer": {"refine_extrinsics": True,
                          "optimize_source_poses": joint},
            "references": {"iters": 10}}
    seen = _capture(monkeypatch)
    JPW(conf).refine(jrec, jfset)
    PatchWarpBundleAdjuster(conf, device="cpu").refine(
        trec, _port_fset(jfset, 8, 16))
    J, T = seen["jax"], seen["port"]
    assert (J["src_idx"] is not None) == (T["src_idx"] is not None) == joint
    np.testing.assert_array_equal(T["valid"], J["valid"])
    if joint:
        np.testing.assert_array_equal(T["src_idx"], J["src_idx"])
    jd, td, ctx = J["obs_data"], T["obs_data"], T["ctx"]
    # the target windows: JAX copies them per observation, the port reads
    # the packed rows by index
    windows = ctx.rows.reshape(-1, ctx.H, ctx.W, ctx.C)[_T(td[0]).long()]
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jd[0]))
    row = _T(td[0]).long()
    for got, want in ((ctx.corners[row], jd[1]), (ctx.scales[row], jd[2]),
                      (ctx.ups[row], jd[3])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(td[1:], jd[4:]):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    rj, Jj = _jax_residual_jac(J, joint)
    packed = J["packed"]
    q, t, c, x = (_T(a, torch.float32) for a in (
        packed.qvec, packed.tvec, packed.cams, packed.xyz))
    img, cam, pt = (_T(a).long() for a in (packed.obs_img, packed.obs_cam,
                                           packed.obs_pt))
    src = (q[_T(T["src_idx"]).long()], t[_T(T["src_idx"]).long()]) \
        if joint else ()
    args = (q[img], t[img], *src, c[cam], x[pt], tuple(map(_T, td)), ctx)
    build, build_jac = _RESIDUAL_BUILDERS["patch_warp"]
    r, Jt = build_jac(*T["key"][1:])(*args)
    np.testing.assert_array_equal(build(*T["key"][1:])(*args).numpy(),
                                  r.numpy())
    assert r.shape == rj.shape and Jt.shape == Jj.shape
    assert Jt.shape[-1] == (12 if joint else 6) + packed.cams.shape[1] + 3
    # NCC divides each node's float32 rounding by its channel's spread
    # across the nodes, which a foreshortened node grid shrinks: on these
    # inputs JAX's jitted residual and its op-by-op evaluation
    # (``jax.disable_jit``) differ by more than 1e-4 of the largest entry
    # themselves, so the NCC cases are held at 5e-4
    tol = 5e-4 if ncc else 1e-4
    for got, want in ((r, rj), (Jt, Jj)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# ba_solve with a second pose block per observation
# ---------------------------------------------------------------------------

_W_SRC = 0.3


def _two_pose_residuals(model):
    """A residual over both pose blocks: the reprojection error in the
    observation's image plus ``_W_SRC`` times the point's in its source
    image (``obs_data``: the two observed keypoints). JAX's form for its
    ``jax.jacfwd`` path, the port's with the closed-form Jacobian from
    ``project_with_jac``."""
    from pixsfm_tpu.base.projection import world_to_pixel

    def j_fn(q, t, qs, ts, cam, X, obs_slice, ctx):
        xy, xy_s = obs_slice
        return jnp.concatenate([
            world_to_pixel(model, cam, q, t, X) - xy,
            _W_SRC * (world_to_pixel(model, cam, qs, ts, X) - xy_s)])

    def t_jac(q, t, qs, ts, cam, X, obs_slice, ctx):
        xy, xy_s = obs_slice
        p, Jp, Jc, Jx = project_with_jac(model, cam, q, t, X)
        ps, Jps, Jcs, Jxs = project_with_jac(model, cam, qs, ts, X)
        zero = torch.zeros_like(Jp)
        r = torch.cat([p - xy, _W_SRC * (ps - xy_s)], dim=1)
        J = torch.cat([torch.cat([Jp, zero, Jc, Jx], -1),
                       _W_SRC * torch.cat([zero, Jps, Jcs, Jxs], -1)], 1)
        return r, J

    def t_fn(*args):
        return t_jac(*args)[0]
    return j_fn, t_fn, t_jac


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_ba_solve_src_idx_matches(layout):
    """``ba_solve`` with ``src_idx`` (each observation's source: the first
    view of its point's track, so a track's first observation has its
    source on its own slot) on the flat CG layout and on the dense step,
    non-monotonic steps on, against JAX's: final cost rtol 1e-5, states
    atol 1e-4. The dense step runs with inner point iterations; on the
    flat layout they take or refuse their point steps, from the fourth LM
    iteration on, on cost changes of float32 summation noise at the
    optimum, and the two packages' points part beyond 1e-4, so that case
    runs without them."""
    rng = np.random.default_rng(0)
    rec = j_synth(n_images=5, n_points=60, noise_px=0.4, seed=72)
    perturb(rng=rng, rec=rec, pose_rot=0.003, pose_t=0.02, point_sigma=0.02)
    packed = j_pack(rec)
    O, Np = len(packed.obs_img), len(packed.point_ids)
    first = np.full(Np, -1)
    for o in range(O):
        if first[packed.obs_pt[o]] < 0:
            first[packed.obs_pt[o]] = o
    src_obs = first[packed.obs_pt]
    src_idx = packed.obs_img[src_obs].astype(np.int32)
    assert (src_idx == packed.obs_img).sum() == Np
    xy, xy_s = (packed.obs_xy.astype(np.float32),
                packed.obs_xy[src_obs].astype(np.float32))
    kw = dict(max_iterations=10, obs_chunk=64, use_nonmonotonic_steps=True,
              use_inner_iterations=layout == "dense",
              linear_solver="dense" if layout == "dense" else "cg")
    free = (packed.pose_free, packed.tvec_free, packed.cam_free,
            packed.point_free)
    state = (packed.qvec, packed.tvec, packed.cams, packed.xyz)
    pairs = (jschur.make_pair_list(packed.obs_pt, Np) if layout == "dense"
             else (np.zeros(4, np.int32) + O,) * 2)
    j_fn, t_fn, t_jac = _two_pose_residuals(packed.cam_model)
    j_st, j_sum = jschur.ba_solve(
        j_fn, jschur.BAState(*map(jnp.asarray, state)),
        jschur.BAObservations(
            jnp.asarray(packed.obs_img), jnp.asarray(packed.obs_cam),
            jnp.asarray(packed.obs_pt), (jnp.asarray(xy), jnp.asarray(xy_s)),
            jnp.ones(O, bool), *map(jnp.asarray, pairs),
            src_idx=jnp.asarray(src_idx)),
        JLoss("cauchy", [2.0]), *map(jnp.asarray, free),
        opts=jschur.BAOptions(**kw))
    t_st, t_sum = tschur.ba_solve(
        t_fn, tschur.BAState(*map(_T, state)),
        tschur.BAObservations(
            _T(packed.obs_img).long(), _T(packed.obs_cam).long(),
            _T(packed.obs_pt).long(), (_T(xy), _T(xy_s)),
            torch.ones(O, dtype=torch.bool), *(_T(p).long() for p in pairs),
            src_idx=_T(src_idx).long()),
        RobustLoss("cauchy", [2.0]), *map(_T, free),
        opts=tschur.BAOptions(**kw), residual_jac_fn=t_jac)
    # at the optimum a step's cost change is float32 noise, and the
    # non-monotonic acceptance turns it into lambda: the two solves may
    # stop an iteration apart there (lambda at its cap)
    assert t_sum["iterations"] >= 8
    assert (t_sum["cg_iterations"] == 0) == (layout == "dense")
    assert t_sum["final_cost"] < 0.1 * t_sum["initial_cost"]
    np.testing.assert_allclose(t_sum["final_cost"], float(j_sum["final_cost"]),
                               rtol=1e-5)
    for name in ("xyz", "tvec", "qvec"):
        np.testing.assert_allclose(getattr(t_st, name).numpy(),
                                   np.asarray(getattr(j_st, name)),
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# the adjuster against JAX's (the JAX package's own patch-warp tests, with
# their assertions, on the port)
# ---------------------------------------------------------------------------

def _refine_both(conf, jrec, jfset):
    """Both adjusters on copies of one scene. The LM iteration counts are
    not compared: at the optimum the LM refuses steps until lambda reaches
    its cap, after a number of steps that float32 noise sets."""
    trec = _to_port(jrec)
    spread0 = track_consistency(jrec)
    j_out = JPW(conf).refine(jrec, jfset)
    t_out = PatchWarpBundleAdjuster(conf, device="cpu").refine(
        trec, _port_fset(jfset, 8, 16))
    assert t_out["joint_source_poses"] == j_out["joint_source_poses"]
    assert t_out["num_residuals"] == j_out["num_residuals"]
    assert t_out["final_cost"] < t_out["initial_cost"]
    np.testing.assert_allclose(t_out["final_cost"], j_out["final_cost"],
                               rtol=1e-4)
    return t_out, trec, spread0


def _conf(nodes, refine_extrinsics, iters, ref_iters, **opt):
    return {"interpolation": {"mode": "BICUBIC", "l2_normalize": False,
                              "ncc_normalize": False, "nodes": nodes},
            "optimizer": {"loss": {"name": "trivial", "params": []},
                          "refine_extrinsics": refine_extrinsics,
                          "refine_focal_length": False,
                          "refine_extra_params": False,
                          "solver": {"max_num_iterations": iters,
                                     "use_inner_iterations": False}, **opt},
            "references": {"loss": {"name": "cauchy", "params": [0.25]},
                           "iters": ref_iters, "compute_offsets3D": False}}


def test_patch_warp_constant_source_flag():
    """``test_patch_warp_constant_source_flag``: ``optimize_source_poses:
    false`` keeps the constant-source path with ``refine_extrinsics`` on."""
    rng = np.random.default_rng(0)
    jrec, jfset = featuremetric_scene(seed=11, n_images=3, n_points=12)
    for p in jrec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.005, 3)
    out, _, _ = _refine_both(_conf(NODES4, True, 10, 5,
                                   optimize_source_poses=False), jrec, jfset)
    assert out["joint_source_poses"] is False


def test_padded_rows_stay_finite_with_two_focal_lengths():
    """A zero-padded observation row of a PINHOLE scene: JAX's sanitized
    source camera keeps ``fy = 0``, so its residual is NaN there (and its
    BA's cost with it: ``w = 0`` cannot absorb a NaN); the port's dummy
    camera has ``fy = 1`` and its residual is finite (ROADMAP.md section
    3)."""
    cam = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    t = np.zeros(3, np.float32)
    X = np.array([0.1, -0.2, 5.0], np.float32)
    interp = JInterp(mode="BICUBIC", l2_normalize=False, ncc_normalize=True,
                     nodes=NODES4)
    from pixsfm_tpu.util.jit_cache import interp_static_key
    zeros = [np.zeros(s, np.float32) for s in (
        (16, 16, 3), 2, 2, (), 4, 3, 4, 2, 12, ())]
    zeros[2], zeros[3] = np.ones(2, np.float32), np.float32(1.0)
    j_r = j_build("PINHOLE", interp_static_key(interp), False)(
        *map(jnp.asarray, (q, t, cam, X)),
        tuple(map(jnp.asarray, zeros)) + (0, 0), ())
    assert np.isnan(np.asarray(j_r)).any()
    pf = tfm.PackedFeatures(torch.zeros((1, 16, 16, 3)), np.zeros((1, 2)),
                            np.ones((1, 2)), np.ones(1, np.float32), {})
    from pixsfm_tpu_torch.bundle_adjustment.main import _PatchRows
    obs = (torch.zeros(1, dtype=torch.long), torch.zeros(1, 4),
           torch.zeros(1, 3), torch.zeros(1, 4), torch.zeros(1, 2),
           torch.zeros(1, 12), torch.zeros(1))
    build, build_jac = _RESIDUAL_BUILDERS["patch_warp"]
    r, J = build_jac("PINHOLE", InterpolationConfig(
        ncc_normalize=True, l2_normalize=False, nodes=NODES4), False)(
        *(_T(a)[None] for a in (q, t, cam, X)), obs, _PatchRows(pf, "cpu"))
    assert torch.isfinite(r).all() and torch.isfinite(J).all()


def test_patch_warp_create_and_defaults():
    """``BundleAdjuster.create`` gives the patch-warp adjuster with JAX's
    defaults; fewer than two nodes raise, as in JAX."""
    adj = BundleAdjuster.create({"strategy": "patch_warp"}, device="cpu")
    assert isinstance(adj, PatchWarpBundleAdjuster)
    assert adj.conf.optimizer.optimize_source_poses is True
    interp = InterpolationConfig.from_conf(adj.conf.interpolation)
    assert interp.nodes == NODES16 and interp.ncc_normalize
    assert not interp.l2_normalize
    jrec, jfset = featuremetric_scene(seed=11, n_images=3, n_points=4)
    adj = PatchWarpBundleAdjuster({"interpolation": {"nodes": [[0.0, 0.0]]}},
                                  device="cpu")
    with pytest.raises(ValueError, match="n_nodes > 1"):
        adj.refine(_to_port(jrec), _port_fset(jfset, 8, 16))
