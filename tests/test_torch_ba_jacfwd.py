"""Port parity: ``ba_solve`` without a closed-form Jacobian (forward mode
over the residual, ``ops/schur.jacfwd_residual_jac``) and
``feature_reference`` BA with node windows, with and without NCC.

- ``jacfwd_residual_jac`` against the closed-form Jacobians: the
  geometric residual (``project_with_jac``) and the two-pose residual of
  ``tests/test_torch_patch_warp.py`` (``src_idx``'s layout ``[omega, dt,
  omega_src, dt_src, dcam, dX]``), within 1e-4 of the largest entry
  (float32 forward mode against the analytic chain, as the port's
  closed-form patch-warp Jacobian against ``jax.jacfwd``); the residuals
  within 1e-3 px (forward mode evaluates at the renormalized quaternion,
  as JAX's ``obs_residual``).
- ``ba_solve`` without ``residual_jac_fn`` against the same solve with
  it, on the flat CG layout, the grid layout and the dense step, and with
  ``src_idx`` on the flat layout: final cost rtol 1e-5, states atol 1e-4
  (the fixtures of ``tests/test_torch_ba.py`` /
  ``tests/test_torch_patch_warp.py``, whose closed-form solves are held to
  the JAX package there at those limits).
- ``FeatureReferenceBundleAdjuster.refine`` with 2x2 node windows at
  +-0.5 px, L2 on (the closed-form path through the node read), and with
  NCC (no closed-form Jacobian in either package: forward mode), against
  the JAX package's adjuster on ``featuremetric_scene`` (textured for NCC,
  as ``tests/test_torch_patch_warp.py`` does): final cost rtol 1e-4,
  poses atol 1e-3, as the one-node cases of ``tests/test_torch_ba.py``.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu.bundle_adjustment import FeatureReferenceBundleAdjuster as JFR
from pixsfm_tpu.bundle_adjustment.problem import pack_ba_problem as j_pack
from pixsfm_tpu.ops import schur as jschur
from pixsfm_tpu.sfm.synthetic import synthetic_reconstruction as j_synth
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.bundle_adjustment import FeatureReferenceBundleAdjuster
from pixsfm_tpu_torch.bundle_adjustment.main import _RESIDUAL_BUILDERS
from pixsfm_tpu_torch.ops import schur as tschur
from tests.test_bundle_adjustment import perturb
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_schur_cg import _grid_order
from tests.test_torch_ba import _port_fset, _to_port
from tests.test_torch_patch_warp import _textured, _two_pose_residuals
from tests.test_torch_localization import _one_torch_thread  # noqa: F401

NODES4 = [[-0.5, -0.5], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]


def _T(a):
    return torch.as_tensor(np.array(a))


def _problem(seed=72, n_points=80):
    rng = np.random.default_rng(0)
    rec = j_synth(n_images=5, n_points=n_points, noise_px=0.4, seed=seed)
    perturb(rng=rng, rec=rec, pose_rot=0.003, pose_t=0.02, point_sigma=0.02)
    return j_pack(rec)


def test_jacfwd_matches_closed_form_jacobians():
    packed = _problem()
    n = 40
    q = _T(packed.qvec[packed.obs_img[:n]]).float()
    t = _T(packed.tvec[packed.obs_img[:n]]).float()
    cam = _T(packed.cams[packed.obs_cam[:n]]).float()
    X = _T(packed.xyz[packed.obs_pt[:n]]).float()
    xy = _T(packed.obs_xy[:n]).float()
    build, build_jac = _RESIDUAL_BUILDERS["geometric"]
    model = packed.cam_model
    cases = [((q, t, cam, X, (xy,), None), build(model), build_jac(model),
              False)]
    _, t_fn, t_jac = _two_pose_residuals(model)
    src = packed.obs_img[::-1][:n].copy()
    qs = _T(packed.qvec[src]).float()
    ts = _T(packed.tvec[src]).float()
    cases.append(((q, t, qs, ts, cam, X, (xy, xy.flip(0)), None), t_fn,
                  t_jac, True))
    for args, fn, jac, has_src in cases:
        r_f, J_f = tschur.jacfwd_residual_jac(fn, has_src)(*args)
        r_c, J_c = jac(*args)
        assert J_f.shape == J_c.shape == (n, r_c.shape[1],
                                          (12 if has_src else 6) + 3
                                          + cam.shape[1])
        # forward mode evaluates at normalize(exp(0) q), as JAX's
        # obs_residual: a few float32 ulps of ~1000 px pixels apart
        np.testing.assert_allclose(r_f.numpy(), r_c.numpy(), atol=1e-3)
        np.testing.assert_allclose(J_f.numpy(), J_c.numpy(),
                                   atol=1e-4 * np.abs(J_c.numpy()).max())


def _solve(layout, jac: bool):
    packed = _problem()
    O, Np, T_b = len(packed.obs_img), len(packed.point_ids), 8
    grid = layout == "grid"
    if grid:
        sel, valid = _grid_order(packed.obs_pt, Np, T_b)
        pt = np.arange(Np * T_b) // T_b
    else:
        sel, valid, pt = np.arange(O), np.ones(O, bool), packed.obs_pt
    if layout == "dense":
        pairs = jschur.make_pair_list(packed.obs_pt, Np)
    else:
        pairs = (np.zeros(4, np.int32) + len(sel),) * 2
    obs = tschur.BAObservations(
        _T(packed.obs_img[sel]).long(), _T(packed.obs_cam[sel]).long(),
        _T(pt).long(), (_T(packed.obs_xy[sel].astype(np.float32)),),
        _T(valid), *(_T(p).long() for p in pairs))
    build, build_jac = _RESIDUAL_BUILDERS["geometric"]
    opts = tschur.BAOptions(
        max_iterations=8, obs_chunk=64, obs_grid_T=T_b if grid else 0,
        linear_solver="dense" if layout == "dense" else "cg")
    return tschur.ba_solve(
        build(packed.cam_model),
        tschur.BAState(*map(_T, (packed.qvec, packed.tvec, packed.cams,
                                 packed.xyz))), obs,
        RobustLoss("cauchy", [2.0]),
        *map(_T, (packed.pose_free, packed.tvec_free, packed.cam_free,
                  packed.point_free)),
        opts=opts, residual_jac_fn=build_jac(packed.cam_model) if jac
        else None)


def _assert_same(a, b):
    (st_a, sum_a), (st_b, sum_b) = a, b
    assert sum_a["final_cost"] < 0.5 * sum_a["initial_cost"]
    np.testing.assert_allclose(sum_a["final_cost"], sum_b["final_cost"],
                               rtol=1e-5)
    for name in ("xyz", "tvec", "qvec"):
        np.testing.assert_allclose(getattr(st_a, name).numpy(),
                                   getattr(st_b, name).numpy(), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["flat", "grid", "dense"])
def test_jacfwd_ba_solve_matches_closed_form(layout):
    _assert_same(_solve(layout, jac=False), _solve(layout, jac=True))


def test_jacfwd_ba_solve_src_idx_matches_closed_form():
    packed = _problem(n_points=60)
    O, Np = len(packed.obs_img), len(packed.point_ids)
    first = np.full(Np, -1)
    for o in range(O):
        if first[packed.obs_pt[o]] < 0:
            first[packed.obs_pt[o]] = o
    src_obs = first[packed.obs_pt]
    _, t_fn, t_jac = _two_pose_residuals(packed.cam_model)
    obs = tschur.BAObservations(
        _T(packed.obs_img).long(), _T(packed.obs_cam).long(),
        _T(packed.obs_pt).long(),
        (_T(packed.obs_xy.astype(np.float32)),
         _T(packed.obs_xy[src_obs].astype(np.float32))),
        torch.ones(O, dtype=torch.bool), *(_T(np.zeros(4, int) + O).long(),) * 2,
        src_idx=_T(packed.obs_img[src_obs]).long())
    outs = [tschur.ba_solve(
        t_fn, tschur.BAState(*map(_T, (packed.qvec, packed.tvec, packed.cams,
                                        packed.xyz))), obs,
        RobustLoss("cauchy", [2.0]),
        *map(_T, (packed.pose_free, packed.tvec_free, packed.cam_free,
                  packed.point_free)),
        opts=tschur.BAOptions(max_iterations=8, obs_chunk=64,
                              linear_solver="cg"),
        residual_jac_fn=jac) for jac in (None, t_jac)]
    _assert_same(*outs)


class _Manager:
    num_levels = 1

    def __init__(self, fset):
        self._fset = fset

    def fset(self, level):
        return self._fset


@pytest.mark.parametrize("ncc", [False, True], ids=["l2", "ncc"])
def test_feature_reference_nodes_matches_jax(ncc):
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": not ncc,
                              "ncc_normalize": ncc, "nodes": NODES4},
            "optimizer": {"solver": {"max_num_iterations": 8,
                                     "use_inner_iterations": False}},
            "references": {"loss": {"name": "cauchy", "params": [0.25]},
                           "iters": 20}}
    jrec, jfset = featuremetric_scene(seed=6, n_images=4, n_points=30)
    if ncc:
        _textured(jrec, jfset)
    perturb(jrec, np.random.default_rng(6), pose_rot=0.002, pose_t=0.01,
            point_sigma=0.02)
    trec = _to_port(jrec)
    seen = []
    orig = tschur.jacfwd_residual_jac
    tschur.jacfwd_residual_jac = lambda *a: seen.append(a) or orig(*a)
    try:
        t_out = FeatureReferenceBundleAdjuster(conf, device="cpu").refine(
            trec, _port_fset(jfset, 8, 16))
    finally:
        tschur.jacfwd_residual_jac = orig
    j_out = JFR(conf).refine(jrec, jfset)
    # NCC takes forward mode (no closed form in either package), L2 the
    # closed-form node read
    assert bool(seen) == ncc
    assert t_out["final_cost"] < 0.5 * t_out["initial_cost"]
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=1e-4)
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].qvec, im.qvec, atol=1e-3)
        np.testing.assert_allclose(trec.images[iid].tvec, im.tvec, atol=1e-3)
