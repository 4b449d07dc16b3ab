"""Port parity: the bundle-adjustment slice against the JAX package, on the
CPU, with the same numpy inputs on both sides.

- geometry, camera models and ``project_with_jac`` for every camera model:
  values and Jacobians at rtol 1e-5 (float32 on both sides; atol 1e-5 for
  entries near zero);
- ``synthetic_reconstruction`` and ``pack_ba_problem``: identical arrays;
  ``robust_mean_irls`` and the reference descriptors: 1e-5 (their distances
  to the robust mean: rtol 1e-4);
- ``ba_solve`` on the flat and the grid CG layouts, on the fixture of
  ``tests/test_schur_cg.py::test_obs_grid_matches_flat``: final cost rtol
  1e-5, states atol 1e-4 (summation-order noise of two float32 programs);
- ``FeatureReferenceBundleAdjuster.refine`` / ``refine_multilevel`` with the
  grid regime forced on both sides (``_ONEHOT_BUDGET = 1``): final cost
  rtol 1e-4, poses atol 1e-3 (the whole pipeline: references, IRLS, LM);
- ``Reconstruction`` text/binary files written by one package read back by
  the other.

``use_inner_iterations`` (the BA default) is held to JAX on the flat
layout at the same tolerances. The JAX package raises ``KeyError: 'V'`` when
its grid (or point-table) regime meets ``use_inner_iterations``
(``ops/schur.py:1356`` reads the flat point blocks); the port runs inner
iterations on both layouts, so the grid case is held to the port's flat
layout, itself held to JAX (``tests/test_torch_ba_inner.py``). The entry
points, costmap BA against the truth and the inner iterations are tested
in ``tests/test_torch_ba_cli.py``, ``test_torch_costmap_truth.py`` and
``test_torch_ba_inner.py``, with this file's helpers.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base import cameras as jcam
from pixsfm_tpu.base import geometry as jgeo
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.base.projection import project_with_jac as j_project
from pixsfm_tpu.bundle_adjustment import FeatureReferenceBundleAdjuster as JFR
from pixsfm_tpu.bundle_adjustment import extract_references as j_refs
from pixsfm_tpu.bundle_adjustment import main as jba_main
from pixsfm_tpu.bundle_adjustment.problem import pack_ba_problem as j_pack
from pixsfm_tpu.bundle_adjustment.references import \
    robust_mean_irls as j_irls
from pixsfm_tpu.features.featuremaps import FeatureView as JView
from pixsfm_tpu.ops import schur as jschur
from pixsfm_tpu.sfm.model import Reconstruction as JRec
from pixsfm_tpu.sfm.synthetic import synthetic_reconstruction as j_synth
from pixsfm_tpu_torch.base import cameras as tcam
from pixsfm_tpu_torch.base import geometry as tgeo
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.base.projection import project_with_jac as t_project
from pixsfm_tpu_torch.bundle_adjustment import FeatureReferenceBundleAdjuster
from pixsfm_tpu_torch.bundle_adjustment import extract_references as t_refs
from pixsfm_tpu_torch.bundle_adjustment.main import _RESIDUAL_BUILDERS
from pixsfm_tpu_torch.bundle_adjustment.problem import \
    pack_ba_problem as t_pack
from pixsfm_tpu_torch.bundle_adjustment.references import \
    robust_mean_irls as t_irls
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.ops import schur as tschur
from pixsfm_tpu_torch.sfm.model import Reconstruction as TRec
from pixsfm_tpu_torch.sfm.synthetic import \
    synthetic_reconstruction as t_synth
from tests.test_bundle_adjustment import perturb
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_schur_cg import _grid_order

MODELS = ["SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "RADIAL", "OPENCV",
          "OPENCV_FISHEYE"]
PARAMS = {
    "SIMPLE_PINHOLE": [900.0, 320.0, 240.0],
    "PINHOLE": [900.0, 880.0, 320.0, 240.0],
    "SIMPLE_RADIAL": [900.0, 320.0, 240.0, 0.05],
    "RADIAL": [900.0, 320.0, 240.0, 0.05, -0.02],
    "OPENCV": [900.0, 880.0, 320.0, 240.0, 0.05, -0.02, 1e-3, -2e-3],
    "OPENCV_FISHEYE": [900.0, 880.0, 320.0, 240.0, 0.05, -0.02, 0.01,
                       -0.005],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: these solves run many small
    ops, and among the fast lane's parallel workers more threads only
    contend for the cores (``tests/test_torch_ba_cli.py``'s entry-point
    test keeps the default: its S2DNet convolutions use them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _T(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# geometry, cameras, projection
# ---------------------------------------------------------------------------

def test_geometry_matches():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(64, 4)).astype(np.float32)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    phi = (rng.normal(size=(64, 3)) * 0.3).astype(np.float32)
    phi[0] = 0.0
    phi[1] = 1e-7
    qn = np.asarray(jgeo.quat_normalize(jnp.asarray(q1)))
    for name, args in (("quat_normalize", (q1,)), ("quat_mul", (q1, q2)),
                       ("quat_rotate", (qn, v)), ("quat_to_rotmat", (q1,)),
                       ("exp_quat", (phi,)),
                       ("apply_pose", (qn, v[:, ::-1], v))):
        got = getattr(tgeo, name)(*map(_T, map(np.ascontiguousarray, args)))
        want = getattr(jgeo, name)(*map(jnp.asarray, args))
        _close(got, want)
    R = np.asarray(jgeo.quat_to_rotmat(jnp.asarray(qn)))
    _close(tgeo.rotmat_to_quat(_T(R)), jgeo.rotmat_to_quat(jnp.asarray(R)))


@pytest.mark.parametrize("model", MODELS)
def test_cameras_match(model):
    import jax
    rng = np.random.default_rng(1)
    params = np.asarray(PARAMS[model], np.float32)
    uv = rng.uniform(-0.5, 0.5, (32, 2)).astype(np.float32)
    uv[0] = 0.0
    _close(tcam.img_from_cam(model, _T(params), _T(uv)),
           jcam.img_from_cam(model, jnp.asarray(params), jnp.asarray(uv)),
           atol=1e-3)
    for fn in ("img_from_cam_with_jac", "distort_with_jac"):
        got = getattr(tcam, fn)(model, _T(params).expand(len(uv), -1),
                                _T(uv))
        want = jax.vmap(lambda p: getattr(jcam, fn)(
            model, jnp.asarray(params), p))(jnp.asarray(uv))
        for g, w in zip(got, want):
            _close(g, w, atol=1e-3)


@pytest.mark.parametrize("model", MODELS)
def test_cam_from_img_matches(model):
    """The fixed-iteration Newton undistortion, batched in float32 and
    through the host camera record, against JAX's at atol 1e-5; and back
    through ``img_from_cam`` to the pixels."""
    import jax
    rng = np.random.default_rng(3)
    params = np.asarray(PARAMS[model], np.float32)
    xy = rng.uniform([0, 0], [640, 480], (64, 2)).astype(np.float32)
    xy[0] = params[list(tcam.CAMERA_MODELS[model].pp_idxs)]
    want = jax.vmap(lambda p: jcam.cam_from_img(model, jnp.asarray(params),
                                                p))(jnp.asarray(xy))
    got = tcam.cam_from_img(model, _T(params), _T(xy))
    assert got.dtype == torch.float32
    _close(got, want, rtol=0, atol=1e-5)
    cam_j = jcam.Camera(1, model, 640, 480, params)
    cam_t = tcam.Camera(1, model, 640, 480, params)
    _close(cam_t.cam_from_img(xy), cam_j.cam_from_img(xy), rtol=0, atol=1e-5)
    _close(cam_t.img_from_cam(cam_t.cam_from_img(xy)), xy, rtol=0,
           atol=1e-3)


@pytest.mark.parametrize("model", MODELS)
def test_project_with_jac_matches(model):
    import jax
    rng = np.random.default_rng(2)
    n = 48
    params = np.asarray(PARAMS[model], np.float32)
    q = np.asarray(jgeo.quat_normalize(jnp.asarray(
        rng.normal(size=(n, 4)) * [[4, 1, 1, 1]])), np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32) * [[0.2, 0.2, 0.0]]
    X = (rng.uniform(-1, 1, (n, 3)) * [[1, 1, 0.5]] + [[0, 0, 5]]) \
        .astype(np.float32)
    want = jax.vmap(lambda a, b, c: j_project(model, jnp.asarray(params),
                                              a, b, c))(
        jnp.asarray(q), jnp.asarray(t, jnp.float32), jnp.asarray(X))
    got = t_project(model, _T(params).expand(n, -1), _T(q),
                    _T(t.astype(np.float32)), _T(X))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-3)


# ---------------------------------------------------------------------------
# data model, packing, references
# ---------------------------------------------------------------------------

def _to_port(jrec) -> TRec:
    """The same reconstruction as the port's data model."""
    rec = TRec()
    for c in jrec.cameras.values():
        rec.add_camera(tcam.Camera(c.camera_id, c.model, c.width, c.height,
                                   c.params.copy()))
    from pixsfm_tpu_torch.sfm.model import Image, Point3D
    for im in jrec.images.values():
        rec.add_image(Image(im.image_id, im.name, im.camera_id,
                            im.qvec.copy(), im.tvec.copy(), im.xys.copy(),
                            im.point3D_ids.copy(), im.registered))
    for p in jrec.points3D.values():
        rec.add_point3D(Point3D(p.point3D_id, p.xyz.copy(), p.color.copy(),
                                p.error, list(p.track)))
    return rec


def test_synthetic_and_pack_match():
    jrec = j_synth(n_images=5, n_points=60, noise_px=0.4, seed=7)
    trec = t_synth(n_images=5, n_points=60, noise_px=0.4, seed=7)
    jp, tp = j_pack(jrec), t_pack(trec)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_reconstruction_roundtrip(tmp_path, fmt):
    jrec = j_synth(n_images=3, n_points=20, seed=3)
    trec = _to_port(jrec)
    getattr(trec, f"write_{fmt}")(tmp_path / "t")
    getattr(jrec, f"write_{fmt}")(tmp_path / "j")
    for a, b in ((JRec.read(tmp_path / "t"), trec),
                 (TRec.read(tmp_path / "j"), jrec)):
        assert a.cameras.keys() == b.cameras.keys()
        for iid, im in b.images.items():
            np.testing.assert_array_equal(a.images[iid].qvec, im.qvec)
            np.testing.assert_array_equal(a.images[iid].xys, im.xys)
            np.testing.assert_array_equal(a.images[iid].point3D_ids,
                                          im.point3D_ids)
        for pid, p in b.points3D.items():
            np.testing.assert_array_equal(a.points3D[pid].xyz, p.xyz)
            assert a.points3D[pid].track == p.track


def test_robust_mean_irls_matches():
    rng = np.random.default_rng(4)
    desc = rng.normal(size=(30, 8, 16)).astype(np.float32)
    desc[:, 6:] += 3.0           # outliers the robust mean must discount
    valid = rng.random((30, 8)) < 0.8
    valid[:, 0] = True
    import jax
    for l2 in (True, False):
        want = jax.vmap(lambda d, v: j_irls(d, v, JLoss("cauchy", [0.25]),
                                            20, l2_normalize=l2))(
            jnp.asarray(desc), jnp.asarray(valid))
        got = t_irls(_T(desc), _T(valid), RobustLoss("cauchy", [0.25]), 20,
                     l2_normalize=l2)
        _close(got, want)


def _port_fset(jfset, C, ps):
    """The port's FeatureSet holding the same float32 patches."""
    fset = tfm.FeatureSet(channels=C, patch_size=ps, dtype="float32")
    for name, fmap in jfset.maps.items():
        ids = sorted(fmap.patches)
        patches = np.stack([fmap.patches[i].data for i in ids])
        corners = np.stack([fmap.patches[i].corner for i in ids])
        fset.emplace(name, tfm.FeatureMap.from_arrays(
            patches, ids, corners, np.array([1.0, 1.0])))
    return fset


def test_extract_references_matches():
    jrec, jfset = featuremetric_scene(seed=5, n_images=4, n_points=30)
    rng = np.random.default_rng(5)
    perturb(jrec, rng, pose_rot=0.002, pose_t=0.01, point_sigma=0.02)
    trec = _to_port(jrec)
    tfset = _port_fset(jfset, 8, 16)
    conf = {"loss": {"name": "cauchy", "params": [0.25]}, "iters": 20,
            "keep_observations": True}
    for l2 in (False, True):
        pids = sorted(jrec.points3D)
        jr = j_refs(jrec, jfset, JView.from_reconstruction(jfset, jrec, pids),
                    conf, JInterp(mode="BICUBIC", l2_normalize=l2))
        tr = t_refs(trec, tfset, tfm.FeatureView.from_reconstruction(
            tfset, trec, pids), conf,
            InterpolationConfig(mode="BICUBIC", l2_normalize=l2))
        assert jr.keys() == tr.keys()
        for pid in jr:
            assert tr[pid].source == jr[pid].source
            assert tr[pid].observations == jr[pid].observations
            _close(tr[pid].descriptor, jr[pid].descriptor)
            # squared distances to the IRLS mean: 20 reweighting steps
            # accumulate float32 rounding of two summation orders
            _close(tr[pid].costs, jr[pid].costs, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# ba_solve, flat and grid CG layouts
# ---------------------------------------------------------------------------

def _solve_both(layout, **opt_kw):
    """``layout``: "flat" / "grid" (CG step) or "dense" (dense step); a
    bool means "grid" / "flat"."""
    if isinstance(layout, bool):
        layout = "grid" if layout else "flat"
    grid = layout == "grid"
    rng = np.random.default_rng(0)
    rec = j_synth(n_images=5, n_points=80, noise_px=0.4, seed=72)
    perturb(rng=rng, rec=rec, pose_rot=0.003, pose_t=0.02, point_sigma=0.02)
    packed = j_pack(rec)
    O, Np, T_b = len(packed.obs_img), len(packed.point_ids), 8
    if grid:
        sel, valid = _grid_order(packed.obs_pt, Np, T_b)
        pt = np.arange(Np * T_b) // T_b
    else:
        sel, valid, pt = np.arange(O), np.ones(O, bool), packed.obs_pt
    kw = dict(dict(max_iterations=12, obs_chunk=64,
                   linear_solver="dense" if layout == "dense" else "cg",
                   obs_grid_T=T_b if grid else 0), **opt_kw)
    free = (packed.pose_free, packed.tvec_free, packed.cam_free,
            packed.point_free)
    state = (packed.qvec, packed.tvec, packed.cams, packed.xyz)
    model = packed.cam_model
    if layout == "dense":
        pairs = jschur.make_pair_list(packed.obs_pt, Np)
    else:
        pairs = (np.zeros(4, np.int32) + len(sel),) * 2
    if not (grid and opt_kw.get("use_inner_iterations")):
        jobs = jschur.BAObservations(
            jnp.asarray(packed.obs_img[sel]), jnp.asarray(packed.obs_cam[sel]),
            jnp.asarray(pt.astype(np.int32)),
            jnp.asarray(packed.obs_xy[sel], jnp.float32), jnp.asarray(valid),
            *map(jnp.asarray, pairs))
        j_st, j_sum = jschur.ba_solve(
            jba_main._RESIDUAL_BUILDERS["geometric"]((model,)),
            jschur.BAState(*map(jnp.asarray, state)), jobs, JLoss("trivial"),
            *map(jnp.asarray, free), opts=jschur.BAOptions(**kw),
            residual_jac_fn=jba_main._RESIDUAL_JAC_BUILDERS["geometric"](
                (model,)))
        j_out = (j_st, float(j_sum["final_cost"]))
    else:
        j_out = None
    tobs = tschur.BAObservations(
        _T(packed.obs_img[sel]).long(), _T(packed.obs_cam[sel]).long(),
        _T(pt).long(), (_T(packed.obs_xy[sel].astype(np.float32)),),
        _T(valid), *(_T(p).long() for p in pairs))
    build, build_jac = _RESIDUAL_BUILDERS["geometric"]
    t_st, t_sum = tschur.ba_solve(
        build(model), tschur.BAState(*map(_T, state)), tobs,
        RobustLoss("trivial"), *map(_T, free), opts=tschur.BAOptions(**kw),
        residual_jac_fn=build_jac(model))
    return j_out, (t_st, t_sum)


@pytest.mark.parametrize("layout", ["flat", "grid", "dense"],
                         ids=["False", "True", "dense"])
def test_ba_solve_matches(layout):
    (j_st, j_cost), (t_st, t_sum) = _solve_both(layout)
    assert t_sum["iterations"] == 12
    assert (t_sum["cg_iterations"] == 0) == (layout == "dense")
    np.testing.assert_allclose(t_sum["final_cost"], j_cost, rtol=1e-5)
    for name in ("xyz", "tvec", "qvec"):
        np.testing.assert_allclose(getattr(t_st, name).numpy(),
                                   np.asarray(getattr(j_st, name)),
                                   atol=1e-4, err_msg=name)


def _assert_solves_match(t_st, t_cost, ref_st, ref_cost):
    np.testing.assert_allclose(t_cost, ref_cost, rtol=1e-5)
    for name in ("xyz", "tvec", "qvec"):
        np.testing.assert_allclose(getattr(t_st, name).numpy(),
                                   np.asarray(getattr(ref_st, name)),
                                   atol=1e-4, err_msg=name)


def test_dense_camera_solve():
    """The Jacobi-scaled Cholesky solves an SPD system; a system that is not
    positive definite gives NaNs (JAX's Cholesky), not a silent zero."""
    rng = np.random.default_rng(9)
    A = rng.normal(size=(30, 30))
    d = 10.0 ** rng.uniform(-3, 3, 30)          # pixel-scale conditioning
    S = (A @ A.T + 30 * np.eye(30)) * np.outer(d, d)
    b = rng.normal(size=30)
    x = tschur.dense_camera_solve(_T(S).float(), _T(b).float()).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(S, b), rtol=1e-4)
    S[3, 3] = -S[3, 3]
    x = tschur.dense_camera_solve(_T(S).float(), _T(b).float())
    assert torch.isnan(x).all()


def test_ba_solve_out_of_scope_raises():
    _, (st, _) = _solve_both(False, max_iterations=0,
                             use_inner_iterations=True)
    obs = tschur.BAObservations(*(torch.zeros(1, dtype=torch.long),) * 3,
                                (torch.zeros(1, 2),), torch.ones(1, dtype=torch.bool))
    free = (torch.ones(st.qvec.shape[0], dtype=torch.bool),) * 4
    with pytest.raises(ValueError, match="observation pairs"):
        tschur.ba_solve(None, st, obs, RobustLoss(), *free,
                        opts=tschur.BAOptions(), residual_jac_fn=lambda: 0)
    # without residual_jac_fn the Jacobian is forward mode over the
    # residual (tests/test_torch_ba_jacfwd.py), nothing raises for it
    # a second pose block per observation runs on the flat layout and the
    # dense step (tests/test_torch_patch_warp.py), never on the grid
    with pytest.raises(ValueError, match="src_idx"):
        tschur.ba_solve(None, st, obs._replace(src_idx=obs.img_idx),
                        RobustLoss(), *free, residual_jac_fn=lambda: 0,
                        opts=tschur.BAOptions(linear_solver="cg",
                                              obs_grid_T=4))


def test_make_pair_list_and_point_major_match():
    pt = np.random.default_rng(3).integers(0, 40, 200).astype(np.int32)
    for a, b in zip(tschur.make_pair_list(pt, 40),
                    jschur.make_pair_list(pt, 40)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tschur.make_point_major(pt, 40, 200),
                                  jschur.make_point_major(pt, 40, 200))


# ---------------------------------------------------------------------------
# the adjuster, grid regime forced on both sides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multilevel", [False, True])
def test_feature_reference_refine_matches(monkeypatch, multilevel):
    conf = {
        "interpolation": {"mode": "BICUBIC", "l2_normalize": multilevel},
        "optimizer": {"solver": {"max_num_iterations": 15,
                                 "use_inner_iterations": False,
                                 "max_linear_solver_iterations": 200}},
        "references": {"loss": {"name": "cauchy", "params": [0.25]},
                       "iters": 20},
    }
    jrec, jfset = featuremetric_scene(seed=6, n_images=4, n_points=40)
    perturb(jrec, np.random.default_rng(6), pose_rot=0.002, pose_t=0.01,
            point_sigma=0.02)
    trec = _to_port(jrec)
    tfset = _port_fset(jfset, 8, 16)
    monkeypatch.setattr(jschur, "_ONEHOT_BUDGET", 1)
    monkeypatch.setattr(tschur, "_ONEHOT_BUDGET", 1)
    seen = []
    orig = jba_main._compiled_ba_run
    monkeypatch.setattr(jba_main, "_compiled_ba_run",
                        lambda *a: seen.append(a[2]) or orig(*a))

    class _Manager:
        num_levels = 1

        def __init__(self, fset):
            self._fset = fset

        def fset(self, level):
            return self._fset

    outs = []
    for adj, rec, fset in ((JFR(conf), jrec, jfset),
                           (FeatureReferenceBundleAdjuster(conf,
                                                           device="cpu"),
                            trec, tfset)):
        base = adj._ba_options()
        adj._ba_options = lambda **kw: dataclasses.replace(
            base, linear_solver="cg", obs_chunk=128)
        if multilevel:
            outs.append({k: v[0] for k, v in adj.refine_multilevel(
                rec, _Manager(fset)).items()})
        else:
            outs.append(adj.refine(rec, fset))
    j_out, t_out = outs
    assert seen and seen[-1].obs_grid_T > 0
    assert t_out["obs_grid_T"] == seen[-1].obs_grid_T
    assert t_out["final_cost"] < 0.5 * t_out["initial_cost"]
    np.testing.assert_allclose(t_out["initial_cost"], j_out["initial_cost"],
                               rtol=1e-4)
    np.testing.assert_allclose(t_out["final_cost"], j_out["final_cost"],
                               rtol=1e-4)
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].qvec, im.qvec, atol=1e-3)
        np.testing.assert_allclose(trec.images[iid].tvec, im.tvec, atol=1e-3)


def _jax_k4_record(monkeypatch):
    """The JAX package's run behind ``tests/ba_fused_jax_record.json``:
    ``featuremetric_scene`` at 128 channels (a width K4 reads) perturbed as
    above, refined by JAX's adjuster on the grid layout with CG steps ->
    ``(record, jrec, jfset)``, ``jrec`` the perturbed input."""
    from tests.test_torch_ba_fused import (grid_cg_options, jax_record_conf,
                                           refined)
    jrec, jfset = featuremetric_scene(seed=6, n_images=4, n_points=40,
                                      C=128)
    perturb(jrec, np.random.default_rng(6), pose_rot=0.002, pose_t=0.01,
            point_sigma=0.02)
    record = {"input": {k: v for k, v in refined(jrec, {
        "initial_cost": 0.0, "final_cost": 0.0}).items()
        if k in ("qvec", "tvec", "xyz")}}
    record["input"]["xys"] = {str(i): im.xys.tolist()
                              for i, im in jrec.images.items()}
    monkeypatch.setattr(jschur, "_ONEHOT_BUDGET", 1)
    rec = jrec.copy()
    adj = JFR(jax_record_conf())
    grid_cg_options(adj)
    record["output"] = refined(rec, adj.refine(rec, jfset))
    return record, jrec, jfset


def test_jax_record_of_k4_scene(monkeypatch):
    """``tests/ba_fused_jax_record.json``, by which the card holds K4's whole
    solve to the JAX package (``tests/test_torch_ba_fused.py::
    test_k4_refine_matches_jax_record``), is what JAX gives now (1e-5 of the
    costs, 1e-5 on the parameters); its scene, built there without JAX, is
    JAX's; and the port's chunk loop on the CPU reaches it at this file's
    parity tolerances (costs rtol 1e-4, poses and points atol 1e-3)."""
    from tests.test_torch_ba_fused import (JAX_RECORD, assert_refined_close,
                                           grid_cg_options, jax_record_conf,
                                           jax_record_scene, refined)
    with open(JAX_RECORD) as fh:
        want = json.load(fh)
    got, jrec, jfset = _jax_k4_record(monkeypatch)
    for key in ("qvec", "tvec", "xyz", "xys"):
        assert got["input"][key] == want["input"][key], key
    assert_refined_close(got["output"], want["output"], rtol=1e-5,
                         atol=1e-5)
    trec, tfset = jax_record_scene(want)
    want_rec, want_fset = _to_port(jrec), _port_fset(jfset, 128, 16)
    for iid, im in want_rec.images.items():
        np.testing.assert_array_equal(trec.images[iid].xys, im.xys)
        np.testing.assert_array_equal(trec.images[iid].point3D_ids,
                                      im.point3D_ids)
        np.testing.assert_array_equal(trec.images[iid].qvec, im.qvec)
        np.testing.assert_array_equal(trec.images[iid].tvec, im.tvec)
        np.testing.assert_array_equal(
            tfset.maps[im.name].patches.numpy(),
            want_fset.maps[im.name].patches.numpy())
        np.testing.assert_array_equal(tfset.maps[im.name].corners,
                                      want_fset.maps[im.name].corners)
    for pid, p in want_rec.points3D.items():
        np.testing.assert_array_equal(trec.points3D[pid].xyz, p.xyz)
        assert trec.points3D[pid].track == p.track
    monkeypatch.setattr(tschur, "_ONEHOT_BUDGET", 1)
    rec = trec.copy()
    adj = FeatureReferenceBundleAdjuster(jax_record_conf(), device="cpu")
    grid_cg_options(adj)
    out = adj.refine(rec, tfset)
    assert out["obs_grid_T"] > 0
    assert_refined_close(refined(rec, out), want["output"])


# ---------------------------------------------------------------------------
# the adjusters in the dense regime (their default on small scenes), mixed
# camera models, segmented dispatch
# ---------------------------------------------------------------------------

def _scene(strategy, mixed):
    """A small scene for ``strategy`` (JAX's reconstruction, and for the
    featuremetric strategy its feature set), half the images on a RADIAL
    camera with k2 = 0 when ``mixed`` (``tests/test_mixed_fm_ba.py``)."""
    from tests.test_mixed_fm_ba import split_cameras_mixed
    if strategy == "geometric":
        rec, fset = j_synth(n_images=5, n_points=60, noise_px=0.3,
                            seed=31), None
    else:
        rec, fset = featuremetric_scene(seed=6, n_images=4, n_points=40)
    if mixed:
        split_cameras_mixed(rec)
    perturb(rec, np.random.default_rng(6), pose_rot=0.002, pose_t=0.01,
            point_sigma=0.02)
    return rec, fset


def _costmaps_from_jax(monkeypatch):
    """Run the port's costmap solve on the JAX package's cost patches: the
    port's own extraction still runs and is held to JAX's (1e-4 of the
    largest value, references included, as in
    ``tests/test_torch_costmaps.py``), then JAX's patches replace it, so
    that both solves start from identical inputs."""
    from pixsfm_tpu.bundle_adjustment import costmaps as jcm
    from pixsfm_tpu_torch.bundle_adjustment import costmaps as tcm
    seen = {}
    j_extract, t_extract = jcm.extract_costmaps, tcm.extract_costmaps

    def j_wrap(*args, **kwargs):
        seen["cset"], refs = j_extract(*args, **kwargs)
        return seen["cset"], refs

    def t_wrap(*args, **kwargs):
        cset, refs, timings = t_extract(*args, **kwargs)
        jset = seen.pop("cset")
        out = tfm.FeatureSet(jset.channels, jset.patch_size, "float32")
        assert list(cset.maps) == list(jset.maps)
        scale = max(np.abs(p.data).max() for m in jset.maps.values()
                    for p in m.patches.values())
        for name, jmap in jset.maps.items():
            tmap = cset.maps[name]
            assert tmap.keypoint_ids() == list(jmap.patches)
            want = np.stack([p.data for p in jmap.patches.values()])
            _close(tmap.patches.numpy(), want, rtol=0, atol=1e-4 * scale)
            out.emplace(name, tfm.FeatureMap.from_arrays(
                want, tmap.keypoint_ids(), tmap.corners, tmap.scale,
                upsampling_factor=tmap.upsampling_factor))
        return out, refs, timings

    monkeypatch.setattr(jcm, "extract_costmaps", j_wrap)
    monkeypatch.setattr(tcm, "extract_costmaps", t_wrap)


_REFINE_CASES = [(s, v) for v in ("dense", "mixed", "segments")
                 for s in ("geometric", "feature_reference", "costmaps")] \
    + [("costmaps", "points")]


@pytest.mark.parametrize("strategy,variant", _REFINE_CASES,
                         ids=[f"{v}-{s}" for s, v in _REFINE_CASES])
def test_adjuster_refine_matches(monkeypatch, strategy, variant):
    """``GeometricBundleAdjuster`` / ``FeatureReferenceBundleAdjuster`` /
    ``CostMapBundleAdjuster`` ``.refine`` against JAX's on a small scene,
    which both take to the dense step: with one camera model, with two
    (SIMPLE_RADIAL and RADIAL), and dispatched in segments of 3 LM
    iterations; for costmaps also with every camera flag off (points only,
    the BA of the ``low_memory`` preset). Final cost rtol 1e-4, poses and
    points atol 1e-3 (the whole solve, as for the grid regime above).

    Costmap BA is held to these limits over the LM iterations up to its
    first accepted step (4 rejected before it; 6 iterations in segments),
    points only over 10, without inner iterations, from JAX's cost patches
    (the port's own are held to them at 1e-5 of the largest value): its
    residual is the cost itself, whose gradient vanishes at each
    observation's minimum, so the normal equations are near-singular and
    the LM is chaotic. JAX's own solve of the dense case ends 21 % apart
    in cost and 0.28 apart in the points after 10 iterations when only its
    chunked summation order changes (``obs_chunk`` 32 instead of 8192); the
    port's first accepted step is within 8e-5 of JAX's in cost from
    identical patches."""
    from pixsfm_tpu.bundle_adjustment import CostMapBundleAdjuster as JCM
    from pixsfm_tpu.bundle_adjustment import GeometricBundleAdjuster as JGeo
    from pixsfm_tpu_torch.bundle_adjustment import (CostMapBundleAdjuster,
                                                    GeometricBundleAdjuster)
    solver = {"max_num_iterations": 10, "use_inner_iterations": True,
              "segment_iterations": 3 if variant == "segments" else 0}
    conf = {"optimizer": {"solver": solver}}
    if strategy != "geometric":
        conf.update(interpolation={"mode": "BICUBIC", "l2_normalize": False},
                    references={"loss": {"name": "cauchy",
                                         "params": [0.25]}, "iters": 20})
    if strategy == "costmaps":
        solver.update(use_inner_iterations=False, max_num_iterations={
            "dense": 5, "mixed": 5, "segments": 6, "points": 10}[variant])
        if variant == "points":
            conf["optimizer"].update({f"refine_{k}": False for k in (
                "focal_length", "principal_point", "extra_params",
                "extrinsics")})
        _costmaps_from_jax(monkeypatch)
    jrec, jfset = _scene(strategy, variant == "mixed")
    trec = _to_port(jrec)
    if strategy == "geometric":
        j_out = JGeo(conf).refine(jrec)
        t_out = GeometricBundleAdjuster(conf, device="cpu").refine(trec)
    else:
        j_cls, t_cls = {"feature_reference": (JFR,
                                              FeatureReferenceBundleAdjuster),
                        "costmaps": (JCM, CostMapBundleAdjuster)}[strategy]
        j_out = j_cls(conf).refine(jrec, jfset)
        t_out = t_cls(conf, device="cpu").refine(trec,
                                                 _port_fset(jfset, 8, 16))
    assert t_out["linear_solver"] == "dense" and t_out["cg_iterations"] == 0
    assert len({c.model for c in trec.cameras.values()}) == (
        2 if variant == "mixed" else 1)
    assert t_out.get("interrupted") is (False if variant == "segments"
                                        else None)
    assert t_out["iterations"] == j_out["iterations"]
    # costmap BA's cases stop after its first accepted step
    assert t_out["final_cost"] < (1.0 if strategy == "costmaps" else 0.5) \
        * t_out["initial_cost"]
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=1e-4)
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].qvec, im.qvec, atol=1e-3)
        np.testing.assert_allclose(trec.images[iid].tvec, im.tvec, atol=1e-3)
    for cid, cam in jrec.cameras.items():
        np.testing.assert_allclose(trec.cameras[cid].params, cam.params,
                                   rtol=1e-4, atol=1e-4)
    for pid, p in jrec.points3D.items():
        np.testing.assert_allclose(trec.points3D[pid].xyz, p.xyz, atol=1e-3)


