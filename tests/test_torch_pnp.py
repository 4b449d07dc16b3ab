"""Port parity: the PnP of ``localization/pnp.py`` against the JAX package on
the CPU, with the same numpy inputs and the same seeds on both sides.

- The batched minimal solvers on the same minimal samples, float32:
  ``_solve_quartic_real`` (roots within 1e-4 relative, the same NaN
  pattern), ``_smallest_evec`` (the same vector up to sign, 1e-5),
  ``_project_so3`` (1e-5), and P3P, the DLT and the homography on exact
  samples of a 60-degree camera on which JAX's float32 answer is not
  decided by rounding (:func:`_rounding_free`): ``ok`` masks equal,
  rotations and translations within 1e-4 relative where both are ok.
- The DLT's cheirality sign on a sample whose six projective depths have
  an even-count median that ``torch.median`` would get wrong: translation
  within 1e-4 of JAX's and of the truth.
- ``_absolute_pose_estimation_host`` (float64, the same rng, the same
  float32 rays): inlier sets equal, poses atol 1e-9.
- ``absolute_pose_estimation`` and ``absolute_pose_estimation_batch``
  (staged, ``polish`` off and on) on the scenes of
  ``tests/test_localization.py::TestPnP`` (recovers pose, planar,
  outliers) and on a batch of mixed sizes with a query that escalates to
  stage 2: the same ``success``, ``num_inliers`` within 1, rotations within
  1e-2 rad and translations within 1e-2 of the scene's scale (``max(|t|,
  median distance of the points)``) unpolished, where the pose is one of
  several tied minimal-sample hypotheses (:func:`_assert_pose_parity`), and
  within 1e-6 polished (the float64 host polish, whose Cauchy scale is the
  1 px floor on these scenes, so it reaches one optimum from either start;
  ``chip_smoke.py`` phase 14 explains why its noisier queries get looser
  pose limits beside consensus checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.cameras import Camera as JCamera
from pixsfm_tpu.localization import pnp as jpnp
from pixsfm_tpu.sfm.synthetic import synthetic_reconstruction as j_synth
from pixsfm_tpu_torch.base.cameras import Camera
from pixsfm_tpu_torch.localization import pnp as tpnp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: these tests run many small
    ops, and among the fast lane's parallel workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotmat(phi):
    phi = np.asarray(phi, np.float64)
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]]) / max(th, 1e-300)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _cams(model, params, W=1024, H=768):
    return (JCamera(1, model, W, H, np.asarray(params, np.float64)),
            Camera(1, model, W, H, np.asarray(params, np.float64)))


def _jcam(cam):
    return JCamera(cam.camera_id, cam.model, cam.width, cam.height,
                   cam.params)


def _rot_angle(q1, q2):
    q1 = np.asarray(q1) / np.linalg.norm(q1)
    q2 = np.asarray(q2) / np.linalg.norm(q2)
    return 2 * np.arccos(np.clip(abs(float(np.dot(q1, q2))), 0.0, 1.0))


def _jit(fn):
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# the batched minimal solvers
# ---------------------------------------------------------------------------

def _minimal_samples(seed, B=96, planar=False):
    """Exact minimal samples of six points seen by a 60-degree camera: rays
    ``su [B, 6, 2]``, points ``sx [B, 6, 3]`` (float32) and the true
    ``(R, t)`` of each sample's camera."""
    rng = np.random.default_rng(seed)
    su, sx, Rs, ts = [], [], [], []
    for _ in range(B):
        R = _rotmat(rng.normal(0, 0.4, 3))
        t = rng.uniform(-0.5, 0.5, 3) + [0, 0, 4.0]
        xc = np.stack([rng.uniform(-1.8, 1.8, 6), rng.uniform(-1.4, 1.4, 6),
                       rng.uniform(3.0, 5.0, 6)], 1)
        if planar:
            xc[:, 2] = 4.0 + 0.3 * xc[:, 0] - 0.2 * xc[:, 1]
        X = (xc - t) @ R            # R^T (xc - t)
        su.append(xc[:, :2] / xc[:, 2:])
        sx.append(X)
        Rs.append(R)
        ts.append(t)
    return (np.asarray(su, np.float32), np.asarray(sx, np.float32),
            np.asarray(Rs), np.asarray(ts))


def _rounding_free(jfn, tfn, su, sx, k, n_trials=4, rel=1e-6, gain=20.0):
    """Samples on which the JAX package's float32 answer is not decided by
    rounding: its ``ok`` mask and poses are the float64 solve's (the port's
    function in float64 stands in for exact arithmetic; where JAX's norm of
    a clamped-pivot null vector overflows, its pose is garbage), and under
    relative
    perturbations of the rays of ``rel`` (a few float32 ulps) the mask stays
    the same and no pose moves by more than ``gain * rel``. At a near-double
    root of P3P's quartic, or where the resolvent cubic's discriminant is
    near zero, float32 rounding alone (different in XLA and in torch)
    decides which roots are real, how they pair and where they lie."""
    rng = np.random.default_rng(0)
    fn = _jit(jfn)
    R, t, ok = [np.asarray(a) for a in fn(jnp.asarray(su), jnp.asarray(sx))]
    tn = np.maximum(np.abs(t).max(1, keepdims=True), 1.0)
    R64, _, ok64 = [a.numpy() for a in tfn(
        torch.as_tensor(su.astype(np.float64)),
        torch.as_tensor(sx.astype(np.float64)))]
    off = np.where(ok, np.abs(R - R64).reshape(len(R), 9).max(1), 0.0)
    keep = ((ok64 == ok) & (off < 1e-3)).reshape(len(su), k).all(1)
    for _ in range(n_trials):
        up = su * (1 + rng.normal(0, rel, su.shape)).astype(np.float32)
        Rp, tp, okp = [np.asarray(a) for a in fn(jnp.asarray(up),
                                                  jnp.asarray(sx))]
        moved = np.where(ok, np.maximum(
            np.abs(Rp - R).reshape(len(R), 9).max(1),
            (np.abs(tp - t) / tn).max(1)), 0.0)
        keep &= ((okp == ok) & (moved < gain * rel)).reshape(
            len(su), k).all(1)
    return keep


@pytest.mark.parametrize("solver", ["p3p", "dlt", "homography"])
def test_minimal_solvers_match_jax(solver):
    fns = {"p3p": (jpnp._p3p_batch_jnp, tpnp._p3p_batch),
           "dlt": (jpnp._dlt_batch_jnp, tpnp._dlt_batch),
           "homography": (jpnp._homography_batch_jnp,
                          tpnp._homography_batch)}[solver]
    su, sx, R_true, t_true = _minimal_samples(
        5, B=400 if solver == "p3p" else 200, planar=solver == "homography")
    k = {"p3p": 4}.get(solver, 1)
    keep = _rounding_free(*fns, su, sx, k)
    assert keep.sum() > 40
    su, sx, R_true = su[keep], sx[keep], R_true[keep]
    Rj, tj, okj = [np.asarray(a) for a in _jit(fns[0])(jnp.asarray(su),
                                                        jnp.asarray(sx))]
    Rt, tt, okt = [a.numpy() for a in fns[1](torch.as_tensor(su),
                                             torch.as_tensor(sx))]
    np.testing.assert_array_equal(okt, okj)
    both = okt & okj
    assert both.sum() >= len(su)
    np.testing.assert_allclose(Rt[both], Rj[both], atol=1e-4)
    scale = np.maximum(np.abs(tj[both]).max(1, keepdims=True), 1.0)
    np.testing.assert_allclose(tt[both] / scale, tj[both] / scale, atol=1e-4)
    # and the true pose is among the solutions of every sample
    err = np.abs(Rt.reshape(len(su), k, 9)
                 - R_true.reshape(len(su), 1, 9)).max(-1)
    assert (np.where(okt.reshape(len(su), k), err, 9).min(1) < 1e-3).all()


def test_quartic_matches_jax():
    rng = np.random.default_rng(2)
    B = 64
    # real roots, well apart, and pairs of complex roots
    r = np.sort(rng.uniform(-3, 3, (B, 4)), 1) + np.arange(4) * 0.5
    coef = np.stack([np.poly(x) for x in r]) * rng.uniform(0.5, 2, (B, 1))
    cplx = np.stack([np.poly([x, x + 1.0, 0.5 + 1j, 0.5 - 1j]).real
                     for x in rng.uniform(-2, 2, 16)])
    c = np.concatenate([coef, cplx]).astype(np.float32).T
    rj = np.asarray(_jit(jpnp._solve_quartic_real)(*map(jnp.asarray, c)))
    rt = tpnp._solve_quartic_real(*map(torch.as_tensor, c)).numpy()
    np.testing.assert_array_equal(np.isnan(rt), np.isnan(rj))
    ok = ~np.isnan(rj)
    np.testing.assert_allclose(rt[ok], rj[ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.sort(rt[:B], 1), r, atol=1e-3)


def test_smallest_evec_and_so3_match_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 16, 12)).astype(np.float32)
    G = np.einsum("bri,brj->bij", A, A)
    xj = np.asarray(_jit(jpnp._smallest_evec)(jnp.asarray(G)))
    xt = tpnp._smallest_evec(torch.as_tensor(G)).numpy()
    np.testing.assert_allclose(np.abs((xj * xt).sum(1)), 1.0, atol=1e-5)
    M = np.stack([_rotmat(rng.normal(0, 1, 3)) * rng.uniform(0.5, 3)
                  + rng.normal(0, 0.05, (3, 3)) for _ in range(40)])
    M[::2] *= -1                                    # det < 0 half the time
    M = M.astype(np.float32)
    Pj = np.asarray(_jit(jpnp._project_so3)(jnp.asarray(M)))
    Pt = tpnp._project_so3(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(Pt, Pj, atol=1e-5)
    np.testing.assert_allclose(Pt @ Pt.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), Pt.shape),
                               atol=1e-5)


def test_dlt_sign_takes_the_even_count_median():
    """Six points, three of them behind the camera: the depths' median is
    the mean of the middle two (positive), their lower middle is negative,
    so the sign test of ``torch.median`` would flip the translation."""
    R = _rotmat([0.1, -0.2, 0.05])
    t = np.array([0.3, -0.2, 0.4])
    xc = np.array([[0.4, 0.1, -3.0], [-0.3, 0.5, -2.0], [0.2, -0.6, -1.0],
                   [0.7, 0.3, 2.0], [-0.8, -0.2, 5.0], [0.1, 0.9, 6.0]])
    X = (xc - t) @ R
    su = (xc[:, :2] / xc[:, 2:])[None].astype(np.float32)
    sx = X[None].astype(np.float32)
    Rj, tj, _ = _jit(jpnp._dlt_batch_jnp)(jnp.asarray(su), jnp.asarray(sx))
    Rt, tt, okt = tpnp._dlt_batch(torch.as_tensor(su), torch.as_tensor(sx))
    assert bool(okt[0])
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj)[0], atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), t, atol=1e-4)
    np.testing.assert_allclose(Rt[0].numpy(), R, atol=1e-4)


# ---------------------------------------------------------------------------
# the host oracle and the device program
# ---------------------------------------------------------------------------

def _project_all(rec, im):
    cam = rec.cameras[im.camera_id]
    pts, xy = [], []
    for pid, p in rec.points3D.items():
        x_cam = im.world_to_camera(p.xyz)[0]
        if x_cam[2] <= 0.1:
            continue
        pts.append(pid)
        xy.append(cam.img_from_cam(x_cam[:2] / x_cam[2]))
    return np.stack([rec.points3D[p].xyz for p in pts]), np.asarray(xy)


def _scene_queries():
    """The scenes of ``tests/test_localization.py::TestPnP`` as (name,
    points2D, points3D, model, params, max_error_px)."""
    out = []
    rec = j_synth(n_images=3, n_points=80, noise_px=0.0, seed=11)
    im = rec.images[1]
    cam = rec.cameras[im.camera_id]
    X, xy = _project_all(rec, im)
    out.append(("recovers_pose", xy, X, cam.model, cam.params, 4.0))

    rng = np.random.default_rng(77)
    n = 120
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    np.zeros(n)], axis=1)
    pts = pts @ _rotmat([0.3, 0.1, 0.0]).T + [0, 0, 6.0]
    params = [900.0, 512.0, 384.0]
    jcam = JCamera(1, "SIMPLE_PINHOLE", 1024, 768, params)
    xy, _ = jpnp.project_np(jcam, jpnp._rotmat_to_quat_np(
        _rotmat([0.05, -0.04, 0.03])), np.array([0.2, -0.1, 0.3]), pts)
    xy = xy + rng.normal(0, 0.8, xy.shape)
    out.append(("planar", xy, pts, "SIMPLE_PINHOLE", params, 6.0))

    rec = j_synth(n_images=3, n_points=100, noise_px=0.2, seed=12,
                  model="PINHOLE")
    im = rec.images[2]
    cam = rec.cameras[im.camera_id]
    X, xy = _project_all(rec, im)
    xy = xy.copy()
    n_out = len(xy) // 4
    xy[:n_out] += np.random.default_rng(0).uniform(50, 200, (n_out, 2))
    out.append(("outliers", xy, X, cam.model, cam.params, 6.0))
    return out


def _assert_pose_parity(ot, oj, X, polish: bool):
    """Translations relative to the scene's scale seen from the camera,
    ``max(|t|, median distance of the points)``.

    Unpolished, the pose is the first of the hypotheses with the largest
    consensus (an LO round replaces it only on a strictly larger count):
    when several tie, float32 rounding of P3P's near-double roots (valid in
    one package and not in the other on ~1 % of samples) can change which
    one comes first, and two minimal-sample poses differ by the keypoint
    noise (1.6e-3 rad measured at 0.2 px). The polish then takes both to the
    same optimum."""
    assert ot["success"] == oj["success"]
    if not oj["success"]:
        return
    assert abs(ot["num_inliers"] - oj["num_inliers"]) <= 1
    tol = 1e-6 if polish else 1e-2
    assert _rot_angle(ot["qvec"], oj["qvec"]) <= tol
    C = -jpnp._quat_to_rotmat_np(oj["qvec"]).T @ oj["tvec"]
    scale = max(np.linalg.norm(oj["tvec"]),
                float(np.median(np.linalg.norm(np.asarray(X) - C, axis=1))))
    assert np.linalg.norm(ot["tvec"] - oj["tvec"]) <= tol * scale


def test_host_oracle_matches_jax(monkeypatch):
    """The rays are JAX's float32 undistortion on both sides: its last bits
    differ between XLA and torch on distorted models, and the LO polish
    stops within its own tolerance (~1e-8) of where it starts. The rest is
    float64 numpy, the same arithmetic in both packages."""
    monkeypatch.setattr(tpnp, "_cam_from_img32",
                        lambda cam, xy: _jcam(cam).cam_from_img(xy))
    for name, xy, X, model, params, max_err in _scene_queries():
        jcam, tcam = _cams(model, params)
        oj = jpnp._absolute_pose_estimation_host(xy, X, jcam,
                                                 max_error_px=max_err)
        ot = tpnp._absolute_pose_estimation_host(xy, X, tcam,
                                                 max_error_px=max_err)
        assert ot["success"] and oj["success"], name
        np.testing.assert_array_equal(ot["inliers"], oj["inliers"])
        np.testing.assert_allclose(ot["qvec"], oj["qvec"], atol=1e-9)
        np.testing.assert_allclose(ot["tvec"], oj["tvec"], atol=1e-9)


@pytest.mark.parametrize("polish", [False, True])
def test_absolute_pose_estimation_matches_jax(polish):
    for name, xy, X, model, params, max_err in _scene_queries():
        jcam, tcam = _cams(model, params)
        oj = jpnp.absolute_pose_estimation(xy, X, jcam, max_error_px=max_err,
                                           polish=polish)
        ot = tpnp.absolute_pose_estimation(xy, X, tcam, max_error_px=max_err,
                                           polish=polish, device="cpu")
        assert ot["success"], name
        _assert_pose_parity(ot, oj, X, polish)


def test_batch_matches_jax():
    """Mixed sizes (two size buckets), a query of 4 points, and a query with
    70 % outliers that misses the stage-1 bar and runs the full program:
    each query as JAX's, and the samples drawn in the same order."""
    rec = j_synth(n_images=6, n_points=90, noise_px=0.2, seed=22)
    rng = np.random.default_rng(4)
    jq, tq = [], []
    for iid, im in list(rec.images.items())[:5]:
        cam = rec.cameras[im.camera_id]
        X, xy = _project_all(rec, im)
        keep = len(xy) - (iid % 3) * 30
        xy, X = xy[:keep].copy(), X[:keep]
        if iid == 4:
            n_out = int(0.7 * keep)
            xy[:n_out] += rng.uniform(40, 150, (n_out, 2))
        jcam, tcam = _cams(cam.model, cam.params)
        jq.append(dict(points2D=xy, points3D=X, camera=jcam))
        tq.append(dict(points2D=xy, points3D=X, camera=tcam))
    for q, cam in ((jq, jq[0]["camera"]), (tq, tq[0]["camera"])):
        q.insert(2, dict(points2D=np.zeros((4, 2)), points3D=np.zeros((4, 3)),
                         camera=cam))
    assert tpnp._stage_accept(0, 60, 0.0) is False
    for polish in (False, True):
        oj = jpnp.absolute_pose_estimation_batch(jq, max_error_px=6.0,
                                                 polish=polish)
        ot = tpnp.absolute_pose_estimation_batch(tq, max_error_px=6.0,
                                                 polish=polish, device="cpu")
        assert not ot[2]["success"] and not oj[2]["success"]
        for a, b, q in zip(ot, oj, tq):
            _assert_pose_parity(a, b, q["points3D"], polish)
        assert all(o["success"] for i, o in enumerate(ot) if i != 2)


def test_stage_two_runs_for_hard_queries(monkeypatch):
    """A query with 70 % outliers misses the stage-1 bar and runs the full
    program as well; its inliers alone pass at stage 1."""
    rec = j_synth(n_images=6, n_points=90, noise_px=0.2, seed=22)
    im = rec.images[4]
    cam = rec.cameras[im.camera_id]
    X, xy = _project_all(rec, im)
    xy = xy.copy()
    n_out = int(0.7 * len(xy))
    xy[:n_out] += np.random.default_rng(4).uniform(40, 150, (n_out, 2))
    _, tcam = _cams(cam.model, cam.params)
    core = tpnp._pnp_core
    calls = []

    def record(model, X_, xy_, valid, params, samples, max_err, **kw):
        calls.append((kw.get("families", "full"), samples.shape[1]))
        return core(model, X_, xy_, valid, params, samples, max_err, **kw)

    monkeypatch.setattr(tpnp, "_pnp_core", record)
    easy = tpnp.absolute_pose_estimation(xy[n_out:], X[n_out:], tcam,
                                         max_error_px=6.0, device="cpu")
    assert easy["success"] and calls == [("p3p", 256)]
    calls.clear()
    hard = tpnp.absolute_pose_estimation(xy, X, tcam, max_error_px=6.0,
                                         device="cpu")
    assert hard["success"] and calls == [("p3p", 256), ("full", 512)]
