"""Port parity: the incremental mapper (``sfm/two_view.py``,
``sfm/mapper.py``) and ``PixSfM.reconstruction`` against the JAX package on
the CPU, with the same numpy inputs on both sides.

- The two-view functions and the mapper's numpy helpers are copies: the same
  answers (atol 1e-10) on the same matches, outliers included.
- ``incremental_mapping`` on a ring of 6 views of 150 points with unknown
  SIMPLE_RADIAL intrinsics (0.3 px keypoint noise, blank PNGs for the image
  sizes): the same registered images and the same number of attempts,
  point counts within 2 %, and after a similarity alignment (the gauge is
  the first registered camera, which the float32 re-registration sweep
  re-seats, so the two maps differ by a similarity of its rounding's size)
  rotations within 0.05 degrees and camera centres within 1e-3 of the
  scene's extent; the focal lengths within 1e-4 relative.
- The ``reconstructor`` command of ``refine_hloc`` with ``--device cpu`` on
  a tiny rendered scene of two planes (``PixSfM.reconstruction`` against
  JAX is in ``tests/test_torch_reconstruction.py``).
"""

import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.base.graph import Graph as JGraph
from pixsfm_tpu.sfm import mapper as jmapper
from pixsfm_tpu.sfm import two_view as jtwo
from pixsfm_tpu.util.hloc import (write_image_pairs, write_keypoints_hloc,
                                  write_matches_hloc)
from pixsfm_tpu_torch.base.graph import Graph
from pixsfm_tpu_torch.sfm import mapper as tmapper
from pixsfm_tpu_torch.sfm import two_view as ttwo
from pixsfm_tpu_torch.sfm.model import Reconstruction


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: these tests run many small
    ops, and among the fast lane's parallel workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotmat_of(q):
    w, x, y, z = np.asarray(q) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _similarity(A, B):
    """(s, R, t) with B ~ s R A + t (Umeyama)."""
    ma, mb = A.mean(0), B.mean(0)
    U, S, Vt = np.linalg.svd((B - mb).T @ (A - ma) / len(A))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((A - ma) ** 2).sum(1).mean()
    return s, R, mb - s * R @ ma


def aligned_pose_errors(rec, ref):
    """Rotation errors (degrees) and camera-centre errors (fractions of the
    extent of ``ref``'s centres) of ``rec``'s registered images after the
    similarity that maps its centres onto ``ref``'s, and that similarity."""
    ids = sorted(i for i, im in ref.images.items() if im.registered)
    C = {}
    for name, r in (("rec", rec), ("ref", ref)):
        C[name] = np.stack([-_rotmat_of(r.images[i].qvec).T @ r.images[i].tvec
                            for i in ids])
    s, R, t = _similarity(C["rec"], C["ref"])
    ext = np.linalg.norm(C["ref"] - C["ref"].mean(0), axis=1).max()
    rot, cen = [], []
    for k, i in enumerate(ids):
        Ra = _rotmat_of(ref.images[i].qvec)
        Rb = _rotmat_of(rec.images[i].qvec) @ R.T
        rot.append(np.degrees(np.arccos(np.clip(
            (np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))
        cen.append(np.linalg.norm(s * R @ C["rec"][k] + t - C["ref"][k])
                   / ext)
    return np.asarray(rot), np.asarray(cen), (s, R, t, ext)


# ---------------------------------------------------------------------------
# two-view functions and numpy helpers: copies
# ---------------------------------------------------------------------------

def _two_views(seed=0, n=160, n_out=30, planar=False):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]
    if planar:
        X[:, 2] = 5.0 + 0.3 * X[:, 0]
    f, c = 800.0, np.array([320.0, 240.0])
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-0.8, 0.1, 0.05])
    x1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:]
    k1 = f * x1 + c + rng.normal(0, 0.3, x1.shape)
    k2 = f * x2 + c + rng.normal(0, 0.3, x2.shape)
    m = np.stack([np.arange(n)] * 2, 1)
    m[:n_out, 1] = rng.permutation(n_out) + n - n_out  # wrong partners
    return k1, k2, m, (x1, x2)


def test_two_view_functions_are_copies():
    k1, k2, m, _ = _two_views()
    np.testing.assert_array_equal(ttwo.verify_matches(k1, k2, m),
                                  jtwo.verify_matches(k1, k2, m))
    fj = jtwo.estimate_pair_focal(k1, k2, m, (320, 240), (320, 240))
    ft = ttwo.estimate_pair_focal(k1, k2, m, (320, 240), (320, 240))
    np.testing.assert_allclose(ft, fj, atol=1e-10)
    assert np.isfinite(ft[:2]).all() and ft[2] >= 100
    F = np.random.default_rng(1).normal(size=(3, 3))
    np.testing.assert_allclose(
        ttwo.estimate_focal_bougnoux(F, (320, 240), (300, 250)),
        jtwo.estimate_focal_bougnoux(F, (320, 240), (300, 250)), atol=1e-10)
    kps = {"a": k1, "b": k2}
    mt, st = ttwo.verify_all_pairs({("a", "b"): m}, kps,
                                   {("a", "b"): np.ones(len(m))})
    mj, sj = jtwo.verify_all_pairs({("a", "b"): m}, kps,
                                   {("a", "b"): np.ones(len(m))})
    np.testing.assert_array_equal(mt[("a", "b")], mj[("a", "b")])
    np.testing.assert_array_equal(st[("a", "b")], sj[("a", "b")])


@pytest.mark.parametrize("planar", [False, True])
def test_mapper_helpers_are_copies(planar):
    k1, k2, m, _ = _two_views(seed=3, planar=planar)
    uv1 = (k1 - [320.0, 240.0]) / 800.0
    uv2 = (k2[m[:, 1]] - [320.0, 240.0]) / 800.0
    h1 = np.hstack([uv1, np.ones((len(uv1), 1))])
    h2 = np.hstack([uv2, np.ones((len(uv2), 1))])
    Ej, Et = jmapper._fit_E(h1[:20], h2[:20]), tmapper._fit_E(h1[:20],
                                                               h2[:20])
    np.testing.assert_allclose(Et, Ej, atol=1e-10)
    np.testing.assert_allclose(tmapper._sampson(Et, h1, h2),
                               jmapper._sampson(Ej, h1, h2), atol=1e-10)
    name = ("_homography_pose_from_matches" if planar
            else "_essential_from_matches")
    sj = getattr(jmapper, name)(uv1, uv2, iters=200, seed=1)
    st = getattr(tmapper, name)(uv1, uv2, iters=200, seed=1)
    assert sj is not None and st is not None
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a, b, atol=1e-10)
    assert tmapper._count_front(uv1, uv2, sj[0], sj[1], sj[2]) == \
        jmapper._count_front(uv1, uv2, sj[0], sj[1], sj[2])
    assert tmapper._default_params("RADIAL", 640, 480) == \
        jmapper._default_params("RADIAL", 640, 480)


# ---------------------------------------------------------------------------
# incremental_mapping on a ring
# ---------------------------------------------------------------------------

def _ring(tmp_path, I=6, Np=150, seed=42, W=1024, H=768, f=1000.0, k=0.02,
          noise=0.3):
    """``tests/test_mapper_scale.py``'s ring at 6 views and 150 points:
    SIMPLE_RADIAL views of a point cloud, exhaustive matches (score 1),
    blank PNGs of the image size. Both packages' graphs."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (Np, 3))
    xyz[:, 2] *= 0.6
    names = [f"im{i:02d}.png" for i in range(I)]
    blank = PIL.Image.new("RGB", (W, H))
    keypoints, kp_of = {}, {}
    for i, a in enumerate(np.linspace(0, 2 * np.pi, I, endpoint=False)):
        c = np.array([3.5 * np.cos(a), 0.5 * np.sin(2 * a), 3.5 * np.sin(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        xc = (xyz - c) @ R.T
        uv = xc[:, :2] / xc[:, 2:]
        xy = f * uv * (1 + k * (uv ** 2).sum(1))[:, None] + [W / 2, H / 2]
        vis = (xc[:, 2] > 0.5) & (xy > 10).all(1) & (xy < [W - 10, H - 10]
                                                      ).all(1)
        idx = np.nonzero(vis)[0]
        keypoints[names[i]] = xy[idx] + rng.normal(0, noise, (len(idx), 2))
        kp_of[names[i]] = {int(p): j for j, p in enumerate(idx)}
        blank.save(tmp_path / names[i])
    graphs = (JGraph(), Graph())
    for a in range(I):
        for b in range(a + 1, I):
            na, nb = names[a], names[b]
            shared = sorted(set(kp_of[na]) & set(kp_of[nb]))
            if len(shared) < 30:
                continue
            m = np.asarray([[kp_of[na][p], kp_of[nb][p]] for p in shared])
            for g in graphs:
                g.register_matches(na, nb, m, np.ones(len(m)))
    return keypoints, graphs


def test_incremental_mapping_matches_jax(tmp_path):
    keypoints, (gj, gt) = _ring(tmp_path)
    rj = jmapper.incremental_mapping(gj, {k: v.copy() for k, v in
                                          keypoints.items()}, tmp_path)
    stats = {}
    rt = tmapper.incremental_mapping(gt, {k: v.copy() for k, v in
                                          keypoints.items()}, tmp_path,
                                     device="cpu", stats=stats)
    assert {i for i, im in rt.images.items() if im.registered} == \
        {i for i, im in rj.images.items() if im.registered}
    assert rt.num_reg_images == len(keypoints)
    assert abs(len(rt.points3D) - len(rj.points3D)) <= 0.02 * len(
        rj.points3D)
    rot, cen, _ = aligned_pose_errors(rt, rj)
    assert rot.max() < 0.05 and cen.max() < 1e-3, (rot, cen)
    for cid, cam in rj.cameras.items():
        np.testing.assert_allclose(rt.cameras[cid].params[0], cam.params[0],
                                   rtol=1e-4)
    assert stats["attempts"] >= 1 and stats["pnp_calls"] >= 6
    assert stats["registrations"] >= 4 and stats["ba_calls"] >= 4
    assert len(stats["init_pairs"]) == stats["attempts"]


# ---------------------------------------------------------------------------
# the reconstructor command
# ---------------------------------------------------------------------------

def _render_two_planes(R, t, f, W, H, freq, phase, mix):
    """A view of the surface z = -0.5 |x| (two planes meeting at x = 0),
    textured by world position."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(xs + 0.5 - W / 2) / f, (ys + 0.5 - H / 2) / f,
                      np.ones_like(xs)], -1)
    d = d_cam @ R                             # world directions, R^T d_cam
    C = -R.T @ t
    best = np.full((H, W), np.inf)
    P = np.zeros((H, W, 3))
    for sgn in (-1.0, 1.0):                   # planes z + 0.5 sgn x = 0
        n = np.array([0.5 * sgn, 0.0, 1.0])
        s = -(n @ C) / (d @ n)
        p = C + s[..., None] * d
        ok = (s > 0) & (sgn * p[..., 0] >= 0) & (s < best)
        best = np.where(ok, s, best)
        P = np.where(ok[..., None], p, P)
    img = 127.5 + np.sin(P @ freq.T + phase) @ mix
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_two_plane_scene(tmp_path, n_views=8, n_points=150, W=320, H=240,
                           seed=4):
    """Views of two textured planes from an arc of cameras, written as PNGs
    and hloc files (keypoints = true projections + N(0, 0.5 px), identity
    matches over every pair). Returns the true points and the paths."""
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    freq = rng.uniform(10.0, 30.0, (6, 3)) * rng.choice([-1, 1], (6, 3))
    phase = rng.uniform(0, 2 * np.pi, 6)
    mix = rng.normal(0, 25.0, (6, 3))
    x = rng.uniform(-0.5, 0.5, n_points)
    P3 = np.stack([x, rng.uniform(-0.35, 0.35, n_points), -0.5 * np.abs(x)],
                  1)
    names, keypoints = [], {}
    for v in range(n_views):
        ang = 0.8 * (v / (n_views - 1) - 0.5)
        eye = np.array([2.0 * np.sin(ang), -0.6, 2.0 * np.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        xa = np.cross([0.0, -1.0, 0.0], z)
        xa /= np.linalg.norm(xa)
        R = np.stack([xa, np.cross(z, xa), z])
        t = -R @ eye
        name = f"v{v}.png"
        PIL.Image.fromarray(_render_two_planes(R, t, f, W, H, freq, phase,
                                               mix)).save(tmp_path / name)
        xc = P3 @ R.T + t
        xy = f * xc[:, :2] / xc[:, 2:] + [W / 2, H / 2]
        assert (xy > 16).all() and (xy < [W - 16, H - 16]).all()
        keypoints[name] = xy + rng.normal(0, 0.5, xy.shape)
        names.append(name)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    ident = np.stack([np.arange(n_points)] * 2, 1)
    paths = (tmp_path / "pairs.txt", tmp_path / "feats.h5",
             tmp_path / "matches.h5")
    write_image_pairs(paths[0], pairs)
    write_keypoints_hloc(paths[1], {n: k - 0.5 for n, k in keypoints.items()})
    write_matches_hloc(paths[2], pairs, [ident] * len(pairs))
    return P3, paths


def test_reconstructor_cli_on_cpu(tmp_path):
    """The ``reconstructor`` command on the CPU registers every view and
    writes a finite model of every track (the port's own S2DNet weights)."""
    from pixsfm_tpu_torch.refine_hloc import main as hloc_main
    P3, (pairs, feats, matches) = _write_two_plane_scene(tmp_path, n_views=5,
                                                         n_points=80)
    hloc_main(["reconstructor", "--image_dir", str(tmp_path),
               "--features_path", str(feats), "--pairs_path", str(pairs),
               "--matches_path", str(matches), "--output_dir",
               str(tmp_path / "sfm"), "--device", "cpu",
               "mapping.BA.optimizer.solver.max_num_iterations=3"])
    rec = Reconstruction.read(tmp_path / "sfm")
    assert rec.num_reg_images == 5
    assert len(rec.points3D) >= 0.95 * len(P3)
    assert all(np.isfinite(p.xyz).all() for p in rec.points3D.values())
