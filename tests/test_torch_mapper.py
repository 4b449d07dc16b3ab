"""Port parity: the incremental mapper (``sfm/two_view.py``,
``sfm/mapper.py``) and ``PixSfM.reconstruction`` against the JAX package on
the CPU, with the same numpy inputs on both sides.

- The two-view functions and the mapper's numpy helpers are copies: the same
  answers (atol 1e-10) on the same matches, outliers included.
- ``incremental_mapping`` and the ``reconstructor`` command:
  ``tests/test_torch_mapper_flow.py`` (this file keeps the helpers they
  share with ``tests/test_torch_reconstruction.py``).
"""

import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.sfm import mapper as jmapper
from pixsfm_tpu.sfm import two_view as jtwo
from pixsfm_tpu.util.hloc import (write_image_pairs, write_keypoints_hloc,
                                  write_matches_hloc)
from pixsfm_tpu_torch.sfm import mapper as tmapper
from pixsfm_tpu_torch.sfm import two_view as ttwo


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
# the two-plane scene of the reconstructor command
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


