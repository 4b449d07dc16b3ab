"""Port parity: triangulation with known poses, the COLMAP database IO and
the entry points that chain KA, triangulation and BA, against the JAX
package on the CPU with the same numpy inputs on both sides.

- ``triangulate_reconstruction`` on the synthetic scene of
  ``tests/test_sfm_io.py::test_triangulation_pipeline_synthetic``, with a
  distorted camera model, keypoints pushed off their tracks and matches to
  an image the reference model lacks: the same accepted tracks and
  observation sets, xyz atol 1e-4 (two float32 SVDs of the same
  constraints, in scene units of a few metres);
- ``util/{database,colmap}.py``: a database written by the JAX package's
  ``COLMAPDatabase`` reads back to identical arrays in both packages, and
  keypoints written by the port read back identically in the JAX package;
- ``PixSfM.refine_keypoints_from_db`` (the ``keypoint_adjuster`` command of
  ``refine_colmap``) and ``PixSfM.triangulation`` on hloc files, with the
  JAX S2DNet weights carried across by ``params_from_flax`` and float32
  feature storage: refined keypoints atol 1e-3 px (``run_ka``'s tolerance
  in ``tests/test_torch_ka.py``), triangulated points atol 1e-3, costs
  rtol 1e-4.
"""

import shutil

import numpy as np
import PIL.Image
import pytest
import torch

from pixsfm_tpu.base.graph import Graph as JGraph
from pixsfm_tpu.sfm.model import Reconstruction as JRec
from pixsfm_tpu.sfm.synthetic import synthetic_reconstruction as j_synth
from pixsfm_tpu.sfm.triangulation import \
    triangulate_reconstruction as j_triangulate
from pixsfm_tpu.util import colmap as jcolmap
from pixsfm_tpu.util.database import COLMAPDatabase as JDB
from pixsfm_tpu.util.hloc import (write_image_pairs, write_keypoints_hloc,
                                  write_matches_hloc)
from pixsfm_tpu_torch.base.cameras import Camera
from pixsfm_tpu_torch.base.geometry import rotmat_to_quat_np
from pixsfm_tpu_torch.base.graph import Graph
from pixsfm_tpu_torch.base.projection import project_np
from pixsfm_tpu_torch.refine_colmap import PixSfM as ColmapPixSfM
from pixsfm_tpu_torch.refine_colmap import main as colmap_main
from pixsfm_tpu_torch.sfm.model import Image, Reconstruction
from pixsfm_tpu_torch.sfm.synthetic import \
    synthetic_reconstruction as t_synth
from pixsfm_tpu_torch.sfm.triangulation import (triangulate_batch,
                                                triangulate_reconstruction)
from pixsfm_tpu_torch.util import colmap as tcolmap
from pixsfm_tpu_torch.util.database import COLMAPDatabase
from tests.test_torch_ka import _pipelines, _write_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: the flows here run many
    small ops (the mapper of the ``reconstructor`` command most of all), and
    among the fast lane's parallel workers more threads only contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# triangulation with known poses
# ---------------------------------------------------------------------------

def _tri_inputs(model):
    """Both packages' copies of one synthetic model (tracks chained into a
    match graph as in ``tests/test_sfm_io.py``), its keypoints with a few
    moved 25 px off their tracks, and matches to an image outside it."""
    kw = dict(n_images=4, n_points=50, noise_px=0.3, seed=8, model=model)
    jrec, trec = j_synth(**kw), t_synth(**kw)
    keypoints = {im.name: im.xys.copy() for im in jrec.images.values()}
    keypoints["image3.jpg"][:4] += 25.0
    keypoints["ghost.jpg"] = np.random.default_rng(1).uniform(0, 900,
                                                              (50, 2))
    graphs = (JGraph(), Graph())
    for p in jrec.points3D.values():
        for (i1, k1), (i2, k2) in zip(p.track[:-1], p.track[1:]):
            for g in graphs:
                g.register_matches(jrec.images[i1].name,
                                   jrec.images[i2].name, np.array([[k1, k2]]))
    for g in graphs:
        g.register_matches("image1.jpg", "ghost.jpg",
                           np.stack([np.arange(10)] * 2, 1))
    for rec in (jrec, trec):
        rec.points3D.clear()
    return (jrec, graphs[0]), (trec, graphs[1]), keypoints


@pytest.mark.parametrize("model", ["SIMPLE_RADIAL", "OPENCV"])
def test_triangulate_reconstruction_matches(model):
    (jrec, jg), (trec, tg), keypoints = _tri_inputs(model)
    want = j_triangulate(jrec, jg, keypoints, max_reproj_error=3.0)
    got = triangulate_reconstruction(trec, tg, keypoints,
                                     max_reproj_error=3.0, device="cpu")
    assert 40 <= len(got.points3D) < 50        # the moved keypoints drop
    assert got.points3D.keys() == want.points3D.keys()
    for pid, p in want.points3D.items():
        assert got.points3D[pid].track == p.track
        np.testing.assert_allclose(got.points3D[pid].xyz, p.xyz, atol=1e-4)
    for iid, im in want.images.items():
        np.testing.assert_array_equal(got.images[iid].point3D_ids,
                                      im.point3D_ids)
        np.testing.assert_array_equal(got.images[iid].xys, im.xys)


def test_triangulate_batch_matches():
    """The batched DLT against the JAX package's (which pads the track
    length to a power of two): a track with a missing view (zero rows), a
    one-view track (two rows: padded to four) and rays that meet at
    infinity (``|w| < 1e-12`` guard; both give a point ~1e12 away, which
    the angle test rejects)."""
    from pixsfm_tpu.sfm.triangulation import _triangulate_batch
    centers = np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0]])
    X = np.array([0.3, -0.2, 4.0])
    uv_par = np.array([0.1, -0.05])

    def rows(c, uv):
        P = np.hstack([np.eye(3), -c[:, None]])
        return np.stack([uv[0] * P[2] - P[0], uv[1] * P[2] - P[1]])
    proj = [(X - c)[:2] / (X - c)[2] for c in centers]
    A = np.zeros((3, 3, 2, 4))
    valid = np.zeros((3, 3), bool)
    for k in (0, 1):                                  # third view missing
        A[0, k], valid[0, k] = rows(centers[k], proj[k]), True
    A[1, 0], valid[1, 0] = rows(centers[0], proj[0]), True
    for k in range(3):                                # parallel rays
        A[2, k], valid[2, k] = rows(centers[k], uv_par), True
    want = _triangulate_batch(A, valid)
    got = triangulate_batch(torch.as_tensor(A.reshape(3, 6, 4),
                                            dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got[0], X, atol=1e-4)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert np.isfinite(got[1]).all() and np.isfinite(want[1]).all()
    for out in (got, want):
        assert np.linalg.norm(out[2]) > 1e6
    one = triangulate_batch(torch.as_tensor(A[1:2, 0], dtype=torch.float32))
    assert one.shape == (1, 3) and np.isfinite(one.numpy()).all()


# ---------------------------------------------------------------------------
# COLMAP database IO
# ---------------------------------------------------------------------------

def _write_db(path, keypoints, matches, descriptors=True):
    """A COLMAP database written by the JAX package: one camera, the
    images in ``keypoints`` order, SIFT-like 4-column keypoints, uint8
    descriptors, the matches of each pair stored under COLMAP's pair id
    (which flips pairs whose first image id is the larger)."""
    rng = np.random.default_rng(5)
    db = JDB.connect(path)
    db.create_tables()
    cam = db.add_camera(2, 160, 120, [150.0, 80.0, 60.0, 0.0])
    ids = {name: db.add_image(name, cam) for name in keypoints}
    for name, kps in keypoints.items():
        extra = rng.uniform(0, 1, (len(kps), 2))
        db.add_keypoints(ids[name], np.concatenate([kps, extra], 1))
        if descriptors:
            db.add_descriptors(ids[name], rng.integers(0, 255, (len(kps),
                                                                128)))
    for (a, b), m in matches.items():
        db.add_matches(ids[a], ids[b], m)
    db.commit()
    db.close()


def test_database_io_matches(tmp_path):
    rng = np.random.default_rng(2)
    keypoints = {n: rng.uniform(0, 160, (k, 2)).astype(np.float32)
                 for n, k in (("a.jpg", 30), ("b.jpg", 25), ("c.jpg", 40))}
    matches = {("a.jpg", "b.jpg"): rng.integers(0, 25, (12, 2)),
               ("c.jpg", "a.jpg"): rng.integers(0, 30, (9, 2)),
               ("b.jpg", "c.jpg"): rng.integers(0, 25, (7, 2))}
    db = tmp_path / "db.db"
    _write_db(db, keypoints, matches)
    assert (tcolmap.read_image_id_to_name_from_db(db)
            == jcolmap.read_image_id_to_name_from_db(db))
    kt, kj = (m.read_keypoints_from_db(db) for m in (tcolmap, jcolmap))
    assert kt.keys() == kj.keys() == keypoints.keys()
    for name in kj:
        np.testing.assert_array_equal(kt[name], kj[name])
        np.testing.assert_array_equal(kt[name], keypoints[name])
    (pt, mt, st), (pj, mj, sj) = (m.read_matches_from_db(db)
                                  for m in (tcolmap, jcolmap))
    assert pt == pj and len(pt) == 3
    for a, b in zip(mt + st, mj + sj):
        np.testing.assert_array_equal(a, b)
    moved = {n: k + 0.25 for n, k in kt.items()}
    tcolmap.write_keypoints_to_db(db, moved)
    back = jcolmap.read_keypoints_from_db(db)
    for name in moved:
        np.testing.assert_array_equal(back[name],
                                      moved[name].astype(np.float32))
    # a database the port writes from scratch reads back in the JAX package
    db2 = tmp_path / "db2.db"
    tdb = COLMAPDatabase.connect(db2)
    tdb.create_tables()
    cam = tdb.add_camera(1, 160, 120, [150.0, 150.0, 80.0, 60.0])
    i1, i2 = tdb.add_image("x.jpg", cam), tdb.add_image("y.jpg", cam)
    tdb.add_keypoints(i1, keypoints["a.jpg"])
    tdb.add_keypoints(i2, keypoints["b.jpg"])
    tdb.add_matches(i2, i1, matches[("a.jpg", "b.jpg")][:, ::-1])
    tdb.commit()
    tdb.close()
    pairs, m2, scores = jcolmap.read_matches_from_db(db2)
    assert pairs == [("x.jpg", "y.jpg")] and scores is None
    np.testing.assert_array_equal(m2[0], matches[("a.jpg", "b.jpg")])


def test_keypoint_adjuster_db_matches_jax(tmp_path):
    """``refine_keypoints_from_db`` against JAX's with the same weights
    (1e-3 px); the ``keypoint_adjuster`` command writes what the method
    does with the port's own weights (exact)."""
    keypoints, matches = _write_scene(tmp_path, np.random.default_rng(8))
    db = tmp_path / "db.db"
    _write_db(db, keypoints, matches)
    conf = {"dense_features": {"dtype": "float"}}
    jsfm, tsfm = _pipelines(conf)
    jsfm.refine_keypoints_from_db(tmp_path / "j.db", db, tmp_path)
    out_t = tsfm.refine_keypoints_from_db(tmp_path / "t.db", db, tmp_path)
    ref = jcolmap.read_keypoints_from_db(tmp_path / "j.db")
    got = tcolmap.read_keypoints_from_db(tmp_path / "t.db")
    moved = 0.0
    for name in keypoints:
        np.testing.assert_allclose(got[name], ref[name], atol=1e-3)
        moved = max(moved, np.abs(got[name] - keypoints[name]).max())
    assert moved > 0.1 and out_t["final_cost"][0] < out_t["initial_cost"][0]

    shutil.copy(db, tmp_path / "in_place.db")
    ColmapPixSfM(conf, device="cpu").refine_keypoints_from_db(
        tmp_path / "in_place.db", tmp_path / "in_place.db", tmp_path)
    colmap_main(["keypoint_adjuster", "--database_path", str(db),
                 "--output_path", str(tmp_path / "cli.db"), "--image_dir",
                 str(tmp_path), "--device", "cpu",
                 "dense_features.dtype=float"])
    a = tcolmap.read_keypoints_from_db(tmp_path / "cli.db")
    b = tcolmap.read_keypoints_from_db(tmp_path / "in_place.db")
    for name in keypoints:
        np.testing.assert_array_equal(a[name], b[name])


# ---------------------------------------------------------------------------
# PixSfM.triangulation on hloc files
# ---------------------------------------------------------------------------

def _look_at(eye, target):
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross([0.0, -1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _write_plane_scene(tmp_path, n_views=4, n_points=24, W=200, H=150,
                       seed=3):
    """Views of a textured plane (z = 0) from known poses, written as PNGs,
    hloc files (keypoints = true projections + N(0, 0.5 px), identity
    matches over every pair) and a COLMAP reference model of the poses."""
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    cam = Camera(1, "SIMPLE_RADIAL", W, H, [f, W / 2, H / 2, 0.0])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    freq = rng.uniform(2.0, 6.0, (6, 2)) * rng.choice([-1, 1], (6, 2))
    phase = rng.uniform(0, 2 * np.pi, 6)
    mix = rng.normal(0, 25.0, (6, 3))
    ref = Reconstruction()
    ref.add_camera(cam)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)
    poses, names = [], []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views
        eye = 2.0 * np.array([0.4 * np.cos(ang), 0.4 * np.sin(ang), 0.92])
        R = _look_at(eye, np.zeros(3))
        t = -R @ eye
        q = pix @ np.linalg.inv(K @ np.stack([R[:, 0], R[:, 1], t], 1)).T
        X = q[..., :2] / q[..., 2:]
        img = 127.5 + np.sin(2 * np.pi * X @ freq.T + phase) @ mix
        name = f"v{v}.png"
        PIL.Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            tmp_path / name)
        ref.add_image(Image(v + 1, name, 1, rotmat_to_quat_np(R), t))
        poses.append((R, t))
        names.append(name)
    P3 = np.concatenate([rng.uniform(-0.35, 0.35, (n_points, 2)),
                         np.zeros((n_points, 1))], 1)
    keypoints = {}
    for name, (R, t) in zip(names, poses):
        xy, _ = project_np(cam, rotmat_to_quat_np(R), t, P3)
        assert (xy > 16).all() and (xy < [W - 16, H - 16]).all()
        keypoints[name] = xy + rng.normal(0, 0.5, xy.shape)
    ref.write_binary(tmp_path / "ref")
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    ident = np.stack([np.arange(n_points)] * 2, 1)
    paths = (tmp_path / "pairs.txt", tmp_path / "feats.h5",
             tmp_path / "matches.h5")
    write_image_pairs(paths[0], pairs)
    write_keypoints_hloc(paths[1], {n: k - 0.5 for n, k in keypoints.items()})
    write_matches_hloc(paths[2], pairs, [ident] * len(pairs))
    return keypoints, P3, paths


def test_triangulation_hloc_matches_jax(tmp_path):
    """KA -> triangulation -> BA (``PixSfM.triangulation``) on hloc files
    against the JAX package's, with the default config (float32 features);
    the BA takes the dense step on both sides."""
    keypoints, P3, paths = _write_plane_scene(tmp_path)
    jsfm, tsfm = _pipelines({"dense_features": {"dtype": "float"}})
    jrec, jout = jsfm.triangulation(tmp_path / "out_j", tmp_path / "ref",
                                    tmp_path, *paths)
    trec, tout = tsfm.triangulation(tmp_path / "out_t", tmp_path / "ref",
                                    tmp_path, *paths)
    assert tout["BA"]["linear_solver"] == ["dense"]
    assert tout["triangulation"]["num_points3D"] == len(P3)
    assert trec.points3D.keys() == jrec.points3D.keys()
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].xys, im.xys, atol=1e-3)
    for pid, p in jrec.points3D.items():
        assert trec.points3D[pid].track == p.track
        np.testing.assert_allclose(trec.points3D[pid].xyz, p.xyz, atol=1e-3)
    for stage in ("KA", "BA"):
        for k in ("initial_cost", "final_cost"):
            np.testing.assert_allclose(tout[stage][k], jout[stage][k],
                                       rtol=1e-4)
        assert tout[stage]["final_cost"][0] < tout[stage]["initial_cost"][0]
    written = JRec.read(tmp_path / "out_t")
    assert written.points3D.keys() == trec.points3D.keys()
    # keypoint k of every view is point k of the plane
    err = np.mean([np.linalg.norm(p.xyz - P3[p.track[0][1]])
                   for p in trec.points3D.values()])
    assert err < 0.01


def test_triangulator_cli_on_cpu(tmp_path):
    """The ``triangulator`` command of ``refine_hloc`` on the CPU writes a
    refined model of every track (the port's own S2DNet weights); the
    ``reconstructor`` command, on the same files, runs the mapper and writes
    a model too."""
    from pixsfm_tpu_torch.refine_hloc import main as hloc_main
    keypoints, P3, (pairs, feats, matches) = _write_plane_scene(tmp_path)
    common = ["--image_dir", str(tmp_path), "--features_path", str(feats),
              "--pairs_path", str(pairs), "--matches_path", str(matches),
              "--device", "cpu"]
    hloc_main(["triangulator", "--reference_model_path",
               str(tmp_path / "ref"), "--output_dir", str(tmp_path / "out"),
               *common, "mapping.BA.optimizer.solver.max_num_iterations=3"])
    rec = Reconstruction.read(tmp_path / "out")
    assert len(rec.points3D) == len(P3)
    assert all(np.isfinite(p.xyz).all() and p.track_length == 4
               for p in rec.points3D.values())
    hloc_main(["reconstructor", "--output_dir", str(tmp_path / "sfm"),
               *common, "mapping.BA.optimizer.solver.max_num_iterations=3"])
    rec = Reconstruction.read(tmp_path / "sfm")
    assert rec.num_reg_images >= 2 and len(rec.points3D) > 0
    assert all(np.isfinite(p.xyz).all() for p in rec.points3D.values())
