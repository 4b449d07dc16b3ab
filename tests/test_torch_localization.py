"""Port parity: query localization against the JAX package on the CPU.

The scenes are those of ``tests/test_localization.py`` at its small sizes:
``featuremetric_scene`` (linear descriptor fields anchored at each point's
true projection, 8 channels, float32 patches of 16 px) with images held out
as queries; :func:`held_out_scene` wraps one numpy scene into the JAX
package's and the port's data models. Tolerances:

- ``evaluate_descriptors``: 1e-5 (float32, L2 on and off);
  ``solve_target_problems`` over three chunks of problems with two
  weighted targets each: keypoints 1e-4 px, costs rtol 1e-5, the same
  iteration count; ``topological_reference`` KA on the smooth-field scene
  of ``tests/test_torch_ka.py``: keypoints 1e-4 px, costs rtol 1e-5.
- ``pose_refinement``: pose 1e-5, cost rtol 1e-4.
- ``QueryKeypointAdjuster.refine`` (plain and stacked correspondences) and
  ``refine_batch``: keypoints 1e-4 px, costs rtol 1e-5.
- Final costs also within 1e-6 of the initial cost: the scenes are
  noise-free, and the solvers reach float32's floor there.
- ``QueryLocalizer.localize`` (the fused QKA -> PnP path, and the stacked
  path that runs QKA then PnP) and ``localize_batch``, references
  ``nearest`` and ``robust_mean``: the same success and inlier counts,
  poses within 1e-4 (after the float64 polish and QBA), QBA costs rtol
  1e-4.
- ``build_query_correspondences``, ``covisibility_clusters``,
  ``write_poses_txt`` and the unique-inlier helpers: identical results.
- ``python -m pixsfm_tpu_torch.localize --device cpu`` on the two-plane hloc
  scene of ``tests/test_torch_mapper.py``: the query localizes within
  1e-2 of the scene's extent.
"""

import numpy as np
import pytest
import torch

from pixsfm_tpu import localize as jlocalize
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.bundle_adjustment import extract_references as j_refs
from pixsfm_tpu.features.featuremaps import FeatureMap as JFeatureMap
from pixsfm_tpu.features.featuremaps import FeatureSet as JFeatureSet
from pixsfm_tpu.features.featuremaps import FeatureView as JView
from pixsfm_tpu.keypoint_adjustment import KeypointAdjuster as JKA
from pixsfm_tpu.keypoint_adjustment import build_matching_graph
from pixsfm_tpu.keypoint_adjustment import solver as jsolver
from pixsfm_tpu.localization import QueryKeypointAdjuster as JQKA
from pixsfm_tpu.localization import QueryLocalizer as JQL
from pixsfm_tpu.localization import main as jloc
from pixsfm_tpu.localization import pnp as jpnp
from pixsfm_tpu.ops.lm import LMOptions as JLMOptions
from pixsfm_tpu_torch import localize as tlocalize
from pixsfm_tpu_torch.base.cameras import Camera
from pixsfm_tpu_torch.base.geometry import (quat_to_rotmat_np,
                                           rotmat_to_quat_np)
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.keypoint_adjustment import main as tmain
from pixsfm_tpu_torch.keypoint_adjustment import solver as tsolver
from pixsfm_tpu_torch.localization import QueryKeypointAdjuster, QueryLocalizer
from pixsfm_tpu_torch.localization import main as tloc
from pixsfm_tpu_torch.localization import pnp as tpnp
from pixsfm_tpu_torch.ops.lm import LMOptions
from pixsfm_tpu_torch.sfm.model import Image, Point3D, Reconstruction
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _port_fset, _to_port
from tests.test_torch_ka import _field_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: these tests run many small
    ops, and among the fast lane's parallel workers more threads only
    contend for the cores."""
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


def _port_camera(cam) -> Camera:
    return Camera(cam.camera_id, cam.model, cam.width, cam.height,
                  np.array(cam.params, np.float64))


def held_out_scene(seed, n_images, n_points, qids, kp_noise=1.0):
    """One numpy featuremetric scene in both packages, the images ``qids``
    held out as queries (their tracks removed from the model, points left
    with fewer than 2 views dropped). Per query: the true pose, camera,
    correspondences to the model, the keypoints moved by U(-kp_noise,
    kp_noise) px, and its featuremap in both packages. ``refs`` /
    ``refs_l2``: the JAX package's references of the model without / with
    L2 normalization."""
    rec, jfset = featuremetric_scene(seed=seed, n_images=n_images,
                                     n_points=n_points)
    rec2 = rec.copy()
    for p in rec2.points3D.values():
        p.track = [(i, j) for (i, j) in p.track if i not in qids]
    for qid in qids:
        del rec2.images[qid]
    rec2.points3D = {pid: p for pid, p in rec2.points3D.items()
                     if p.track_length >= 2}
    tfset = _port_fset(jfset, 8, 16)
    rng = np.random.default_rng(seed)
    queries = []
    for qid in qids:
        im = rec.images[qid]
        p2D = [i for i, pid in enumerate(im.point3D_ids)
               if pid >= 0 and pid in rec2.points3D]
        p3D = [int(im.point3D_ids[i]) for i in p2D]
        kps = im.xys.copy()
        kps[p2D] += rng.uniform(-kp_noise, kp_noise, (len(p2D), 2))
        queries.append(dict(
            name=im.name, jcam=rec.cameras[im.camera_id], p2D=p2D, p3D=p3D,
            points3D=[rec2.points3D[p].xyz for p in p3D], kps=kps,
            gt_qvec=im.qvec.copy(), gt_tvec=im.tvec.copy(),
            jfmap=jfset.get_map(im.name), tfmap=tfset.get_map(im.name)))
    out = dict(jrec=rec, jrec2=rec2, trec2=_to_port(rec2), jfset=jfset,
               tfset=tfset, queries=queries)
    view = JView.from_reconstruction(jfset, rec2, sorted(rec2.points3D))
    for key, l2 in (("refs", False), ("refs_l2", True)):
        out[key] = j_refs(rec2, jfset, view,
                          {"loss": {"name": "cauchy", "params": [0.25]},
                           "iters": 20, "keep_observations": True},
                          JInterp(mode="BICUBIC", l2_normalize=l2))
    return out


@pytest.fixture(scope="module")
def scene():
    return held_out_scene(seed=31, n_images=6, n_points=50, qids=[5, 6])


# ---------------------------------------------------------------------------
# the fixed-target solver and topological_reference KA
# ---------------------------------------------------------------------------

def _assert_costs(s_t, s_j):
    """Costs within rtol 1e-5; the final one also within 1e-6 of the
    initial one, the float32 floor that these noise-free scenes reach."""
    np.testing.assert_allclose(s_t["initial_cost"], s_j["initial_cost"],
                               rtol=1e-5)
    np.testing.assert_allclose(s_t["final_cost"], s_j["final_cost"],
                               rtol=1e-5,
                               atol=1e-6 * np.max(s_j["initial_cost"]))


@pytest.mark.parametrize("l2", [False, True])
def test_evaluate_descriptors_matches_jax(l2):
    rng = np.random.default_rng(3)
    patches = rng.normal(size=(6, 16, 16, 8)).astype(np.float32)
    rows = rng.integers(0, 6, 40)
    corners = rng.integers(0, 50, (6, 2)).astype(np.float32)
    scales = np.tile([0.5, 0.5], (6, 1)).astype(np.float32)
    ups = np.ones(6, np.float32)
    kps = (corners[rows] + 0.5 + rng.uniform(-1, 17, (40, 2))) \
        / scales[rows]
    args = (patches, rows, kps, corners[rows], scales[rows], ups[rows])
    want = jsolver.evaluate_descriptors(
        *args, JInterp(mode="BICUBIC", l2_normalize=l2), query_chunk=16)
    got = tsolver.evaluate_descriptors(
        *args, InterpolationConfig(mode="BICUBIC", l2_normalize=l2),
        query_chunk=16, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)


def _target_problems():
    """37 fixed-target problems on smooth-field patches: two targets each
    (the field at the true keypoint and at a point 0.3 px off, the second
    weighted 0.5, one problem's second target padding), keypoints 1.5 px
    off, bound boxes of 4 px."""
    keypoints, maps, _ = _field_scene(np.random.default_rng(9), n_kps=37)
    patches, corners = maps["a.jpg"]
    true_xy = keypoints["a.jpg"]
    P = len(true_xy)
    rows = np.arange(P, dtype=np.int32)
    corner = corners.astype(np.float32)
    scale = np.ones((P, 2), np.float32)
    ups = np.ones(P, np.float32)
    interp = JInterp(mode="BICUBIC", l2_normalize=True)
    t0 = jsolver.evaluate_descriptors(patches, rows, true_xy, corner, scale,
                                      ups, interp)
    t1 = jsolver.evaluate_descriptors(patches, rows, true_xy + 0.3, corner,
                                      scale, ups, interp)
    targets = np.stack([t0, t1], 1)
    tw = np.tile([1.0, 0.5], (P, 1)).astype(np.float32)
    tw[5, 1] = 0.0
    kp0 = true_xy + np.random.default_rng(1).uniform(-1.5, 1.5, (P, 2))
    lo = np.maximum((corner + 0.5) / scale, kp0 - 4.0)
    hi = np.minimum(lo + 16.0, kp0 + 4.0)
    return (kp0, rows, corner, scale, ups, targets, tw, lo, hi), patches


def test_solve_target_problems_matches_jax():
    args, patches = _target_problems()
    solver_conf = {"max_num_iterations": 30, "parameter_tolerance": 1e-5}
    free = np.ones(len(args[0]), bool)
    free[3] = False
    kp_j, s_j = jsolver.solve_target_problems(
        *args, patches, JInterp(), JLoss("cauchy", [0.25]),
        JLMOptions.from_solver_conf(solver_conf), chunk=16, free_mask=free)
    kp_t, s_t = tsolver.solve_target_problems(
        *args, patches, InterpolationConfig(), RobustLoss("cauchy", [0.25]),
        LMOptions.from_solver_conf(solver_conf), chunk=16, free_mask=free,
        device="cpu")
    np.testing.assert_allclose(kp_t, kp_j, atol=1e-4)
    np.testing.assert_array_equal(kp_t[3], args[0][3].astype(np.float32))
    _assert_costs(s_t, s_j)
    assert s_t["iterations"] == s_j["iterations"]
    assert s_t["final_cost"] < 0.1 * s_t["initial_cost"]


def test_topological_reference_ka_matches_jax():
    keypoints, maps, matches = _field_scene(np.random.default_rng(6))
    jset = JFeatureSet(channels=16, patch_size=16, dtype="float32")
    tset = tfm.FeatureSet(16, 16, "float32")
    for name, (patches, corners) in maps.items():
        ids = list(range(len(patches)))
        jset.emplace(name, JFeatureMap.from_arrays(patches, ids, corners,
                                                   np.ones(2)))
        tset.emplace(name, tfm.FeatureMap.from_arrays(patches, ids, corners,
                                                      np.ones(2)))
    conf = {"strategy": "topological_reference",
            "optimizer": {"solver": {"max_num_iterations": 30}}}
    kps_j = {k: v.copy() for k, v in keypoints.items()}
    kps_t = {k: v.copy() for k, v in keypoints.items()}
    ka_j = JKA.create(conf)
    ka_t = tmain.KeypointAdjuster.create(conf, device="cpu")
    assert type(ka_t).__name__ == type(ka_j).__name__ \
        == "TopologicalReferenceKeypointAdjuster"
    assert ka_t.conf.to_dict() == ka_j.conf.to_dict()
    out_j = ka_j.refine_multilevel(kps_j, _Manager(jset),
                                   build_matching_graph(matches))
    out_t = ka_t.refine_multilevel(kps_t, _Manager(tset),
                                   tmain.build_matching_graph(matches))
    for name in keypoints:
        np.testing.assert_allclose(kps_t[name], kps_j[name], atol=1e-4)
    _assert_costs(out_t, out_j)
    assert out_t["num_problems"] == out_j["num_problems"]
    moved = max(np.abs(kps_t[n] - keypoints[n]).max() for n in keypoints)
    assert moved > 0.1


# ---------------------------------------------------------------------------
# PnP refinement, QKA
# ---------------------------------------------------------------------------

def test_pose_refinement_matches_jax(scene):
    q = scene["queries"][0]
    X = np.asarray(q["points3D"])
    xy = q["kps"][q["p2D"]]
    rng = np.random.default_rng(2)
    qv = q["gt_qvec"] + rng.normal(0, 2e-3, 4)
    tv = q["gt_tvec"] + rng.normal(0, 2e-2, 3)
    want = jpnp.pose_refinement(q["jcam"], qv, tv, X, xy, iters=15)
    got = tpnp.pose_refinement(_port_camera(q["jcam"]), qv, tv, X, xy,
                               iters=15, device="cpu")
    np.testing.assert_allclose(got["qvec"], want["qvec"], atol=1e-5)
    np.testing.assert_allclose(got["tvec"], want["tvec"], atol=1e-5)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    assert np.abs(got["tvec"] - q["gt_tvec"]).max() < 1e-2


def _qka_case(scene, qi, stacked):
    """A query's QKA inputs, its robust-mean references; with ``stacked``,
    every third correspondence's keypoint matched a second time, to a
    target near the first (a second 3D point of similar appearance: two
    targets, one keypoint)."""
    q = scene["queries"][qi]
    refs = [scene["refs"][p].descriptor for p in q["p3D"]]
    p2D = list(q["p2D"])
    kps = q["kps"][p2D].copy()
    if stacked:
        extra = list(range(0, len(p2D) - 1, 3))
        rng = np.random.default_rng(qi)
        p2D = p2D + [p2D[i] for i in extra]
        refs = refs + [(refs[i] + rng.normal(0, 0.05, refs[i].shape))
                       .astype(np.float32) for i in extra]
        kps = np.concatenate([kps, kps[extra]])
    return kps, refs, p2D


@pytest.mark.parametrize("stacked", [False, True])
def test_qka_refine_matches_jax(scene, stacked):
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": False},
            "stack_correspondences": stacked,
            "optimizer": {"solver": {"max_num_iterations": 20}}}
    kps, refs, p2D = _qka_case(scene, 0, stacked)
    q = scene["queries"][0]
    kp_j, kp_t = kps.copy(), kps.copy()
    s_j = JQKA(conf).refine(kp_j, q["jfmap"], refs, p2D)
    s_t = QueryKeypointAdjuster(conf, device="cpu").refine(
        kp_t, q["tfmap"], refs, p2D)
    np.testing.assert_allclose(kp_t, kp_j, atol=1e-4)
    _assert_costs(s_t, s_j)
    assert s_t["final_cost"] < s_t["initial_cost"]
    if stacked:       # a keypoint matched twice moves as one
        np.testing.assert_array_equal(
            kp_t[len(q["p2D"]):], kp_t[:len(q["p2D"]) - 1:3])


def test_qka_refine_batch_matches_jax(scene):
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": False},
            "optimizer": {"solver": {"max_num_iterations": 20}}}
    items_j, items_t = [], []
    for qi, stacked in ((0, False), (1, True)):
        kps, refs, p2D = _qka_case(scene, qi, stacked)
        q = scene["queries"][qi]
        items_j.append((kps.copy(), q["jfmap"], refs, p2D))
        items_t.append((kps.copy(), q["tfmap"], refs, p2D))
    s_j = JQKA(conf).refine_batch(items_j)
    s_t = QueryKeypointAdjuster(conf, device="cpu").refine_batch(items_t)
    for (kp_j, *_), (kp_t, *_) in zip(items_j, items_t):
        np.testing.assert_allclose(kp_t, kp_j, atol=1e-4)
    _assert_costs(s_t, s_j)


# ---------------------------------------------------------------------------
# QueryLocalizer
# ---------------------------------------------------------------------------

def _loc_conf(mode, stacked=False):
    return {"interpolation": {"mode": "BICUBIC", "l2_normalize": False},
            "target_reference": mode,
            "references": {"loss": {"name": "cauchy", "params": [0.25]},
                           "iters": 20, "keep_observations": True},
            "QKA": {"stack_correspondences": stacked,
                    "optimizer": {"solver": {"max_num_iterations": 10}}},
            "QBA": {"optimizer": {"solver": {"max_num_iterations": 4}}}}


def _assert_localized_alike(ot, oj, gt=None):
    assert ot["success"] and oj["success"]
    assert ot["num_inliers"] == oj["num_inliers"]
    assert ot["inliers"] == oj["inliers"]
    np.testing.assert_allclose(ot["qvec"], oj["qvec"], atol=1e-4)
    np.testing.assert_allclose(ot["tvec"], oj["tvec"], atol=1e-4)
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(ot["QBA"][key], oj["QBA"][key],
                                   rtol=1e-4)
    if gt is not None:
        np.testing.assert_allclose(ot["tvec"], gt, atol=0.05)


@pytest.mark.parametrize("mode,stacked", [("nearest", False),
                                          ("robust_mean", False),
                                          ("nearest", True)])
def test_localize_matches_jax(scene, mode, stacked):
    conf = _loc_conf(mode, stacked)
    jl = JQL(scene["jrec2"], conf=conf, dense_features=_Manager(
        scene["jfset"]))
    tl = QueryLocalizer(scene["trec2"], conf=conf, dense_features=_Manager(
        scene["tfset"]), device="cpu")
    q = scene["queries"][0]
    oj = jl.localize(q["kps"].copy(), q["p2D"], q["p3D"], q["jcam"],
                     query_fmaps=[q["jfmap"]])
    ot = tl.localize(q["kps"].copy(), q["p2D"], q["p3D"],
                     _port_camera(q["jcam"]), query_fmaps=[q["tfmap"]])
    _assert_localized_alike(ot, oj, q["gt_tvec"])


@pytest.mark.parametrize("mode", ["nearest", "robust_mean"])
def test_localize_batch_matches_jax(scene, mode):
    conf = _loc_conf(mode)
    jl = JQL(scene["jrec2"], conf=conf, dense_features=_Manager(
        scene["jfset"]))
    tl = QueryLocalizer(scene["trec2"], conf=conf, dense_features=_Manager(
        scene["tfset"]), device="cpu")
    batches = {}
    for pkg, loc in (("jax", jl), ("torch", tl)):
        batches[pkg] = loc.localize_batch([dict(
            keypoints=q["kps"].copy(), pnp_point2D_idxs=q["p2D"],
            pnp_points3D_id=q["p3D"],
            query_camera=(q["jcam"] if pkg == "jax"
                          else _port_camera(q["jcam"])),
            query_fmaps=[q["jfmap" if pkg == "jax" else "tfmap"]])
            for q in scene["queries"]])
    for ot, oj, q in zip(batches["torch"], batches["jax"], scene["queries"]):
        _assert_localized_alike(ot, oj, q["gt_tvec"])


def test_unported_modes_raise(scene):
    """What the localizer still refuses: "full" references fed to QKA
    (``ValueError``; the JAX package's QKA fails on them too,
    ``tests/test_torch_qba_options.py``). The "full" mode with QKA off, the
    other interpolation modes and the device mesh of ``parallel`` build."""
    mgr = _Manager(scene["tfset"])
    with pytest.raises(ValueError, match="QKA.apply"):
        QueryLocalizer(scene["trec2"], conf={"target_reference": "full"},
                       dense_features=mgr, device="cpu")
    loc = QueryLocalizer(scene["trec2"], conf={"parallel": {
        "enabled": True, "n_devices": 2}}, dense_features=mgr, device="cpu")
    assert loc._parallel_mesh().size == 2
    QueryLocalizer(scene["trec2"], conf={"target_reference": "full",
                                         "QKA": {"apply": False}},
                   dense_features=mgr, device="cpu")
    QueryLocalizer(scene["trec2"], conf={"interpolation": {
        "mode": "BILINEAR"}}, dense_features=mgr, device="cpu")


# ---------------------------------------------------------------------------
# localize.py
# ---------------------------------------------------------------------------

def _pairs_and_matches(rec, rec2, qids):
    """Retrieval pairs and matches: query keypoint -> the keypoint of the
    same 3D point in each model image (what hloc matching would give),
    some pairs stored in the other order."""
    pairs, matches = [], {}
    for qid in qids:
        query = rec.images[qid]
        for iid, im in rec2.images.items():
            m = [(q_idx, r_idx) for r_idx, pid in enumerate(im.point3D_ids)
                 if pid >= 0 and pid in rec2.points3D
                 for q_idx in np.nonzero(query.point3D_ids == pid)[0]]
            if not m:
                continue
            m = np.asarray(m, np.int64)
            if (iid + qid) % 2:
                pairs.append((query.name, im.name))
                matches[(query.name, im.name)] = m
            else:
                pairs.append((im.name, query.name))
                matches[(im.name, query.name)] = m[:, ::-1]
    return pairs, matches


def test_localize_helpers_match_jax(scene, tmp_path):
    pairs, matches = _pairs_and_matches(scene["jrec"], scene["jrec2"],
                                        [5, 6])
    for q in scene["queries"]:
        for fn in ("build_query_correspondences", "covisibility_clusters"):
            want = getattr(jlocalize, fn)(scene["jrec2"], q["name"], pairs,
                                          matches)
            got = getattr(tlocalize, fn)(scene["trec2"], q["name"], pairs,
                                         matches)
            assert got == want, fn
    rng = np.random.default_rng(0)
    results = {q["name"]: dict(success=bool(i), qvec=rng.normal(size=4),
                               tvec=rng.normal(size=3))
               for i, q in enumerate(scene["queries"] * 2)}
    jlocalize.write_poses_txt(tmp_path / "j.txt", results)
    tlocalize.write_poses_txt(tmp_path / "t.txt", results)
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()

    q = scene["queries"][0]
    X, xy = np.asarray(q["points3D"]), q["kps"][q["p2D"]]
    qv, tv = q["gt_qvec"], q["gt_tvec"] + [0.0, 0.0, 0.01]
    np.testing.assert_allclose(
        tloc.compute_reprojection_errors(xy, X, qv, tv,
                                         _port_camera(q["jcam"])),
        jloc.compute_reprojection_errors(xy, X, qv, tv, q["jcam"]),
        rtol=1e-12)
    ids = list(rng.integers(0, 10, len(xy)))
    pre = list(rng.random(len(xy)) < 0.8)
    assert tloc.find_unique_inliers(ids, pre) == \
        jloc.find_unique_inliers(ids, pre)
    assert tloc.find_unique_min_reproj_inliers(
        ids, qv, tv, _port_camera(q["jcam"]), xy, X, pre, q["p2D"]) == \
        jloc.find_unique_min_reproj_inliers(ids, qv, tv, q["jcam"], xy, X,
                                            pre, q["p2D"])


def test_localize_cli_on_cpu(tmp_path):
    """``python -m pixsfm_tpu_torch.localize --device cpu``: the two-plane
    scene's last view is the query, the first seven at their true poses
    form the model (the port's own S2DNet weights)."""
    from tests.test_torch_mapper import _write_two_plane_scene
    W, H, n_views = 320, 240, 8
    P3, (pairs_p, feats, matches_p) = _write_two_plane_scene(
        tmp_path, n_views=n_views, n_points=100)
    from pixsfm_tpu_torch.util.hloc import read_keypoints_hloc
    kps = {k: v + 0.5 for k, v in read_keypoints_hloc(feats).items()}
    f = 1.2 * W
    cam = Camera(1, "PINHOLE", W, H, [f, f, W / 2, H / 2])
    rec = Reconstruction()
    rec.add_camera(cam)
    poses = {}
    for v in range(n_views):        # the arc of _write_two_plane_scene
        ang = 0.8 * (v / (n_views - 1) - 0.5)
        eye = np.array([2.0 * np.sin(ang), -0.6, 2.0 * np.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        xa = np.cross([0.0, -1.0, 0.0], z)
        xa /= np.linalg.norm(xa)
        R = np.stack([xa, np.cross(z, xa), z])
        poses[f"v{v}.png"] = (rotmat_to_quat_np(R), -R @ eye)
    for v in range(n_views - 1):
        name = f"v{v}.png"
        rec.add_image(Image(v + 1, name, 1, *poses[name], kps[name],
                            np.arange(len(P3))))
    for p, xyz in enumerate(P3):
        rec.add_point3D(Point3D(p, xyz, track=[
            (v + 1, p) for v in range(n_views - 1)]))
    rec.write(tmp_path / "model")
    qname = f"v{n_views - 1}.png"
    (tmp_path / "queries.txt").write_text(
        f"{qname} PINHOLE {W} {H} {f} {f} {W / 2} {H / 2}\n")
    out = tmp_path / "poses.txt"
    results = tlocalize.main([
        "--reference_sfm", str(tmp_path / "model"), "--queries",
        str(tmp_path / "queries.txt"), "--features_path", str(feats),
        "--pairs_path", str(pairs_p), "--matches_path", str(matches_p),
        "--image_dir", str(tmp_path), "--output_path", str(out),
        "--device", "cpu", "references.iters=5",
        "QKA.optimizer.solver.max_num_iterations=5",
        "QBA.optimizer.solver.max_num_iterations=3"])
    res = results[qname]
    assert res["success"] and res["num_inliers"] >= 90
    name, *vals = out.read_text().split()
    assert name == qname
    q_true, t_true = poses[qname]
    C_true = -quat_to_rotmat_np(q_true).T @ t_true
    C_est = -quat_to_rotmat_np(np.asarray(vals[:4], float)).T \
        @ np.asarray(vals[4:], float)
    assert np.linalg.norm(C_est - C_true) < 1e-2 * np.ptp(P3, 0).max()
    assert (tmp_path / "poses.txt_logs.pkl").exists()


