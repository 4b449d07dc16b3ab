"""Port parity: query bundle adjustment beyond one BICUBIC node, and the
"full" reference mode, against the JAX package on the CPU.

The scene is ``tests/test_torch_localization.py``'s held-out
featuremetric scene (linear 8-channel descriptor fields, one query).

- The Newton system of ``_qba_autodiff_system_fn`` (``torch.func``
  forward mode over the gradient, the read's own derivatives) against
  ``jax.grad`` / ``jax.hessian`` of the JAX package's QBA cost
  (``tests/test_torch_qba.py``'s ``_jax_system``), at the start pose with
  focal length and distortion free: 2x2 node windows with NCC on a
  textured field (NCC over a linear field has no pose signal, JAX's own
  ``tests/test_localization.py:398-410``) and BILINEAR (forward-difference
  derivatives: the read's own first derivatives, differentiated once more
  as plain functions; BICUBICCHAIN takes the same route and is held to
  JAX's read in ``tests/test_torch_interp_modes.py``). Gradient and
  Hessian within 1e-4 of their largest entry (float32, two summation
  orders), NCC within 1e-3 (it divides the rounding by the window's
  spread).
- ``QueryBundleAdjuster.refine`` with 2x2 node windows (L2 on) against
  the JAX package's, 10 steps (the first ones are rejected, as in
  JAX): pose within 1e-5, the initial cost rtol 1e-4 and the final one
  rtol 1e-3 (after 10 steps the pose is still far from the optimum, where
  the cost's slope turns the <1e-5 pose difference into ~5e-4 of it).
- Patch-warp QBA (``_refine_patch_warp``, 10 steps) from the same
  perturbed pose
  with the same references (the port's, which carry ``node_offsets3D``;
  the JAX method reads them by attribute): pose within 1e-5, costs rtol
  1e-4.
- ``QueryLocalizer.localize`` with ``target_reference: full`` on
  ``featuremetric_scene(seed=31, n_images=5, n_points=50)``, as the JAX
  package's ``TestFullReferenceLocalize``: success, >= 90 % inliers, the
  translation within 0.05 of the truth, the QBA cost not raised;
  ``localize_batch`` of the same query (run serially, as in JAX) gives the
  same pose within 1e-6. With QKA on, "full" references raise, as they
  make the JAX package's QKA fail.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.bundle_adjustment import extract_references as j_refs
from pixsfm_tpu.features.featuremaps import FeatureView as JView
from pixsfm_tpu.localization import QueryBundleAdjuster as JQBA
from pixsfm_tpu.localization import QueryLocalizer as JQL
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.localization import QueryBundleAdjuster, QueryLocalizer
from pixsfm_tpu_torch.localization import main as tloc
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _port_fset, _to_port
from tests.test_torch_ka import smooth_field
from tests.test_torch_localization import _one_torch_thread  # noqa: F401
from tests.test_torch_localization import (_Manager, _port_camera,
                                           held_out_scene)
from tests.test_torch_qba import _jax_system, _perturbed

NODES4 = [[dx, dy] for dy in (-0.5, 0.5) for dx in (-0.5, 0.5)]


@pytest.fixture(scope="module")
def scene():
    return held_out_scene(seed=23, n_images=5, n_points=40, qids=[4])


@pytest.mark.parametrize("name,conf,tol", [
    ("nodes_ncc", dict(mode="BICUBIC", l2_normalize=False,
                       ncc_normalize=True, nodes=NODES4), 1e-3),
    ("bilinear", dict(mode="BILINEAR", l2_normalize=True), 1e-4)])
def test_autodiff_system_matches_jax(scene, name, conf, tol):
    q = scene["queries"][0]
    rng = np.random.default_rng(4)
    sel = list(range(len(q["p3D"])))
    interp = InterpolationConfig(**conf)
    D = {"nodes_ncc": 4 * 8, "bilinear": 8}[name]
    references = [rng.normal(size=D).astype(np.float32) for _ in sel]
    arrays = list(QueryBundleAdjuster({"interpolation": conf},
                                      device="cpu")._build_arrays(
        q["points3D"], q["tfmap"], references, sel, q["p2D"]))
    if name == "nodes_ncc":
        # a textured field in every patch: NCC needs spread in the window
        field = smooth_field(16 * arrays[0].shape[0], 16, 8, seed=3)
        arrays[0] = torch.from_numpy(field.reshape(-1, 16, 16, 8))
    q0, t0 = _perturbed(q["gt_qvec"], q["gt_tvec"], seed=0)
    cam = q["jcam"]
    cam_mask = np.zeros(len(cam.params), np.float32)
    cam_mask[[0, 3]] = 1.0                   # SIMPLE_RADIAL: f and k
    g_j, H_j, _ = _jax_system(
        cam.model, JInterp(**conf), JLoss("cauchy", [0.25]),
        jnp.asarray(cam_mask), [np.asarray(a) for a in arrays],
        jnp.asarray(q0, jnp.float32), jnp.asarray(t0, jnp.float32),
        jnp.asarray(cam.params, jnp.float32))

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype)[None]

    patches, rows, corner, scale, up, X, targets, tw = arrays
    system = tloc._qba_autodiff_system_fn(
        cam.model, interp, RobustLoss("cauchy", [0.25]),
        torch.as_tensor(cam_mask), patches, T(rows, torch.int64), T(corner),
        T(scale), T(up), T(X), T(targets), T(tw))
    _, g_t, H_t = system(T(q0), T(t0), T(cam.params))
    np.testing.assert_allclose(g_t[0].numpy(), g_j,
                               atol=tol * np.abs(g_j).max())
    np.testing.assert_allclose(H_t[0].numpy(), H_j,
                               atol=tol * np.abs(H_j).max())


def _node_refs(scene, interp):
    rec2, jfset = scene["jrec2"], scene["jfset"]
    view = JView.from_reconstruction(jfset, rec2, sorted(rec2.points3D))
    return j_refs(rec2, jfset, view, {"loss": {"name": "cauchy",
                                               "params": [0.25]},
                                      "iters": 20}, interp)


def test_refine_nodes_matches_jax(scene):
    q = scene["queries"][0]
    conf = dict(mode="BICUBIC", l2_normalize=True, nodes=NODES4)
    refs = _node_refs(scene, JInterp(**conf))
    references = [refs[p].descriptor for p in q["p3D"]]
    assert references[0].shape == (4 * 8,)
    q0, t0 = _perturbed(q["gt_qvec"], q["gt_tvec"], seed=0)
    qconf = {"interpolation": conf,
             "optimizer": {"solver": {"max_num_iterations": 10}}}
    oj = JQBA(qconf).refine(q0, t0, copy.deepcopy(q["jcam"]),
                            q["points3D"], q["jfmap"], references,
                            point2D_idxs=q["p2D"])
    ot = QueryBundleAdjuster(qconf, device="cpu").refine(
        q0, t0, _port_camera(q["jcam"]), q["points3D"], q["tfmap"],
        references, point2D_idxs=q["p2D"])
    _assert_pose_cost(ot, oj, rtol=1e-3)
    assert ot["final_cost"] < ot["initial_cost"]
    assert np.abs(ot["tvec"] - t0).max() > 1e-4


def _assert_pose_cost(ot, oj, rtol=1e-4):
    np.testing.assert_allclose(ot["qvec"], oj["qvec"], atol=1e-5)
    np.testing.assert_allclose(ot["tvec"], oj["tvec"], atol=1e-5)
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(ot[key], oj[key], rtol=rtol,
                                   atol=1e-6 * oj["initial_cost"])


def _full_scene():
    """The held-out query of the JAX package's ``TestFullReferenceLocalize``
    (``featuremetric_scene(seed=31, n_images=5, n_points=50)``, image 5)
    in the port's data model."""
    rec, jfset = featuremetric_scene(seed=31, n_images=5, n_points=50)
    query = rec.images[5]
    p2D = [i for i, pid in enumerate(query.point3D_ids) if pid >= 0]
    rec2 = rec.copy()
    for p in rec2.points3D.values():
        p.track = [(i, j) for (i, j) in p.track if i != 5]
    del rec2.images[5]
    rec2.points3D = {pid: p for pid, p in rec2.points3D.items()
                     if p.track_length >= 2}
    pairs = [(i, int(query.point3D_ids[i])) for i in p2D
             if int(query.point3D_ids[i]) in rec2.points3D]
    tfset = _port_fset(jfset, 8, 16)
    return dict(query=query, jcam=rec.cameras[query.camera_id],
                p2D=[a for a, _ in pairs], p3D=[b for _, b in pairs],
                rec2=rec2, trec2=_to_port(rec2), jfset=jfset, tfset=tfset)


FULL_CONF = {"interpolation": {"mode": "BICUBIC", "l2_normalize": False,
                               "nodes": NODES4},
             "target_reference": "full",
             "references": {"iters": 20, "keep_observations": True,
                            "compute_offsets3D": True},
             "QKA": {"apply": False},
             "QBA": {"apply": True,
                     "interpolation": {"mode": "BICUBIC",
                                       "l2_normalize": False,
                                       "nodes": NODES4},
                     "optimizer": {"solver": {"max_num_iterations": 10}}}}


def test_localize_full_mode():
    s = _full_scene()
    loc = QueryLocalizer(s["trec2"], conf=FULL_CONF,
                         dense_features=_Manager(s["tfset"]), device="cpu")
    cam = _port_camera(s["jcam"])
    fmap = s["tfset"].get_map(s["query"].name)
    out = loc.localize(s["query"].xys.copy(), s["p2D"], s["p3D"], cam,
                       query_fmaps=[fmap])
    assert out["success"]
    assert out["num_inliers"] >= 0.9 * len(s["p2D"])
    np.testing.assert_allclose(out["tvec"], s["query"].tvec, atol=0.05)
    assert out["QBA"]["final_cost"] <= out["QBA"]["initial_cost"]
    # the batch entry point runs "full" queries one by one
    (ob,) = loc.localize_batch([dict(
        keypoints=s["query"].xys.copy(), pnp_point2D_idxs=s["p2D"],
        pnp_points3D_id=s["p3D"], query_camera=cam, query_fmaps=[fmap])])
    np.testing.assert_allclose(ob["qvec"], out["qvec"], atol=1e-6)
    np.testing.assert_allclose(ob["tvec"], out["tvec"], atol=1e-6)

    # patch-warp QBA from a perturbed pose with the same references in
    # both packages
    refs = loc.references[0]
    references = [refs[p] for p in s["p3D"]]
    assert references[0].node_offsets3D.shape == (4, 3)
    q0, t0 = _perturbed(s["query"].qvec, s["query"].tvec, seed=1)
    interp = FULL_CONF["QBA"]["interpolation"]
    points3D = [s["rec2"].points3D[p].xyz for p in s["p3D"]]
    sel = list(range(len(s["p3D"])))
    oj = JQBA(FULL_CONF["QBA"])._refine_patch_warp(
        q0, t0, s["jcam"], points3D, s["jfset"].get_map(s["query"].name),
        references, sel, s["p2D"], JInterp(**interp),
        JLoss("cauchy", [0.25]), 10)
    ot = loc.qba._refine_patch_warp(
        q0, t0, cam, points3D, fmap, references, sel, s["p2D"],
        InterpolationConfig(**interp), RobustLoss("cauchy", [0.25]), 10)
    _assert_pose_cost(ot, oj)
    assert ot["final_cost"] < ot["initial_cost"]

    # QKA on "full" references: the JAX package's QKA fails on them too
    with pytest.raises(ValueError, match="QKA.apply"):
        QueryLocalizer(s["trec2"], conf=dict(FULL_CONF, QKA={"apply": True}),
                       dense_features=_Manager(s["tfset"]), device="cpu")
    jloc = JQL(s["rec2"], conf=dict(FULL_CONF, QKA={"apply": True}),
               references=[{p: refs[p] for p in s["p3D"]}])
    with pytest.raises(IndexError):          # its QKA's descriptor shape
        jloc.localize(s["query"].xys.copy(), s["p2D"], s["p3D"], s["jcam"],
                      query_fmaps=[s["jfset"].get_map(s["query"].name)])
