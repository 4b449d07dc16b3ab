"""Port parity: query bundle adjustment (QBA, ``localization/main.py``)
against the JAX package on the CPU, on the held-out featuremetric scene of
``tests/test_torch_localization.py`` (one query view, its pose perturbed by
~2e-3 rad and ~6e-3 scene units, reference descriptors from the JAX
package's ``extract_references``).

- The Newton system itself: the gradient and the exact Hessian of the QBA
  cost at the start pose, against ``jax.grad`` / ``jax.hessian`` of the JAX
  package's ``residual_cost`` (written out below from its own functions),
  with the intrinsics frozen and with focal length and distortion free,
  L2 on and off, and with ``check_bounds`` (the hinge term): gradient and
  Hessian within 1e-4 of the largest entry (float32 of two summation
  orders; the port builds the Hessian from analytic second derivatives,
  JAX by forward-over-reverse autodiff). The Gauss-Newton matrix J^T W J
  differs from it by far more than that, which the test checks too.
- ``QueryBundleAdjuster.refine`` after one step (the step of that system)
  and after 10 steps: pose within 1e-5, intrinsics within 1e-5 relative
  and 2e-6 absolute (the distortion's Hessian entries are ~1e-6 of the
  focal length's, so the float32 rounding of the system moves its step
  most: 4.8e-7 of a 4.8e-3 step here),
  initial and final cost within rtol 1e-4 (near the optimum each residual
  is ~1e-2 of its descriptor, so the float32 rounding of the descriptors,
  ~1e-7, is ~1e-5 of the cost) and 1e-6 of the initial cost (the scene is
  noise-free: 10 steps reach a cost at float32's floor, ~1e-9 of it).
- ``refine_batch`` over two queries of different correspondence counts
  (the port pads with weight-0 copies of a real row): each query as the JAX
  package's batch, the same limits.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.geometry import (exp_quat, quat_mul, quat_normalize)
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.interpolation import bounds_violation as j_bounds
from pixsfm_tpu.base.interpolation import interpolate_residual
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.base.projection import world_to_pixel
from pixsfm_tpu.localization import QueryBundleAdjuster as JQBA
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.localization import QueryBundleAdjuster
from pixsfm_tpu_torch.localization import main as tloc
from tests.test_torch_localization import _one_torch_thread  # noqa: F401
from tests.test_torch_localization import _port_camera, held_out_scene


def _perturbed(q, t, seed):
    rng = np.random.default_rng(seed)
    q0 = np.asarray(quat_normalize(quat_mul(
        exp_quat(jnp.asarray(rng.normal(0, 2e-3, 3))), jnp.asarray(q))))
    return q0, np.asarray(t) + rng.normal(0, 6e-3, 3)


@pytest.fixture(scope="module")
def scene():
    return held_out_scene(seed=23, n_images=5, n_points=40, qids=[4, 5])


def _qba_inputs(scene, qi, l2, check_bounds=False):
    """One query's (JAX arrays, port arrays, q0, t0, camera, references)."""
    q = scene["queries"][qi]
    refs = scene["refs_l2" if l2 else "refs"]
    references = [refs[p].descriptor for p in q["p3D"]]
    q0, t0 = _perturbed(q["gt_qvec"], q["gt_tvec"], seed=qi)
    interp = dict(mode="BICUBIC", l2_normalize=l2, check_bounds=check_bounds)
    sel = list(range(len(q["p3D"])))
    ja = JQBA({"interpolation": interp})._build_arrays(
        q["points3D"], q["jfmap"], references, sel, q["p2D"])
    ta = QueryBundleAdjuster({"interpolation": interp},
                             device="cpu")._build_arrays(
        q["points3D"], q["tfmap"], references, sel, q["p2D"])
    return ja, ta, q0, t0, q, references, interp


def _jax_system(model, interp, loss, cam_mask, arrays, q0, t0, c0):
    """``jax.grad`` / ``jax.hessian`` of the JAX package's QBA cost
    (``residual_cost`` of ``_qba_inner``, built from the same package
    functions) at D = 0, and the Gauss-Newton matrix sum_i rho'(s_i) J_i^T
    J_i of the same residuals."""
    patches, rows, corners, scales, ups, X, targets, tw = arrays
    patches = jnp.asarray(patches)
    data = tuple(jnp.asarray(a) for a in (rows, corners, scales, ups, X,
                                          targets))

    def residuals(d):
        q = quat_normalize(quat_mul(exp_quat(d[:3]), q0))
        t = t0 + d[3:6]
        c = c0 + d[6:] * cam_mask

        def per_corr(row, corner, scale, up, Xi, tgt):
            xy = world_to_pixel(model, c, q, t, Xi)
            pc = (xy * scale - 0.5 - corner) * up
            f = interpolate_residual(patches, row, pc[1], pc[0], interp)
            viol = j_bounds(pc[1], pc[0], patches.shape[1],
                            patches.shape[2])
            return f[None, :] - tgt, viol

        return jax.vmap(per_corr)(*data)

    def residual_cost(d):
        r, viol = residuals(d)
        s = jnp.sum(r * r, axis=-1)
        if interp.check_bounds:
            s = s + (viol * viol)[:, None]
        return 0.5 * jnp.sum(jnp.asarray(tw) * loss(s))

    @jax.jit
    def system(d):
        r, _ = residuals(d)
        J = jax.jacfwd(lambda d_: residuals(d_)[0])(d)     # [n, T, C, NP]
        w = jnp.asarray(tw) * loss.weight(jnp.sum(r * r, axis=-1))
        return (jax.grad(residual_cost)(d), jax.hessian(residual_cost)(d),
                jnp.einsum("ntca,nt,ntcb->ab", J, w, J))

    return tuple(np.asarray(a) for a in system(
        jnp.zeros(6 + len(c0), jnp.float32)))


@pytest.mark.parametrize("free,l2,check_bounds", [
    ("pose", True, False), ("intrinsics", True, False),
    ("intrinsics", False, True)])
def test_newton_system_matches_jax(scene, free, l2, check_bounds):
    ja, ta, q0, t0, q, _, interp = _qba_inputs(scene, 0, l2, check_bounds)
    cam = q["jcam"]
    k = len(cam.params)
    cam_mask = np.zeros(k, np.float32)
    if free == "intrinsics":
        cam_mask[[0, 3]] = 1.0               # SIMPLE_RADIAL: f and k
    g_j, H_j, H_gn = _jax_system(
        cam.model, JInterp.from_conf(interp), JLoss("cauchy", [0.25]),
        jnp.asarray(cam_mask), ja, jnp.asarray(q0, jnp.float32),
        jnp.asarray(t0, jnp.float32), jnp.asarray(cam.params, jnp.float32))

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype)[None]

    patches, rows, corner, scale, up, X, targets, tw = ta
    system = tloc._qba_system_fn(
        cam.model, InterpolationConfig.from_conf(interp),
        RobustLoss("cauchy", [0.25]), torch.as_tensor(cam_mask), patches,
        T(rows, torch.int64), T(corner), T(scale), T(up), T(X), T(targets),
        T(tw))
    _, g_t, H_t = system(T(q0), T(t0), T(cam.params))
    g_t, H_t = g_t[0].numpy(), H_t[0].numpy()
    scale_g = np.abs(g_j).max()
    scale_H = np.abs(H_j).max()
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * scale_g)
    np.testing.assert_allclose(H_t, H_j, atol=1e-4 * scale_H)

    # the exact Hessian, not Gauss-Newton: the Gauss-Newton matrix of the
    # same residuals is far from it
    assert np.abs(H_gn - H_j).max() > 10 * np.abs(H_t - H_j).max()


@pytest.mark.parametrize("iters,free", [(1, "intrinsics"), (10, "pose")])
def test_refine_matches_jax(scene, iters, free):
    _, _, q0, t0, q, references, interp = _qba_inputs(scene, 0, True)
    conf = {"interpolation": interp,
            "optimizer": {"solver": {"max_num_iterations": iters},
                          "refine_focal_length": free == "intrinsics",
                          "refine_extra_params": free == "intrinsics"}}
    jcam = copy.deepcopy(q["jcam"])
    tcam = _port_camera(q["jcam"])
    oj = JQBA(conf).refine(q0, t0, jcam, q["points3D"], q["jfmap"],
                           references, point2D_idxs=q["p2D"])
    ot = QueryBundleAdjuster(conf, device="cpu").refine(
        q0, t0, tcam, q["points3D"], q["tfmap"], references,
        point2D_idxs=q["p2D"])
    _assert_same(ot, oj)
    np.testing.assert_allclose(tcam.params, jcam.params, rtol=1e-5,
                               atol=2e-6)
    # the step moved the pose: a comparison of a real step
    assert np.abs(oj["tvec"] - t0).max() > 1e-4
    assert ot["final_cost"] < ot["initial_cost"]


def _assert_same(ot, oj):
    np.testing.assert_allclose(ot["qvec"], oj["qvec"], atol=1e-5)
    np.testing.assert_allclose(ot["tvec"], oj["tvec"], atol=1e-5)
    np.testing.assert_allclose(ot["camera_params"], oj["camera_params"],
                               rtol=1e-5, atol=2e-6)
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(ot[key], oj[key], rtol=1e-4,
                                   atol=1e-6 * oj["initial_cost"])


def test_refine_batch_matches_jax(scene):
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
            "optimizer": {"solver": {"max_num_iterations": 5}}}
    items_j, items_t = [], []
    for qi in (0, 1):
        _, _, q0, t0, q, references, _ = _qba_inputs(scene, qi, True)
        # the second query keeps only its first 3/4 of correspondences
        n = len(q["p3D"]) if qi == 0 else 3 * len(q["p3D"]) // 4
        inl = [i < n for i in range(len(q["p3D"]))]
        for items, cam, fmap in ((items_j, copy.deepcopy(q["jcam"]),
                                  q["jfmap"]),
                                 (items_t, _port_camera(q["jcam"]),
                                  q["tfmap"])):
            items.append(dict(qvec=q0, tvec=t0, camera=cam,
                              points3D=q["points3D"], query_fmap=fmap,
                              references=references, inliers=inl,
                              point2D_idxs=q["p2D"]))
    outs_j = JQBA(conf).refine_batch(items_j)
    outs_t = QueryBundleAdjuster(conf, device="cpu").refine_batch(items_t)
    # the two queries select different numbers of correspondences
    assert sum(items_t[0]["inliers"]) != sum(items_t[1]["inliers"])
    for ot, oj in zip(outs_t, outs_j):
        _assert_same(ot, oj)
