"""Port parity: costmap extraction, the gradient-field interpolation modes,
the costmap residual and Jacobian and the ``low_memory`` preset against the
JAX package on the CPU, with the same numpy inputs on both sides.

Tolerances (each test's docstring repeats its own):

- ``_costmap_kernel`` / ``_costmap_kernel_upsampled`` from identical
  references: 1e-5 of the largest absolute value of JAX's cost patches
  (float32 sums over the channels in two orders);
- ``POLYGRADIENTFIELD`` / ``BICUBICGRADIENTFIELD``: value and d/dr, d/dc,
  d/drdc within 1e-5 of the largest absolute value of each output;
- the costmap residual and its Jacobian (``_build_costmap`` /
  ``_build_costmap_jac``, one and two camera models, with and without
  ``check_bounds``): 1e-5 of the largest absolute value;
- ``extract_costmaps`` end to end (references included): 1e-4 of the
  largest absolute value (the IRLS references agree to rtol 1e-4 in
  ``tests/test_torch_ba.py``), and identical maps, keypoint ids, corners,
  scales and upsampling factors;
- ``PixSfM("low_memory").triangulation`` against the JAX package's at the
  tolerances of ``tests/test_torch_sfm.py::test_triangulation_hloc_matches_jax``,
  except the costmap BA's final cost (rtol 1e-3; the test says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.geometry import apply_pose as j_apply_pose
from pixsfm_tpu.base.geometry import invert_pose as j_invert_pose
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.interpolation import interpolate_with_grad
from pixsfm_tpu.base.losses import make_loss as j_make_loss
from pixsfm_tpu.bundle_adjustment import costmaps as jcm
from pixsfm_tpu.bundle_adjustment import main as jba_main
from pixsfm_tpu.util.jit_cache import interp_static_key
from pixsfm_tpu_torch.base.interpolation import (InterpolationConfig,
                                                 check_window_config,
                                                 gradient_field_eval)
from pixsfm_tpu_torch.base.losses import make_loss
from pixsfm_tpu_torch.bundle_adjustment import costmaps as tcm
from pixsfm_tpu_torch.bundle_adjustment.main import (_RESIDUAL_BUILDERS,
                                                     _CostPatches)
from pixsfm_tpu_torch.features.featuremaps import PackedFeatures
from tests.test_feature_reference_ba import featuremetric_scene
from tests.test_torch_ba import _port_fset, _to_port

LOSSES = {"trivial": {"name": "trivial", "params": []},
          "cauchy": {"name": "cauchy", "params": [0.25]}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: among the fast lane's
    parallel workers, torch's default threads only contend for the cores
    (as in ``tests/test_torch_ba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled_close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the extraction kernels
# ---------------------------------------------------------------------------

def _patches(rng, n=6, ps=8, C=16):
    """Smooth random feature patches (a linear field plus noise, as a CNN
    map looks at this scale) and references near their centres."""
    yy, xx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    base = rng.normal(0, 1, (n, 1, 1, C))
    grad = rng.normal(0, 0.2, (n, 2, 1, 1, C))
    p = (base + grad[:, 0] * yy[None, :, :, None]
         + grad[:, 1] * xx[None, :, :, None]
         + rng.normal(0, 0.05, (n, ps, ps, C))).astype(np.float32)
    refs = (p[:, ps // 2, ps // 2] + rng.normal(0, 0.1, (n, C))) \
        .astype(np.float32)
    return p, refs


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_costmap_kernel_matches(loss, l2, cross):
    """``_costmap_kernel``: cost, dcost/dr, dcost/dc and (``cross``) the
    analytic d2cost/drdc, whose ``rho''`` is the loss's closed form in the
    port and a ``jax.jvp`` of the weight in JAX; 1e-5 of the largest
    absolute value."""
    p, refs = _patches(np.random.default_rng(1))
    want = jcm._costmap_kernel(jnp.asarray(p), jnp.asarray(refs),
                               j_make_loss(LOSSES[loss]), l2, cross)
    got = tcm._costmap_kernel(torch.from_numpy(p), torch.from_numpy(refs),
                              make_loss(LOSSES[loss]), l2, cross)
    assert got.shape == want.shape == p.shape[:3] + (4 if cross else 3,)
    for ch in range(got.shape[-1]):
        _scaled_close(got[..., ch].numpy(), want[..., ch])


@pytest.mark.parametrize("l2", [False, True])
def test_costmap_kernel_upsampled_matches(l2):
    """``_costmap_kernel_upsampled`` with up = 2 (the port reads the
    feature patches through K1's plain version here): 1e-5 of the largest
    absolute value; every other sample of the upsampled costmap is the
    unit-scale one (1e-5 of its largest value: both interpolate the
    feature patch at its pixels)."""
    p, refs = _patches(np.random.default_rng(2), n=3)
    loss = LOSSES["cauchy"]
    want = jcm._costmap_kernel_upsampled(jnp.asarray(p), jnp.asarray(refs),
                                         j_make_loss(loss), l2, 2)
    got = tcm._costmap_kernel_upsampled(torch.from_numpy(p),
                                        torch.from_numpy(refs),
                                        make_loss(loss), l2, 2)
    assert got.shape == want.shape == (3, 16, 16, 3)
    _scaled_close(got.numpy(), want)
    unit = tcm._costmap_kernel(torch.from_numpy(p), torch.from_numpy(refs),
                               make_loss(loss), l2, False)
    _scaled_close(got[:, ::2, ::2, 0].numpy(), unit[..., 0].numpy())


def test_costmap_patches_chunks(monkeypatch):
    """``costmap_patches`` in chunks of one observation gives the whole
    batch's cost patches exactly."""
    p, refs = _patches(np.random.default_rng(3), n=5)
    rows = torch.tensor([4, 0, 2, 2, 1])
    args = (torch.from_numpy(p), rows, torch.from_numpy(refs)[rows],
            make_loss(LOSSES["cauchy"]), True, True)
    whole = tcm.costmap_patches(*args)
    monkeypatch.setattr(tcm, "_CHUNK_BYTES", 1)
    chunked = tcm.costmap_patches(*args)
    assert torch.equal(whole, chunked) and whole.shape == (5, 8, 8, 4)


# ---------------------------------------------------------------------------
# the gradient-field interpolation modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["POLYGRADIENTFIELD",
                                  "BICUBICGRADIENTFIELD"])
def test_gradient_field_matches(mode):
    """Value, d/dr, d/dc and d/drdc against the JAX package's
    ``interpolate_with_grad(..., cross=True)``, one query at a time there,
    at interior points, on cell borders (integer rows or columns, the last
    row and column) and at clamped edges (outside the patch): 1e-5 of the
    largest absolute value of each output."""
    rng = np.random.default_rng(4)
    C = 4 if mode == "BICUBICGRADIENTFIELD" else 3
    H = W = 8
    patches = rng.normal(0, 1, (3, H, W, C)).astype(np.float32)
    interior = rng.uniform(0.1, 6.9, (12, 2))
    borders = np.array([[0, 3.5], [3, 2.25], [7, 4.5], [5.5, 7], [7, 7],
                        [2, 0], [4, 5]], np.float64)
    edges = np.array([[-1.5, 3.2], [3.3, -0.7], [8.4, 2.0], [1.0, 9.1],
                      [-2.0, -2.0], [7.6, 7.9]], np.float64)
    rc = np.concatenate([interior, borders, edges]).astype(np.float32)
    row = rng.integers(0, 3, len(rc))
    cfg = JInterp(mode=mode, l2_normalize=False)
    want = jax.vmap(lambda i, r, c: jnp.stack(interpolate_with_grad(
        jnp.asarray(patches)[i], r, c, cfg, cross=True)))(
        jnp.asarray(row), jnp.asarray(rc[:, 0]), jnp.asarray(rc[:, 1]))
    got = gradient_field_eval(torch.from_numpy(patches),
                              torch.from_numpy(row),
                              torch.from_numpy(rc[:, 0]),
                              torch.from_numpy(rc[:, 1]), mode)
    for k in range(4):
        assert got[k].shape == (len(rc), 1)
        _scaled_close(got[k].numpy(), np.asarray(want)[:, k])
    with pytest.raises(ValueError, match="cost patches"):
        check_window_config(InterpolationConfig(mode=mode))


# ---------------------------------------------------------------------------
# the costmap residual and Jacobian
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("models", [("SIMPLE_RADIAL",),
                                    ("SIMPLE_RADIAL", "RADIAL")],
                         ids=["one_model", "mixed"])
@pytest.mark.parametrize("check_bounds", [False, True])
@pytest.mark.parametrize("mode", ["POLYGRADIENTFIELD",
                                  "BICUBICGRADIENTFIELD"])
def test_costmap_residual_jac_matches(mode, check_bounds, models):
    """``_build_costmap`` / ``_build_costmap_jac`` against the JAX package's
    builders (vmapped over the observations) on cost patches placed in the
    image, reprojections inside and (``check_bounds``) outside their
    patches, one camera model and two (grouped per model in the port, a
    ``lax.switch`` in JAX): residual and Jacobian within 1e-5 of the
    largest absolute value."""
    rng = np.random.default_rng(5)
    n, B, H, W = 48, 5, 8, 8
    C = 4 if mode == "BICUBICGRADIENTFIELD" else 3
    k = 5 if len(models) > 1 else 4
    patches = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    corners = rng.integers(0, 600, (B, 2)).astype(np.float64)
    scales, ups = np.ones((B, 2)), np.ones(B, np.float32)
    row = rng.integers(0, B, n)
    mi = rng.integers(0, len(models), n)
    cam = np.tile(np.array([500, 320, 240, 0.01, 0.005][:k], np.float32),
                  (n, 1))
    q = rng.normal(0, 1, (n, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    t = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    pc = rng.uniform(-2.0 if check_bounds else 0.5,
                     H + 1.0 if check_bounds else H - 1.5, (n, 2))
    uv = (pc + 0.5 + corners[row] - [320.0, 240.0]) / 500.0
    Xc = np.concatenate([uv * 3.0, np.full((n, 1), 3.0)], 1)
    X = np.stack([np.asarray(j_apply_pose(*j_invert_pose(
        jnp.asarray(q[i]), jnp.asarray(t[i])),
        jnp.asarray(Xc[i], jnp.float32))) for i in range(n)]) \
        .astype(np.float32)

    key = interp_static_key(JInterp(mode=mode, l2_normalize=False,
                                    check_bounds=check_bounds))
    jmodel = models if len(models) > 1 else models[0]
    rfn = jba_main._RESIDUAL_BUILDERS["costmap"](jmodel, key)
    jfn = jba_main._RESIDUAL_JAC_BUILDERS["costmap"](jmodel, key)
    ctx = (jnp.asarray(patches), jnp.asarray(corners, jnp.float32),
           jnp.asarray(scales, jnp.float32), jnp.asarray(ups))
    sl = (jnp.asarray(row, jnp.int32),) + (
        (jnp.asarray(mi, jnp.int32),) if len(models) > 1 else ())

    def one(fn):
        return jax.vmap(lambda q_, t_, c_, X_, *s: fn(
            q_, t_, c_, X_, s if len(s) > 1 else s[0], ctx))(
            q, t, cam, X, *sl)

    jr, (jr2, jJ) = one(rfn), one(jfn)

    build, build_jac = _RESIDUAL_BUILDERS["costmap"]
    interp = InterpolationConfig(mode=mode, l2_normalize=False,
                                 check_bounds=check_bounds)
    tctx = _CostPatches(PackedFeatures(torch.from_numpy(patches), corners,
                                       scales, ups, {}), torch.device("cpu"))
    tsl = (torch.from_numpy(row),) + (
        (torch.from_numpy(mi),) if len(models) > 1 else ())
    targs = tuple(map(torch.from_numpy, (q, t, cam, X)))
    tmodel = models if len(models) > 1 else models[0]
    tr = build(tmodel, interp)(*targs, tsl, tctx)
    tr2, tJ = build_jac(tmodel, interp)(*targs, tsl, tctx)
    D = 2 if check_bounds else 1
    assert tr.shape == (n, D) and tJ.shape == (n, D, 9 + k)
    if check_bounds:
        assert (tr[:, 1] > 0).any() and (tr[:, 1] == 0).any()
    for got, want in ((tr, jr), (tr2, jr2), (tJ, jJ)):
        _scaled_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# extract_costmaps end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("l2", [False, True])
def test_extract_costmaps_matches(l2, cross):
    """``extract_costmaps`` on ``featuremetric_scene`` (references
    included): the same maps in the same order, each with the same keypoint
    ids, corners, scale and upsampling factor, the cost patches within 1e-4
    of the largest absolute value, and references for the same points (the
    scene is noise-free, so which observation of a track is the source is
    a tie that float32 rounding breaks)."""
    jrec, jfset = featuremetric_scene(seed=7, n_points=10)
    trec, tfset = _to_port(jrec), _port_fset(jfset, 8, 16)
    conf = {"loss": LOSSES["cauchy"], "compute_cross_derivative": cross}
    rconf = {"loss": LOSSES["cauchy"], "iters": 10}
    jset, jrefs = jcm.extract_costmaps(jrec, jfset, conf, rconf,
                                       JInterp(mode="BICUBIC",
                                               l2_normalize=l2))
    tset, trefs, timings = tcm.extract_costmaps(
        trec, tfset, conf, rconf,
        InterpolationConfig(mode="BICUBIC", l2_normalize=l2))
    assert set(timings) == {"references", "costmaps"}
    assert tset.channels == jset.channels == (4 if cross else 3)
    assert tset.patch_size == jset.patch_size
    assert list(tset.maps) == list(jset.maps)
    assert trefs.keys() == jrefs.keys()
    scale = max(np.abs(p.data).max() for m in jset.maps.values()
                for p in m.patches.values())
    for name, jmap in jset.maps.items():
        tmap = tset.maps[name]
        ids = list(jmap.patches)
        assert tmap.keypoint_ids() == ids
        assert tmap.patches.dtype == torch.float32
        np.testing.assert_array_equal(
            tmap.corners, np.stack([jmap.patches[i].corner for i in ids]))
        for i, pid in enumerate(ids):
            jp = jmap.patches[pid]
            np.testing.assert_array_equal(tmap.scale, jp.scale)
            assert tmap.upsampling_factor == jp.upsampling_factor
            np.testing.assert_allclose(tmap.patches[i].numpy(), jp.data,
                                       rtol=0, atol=1e-4 * scale)


def test_extract_costmaps_upsampled_matches():
    """The counterpart of ``tests/test_costmap_patchwarp_ba.py::
    test_costmap_upsampled``: with ``upsampling_factor`` 2 each map holds
    patches of twice the size with the factor recorded, they agree with
    JAX's within 1e-4 of the largest absolute value (references
    included), and their even samples are the unit-scale costmap (atol
    1e-3, the JAX test's)."""
    jrec, jfset = featuremetric_scene(seed=17, n_points=6)
    trec, tfset = _to_port(jrec), _port_fset(jfset, 8, 16)
    rconf = {"loss": LOSSES["cauchy"], "iters": 5}
    interp = InterpolationConfig(mode="BICUBIC", l2_normalize=False)
    up2 = {"loss": LOSSES["trivial"], "upsampling_factor": 2}
    jset, _ = jcm.extract_costmaps(jrec, jfset, up2, rconf,
                                   JInterp(mode="BICUBIC",
                                           l2_normalize=False))
    tset = tcm.extract_costmaps(trec, tfset, up2, rconf, interp)[0]
    unit = tcm.extract_costmaps(trec, tfset, {"loss": LOSSES["trivial"]},
                                rconf, interp)[0]
    assert list(tset.maps) == list(jset.maps) and tset.patch_size == 32
    scale = max(np.abs(p.data).max() for m in jset.maps.values()
                for p in m.patches.values())
    for name, jmap in jset.maps.items():
        tmap = tset.maps[name]
        assert tmap.patches.shape[1:] == (32, 32, 3)
        assert tmap.upsampling_factor == 2.0
        want = np.stack([p.data for p in jmap.patches.values()])
        np.testing.assert_allclose(tmap.patches.numpy(), want, rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(tmap.patches[:, ::2, ::2, 0].numpy(),
                                   unit.maps[name].patches[..., 0].numpy(),
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# the low_memory preset and the entry points
# ---------------------------------------------------------------------------

def test_low_memory_preset_builds():
    """``load_config("low_memory")`` loads the JAX package's values, and
    ``PixSfM("low_memory", device="cpu")`` builds topological_reference KA
    (1000 keypoints per problem, bound 2.0) and costmap BA (points only,
    JAX's ``costmaps`` defaults) on an extractor of 8 px patches; the
    patch_warp strategy builds its adjuster, and the device mesh (with its
    costmap_window layout) still raises."""
    from pixsfm_tpu.config import load_config as j_load_config
    from pixsfm_tpu_torch.bundle_adjustment import (BundleAdjuster,
                                                    CostMapBundleAdjuster,
                                                    PatchWarpBundleAdjuster)
    from pixsfm_tpu_torch.config import load_config
    from pixsfm_tpu_torch.keypoint_adjustment.main import \
        TopologicalReferenceKeypointAdjuster
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    from pixsfm_tpu.bundle_adjustment import CostMapBundleAdjuster as JCM
    conf = load_config("low_memory")
    assert conf.to_dict() == j_load_config("low_memory").to_dict()
    sfm = PixSfM("low_memory", device="cpu")
    ka, ba = sfm.keypoint_adjuster, sfm.bundle_adjuster
    assert isinstance(ka, TopologicalReferenceKeypointAdjuster)
    assert int(ka.conf.max_kps_per_problem) == 1000
    assert float(ka.conf.optimizer.bound) == 2.0
    assert isinstance(ba, CostMapBundleAdjuster)
    assert ba.conf.costmaps.to_dict() == {**JCM.default_conf["costmaps"],
                                          "num_threads": -1}
    assert not any(ba._optimizer_flags().values())
    assert int(sfm.extractor.conf.patch_size) == 8
    assert isinstance(BundleAdjuster.create({"strategy": "patch_warp"},
                                            device="cpu"),
                      PatchWarpBundleAdjuster)
    # the knob builds: without n_devices the CPU runs unsharded, with it
    # the costmap_window layout takes a mesh of CPU shards
    par = {"enabled": True}
    assert CostMapBundleAdjuster({"parallel": par},
                                 device="cpu")._parallel_mesh() is None
    mesh = CostMapBundleAdjuster({"parallel": dict(par, n_devices=2)},
                                 device="cpu")._parallel_mesh()
    assert mesh.size == 2 and {d.type for d in mesh.devices} == {"cpu"}


def test_use_cache_without_path_runs_and_a_path_raises(tmp_path):
    """``use_cache: true`` with no cache path is ignored, as the JAX
    package ignores it (``pixsfm_tpu/extract.py:42``): the preset's
    extractor cuts 8 px bf16 patches; a cache path raises and names the
    ROADMAP item that brings the H5 cache."""
    from pixsfm_tpu_torch.extract import features_from_image_list
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    ext = PixSfM("low_memory", device="cpu").extractor
    assert ext.conf.use_cache
    img = np.random.default_rng(0).integers(0, 255, (48, 64, 3),
                                            dtype=np.uint8)
    kps = {"a.png": np.array([[20.0, 20.0], [40.0, 30.0]])}
    fm = features_from_image_list(ext, ["a.png"], {"a.png": img}, kps)
    patches = fm.fset(0).get_map("a.png").patches
    assert patches.shape == (2, 8, 8, 128) and patches.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="Features, rest"):
        features_from_image_list(ext, ["a.png"], {"a.png": img}, kps,
                                 cache_path=tmp_path / "cache.h5")


def test_low_memory_triangulation_matches_jax(tmp_path):
    """``PixSfM("low_memory").triangulation`` (topological_reference KA ->
    triangulation -> points-only costmap BA) on hloc files against the JAX
    package's, float32 feature storage, the JAX S2DNet weights carried
    across: refined keypoints atol 1e-3 px, points atol 1e-3, KA costs and
    the BA's initial cost rtol 1e-4 (``tests/test_torch_sfm.py::
    test_triangulation_hloc_matches_jax``). The BA's final cost is held at
    rtol 1e-3: after the preset's 100 LM iterations with inner iterations
    the points agree within 8e-5, but costmap BA's near-singular steps
    (``tests/test_torch_ba.py::test_adjuster_refine_matches``) leave its
    flat final cost 6e-4 apart (1.5e-7 of 2.4e-4)."""
    from pixsfm_tpu.config import load_config as j_load_config
    from tests.test_torch_ka import _pipelines
    from tests.test_torch_sfm import _write_plane_scene
    keypoints, P3, paths = _write_plane_scene(tmp_path)
    conf = j_load_config("low_memory", extra={"dense_features": {
        "dtype": "float"}}).to_dict()
    jsfm, tsfm = _pipelines(conf)
    assert type(tsfm.bundle_adjuster).__name__ == "CostMapBundleAdjuster"
    jrec, jout = jsfm.triangulation(tmp_path / "out_j", tmp_path / "ref",
                                    tmp_path, *paths)
    trec, tout = tsfm.triangulation(tmp_path / "out_t", tmp_path / "ref",
                                    tmp_path, *paths)
    assert tout["triangulation"]["num_points3D"] == len(P3)
    assert trec.points3D.keys() == jrec.points3D.keys()
    for iid, im in jrec.images.items():
        np.testing.assert_allclose(trec.images[iid].xys, im.xys, atol=1e-3)
    for pid, p in jrec.points3D.items():
        assert trec.points3D[pid].track == p.track
        np.testing.assert_allclose(trec.points3D[pid].xyz, p.xyz, atol=1e-3)
    for stage, k, rtol in (("KA", "initial_cost", 1e-4),
                           ("KA", "final_cost", 1e-4),
                           ("BA", "initial_cost", 1e-4),
                           ("BA", "final_cost", 1e-3)):
        np.testing.assert_allclose(tout[stage][k], jout[stage][k], rtol=rtol)
    for stage in ("KA", "BA"):
        assert tout[stage]["final_cost"][0] < tout[stage]["initial_cost"][0]
