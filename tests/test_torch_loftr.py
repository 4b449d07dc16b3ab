"""Port parity: LoFTR and the detector-free front end of
``pixsfm_tpu_torch`` against the JAX package on the CPU.

The JAX model's random weights (BatchNorm statistics randomized, so that a
wrong mapping cannot pass as the identity) are carried across with
``params_from_flax``; the images are those of ``tests/test_loftr.py``.
Tolerances:

- the position encoding equal, the align-corners upsampling within 1e-6;
- coarse tokens, fine maps and the fine head within 2e-4 of the largest
  value (the JAX test's limit: float32 convolutions summed in different
  orders);
- ``match_pair``: the valid matches equal as a set (keyed by their coarse
  cells), fine positions within 1e-3 px, confidences within 1e-4 of the
  pair's largest (the dual softmax at temperature 0.1 turns the tokens'
  ~1e-6 rounding into ~1e-4 of the smallest confidences);
- ``match_loftr_dir``: keypoint ids and matches equal, keypoints within
  1e-3 px, scores within 1e-4 relative;
- the grayscale loader equals OpenCV's ``imread`` + ``resize``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixsfm_tpu.features.models.loftr import LoFTR as JaxLoFTR
from pixsfm_tpu.features.models.loftr import load_torch_loftr
from pixsfm_tpu.features.models.loftr import \
    position_encoding_sine as jax_pe
from pixsfm_tpu.features.models.loftr import \
    upsample2x_align_corners as jax_upsample
from pixsfm_tpu_torch.features.models import loftr
from pixsfm_tpu_torch.features.models.base_model import read_checkpoint

CONF = {"pretrained": None, "max_matches": 64}


def _rel_err(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _randomize_bn(variables, seed=0):
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(variables))

    def walk(tree):
        if "mean" in tree:
            tree["mean"] = rng.normal(0, 0.2, tree["mean"].shape).astype(
                np.float32)
            tree["var"] = rng.uniform(0.5, 1.5, tree["var"].shape).astype(
                np.float32)
        else:
            for sub in tree.values():
                walk(sub)

    walk(variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def models():
    """(JAX LoFTR, port LoFTR with the JAX weights, the weights as numpy)."""
    jm = JaxLoFTR(dict(CONF))
    variables = _randomize_bn(jm.variables)
    jm.variables = flax.core.freeze(jax.tree.map(jnp.asarray, variables))
    tm = loftr.LoFTR(dict(CONF), device="cpu")
    tm.load_state_dict(loftr.params_from_flax(variables), strict=True)
    return jm, tm, variables


def _smooth(shape, seed, cells=(12, 14)):
    """A smooth random image in [0, 1] (bicubic upsampling of a coarse
    random grid, as ``tests/test_loftr.py`` makes its images)."""
    g = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, cells)[None, None])
    img = F.interpolate(g, size=shape, mode="bicubic", align_corners=False)
    return img[0, 0].clamp(0, 1).numpy().astype(np.float32)


@pytest.mark.parametrize("bug_fix", [False, True])
def test_position_encoding_matches_jax(bug_fix):
    np.testing.assert_array_equal(
        loftr.position_encoding_sine(256, 6, 9, temp_bug_fix=bug_fix),
        jax_pe(256, 6, 9, temp_bug_fix=bug_fix))


def test_upsample2x_matches_jax():
    x = np.random.default_rng(14).normal(0, 1, (2, 5, 7, 3)).astype(
        np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(x)))
    out = loftr.upsample2x_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_coarse_tokens_and_fine_maps_match_jax(models):
    jm, tm, _ = models
    rng = np.random.default_rng(15)
    img0, img1 = (rng.uniform(0, 1, (48, 64)).astype(np.float32)
                  for _ in range(2))
    ref = jm.module.apply(jm.variables, jnp.asarray(img0)[None, :, :, None],
                          jnp.asarray(img1)[None, :, :, None],
                          method=jm.module.coarse_features)
    out = tm.coarse_features(torch.from_numpy(img0)[None, None],
                             torch.from_numpy(img1)[None, None])
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        assert _rel_err(o.numpy(), np.asarray(r)) < 2e-4


def test_fine_head_matches_jax(models):
    jm, tm, _ = models
    rng = np.random.default_rng(16)
    win0, win1 = (rng.normal(0, 1, (6, 25, 128)).astype(np.float32)
                  for _ in range(2))
    cv0, cv1 = (rng.normal(0, 1, (6, 256)).astype(np.float32)
                for _ in range(2))
    ref = jm.module.apply(jm.variables, *map(jnp.asarray,
                                             (win0, win1, cv0, cv1)),
                          method=jm.module.fine_refine)
    out = tm.fine_refine(*map(torch.from_numpy, (win0, win1, cv0, cv1)))
    for o, r in zip(out, ref):
        assert _rel_err(o.numpy(), np.asarray(r)) < 2e-4


def _keyed(out):
    """Valid matches of ``match_pair`` keyed by their coarse cells (image
    0's cell, image 1's cell; the fine offset stays within +-4 px)."""
    mk0, mk1, conf, valid = out
    assert np.all(np.diff(conf) <= 0)            # valid first, by value
    assert valid.sum() == 0 or valid[:valid.sum()].all()
    return {(tuple((a / 8).astype(int)), tuple(np.rint(b / 8).astype(int))):
            (b, c) for a, b, c in zip(mk0[valid], mk1[valid], conf[valid])}


@pytest.mark.parametrize("pair", ["identical", "shifted"])
def test_match_pair_matches_jax(models, pair):
    jm, tm, _ = models
    big = _smooth((96, 112), seed=17)
    img0 = big[:80, :96]
    img1 = img0 if pair == "identical" else big[16:96, 16:112]
    for m in (jm, tm):
        m.conf["match_threshold"] = 0.0
    ref, out = _keyed(jm.match_pair(img0, img1)), \
        _keyed(tm.match_pair(img0, img1))
    # random weights match few cells of a shifted view (8 of 80 here)
    assert len(ref) >= (10 if pair == "identical" else 5)
    assert set(out) == set(ref)
    top = max(c for _, c in ref.values())
    for k, (b, c) in ref.items():
        np.testing.assert_allclose(out[k][0], b, rtol=0, atol=1e-3)
        np.testing.assert_allclose(out[k][1], c, rtol=0, atol=1e-4 * top)
    if pair == "identical":
        d = np.array([np.abs(b - np.array(k[0]) * 8).max()
                      for k, (b, _) in out.items()])
        assert np.median(d) < 1.0


def test_public_checkpoint_layout_loads_in_both_packages(tmp_path, models):
    """The port's state dict in the released files' wrapping loads into
    JAX through ``load_torch_loftr`` (equal outputs) and back into the
    port with ``strict=True``; the public module layout of
    ``tests/test_loftr.py`` loads into the port with ``strict=True`` and
    computes the same coarse tokens."""
    from tests.test_loftr import build_torch_loftr
    jm, tm, _ = models
    path = tmp_path / "outdoor_ds.ckpt"
    torch.save({"state_dict": {"matcher." + k: v
                               for k, v in tm.state_dict().items()}}, path)
    net = JaxLoFTR(dict(CONF))
    net.variables = load_torch_loftr(path, net.variables)
    img = np.random.default_rng(18).uniform(0, 1, (48, 64)).astype(
        np.float32)
    x = jnp.asarray(img)[None, :, :, None]
    ref = net.module.apply(net.variables, x, x,
                           method=net.module.coarse_features)
    t = torch.from_numpy(img)[None, None]
    out = tm.coarse_features(t, t)
    for o, r in zip(out, ref):
        assert _rel_err(o.numpy(), np.asarray(r)) < 2e-4
    back = loftr.LoFTR(dict(CONF), device="cpu", seed=1)
    back.load_state_dict(read_checkpoint(path, ("state_dict",),
                                         ("matcher.", "module.")),
                         strict=True)
    for o, r in zip(back.coarse_features(t, t), out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)

    public = build_torch_loftr(seed=13)
    port = loftr.LoFTR(dict(CONF), device="cpu")
    port.load_state_dict(public.state_dict(), strict=True)
    with torch.no_grad():
        c, f = public.backbone(t)
        pe = torch.from_numpy(loftr.position_encoding_sine(
            256, *c.shape[2:])).permute(2, 0, 1)
        tok = (c + pe).flatten(2).transpose(1, 2)
        tok0, _ = public.loftr_coarse(tok, tok)
    t0, _, f0, _ = port.coarse_features(t, t)
    assert _rel_err(t0.numpy(), tok0.numpy()) < 1e-5
    assert _rel_err(f0.numpy(), f.permute(0, 2, 3, 1).numpy()) < 1e-5


def test_top_k_clamps_on_small_images():
    m = loftr.LoFTR({"pretrained": None, "max_matches": 1024,
                     "match_threshold": 0.0}, device="cpu")
    img = np.random.default_rng(0).uniform(0, 1, (64, 64)).astype(np.float32)
    mk0, mk1, conf, valid = m.match_pair(img, img)
    assert mk0.shape == mk1.shape == (64, 2)      # (64 / 8)^2 cells
    assert conf.shape == valid.shape == (64,)
    assert np.isfinite(mk1[valid]).all()


def test_conf_change_takes_effect():
    m = loftr.LoFTR({"pretrained": None, "max_matches": 32,
                     "match_threshold": 0.0}, device="cpu")
    img = np.random.default_rng(1).uniform(0, 1, (64, 64)).astype(np.float32)
    valid0 = m.match_pair(img, img)[3]
    m.conf.match_threshold = 2.0       # no confidence passes
    valid1 = m.match_pair(img, img)[3]
    assert valid0.sum() > 0 and valid1.sum() == 0


# ---------------------------------------------------------------------------
# the detector-free front end
# ---------------------------------------------------------------------------

def _write_views(tmp_path):
    """Three gray PNG views (80x96, shifted crops of one smooth image): an
    exact decode in both packages."""
    import PIL.Image
    big = _smooth((112, 128), seed=19)
    names = ["a.png", "b.png", "c.png"]
    for i, n in enumerate(names):
        crop = big[8 * i:8 * i + 80, 8 * i:8 * i + 96]
        PIL.Image.fromarray((crop * 255).astype(np.uint8)).save(tmp_path / n)
    return names


def test_match_loftr_dir_matches_jax(tmp_path, models, monkeypatch):
    """Both front ends on the same views with the same weights: the JAX
    package's own random init (its ``match_loftr_dir`` builds a fresh
    model), carried into the port's class for this test."""
    pytest.importorskip("cv2")
    from pixsfm_tpu.features import detectors as jdet
    from pixsfm_tpu_torch.features import detectors as tdet
    conf = {**CONF, "match_threshold": 0.0}
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(
        JaxLoFTR(dict(conf)).variables))

    class Carried(loftr.LoFTR):
        def __init__(self, conf=None, device=None, seed=0):
            super().__init__(conf, device=device, seed=seed)
            self.load_state_dict(loftr.params_from_flax(variables))

    monkeypatch.setattr(loftr, "LoFTR", Carried)
    names = _write_views(tmp_path)
    kj, mj, sj = jdet.match_loftr_dir(tmp_path, names, matcher_conf=conf,
                                      min_matches=5)
    stats = {}
    kt, mt, st = tdet.match_loftr_dir(tmp_path, names, matcher_conf=conf,
                                      min_matches=5, device="cpu",
                                      stats=stats)
    assert len(mj) == 3 and list(mt) == list(mj)
    for n in names:
        assert kt[n].shape == kj[n].shape and len(kj[n]) >= 5
        np.testing.assert_allclose(kt[n], kj[n], rtol=0, atol=1e-3)
    for p in mj:
        np.testing.assert_array_equal(mt[p], mj[p])
        np.testing.assert_allclose(st[p], sj[p], rtol=1e-4, atol=0)
    assert stats["matched_pairs"] == 3 and stats["matching_s"] > 0
    with pytest.raises(FileNotFoundError, match="nope.png"):
        tdet.match_loftr_dir(tmp_path, ["nope.png"], matcher_conf=CONF,
                             device="cpu")


@pytest.mark.parametrize("fmt", ["rgb.png", "gray.png", "rgb.jpg"])
@pytest.mark.parametrize("max_edge", [1024, 333, 250])
def test_gray_loader_matches_opencv(tmp_path, fmt, max_edge):
    """``load_gray`` against the JAX front end's decode (``cv2.imread``
    grayscale, then ``cv2.resize`` at the default ``INTER_LINEAR``): equal
    (bound 0 levels) for colour and gray PNGs and JPEGs, at factors of
    0.666 and 1/2 (which OpenCV serves with ``INTER_AREA``)."""
    cv2 = pytest.importorskip("cv2")
    import PIL.Image

    from pixsfm_tpu_torch.features.detectors import load_gray
    img = np.random.default_rng(8).integers(0, 256, (300, 500, 3)).astype(
        np.uint8)
    img[:20] = img[:20, :, :1]                     # grey pixels too
    if fmt == "gray.png":
        img = img[..., 1]
    PIL.Image.fromarray(img).save(tmp_path / fmt, quality=90)
    ref = cv2.imread(str(tmp_path / fmt), cv2.IMREAD_GRAYSCALE)
    scale = 1.0
    if max(ref.shape) > max_edge:
        scale = max_edge / max(ref.shape)
        ref = cv2.resize(ref, None, fx=scale, fy=scale)
    out, s = load_gray(tmp_path / fmt, max_edge)
    assert s == scale
    np.testing.assert_array_equal(np.rint(out * 255).astype(np.uint8), ref)


@pytest.mark.parametrize("shape,fx", [((1200, 1600), 0.64),
                                      ((97, 131), 0.37),
                                      ((361, 481, 3), 0.73),
                                      ((240, 320), 0.5)])
def test_resize_linear_matches_opencv(shape, fx):
    cv2 = pytest.importorskip("cv2")
    from pixsfm_tpu_torch.features.detectors import resize_linear
    img = np.random.default_rng(9).integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(resize_linear(img, fx, fx),
                                  cv2.resize(img, None, fx=fx, fy=fx))
