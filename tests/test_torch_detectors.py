"""Port parity: the detectors, VGGNet, the matchers and the ETH3D helpers
of ``pixsfm_tpu_torch`` against the JAX package on the CPU.

The JAX models' random weights are carried across with each port module's
``params_from_flax`` (R2D2's BatchNorm statistics randomized, so that a
wrong mapping cannot pass as the identity). Tolerances:

- forward passes within 1e-4 of the largest value (float32 on both sides,
  convolutions summed in different orders);
- ``detect``: the valid keypoints equal (D2-Net's sub-pixel Newton step
  moves them within 1e-3 px), scores within 1e-5 relative, descriptors
  within 1e-4;
- matching: pairs equal, scores within 1e-6;
- numpy helpers, the synthetic scene and the area resize: equal.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.features.models.d2net import D2Net as JaxD2Net
from pixsfm_tpu.features.models.r2d2 import R2D2 as JaxR2D2
from pixsfm_tpu.features.models.superpoint import SuperPoint as JaxSuperPoint
from pixsfm_tpu.features.models.vggnet import VGGNet as JaxVGGNet
from pixsfm_tpu_torch.features.models import d2net, r2d2, superpoint, vggnet
from pixsfm_tpu_torch.features.models.base_model import read_checkpoint

PORT = {"superpoint": superpoint, "r2d2": r2d2, "d2net": d2net,
        "vggnet": vggnet}
JAX = {"superpoint": JaxSuperPoint, "r2d2": JaxR2D2, "d2net": JaxD2Net,
       "vggnet": JaxVGGNet}
CLASSES = {"superpoint": superpoint.SuperPoint, "r2d2": r2d2.R2D2,
           "d2net": d2net.D2Net, "vggnet": vggnet.VGGNet}
DETECT_CONF = {"superpoint": {"max_keypoints": 256},
               "r2d2": {"max_keypoints": 256, "reliability_threshold": 0.0,
                        "repeatability_threshold": 0.0},
               "d2net": {"max_keypoints": 256}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: among the fast lane's
    parallel workers, torch's default threads only contend for the cores
    (as in ``tests/test_torch_ba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(variables, seed=0):
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(variables))
    for stats in variables.get("batch_stats", {}).values():
        stats["mean"] = rng.normal(0, 0.2, stats["mean"].shape).astype(
            np.float32)
        stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(
            np.float32)
    return variables


def _pair(name, conf=None):
    """(JAX model, port model with the JAX weights) on the CPU."""
    conf = {**(conf or {}), "pretrained": None}
    jm = JAX[name](conf)
    variables = _randomize_bn(jm.variables)
    jm.variables = flax.core.freeze(jax.tree.map(jnp.asarray, variables))
    tm = CLASSES[name](conf, device="cpu")
    tm.load_state_dict(PORT[name].params_from_flax(variables))
    return jm, tm


def _image(seed=0, H=96, W=128):
    return np.random.default_rng(seed).uniform(0, 1, (1, H, W, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["superpoint", "r2d2", "d2net", "vggnet"])
def test_forward_matches_jax(name):
    jm, tm = _pair(name)
    img = _image()
    ref = [np.asarray(f) for f in jm._forward(jnp.asarray(img))]
    with torch.no_grad():
        out = tm(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert len(out) == len(ref) == len(tm.output_dims)
    for o, r, c in zip(out, ref, tm.output_dims):
        o = o.permute(0, 2, 3, 1).numpy()
        assert o.shape == r.shape and o.shape[-1] == c
        np.testing.assert_allclose(o, r, atol=1e-4 * np.abs(r).max())


def _sorted_valid(out):
    v = out["valid"][0]
    kp, sc, de = (out[k][0][v] for k in ("keypoints", "scores",
                                         "descriptors"))
    order = np.lexsort((kp[:, 1], kp[:, 0]))
    return kp[order], sc[order], de[order]


@pytest.mark.parametrize("name", ["superpoint", "r2d2", "d2net"])
def test_detect_matches_jax(name):
    jm, tm = _pair(name, DETECT_CONF[name])
    img = _image(1)
    kj, sj, dj = _sorted_valid(jm.detect(img))
    kt, st, dt = _sorted_valid(tm.detect(img))
    assert len(kj) == len(kt) > 20
    np.testing.assert_allclose(kt, kj, atol=1e-3 if name == "d2net" else 0)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dt, dj, atol=1e-4)


# ---------------------------------------------------------------------------
# public checkpoint layouts, fabricated as tests/test_checkpoint_layouts.py
# does: a random state dict under the public names, converted by the JAX
# package's loader and loaded with load_state_dict(strict=True) here
# ---------------------------------------------------------------------------

def _t(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.1, shape).astype(np.float32))


def _public_state_dict(name, tm):
    """The state dict of the public checkpoint file, wrapper included."""
    sd = {}
    for i, (k, v) in enumerate(tm.state_dict().items()):
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000)
        elif k.endswith("running_var"):
            sd[k] = _t(tuple(v.shape), i).abs() + 0.5
        else:
            sd[k] = _t(tuple(v.shape), i)
    if name == "superpoint":        # magicleap: a raw state dict
        return sd, sd
    if name == "r2d2":              # naver: {'net': ..., 'state_dict': ...}
        return sd, {"net": "Quad_L2Net_ConfCFS(dim=128)", "state_dict": sd}
    if name == "d2net":             # d2_tf.pth: {'model': ...}
        return sd, {"model": sd}
    return sd, {"state_dict": sd}   # vgg16 in the S2DNet layout


@pytest.mark.parametrize("name", ["superpoint", "r2d2", "d2net", "vggnet"])
def test_public_checkpoint_layout_loads(tmp_path, name):
    from pixsfm_tpu.features.models import d2net as jd2
    from pixsfm_tpu.features.models import r2d2 as jr2
    from pixsfm_tpu.features.models import s2dnet as js2
    from pixsfm_tpu.features.models import superpoint as jsp

    jm = JAX[name]({"pretrained": None})
    tm = CLASSES[name]({"pretrained": None}, device="cpu")
    sd, blob = _public_state_dict(name, tm)
    pth = tmp_path / "ckpt.pth"
    torch.save(blob, pth)
    loaders = {"superpoint": jsp.load_torch_superpoint,
               "r2d2": jr2.load_torch_r2d2, "d2net": jd2.load_torch_d2net,
               "vggnet": lambda p, v: js2.load_torch_s2dnet(p, v, ())}
    jm.variables = loaders[name](pth, jm.variables)
    read = read_checkpoint(pth)
    assert set(read) == set(sd)
    tm.load_state_dict(read, strict=True)
    img = _image(2)
    ref = [np.asarray(f) for f in jm._forward(jnp.asarray(img))]
    with torch.no_grad():
        out = tm(torch.from_numpy(img).permute(0, 3, 1, 2))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), r,
                                   atol=1e-4 * np.abs(r).max())


# ---------------------------------------------------------------------------
# matching and the numpy helpers
# ---------------------------------------------------------------------------

def _descriptors(seed, K, C=32):
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 1, (K, C)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d, rng.uniform(0, 1, K) > 0.2


@pytest.mark.parametrize("ratio,min_sim", [(0.95, -1.0), (np.inf, 0.3)])
def test_mutual_nn_ratio_match_matches_jax(ratio, min_sim):
    from pixsfm_tpu.features import detectors as jdet
    from pixsfm_tpu_torch.features import detectors as tdet
    d1, v1 = _descriptors(0, 300)
    d2, v2 = _descriptors(1, 280)
    d2[:100] = d1[:100] + np.random.default_rng(2).normal(
        0, 0.1, (100, 32)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    pj, sj = jdet.mutual_nn_ratio_match(d1, d2, v1, v2, ratio=ratio,
                                        min_similarity=min_sim)
    pt, st = tdet.mutual_nn_ratio_match(d1, d2, v1, v2, ratio=ratio,
                                        min_similarity=min_sim,
                                        device="cpu")
    assert len(pj) > 30
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(st, sj, atol=1e-6)


def test_match_exhaustive_matches_jax():
    from pixsfm_tpu.features import detectors as jdet
    from pixsfm_tpu_torch.features import detectors as tdet
    names = ["a.png", "b.png", "c.png"]
    base, _ = _descriptors(3, 200)
    rng = np.random.default_rng(4)
    descs, valid = {}, {}
    for i, n in enumerate(names):
        d = base + rng.normal(0, 0.02 * (i + 1), base.shape).astype(
            np.float32)
        descs[n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        valid[n] = rng.uniform(0, 1, len(d)) > 0.1
    for method in ("superpoint", "d2net", "r2d2"):
        mj, sj = jdet.match_exhaustive(names, descs, valid, method=method)
        mt, st = tdet.match_exhaustive(names, descs, valid, method=method,
                                       device="cpu")
        assert list(mt) == list(mj) and len(mj) > 0, method
        for pair in mj:
            np.testing.assert_array_equal(mt[pair], mj[pair])
            np.testing.assert_allclose(st[pair], sj[pair], atol=1e-6)


def test_aggregate_semidense_matches_matches_jax():
    from pixsfm_tpu.features import detectors as jdet
    from pixsfm_tpu_torch.features import detectors as tdet
    rng = np.random.default_rng(5)
    pm = {}
    for a, b in (("x", "y"), ("x", "z"), ("y", "z")):
        xy0 = rng.uniform(0, 20, (60, 2))
        pm[(a, b)] = (xy0, xy0 + rng.normal(0, 2, (60, 2)),
                      rng.uniform(0, 1, 60))
    kj, mj, sj = jdet.aggregate_semidense_matches(pm, cell_size=2.0)
    kt, mt, st = tdet.aggregate_semidense_matches(pm, cell_size=2.0)
    assert sorted(kt) == sorted(kj) and list(mt) == list(mj)
    for n in kj:
        np.testing.assert_array_equal(kt[n], kj[n])
    for p in mj:
        np.testing.assert_array_equal(mt[p], mj[p])
        np.testing.assert_array_equal(st[p], sj[p])


def test_loftr_front_end_names_its_roadmap_item(tmp_path):
    """The detector-free front end is ported: a missing image raises
    ``FileNotFoundError`` naming it, through ``match_loftr_dir`` and
    through the harness's ``detect_and_match``, as in the JAX package."""
    from pixsfm_tpu_torch.eval.eth3d.triangulation import detect_and_match
    from pixsfm_tpu_torch.features.detectors import match_loftr_dir
    conf = {"pretrained": None}
    with pytest.raises(FileNotFoundError, match="a.png"):
        match_loftr_dir(tmp_path, ["a.png"], matcher_conf=conf,
                        device="cpu")
    with pytest.raises(FileNotFoundError, match="a.png"):
        detect_and_match(tmp_path, ["a.png"], method="loftr", device="cpu")


def test_eth3d_utils_match_jax(tmp_path):
    from pixsfm_tpu.eval.eth3d import utils as ju
    from pixsfm_tpu_torch.eval.eth3d import synthetic as tsyn
    from pixsfm_tpu_torch.eval.eth3d import utils as tu
    rng = np.random.default_rng(6)
    rec, gt = rng.normal(0, 1, (300, 3)), rng.normal(0, 1, (250, 3))
    tol = (0.05, 0.2, 0.5)
    assert tu.accuracy_completeness(rec, gt, tol) == \
        ju.accuracy_completeness(rec, gt, tol)
    assert tu.accuracy_completeness(rec[:0], gt, tol) == \
        ju.accuracy_completeness(rec[:0], gt, tol)
    errors = list(rng.uniform(0, 0.2, 9)) + [np.inf]
    assert tu.pose_auc(errors, tol) == ju.pose_auc(errors, tol)
    tu.create_list_files(["c.png", "a.png", "b.png"], tmp_path / "t.txt")
    ju.create_list_files(["c.png", "a.png", "b.png"], tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    tsyn.write_ply(tmp_path / "a.ply", rec)
    np.testing.assert_array_equal(tu.read_ply_xyz(tmp_path / "a.ply"),
                                  ju.read_ply_xyz(tmp_path / "a.ply"))
    binary = tmp_path / "b.ply"
    with open(binary, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 300\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"property uchar red\nend_header\n")
        data = np.zeros(300, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                              ("red", "u1")])
        data["x"], data["y"], data["z"] = rec.T.astype(np.float32)
        f.write(data.tobytes())
    np.testing.assert_array_equal(tu.read_ply_xyz(binary),
                                  ju.read_ply_xyz(binary))


def test_synthetic_scene_matches_jax(tmp_path):
    from pixsfm_tpu.eval.eth3d.synthetic import \
        make_synthetic_scene as jmake
    from pixsfm_tpu_torch.eval.eth3d.synthetic import \
        make_synthetic_scene as tmake
    from pixsfm_tpu_torch.sfm.model import Reconstruction
    rt = tmake(tmp_path / "t", n_images=4, n_points=40, seed=5)
    rj = jmake(tmp_path / "j", n_images=4, n_points=40, seed=5)
    assert sorted(rt.points3D) == sorted(rj.points3D)
    for pid in rj.points3D:
        np.testing.assert_array_equal(rt.points3D[pid].xyz,
                                      rj.points3D[pid].xyz)
    for iid, im in rj.images.items():
        assert rt.images[iid].name == im.name
        np.testing.assert_allclose(rt.images[iid].qvec, im.qvec, atol=1e-7)
        np.testing.assert_allclose(rt.images[iid].tvec, im.tvec, atol=1e-6)
        assert (tmp_path / "t" / "images" / im.name).read_bytes() == \
            (tmp_path / "j" / "images" / im.name).read_bytes()
    assert (tmp_path / "t" / "scan_clean.ply").read_text() == \
        (tmp_path / "j" / "scan_clean.ply").read_text()
    back = Reconstruction.read(tmp_path / "t" / "dslr_calibration_undistorted")
    assert len(back.images) == 4 and len(back.points3D) == len(rj.points3D)


# ---------------------------------------------------------------------------
# image loading and the SIFT branch (OpenCV on the JAX side)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,fx", [((403, 605, 3), 1600 / 6048),
                                      ((361, 481, 3), 0.73),
                                      ((240, 320, 3), 0.5),
                                      ((77, 131), 1 / 3)])
def test_resize_area_matches_opencv(shape, fx):
    cv2 = pytest.importorskip("cv2")
    from pixsfm_tpu_torch.features.detectors import resize_area
    img = np.random.default_rng(7).integers(0, 256, shape).astype(np.uint8)
    ref = cv2.resize(img, None, fx=fx, fy=fx, interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resize_area(img, fx, fx), ref)


def test_load_rgb_matches_opencv_loader(tmp_path):
    pytest.importorskip("cv2")
    import PIL.Image

    from pixsfm_tpu.features.detectors import _load_rgb
    from pixsfm_tpu_torch.features.detectors import load_rgb
    img = np.random.default_rng(8).integers(0, 256, (300, 500, 3)).astype(
        np.uint8)
    PIL.Image.fromarray(img).save(tmp_path / "a.png")
    for max_edge in (500, 333):
        a, sa = load_rgb(tmp_path / "a.png", max_edge)
        b, sb = _load_rgb(tmp_path / "a.png", max_edge)
        assert sa == sb
        np.testing.assert_array_equal(a, b)


def _exif_jpeg(path):
    """A 160x120 JPEG whose EXIF orientation tag (6) turns it upright as
    120x160 rotated."""
    import PIL.Image
    img = np.random.default_rng(9).integers(0, 256, (120, 160, 3)).astype(
        np.uint8)
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    PIL.Image.fromarray(img).save(path, exif=exif.tobytes())


def test_load_rgb_applies_exif_orientation(tmp_path):
    pytest.importorskip("cv2")
    from pixsfm_tpu.features.detectors import _load_rgb
    from pixsfm_tpu_torch.features.detectors import load_rgb
    _exif_jpeg(tmp_path / "o.jpg")
    a, sa = load_rgb(tmp_path / "o.jpg", 1600)
    b, sb = _load_rgb(tmp_path / "o.jpg", 1600)
    assert a.shape == b.shape == (160, 120, 3) and sa == sb
    np.testing.assert_array_equal(a, b)


def test_load_gray_applies_exif_orientation(tmp_path):
    """The LoFTR front end's loader against the JAX package's decode
    (``cv2.imread`` grayscale) on the same file."""
    cv2 = pytest.importorskip("cv2")
    from pixsfm_tpu_torch.features.detectors import load_gray
    _exif_jpeg(tmp_path / "o.jpg")
    ref = cv2.imread(str(tmp_path / "o.jpg"), cv2.IMREAD_GRAYSCALE)
    out, scale = load_gray(tmp_path / "o.jpg", 1024)
    assert out.shape == ref.shape == (160, 120) and scale == 1.0
    np.testing.assert_array_equal(np.rint(out * 255).astype(np.uint8), ref)


def test_sift_branch_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from pixsfm_tpu.features import detectors as jdet
    from pixsfm_tpu_torch.eval.eth3d.synthetic import make_synthetic_scene
    from pixsfm_tpu_torch.features import detectors as tdet
    rec = make_synthetic_scene(tmp_path / "s", n_images=3, n_points=40,
                               seed=5)
    names = sorted(im.name for im in rec.images.values())
    image_dir = tmp_path / "s" / "images"
    kj, mj, sj = jdet.detect_and_match_dir(image_dir, names, method="sift",
                                           max_edge=400)
    kt, mt, st = tdet.detect_and_match_dir(image_dir, names, method="sift",
                                           max_edge=400, device="cpu")
    for n in names:
        np.testing.assert_array_equal(kt[n], kj[n])
    assert list(mt) == list(mj) and len(mj) > 0
    for p in mj:
        np.testing.assert_array_equal(mt[p], mj[p])
        np.testing.assert_array_equal(st[p], sj[p])


# ---------------------------------------------------------------------------
# multilevel KA on VGGNet's 64 / 256 / 512-channel levels
# ---------------------------------------------------------------------------

def test_vggnet_multilevel_ka_matches_jax(tmp_path):
    """KA on VGGNet's three levels of 64 / 256 / 512 channels (float32
    patches, so the two packages read the same features): keypoints within
    1e-4 px of JAX's."""
    from pixsfm_tpu.refine_colmap import PixSfM as JaxPixSfM
    from pixsfm_tpu_torch.refine_colmap import PixSfM
    from tests.test_torch_ka import _write_scene

    keypoints, matches = _write_scene(tmp_path, np.random.default_rng(9),
                                      n_kps=10, H=192, W=256)
    conf = {"dense_features": {"model": {"name": "vggnet",
                                         "pretrained": None},
                               "dtype": "float"},
            "mapping": {"KA": {"optimizer": {"solver": {
                "max_num_iterations": 10}}}}}
    jsfm = JaxPixSfM(conf)
    tsfm = PixSfM(conf, device="cpu")
    tsfm.extractor.model.load_state_dict(vggnet.params_from_flax(
        jax.tree.map(np.asarray, jsfm.extractor.model.variables)))
    assert tsfm.extractor.channels_per_level == [64, 256, 512]
    kj, oj = jsfm.run_ka({k: v.copy() for k, v in keypoints.items()},
                         tmp_path, matches=matches)
    kt, ot = tsfm.run_ka({k: v.copy() for k, v in keypoints.items()},
                         tmp_path, matches=matches)
    assert len(ot["final_cost"]) == 3
    np.testing.assert_allclose(ot["final_cost"], oj["final_cost"],
                               rtol=1e-4)
    for n in keypoints:
        np.testing.assert_allclose(kt[n], kj[n], atol=1e-4)
