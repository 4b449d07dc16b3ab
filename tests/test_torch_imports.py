"""The port stands alone: every ``pixsfm_tpu_torch`` module imports without
JAX and without the JAX package, and its entry points refuse to run on a
missing GPU instead of falling back to the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pixsfm_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "pixsfm_tpu_torch"


def _module_names():
    names = ["pixsfm_tpu_torch"]
    for m in pkgutil.walk_packages([str(PKG)], prefix="pixsfm_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for n in {_module_names()!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'pixsfm_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for name in ("keypoint_adjustment.solver", "ops.schur", "ops.schur_cuda",
                 "bundle_adjustment.main", "bundle_adjustment.references",
                 "bundle_adjustment.problem", "base.geometry",
                 "base.cameras", "base.projection", "sfm.model",
                 "sfm.synthetic", "sfm.triangulation", "util.database",
                 "util.colmap", "refine_colmap", "refine_hloc",
                 "localization.pnp", "sfm.two_view", "sfm.mapper",
                 "features.models.dsift", "features.models.image",
                 "localization.main", "localize",
                 "bundle_adjustment.costmaps", "features.detectors",
                 "features.models.superpoint", "features.models.r2d2",
                 "features.models.d2net", "features.models.vggnet",
                 "eval.eth3d.config", "eval.eth3d.utils",
                 "eval.eth3d.synthetic", "eval.eth3d.triangulation",
                 "eval.eth3d.localization", "features.models.loftr",
                 "configs", "eval.eth3d.plot_triangulation",
                 "eval.eth3d.plot_localization", "parallel",
                 "parallel.sharded", "util.profiling", "features.h5cache",
                 "features.store_references", "native", "util.visualize",
                 "eval.eth3d.download"):
        assert f"pixsfm_tpu_torch.{name}" in _module_names()


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import (jax|flax|ml_dtypes|pixsfm_tpu)\b"
                     r"|from (jax|flax|ml_dtypes|pixsfm_tpu)\b[ .])", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path is not reachable")
    from pixsfm_tpu_torch.keypoint_adjustment import solver
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PixSfM()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pixsfm_tpu_torch.resolve_device("cuda")
    from pixsfm_tpu_torch.bundle_adjustment import BundleAdjuster
    from pixsfm_tpu_torch.refine_colmap import main as colmap_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BundleAdjuster.create()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BundleAdjuster.create({"strategy": "costmaps"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PixSfM("low_memory")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        colmap_main(["bundle_adjuster", "--input_path", "m", "--output_path",
                     "o", "--image_dir", "i"])
    from pixsfm_tpu_torch.base.graph import Graph
    from pixsfm_tpu_torch.refine_hloc import main as hloc_main
    from pixsfm_tpu_torch.sfm import Reconstruction
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_reconstruction
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hloc_main(["triangulator", "--image_dir", "i",
                   "--reference_model_path", "r", "--features_path", "f",
                   "--pairs_path", "p", "--matches_path", "m",
                   "--output_dir", "o"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        colmap_main(["keypoint_adjuster", "--database_path", "d",
                     "--output_path", "o", "--image_dir", "i"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        triangulate_reconstruction(Reconstruction(), Graph(), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hloc_main(["reconstructor", "--image_dir", "i", "--features_path",
                   "f", "--pairs_path", "p", "--matches_path", "m",
                   "--output_dir", "o"])
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.localization import absolute_pose_estimation
    from pixsfm_tpu_torch.sfm.mapper import incremental_mapping
    cam = Camera(1, "PINHOLE", 64, 48, [50.0, 50.0, 32.0, 24.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        absolute_pose_estimation(np.zeros((8, 2)), np.ones((8, 3)), cam)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        incremental_mapping(Graph(), {}, ".")
    problems = solver.KAProblems(*[np.zeros((1, 8, 2))] * 15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve_ka_problems(problems, np.zeros((1, 16, 16, 8)),
                                 solver.InterpolationConfig(),
                                 solver.RobustLoss(), solver.LMOptions())
    from pixsfm_tpu_torch.localization import (QueryBundleAdjuster,
                                               QueryKeypointAdjuster,
                                               QueryLocalizer,
                                               pose_refinement)
    from pixsfm_tpu_torch.localize import main as localize_main
    for cls in (QueryKeypointAdjuster, QueryBundleAdjuster):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryLocalizer(Reconstruction(), references=[{}])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pose_refinement(cam, [1.0, 0, 0, 0], np.zeros(3), np.ones((8, 3)),
                        np.zeros((8, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.evaluate_descriptors(np.zeros((1, 16, 16, 8)), [0],
                                    np.zeros((1, 2)), np.zeros((1, 2)),
                                    np.ones((1, 2)), np.ones(1),
                                    solver.InterpolationConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve_target_problems(
            np.zeros((1, 2)), [0], np.zeros((1, 2)), np.ones((1, 2)),
            np.ones(1), np.zeros((1, 1, 8)), np.ones((1, 1)),
            np.zeros((1, 2)), np.ones((1, 2)), np.zeros((1, 16, 16, 8)),
            solver.InterpolationConfig(), solver.RobustLoss(),
            solver.LMOptions())
    tmain = __import__("pixsfm_tpu_torch.keypoint_adjustment.main",
                       fromlist=["KeypointAdjuster"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.KeypointAdjuster.create({"strategy": "topological_reference"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        localize_main(["--reference_sfm", "m", "--queries", "q",
                       "--features_path", "f", "--pairs_path", "p",
                       "--matches_path", "m", "--image_dir", "i",
                       "--output_path", "o"])


def test_reconstruction_is_ported():
    """``PixSfM.reconstruction`` (and ``run``) is the mapper flow, no longer
    a stub; a device mesh passed to the PnP driver splits its query batch
    and draws what an unsharded call draws."""
    import inspect

    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.localization import absolute_pose_estimation_batch
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    assert PixSfM.run is PixSfM.reconstruction
    for fn in (PixSfM.reconstruction, PixSfM._reconstruction):
        assert "NotImplementedError" not in inspect.getsource(fn)
    cam = Camera(1, "PINHOLE", 64, 48, [50.0, 50.0, 32.0, 24.0])
    q = dict(points2D=np.zeros((8, 2)), points3D=np.ones((8, 3)), camera=cam)
    from pixsfm_tpu_torch.parallel import make_mesh
    one = absolute_pose_estimation_batch([q, q], device="cpu")
    two = absolute_pose_estimation_batch([q, q], mesh=make_mesh(2, "cpu"))
    for a, b in zip(one, two):
        assert a["success"] == b["success"]
        assert a["num_inliers"] == b["num_inliers"]


def test_weight_free_presets_load():
    """The dsift, norefine and photometric presets load; dsift and norefine
    build a pipeline on the CPU with their weight-free models."""
    from pixsfm_tpu_torch.config import load_config
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    confs = {n: load_config(n) for n in ("dsift", "norefine", "photometric")}
    assert confs["dsift"].dense_features.model.name == "dsift"
    assert confs["photometric"].mapping.BA.strategy == "patch_warp"
    sfm = PixSfM(confs["dsift"], device="cpu")
    assert sfm.extractor.model.output_dims == [128]
    assert sfm.extractor.model.device.type == "cpu"
    sfm = PixSfM(confs["norefine"], device="cpu")
    assert sfm.extractor.model.output_dims == [3]
    assert not sfm.keypoint_adjuster.conf.apply


def test_detectors_and_eth3d_entry_points_raise_without_gpu(tmp_path):
    """The detectors, the matcher and the ETH3D harnesses run on ``cuda``
    unless given ``device="cpu"`` / ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path is not reachable")
    from pixsfm_tpu_torch.eval.eth3d.synthetic import make_synthetic_scene
    from pixsfm_tpu_torch.eval.eth3d.triangulation import main as tri_main
    from pixsfm_tpu_torch.eval.eth3d.triangulation import run_scene
    from pixsfm_tpu_torch.features.detectors import (detect_directory,
                                                     mutual_nn_ratio_match)
    from pixsfm_tpu_torch.features.models import get_model
    for name in ("superpoint", "r2d2", "d2net", "vggnet", "s2dnet"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(name)({"pretrained": None})
    d = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mutual_nn_ratio_match(d, d, np.ones(4, bool), np.ones(4, bool))
    make_synthetic_scene(tmp_path / "s", n_images=2, n_points=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_directory(tmp_path / "s" / "images", ["image1.jpg"],
                         method="superpoint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scene(tmp_path / "s", tmp_path / "o")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tri_main(["--dataset_dir", str(tmp_path), "--output_dir",
                  str(tmp_path / "o"), "--scenes", "s"])


def test_loftr_entry_points_raise_without_gpu(tmp_path):
    """LoFTR, ``match_loftr_dir`` and both harnesses with ``--method
    loftr`` run on ``cuda`` unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path is not reachable")
    from pixsfm_tpu_torch.eval.eth3d.localization import \
        run_scene_localization
    from pixsfm_tpu_torch.eval.eth3d.synthetic import make_synthetic_scene
    from pixsfm_tpu_torch.eval.eth3d.triangulation import run_scene
    from pixsfm_tpu_torch.features.detectors import match_loftr_dir
    from pixsfm_tpu_torch.features.models.loftr import LoFTR
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoFTR({"pretrained": None})
    make_synthetic_scene(tmp_path / "s", n_images=2, n_points=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        match_loftr_dir(tmp_path / "s" / "images",
                        ["image1.jpg", "image2.jpg"])
    for run in (run_scene, run_scene_localization):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(tmp_path / "s", tmp_path / "o", method="loftr")


@pytest.mark.parametrize("name,dims,scales", [
    ("superpoint", [256], [8]), ("r2d2", [128], [1]), ("d2net", [512], [4]),
    ("vggnet", [64, 256, 512], [1, 4, 16])])
def test_detector_models_are_registered(name, dims, scales):
    """``get_model`` builds the detectors and VGGNet (no JAX: see
    ``test_every_module_imports_without_jax``); their submodules carry the
    public checkpoints' names."""
    from pixsfm_tpu_torch.features.models import get_model
    model = get_model(name)({"pretrained": None}, device="cpu")
    assert model.output_dims == dims and model.scales == scales
    keys = set(model.state_dict())
    want = {"superpoint": "convDb.weight", "r2d2": "ops.1.running_var",
            "d2net": "dense_feature_extraction.model.21.weight",
            "vggnet": "encoder.28.weight"}[name]
    assert want in keys
