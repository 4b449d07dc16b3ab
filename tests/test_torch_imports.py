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
                 "util.colmap", "refine_colmap", "refine_hloc"):
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
    problems = solver.KAProblems(*[np.zeros((1, 8, 2))] * 15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve_ka_problems(problems, np.zeros((1, 16, 16, 8)),
                                 solver.InterpolationConfig(),
                                 solver.RobustLoss(), solver.LMOptions())
