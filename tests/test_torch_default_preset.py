"""Port parity: every config preset builds the refiner by name.

``PixSfM(name)`` resolves the ``mapping`` subtree against the whole config
before it takes the KA and BA strategy configs out of it, so the default
preset's ``interpolation: ${..interpolation}`` reaches the top-level block
(the JAX package's ``PixSfM`` recurses on it, ROADMAP.md section 3). For
every preset: the port's refiner built by name, from the loaded config and
from its resolved dict has the same KA and BA adjusters with equal configs,
equal to what JAX's ``PixSfM`` builds from the resolved dict (exact).
``PixSfM("default")`` equals ``PixSfM()``. Both command lines accept
``--config_path default`` on the CPU and reach the refiner's entry point
with those configs.
"""

import pytest

from pixsfm_tpu_torch.config import load_config
from pixsfm_tpu_torch.configs import list_configs
from tests.test_torch_localization import _one_torch_thread  # noqa: F401


def _strategies(sfm):
    """The KA and BA adjusters' classes and configs."""
    return [(type(a).__name__, a.conf.to_dict())
            for a in (sfm.keypoint_adjuster, sfm.bundle_adjuster)]


@pytest.fixture(scope="module")
def jax_pixsfm():
    """JAX's ``PixSfM`` with its feature extractor left out (only the
    strategy configs are compared, and the flax models take seconds to
    initialise)."""
    import pixsfm_tpu.refine_colmap as jcolmap

    class _NoExtractor:
        def __init__(self, conf):
            self.conf = conf

    saved = jcolmap.FeatureExtractor
    jcolmap.FeatureExtractor = _NoExtractor
    yield jcolmap.PixSfM
    jcolmap.FeatureExtractor = saved


def test_presets_are_all_listed():
    assert set(list_configs()) >= {
        "default", "dsift", "low_memory", "photometric", "norefine",
        "pixsfm_eth3d", "pixsfm_eth3d_d2net"}


@pytest.mark.parametrize("name", list_configs())
def test_preset_by_name_matches_resolved_and_jax(name, jax_pixsfm):
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    resolved = load_config(name).to_dict(resolve=True)
    want = _strategies(PixSfM(resolved, device="cpu"))
    assert _strategies(PixSfM(name, device="cpu")) == want
    assert _strategies(PixSfM(load_config(name), device="cpu")) == want
    assert _strategies(jax_pixsfm(resolved)) == want


def test_default_by_name_is_the_default():
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    default = _strategies(PixSfM(device="cpu"))
    assert _strategies(PixSfM("default", device="cpu")) == default
    ka, ba = default
    assert (ka[0], ba[0]) == ("FeatureMetricKeypointAdjuster",
                              "FeatureReferenceBundleAdjuster")
    assert ka[1]["interpolation"] == ba[1]["interpolation"] == \
        load_config("default").to_dict()["interpolation"]


@pytest.mark.parametrize("cli,command,method", [
    ("refine_colmap", "keypoint_adjuster", "refine_keypoints_from_db"),
    ("refine_colmap", "bundle_adjuster", "refine_reconstruction"),
    ("refine_hloc", "keypoint_adjuster", "refine_keypoints"),
    ("refine_hloc", "triangulator", "triangulation"),
    ("refine_hloc", "reconstructor", "reconstruction"),
    ("refine_hloc", "bundle_adjuster", "refine_reconstruction"),
])
def test_cli_config_path_default(monkeypatch, tmp_path, cli, command,
                                 method):
    """``--config_path default --device cpu`` builds the refiner and calls
    the command's entry point, recorded here in place of the run."""
    import importlib
    mod = importlib.import_module(f"pixsfm_tpu_torch.{cli}")
    from pixsfm_tpu_torch.refine_hloc import PixSfM as Default
    built = []
    monkeypatch.setattr(mod.PixSfM, method,
                        lambda self, *a, **k: built.append(self))
    paths = {"keypoint_adjuster": ["--database_path", "db", "--output_path",
                                   "out"] if cli == "refine_colmap" else
             ["--features_path", "f", "--pairs_path", "p", "--matches_path",
              "m", "--output_path", "out"],
             "bundle_adjuster": ["--input_path", "in", "--output_path",
                                 "out"],
             "triangulator": ["--features_path", "f", "--pairs_path", "p",
                              "--matches_path", "m", "--reference_model_path",
                              "ref", "--output_dir", "out"],
             "reconstructor": ["--features_path", "f", "--pairs_path", "p",
                               "--matches_path", "m", "--output_dir", "out"]}
    mod.main([command, *paths[command], "--image_dir", str(tmp_path),
              "--config_path", "default", "--device", "cpu",
              "mapping.BA.optimizer.solver.max_num_iterations=7"])
    assert len(built) == 1 and str(built[0].device) == "cpu"
    ka, ba = _strategies(built[0])
    want_ka, want_ba = _strategies(Default(device="cpu"))
    assert ka == want_ka
    assert ba[1]["optimizer"]["solver"]["max_num_iterations"] == 7
    ba[1]["optimizer"]["solver"]["max_num_iterations"] = \
        want_ba[1]["optimizer"]["solver"]["max_num_iterations"]
    assert ba == want_ba
