"""Port parity: the config registry and the ETH3D plot modules of
``pixsfm_tpu_torch`` against the JAX package's, on the CPU (the plots need
matplotlib, which the card's machine is not asked to have)."""

import json

import numpy as np
import pytest


def test_all_config_presets_load():
    """As ``tests/test_eval_utils.py::test_all_config_presets_load``, through
    the port's registry: the same preset names as the JAX package's, each
    loading and resolving its mapping / localization trees."""
    from pixsfm_tpu.configs import list_configs as jax_list
    from pixsfm_tpu_torch.config import load_config
    from pixsfm_tpu_torch.configs import list_configs, parse_config_path

    names = list_configs()
    assert names == jax_list()
    assert {"default", "low_memory", "norefine", "photometric",
            "pixsfm_eth3d", "pixsfm_eth3d_d2net", "dsift"} <= set(names)
    for name in names:
        conf = load_config(name)
        if "mapping" in conf:
            _ = conf.mapping.to_dict()
        if "localization" in conf:
            _ = conf.localization.to_dict()
        assert parse_config_path(name).stem == name
        assert parse_config_path(parse_config_path(name)).stem == name
    with pytest.raises(FileNotFoundError, match="available"):
        parse_config_path("no_such_preset")


def _write_localization_results(root):
    rng = np.random.default_rng(0)
    thresholds = [0.001, 0.01, 0.1]
    for method, scale in (("sift", 0.004), ("superpoint", 0.02)):
        for scene in ("courtyard", "kicker"):
            d = root / method / scene
            d.mkdir(parents=True)
            errs = np.abs(rng.normal(0, scale, 8)).tolist() + [None]
            (d / "results_localization.json").write_text(json.dumps(
                {"errors_m": errs, "thresholds": thresholds}))
    return thresholds


def test_plot_localization_matches_jax(tmp_path):
    """As ``tests/test_eval_tools.py::test_plot_localization_table_and_
    figure``: the collected errors, AUCs and table equal JAX's, and the
    figure and the CLI write their PNGs."""
    pytest.importorskip("matplotlib")
    from pixsfm_tpu.eval.eth3d import plot_localization as jplot
    from pixsfm_tpu_torch.eval.eth3d import plot_localization as tplot

    thresholds = _write_localization_results(tmp_path)
    methods = ["sift", "superpoint"]
    errors, aucs = tplot.collect(tmp_path, ["."], methods, thresholds)
    errors_j, aucs_j = jplot.collect(tmp_path, ["."], methods, thresholds)
    assert errors == errors_j and len(errors["sift"]["."]) == 18
    assert aucs == aucs_j
    table = tplot.format_results(aucs, thresholds)
    assert table == jplot.format_results(aucs_j, thresholds)
    assert "sift" in table and "superpoint" in table
    assert all(s >= p for s, p in
               zip(aucs["."]["sift"], aucs["."]["superpoint"]))
    tplot.plot_cumulative(errors, thresholds, path=tmp_path / "plot.png")
    assert (tmp_path / "plot.png").stat().st_size > 0
    tplot.main(["--results_dir", str(tmp_path), "--methods", *methods,
                "--thresholds", *map(str, thresholds)])
    assert (tmp_path / "eth3d_localization.png").stat().st_size > 0


def test_plot_triangulation_writes_figure(tmp_path):
    """The bar chart of ``results.json`` files (the JAX module has no test
    of its own): the CLI reads every scene directory and writes the PNG;
    an empty set of results raises as JAX's does."""
    pytest.importorskip("matplotlib")
    from pixsfm_tpu.eval.eth3d import plot_triangulation as jplot
    from pixsfm_tpu_torch.eval.eth3d import plot_triangulation as tplot

    for scene, acc in (("courtyard", [50.0, 70.0, 90.0]),
                       ("kicker", [40.0, 60.0, 80.0])):
        (tmp_path / scene).mkdir()
        (tmp_path / scene / "results.json").write_text(json.dumps(
            {"accuracy": acc, "completeness": [10.0, 20.0, 30.0]}))
    tplot.main(["--results_dir", str(tmp_path), "--metric", "completeness"])
    assert (tmp_path / "triangulation_completeness.png").stat().st_size > 0
    for mod in (tplot, jplot):
        with pytest.raises(ValueError, match="no results"):
            mod.plot_results({"s": {}}, path=tmp_path / "x.png")
