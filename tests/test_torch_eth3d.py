"""Port parity: the ETH3D triangulation and localization harnesses of
``pixsfm_tpu_torch.eval.eth3d`` against the JAX package's on the CPU.

The scene and configs are ``tests/test_eval_harness.py``'s: 5 rendered
480x360 views of 50 points (``make_synthetic_scene``, seed 5), OpenCV SIFT
front end, raw grayscale features, topological_reference KA and geometric
BA. Limits: the same number of points, accuracy and completeness within
one point's share, mean reprojection error rtol 1e-3; the localization
harness localizes the same held-out query with a position error within
1e-4 of JAX's.

The localization config takes ``nearest`` references where
``tests/test_eval_harness.py`` takes ``robust_mean``: the robust mean of a
two-view track starts its Cauchy IRLS at the two descriptors' midpoint,
a stationary point between two minima, and float32 rounding decides which
observation it settles on (in either package; 37 of this scene's 136
references part so), and QBA on one-channel intensities follows them.
"""

import json

import numpy as np
import pytest

TOLERANCES = (0.05, 0.15, 0.3)

HARNESS_CONF = {
    "dense_features": {"model": {"name": "image", "grayscale": True},
                       "l2_normalize": False, "max_edge": 480,
                       "patch_size": 8, "dtype": "float32"},
    "interpolation": {"mode": "BICUBIC", "l2_normalize": False},
    "mapping": {
        "KA": {"strategy": "topological_reference",
               "optimizer": {"bound": 1.0,
                             "solver": {"max_num_iterations": 5}}},
        "BA": {"strategy": "geometric",
               "optimizer": {"refine_focal_length": False,
                             "refine_extra_params": False,
                             "solver": {"max_num_iterations": 15,
                                        "use_inner_iterations": False}}},
    },
}

LOC_CONF = {**HARNESS_CONF,
            "target_reference": "nearest",
            "references": {"iters": 10, "keep_observations": True},
            "QKA": {"apply": False},
            "QBA": {"apply": True,
                    "interpolation": {"mode": "BICUBIC",
                                      "l2_normalize": False},
                    "optimizer": {"solver": {"max_num_iterations": 10}}}}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    pytest.importorskip("cv2")
    from pixsfm_tpu_torch.eval.eth3d.synthetic import make_synthetic_scene
    root = tmp_path_factory.mktemp("eth3d")
    make_synthetic_scene(root / "synthetic_scene", n_images=5, n_points=50,
                         seed=5, width=480, height=360)
    return root


@pytest.fixture(scope="module")
def triangulated(scene):
    from pixsfm_tpu.eval.eth3d.triangulation import run_scene as jrun
    from pixsfm_tpu_torch.eval.eth3d.triangulation import run_scene as trun
    (scene / "out_j").mkdir()
    mj = jrun(scene / "synthetic_scene", scene / "out_j", conf=HARNESS_CONF,
              tolerances=TOLERANCES)
    stats = {}
    mt = trun(scene / "synthetic_scene", scene / "out_t", conf=HARNESS_CONF,
              tolerances=TOLERANCES, device="cpu", stats=stats)
    return mj, mt, stats


def test_run_scene_matches_jax(triangulated):
    mj, mt, _ = triangulated
    assert mt["num_points"] == mj["num_points"] >= 15
    n_gt = 50
    for key, share in (("accuracy", 100.0 / mj["num_points"]),
                       ("completeness", 100.0 / n_gt)):
        np.testing.assert_allclose(mt[key], mj[key], atol=share + 1e-9)
    np.testing.assert_allclose(mt["mean_reproj_error"],
                               mj["mean_reproj_error"], rtol=1e-3)
    assert mt["mean_reproj_error"] < 3.0 and mt["accuracy"][2] > 50.0


def test_run_scene_reports_stages_and_writes_results(scene, triangulated):
    _, mt, stats = triangulated
    for k in ("detection_s", "matching_s", "verification_s", "ka_s",
              "triangulation_s", "ba_s"):
        assert stats[k] >= 0.0, k
    assert stats["KA"]["final_cost"][0] <= stats["KA"]["initial_cost"][0]
    assert stats["BA"]["final_cost"][0] <= stats["BA"]["initial_cost"][0]
    assert json.loads((scene / "out_t" / "results.json").read_text()) == \
        pytest.approx(mt)
    assert (scene / "out_t" / "sparse" / "points3D.bin").exists()


def test_triangulation_cli_reads_results(scene, triangulated, capsys):
    """The CLI keeps a scene's results.json unless --overwrite, and prints
    the table (the scene directory is named as the CLI's --scenes)."""
    from pixsfm_tpu_torch.eval.eth3d.triangulation import format_results, main
    _, mt, _ = triangulated
    out = scene / "cli"
    (out / "synthetic_scene").mkdir(parents=True)
    (out / "synthetic_scene" / "results.json").write_text(json.dumps(mt))
    main(["--dataset_dir", str(scene), "--output_dir", str(out),
          "--scenes", "synthetic_scene", "--method", "sift",
          "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "synthetic_scene" in printed
    assert format_results({"synthetic_scene": mt}, [0.01, 0.02, 0.05]) \
        in printed


def test_run_scene_localization_matches_jax(scene):
    from pixsfm_tpu.eval.eth3d.localization import \
        run_scene_localization as jloc
    from pixsfm_tpu_torch.eval.eth3d.localization import \
        run_scene_localization as tloc
    rj = jloc(scene / "synthetic_scene", scene / "loc_j", conf=LOC_CONF,
              num_holdout=1, thresholds=(0.05, 0.15, 0.5))
    stats = {}
    rt = tloc(scene / "synthetic_scene", scene / "loc_t", conf=LOC_CONF,
              num_holdout=1, thresholds=(0.05, 0.15, 0.5), device="cpu",
              stats=stats)
    assert rt["queries"] == rj["queries"] and rt["num_queries"] == 1
    assert [e is None for e in rt["errors_m"]] == \
        [e is None for e in rj["errors_m"]]
    assert np.isfinite(rt["median_error_m"]) and rt["median_error_m"] < 0.5
    np.testing.assert_allclose(rt["median_error_m"], rj["median_error_m"],
                               atol=1e-4)
    for k in ("detection_s", "triangulation_s", "references_s",
              "localize_s"):
        assert stats[k] >= 0.0, k
    assert (scene / "loc_t" / "results_localization.json").exists()


