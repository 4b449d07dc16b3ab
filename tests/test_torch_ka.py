"""Port parity: featuremetric keypoint adjustment against the JAX package.

1. ``solve_ka_problems`` on the same ``KAProblems`` and the same float32
   packed patches: keypoints within 1e-3 px, costs within rtol 1e-4.
2. The constant-keypoint setup (``KeypointAdjustmentSetup``).
3. ``PixSfM.run_ka`` / ``refine_keypoints`` end to end on small images
   written to disk, with the S2DNet weights carried across: keypoints
   within 1e-3 px and costs
   within rtol 1e-4 with float32 feature storage; 1e-2 px and rtol 1e-3
   with bfloat16 storage (features that differ in their last float32 bits
   can round to neighbouring bf16 values, and the KA optimum moves with
   the features).
"""

from dataclasses import asdict

import flax
import jax
import numpy as np
import PIL.Image
import pytest

from pixsfm_tpu.base import solver_default_conf
from pixsfm_tpu.base.graph import (compute_root_labels, compute_score_labels,
                                   compute_track_labels)
from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.losses import RobustLoss as JLoss
from pixsfm_tpu.features.featuremaps import FeatureMap, FeatureSet, FeatureView
from pixsfm_tpu.keypoint_adjustment import KeypointAdjuster as JKA
from pixsfm_tpu.keypoint_adjustment import KeypointAdjustmentSetup as JSetup
from pixsfm_tpu.keypoint_adjustment import (build_matching_graph,
                                            find_problem_labels)
from pixsfm_tpu.keypoint_adjustment.solver import (build_ka_problems,
                                                   solve_ka_problems)
from pixsfm_tpu.ops.lm import LMOptions as JLMOptions
from pixsfm_tpu.refine_hloc import PixSfM as JaxPixSfM
from pixsfm_tpu.util.hloc import (read_keypoints_hloc, write_image_pairs,
                                  write_keypoints_hloc, write_matches_hloc)
from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
from pixsfm_tpu_torch.base.losses import RobustLoss
from pixsfm_tpu_torch.features import featuremaps as tfm
from pixsfm_tpu_torch.features.models.s2dnet import params_from_flax
from pixsfm_tpu_torch.keypoint_adjustment import main as tmain
from pixsfm_tpu_torch.keypoint_adjustment import solver as tsolver
from pixsfm_tpu_torch.ops.lm import LMOptions
from pixsfm_tpu_torch.refine_hloc import PixSfM


def smooth_field(H, W, C, seed, shift=(0.0, 0.0)):
    """Low-frequency random field: sum of random sinusoids per channel,
    sampled on the pixel grid moved by ``shift`` (x, y)."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(H) + shift[1], np.arange(W) + shift[0],
                       indexing="ij")
    field = np.zeros((H, W, C), np.float32)
    for c in range(C):
        for _ in range(4):
            fx, fy = rng.uniform(0.02, 0.12, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            field[..., c] += rng.uniform(0.3, 1.0) * (
                np.sin(2 * np.pi * fx * x + ph[0])
                * np.sin(2 * np.pi * fy * y + ph[1]))
    return field


def _field_scene(rng, names=("a.jpg", "b.jpg", "c.jpg"), ps=16, C=16,
                 n_kps=20):
    """Patches cut from one smooth feature field around perturbed keypoints
    (the first image's are exact). Returns (keypoints, per-image
    (patches, corners), identity matches)."""
    field = smooth_field(112, 112, C, seed=5)
    true_xy = rng.uniform(ps, 112 - ps, (n_kps, 2))
    keypoints, maps = {}, {}
    for i, name in enumerate(names):
        kps = true_xy + (rng.uniform(-1.2, 1.2, true_xy.shape) if i else 0)
        corners = np.floor(kps - ps / 2).astype(np.int64)
        maps[name] = (np.stack([field[cy:cy + ps, cx:cx + ps]
                                for cx, cy in corners]), corners)
        keypoints[name] = kps
    ident = np.stack([np.arange(n_kps)] * 2, axis=1)
    matches = {(a, b): ident for i, a in enumerate(names)
               for b in names[i + 1:]}
    return keypoints, maps, matches


def test_solve_ka_problems_matches_jax():
    keypoints, maps, matches = _field_scene(np.random.default_rng(5))
    fset = FeatureSet(channels=16, patch_size=16, dtype="float32")
    for name, (patches, corners) in maps.items():
        fset.emplace(name, FeatureMap.from_arrays(
            patches, list(range(len(patches))), corners, np.ones(2)))
    graph = build_matching_graph(matches)
    tracks = compute_track_labels(graph)
    roots = compute_root_labels(graph, tracks,
                                compute_score_labels(graph, tracks))
    # 7 tracks of 3 keypoints per problem: K = 24, N = 48 -> the CG path
    labels, _ = find_problem_labels(tracks, 21)
    labels = np.asarray(labels)
    packed = FeatureView.from_graph(fset, graph, np.nonzero(labels >= 0)[0],
                                    keypoints=keypoints).packed
    problems = build_ka_problems(keypoints, graph, labels, roots, packed,
                                 bound=4.0)
    assert problems.kp0.shape[:2] == (3, 24)

    solver_conf = dict(solver_default_conf)
    kp_j, sum_j = solve_ka_problems(
        problems, packed.patches, JInterp(), JLoss("cauchy", [0.25]),
        JLMOptions.from_solver_conf(solver_conf), chunk=2)
    kp_t, sum_t = tsolver.solve_ka_problems(
        tsolver.KAProblems(**asdict(problems)), packed.patches,
        InterpolationConfig(), RobustLoss("cauchy", [0.25]),
        LMOptions.from_solver_conf(solver_conf), chunk=2, device="cpu")
    valid = problems.kp_valid
    np.testing.assert_allclose(kp_t[valid], kp_j[valid], atol=1e-3)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(sum_t[k], sum_j[k], rtol=1e-4)
    assert sum_t["final_cost"] < sum_t["initial_cost"]
    assert sum_t["num_problems"] == sum_j["num_problems"]


class _Manager:
    def __init__(self, fset):
        self._fset = fset
        self.num_levels = 1

    def fset(self, level):
        return self._fset


def test_constant_image_stays_fixed():
    """KeypointAdjustmentSetup: the keypoints of a constant image do not
    move, and the rest match the JAX package (1e-3 px)."""
    keypoints, maps, matches = _field_scene(np.random.default_rng(6))
    jset = FeatureSet(channels=16, patch_size=16, dtype="float32")
    tset = tfm.FeatureSet(16, 16, "float32")
    for name, (patches, corners) in maps.items():
        ids = list(range(len(patches)))
        jset.emplace(name, FeatureMap.from_arrays(patches, ids, corners,
                                                  np.ones(2)))
        tset.emplace(name, tfm.FeatureMap.from_arrays(patches, ids, corners,
                                                      np.ones(2)))
    out = {}
    for pkg, fset in (("jax", jset), ("torch", tset)):
        kps = {k: v.copy() for k, v in keypoints.items()}
        if pkg == "jax":
            adj, setup = JKA.create(None), JSetup()
            graph = build_matching_graph(matches)
        else:
            adj = tmain.KeypointAdjuster.create(None, device="cpu")
            setup = tmain.KeypointAdjustmentSetup()
            graph = tmain.build_matching_graph(matches)
        setup.set_image_constant("b.jpg")
        adj.refine_multilevel(kps, _Manager(fset), graph,
                              problem_setup=setup)
        out[pkg] = kps
    # untouched up to the solver's float32 storage of the keypoints
    np.testing.assert_array_equal(out["torch"]["b.jpg"],
                                  keypoints["b.jpg"].astype(np.float32))
    for name in keypoints:
        np.testing.assert_allclose(out["torch"][name], out["jax"][name],
                                   atol=1e-3)
    # tied scores make the last image's keypoints the (frozen) roots, so
    # only the first image is free to move
    assert np.abs(out["torch"]["a.jpg"] - keypoints["a.jpg"]).max() > 0.1


def _write_scene(tmp_path, rng, n_images=3, n_kps=12, H=120, W=160):
    """Images of one smooth RGB texture under sub-pixel shifts; the
    keypoints of all but the first image are perturbed."""
    true_xy = rng.uniform(24, [W - 24, H - 24], (n_kps, 2))
    names, keypoints = [], {}
    for i in range(n_images):
        shift = np.array([1.7, 0.6]) * i
        tex = smooth_field(H, W, 3, seed=7, shift=shift)
        img = np.clip(127.5 + 60.0 * tex, 0, 255).astype(np.uint8)
        name = f"im{i}.png"
        PIL.Image.fromarray(img).save(tmp_path / name)
        kps = true_xy - shift
        if i:
            kps = kps + rng.normal(0, 0.7, kps.shape)
        names.append(name)
        keypoints[name] = kps
    ident = np.stack([np.arange(n_kps)] * 2, axis=1)
    matches = {(a, b): ident for i, a in enumerate(names)
               for b in names[i + 1:]}
    return keypoints, matches


def _pipelines(conf):
    """The JAX and the port's PixSfM, the JAX S2DNet weights carried over."""
    jsfm = JaxPixSfM(conf)
    tsfm = PixSfM(conf, device="cpu")
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(
        jsfm.extractor.model.variables))
    tsfm.extractor.model.load_state_dict(params_from_flax(variables))
    return jsfm, tsfm


@pytest.mark.parametrize("dtype,atol,rtol", [("float", 1e-3, 1e-4),
                                              ("half", 1e-2, 1e-3)])
def test_run_ka_matches_jax(tmp_path, dtype, atol, rtol):
    rng = np.random.default_rng(8)
    keypoints, matches = _write_scene(tmp_path, rng)
    jsfm, tsfm = _pipelines({"dense_features": {"dtype": dtype}})
    kp_j, out_j = jsfm.run_ka({k: v.copy() for k, v in keypoints.items()},
                              tmp_path, matches=matches)
    kp_t, out_t = tsfm.run_ka({k: v.copy() for k, v in keypoints.items()},
                              tmp_path, matches=matches)
    for name in keypoints:
        np.testing.assert_allclose(kp_t[name], kp_j[name], atol=atol)
        assert np.abs(kp_t[name] - keypoints[name]).max() <= 4.0 + 1e-4
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=rtol)
    assert out_t["final_cost"][0] < out_t["initial_cost"][0]


def test_refine_keypoints_hloc_files_match_jax(tmp_path):
    """``refine_keypoints`` through hloc feature/match/pair files (with the
    +-0.5 px shift): the written keypoints match the JAX package's to
    1e-3 px (float32 feature storage)."""
    keypoints, matches = _write_scene(tmp_path, np.random.default_rng(8))
    pairs = list(matches)
    feats, mfile, pfile = (tmp_path / "feats.h5", tmp_path / "matches.h5",
                           tmp_path / "pairs.txt")
    write_keypoints_hloc(feats, {n: k - 0.5 for n, k in keypoints.items()})
    write_matches_hloc(mfile, pairs, [matches[p] for p in pairs])
    write_image_pairs(pfile, pairs)
    jsfm, tsfm = _pipelines({"dense_features": {"dtype": "float"}})
    jsfm.refine_keypoints(tmp_path / "out_j.h5", feats, tmp_path, pfile,
                          mfile)
    kp_t, out_t = tsfm.refine_keypoints(tmp_path / "out_t.h5", feats,
                                        tmp_path, pfile, mfile)
    ref = read_keypoints_hloc(tmp_path / "out_j.h5")
    out = read_keypoints_hloc(tmp_path / "out_t.h5")
    assert set(out) == set(ref) == set(keypoints)
    for name in keypoints:
        np.testing.assert_allclose(out[name], ref[name], atol=1e-3)
        np.testing.assert_allclose(kp_t[name], out[name] + 0.5, atol=1e-9)
    assert out_t["final_cost"][0] < out_t["initial_cost"][0]
