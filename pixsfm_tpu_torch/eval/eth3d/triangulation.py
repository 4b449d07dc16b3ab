"""ETH3D triangulation evaluation (reference: pixsfm/eval/eth3d/triangulation.py).

Port of ``pixsfm_tpu/eval/eth3d/triangulation.py``. Per scene: detection +
exhaustive matching (``features/detectors.py``) -> geometric verification
-> KA -> triangulation with the GT calibrated poses -> BA -> accuracy /
completeness against the GT scan (computed in-process; the reference
shells out to ETH3DMultiViewEvaluation). The scene must be present at
``--dataset_dir`` (nothing is downloaded). Runs on ``cuda`` unless
``--device cpu``::

    python -m pixsfm_tpu_torch.eval.eth3d.triangulation --dataset_dir D \\
        --output_dir O --method superpoint --config_path pixsfm_eth3d \\
        [--device cpu] [a.b=c ...]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ... import logger
from ...config import OmegaConf, load_config
from ...keypoint_adjustment import build_matching_graph
from ...refine_hloc import PixSfM
from ...sfm.model import Reconstruction
from ...sfm.triangulation import triangulate_reconstruction
from ...sfm.two_view import verify_all_pairs
from .config import SCENES, TRIANGULATION_TOLERANCES
from .utils import accuracy_completeness, read_ply_xyz

__all__ = ["detect_and_match", "run_scene", "main", "format_results"]


def detect_and_match(image_dir: Path, names: List[str], max_edge=1600,
                     n_features=8000, method: str = "sift", device=None,
                     stats: Optional[Dict] = None):
    """Front end of one scene: detection + exhaustive matching + geometric
    verification. ``method`` is one of ``config.METHODS`` /
    ``EXTRA_METHODS``; the learned ones run on ``device`` (``cuda`` unless
    ``"cpu"``). ``loftr`` is detector-free: matches come first and are
    aggregated into keypoints (reference eval config.py:90-92, :120-131:
    resize_max 1024, cell_size 1). ``stats``, when given, receives the
    stages' wall times (``detection_s`` and ``matching_s``, or LoFTR's
    ``matching_s``; ``verification_s``). Returns ``(kps, (matches,
    scores))``."""
    from ...features.detectors import detect_and_match_dir, match_loftr_dir

    stats = {} if stats is None else stats
    if method == "loftr":
        kps, matches, scores = match_loftr_dir(image_dir, names,
                                               max_edge=1024, device=device,
                                               stats=stats)
    else:
        kps, matches, scores = detect_and_match_dir(
            image_dir, names, method=method, max_edge=max_edge,
            n_features=n_features, device=device, stats=stats)
    t0 = time.time()
    verified = verify_all_pairs(matches, kps, scores)
    stats["verification_s"] = time.time() - t0
    stats["num_pairs"] = len(verified[0])
    return kps, verified


def run_scene(scene_dir: Path, output_dir: Path, conf=None,
              tolerances=TRIANGULATION_TOLERANCES,
              method: str = "sift", device=None,
              stats: Optional[Dict] = None) -> Optional[Dict]:
    """Expects the COLMAP GT model at ``scene_dir/dslr_calibration_
    undistorted`` and the GT scan (PLY) under ``scene_dir`` (ETH3D
    layout). Returns the metrics written to ``results.json``; ``stats``,
    when given, receives the stage times (``*_s``) and the KA and BA
    summaries."""
    scene_dir, output_dir = Path(scene_dir), Path(output_dir)
    gt_model_dir = scene_dir / "dslr_calibration_undistorted"
    image_dir = scene_dir / "images"
    if not gt_model_dir.exists() or not image_dir.exists():
        logger.warning("scene %s incomplete; skipping", scene_dir.name)
        return None
    stats = {} if stats is None else stats

    gt = Reconstruction.read(gt_model_dir)
    names = sorted(im.name for im in gt.images.values())
    sfm = PixSfM(conf, device=device)
    kps, (matches, scores) = detect_and_match(
        image_dir, names, method=method, device=sfm.device, stats=stats)

    graph = build_matching_graph(matches, scores)
    t0 = time.time()
    keypoints, stats["KA"] = sfm.run_ka(kps, image_dir, graph=graph)
    stats["ka_s"] = time.time() - t0
    t0 = time.time()
    rec = triangulate_reconstruction(gt, graph, keypoints,
                                     device=sfm.device)
    stats["triangulation_s"] = time.time() - t0
    t0 = time.time()
    stats["BA"] = sfm.run_ba(rec, image_dir)
    stats["ba_s"] = time.time() - t0
    output_dir.mkdir(parents=True, exist_ok=True)
    rec.write(output_dir / "sparse")

    plys = list(scene_dir.glob("*.ply"))
    if (scene_dir / "scan").exists():
        plys += list((scene_dir / "scan").glob("*.ply"))
    if not plys:
        logger.warning("no GT scan PLY for %s; geometric metrics only",
                       scene_dir.name)
        metrics = {}
    else:
        gt_cloud = np.concatenate([read_ply_xyz(p) for p in plys])
        pts = np.stack([p.xyz for p in rec.points3D.values()]) \
            if rec.points3D else np.zeros((0, 3))
        metrics = accuracy_completeness(pts, gt_cloud, tolerances)
    metrics["num_points"] = len(rec.points3D)
    metrics["mean_reproj_error"] = rec.mean_reprojection_error()
    with open(output_dir / "results.json", "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def format_results(results: Dict[str, Dict], tolerances) -> str:
    lines = ["scene".ljust(16) + "  accuracy@" +
             "/".join(f"{t * 100:.0f}cm" for t in tolerances)
             + "   completeness"]
    for scene, m in results.items():
        if not m or "accuracy" not in m:
            continue
        acc = " / ".join(f"{v:6.2f}" for v in m["accuracy"])
        com = " / ".join(f"{v:6.2f}" for v in m["completeness"])
        lines.append(f"{scene.ljust(16)}  {acc}   {com}")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", type=Path, required=True)
    parser.add_argument("--output_dir", type=Path, required=True)
    parser.add_argument("--scenes", nargs="*", default=SCENES)
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--method", default="sift",
                        help="detector/matcher front end (config.METHODS)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_args(argv)

    conf = load_config(args.config_path, cli=args.dotlist) \
        if args.config_path else OmegaConf.from_dotlist(args.dotlist)
    results = {}
    for scene in args.scenes:
        out = args.output_dir / scene
        out.mkdir(parents=True, exist_ok=True)
        res_file = out / "results.json"
        if res_file.exists() and not args.overwrite:
            results[scene] = json.loads(res_file.read_text())
            continue
        results[scene] = run_scene(args.dataset_dir / scene, out, conf,
                                   method=args.method, device=args.device)
    print(format_results(results, TRIANGULATION_TOLERANCES))


if __name__ == "__main__":
    main()
