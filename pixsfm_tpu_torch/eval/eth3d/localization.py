"""ETH3D localization evaluation (reference: pixsfm/eval/eth3d/localization.py).

Port of ``pixsfm_tpu/eval/eth3d/localization.py``. Leave-N-out protocol
per scene: rebuild the reference model without N held-out query images,
match each query against the remaining images, run ``QueryLocalizer``
(QKA -> PnP -> QBA), and report the AUC of the position error at {0.1, 1,
10} cm against the GT poses. Runs on ``cuda`` unless ``--device cpu``::

    python -m pixsfm_tpu_torch.eval.eth3d.localization --dataset_dir D \\
        --output_dir O --method superpoint --config_path pixsfm_eth3d \\
        [--device cpu] [a.b=c ...]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ... import logger, resolve_device
from ...base.geometry import quat_to_rotmat_np
from ...config import OmegaConf, load_config
from ...keypoint_adjustment import build_matching_graph
from ...localization import QueryLocalizer
from ...localize import build_query_correspondences
from ...sfm.model import Reconstruction
from ...sfm.triangulation import triangulate_reconstruction
from .config import LOCALIZATION_THRESHOLDS, NUM_HOLDOUT_IMAGES, SCENES
from .triangulation import detect_and_match
from .utils import pose_auc

__all__ = ["run_scene_localization", "main"]


def run_scene_localization(scene_dir: Path, output_dir: Path, conf=None,
                           num_holdout=NUM_HOLDOUT_IMAGES,
                           thresholds=LOCALIZATION_THRESHOLDS,
                           method: str = "sift", device=None,
                           stats: Optional[Dict] = None) -> Optional[Dict]:
    """Returns the result written to ``results_localization.json``;
    ``stats``, when given, receives the stage times (``*_s``: the front
    end's, the map's triangulation, the localizer's references, and
    ``localize_s`` over all queries)."""
    scene_dir, output_dir = Path(scene_dir), Path(output_dir)
    gt_model_dir = scene_dir / "dslr_calibration_undistorted"
    image_dir = scene_dir / "images"
    if not gt_model_dir.exists() or not image_dir.exists():
        logger.warning("scene %s incomplete; skipping", scene_dir.name)
        return None
    stats = {} if stats is None else stats
    dev = resolve_device(device)

    gt = Reconstruction.read(gt_model_dir)
    names = sorted(im.name for im in gt.images.values())
    rng = np.random.default_rng(0)
    queries = sorted(rng.choice(names, min(num_holdout, len(names) // 2),
                                replace=False).tolist())
    mapping = [n for n in names if n not in queries]

    kps, (matches, scores) = detect_and_match(image_dir, names,
                                              method=method, device=dev,
                                              stats=stats)

    # reference model without the queries
    t0 = time.time()
    map_matches = {k: v for k, v in matches.items()
                   if k[0] in mapping and k[1] in mapping}
    map_scores = {k: scores[k] for k in map_matches}
    graph = build_matching_graph(map_matches, map_scores)
    gt_map = gt.copy()
    for im in list(gt_map.images.values()):
        if im.name in queries:
            del gt_map.images[im.image_id]
    rec = triangulate_reconstruction(gt_map, graph, kps, device=dev)
    stats["triangulation_s"] = time.time() - t0

    t0 = time.time()
    loc_conf = dict(conf.to_dict() if hasattr(conf, "to_dict")
                    else (conf or {}))
    localizer = QueryLocalizer(rec, conf=loc_conf, image_dir=image_dir,
                               device=dev)
    stats["references_s"] = time.time() - t0

    errors = []
    pair_list = list(matches.keys())
    t0 = time.time()
    for qname in queries:
        gt_im = gt.image_by_name(qname)
        qcam = gt.cameras[gt_im.camera_id]
        p2D_idxs, p3D_ids = build_query_correspondences(
            rec, qname, pair_list, matches)
        if not p2D_idxs:
            errors.append(np.inf)
            continue
        pose = localizer.localize(kps[qname], p2D_idxs, p3D_ids, qcam,
                                  image_path=image_dir / qname)
        if not pose.get("success"):
            errors.append(np.inf)
            continue
        # position error
        R = quat_to_rotmat_np(pose["qvec"] / np.linalg.norm(pose["qvec"]))
        c_est = -R.T @ pose["tvec"]
        errors.append(float(np.linalg.norm(c_est
                                           - gt_im.projection_center())))
    stats["localize_s"] = time.time() - t0

    aucs = pose_auc([e for e in errors], thresholds)
    result = {"auc": aucs, "thresholds": list(thresholds),
              "median_error_m": float(np.median(
                  [e for e in errors if np.isfinite(e)] or [np.inf])),
              "num_queries": len(queries),
              # per-query errors, for the cumulative-recall plots
              "queries": list(queries),
              "errors_m": [e if np.isfinite(e) else None for e in errors]}
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "results_localization.json", "w") as f:
        json.dump(result, f, indent=2)
    return result


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
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_args(argv)

    conf = load_config(args.config_path, cli=args.dotlist) \
        if args.config_path else OmegaConf.from_dotlist(args.dotlist)
    for scene in args.scenes:
        res = run_scene_localization(args.dataset_dir / scene,
                                     args.output_dir / scene, conf,
                                     method=args.method, device=args.device)
        if res:
            print(scene, "AUC@{0.1,1,10}cm:",
                  " / ".join(f"{a:.2f}" for a in res["auc"]))


if __name__ == "__main__":
    main()
