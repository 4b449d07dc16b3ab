"""Batch query localization (reference: pixsfm/localize.py).

Port of ``pixsfm_tpu/localize.py``: an hloc ``localize_sfm``-style loop that
gathers each query's 2D-3D correspondences from its retrieval pairs and
matches against a reference reconstruction, runs
:meth:`QueryLocalizer.localize` (QKA -> PnP -> QBA), and writes the poses
(``name qw qx qy qz tx ty tz`` per line) and a pickle of the results::

    python -m pixsfm_tpu_torch.localize --reference_sfm MODEL \\
        --queries Q.txt --features_path F.h5 --pairs_path P.txt \\
        --matches_path M.h5 --image_dir I --output_path POSES.txt \\
        [--config_path CONF] [--device cpu] [a.b=c ...]

``--device cpu`` runs the plain PyTorch versions of the kernels. The hloc
files need h5py; without it, call :func:`localize_queries` on decoded
arrays (``image_dir`` may map image names to ``[H, W, 3]`` uint8 arrays).
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import logger, resolve_device
from .base.cameras import Camera
from .config import OmegaConf, load_config
from .localization import QueryLocalizer
from .sfm.model import Reconstruction
from .util.hloc import read_image_pairs, read_keypoints_hloc, \
    read_matches_hloc

__all__ = ["main", "localize_queries", "write_poses_txt",
           "build_query_correspondences", "covisibility_clusters"]


def build_query_correspondences(reconstruction: Reconstruction,
                                query_name: str,
                                pairs: List[Tuple[str, str]],
                                matches: Dict[Tuple[str, str], np.ndarray]
                                ) -> Tuple[List[int], List[int]]:
    """2D-3D correspondences for a query from its retrieval pairs: query
    keypoint -> matched reference keypoint -> its 3D point."""
    p2D_idxs, p3D_ids = [], []
    for name1, name2 in pairs:
        if query_name not in (name1, name2):
            continue
        ref_name = name2 if name1 == query_name else name1
        ref_image = reconstruction.image_by_name(ref_name)
        if ref_image is None:
            continue
        m = matches.get((name1, name2))
        if m is None:
            m = matches.get((name2, name1))
            if m is None:
                continue
            m = np.flip(np.asarray(m), -1)
        m = np.asarray(m)
        if name1 != query_name:
            m = np.flip(m, -1)
        for q_idx, r_idx in m:
            if r_idx >= len(ref_image.point3D_ids):
                continue
            pid = ref_image.point3D_ids[r_idx]
            if pid >= 0:
                p2D_idxs.append(int(q_idx))
                p3D_ids.append(int(pid))
    return p2D_idxs, p3D_ids


def covisibility_clusters(reconstruction: Reconstruction, query_name: str,
                          pairs, matches) -> List[List[str]]:
    """Group a query's retrieved reference images into covisibility
    clusters: references that share 3D points form one cluster; PnP runs
    per cluster and the best wins."""
    refs = []
    for n1, n2 in pairs:
        if query_name in (n1, n2):
            other = n2 if n1 == query_name else n1
            if reconstruction.image_by_name(other) is not None:
                refs.append(other)
    refs = sorted(set(refs))
    if not refs:
        return []
    pid_sets = {}
    for name in refs:
        im = reconstruction.image_by_name(name)
        pid_sets[name] = set(int(p) for p in im.point3D_ids if p >= 0)
    parent = {n: n for n in refs}      # union-find over shared points

    def find(n):
        while parent[n] != n:
            parent[n] = parent[parent[n]]
            n = parent[n]
        return n

    for i, a in enumerate(refs):
        for b in refs[i + 1:]:
            if pid_sets[a] & pid_sets[b]:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
    clusters: Dict[str, List[str]] = {}
    for n in refs:
        clusters.setdefault(find(n), []).append(n)
    return sorted(clusters.values(), key=len, reverse=True)


def _query_image(image_dir, qname):
    """A query's image: its path under ``image_dir``, or its decoded array
    when ``image_dir`` maps names to arrays."""
    if image_dir is None:
        return None
    if isinstance(image_dir, Mapping):
        return image_dir[qname]
    return Path(image_dir) / qname


def localize_queries(localizer: QueryLocalizer,
                     queries: List[Tuple[str, Camera]],
                     keypoints: Dict[str, np.ndarray],
                     pairs: List[Tuple[str, str]],
                     matches: Dict[Tuple[str, str], np.ndarray],
                     image_dir=None,
                     covisibility_clustering: bool = False,
                     prefetch_depth: int = 2) -> Dict[str, Dict]:
    """Localize all queries, one at a time.

    Without clustering, the correspondences and the query's feature
    extraction run ``prefetch_depth`` queries ahead of QKA/PnP/QBA on a
    background thread (``util/prefetch.py``); ``prefetch_depth=0`` is the
    plain serial loop, which clustering always takes (its correspondences
    depend on the clusters). ``image_dir``: a directory or a ``{name:
    [H, W, 3] uint8}`` mapping."""
    results = {}
    require_feats = (localizer.conf.QKA.apply or localizer.conf.QBA.apply)

    if not covisibility_clustering:
        from .util.prefetch import prefetch_map

        def prepare(item):
            qname, qcam = item
            image = _query_image(image_dir, qname)
            p2D_idxs, p3D_ids = build_query_correspondences(
                localizer.reconstruction, qname, pairs, matches)
            fmaps = None
            if p2D_idxs and require_feats and image is not None:
                fmaps = localizer.extract_query_fmaps(
                    keypoints[qname], p2D_idxs, image)
            return qname, qcam, image, p2D_idxs, p3D_ids, fmaps

        for (qname, qcam, image, p2D_idxs, p3D_ids,
             fmaps) in prefetch_map(prepare, queries, depth=prefetch_depth):
            if not p2D_idxs:
                results[qname] = {"success": False}
                continue
            results[qname] = localizer.localize(
                keypoints[qname], p2D_idxs, p3D_ids, qcam,
                image_path=image, query_fmaps=fmaps)
        return results

    for qname, qcam in queries:
        image = _query_image(image_dir, qname)
        clusters = covisibility_clusters(localizer.reconstruction, qname,
                                         pairs, matches)
        best = {"success": False, "num_inliers": -1}
        for cluster in clusters:
            sub_pairs = [p for p in pairs
                         if qname in p and (p[0] in cluster
                                            or p[1] in cluster)]
            p2D_idxs, p3D_ids = build_query_correspondences(
                localizer.reconstruction, qname, sub_pairs, matches)
            if not p2D_idxs:
                continue
            pose = localizer.localize(keypoints[qname], p2D_idxs,
                                      p3D_ids, qcam, image_path=image)
            if pose.get("success") and \
                    pose.get("num_inliers", 0) > best["num_inliers"]:
                best = pose
        results[qname] = best if best["num_inliers"] >= 0 \
            else {"success": False}
    return results


def write_poses_txt(path, results: Dict[str, Dict]) -> None:
    with open(path, "w") as f:
        for name, pose in results.items():
            if not pose.get("success"):
                continue
            q = pose["qvec"]
            t = pose["tvec"]
            f.write(f"{name} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]}\n")


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="pixsfm_tpu_torch localization")
    parser.add_argument("--reference_sfm", type=Path, required=True)
    parser.add_argument("--queries", type=Path, required=True,
                        help="txt: name MODEL w h params... per line")
    parser.add_argument("--features_path", type=Path, required=True)
    parser.add_argument("--pairs_path", type=Path, required=True)
    parser.add_argument("--matches_path", type=Path, required=True)
    parser.add_argument("--image_dir", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)     # refuse before reading files

    conf = load_config(args.config_path, cli=args.dotlist) \
        if args.config_path else OmegaConf.from_dotlist(args.dotlist)
    rec = Reconstruction.read(args.reference_sfm)

    queries = []
    with open(args.queries) as f:
        for line in f:
            el = line.split()
            if not el:
                continue
            queries.append((el[0], Camera(
                -1, el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))))

    keypoints = read_keypoints_hloc(args.features_path)
    for k in keypoints:
        keypoints[k] = keypoints[k] + 0.5  # hloc -> COLMAP convention
    pairs = read_image_pairs(args.pairs_path)
    matches_list, _ = read_matches_hloc(args.matches_path, pairs)
    matches = {tuple(p): m for p, m in zip(pairs, matches_list)}

    localizer = QueryLocalizer(rec, conf=conf, image_dir=args.image_dir,
                               device=device)
    results = localize_queries(localizer, queries, keypoints, pairs, matches,
                               image_dir=args.image_dir)
    write_poses_txt(args.output_path, results)
    with open(str(args.output_path) + "_logs.pkl", "wb") as f:
        pickle.dump(results, f)
    n_ok = sum(1 for r in results.values() if r.get("success"))
    logger.info("Localized %d / %d queries.", n_ok, len(results))
    return results


if __name__ == "__main__":
    main()
