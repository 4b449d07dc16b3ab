"""ETH3D eval utilities (reference: pixsfm/eval/eth3d/utils.py + the external
ETH3DMultiViewEvaluation binary, reimplemented here as point-cloud metrics).

A copy of ``pixsfm_tpu/eval/eth3d/utils.py`` (numpy and scipy only)."""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["create_list_files", "accuracy_completeness", "pose_auc",
           "read_ply_xyz"]

# numpy >= 2 names it trapezoid, numpy 1 trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def create_list_files(image_names: Sequence[str], output_path) -> None:
    """Exhaustive pair list (reference: utils.py:61-69)."""
    with open(output_path, "w") as f:
        f.write("\n".join(f"{a} {b}"
                          for a, b in combinations(sorted(image_names), 2)))


def read_ply_xyz(path) -> np.ndarray:
    """Minimal PLY reader (ascii + binary_little_endian) returning Nx3 xyz."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = next(int(l.split()[2]) for l in header
                 if l.startswith("element vertex"))
        props = [l.split() for l in header if l.startswith("property")
                 and "list" not in l]
        names = [p[2] for p in props]
        types = [p[1] for p in props]
        tmap = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
                "short": "<i2", "ushort": "<u2"}
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, cols].astype(np.float64)
        dtype = np.dtype([(nm, tmap[t]) for nm, t in zip(names, types)])
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float64)


def accuracy_completeness(reconstructed: np.ndarray, ground_truth: np.ndarray,
                          tolerances: Sequence[float]) -> Dict[str, List[float]]:
    """Accuracy: % of reconstructed points within tol of the GT cloud;
    completeness: % of GT points within tol of the reconstruction — the
    ETH3DMultiViewEvaluation metrics over point sets."""
    from scipy.spatial import cKDTree

    out = {"accuracy": [], "completeness": []}
    if len(reconstructed) == 0 or len(ground_truth) == 0:
        out["accuracy"] = [0.0] * len(tolerances)
        out["completeness"] = [0.0] * len(tolerances)
        return out
    gt_tree = cKDTree(ground_truth)
    rc_tree = cKDTree(reconstructed)
    d_rec, _ = gt_tree.query(reconstructed, k=1)
    d_gt, _ = rc_tree.query(ground_truth, k=1)
    for tol in tolerances:
        out["accuracy"].append(float(np.mean(d_rec <= tol) * 100.0))
        out["completeness"].append(float(np.mean(d_gt <= tol) * 100.0))
    return out


def pose_auc(errors: Sequence[float], thresholds: Sequence[float]
             ) -> List[float]:
    """AUC of the cumulative pose-error curve at each threshold (the reference
    localization metric, eval/eth3d/localization.py)."""
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / max(len(errors), 1)
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last], [recall[min(last, len(recall))
                                                   - 1]]])
        e = np.concatenate([errors[:last], [t]])
        aucs.append(float(_trapezoid(r, x=e) / t * 100.0))
    return aucs
