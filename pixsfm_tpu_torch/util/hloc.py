"""hloc-format feature/match IO (reference: pixsfm/util/hloc.py).

Same on-disk conventions: per-image groups with a ``keypoints`` dataset; match
files with ``matches0``/``matching_scores0`` under ``name1/name2`` (or the
reversed pair); pair lists as whitespace-separated text.

Copy of ``pixsfm_tpu/util/hloc.py`` with ``h5py`` imported where a file is
opened, so the package imports without it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "list_h5_names", "read_image_pairs", "write_image_pairs",
    "read_keypoints_hloc", "write_keypoints_hloc", "read_matches_hloc",
    "write_matches_hloc",
]


def list_h5_names(path) -> List[str]:
    import h5py
    names = []
    with h5py.File(str(path), "r") as fd:
        def visit(_, obj):
            if isinstance(obj, h5py.Dataset):
                names.append(obj.parent.name.strip("/"))
        fd.visititems(visit)
    return list(set(names))


def read_image_pairs(path) -> List[Tuple[str, str]]:
    with open(path, "r") as f:
        return [tuple(p.split()) for p in f.read().rstrip("\n").split("\n")
                if p.strip()]


def write_image_pairs(path, pairs) -> None:
    with open(path, "w") as f:
        f.write("\n".join(" ".join(p) for p in pairs))


def read_keypoints_hloc(path, names: Optional[List[str]] = None
                        ) -> Dict[str, np.ndarray]:
    import h5py
    out: Dict[str, np.ndarray] = {}
    if names is None:
        names = list_h5_names(path)
    with h5py.File(str(path), "r") as f:
        for name in names:
            out[name] = f[name]["keypoints"][...][:, :2].astype(np.float64)
    return out


def write_keypoints_hloc(path, keypoints: Dict[str, np.ndarray]) -> None:
    import h5py
    with h5py.File(str(path), "w") as f:
        for name, kps in keypoints.items():
            f.create_group(name).create_dataset("keypoints", data=kps)


def _pair_key(f, name1: str, name2: str):
    for key, reverse in ((f"{name1}/{name2}", False),
                         (f"{name2}/{name1}", True)):
        if key in f:
            return key, reverse
    raise KeyError(f"pair ({name1}, {name2}) not found")


def read_matches_hloc(path, pairs) -> Tuple[List[np.ndarray],
                                            List[np.ndarray]]:
    import h5py
    matches, scores = [], []
    with h5py.File(str(path), "r") as f:
        for name1, name2 in pairs:
            key, reverse = _pair_key(f, name1, name2)
            m0 = f[key]["matches0"][...]
            idx = np.where(m0 != -1)[0]
            m = np.stack([idx, m0[idx]], -1).astype(np.int64)
            if "matching_scores0" in f[key]:
                s = f[key]["matching_scores0"][...][idx].astype(np.float32)
            else:
                s = np.ones(len(idx), np.float32)
            if reverse:
                m = np.flip(m, -1)
            matches.append(m)
            scores.append(s)
    return matches, scores


def write_matches_hloc(path, pairs, matches,
                       scores: Optional[List[np.ndarray]] = None) -> None:
    """Write matches in hloc's ``matches0`` / ``matching_scores0`` format,
    one group ``name1/name2`` per pair (scores 1 where none are given)."""
    import h5py
    with h5py.File(str(path), "w") as f:
        for i, (name1, name2) in enumerate(pairs):
            g = f.create_group(f"{name1}/{name2}")
            m = np.asarray(matches[i])
            n_kp1 = int(m[:, 0].max()) + 1 if len(m) else 0
            m0 = np.full(n_kp1, -1, np.int64)
            s0 = np.zeros(n_kp1, np.float32)
            m0[m[:, 0]] = m[:, 1]
            if scores is not None and len(scores[i]):
                s0[m[:, 0]] = scores[i]
            else:
                s0[m[:, 0]] = 1.0
            g.create_dataset("matches0", data=m0)
            g.create_dataset("matching_scores0", data=s0)
