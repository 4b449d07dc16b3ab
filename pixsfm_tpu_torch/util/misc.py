"""Misc helpers (reference: pixsfm/util/misc.py); copy of ``pixsfm_tpu/util/misc.py``."""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["to_colmap_coordinates", "to_hloc_coordinates", "progress_iter"]


def to_colmap_coordinates(keypoints: Dict[str, np.ndarray]) -> None:
    """hloc corner-origin -> COLMAP pixel-center convention (+0.5 px;
    reference: util/misc.py:39-41)."""
    for name in keypoints:
        keypoints[name] = keypoints[name] + 0.5


def to_hloc_coordinates(keypoints: Dict[str, np.ndarray]) -> None:
    for name in keypoints:
        keypoints[name] = keypoints[name] - 0.5


def progress_iter(iterable, desc: str = "", total=None, min_items: int = 20):
    """tqdm progress over long host loops (extraction, packing); passthrough
    for short ones so logs stay quiet (reference uses its own LogProgressbar,
    util/src/log_exceptions.h / progressbar in the python pipelines)."""
    try:
        n = total if total is not None else len(iterable)
    except TypeError:
        n = None
    if n is not None and n < min_items:
        return iterable
    try:
        from tqdm import tqdm
        return tqdm(iterable, desc=desc, total=n, leave=False)
    except ImportError:
        return iterable
