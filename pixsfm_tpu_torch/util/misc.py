"""Misc helpers (reference: pixsfm/util/misc.py); copy of ``pixsfm_tpu/util/misc.py``."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import logger

__all__ = ["check_memory", "free_memory", "total_memory",
           "resolve_level_indices", "to_colmap_coordinates",
           "to_hloc_coordinates", "to_ctr", "progress_iter", "bucket"]


def total_memory() -> int:
    """Physical memory of the host in bytes (0 where unknown)."""
    try:
        import os
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 0


def free_memory() -> int:
    """Available host memory in bytes (``MemAvailable``; 0 where unknown)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def check_memory(req_memory, gap=2 ** 30) -> None:
    """Warn before likely-OOM extractions (reference: util/misc.py:10-16)."""
    if req_memory != req_memory:  # nan
        logger.info("Invalid memory estimate. Continue.")
    elif req_memory + gap > free_memory():
        logger.warning(
            "Required memory [%dMB] might exceed free memory [%dMB].",
            req_memory / 2 ** 20, free_memory() / 2 ** 20)


def resolve_level_indices(level_indices, n_levels):
    if level_indices not in (None, "all"):
        return level_indices
    return list(reversed(range(n_levels)))


def to_colmap_coordinates(keypoints: Dict[str, np.ndarray]) -> None:
    """hloc corner-origin -> COLMAP pixel-center convention (+0.5 px;
    reference: util/misc.py:39-41)."""
    for name in keypoints:
        keypoints[name] = keypoints[name] + 0.5


def to_hloc_coordinates(keypoints: Dict[str, np.ndarray]) -> None:
    for name in keypoints:
        keypoints[name] = keypoints[name] - 0.5


def to_ctr(conf, resolve: bool = True):
    if hasattr(conf, "to_dict"):
        return conf.to_dict(resolve=resolve)
    return dict(conf)


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


def bucket(n: int, minimum: int = 8) -> int:
    """Next power of two >= n (>= minimum); copy of the JAX package's
    ``util/jit_cache.py:bucket``, which sizes BA problems and tracks."""
    n = max(int(n), 1)
    return max(1 << int(np.ceil(np.log2(n))), minimum)
