"""The native graph core (``graph_core.cpp``), built at first use.

Port of ``pixsfm_tpu/native/__init__.py``. The C++ source (union-find track
labels, score and root labels, FFD bin packing) is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` into ``_build/libgraph_core-<hash>.so``
(the hash is of the source and the flags, so an edited source is rebuilt)
the first time a function here is called, and loaded with ``ctypes``, as
``kernels/__init__.py`` does for ``nvcc``. Nothing is built when the package
is imported. A failed build raises with the compiler's output; there is no
quiet fallback. ``base/graph.py`` keeps the numpy versions as the plain
versions the tests hold this core to.

``lib`` (the loaded ``ctypes`` library) and ``available()`` are the JAX
package's names: reading ``lib`` or calling ``available()`` builds the
core if needed, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["SOURCE", "BUILD_DIR", "CXX_FLAGS", "build", "load", "lib",
           "available", "compute_track_labels_native",
           "compute_score_labels_native", "compute_root_labels_native",
           "ffd_bin_packing_native"]

SOURCE = Path(__file__).parent / "graph_core.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target(source: Path, build_dir: Path) -> Path:
    h = hashlib.sha256(source.read_bytes() if source.is_file() else b"")
    h.update(" ".join(CXX_FLAGS).encode())
    return build_dir / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source=SOURCE, build_dir=BUILD_DIR, cxx: str = "g++") -> Path:
    """Compile ``source`` with ``cxx`` unless its library exists; returns
    the library path. Raises RuntimeError with the compiler's output when
    the build fails."""
    source, build_dir = Path(source), Path(build_dir)
    out = _target(source, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx!r} to build {source.name}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded graph core, building it if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.psf_compute_track_labels.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, i64p, i64p]
        lib.psf_compute_track_labels.restype = None
        lib.psf_compute_score_labels.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, i64p, f64p]
        lib.psf_compute_score_labels.restype = None
        lib.psf_compute_root_labels.argtypes = [
            ctypes.c_int64, i64p, f64p, u8p]
        lib.psf_compute_root_labels.restype = None
        lib.psf_ffd_bin_packing.argtypes = [
            ctypes.c_int64, i64p, ctypes.c_int64, i64p]
        lib.psf_ffd_bin_packing.restype = ctypes.c_int64
        _lib = lib
        return lib


def available() -> bool:
    """True once the core is built and loaded; a failed build raises (the
    port has no numpy fallback on the main path)."""
    load()
    return True


def __getattr__(name):
    # ``lib`` is loaded on first access, so importing the package runs no
    # compiler
    if name == "lib":
        return load()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _edges(src, dst, sim, n_nodes: int):
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    sim = np.ascontiguousarray(sim, np.float64)
    if not (len(src) == len(dst) == len(sim)):
        raise ValueError("src, dst and sim differ in length")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError("edge endpoint outside the node range")
    return src, dst, sim


def compute_track_labels_native(src, dst, sim, node_image_ids) -> np.ndarray:
    ids = np.ascontiguousarray(node_image_ids, np.int64)
    n_nodes = len(ids)
    src, dst, sim = _edges(src, dst, sim, n_nodes)
    out = np.empty(n_nodes, np.int64)
    load().psf_compute_track_labels(n_nodes, len(src), _p64(src), _p64(dst),
                                    _pf64(sim), _p64(ids), _p64(out))
    return out


def compute_score_labels_native(n_nodes, src, dst, sim,
                                track_labels) -> np.ndarray:
    n_nodes = int(n_nodes)
    src, dst, sim = _edges(src, dst, sim, n_nodes)
    tl = np.ascontiguousarray(track_labels, np.int64)
    if len(tl) != n_nodes:
        raise ValueError("one track label per node expected")
    out = np.zeros(n_nodes, np.float64)
    load().psf_compute_score_labels(n_nodes, len(src), _p64(src), _p64(dst),
                                    _pf64(sim), _p64(tl), _pf64(out))
    return out


def compute_root_labels_native(track_labels, scores) -> np.ndarray:
    tl = np.ascontiguousarray(track_labels, np.int64)
    sc = np.ascontiguousarray(scores, np.float64)
    if len(tl) != len(sc) or (len(tl) and tl.min() < 0):
        raise ValueError("one non-negative track label per score expected")
    out = np.zeros(len(tl), np.uint8)
    load().psf_compute_root_labels(
        len(tl), _p64(tl), _pf64(sc),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def ffd_bin_packing_native(track_counts, max_per_problem):
    """(track -> problem labels, number of problems) of first-fit-decreasing
    packing of per-track counts into problems of at most
    ``max_per_problem``."""
    tc = np.ascontiguousarray(track_counts, np.int64)
    out = np.empty(len(tc), np.int64)
    n_bins = load().psf_ffd_bin_packing(len(tc), _p64(tc),
                                        int(max_per_problem), _p64(out))
    return out, int(n_bins)
