"""Timing / profiling utilities (reference: SURVEY.md §5.1 — colmap::Timer
around parallel solves + Ceres Solver::Summary as the profiling surface).

Copy of ``pixsfm_tpu/util/profiling.py``: wall-clock timers and merged
solver summaries as there; ``trace(...)`` records a ``torch.profiler``
trace instead of the JAX device profile (a Chrome trace, with the CUDA
activity when a GPU is present).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import logger

__all__ = ["Timer", "trace", "SolverSummary", "merge_summaries"]


class Timer:
    """Wall-clock timer with pause/resume (colmap::Timer-style)."""

    def __init__(self, start: bool = False):
        self._elapsed = 0.0
        self._t0: Optional[float] = None
        if start:
            self.start()

    def start(self):
        if self._t0 is None:
            self._t0 = time.time()
        return self

    def pause(self):
        if self._t0 is not None:
            self._elapsed += time.time() - self._t0
            self._t0 = None
        return self

    def restart(self):
        self._elapsed = 0.0
        self._t0 = time.time()
        return self

    @property
    def elapsed_seconds(self) -> float:
        cur = time.time() - self._t0 if self._t0 is not None else 0.0
        return self._elapsed + cur

    def print(self, label: str = ""):
        logger.info("%s time: %.4fs", label or "Elapsed",
                    self.elapsed_seconds)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.pause()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.json``, open it in ``chrome://tracing`` or Perfetto) under
    ``logdir``; the CUDA activity is recorded when a GPU is present. With
    ``None`` nothing is recorded."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logger.info("Wrote device trace to %s", path)


@dataclass
class SolverSummary:
    """Merged LM statistics (reference: util/src/statistics.h:14-60 merges
    per-subproblem Ceres summaries into one report)."""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    num_problems: int = 0
    iterations: int = 0
    time_s: float = 0.0
    num_residual_evaluations: int = 0
    extra: Dict = field(default_factory=dict)

    def report(self) -> str:
        dc = self.initial_cost - self.final_cost
        rel = dc / self.initial_cost * 100 if self.initial_cost else 0.0
        return (f"problems: {self.num_problems}, cost: "
                f"{self.initial_cost:.6g} -> {self.final_cost:.6g} "
                f"(-{rel:.2f}%), iters: {self.iterations}, "
                f"time: {self.time_s:.3f}s")


def merge_summaries(summaries: List[Dict]) -> SolverSummary:
    out = SolverSummary()
    for s in summaries:
        out.initial_cost += float(s.get("initial_cost", 0.0))
        out.final_cost += float(s.get("final_cost", 0.0))
        out.num_problems += int(s.get("num_problems", 0))
        out.iterations = max(out.iterations, int(s.get("iterations", 0)))
        out.time_s += float(s.get("time", 0.0))
    return out
