"""Timing / profiling utilities (reference: SURVEY.md §5.1 — colmap::Timer
around parallel solves + Ceres Solver::Summary as the profiling surface).

Copy of ``pixsfm_tpu/util/profiling.py``: wall-clock timers and merged
solver summaries as there; ``trace(...)`` records a ``torch.profiler``
trace instead of the JAX device profile (a Chrome trace, with the CUDA
activity when a GPU is present).

Beside them, the program's span and counter recorder. The program opens a
``span(name)`` at each stage boundary (``run_ba`` > ``extract`` /
``ba`` > ``ba.level`` > ``ba.pack``, ``ba.references``, ``ba.layout``,
``ba.lm`` > ``ba.lm.iter`` > ...) and counts, under ``sync.<site>``, each
point where the host waits for a GPU, at the call that waits: a read to the
host through :func:`host`, a copy from host memory through
:func:`to_device`, any other blocking call through :func:`count_on` on the
line before it. A counter belongs to the innermost open span, so the span
tells which layer waited. The recorder records while ``torch.profiler``
records, and only then: a profile of the program carries its spans and
counters, and otherwise a span is one check of the profiler's state (a
``timed`` span also reads the clock twice, for the summaries' times) and a
count does nothing. Recording, each span keeps its name, id, parent's id,
job id (a span opened while none is open starts a job: each ``run_ba`` /
``run_ka`` call is one) and its start and end in ``time.time_ns()``, the
clock of ``torch.profiler``'s events. A profiler session starts a new
recording at its first span, count or ``recorded()``; ``recorded()`` reads
it during the session and after it, until the next session or
``clear_recorded()`` (a session in which the program opens no span between
two others adds to the first one's recording). Spans never synchronize the
device: its time comes from the device trace (``trace(logdir)`` writes both
on one timeline).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .. import logger

__all__ = ["Timer", "trace", "SolverSummary", "merge_summaries", "Span",
           "Recording", "span", "count", "count_on", "host", "to_device",
           "recorded", "clear_recorded"]


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


# -- the span and counter recorder ------------------------------------------

@dataclass
class Span:
    """One closed span: ``start_ns`` / ``end_ns`` in ``time.time_ns()``;
    ``parent`` is the id of the span it was opened in (None for a job's
    root), ``job`` the id of its job."""
    name: str
    id: int
    parent: Optional[int]
    job: int
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Recording:
    """What the recorder holds: the closed spans in the order they closed,
    and the counters under ``(job, innermost open span's id, name)`` (both
    None where no span was open)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[Tuple[Optional[int], Optional[int], str],
                            float] = defaultdict(float)
        self._open: List[Tuple[int, int]] = []     # (span id, job id)
        self._ids = itertools.count(1)
        self._jobs = itertools.count(1)

    def seconds(self, name: str) -> float:
        """The summed duration of the spans called ``name``."""
        return sum(s.seconds for s in self.spans if s.name == name)

    def self_seconds(self, span: Span) -> float:
        """``span``'s duration less its children's."""
        return span.seconds - sum(s.seconds for s in self.spans
                                  if s.parent == span.id)

    def counts(self, prefix: str = "",
               within: Optional[str] = None) -> Dict[str, float]:
        """The counters whose names start with ``prefix``, summed over
        jobs and spans; with ``within``, only those counted inside a
        closed span called ``within``."""
        by_id = {s.id: s for s in self.spans}

        def inside(sid):
            while sid in by_id:
                if by_id[sid].name == within:
                    return True
                sid = by_id[sid].parent
            return False

        out: Dict[str, float] = defaultdict(float)
        for (_, sid, name), n in self.counters.items():
            if name.startswith(prefix) and (within is None or inside(sid)):
                out[name] += n
        return dict(out)


_last = Recording()     # the current or last profiler session's recording
_profiling = False      # whether torch.profiler recorded at the last look


def _recording() -> Optional[Recording]:
    """Where spans and counters go now: the recording while
    ``torch.profiler`` records (a new one at a session's first look), else
    None."""
    global _last, _profiling
    on = torch.autograd._profiler_enabled()
    if on and not _profiling:
        _last = Recording()
    _profiling = on
    return _last if on else None


class _Span:
    """The context manager of a recorded or ``timed`` span."""
    __slots__ = ("name", "rec", "id", "start_ns", "end_ns")

    def __init__(self, name: str, rec: Optional[Recording]):
        self.name, self.rec = name, rec

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            job = rec._open[-1][1] if rec._open else next(rec._jobs)
            self.id = next(rec._ids)
            rec._open.append((self.id, job))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        rec = self.rec
        if rec is not None:
            sid, job = rec._open.pop()
            rec.spans.append(Span(self.name, sid, rec._open[-1][0]
                                  if rec._open else None, job,
                                  self.start_ns, self.end_ns))
        return False

    @property
    def seconds(self) -> float:
        """The span's duration (after it closed)."""
        return (self.end_ns - self.start_ns) * 1e-9


_OFF = contextlib.nullcontext()


def span(name: str, timed: bool = False):
    """A span over the ``with`` block, recorded while the recorder records.
    ``timed``: read the clock even while it does not, so that ``with
    span(name, timed=True) as s`` gives ``s.seconds`` after the block."""
    rec = _recording()
    if rec is None and not timed:
        return _OFF
    return _Span(name, rec)


def count(name: str, n: float = 1):
    """Add ``n`` to counter ``name`` of the innermost open span, while the
    recorder records."""
    rec = _recording()
    if rec is not None:
        key = (rec._open[-1][1], rec._open[-1][0]) if rec._open \
            else (None, None)
        rec.counters[key + (name,)] += n


def count_on(device, name: str):
    """Count one under ``name`` where ``device`` is a GPU: put right before
    a call that makes the host wait for it there (a check of a result on
    the host, a boolean-mask selection) and waits for nothing on the
    CPU."""
    if torch.device(device).type != "cpu":
        count(name)


def host(x: torch.Tensor, name: str):
    """``x`` read to the host (a Python number for a 0-d tensor, else a
    CPU tensor), counted under ``name``: on a GPU, a read the host waits
    for."""
    count(name)
    return x.item() if x.dim() == 0 else x.cpu()


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)``, counted under
    ``sync.upload`` where it copies host data to a GPU: a copy from pageable
    memory, which the host waits for."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if t.device.type != "cpu" and t.numel() and not (
            isinstance(a, torch.Tensor) and a.device.type != "cpu"):
        count("sync.upload")
    return t


def recorded() -> Recording:
    """What the recorder holds: the recording of the profiler session that
    runs, else of the last one."""
    _recording()
    return _last


def clear_recorded():
    """Forget what the recorder holds."""
    global _last
    _last = Recording()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.json``, open it in ``chrome://tracing`` or Perfetto) under
    ``logdir``; the CUDA activity is recorded when a GPU is present. The
    program's spans of the block, which the recorder records while the
    profiler runs, go into the same file as complete events (``cat:
    "span"``) on the profiler's timeline; what the recorder held before is
    forgotten. With ``None`` nothing is recorded."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    clear_recorded()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()     # a row of the process of its own (thread 0)
    doc["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": 0, "args": {"name": "program spans"}})
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": 0,
         "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "job": s.job}}
        for s in recorded().spans)
    with open(path, "w") as fh:
        json.dump(doc, fh)
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
