"""Spans, counters and the device trace of one run, kept in memory.

The benchmark spans the calls it makes into the program's layers (the
extractor, bundle adjustment) from its own files: it
wraps module attributes and instance methods for the length of a run and
puts them back afterwards. With tracing off (``--trace 0``) a span costs
two clock reads and adds no device sync. With tracing on, each span ends in
``torch.cuda.synchronize()``, the first job of the window runs under
``torch.profiler`` (CUDA activity only), and the calls into the hand-written
kernels' entry points are counted by their shapes (``counts.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from . import counts


class Tracer:
    def __init__(self, tracing: bool, sync: Callable[[], None]):
        self.tracing = tracing
        self.sync = sync
        self.spans: Dict[str, float] = defaultdict(float)   # seconds
        self.counters: Dict[str, float] = defaultdict(float)
        self.pieces: Dict[str, List[float]] = defaultdict(
            lambda: [0.0, 0.0])                   # piece -> [bytes, FLOPs]
        self.marks: List[Tuple[str, int, int]] = []   # traced job's spans
        self.counting = False        # kernel entry counts (traced job only)
        self.kernels: List[Tuple[str, int, int]] = []   # (name, start, end)
        self.traced_ns: Optional[Tuple[int, int]] = None
        self._restore: List[Callable[[], None]] = []

    # -- spans and counters -------------------------------------------------
    def reset(self):
        """Forget what set-up (the warm-up job) recorded."""
        self.spans.clear()
        self.counters.clear()
        self.pieces.clear()
        self.marks.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self.tracing:
                self.sync()
            t1 = time.time_ns()
            self.spans[name] += (t1 - t0) * 1e-9
            if self.counting:
                self.marks.append((name, t0, t1))

    def count(self, name: str, value: float):
        self.counters[name] += float(value)

    def add_piece(self, name: str, bytes_: float, flops: float):
        if self.counting:
            self.pieces[name][0] += float(bytes_)
            self.pieces[name][1] += float(flops)

    # -- wrapping the program -------------------------------------------------
    def wrap(self, owner, attr: str, span: Optional[str] = None,
             after: Optional[Callable] = None, before: Optional[Callable]
             = None):
        """Replace ``owner.attr`` by a call that runs ``before(*a, **kw)``,
        the original inside span ``span``, then ``after(result, *a, **kw)``;
        :meth:`restore` puts the original back."""
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            if before is not None:
                before(*a, **kw)
            if span is None:
                out = orig(*a, **kw)
            else:
                with self.span(span):
                    out = orig(*a, **kw)
            if after is not None:
                after(out, *a, **kw)
            return out

        wrapped.__wrapped__ = orig
        setattr(owner, attr, wrapped)
        had = attr in getattr(owner, "__dict__", {})
        self._restore.append(lambda: setattr(owner, attr, orig) if had
                             else delattr(owner, attr))
        return orig

    def restore(self, keep: int = 0):
        """Put the originals back, all but the first ``keep`` wraps."""
        while len(self._restore) > keep:
            self._restore.pop()()

    def count_kernel_entries(self):
        """Count bytes and FLOPs of every call into K1 (the read route),
        K2 (the KA linear solves) and K3 (the grid Schur terms) from their
        arguments' shapes, while :attr:`counting`."""
        import torch
        from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda, lm
        from pixsfm_tpu_torch.ops import schur_cuda

        def k1(out, rows, H, W, C, row_base, r, c, l2=None, **kw):
            l2 = kw.get("l2_normalize", l2)
            if rows.is_cuda and self.counting:
                dev = rows.device
                self.add_piece("read", *counts.k1(
                    rows, H, W, C, torch.as_tensor(row_base, device=dev),
                    torch.as_tensor(r, device=dev),
                    torch.as_tensor(c, device=dev), bool(l2)))

        def k2(out, H, g, iters, damp=None, **kw):
            if H.is_cuda:
                self.add_piece("cg", *counts.k2(H, g, int(iters), damp))

        def k3(out, *a, **kw):
            ts = [t for t in a if isinstance(t, torch.Tensor)]
            if ts and ts[0].is_cuda:
                self.add_piece("schur", *counts.k3(ts, out))

        self.wrap(interpolate_cuda, "interpolate_rows", after=k1)
        self.wrap(cg_cuda, "pcg_solve", after=k2)
        self.wrap(lm, "pcg_solve", after=k2)
        for name in ("schur_term_matvec", "schur_rhs", "schur_backsub"):
            self.wrap(schur_cuda, name, after=k3)

    # -- the traced job -------------------------------------------------------
    @contextlib.contextmanager
    def profiled(self):
        """Run the block under ``torch.profiler`` (CUDA activity) and keep
        its kernels' intervals; count the kernel entries meanwhile."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self.counting = True
        on_card = torch.cuda.is_available()
        with profile(activities=[ProfilerActivity.CUDA if on_card
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.time_ns()
            try:
                yield
            finally:
                self.sync()
                t1 = time.time_ns()
                self.counting = False
        self.traced_ns = (t0, t1)
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                self.kernels.append((e.name(), e.start_ns(), e.end_ns()))
        self.kernels.sort(key=lambda k: k[1])
