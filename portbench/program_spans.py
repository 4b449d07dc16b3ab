"""The program's own spans and counters in the traced job.

The program's recorder (``pixsfm_tpu_torch.util.profiling``) records while
``torch.profiler`` records, which in a run is the traced job alone, so
after the window it holds that job's spans (name, start and end in
``time.time_ns()``, the clock of the device trace) and its counters. The
readers of the metrics that read them call :func:`recording`; its first
call also adds the spans to the marks that name the traced job's idle gaps
(the innermost span open at a gap's middle), beside the benchmark's own.
So ``breakdown`` names gaps by the program's spans only in a cell that
lists one of these metrics (the harness reads the metrics before the
breakdown). A program without the recorder gives None, and the metrics
are left out.
"""

from __future__ import annotations


def recording(ctx):
    """The program's recording of the traced job, or None."""
    if "program" not in ctx.__dict__:
        ctx.program = None
        ns = ctx.tracer.traced_ns
        try:
            from pixsfm_tpu_torch.util import profiling
        except ImportError:
            return None
        rec = getattr(profiling, "recorded", lambda: None)()
        if ns is None or rec is None or not rec.spans:
            return None
        ctx.program = rec
        ctx.tracer.marks.extend((s.name, s.start_ns, s.end_ns)
                                for s in rec.spans
                                if ns[0] <= s.start_ns and s.end_ns <= ns[1])
    return ctx.program


def seconds(ctx, *names):
    """The traced job's seconds in the program's spans called ``names``."""
    rec = recording(ctx)
    if rec is None:
        return None
    return sum(rec.seconds(n) for n in names)
