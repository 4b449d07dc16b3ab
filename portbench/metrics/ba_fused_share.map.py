"""Share of BA's evaluations in the traced job that took the fused kernel
K4: the program's counters ``ba.eval.fused`` and ``ba.eval.chunked`` (one
per evaluation of ``ba_solve``, on the path it took), as 100 * fused /
(fused + chunked) inside its ``ba`` span. None where the program counts
neither."""

from portbench import program_spans

LAYER = "bundle_adjustment"
UNIT = "%"
MOVES = "scene_s"
BETTER = "higher"


def read(ctx):
    rec = program_spans.recording(ctx)
    if rec is None:
        return None
    n = rec.counts("ba.eval.", within="ba")
    fused = n.get("ba.eval.fused", 0.0)
    total = fused + n.get("ba.eval.chunked", 0.0)
    return None if total == 0 else 100.0 * fused / total
