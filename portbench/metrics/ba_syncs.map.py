"""Points of the traced job where BA's host waits for the device: the
program's own counters ``sync.<site>`` (reads to the host, blocking
uploads, other blocking calls), summed over the sites and over the spans
inside its ``ba`` span."""

from portbench import program_spans

LAYER = "bundle_adjustment"
UNIT = "count"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    rec = program_spans.recording(ctx)
    if rec is None:
        return None
    return float(sum(rec.counts("sync.", within="ba").values()))
