"""Share of BA's Levenberg-Marquardt loop in which no operation ran on the
device: 1 - (union of the traced job's device operations clipped to the
program's ``ba.lm`` spans) / those spans' wall time."""

from portbench import program_spans

LAYER = "bundle_adjustment"
UNIT = "%"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    rec = program_spans.recording(ctx)
    if rec is None:
        return None
    spans = [(s.start_ns, s.end_ns) for s in rec.spans if s.name == "ba.lm"]
    wall = sum(b - a for a, b in spans)
    if not wall:
        return None
    busy = 0
    for a, b in spans:
        cur = a                     # the union's end so far, in [a, b]
        for _, s, e in ctx.tracer.kernels:      # sorted by their start
            if s >= b:
                break
            s, e = max(s, cur), min(e, b)
            if e > s:
                busy += e - s
                cur = e
    return 100.0 * (1.0 - busy / wall)
