"""Share of the traced job in which no operation ran on the device: 1 -
(union of its device operation intervals) / its wall time, from
``torch.profiler``."""

LAYER = "device"
UNIT = "%"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    t = ctx.traced_seconds()
    if not t:
        return None
    return 100.0 * (1.0 - ctx.busy_seconds() / t)
