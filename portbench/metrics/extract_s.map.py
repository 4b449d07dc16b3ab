"""Seconds per job in the calls into the extractor of the benchmark's own
``PixSfM`` object (synced at the span's end in the traced run)."""

LAYER = "features"
UNIT = "s"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    return ctx.per_job("extract")
