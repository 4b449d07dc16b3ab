"""Seconds per job in ``BundleAdjuster.refine_multilevel`` (references,
layout and the BA solve, after extraction)."""

LAYER = "bundle_adjustment"
UNIT = "s"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    return ctx.per_job("ba")
