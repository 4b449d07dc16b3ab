"""CG steps per job of the BA solve, as the program's summary reports."""

LAYER = "bundle_adjustment"
UNIT = "count"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    return ctx.counter_per_job("ba_cg_steps")
