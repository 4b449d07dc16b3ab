"""Wall seconds per scene refinement: the window (from the first job's
start to the end of the last job begun while it was open) over the jobs
completed."""

LAYER = ""
UNIT = "s"
MOVES = ""
BETTER = "lower"


def read(ctx):
    return ctx.window_s / ctx.jobs if ctx.unit == "scenes" else None
