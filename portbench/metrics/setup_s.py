"""Seconds from the start of the process to the opening of the window:
imports, CUDA context, the scene, the weights, kernel builds (first run
in a checkout) and the warm-up job."""

LAYER = ""
UNIT = "s"
MOVES = ""
BETTER = "lower"


def read(ctx):
    return ctx.setup_s
