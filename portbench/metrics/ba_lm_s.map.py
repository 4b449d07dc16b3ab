"""Seconds of the traced job in BA's Levenberg-Marquardt loop, from the
program's own span ``ba.lm``."""

from portbench import program_spans

LAYER = "bundle_adjustment"
UNIT = "s"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    return program_spans.seconds(ctx, "ba.lm")
