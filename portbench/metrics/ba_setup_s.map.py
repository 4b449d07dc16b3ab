"""Seconds of the traced job in BA's set-up stages, from the program's own
spans: packing (``ba.pack``), the references (``ba.references``) and the
layout with its uploads (``ba.layout``)."""

from portbench import program_spans

LAYER = "bundle_adjustment"
UNIT = "s"
MOVES = "scene_s"
BETTER = "lower"


def read(ctx):
    return program_spans.seconds(ctx, "ba.pack", "ba.references",
                                 "ba.layout")
