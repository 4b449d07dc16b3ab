"""The traced job's least time on the chip over its wall time: the sum
over counted pieces (S2DNet's convolutions, the bicubic reads, the CG
solves, the grid Schur terms) of max(bytes / 3.35 TB/s, FLOPs / 67
TFLOP/s), each piece counted from the problem's shapes (``counts.py``),
against the published H100 SXM peaks."""

from portbench import counts

LAYER = "whole job"
UNIT = "%"
MOVES = "scene_s"
BETTER = "higher"


def read(ctx):
    t = ctx.traced_seconds()
    if not t or not ctx.tracer.pieces:
        return None
    least = sum(counts.least_seconds(b, f)
                for b, f in ctx.tracer.pieces.values())
    return 100.0 * least / t
