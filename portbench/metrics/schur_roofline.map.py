"""K3's share of its roofline: the counted bytes of the grid Schur terms
(``ops/schur_cuda``: matvec, rhs, backsub) over the device time of the
K3 kernels in the traced job. FLOPs are not counted, so the share is a
lower bound."""

from portbench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "scene_s"
BETTER = "higher"


def read(ctx):
    dev = ctx.kernel_seconds("matvec_kernel", "rhs_kernel",
                             "backsub_kernel")
    piece = ctx.tracer.pieces.get("schur")
    if not dev or not piece:
        return None
    return 100.0 * counts.least_seconds(*piece) / dev
