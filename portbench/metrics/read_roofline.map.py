"""K1's share of its roofline: the counted bytes and FLOPs of the calls
into the read route (``ops/interpolate_cuda.interpolate_rows``) as
max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s), over the device time of the
K1 kernels (``interp_kernel*``) in the traced job."""

from portbench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "scene_s"
BETTER = "higher"


def read(ctx):
    dev = ctx.kernel_seconds("interp_kernel")
    piece = ctx.tracer.pieces.get("read")
    if not dev or not piece:
        return None
    return 100.0 * counts.least_seconds(*piece) / dev
