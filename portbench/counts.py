"""The chip's peaks and the operations and bytes of the counted pieces.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit; float32
outside the tensor cores, since the program runs its convolutions and
products with TF32 off.

Each count follows from the problem's shapes alone (image sizes, query and
system counts, the solver's own iteration counts), never from which kernel
ran: each input byte read once, each output byte written once.
"""

from __future__ import annotations

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# S2DNet at num_layers 1: (in, out, kernel) of each convolution
S2DNET_CONVS = ((3, 64, 3), (64, 64, 3), (64, 64, 1), (64, 128, 5))


def least_seconds(bytes_: float, flops: float) -> float:
    """The least time the chip can take: max(bytes / BW, FLOPs / peak)."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def s2dnet(H: int, W: int):
    """(bytes, FLOPs) of one ``H x W`` image through S2DNet's convolutions:
    the float32 input and the 128-channel float32 output once, two FLOPs
    per multiply-add."""
    flops = 2.0 * H * W * sum(i * o * k * k for i, o, k in S2DNET_CONVS)
    bytes_ = 4.0 * H * W * (3 + S2DNET_CONVS[-1][1])
    return bytes_, flops


def k1(rows, H: int, W: int, C: int, row_base, r, c, l2: bool):
    """(bytes, FLOPs) of one call's bicubic reads of C channels: the
    distinct tap pixels its queries need (a 4 x 4 window each, clamped to
    the patch, shared taps counted once), each query's three inputs and
    its three float32 outputs (value and two derivatives); 6 FLOPs per tap
    and channel, and 12 per channel for the L2 chain rule."""
    import torch
    n = int(r.shape[0])
    taps = torch.arange(-1, 3, device=r.device)
    ri = torch.clamp(torch.floor(r).long()[:, None] + taps, 0, H - 1)
    ci = torch.clamp(torch.floor(c).long()[:, None] + taps, 0, W - 1)
    pix = ((row_base.to(r.device).long()[:, None, None] + ri[:, :, None])
           * W + ci[:, None, :]).reshape(-1)
    n_pix = int(torch.unique(pix).numel())
    bytes_ = float(n_pix) * C * rows.element_size() + 12.0 * n \
        + 12.0 * n * C
    flops = float(n) * C * (16 * 6 + (12 if l2 else 0))
    return bytes_, flops


def k2(H, g, iters: int, damp=None):
    """(bytes, FLOPs) of ``iters`` Jacobi-PCG steps on ``P`` float32
    systems of size ``N``: the matrices, gradients, damping and results
    once; a matrix-vector product (2 N^2) and 10 N of vector work a step."""
    P, N = g.shape
    bytes_ = 4.0 * (P * N * N + 2 * P * N + (P * N if damp is not None
                                            else 0))
    flops = float(iters) * P * (2.0 * N * N + 10.0 * N)
    return bytes_, flops


def k3(tensors, out):
    """(bytes, FLOPs) of one grid Schur term: its tensor inputs read once
    and its outputs written once; the FLOPs are left out, so the bound is a
    lower one."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    bytes_ = sum(t.numel() * t.element_size() for t in tensors) \
        + sum(t.numel() * t.element_size() for t in outs)
    return float(bytes_), 0.0
