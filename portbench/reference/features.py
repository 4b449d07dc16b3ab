"""Plain S2DNet features (``num_layers: 1``): VGG16's conv1_1 and conv1_2
with ReLUs, then the adaptation head 1x1 conv -> ReLU -> 5x5 conv ->
BatchNorm, 128 channels, ImageNet mean/std input normalization; the
keypoint windows the extractor stores (corner, per-pixel L2, bfloat16);
and a Catmull-Rom read of the dense map at image points.

Written from the published S2DNet head and the extractor's documented
storage; plain ``torch.nn.functional`` calls in float32 with TF32 off. It
imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def full_float32():
    """cuDNN and cuBLAS float32 in full precision (TF32 off)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def preprocess(image: np.ndarray, device) -> torch.Tensor:
    """``[H, W, 3]`` uint8 -> ``[1, 3, H, W]`` float32 in [0, 1]."""
    arr = np.asarray(image, dtype=np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t.permute(2, 0, 1)[None].contiguous()


@torch.no_grad()
def dense_map(weights: Dict[str, torch.Tensor], image: np.ndarray
              ) -> torch.Tensor:
    """The ``[128, H, W]`` float32 map of one image."""
    w = weights
    dev = w["encoder.0.weight"].device
    x = preprocess(image, dev)
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(3, 1, 1)
    x = (x - mean) / std
    head = "adaptation_layers.adap_layer_0"
    with full_float32():
        x = F.relu(F.conv2d(x, w["encoder.0.weight"], w["encoder.0.bias"],
                            padding=1))
        x = F.relu(F.conv2d(x, w["encoder.2.weight"], w["encoder.2.bias"],
                            padding=1))
        x = F.relu(F.conv2d(x, w[f"{head}.0.weight"], w[f"{head}.0.bias"]))
        x = F.conv2d(x, w[f"{head}.2.weight"], w[f"{head}.2.bias"],
                     padding=2)
        x = F.batch_norm(x, w[f"{head}.3.running_mean"],
                         w[f"{head}.3.running_var"], w[f"{head}.3.weight"],
                         w[f"{head}.3.bias"], False, 0.0, 1e-5)
    return x[0]


def corners(keypoints: np.ndarray, ps: int, W: int, H: int) -> np.ndarray:
    """Integer window origins (x, y) of keypoints at scale 1, clipped."""
    c = (np.asarray(keypoints, np.float64) - ps / 2.0).astype(np.int32)
    return np.clip(c, [0, 0], [max(W - ps - 1, 0), max(H - ps - 1, 0)])


def windows(fmap: torch.Tensor, keypoints: np.ndarray, ps: int,
            dtype=torch.bfloat16) -> torch.Tensor:
    """The stored ``[N, ps, ps, C]`` windows of a ``[C, H, W]`` map: cut at
    :func:`corners`, L2-normalized per pixel in float32, cast."""
    C, H, W = fmap.shape
    cr = torch.as_tensor(corners(keypoints, ps, W, H), device=fmap.device,
                         dtype=torch.int64)
    ys = cr[:, 1, None] + torch.arange(ps, device=fmap.device)
    xs = cr[:, 0, None] + torch.arange(ps, device=fmap.device)
    f = fmap.permute(1, 2, 0)[ys[:, :, None], xs[:, None, :]]
    f = f.to(torch.float32)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                        min=1e-12)
    return f.to(dtype).contiguous()


def _catmull_rom(t: torch.Tensor) -> torch.Tensor:
    """``[N, 4]`` weights of taps -1..2 at fractional offsets ``t [N]``."""
    t2, t3 = t * t, t * t * t
    return torch.stack([-0.5 * t3 + t2 - 0.5 * t,
                        1.5 * t3 - 2.5 * t2 + 1.0,
                        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
                        0.5 * t3 - 0.5 * t2], 1)


def read(fmap: torch.Tensor, xy: np.ndarray, chunk: int = 65536,
         dtype=torch.bfloat16) -> torch.Tensor:
    """Bicubic (Catmull-Rom, edges clamped) read at image points ``xy
    [N, 2]`` (pixel centres at +0.5) of the ``[C, H, W]`` map as stored:
    L2-normalized per pixel and cast to ``dtype``; each result read in
    float32 and L2-normalized: ``[N, C]``."""
    C, H, W = fmap.shape
    dev = fmap.device
    f = fmap.permute(1, 2, 0).to(torch.float32)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                        min=1e-12)
    f = f.to(dtype).to(torch.float32).reshape(H * W, C)
    out = []
    pts = torch.as_tensor(np.asarray(xy, np.float64), device=dev)
    taps = torch.arange(-1, 3, device=dev)
    for s in range(0, len(pts), chunk):
        p = pts[s:s + chunk]
        c, r = p[:, 0] - 0.5, p[:, 1] - 0.5
        c0, r0 = torch.floor(c), torch.floor(r)
        wc = _catmull_rom((c - c0).to(torch.float32))
        wr = _catmull_rom((r - r0).to(torch.float32))
        ci = torch.clamp(c0.long()[:, None] + taps, 0, W - 1)
        ri = torch.clamp(r0.long()[:, None] + taps, 0, H - 1)
        idx = ri[:, :, None] * W + ci[:, None, :]              # [n, 4, 4]
        vals = f[idx.reshape(-1)].reshape(len(p), 4, 4, C)
        v = torch.einsum("nijc,ni,nj->nc", vals, wr, wc)
        out.append(v / torch.clamp(torch.linalg.vector_norm(
            v, dim=-1, keepdim=True), min=1e-12))
    if not out:
        return torch.zeros((0, C), device=dev)
    return torch.cat(out)
