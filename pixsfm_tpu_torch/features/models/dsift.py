"""Dense SIFT descriptors (reference: pixsfm/features/models/dsift.py, which
wraps kornia's DenseSIFTDescriptor).

Port of ``pixsfm_tpu/features/models/dsift.py`` as an ``nn.Module`` in
NCHW, with no weights: image gradients by circular shifts -> 8 soft
orientation bins -> a separable triangular blur of ``spatial_bin_size``
(depthwise ``conv2d``, zero padding to the input size) -> the 4x4 grid of
bins by circular shifts -> per-pixel 128-D descriptor -> L2 normalization,
then RootSIFT. Float32 throughout, convolutions with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base_model import BaseModel
from .s2dnet import _no_tf32

__all__ = ["DSIFT", "NUM_ANG_BINS", "NUM_SPATIAL_BINS"]

NUM_ANG_BINS = 8
NUM_SPATIAL_BINS = 4
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


class DSIFT(BaseModel):
    default_conf = {
        "rootsift": True,
        "spatial_bin_size": 4,
        "grayscale": True,
    }

    def _init(self, conf, seed: int):
        self.output_dims = [NUM_ANG_BINS * NUM_SPATIAL_BINS ** 2]  # 128
        self.scales = [1]
        bs = self.bin_size = int(conf.get("spatial_bin_size", 4))
        tri = np.concatenate([np.arange(1, bs + 1), np.arange(bs - 1, 0, -1)])
        self.register_buffer("tri", torch.tensor(tri / tri.sum(),
                                                  dtype=torch.float32),
                             persistent=False)
        self.register_buffer("gray", torch.tensor(GRAY_WEIGHTS).view(3, 1, 1),
                             persistent=False)
        self.register_buffer("bins", (torch.arange(NUM_ANG_BINS) * (
            2 * np.pi / NUM_ANG_BINS) - np.pi).view(-1, 1, 1),
            persistent=False)
        # offsets of the 4x4 grid, Python's round-half-to-even as in JAX
        self.offsets = [int(round((i - (NUM_SPATIAL_BINS - 1) / 2.0) * bs))
                        for i in range(NUM_SPATIAL_BINS)]

    def _blur(self, h):
        """Depthwise triangular blur along H, then W (zero 'SAME' padding)."""
        C, L = h.shape[1], self.tri.numel()
        k = self.tri.expand(C, 1, L)
        h = F.conv2d(h, k[..., None], padding=(L // 2, 0), groups=C)
        return F.conv2d(h, k[:, :, None, :], padding=(0, L // 2), groups=C)

    def forward(self, image: torch.Tensor):
        x = (image * self.gray).sum(1, keepdim=True)       # [B, 1, H, W]
        gx = 0.5 * (torch.roll(x, -1, dims=3) - torch.roll(x, 1, dims=3))
        gy = 0.5 * (torch.roll(x, -1, dims=2) - torch.roll(x, 1, dims=2))
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        ori = torch.atan2(gy, gx)                           # [-pi, pi]

        # soft orientation binning (floor-mod, as jnp's %)
        d = (ori - self.bins + np.pi) % (2 * np.pi) - np.pi  # [B, 8, H, W]
        w = torch.clamp(1.0 - torch.abs(d) * NUM_ANG_BINS / (2 * np.pi),
                        min=0.0)
        with _no_tf32():
            pooled = self._blur(mag * w)

        # sample the 4x4 spatial grid around each pixel by shifting
        desc = torch.cat([torch.roll(pooled, (-dy, -dx), dims=(2, 3))
                          for dy in self.offsets for dx in self.offsets], 1)
        norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
        desc = desc / torch.clamp(norm, min=1e-8)
        if self.conf.get("rootsift", True):
            l1 = torch.abs(desc).sum(1, keepdim=True)
            desc = torch.sqrt(desc / torch.clamp(l1, min=1e-8))
        return [desc]
