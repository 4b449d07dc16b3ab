"""Identity "feature" model: raw RGB or grayscale intensities as feature
maps (reference: pixsfm/features/models/image.py; the photometric and
norefine presets use it). Port of ``pixsfm_tpu/features/models/image.py``
as an ``nn.Module`` in NCHW with no weights."""

from __future__ import annotations

import torch

from .base_model import BaseModel
from .dsift import GRAY_WEIGHTS

__all__ = ["ImageModel"]


class ImageModel(BaseModel):
    default_conf = {
        "grayscale": False,
    }

    def _init(self, conf, seed: int):
        self.output_dims = [1 if conf.get("grayscale") else 3]
        self.scales = [1]
        self.register_buffer("gray", torch.tensor(GRAY_WEIGHTS).view(3, 1, 1),
                             persistent=False)

    def forward(self, image: torch.Tensor):
        if self.conf.get("grayscale"):
            return [(image * self.gray).sum(1, keepdim=True)]
        return [image]
