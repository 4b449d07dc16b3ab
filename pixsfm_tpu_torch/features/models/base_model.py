"""Feature-model base class (reference: pixsfm/features/models/base_model.py).

Port of ``pixsfm_tpu/features/models/base_model.py``: models are
``nn.Module``s in NCHW that own their weights on an explicit device and
expose ``output_dims`` / ``scales`` per returned level.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ...config import merge

__all__ = ["BaseModel"]


class BaseModel(nn.Module):
    default_conf = {"name": "???"}
    output_dims: Optional[List[int]] = None   # channels per returned level
    scales: Optional[List[int]] = None        # downscale per level vs input

    def __init__(self, conf=None, device="cpu", seed: int = 0):
        super().__init__()
        self.conf = merge({"name": self.__class__.__name__.lower()},
                          self.default_conf, conf or {})
        self._init(self.conf, seed)
        if self.output_dims is None:
            raise ValueError(f"{type(self).__name__} set no output_dims")
        if self.scales is not None and \
                len(self.output_dims) != len(self.scales):
            raise ValueError("output_dims and scales differ in length")
        self.to(torch.device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- to be implemented --------------------------------------------------
    def _init(self, conf, seed: int):
        raise NotImplementedError

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image: [B, 3, H, W] float32 in [0, 1] -> list of [B, C, h, w]."""
        raise NotImplementedError

    def preprocess(self, image) -> torch.Tensor:
        """PIL image or ``[H, W, 3]`` array -> ``[1, 3, H, W]`` float32 in
        [0, 1] on the model's device."""
        arr = np.asarray(image, dtype=np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        if arr.max() > 1.5:
            arr = arr / 255.0
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(self.device).permute(2, 0, 1)[None].contiguous()
