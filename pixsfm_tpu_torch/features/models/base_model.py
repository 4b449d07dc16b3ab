"""Feature-model base class (reference: pixsfm/features/models/base_model.py).

Port of ``pixsfm_tpu/features/models/base_model.py``: models are
``nn.Module``s in NCHW that own their weights on a device (``cuda`` unless
the caller passes ``device="cpu"``) and expose ``output_dims`` / ``scales``
per returned level.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ...config import merge

__all__ = ["BaseModel", "read_checkpoint", "to_nhwc_batch", "oihw", "vec"]


def oihw(kernel) -> torch.Tensor:
    """A Flax HWIO convolution kernel as a torch OIHW weight."""
    return vec(kernel).permute(3, 2, 0, 1).contiguous()


def vec(a) -> torch.Tensor:
    """A Flax parameter array as a float32 tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def read_checkpoint(path, wrappers=("state_dict", "net", "model"),
                    prefixes=("module.",)):
    """The state dict of a public checkpoint file: unwrapped from each of
    ``wrappers`` in turn that holds a dict (as the JAX package's loaders
    do), the first of ``prefixes`` that a key starts with stripped,
    non-tensor entries dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in wrappers:
        if isinstance(sd.get(key), dict):
            sd = sd[key]

    def strip(k):
        for p in prefixes:
            if k.startswith(p):
                return k[len(p):]
        return k

    return {strip(k): v for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def to_nhwc_batch(image, device) -> torch.Tensor:
    """``[B, H, W, c]`` float32 tensor on ``device`` from a numpy array or a
    tensor in that layout (the detectors' input, as in the JAX package)."""
    if isinstance(image, torch.Tensor):
        return image.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(
        device)


class BaseModel(nn.Module):
    default_conf = {"name": "???"}
    output_dims: Optional[List[int]] = None   # channels per returned level
    scales: Optional[List[int]] = None        # downscale per level vs input

    def __init__(self, conf=None, device=None, seed: int = 0):
        super().__init__()
        self.conf = merge({"name": self.__class__.__name__.lower()},
                          self.default_conf, conf or {})
        self._init(self.conf, seed)
        if self.output_dims is None:
            raise ValueError(f"{type(self).__name__} set no output_dims")
        if self.scales is not None and \
                len(self.output_dims) != len(self.scales):
            raise ValueError("output_dims and scales differ in length")
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        """The device of the model's weights, or of its buffers when it has
        no weights (dense SIFT, the identity model)."""
        return next(itertools.chain(self.parameters(), self.buffers())).device

    def _random_init(self, seed: int):
        """LeCun-normal conv kernels and zero biases (Flax's defaults),
        drawn from an explicit generator; BatchNorm stays the identity."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / np.sqrt(fan_in))
                    m.bias.zero_()

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
