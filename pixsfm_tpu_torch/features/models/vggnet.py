"""Raw VGG16 hypercolumn features (reference: pixsfm/features/models/vggnet.py).

Port of ``pixsfm_tpu/features/models/vggnet.py`` as an ``nn.Module`` in
NCHW: the VGG16 encoder of S2DNet (ImageNet mean/std normalization) cut
after the last hypercolumn layer, each hypercolumn layer's ReLU output
returned as one level without adaptation heads. The default layers
conv1_2 / conv3_3 / conv5_3 give three levels of 64 / 256 / 512 channels
at scales 1 / 4 / 16. The encoder carries S2DNet's names (``encoder.N``,
torchvision's ``vgg16().features`` indices), so
``checkpoints/vgg16_imagenet.pth`` loads with ``load_state_dict``.
Convolutions run with cuDNN's TF32 off.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from ... import logger
from .base_model import BaseModel, read_checkpoint
from .s2dnet import (HYPERCOLUMN_LAYERS, IMAGENET_MEAN, IMAGENET_STD,
                     VGG16_LAYERS, _conv_indices, _no_tf32)
# the encoder carries S2DNet's names: its converter serves VGGNet too
from .s2dnet import params_from_flax  # noqa: F401

__all__ = ["VGGNet", "params_from_flax", "VGG16_CHANNELS"]

VGG16_CHANNELS = {name: ch for name, ch in VGG16_LAYERS if ch}


class VGGNet(BaseModel):
    default_conf = {
        "hypercolumn_layers": list(HYPERCOLUMN_LAYERS),
        "num_layers": None,
        "pretrained": "imagenet",
    }

    def _init(self, conf, seed: int):
        layers = list(conf.get("hypercolumn_layers") or HYPERCOLUMN_LAYERS)
        if conf.get("num_layers"):
            layers = layers[:int(conf.num_layers)]
        conv_idx = _conv_indices()
        modules, in_ch = [], 3
        for name, ch in VGG16_LAYERS:
            if name.startswith("pool"):
                modules.append(nn.MaxPool2d(kernel_size=2, stride=2))
            else:
                modules += [nn.Conv2d(in_ch, ch, kernel_size=3, padding=1),
                            nn.ReLU()]
                in_ch = ch
        last = max(conv_idx[n] for n in layers)
        self.encoder = nn.ModuleList(modules[:last + 2])
        self._tap = {conv_idx[n] + 1 for n in layers}
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(3, 1, 1),
                             persistent=False)
        self.output_dims = [VGG16_CHANNELS[n] for n in layers]
        scale, self.scales = 1, []
        for name, _ in VGG16_LAYERS:
            if name.startswith("pool"):
                scale *= 2
            elif name in layers:
                self.scales.append(scale)
        self._random_init(seed)
        ckpt = Path(__file__).parent / "checkpoints" / "vgg16_imagenet.pth"
        if conf.get("pretrained") and ckpt.exists():
            own = self.state_dict()
            self.load_state_dict({k: v for k, v in read_checkpoint(
                ckpt, ("state_dict",)).items() if k in own})
            logger.info("Loaded VGG16 checkpoint from %s", ckpt)
        elif conf.get("pretrained"):
            logger.warning("VGG16 pretrained weights not found (%s); using "
                           "random init.", ckpt)

    def forward(self, image: torch.Tensor):
        x = (image - self.mean) / self.std
        feats = []
        with _no_tf32():
            for idx, layer in enumerate(self.encoder):
                x = layer(x)
                if idx in self._tap:
                    feats.append(x)
        return feats
