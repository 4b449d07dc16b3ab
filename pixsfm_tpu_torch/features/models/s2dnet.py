"""S2DNet (reference: pixsfm/features/models/s2dnet.py — VGG16 hypercolumns
conv1_2/conv3_3/conv5_3 + per-level adaptation heads 1x1 conv -> ReLU -> 5x5
conv -> BatchNorm, 128-dim output, ImageNet mean/std normalization).

Port of ``pixsfm_tpu/features/models/s2dnet.py`` as an ``nn.Module`` in NCHW.
The submodules carry the reference checkpoint's names (``encoder.{idx}`` as
in torchvision's ``vgg16().features``, ``adaptation_layers.adap_layer_{i}.
{0,2,3}``), so a checkpoint at ``checkpoints/s2dnet_weights.pth`` loads with
``load_state_dict``. Without one the weights are a deterministic random
init from an explicit ``torch.Generator``. :func:`params_from_flax` carries
the JAX model's variables across, so both packages compute one function.

``combine: true`` sums the coarser levels onto the first after upsampling
them with :func:`resize_bicubic`, which reproduces ``jax.image.resize(...,
"bicubic")``: Keys cubic (a = -0.5), half-pixel centres, taps outside the
input dropped and each row renormalised. ``F.interpolate(mode="bicubic")``
(a = -0.75, edges clamped) is another function.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Mapping

import torch
from torch import nn

from ... import logger
from .base_model import BaseModel, oihw, vec

__all__ = ["S2DNet", "params_from_flax", "resize_bicubic",
           "bicubic_weight_matrix", "VGG16_LAYERS", "HYPERCOLUMN_LAYERS"]

# VGG16 feature-extractor layout: (name, out_channels) conv entries and pools.
VGG16_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("pool5", None),
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

HYPERCOLUMN_LAYERS = ["conv1_2", "conv3_3", "conv5_3"]


def _conv_indices() -> Dict[str, int]:
    """Conv name -> child index in ``vgg16().features`` (conv, ReLU pairs
    and single pools)."""
    out, idx = {}, 0
    for name, _ in VGG16_LAYERS:
        if name.startswith("pool"):
            idx += 1
        else:
            out[name] = idx
            idx += 2
    return out


def bicubic_weight_matrix(in_size: int, out_size: int, device=None
                          ) -> torch.Tensor:
    """``[in_size, out_size]`` float32 resampling weights of
    ``jax.image.resize(..., "bicubic")`` along one axis
    (``compute_weight_mat`` of ``jax/_src/image/scale.py`` with the Keys
    kernel, a = -0.5, antialiasing on, no translation)."""
    f32 = torch.float32
    scale = torch.tensor(out_size / in_size, dtype=f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros((), dtype=f32), w)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(
        torch.finfo(f32).eps), w / torch.where(total != 0, total,
                                                torch.ones((), dtype=f32)),
        torch.zeros((), dtype=f32))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros((), dtype=f32))
    return w.to(device)


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """``[B, C, h, w]`` -> ``[B, C, H, W]`` as ``jax.image.resize`` with
    ``method="bicubic"`` on the two spatial axes: two products with the
    per-axis weight matrices (an axis whose size is kept is left as is)."""
    H, W = int(size[0]), int(size[1])
    h, w = x.shape[-2:]
    if h != H:
        x = torch.einsum("bchw,hH->bcHw", x,
                         bicubic_weight_matrix(h, H, x.device).to(x.dtype))
    if w != W:
        x = torch.einsum("bchw,wW->bchW", x,
                         bicubic_weight_matrix(w, W, x.device).to(x.dtype))
    return x


@contextlib.contextmanager
def _no_tf32():
    """Full float32 convolutions: cuDNN would otherwise run them in TF32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class S2DNet(BaseModel):
    default_conf = {
        "num_layers": 1,
        "checkpointing": None,
        "output_dim": 128,
        "pretrained": "s2dnet",
        "remove_pooling_layers": False,
        "combine": False,
    }

    def _init(self, conf, seed: int):
        hyper = HYPERCOLUMN_LAYERS[:int(conf.num_layers)]
        conv_idx = _conv_indices()
        self.remove_pooling_layers = bool(conf.remove_pooling_layers)
        layers = []
        in_ch = 3
        for name, ch in VGG16_LAYERS:
            if name.startswith("pool"):
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
            else:
                layers += [nn.Conv2d(in_ch, ch, kernel_size=3, padding=1),
                           nn.ReLU()]
                in_ch = ch
        # keep the encoder through the ReLU of the last hypercolumn layer
        self.encoder = nn.ModuleList(layers[:conv_idx[hyper[-1]] + 2])
        self._tap = {conv_idx[n] + 1 for n in hyper}
        channels = dict(VGG16_LAYERS)
        self.adaptation_layers = nn.Module()
        out_dim = int(conf.output_dim)
        for i, name in enumerate(hyper):
            self.adaptation_layers.add_module(
                f"adap_layer_{i}", nn.Sequential(
                    nn.Conv2d(channels[name], 64, kernel_size=1),
                    nn.ReLU(),
                    nn.Conv2d(64, out_dim, kernel_size=5, padding=2),
                    nn.BatchNorm2d(out_dim, eps=1e-5)))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(3, 1, 1),
                             persistent=False)
        self.output_dims = [out_dim] * len(hyper)
        if self.remove_pooling_layers:
            self.scales = [1] * len(hyper)
        else:
            scale_of = {"conv1_2": 1, "conv3_3": 4, "conv5_3": 16}
            self.scales = [scale_of[n] for n in hyper]
        self.combine = bool(conf.get("combine"))
        if self.combine:
            self.output_dims = self.output_dims[:1]
            self.scales = self.scales[:1]

        self._random_init(seed)
        ckpt = Path(__file__).parent / "checkpoints" / "s2dnet_weights.pth"
        if conf.get("pretrained") == "s2dnet":
            if ckpt.exists():
                sd = torch.load(ckpt, map_location="cpu", weights_only=True)
                sd = sd.get("state_dict", sd)
                own = self.state_dict()
                self.load_state_dict({k: v for k, v in sd.items()
                                      if k in own})
                logger.info("Loaded S2DNet checkpoint from %s", ckpt)
            else:
                logger.warning(
                    "S2DNet pretrained weights not found at %s (zero-egress "
                    "environment); using deterministic random init. Place the "
                    "reference checkpoint there for descriptor parity.", ckpt)

    def forward(self, image: torch.Tensor):
        x = (image - self.mean) / self.std
        feats = []
        with _no_tf32():
            for idx, layer in enumerate(self.encoder):
                if isinstance(layer, nn.MaxPool2d) and \
                        self.remove_pooling_layers:
                    continue
                x = layer(x)
                if idx in self._tap:
                    feats.append(x)
            feats = [self.adaptation_layers.get_submodule(
                f"adap_layer_{i}")(f) for i, f in enumerate(feats)]
            if self.combine and len(feats) > 1:
                base = feats[0]
                for f in feats[1:]:
                    base = base + resize_bicubic(f, base.shape[-2:])
                feats = [base]
            return feats


def params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`S2DNet` from the JAX model's ``variables``
    (nested mappings of arrays: ``params`` and ``batch_stats``).

    Conv kernels go HWIO -> OIHW; BatchNorm ``scale/bias`` become
    ``weight/bias`` and ``mean/var`` the running statistics (eps is 1e-5 in
    both frameworks)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, idx in _conv_indices().items():
        if name in params:
            sd[f"encoder.{idx}.weight"] = oihw(params[name]["kernel"])
            sd[f"encoder.{idx}.bias"] = vec(params[name]["bias"])
    i = 0
    while f"adap{i}_conv1" in params:
        pre = f"adaptation_layers.adap_layer_{i}"
        for sub, fl in ((0, f"adap{i}_conv1"), (2, f"adap{i}_conv2")):
            sd[f"{pre}.{sub}.weight"] = oihw(params[fl]["kernel"])
            sd[f"{pre}.{sub}.bias"] = vec(params[fl]["bias"])
        bn = f"adap{i}_bn"
        sd[f"{pre}.3.weight"] = vec(params[bn]["scale"])
        sd[f"{pre}.3.bias"] = vec(params[bn]["bias"])
        sd[f"{pre}.3.running_mean"] = vec(stats[bn]["mean"])
        sd[f"{pre}.3.running_var"] = vec(stats[bn]["var"])
        sd[f"{pre}.3.num_batches_tracked"] = torch.tensor(0)
        i += 1
    return sd
