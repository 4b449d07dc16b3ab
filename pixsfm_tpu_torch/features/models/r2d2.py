"""R2D2 — reliable and repeatable learned detector/descriptor.

Port of ``pixsfm_tpu/features/models/r2d2.py`` as an ``nn.Module`` in
NCHW: the public ``Quad_L2Net_ConfCFS`` (naver/r2d2 ``nets/patchnet.py``)
run fully convolutionally (strides become dilations, every map stays at
full resolution), a 128-d L2-normalized descriptor, a 2-class softmax
reliability head and a softplus-squashed repeatability head, both on the
squared descriptor activations.

The submodules carry the public checkpoint's names: ``ops.N`` is the
ModuleList of Conv2d / BatchNorm2d(affine=False) / ReLU, ``clf`` and
``sal`` the 1x1 heads, so ``checkpoints/r2d2_WASF_N16.pt`` loads with
``load_state_dict``. BatchNorm runs in eval mode with eps 1e-5, Flax's
default. The 2x2 dilated convolutions pad (k - 1) * d / 2 on every side,
which keeps the map's size. Convolutions run with cuDNN's TF32 off.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ... import logger
from .base_model import BaseModel, oihw, read_checkpoint, to_nhwc_batch, vec
from .s2dnet import IMAGENET_MEAN, IMAGENET_STD, _no_tf32
from .superpoint import detection_output, select_keypoints, simple_nms

__all__ = ["R2D2", "params_from_flax", "R2D2_CONV_PLAN"]

# (out_ch, kernel, dilation, use_bn, use_relu) — fully-convolutional plan
# with stride folded into dilation (dilated=True in the public net).
R2D2_CONV_PLAN = [
    (32, 3, 1, True, True),
    (32, 3, 1, True, True),
    (64, 3, 1, True, True),    # stride 2 -> subsequent dilation x2
    (64, 3, 2, True, True),
    (128, 3, 2, True, True),   # stride 2 -> subsequent dilation x2
    (128, 3, 4, True, True),
    (128, 2, 4, True, False),  # the three 2x2 convs replacing the 8x8
    (128, 2, 8, True, False),
    (128, 2, 16, False, False),
]


def _slots() -> List[Tuple[int, int]]:
    """(conv slot, BatchNorm slot or -1) in ``ops`` for each plan entry."""
    out, idx = [], 0
    for _, _, _, use_bn, use_relu in R2D2_CONV_PLAN:
        conv = idx
        idx += 1
        bn = idx if use_bn else -1
        idx += int(use_bn) + int(use_relu)
        out.append((conv, bn))
    return out


class R2D2(BaseModel):
    """Dense-feature-model view: full-resolution 128-d descriptors as one
    level (scale 1), plus :meth:`detect` for reliability-filtered
    keypoints."""

    default_conf = {
        "max_keypoints": 2048,
        "reliability_threshold": 0.7,
        "repeatability_threshold": 0.7,
        "nms_radius": 1,
        "pretrained": "r2d2",
    }

    def _init(self, conf, seed: int):
        ops, in_ch = [], 3
        for ch, k, d, use_bn, use_relu in R2D2_CONV_PLAN:
            ops.append(nn.Conv2d(in_ch, ch, kernel_size=k,
                                 padding=((k - 1) * d) // 2, dilation=d))
            if use_bn:
                ops.append(nn.BatchNorm2d(ch, affine=False, eps=1e-5))
            if use_relu:
                ops.append(nn.ReLU())
            in_ch = ch
        self.ops = nn.ModuleList(ops)
        self.clf = nn.Conv2d(128, 2, kernel_size=1)
        self.sal = nn.Conv2d(128, 1, kernel_size=1)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.output_dims = [128]
        self.scales = [1]
        self._random_init(seed)
        if conf.get("pretrained") == "r2d2":
            ckpt = Path(__file__).parent / "checkpoints" / "r2d2_WASF_N16.pt"
            if ckpt.exists():
                self.load_state_dict(read_checkpoint(ckpt))
                logger.info("Loaded R2D2 checkpoint from %s", ckpt)
            else:
                logger.warning(
                    "R2D2 weights not found at %s (zero-egress environment); "
                    "using deterministic random init.", ckpt)

    def net(self, x: torch.Tensor):
        """ImageNet-normalized ``[B, 3, H, W]`` -> (desc ``[B, 128, H, W]``
        L2-normalized, reliability ``[B, 1, H, W]``, repeatability
        ``[B, 1, H, W]``)."""
        with _no_tf32():
            for op in self.ops:
                x = op(x)
            desc = x / torch.clamp(torch.linalg.vector_norm(
                x, dim=1, keepdim=True), min=1e-8)
            x2 = x ** 2
            urel = self.clf(x2)
            urep = self.sal(x2)
        reliability = torch.softmax(urel, dim=1)[:, 1:2]
        sp = torch.logaddexp(urep, torch.zeros_like(urep))   # softplus
        return desc, reliability, sp / (1.0 + sp)

    def _normalize(self, image_nchw):
        return (image_nchw - self.mean.view(3, 1, 1)) / self.std.view(3, 1, 1)

    def forward(self, image: torch.Tensor):
        return [self.net(self._normalize(image))[0]]

    @torch.no_grad()
    def detect(self, image) -> Dict[str, np.ndarray]:
        """``image [B, H, W, 3]`` float32 in [0, 1] -> dict(keypoints,
        scores, valid, descriptors ``[B, K, 128]``) as numpy, K static.

        Score = reliability * repeatability at 3x3 local maxima of the
        repeatability map where both pass their thresholds (the public
        extractor's NonMaxSuppression)."""
        conf = self.conf
        img = to_nhwc_batch(image, self.device).permute(0, 3, 1, 2)
        desc, rel, rep = self.net(self._normalize(img))
        rel, rep = rel[:, 0], rep[:, 0]
        rep2 = simple_nms(rep, int(conf.nms_radius), iterations=0)
        ok_t = ((rel >= float(conf.reliability_threshold))
                & (rep >= float(conf.repeatability_threshold)))
        score = torch.where(ok_t, rep2 * rel, torch.zeros_like(rel))
        xy, val, ok = select_keypoints(score, int(conf.max_keypoints), 0.0,
                                       border=4)
        ii, jj = xy[..., 1].long(), xy[..., 0].long()
        b = torch.arange(desc.shape[0], device=desc.device)[:, None]
        d = desc.permute(0, 2, 3, 1)[b, ii, jj]
        return detection_output(xy, val, ok & (val > 0), d)


def params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`R2D2` from the JAX model's ``variables``
    (``params`` and ``batch_stats``), under the public names."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate(_slots()):
        sd[f"ops.{conv}.weight"] = oihw(params[f"conv{i}"]["kernel"])
        sd[f"ops.{conv}.bias"] = vec(params[f"conv{i}"]["bias"])
        if bn >= 0:
            sd[f"ops.{bn}.running_mean"] = vec(stats[f"bn{i}"]["mean"])
            sd[f"ops.{bn}.running_var"] = vec(stats[f"bn{i}"]["var"])
            sd[f"ops.{bn}.num_batches_tracked"] = torch.tensor(0)
    for head in ("clf", "sal"):
        sd[f"{head}.weight"] = oihw(params[head]["kernel"])
        sd[f"{head}.bias"] = vec(params[head]["bias"])
    return sd
