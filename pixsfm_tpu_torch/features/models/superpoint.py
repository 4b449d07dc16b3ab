"""SuperPoint — learned keypoint detector + 256-d descriptors.

Port of ``pixsfm_tpu/features/models/superpoint.py`` as an ``nn.Module``
in NCHW. The network is the public ``SuperPointNet`` (magicleap
``demo_superpoint.py``): a VGG-style encoder over grayscale input (64, 64 /
64, 64 / 128, 128 / 128, 128 with 2x2 max-pools between blocks), a
detector head (3x3x256 -> 1x1x65, softmax over 65 cells with a dustbin,
8x8 pixel-shuffle to a full-resolution heatmap) and a descriptor head
(3x3x256 -> 1x1x256, bilinearly sampled at keypoints, L2-normalized).

The submodules carry the public checkpoint's names (``conv1a`` ...
``convDb``), so ``checkpoints/superpoint_v1.pth`` loads with
``load_state_dict`` when it is present; otherwise the weights are a
deterministic random init. :func:`params_from_flax` carries the JAX
model's variables across. Convolutions run with cuDNN's TF32 off.

The helpers keep the JAX package's layouts: score maps ``[B, H, W]``,
descriptor maps ``[B, h, w, C]``, keypoints ``[B, K, 2]`` as (x, y).
Selection is a static top-k with a validity mask, as in JAX.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import logger
from .base_model import BaseModel, oihw, read_checkpoint, to_nhwc_batch, vec
from .s2dnet import _no_tf32

__all__ = ["SuperPoint", "params_from_flax", "superpoint_scores_dense",
           "simple_nms", "select_keypoints", "sample_descriptors_coarse8",
           "SUPERPOINT_LAYERS"]

# (name, in, out, kernel) in forward order; the public checkpoint's names
SUPERPOINT_LAYERS = [
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3), ("convDb", 256, None, 1),
]

GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def superpoint_scores_dense(semi: torch.Tensor) -> torch.Tensor:
    """``[B, Hc, Wc, 65]`` raw logits -> ``[B, Hc*8, Wc*8]`` keypoint
    probability: softmax over the 65 cells, dustbin dropped, 8x8
    pixel-shuffle."""
    prob = torch.softmax(semi, dim=-1)[..., :64]
    B, Hc, Wc, _ = prob.shape
    prob = prob.reshape(B, Hc, Wc, 8, 8)
    return prob.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)


def simple_nms(scores: torch.Tensor, radius: int,
               iterations: int = 2) -> torch.Tensor:
    """Approximate NMS by iterated max-pooling of ``[B, H, W]`` scores.

    A pixel survives iff it is the maximum of its (2r+1)^2 window (padding
    reads -inf, as JAX's ``reduce_window`` 'SAME'); suppressed
    neighbourhoods are re-opened for secondary maxima ``iterations`` times."""
    k = 2 * radius + 1

    def maxpool(x):
        return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == maxpool(scores)
    for _ in range(iterations):
        supp = maxpool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp, zeros, scores)
        new_max = (supp_scores == maxpool(supp_scores)) & ~supp
        max_mask = max_mask | new_max
    return torch.where(max_mask, scores, zeros)


def select_keypoints(scores: torch.Tensor, max_keypoints: int,
                     threshold: float, border: int = 4):
    """``[B, H, W]`` NMS'd scores -> (xy ``[B, K, 2]`` float32, score
    ``[B, K]``, valid ``[B, K]``): top-k over the flattened map, valid where
    the score passes ``threshold``. Invalid slots keep in-range coordinates.
    Slots of equal score may come in another order than JAX's
    ``lax.top_k`` (compare valid slots as sets)."""
    B, H, W = scores.shape
    if border > 0:
        m = torch.zeros((H, W), dtype=scores.dtype, device=scores.device)
        m[border:H - border, border:W - border] = 1.0
        scores = scores * m
    val, idx = torch.topk(scores.reshape(B, H * W), max_keypoints, dim=1)
    yy = (idx // W).to(torch.float32)
    xx = (idx % W).to(torch.float32)
    return torch.stack([xx, yy], dim=-1), val, val > threshold


def sample_descriptors_coarse8(xy: torch.Tensor,
                               desc_coarse: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample the stride-8 descriptor map at pixel coordinates.

    The public mapping (``grid_sample`` with ``align_corners=True`` after
    shifting the keypoints by s/2 - 0.5), written out with the JAX
    package's clamps (``grid_sample``'s borders differ).
    ``xy [B, K, 2]``, ``desc_coarse [B, Hc, Wc, C]`` -> L2-normalized
    ``[B, K, C]``."""
    B, Hc, Wc, C = desc_coarse.shape
    s = 8.0
    gx = (xy[..., 0] - s / 2 + 0.5) / (Wc * s - s / 2 - 0.5) * (Wc - 1)
    gy = (xy[..., 1] - s / 2 + 0.5) / (Hc * s - s / 2 - 0.5) * (Hc - 1)
    x0 = torch.clamp(torch.floor(gx), 0, Wc - 1)
    y0 = torch.clamp(torch.floor(gy), 0, Hc - 1)
    x1 = torch.clamp(x0 + 1, 0, Wc - 1)
    y1 = torch.clamp(y0 + 1, 0, Hc - 1)
    wx = torch.clamp(gx - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(gy - y0, 0.0, 1.0)[..., None]
    flat = desc_coarse.reshape(B, Hc * Wc, C)

    def tap(yi, xi):
        lin = (yi.long() * Wc + xi.long())[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, lin)

    v = ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x1))
         + wy * ((1 - wx) * tap(y1, x0) + wx * tap(y1, x1)))
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-8)


def detection_output(xy, val, ok, desc) -> Dict[str, np.ndarray]:
    """The detectors' result as numpy, the JAX package's ``detect`` dict."""
    return {"keypoints": xy.cpu().numpy(), "scores": val.cpu().numpy(),
            "valid": ok.cpu().numpy(), "descriptors": desc.cpu().numpy()}


class SuperPoint(BaseModel):
    """Dense-feature-model view: the stride-8 descriptor map as one level,
    plus :meth:`detect` for keypoints."""

    default_conf = {
        "descriptor_dim": 256,
        "nms_radius": 4,
        "keypoint_threshold": 0.005,
        "max_keypoints": 2048,
        "remove_borders": 4,
        "pretrained": "superpoint",
    }

    def _init(self, conf, seed: int):
        dim = int(conf.descriptor_dim)
        for name, cin, cout, k in SUPERPOINT_LAYERS:
            self.add_module(name, nn.Conv2d(cin, cout or dim, k, 1, k // 2))
        self.register_buffer("gray", torch.tensor(GRAY_WEIGHTS),
                             persistent=False)
        self.output_dims = [dim]
        self.scales = [8]
        self._random_init(seed)
        if conf.get("pretrained") == "superpoint":
            ckpt = Path(__file__).parent / "checkpoints" / "superpoint_v1.pth"
            if ckpt.exists():
                self.load_state_dict(read_checkpoint(ckpt, ("state_dict",)))
                logger.info("Loaded SuperPoint checkpoint from %s", ckpt)
            else:
                logger.warning(
                    "SuperPoint weights not found at %s (zero-egress "
                    "environment); using deterministic random init.", ckpt)

    def net(self, gray: torch.Tensor):
        """``[B, 1, H, W]`` -> (semi ``[B, 65, H/8, W/8]``, desc ``[B, C,
        H/8, W/8]``)."""
        with _no_tf32():
            x = gray
            for i, name in enumerate(n for n, *_ in SUPERPOINT_LAYERS[:8]):
                x = F.relu(getattr(self, name)(x))
                if i in (1, 3, 5):
                    x = F.max_pool2d(x, 2, 2)
            semi = self.convPb(F.relu(self.convPa(x)))
            desc = self.convDb(F.relu(self.convDa(x)))
        return semi, desc

    def forward(self, image: torch.Tensor):
        """``[B, 3, H, W]`` in [0, 1] -> ``[desc map]`` (unnormalized)."""
        gray = (image * self.gray.view(3, 1, 1)).sum(1, keepdim=True)
        return [self.net(gray)[1]]

    @torch.no_grad()
    def detect(self, image) -> Dict[str, np.ndarray]:
        """``image [B, H, W, 3]`` (or ``[B, H, W, 1]``) float32 in [0, 1],
        numpy or tensor -> dict(keypoints ``[B, K, 2]``, scores ``[B, K]``,
        valid ``[B, K]``, descriptors ``[B, K, C]``) as numpy; K =
        ``max_keypoints`` (padded)."""
        conf = self.conf
        img = to_nhwc_batch(image, self.device)
        gray = img if img.shape[-1] == 1 else \
            (img * self.gray).sum(-1, keepdim=True)
        semi, desc = self.net(gray.permute(0, 3, 1, 2))
        scores = superpoint_scores_dense(semi.permute(0, 2, 3, 1))
        scores = simple_nms(scores, int(conf.nms_radius))
        xy, val, ok = select_keypoints(scores, int(conf.max_keypoints),
                                       float(conf.keypoint_threshold),
                                       int(conf.remove_borders))
        d = sample_descriptors_coarse8(xy, desc.permute(0, 2, 3, 1))
        return detection_output(xy, val, ok, d)


def params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`SuperPoint` from the JAX model's
    ``variables``: kernels HWIO -> OIHW under the public names."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, *_ in SUPERPOINT_LAYERS:
        sd[f"{name}.weight"] = oihw(params[name]["kernel"])
        sd[f"{name}.bias"] = vec(params[name]["bias"])
    return sd
