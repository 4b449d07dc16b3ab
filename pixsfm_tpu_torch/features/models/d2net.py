"""D2-Net — joint detection and description from one dense map.

Port of ``pixsfm_tpu/features/models/d2net.py`` as an ``nn.Module`` in
NCHW: the public test-time network (mihaidusmanu/d2-net
``lib/model_test.py``), VGG16 cut at conv4_3 — conv1_1..conv1_2 / pool
(2, 2) / conv2_1..conv2_2 / pool (2, 2) / conv3_1..conv3_3 / pool (2,
stride 1) / conv4_1..conv4_3 with dilation 2 — a stride-4 512-d map; the
last conv has no ReLU. The stride-1 pool keeps torch's VALID semantics: it
drops one row and one column before the dilated convolutions. Input
preprocessing is Caffe's: RGB -> BGR, x255, minus the VGG mean.

Detection is the public ``HardDetectionModule`` (a cell is a keypoint iff
some channel is the depth-wise max, a 3x3 local max of its plane and not
edge-like by the 2x2 Hessian test), then the ``HandcraftedLocalizationModule``
sub-pixel Newton step and bilinear descriptors at the refined position;
positions map back through the two 2x poolings as ``4 p + 1.5``.

The submodules carry the public checkpoint's names
(``dense_feature_extraction.model.N``), so ``checkpoints/d2_tf.pth``
loads with ``load_state_dict``. Convolutions run with cuDNN's TF32 off.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import logger
from .base_model import BaseModel, oihw, read_checkpoint, to_nhwc_batch, vec
from .s2dnet import _no_tf32
from .superpoint import detection_output, select_keypoints

__all__ = ["D2Net", "params_from_flax", "D2NET_CONV_PLAN", "hard_detection",
           "CAFFE_MEAN_BGR"]

# Caffe preprocessing mean (BGR order), as the public
# ``preprocess_image(..., preprocessing='caffe')``.
CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)

# (out_ch, dilation, relu_after, pool_after) — pool_after in
# {None, "2x2", "2x1"} (kernel 2 with stride 2 / stride 1).
D2NET_CONV_PLAN = [
    (64, 1, True, None),    # conv1_1
    (64, 1, True, "2x2"),   # conv1_2 + pool1
    (128, 1, True, None),   # conv2_1
    (128, 1, True, "2x2"),  # conv2_2 + pool2
    (256, 1, True, None),   # conv3_1
    (256, 1, True, None),   # conv3_2
    (256, 1, True, "2x1"),  # conv3_3 + pool3 (stride 1)
    (512, 2, True, None),   # conv4_1 (dilated)
    (512, 2, True, None),   # conv4_2 (dilated)
    (512, 2, False, None),  # conv4_3 (dilated, no ReLU)
]


def _conv_slots() -> List[int]:
    """Slot of each conv in the public ``nn.Sequential``."""
    out, slot = [], 0
    for _, _, relu, pool in D2NET_CONV_PLAN:
        out.append(slot)
        slot += 1 + int(relu) + int(pool is not None)
    return out


def _channel_hessian_gate(fmap: torch.Tensor, edge_threshold: float):
    """Per-channel 2x2 Hessian edge rejection on ``[B, H, W, C]`` with the
    public ``HardDetectionModule``'s difference filters and zero padding."""
    p = F.pad(fmap, (0, 0, 1, 1, 1, 1))
    up, down = p[:, :-2, 1:-1], p[:, 2:, 1:-1]
    left, right = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    ul, ur = p[:, :-2, :-2], p[:, :-2, 2:]
    dl, dr = p[:, 2:, :-2], p[:, 2:, 2:]
    dii = up - 2.0 * fmap + down
    djj = left - 2.0 * fmap + right
    dij = 0.25 * (ul - ur - dl + dr)
    det = dii * djj - dij * dij
    tr = dii + djj
    r = edge_threshold
    thr = (r + 1.0) ** 2 / r
    return (det > 0.0) & (tr * tr <= thr * det)


def hard_detection(fmap: torch.Tensor,
                   edge_threshold: float = 5.0) -> torch.Tensor:
    """The public ``HardDetectionModule``: ``[B, H, W, C]`` dense map ->
    score map ``[B, H, W]`` (the depth-wise max where all three gates pass,
    0 elsewhere)."""
    depth_max = fmap.amax(dim=-1)
    is_depth_max = fmap == depth_max[..., None]
    local_max = F.max_pool2d(fmap.permute(0, 3, 1, 2), 3, stride=1,
                             padding=1).permute(0, 2, 3, 1)
    detected = (is_depth_max & (fmap == local_max)
                & _channel_hessian_gate(fmap, edge_threshold)).any(dim=-1)
    return torch.where(detected, depth_max, torch.zeros_like(depth_max))


def _refine(fm: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    """Sub-pixel Newton step on the depth-max channel's plane and bilinear
    descriptors of one ``[H, W, C]`` map at cells ``(i, j) [K]``:
    (fi, fj, good, desc ``[K, C]``). A displacement past half a cell drops
    the point, as the public mask does."""
    H, W, _ = fm.shape
    c = torch.argmax(fm[i, j], dim=-1)

    def tap(di, dj):
        return fm[torch.clamp(i + di, 0, H - 1),
                  torch.clamp(j + dj, 0, W - 1), c]

    f0 = tap(0, 0)
    di_ = 0.5 * (tap(1, 0) - tap(-1, 0))
    dj_ = 0.5 * (tap(0, 1) - tap(0, -1))
    dii = tap(-1, 0) - 2.0 * f0 + tap(1, 0)
    djj = tap(0, -1) - 2.0 * f0 + tap(0, 1)
    dij = 0.25 * (tap(-1, -1) - tap(-1, 1) - tap(1, -1) + tap(1, 1))
    det = dii * djj - dij * dij
    singular = torch.abs(det) < 1e-10
    safe = torch.where(singular, torch.ones_like(det), det)
    disp_i = -(djj * di_ - dij * dj_) / safe
    disp_j = -(dii * dj_ - dij * di_) / safe
    good = ~singular & (torch.abs(disp_i) < 0.5) & (torch.abs(disp_j) < 0.5)
    zero = torch.zeros_like(disp_i)
    fi = i.to(torch.float32) + torch.where(good, disp_i, zero)
    fj = j.to(torch.float32) + torch.where(good, disp_j, zero)
    # bilinear descriptor interpolation at the refined position (public
    # interpolate_dense_features)
    i0 = torch.clamp(torch.floor(fi).long(), 0, H - 2)
    j0 = torch.clamp(torch.floor(fj).long(), 0, W - 2)
    wi = (fi - i0)[:, None]
    wj = (fj - j0)[:, None]
    d = ((1 - wi) * (1 - wj) * fm[i0, j0]
         + (1 - wi) * wj * fm[i0, j0 + 1]
         + wi * (1 - wj) * fm[i0 + 1, j0]
         + wi * wj * fm[i0 + 1, j0 + 1])
    return fi, fj, good, d


class D2Net(BaseModel):
    """Dense-feature-model view: the stride-4 512-d map as one level, plus
    :meth:`detect` for the joint detector."""

    default_conf = {
        "max_keypoints": 2048,
        "edge_threshold": 5.0,
        "pretrained": "d2net",
    }

    def _init(self, conf, seed: int):
        layers, in_ch = [], 3
        for ch, d, relu, pool in D2NET_CONV_PLAN:
            layers.append(nn.Conv2d(in_ch, ch, 3, padding=d, dilation=d))
            if relu:
                layers.append(nn.ReLU())
            if pool == "2x2":
                layers.append(nn.MaxPool2d(2, stride=2))
            elif pool == "2x1":
                layers.append(nn.MaxPool2d(2, stride=1))
            in_ch = ch
        self.dense_feature_extraction = nn.Module()
        self.dense_feature_extraction.model = nn.Sequential(*layers)
        self.register_buffer("mean_bgr", torch.tensor(CAFFE_MEAN_BGR),
                             persistent=False)
        self.output_dims = [512]
        self.scales = [4]
        self._random_init(seed)
        if conf.get("pretrained") == "d2net":
            ckpt = Path(__file__).parent / "checkpoints" / "d2_tf.pth"
            if ckpt.exists():
                sd = read_checkpoint(ckpt, ("state_dict", "model"))
                if not any(k.startswith("dense_feature_extraction.")
                           for k in sd):
                    sd = {f"dense_feature_extraction.{k}": v
                          for k, v in sd.items()}
                self.load_state_dict(sd)
                logger.info("Loaded D2-Net checkpoint from %s", ckpt)
            else:
                logger.warning(
                    "D2-Net weights not found at %s (zero-egress "
                    "environment); using deterministic random init.", ckpt)

    def preprocess_caffe(self, image_nhwc: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` RGB in [0, 1] -> Caffe BGR ``[B, 3, H, W]``,
        x255, mean-subtracted."""
        bgr = image_nhwc.flip(-1) * 255.0 - self.mean_bgr
        return bgr.permute(0, 3, 1, 2)

    def net(self, x: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            return self.dense_feature_extraction.model(x)

    def forward(self, image: torch.Tensor):
        return [self.net(self.preprocess_caffe(image.permute(0, 2, 3, 1)))]

    @torch.no_grad()
    def detect(self, image) -> Dict[str, np.ndarray]:
        """``image [B, H, W, 3]`` float32 in [0, 1] (H, W multiples of 4)
        -> dict(keypoints ``[B, K, 2]`` image pixels, scores, valid,
        descriptors ``[B, K, 512]`` L2-normalized) as numpy, K static."""
        conf = self.conf
        img = to_nhwc_batch(image, self.device)
        fmap = self.net(self.preprocess_caffe(img)).permute(0, 2, 3, 1)
        score = hard_detection(fmap, float(conf.edge_threshold))
        xy, val, ok = select_keypoints(score, int(conf.max_keypoints), 0.0,
                                       border=1)
        ii, jj = xy[..., 1].long(), xy[..., 0].long()
        out = [_refine(fmap[b], ii[b], jj[b]) for b in range(len(fmap))]
        fi, fj, good, d = (torch.stack(t) for t in zip(*out))
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                            min=1e-8)
        # upscale_positions with 2 scaling steps: p -> 2p + 0.5 twice
        xy_img = torch.stack([fj, fi], dim=-1) * 4.0 + 1.5
        return detection_output(xy_img, val, ok & good & (val > 0), d)


def params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`D2Net` from the JAX model's ``variables``,
    under the public names."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i, slot in enumerate(_conv_slots()):
        pre = f"dense_feature_extraction.model.{slot}"
        sd[f"{pre}.weight"] = oihw(params[f"conv{i}"]["kernel"])
        sd[f"{pre}.bias"] = vec(params[f"conv{i}"]["bias"])
    return sd
