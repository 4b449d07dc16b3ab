"""LoFTR — detector-free transformer matching (coarse to fine).

Port of ``pixsfm_tpu/features/models/loftr.py`` as an ``nn.Module`` in
NCHW. The reference's ETH3D method matrix runs the public zju3dv/LoFTR
network (outdoor dual-softmax variant: grayscale input, resize_max 1024,
match aggregation with cell_size 1); this is that network:

1. **Backbone** ``ResNetFPN_8_2``: 7x7/s2 stem and three residual stages
   (128 / 196 / 256 channels) down to 1/8, an FPN top-down path back up to
   1/2: coarse features ``[B, 256, H/8, W/8]`` and fine features ``[B,
   128, H/2, W/2]``.
2. **Positional encoding**: 2-D sinusoidal, added to the coarse features,
   in the ``temp_bug_fix=False`` layout of the released checkpoints.
3. **Coarse transformer**: four (self, cross) linear-attention encoder
   layers (``elu(x) + 1`` feature map), d = 256, 8 heads.
4. **Coarse matching**: dual softmax over the ``[L, S]`` similarity with
   temperature 0.1, border removal, mutual maximum and confidence
   threshold, static top-K.
5. **Fine refinement**: 5x5 windows cut from the fine maps at each coarse
   match, the coarse vector projected and merged in (``fine_preprocess``),
   one (self, cross) fine transformer (d = 128), centre-vector correlation
   and a spatial expectation: the sub-pixel offset on image 1.

The submodules carry the public checkpoint's names (``backbone.*``,
``loftr_coarse.layers.N.*``, ``loftr_fine.layers.N.*``,
``fine_preprocess.*``), so ``checkpoints/outdoor_ds.ckpt`` (a
``{"state_dict": ...}`` file, keys optionally ``matcher.``-prefixed) loads
with ``load_state_dict(strict=True)`` when it is present; otherwise the
weights are a deterministic random init and a warning is logged.
:func:`params_from_flax` carries the JAX model's variables across.

Each cross layer updates both token sets from the other's input (as the
JAX package does), so the two images of a pair run as one batch of two.
Convolutions and matrix products run in float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math
from pathlib import Path
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import logger, resolve_device
from ...config import merge
from .base_model import oihw, read_checkpoint, vec
from .s2dnet import _no_tf32

__all__ = ["LoFTR", "params_from_flax", "position_encoding_sine",
           "upsample2x_align_corners", "linear_attention", "cut_windows",
           "BLOCK_DIMS", "INITIAL_DIM"]

INITIAL_DIM = 128
BLOCK_DIMS = (128, 196, 256)
COARSE_LAYERS = ("self", "cross") * 4
FINE_LAYERS = ("self", "cross")


@contextlib.contextmanager
def _full_fp32():
    """Float32 convolutions and matrix products without TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _no_tf32():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# plain functions
# ---------------------------------------------------------------------------

def position_encoding_sine(d_model: int, H: int, W: int,
                           temp_bug_fix: bool = False) -> np.ndarray:
    """2-D sinusoidal encoding ``[H, W, d_model]`` float32; positions start
    at 1 (cumsum of ones) as in the public ``PositionEncodingSine``. The
    released checkpoints were trained with ``temp_bug_fix=False``, whose
    ``//`` precedence bug collapses the frequency ladder; it is kept."""
    ks = np.arange(0, d_model // 2, 2, dtype=np.float64)
    if temp_bug_fix:
        div = np.exp(ks * (-math.log(10000.0) / (d_model // 2)))
    else:  # (-log(1e4) / d_model) // 2, the historical bug
        div = np.exp(ks * (-math.log(10000.0) / d_model // 2))
    ypos = np.arange(1, H + 1, dtype=np.float64)[:, None, None]
    xpos = np.arange(1, W + 1, dtype=np.float64)[None, :, None]
    pe = np.zeros((H, W, d_model), np.float32)
    pe[:, :, 0::4] = np.sin(xpos * div)
    pe[:, :, 1::4] = np.cos(xpos * div)
    pe[:, :, 2::4] = np.sin(ypos * div)
    pe[:, :, 3::4] = np.cos(ypos * div)
    return pe


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of ``[B, C, H, W]`` with
    ``align_corners=True`` (out[i] samples in[i (H - 1) / (2H - 1)])."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


def linear_attention(q, k, v):
    """``elu + 1`` kernelised attention over ``[B, L, h, d]`` (the public
    ``LinearAttention``): O(L) through the ``K^T V`` contraction."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    v_length = v.shape[1]
    v = v / v_length
    kv = torch.einsum("nshd,nshv->nhdv", k, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * v_length


def cut_windows(fmap: torch.Tensor, centers: torch.Tensor,
                w: int) -> torch.Tensor:
    """``w x w`` windows (w odd) of ``fmap [H, W, C]`` around integer
    ``centers [M, 2]`` (x, y), indices clamped to the map: ``[M, w*w, C]``."""
    H, W, C = fmap.shape
    r = w // 2
    off = torch.arange(-r, r + 1, device=fmap.device)
    yy = torch.clamp(centers[:, 1, None] + off[None, :], 0, H - 1)
    xx = torch.clamp(centers[:, 0, None] + off[None, :], 0, W - 1)
    win = fmap[yy[:, :, None], xx[:, None, :]]          # [M, w, w, C]
    return win.reshape(centers.shape[0], w * w, C)


# ---------------------------------------------------------------------------
# modules (public zju3dv/LoFTR names)
# ---------------------------------------------------------------------------

def _conv1x1(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 1, stride, 0, bias=False)


def _conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN plus a (1x1 / stride + BN) shortcut when
    the shape changes, then ReLU."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3x3(cin, planes, stride)
        self.conv2 = _conv3x3(planes, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None if stride == 1 and cin == planes else \
            nn.Sequential(_conv1x1(cin, planes, stride), nn.BatchNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetFPN_8_2(nn.Module):
    """Grayscale ``[B, 1, H, W]`` (H, W multiples of 8) -> (coarse ``[B,
    256, H/8, W/8]``, fine ``[B, 128, H/2, W/2]``)."""

    def __init__(self):
        super().__init__()
        d0, d1, d2 = BLOCK_DIMS
        self.conv1 = nn.Conv2d(1, INITIAL_DIM, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(INITIAL_DIM)
        self.layer1 = nn.Sequential(BasicBlock(INITIAL_DIM, d0),
                                    BasicBlock(d0, d0))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2), BasicBlock(d1, d1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2))
        self.layer3_outconv = _conv1x1(d2, d2)
        self.layer2_outconv = _conv1x1(d1, d2)
        self.layer2_outconv2 = nn.Sequential(
            _conv3x3(d2, d2), nn.BatchNorm2d(d2), nn.LeakyReLU(),
            _conv3x3(d2, d1))
        self.layer1_outconv = _conv1x1(d0, d1)
        self.layer1_outconv2 = nn.Sequential(
            _conv3x3(d1, d1), nn.BatchNorm2d(d1), nn.LeakyReLU(),
            _conv3x3(d1, d0))

    def forward(self, x):
        x1 = self.layer1(F.relu(self.bn1(self.conv1(x))))    # 1/2
        x2 = self.layer2(x1)                                 # 1/4
        x3 = self.layer3(x2)                                 # 1/8
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2)
                                      + upsample2x_align_corners(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1)
                                      + upsample2x_align_corners(x2_out))
        return x3_out, x1_out


class EncoderLayer(nn.Module):
    """Bias-free q / k / v / merge projections, linear attention, a
    concat-MLP residual update with two LayerNorms."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
            nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, source):
        B, L, d = x.shape
        S, h = source.shape[1], self.nhead
        q = self.q_proj(x).view(B, L, h, d // h)
        k = self.k_proj(source).view(B, S, h, d // h)
        v = self.v_proj(source).view(B, S, h, d // h)
        msg = self.norm1(self.merge(linear_attention(q, k, v).reshape(B, L,
                                                                      d)))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + msg


class LocalFeatureTransformer(nn.Module):
    """Alternating self / cross layers over a pair of token sets stacked
    as ``[2B, L, d]`` (image 0's first): a cross layer attends each half to
    the other half's input."""

    def __init__(self, d_model: int, nhead: int, layer_names: Sequence[str]):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead)
                                    for _ in self.layer_names)

    def forward(self, f):
        for layer, kind in zip(self.layers, self.layer_names):
            f = layer(f, f if kind == "self" else f.roll(f.shape[0] // 2, 0))
        return f


class FinePreprocess(nn.Module):
    """The public ``FinePreprocess`` projections (``cat_c_feat``): the
    coarse vector projected to 128 and merged with each window token."""

    def __init__(self):
        super().__init__()
        self.down_proj = nn.Linear(256, 128)
        self.merge_feat = nn.Linear(256, 128)

    def forward(self, win, cvec):
        # win [M, WW, 128], cvec [M, 256]
        c = self.down_proj(cvec)[:, None, :].expand(-1, win.shape[1], -1)
        return self.merge_feat(torch.cat([win, c], dim=-1))


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------

class LoFTR(nn.Module):
    """Pairwise detector-free matcher. ``match_pair(img0, img1)`` returns
    numpy ``(mkpts0 [K, 2], mkpts1 [K, 2], conf [K], valid [K])`` with
    static K = ``min(max_matches, cells)``, valid slots first by
    decreasing confidence.

    Coordinates follow the public convention: the coarse cell's integer
    grid x 8 on image 0, plus the fine sub-pixel offset on image 1."""

    default_conf = {
        "max_matches": 1024,
        "match_threshold": 0.2,
        "border_rm": 2,
        "dual_softmax_temperature": 0.1,
        "fine_window": 5,
        "temp_bug_fix": False,
        "pretrained": "loftr",
    }

    def __init__(self, conf=None, device=None, seed: int = 0):
        super().__init__()
        self.conf = merge(self.default_conf, conf or {})
        self.backbone = ResNetFPN_8_2()
        self.loftr_coarse = LocalFeatureTransformer(256, 8, COARSE_LAYERS)
        self.loftr_fine = LocalFeatureTransformer(128, 8, FINE_LAYERS)
        self.fine_preprocess = FinePreprocess()
        self._random_init(seed)
        if self.conf.get("pretrained") == "loftr":
            ckpt = Path(__file__).parent / "checkpoints" / "outdoor_ds.ckpt"
            if ckpt.exists():
                sd = read_checkpoint(ckpt, ("state_dict",),
                                     ("matcher.", "module."))
                # the public model's fixed encoding buffer is recomputed
                # here for each map size
                self.load_state_dict({k: v for k, v in sd.items()
                                      if not k.startswith("pos_encoding.")})
                logger.info("Loaded LoFTR checkpoint from %s", ckpt)
            else:
                logger.warning(
                    "LoFTR weights not found at %s (zero-egress "
                    "environment); using deterministic random init.", ckpt)
        self._pe: Dict[tuple, torch.Tensor] = {}
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _random_init(self, seed: int):
        """LeCun-normal weights and zero biases (Flax's defaults), drawn
        from an explicit generator; the norms stay the identity."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / math.sqrt(fan_in))
                    if m.bias is not None:
                        m.bias.zero_()

    def _encoding(self, d: int, hc: int, wc: int) -> torch.Tensor:
        key = (d, hc, wc)
        if key not in self._pe:
            pe = position_encoding_sine(d, hc, wc,
                                        bool(self.conf.temp_bug_fix))
            self._pe[key] = torch.from_numpy(pe).to(self.device).permute(
                2, 0, 1)
        return self._pe[key]

    @torch.no_grad()
    def coarse_features(self, img0: torch.Tensor, img1: torch.Tensor):
        """A grayscale pair ``[B, 1, H, W]`` -> transformed coarse tokens
        ``[B, L, 256]`` x2 and the fine maps ``[B, H/2, W/2, 128]`` x2 (the
        JAX package's layouts)."""
        with _full_fp32():
            c, f = self.backbone(torch.cat([img0, img1]))
            B2, d, hc, wc = c.shape
            t = (c + self._encoding(d, hc, wc)).flatten(2).transpose(1, 2)
            del c
            t = self.loftr_coarse(t)
        f = f.permute(0, 2, 3, 1)
        B = B2 // 2
        return t[:B], t[B:], f[:B], f[B:]

    @torch.no_grad()
    def fine_refine(self, win0, win1, cvec0, cvec1):
        """Fine windows ``[M, WW, 128]`` and coarse vectors ``[M, 256]`` at
        the matches -> the transformed windows of image 0 and image 1."""
        with _full_fp32():
            w = self.fine_preprocess(torch.cat([win0, win1]),
                                     torch.cat([cvec0, cvec1]))
            w = self.loftr_fine(w)
        M = win0.shape[0]
        return w[:M], w[M:]

    def _image(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            t = img.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
                self.device)
        return t[None, None]

    @torch.no_grad()
    def match_pair(self, img0, img1):
        """``img*`` ``[H, W]`` float32 grayscale in [0, 1] (numpy or
        tensor), one shape, H and W multiples of 8."""
        conf = self.conf
        H, W = img0.shape
        hc, wc = H // 8, W // 8
        # top-k needs k <= cells: small images clamp it
        K = min(int(conf.max_matches), hc * wc)
        thr = float(conf.match_threshold)
        border = int(conf.border_rm)
        temp = float(conf.dual_softmax_temperature)
        fine_w = int(conf.fine_window)
        t0, t1, f0, f1 = self.coarse_features(self._image(img0),
                                              self._image(img1))
        t0, t1 = t0[0], t1[0]
        d = t0.shape[-1]
        dev = t0.device
        # dual-softmax confidence, built in place: each [L, S] float32
        # temporary is 4 L^2 bytes (604 MB at 1024x768)
        with _full_fp32():
            ok = (t0 / d ** 0.5) @ (t1 / d ** 0.5).T
        ok.div_(temp)
        sm = torch.softmax(ok, dim=1)
        ok = torch.softmax(ok, dim=0).mul_(sm)
        del sm
        # border removal on both grids
        ii = torch.arange(hc * wc, device=dev)
        in0 = ((ii % wc >= border) & (ii % wc < wc - border)
               & (ii // wc >= border) & (ii // wc < hc - border)).to(
                   ok.dtype)
        ok.mul_(in0[:, None]).mul_(in0[None, :])
        # mutual maximum (by equality on this one tensor) and threshold
        keep = ok == ok.amax(dim=1, keepdim=True)
        keep &= ok == ok.amax(dim=0, keepdim=True)
        keep &= ok > thr
        ok.mul_(keep)
        del keep
        flat, jbest = ok.max(dim=1)                     # best per row
        del ok
        val, isel = torch.topk(flat, K)                 # [K], by value
        jsel = jbest[isel]
        valid = val > 0.0
        xy0 = torch.stack([isel % wc, isel // wc], dim=1)
        xy1 = torch.stack([jsel % wc, jsel // wc], dim=1)

        # fine refinement: 5x5 windows on the 1/2-resolution maps
        win0 = cut_windows(f0[0], xy0 * 4, fine_w)      # [K, WW, 128]
        win1 = cut_windows(f1[0], xy1 * 4, fine_w)
        w0, w1 = self.fine_refine(win0, win1, t0[isel], t1[jsel])
        cf = w0.shape[-1]
        center = (fine_w * fine_w) // 2
        simf = torch.einsum("mc,mrc->mr", w0[:, center], w1) / cf ** 0.5
        heat = torch.softmax(simf, dim=1).reshape(-1, fine_w, fine_w)
        grid = torch.arange(fine_w, dtype=heat.dtype, device=dev)
        # normalised spatial expectation in [-1, 1] (kornia's dsnt), scaled
        # to image pixels as the JAX package scales it
        gn = 2.0 * grid / (fine_w - 1) - 1.0
        ex = torch.einsum("mij,j->m", heat, gn)
        ey = torch.einsum("mij,i->m", heat, gn)
        offset = torch.stack([ex, ey], dim=1) * (fine_w // 2) * 2.0
        mk0 = xy0.to(torch.float32) * 8.0
        mk1 = xy1.to(torch.float32) * 8.0 + offset
        return tuple(o.cpu().numpy() for o in (mk0, mk1, val, valid))


def params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`LoFTR` under the public names from the JAX
    model's ``variables`` (``params`` and ``batch_stats``): the inverse of
    the JAX package's ``load_torch_loftr``."""
    params, stats = variables["params"], variables["batch_stats"]
    P, S = params["backbone"], stats["backbone"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(dst, p, s):
        sd[f"{dst}.weight"] = vec(p["scale"])
        sd[f"{dst}.bias"] = vec(p["bias"])
        sd[f"{dst}.running_mean"] = vec(s["mean"])
        sd[f"{dst}.running_var"] = vec(s["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def dense(dst, p):
        sd[f"{dst}.weight"] = vec(p["kernel"]).T.contiguous()
        if "bias" in p:
            sd[f"{dst}.bias"] = vec(p["bias"])

    sd["backbone.conv1.weight"] = oihw(P["conv1"]["kernel"])
    bn("backbone.bn1", P["bn1"], S["bn1"])
    for li in (1, 2, 3):
        for b in range(2):
            src, dst = P[f"layer{li}_{b}"], f"backbone.layer{li}.{b}"
            st = S[f"layer{li}_{b}"]
            for i in (1, 2):
                sd[f"{dst}.conv{i}.weight"] = oihw(src[f"conv{i}"]["kernel"])
                bn(f"{dst}.bn{i}", src[f"bn{i}"], st[f"bn{i}"])
            if "down_conv" in src:
                sd[f"{dst}.downsample.0.weight"] = oihw(
                    src["down_conv"]["kernel"])
                bn(f"{dst}.downsample.1", src["down_bn"], st["down_bn"])
    sd["backbone.layer3_outconv.weight"] = oihw(P["layer3_outconv"]["kernel"])
    for lvl in (2, 1):
        pre = f"backbone.layer{lvl}_outconv"
        sd[f"{pre}.weight"] = oihw(P[f"layer{lvl}_outconv"]["kernel"])
        sd[f"{pre}2.0.weight"] = oihw(P[f"layer{lvl}_outconv2_0"]["kernel"])
        bn(f"{pre}2.1", P[f"layer{lvl}_outconv2_bn"],
           S[f"layer{lvl}_outconv2_bn"])
        sd[f"{pre}2.3.weight"] = oihw(P[f"layer{lvl}_outconv2_1"]["kernel"])
    for mod, n_layers in (("loftr_coarse", len(COARSE_LAYERS)),
                          ("loftr_fine", len(FINE_LAYERS))):
        for i in range(n_layers):
            src, dst = params[mod][f"layer{i}"], f"{mod}.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                dense(f"{dst}.{proj}", src[proj])
            dense(f"{dst}.mlp.0", src["mlp_0"])
            dense(f"{dst}.mlp.2", src["mlp_1"])
            for norm in ("norm1", "norm2"):
                sd[f"{dst}.{norm}.weight"] = vec(src[norm]["scale"])
                sd[f"{dst}.{norm}.bias"] = vec(src[norm]["bias"])
    dense("fine_preprocess.down_proj", params["fine_head"]["down_proj"])
    dense("fine_preprocess.merge_feat", params["fine_head"]["merge_feat"])
    return sd
