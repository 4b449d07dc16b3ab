"""Keypoint detection + exhaustive descriptor matching front end.

Port of ``pixsfm_tpu/features/detectors.py``. The method names of the
reference's hloc configs (pixsfm/eval/eth3d/config.py:30-137) are
first-class:

- ``sift``: OpenCV SIFT + brute-force ratio matching on the host. It needs
  OpenCV (``cv2``) and raises ``ImportError`` without it.
- ``superpoint`` / ``r2d2`` / ``d2net``: the port's models
  (``features/models/``) with static-K detection on the device, and
  matching as one float32 matrix product per pair on the device (mutual
  nearest neighbour + ratio or similarity test, masked for padded slots).
- ``loftr`` (:func:`match_loftr_dir`): detector-free; LoFTR matches each
  pair on the device, and the matches are aggregated into keypoints.

Images are decoded with PIL, upright by their EXIF orientation as
``cv2.imread`` makes them, and shrunk to ``max_edge`` by :func:`resize_area`
(RGB, OpenCV's ``INTER_AREA``) or :func:`resize_linear` (grayscale for
LoFTR, OpenCV's ``INTER_LINEAR``), each reproducing OpenCV bit for bit
(the JAX package reads with ``cv2.imread`` and ``cv2.resize``). All
detectors return COLMAP-convention keypoints (pixel centres at +0.5).
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import logger, resolve_device

__all__ = ["detect_directory", "match_exhaustive", "detect_and_match_dir",
           "mutual_nn_ratio_match", "match_loftr_dir",
           "aggregate_semidense_matches", "resize_area", "resize_linear",
           "load_rgb", "load_gray"]


def _area_taps(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab`` for one axis: ``(src [d, m],
    alpha [d, m])`` float32, the source indices and weights of each output
    index in OpenCV's order (unused taps have weight 0)."""
    taps: List[List[Tuple[int, float]]] = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    m = max(len(r) for r in taps)
    src = np.zeros((dsize, m), np.int64)
    alpha = np.zeros((dsize, m), np.float32)
    for dx, row in enumerate(taps):
        for k, (s, a) in enumerate(row):
            src[dx, k], alpha[dx, k] = s, np.float32(a)
    return src, alpha


def resize_area(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Shrink a uint8 ``[H, W]`` or ``[H, W, c]`` image by the factors
    ``fx, fy <= 1`` as ``cv2.resize(img, None, fx=fx, fy=fy,
    interpolation=cv2.INTER_AREA)`` does: output size rounded from ``W fx,
    H fy``, each output pixel the area-weighted mean of the source pixels
    its cell covers (OpenCV's ``resizeArea_``: float32 sums of the column
    taps, then of the row taps, in OpenCV's order; rounded half to even).
    Integer factors take OpenCV's block average (``resizeAreaFast_``),
    whose 2x2 blocks round ties up as its vector path does."""
    H, W = img.shape[:2]
    dw, dh = int(round(W * fx)), int(round(H * fy))
    if (dh, dw) == (H, W):
        return img.copy()
    sx, sy = 1.0 / fx, 1.0 / fy
    src = img.astype(np.float32)
    if abs(sx - round(sx)) < np.finfo(np.float64).eps and \
            abs(sy - round(sy)) < np.finfo(np.float64).eps:
        # resizeAreaFast_: whole blocks sum * (1 / area), cells cut by the
        # border the mean of the pixels they hold
        ix, iy = int(round(sx)), int(round(sy))
        pad = np.zeros((dh * iy, dw * ix) + img.shape[2:], np.int64)
        cnt = np.zeros((dh * iy, dw * ix), np.int64)
        h, w = min(H, dh * iy), min(W, dw * ix)
        pad[:h, :w] = img[:h, :w]
        cnt[:h, :w] = 1
        sums = pad.reshape(dh, iy, dw, ix, *img.shape[2:]).sum((1, 3))
        n = cnt.reshape(dh, iy, dw, ix).sum((1, 3))
        n = n.reshape(n.shape + (1,) * (img.ndim - 2))
        full = sums.astype(np.float32) * np.float32(1.0 / (ix * iy))
        full = (sums + 2) >> 2 if ix == iy == 2 else np.rint(full)
        part = np.rint(sums.astype(np.float32)
                       / np.maximum(n, 1).astype(np.float32))
        out = np.where(n == ix * iy, full, part)
        return np.clip(out, 0, 255).astype(np.uint8)
    xs, xa = _area_taps(W, dw, sx)
    ys, ya = _area_taps(H, dh, sy)
    col_shape = (1, -1) + (1,) * (img.ndim - 2)
    row_shape = (-1,) + (1,) * (img.ndim - 1)
    cols = np.zeros((H, dw) + img.shape[2:], np.float32)
    for k in range(xs.shape[1]):
        cols += src[:, xs[:, k]] * xa[:, k].reshape(col_shape)
    out = np.zeros((dh, dw) + img.shape[2:], np.float32)
    for k in range(ys.shape[1]):
        out += cols[ys[:, k]] * ya[:, k].reshape(row_shape)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


_COEF_BITS = 11


def _linear_taps(ssize: int, dsize: int, scale: float, clamp: bool):
    """OpenCV's ``INTER_LINEAR`` taps for one axis: (first source index
    ``[d]``, the two 11-bit fixed-point weights ``[d]`` each) at positions
    ``(d + 0.5) scale - 0.5`` in float32. ``clamp`` (the columns): a tap
    past either end takes the end pixel with weights (1, 0); the rows keep
    their weights and only their indices are clipped (by the caller)."""
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= ssize - 1)] = 0.0
        s = np.clip(s, 0, ssize - 1)
    one = np.float32(1 << _COEF_BITS)
    return (s, np.rint((np.float32(1.0) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Shrink a uint8 ``[H, W]`` or ``[H, W, c]`` image as
    ``cv2.resize(img, None, fx=fx, fy=fy)`` (``INTER_LINEAR``) does on
    x86: 11-bit fixed-point weights, exact integer rows, and OpenCV's
    vector column pass, which drops 4 bits of each row sum before a
    16-bit high multiply. A factor of exactly 1/2 is OpenCV's
    ``INTER_AREA`` (:func:`resize_area`), as ``cv2.resize`` switches."""
    H, W = img.shape[:2]
    dw, dh = int(round(W * fx)), int(round(H * fy))
    if (dh, dw) == (H, W):
        return img.copy()
    sx, sy = 1.0 / fx, 1.0 / fy
    if sx == sy == 2.0:
        return resize_area(img, fx, fy)
    xs, a0, a1 = _linear_taps(W, dw, sx, clamp=True)
    ys, b0, b1 = _linear_taps(H, dh, sy, clamp=False)
    src = img.astype(np.int64)
    cshape = (1, -1) + (1,) * (img.ndim - 2)
    rows = src[:, xs] * a0.reshape(cshape) \
        + src[:, np.minimum(xs + 1, W - 1)] * a1.reshape(cshape)
    rshape = (-1,) + (1,) * (img.ndim - 1)
    top = ((rows[np.clip(ys, 0, H - 1)] >> 4) * b0.reshape(rshape)) >> 16
    bot = ((rows[np.clip(ys + 1, 0, H - 1)] >> 4)
           * b1.reshape(rshape)) >> 16
    return np.clip((top + bot + 2) >> 2, 0, 255).astype(np.uint8)


def load_rgb(path, max_edge: int):
    """Decode an image with PIL as RGB (upright by its EXIF orientation)
    and shrink it to ``max_edge`` with :func:`resize_area`: (``[H, W, 3]``
    float32 in [0, 1], scale)."""
    import PIL.Image
    import PIL.ImageOps

    img = PIL.ImageOps.exif_transpose(PIL.Image.open(path))
    img = np.asarray(img.convert("RGB"))
    scale = 1.0
    if max(img.shape[:2]) > max_edge:
        scale = max_edge / max(img.shape[:2])
        img = resize_area(img, scale, scale)
    return img.astype(np.float32) / 255.0, scale


def _gray_u8(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` without OpenCV, upright
    by the EXIF tag: a JPEG decodes to its luma plane (libjpeg's grayscale
    output); a colour PNG takes libpng's ``rgb_to_gray`` with OpenCV's
    coefficients (0.299, 0.587 in 15-bit fixed point, truncated; grey
    pixels kept); other images take PIL's ``L`` conversion."""
    import PIL.Image
    import PIL.ImageOps

    img = PIL.Image.open(path)
    fmt = img.format
    if fmt == "JPEG" and img.mode in ("L", "RGB", "YCbCr"):
        img.draft("L", img.size)
    img = PIL.ImageOps.exif_transpose(img)
    if fmt == "PNG" and img.mode in ("RGB", "RGBA", "P", "PA"):
        rgb = np.asarray(img.convert("RGB")).astype(np.int64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        gray = (9797 * r + 19234 * g + 3737 * b) >> 15
        return np.where((r == g) & (g == b), r, gray).astype(np.uint8)
    return np.asarray(img.convert("L"))


def load_gray(path, max_edge: int):
    """Decode an image as 8-bit grayscale (:func:`_gray_u8`) and shrink it
    to ``max_edge`` with :func:`resize_linear`, as the JAX package's LoFTR
    front end does with ``cv2.imread`` and ``cv2.resize``: (``[H, W]``
    float32 in [0, 1], scale)."""
    img = _gray_u8(path)
    scale = 1.0
    if max(img.shape) > max_edge:
        scale = max_edge / max(img.shape)
        img = resize_linear(img, scale, scale)
    return img.astype(np.float32) / 255.0, scale


def _pad_to(img, H, W):
    h, w = img.shape[:2]
    out = np.zeros((H, W, 3), np.float32)
    out[:h, :w] = img
    return out


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the 'sift' method needs OpenCV (cv2.SIFT_create and "
            "cv2.BFMatcher), which is not installed") from e
    return cv2


def _detect_sift(image_dir: Path, names: List[str], max_edge: int,
                 n_features: int):
    cv2 = _cv2()
    sift = cv2.SIFT_create(nfeatures=n_features)
    kps, descs = {}, {}
    for name in names:
        img = cv2.imread(str(image_dir / name), cv2.IMREAD_GRAYSCALE)
        scale = 1.0
        if max(img.shape) > max_edge:
            scale = max_edge / max(img.shape)
            img = cv2.resize(img, None, fx=scale, fy=scale)
        kp, des = sift.detectAndCompute(img, None)
        kps[name] = (np.array([k.pt for k in kp], np.float64) + 0.5) / scale
        descs[name] = des
    return kps, descs, {n: np.ones(len(kps[n]), bool) for n in names}


def detect_directory(image_dir: Path, names: List[str], method: str = "sift",
                     max_edge: int = 1600, n_features: int = 8000,
                     conf: Optional[dict] = None, device=None):
    """Detect keypoints in every image. Returns (kps, descs, valid) dicts:
    ``kps[name] [N, 2]`` float64 (+0.5 centre convention, full-resolution
    coordinates), ``descs[name] [N, C]`` float32, ``valid[name] [N]`` bool
    (meaningful for the static-K learned detectors). ``device``: where the
    learned detectors run (``cuda`` unless ``"cpu"``)."""
    image_dir = Path(image_dir)
    if method == "sift":
        return _detect_sift(image_dir, names, max_edge, n_features)

    from .models import get_model

    model_conf = dict(conf or {})
    model_conf.setdefault("max_keypoints", min(n_features, 4096))
    model = get_model(method)(model_conf, device=resolve_device(device))
    if not hasattr(model, "detect"):
        raise ValueError(f"model {method!r} has no detect()")

    kps, descs, valid = {}, {}, {}
    loaded = {n: load_rgb(image_dir / n, max_edge) for n in names}
    H = max(im.shape[0] for im, _ in loaded.values())
    W = max(im.shape[1] for im, _ in loaded.values())
    # one padded size, a multiple of 64 (the detectors' strides)
    H, W = -(-H // 64) * 64, -(-W // 64) * 64
    for name in names:
        img, scale = loaded[name]
        out = model.detect(_pad_to(img, H, W)[None])
        xy = out["keypoints"][0]
        # reject detections inside the padding margin
        ok = out["valid"][0] & (xy[:, 0] < img.shape[1] - 0.5) \
            & (xy[:, 1] < img.shape[0] - 0.5)
        kps[name] = (xy.astype(np.float64) + 0.5) / scale
        descs[name] = np.asarray(out["descriptors"][0], np.float32)
        valid[name] = ok
    return kps, descs, valid


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 matrix products in full precision (no TF32) on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _as_tensor(a, device, dtype):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                          dtype=dtype)


def mutual_nn_ratio_match(d1, d2, v1, v2, ratio: float = 0.95,
                          min_similarity: float = -1.0, device=None):
    """Masked mutual-NN + ratio matching of L2-normalized descriptor sets
    (``[K1, C]``, ``[K2, C]`` with validity masks; numpy or tensors): one
    float32 product and two argmaxes on ``device`` (``cuda`` unless
    ``"cpu"``).

    Returns (pairs ``[M, 2]`` int64, scores ``[M]`` float32) as numpy."""
    dev = resolve_device(device)
    d1, d2 = (_as_tensor(d, dev, torch.float32) for d in (d1, d2))
    v1, v2 = (_as_tensor(v, dev, torch.bool) for v in (v1, v2))
    with _full_fp32_matmul():
        sim = d1 @ d2.T                                  # [K1, K2] cosine
    neg = torch.tensor(-math.inf, device=dev)
    sim = torch.where(v1[:, None] & v2[None, :], sim, neg)
    nn12 = torch.argmax(sim, dim=1)
    nn21 = torch.argmax(sim, dim=0)
    rows = torch.arange(sim.shape[0], device=dev)
    best = sim[rows, nn12]
    # ratio test in distance space: d^2 = 2 - 2 sim for unit vectors
    sim[rows, nn12] = neg
    second = sim.amax(dim=1)
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=1e-12))
    keep = (nn21[nn12] == rows) & (best > min_similarity) \
        & (d_best < ratio * d_second) & torch.isfinite(best)
    idx = torch.nonzero(keep).flatten()
    pairs = torch.stack([idx, nn12[idx]], dim=1).cpu().numpy()
    return pairs.astype(np.int64), best[idx].cpu().numpy().astype(np.float32)


# reference match_configs (pixsfm/eval/eth3d/config.py:95-119): learned
# descriptors take mutual NN + a similarity threshold (distance threshold
# sqrt(2 (1 - sim))), no ratio test
SIM_THRESH = {"superpoint": 0.755, "d2net": 0.8, "r2d2": 0.9}


def match_exhaustive(names: List[str], descs: Dict, valid: Dict,
                     method: str = "sift", ratio: float = None,
                     min_matches: int = 15, device=None
                     ) -> Tuple[Dict, Dict]:
    """All-pairs matching. Returns (matches, scores) dicts keyed by
    ``(name_i, name_j)`` with i < j in ``names`` order. ``sift`` matches on
    the host with OpenCV; the learned methods on ``device``."""
    matches, scores = {}, {}
    if method == "sift":
        cv2 = _cv2()
        bf = cv2.BFMatcher(cv2.NORM_L2)
        r = 0.8 if ratio is None else ratio
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                if descs[names[i]] is None or descs[names[j]] is None:
                    continue
                raw = bf.knnMatch(descs[names[i]], descs[names[j]], k=2)
                good = [m for m, n in raw if m.distance < r * n.distance]
                if len(good) < min_matches:
                    continue
                m = np.array([[g.queryIdx, g.trainIdx] for g in good],
                             np.int64)
                matches[(names[i], names[j])] = m
                scores[(names[i], names[j])] = np.array(
                    [1.0 - g.distance / 512.0 for g in good], np.float32)
        return matches, scores

    if ratio is None and method in SIM_THRESH:
        r, min_sim = math.inf, SIM_THRESH[method]
    else:
        r, min_sim = (0.95 if ratio is None else ratio), -1.0
    dev = resolve_device(device)
    # each image's descriptors go to the device once
    d = {n: _as_tensor(descs[n], dev, torch.float32) for n in names}
    v = {n: _as_tensor(valid[n], dev, torch.bool) for n in names}
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            m, s = mutual_nn_ratio_match(d[names[i]], d[names[j]],
                                         v[names[i]], v[names[j]],
                                         ratio=r, min_similarity=min_sim,
                                         device=dev)
            if len(m) < min_matches:
                continue
            matches[(names[i], names[j])] = m
            scores[(names[i], names[j])] = s
    return matches, scores


def detect_and_match_dir(image_dir: Path, names: List[str],
                         method: str = "sift", max_edge: int = 1600,
                         n_features: int = 8000,
                         detector_conf: Optional[dict] = None,
                         ratio: float = None, device=None,
                         stats: Optional[Dict] = None):
    """Detection + exhaustive matching. Returns (kps, matches, scores);
    geometric verification is the caller's (``sfm.two_view.
    verify_all_pairs``). ``stats``, when given, receives the two stages'
    wall times (``detection_s``, ``matching_s``) and
    ``keypoints_per_image``."""
    stats = {} if stats is None else stats
    t0 = time.time()
    kps, descs, valid = detect_directory(image_dir, names, method=method,
                                         max_edge=max_edge,
                                         n_features=n_features,
                                         conf=detector_conf, device=device)
    stats["detection_s"] = time.time() - t0
    stats["keypoints_per_image"] = float(np.mean(
        [np.sum(valid[n]) for n in names]))
    logger.info("detect[%s]: %d images, %.0f keypoints/image", method,
                len(names), stats["keypoints_per_image"])
    t0 = time.time()
    matches, scores = match_exhaustive(names, descs, valid, method=method,
                                       ratio=ratio, device=device)
    stats["matching_s"] = time.time() - t0
    return kps, matches, scores


# ---------------------------------------------------------------------------
# detector-free (LoFTR) front end: match first, aggregate matches to features
# ---------------------------------------------------------------------------

def aggregate_semidense_matches(pair_matches: Dict, cell_size: float = 1.0):
    """Per-pair semi-dense match coordinates -> per-image keypoint lists +
    index matches (the reference's loftr flow: "we match first and then
    aggregate matches to features", at most one keypoint per ``cell_size``
    cell, reference eval/eth3d/config.py:120-131).

    ``pair_matches``: ``{(name0, name1): (xy0 [M, 2], xy1 [M, 2], conf
    [M])}`` with full-resolution +0.5-convention coordinates. Returns (kps,
    matches, scores): ``kps[name] [N, 2]`` = per-cell running-mean
    coordinates; ``matches[(n0, n1)] [K, 2]`` int64 keypoint indices, one
    to one within a pair (greedy by confidence)."""
    ids: Dict[str, Dict[Tuple[int, int], int]] = {}
    sums: Dict[str, list] = {}
    counts: Dict[str, list] = {}

    def kp_id(name, xy):
        cell = (int(np.floor(xy[0] / cell_size)),
                int(np.floor(xy[1] / cell_size)))
        table = ids.setdefault(name, {})
        if cell not in table:
            table[cell] = len(table)
            sums.setdefault(name, []).append(np.array(xy, np.float64))
            counts.setdefault(name, []).append(1)
        else:
            i = table[cell]
            sums[name][i] += xy
            counts[name][i] += 1
        return table[cell]

    matches, scores = {}, {}
    for (n0, n1), (xy0, xy1, conf) in pair_matches.items():
        best: Dict[Tuple[int, int], Tuple[float, int, int]] = {}
        for k in range(len(xy0)):
            i0 = kp_id(n0, xy0[k])
            i1 = kp_id(n1, xy1[k])
            c = float(conf[k])
            if (i0, i1) not in best or c > best[(i0, i1)][0]:
                best[(i0, i1)] = (c, i0, i1)
        # one to one within the pair: several matches can quantize into
        # one source cell with different target cells; keep the most
        # confident assignment per i0 and per i1
        used0, used1 = set(), set()
        vals = []
        for c, i0, i1 in sorted(best.values(), reverse=True):
            if i0 in used0 or i1 in used1:
                continue
            used0.add(i0)
            used1.add(i1)
            vals.append((c, i0, i1))
        if vals:
            vals.sort(key=lambda t: (t[1], t[2]))
            matches[(n0, n1)] = np.array([[i0, i1] for _, i0, i1 in vals],
                                         np.int64)
            scores[(n0, n1)] = np.array([c for c, _, _ in vals], np.float32)

    kps = {name: np.stack(sums[name]) / np.array(counts[name])[:, None]
           for name in sums}
    return kps, matches, scores


def match_loftr_dir(image_dir: Path, names: List[str],
                    max_edge: int = 1024, matcher_conf: Optional[dict] = None,
                    cell_size: float = 1.0, min_matches: int = 15,
                    device=None, stats: Optional[Dict] = None):
    """Detector-free front end: exhaustive LoFTR pair matching on
    ``device`` (``cuda`` unless ``"cpu"``) + semi-dense aggregation. Same
    return contract as :func:`detect_and_match_dir` (kps, matches, scores)
    with full-resolution +0.5 keypoints, so the graph / KA / SfM stages
    downstream do not depend on the method.

    Images decode as ``cv2.imread(..., IMREAD_GRAYSCALE)`` and shrink as
    ``cv2.resize`` do (:func:`load_gray`), and are padded to one shared /64
    size; matches that land in the padding are rejected. ``stats``, when
    given, receives ``matching_s``, ``keypoints_per_image`` and
    ``matched_pairs`` (pairs with at least ``min_matches`` matches)."""
    from .models.loftr import LoFTR

    stats = {} if stats is None else stats
    t0 = time.time()
    image_dir = Path(image_dir)
    matcher = LoFTR(matcher_conf or {}, device=resolve_device(device))
    loaded = {}
    for name in names:
        try:
            loaded[name] = load_gray(image_dir / name, max_edge)
        except OSError as e:     # missing, or PIL cannot identify it
            raise FileNotFoundError(
                f"cannot read image {image_dir / name} (missing or not a "
                "decodable image)") from e
    H = max(im.shape[0] for im, _ in loaded.values())
    W = max(im.shape[1] for im, _ in loaded.values())
    H, W = -(-H // 64) * 64, -(-W // 64) * 64
    padded = {n: _pad_to(im[..., None], H, W)[..., 0]
              for n, (im, _) in loaded.items()}

    pair_matches = {}
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            n0, n1 = names[i], names[j]
            (im0, s0), (im1, s1) = loaded[n0], loaded[n1]
            mk0, mk1, conf, valid = matcher.match_pair(padded[n0],
                                                       padded[n1])
            keep = valid \
                & (mk0[:, 0] < im0.shape[1] - 0.5) \
                & (mk0[:, 1] < im0.shape[0] - 0.5) \
                & (mk1[:, 0] < im1.shape[1] - 0.5) \
                & (mk1[:, 1] < im1.shape[0] - 0.5)
            if keep.sum() < min_matches:
                continue
            pair_matches[(n0, n1)] = ((mk0[keep] + 0.5) / s0,
                                      (mk1[keep] + 0.5) / s1,
                                      conf[keep])
    kps, matches, scores = aggregate_semidense_matches(pair_matches,
                                                       cell_size=cell_size)
    for n in names:
        kps.setdefault(n, np.zeros((0, 2), np.float64))
    stats["matching_s"] = time.time() - t0
    stats["keypoints_per_image"] = float(np.mean([len(kps[n])
                                                  for n in names]))
    stats["matched_pairs"] = len(matches)
    logger.info("loftr: %d images, %.0f keypoints/image, %d matched pairs",
                len(names), stats["keypoints_per_image"], len(matches))
    return kps, matches, scores
