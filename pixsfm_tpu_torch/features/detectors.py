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

Images are decoded with PIL and shrunk to ``max_edge`` by
:func:`resize_area`, which reproduces OpenCV's ``INTER_AREA`` (the JAX
package reads with ``cv2.imread`` and ``cv2.resize``). All detectors return
COLMAP-convention keypoints (pixel centres at +0.5).
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
           "aggregate_semidense_matches", "resize_area", "load_rgb"]


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


def load_rgb(path, max_edge: int):
    """Decode an image with PIL as RGB and shrink it to ``max_edge`` with
    :func:`resize_area`: (``[H, W, 3]`` float32 in [0, 1], scale)."""
    import PIL.Image

    img = np.asarray(PIL.Image.open(path).convert("RGB"))
    scale = 1.0
    if max(img.shape[:2]) > max_edge:
        scale = max_edge / max(img.shape[:2])
        img = resize_area(img, scale, scale)
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
                    cell_size: float = 1.0, min_matches: int = 15):
    """Detector-free front end (exhaustive LoFTR pair matching +
    :func:`aggregate_semidense_matches`): not ported yet."""
    raise NotImplementedError(
        "match_loftr_dir: the LoFTR matcher is not ported to "
        "pixsfm_tpu_torch yet (ROADMAP.md section 1, item 'Detectors and "
        "matchers')")
