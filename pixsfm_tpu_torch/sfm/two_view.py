"""Two-view geometric match verification (fundamental-matrix LO-RANSAC)
and Bougnoux focal seeds.

A copy of ``pixsfm_tpu/sfm/two_view.py`` (numpy only, so the same draws of
``np.random.default_rng`` give the same answers). The reference consumes
matches already verified by hloc/COLMAP's two-view geometry stage; this
module provides the equivalent filter for raw descriptor matches so the
built-in mapper/triangulator receive clean tracks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["verify_matches", "verify_all_pairs", "estimate_focal_bougnoux",
           "estimate_pair_focal"]


def _normalize(pts: np.ndarray):
    c = pts.mean(axis=0)
    s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - c, axis=1)), 1e-9)
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    return (pts - c) * s, T


def _fit_F(x1h: np.ndarray, x2h: np.ndarray) -> np.ndarray:
    A = np.einsum("ni,nj->nij", x2h, x1h).reshape(len(x1h), 9)
    _, _, Vt = np.linalg.svd(A)
    F = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(F)
    S = np.array([S[0], S[1], 0.0])
    return U @ np.diag(S) @ Vt2


def _sampson_px(F, x1h, x2h):
    Fx1 = x1h @ F.T
    Ftx2 = x2h @ F
    num = np.einsum("ni,ni->n", x2h, Fx1) ** 2
    den = (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2
           + Ftx2[:, 1] ** 2)
    return num / np.maximum(den, 1e-18)


def verify_matches(kps1: np.ndarray, kps2: np.ndarray, matches: np.ndarray,
                   max_error_px: float = 3.0, iters: int = 1000,
                   seed: int = 0) -> np.ndarray:
    """Return the boolean inlier mask of ``matches`` under the best fundamental
    matrix (LO-RANSAC, Sampson error in pixels)."""
    n = len(matches)
    if n < 8:
        return np.ones(n, bool)
    p1 = np.asarray(kps1, np.float64)[matches[:, 0]]
    p2 = np.asarray(kps2, np.float64)[matches[:, 1]]
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    x1h = np.hstack([n1, np.ones((n, 1))])
    x2h = np.hstack([n2, np.ones((n, 1))])
    # threshold in normalized units: scale by the mean normalization factor
    s = 0.5 * (T1[0, 0] + T2[0, 0])
    t2 = (max_error_px * s) ** 2

    rng = np.random.default_rng(seed)
    best_inl = np.zeros(n, bool)
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        F = _fit_F(x1h[idx], x2h[idx])
        inl = _sampson_px(F, x1h, x2h) < t2
        if inl.sum() > best_inl.sum():
            for _ in range(3):
                if inl.sum() < 8:
                    break
                F = _fit_F(x1h[inl], x2h[inl])
                new = _sampson_px(F, x1h, x2h) < t2
                if new.sum() <= inl.sum():
                    break
                inl = new
            if inl.sum() > best_inl.sum():
                best_inl = inl
    return best_inl


def _cross_mat(v):
    return np.array([[0, -v[2], v[1]],
                     [v[2], 0, -v[0]],
                     [-v[1], v[0], 0]], np.float64)


def estimate_focal_bougnoux(F: np.ndarray, pp1, pp2):
    """Bougnoux self-calibration: focal lengths of both views from a pixel-
    coordinate fundamental matrix and the principal points. Returns
    ``(f1, f2)`` with ``nan`` entries when the estimate is degenerate
    (negative square — near-zero baseline, parallel axes, or pp on the
    epipolar line). Used to seed the mapper's focal sweep for EXIF-less
    images (reference relies on COLMAP's two-view geometry for this)."""
    F = np.asarray(F, np.float64)
    p1 = np.array([pp1[0], pp1[1], 1.0])
    p2 = np.array([pp2[0], pp2[1], 1.0])
    # epipoles: F e1 = 0, F^T e2 = 0
    _, _, Vt = np.linalg.svd(F)
    e1 = Vt[-1]
    _, _, Vt = np.linalg.svd(F.T)
    e2 = Vt[-1]
    II = np.diag([1.0, 1.0, 0.0])

    def f_sq(Fm, ea, pa, pb):
        # Bougnoux 1998: f_b^2 for the second view of Fm (x_b^T Fm x_a = 0)
        num = -(pb @ _cross_mat(ea) @ II @ Fm @ pa) * (pb @ Fm @ pa)
        den = pb @ _cross_mat(ea) @ II @ Fm @ II @ Fm.T @ pb
        if abs(den) < 1e-12:
            return np.nan
        return num / den

    f1_sq = f_sq(F, e2, p1, p2)
    f2_sq = f_sq(F.T, e1, p2, p1)
    f1 = float(np.sqrt(f1_sq)) if f1_sq and f1_sq > 0 else float("nan")
    f2 = float(np.sqrt(f2_sq)) if f2_sq and f2_sq > 0 else float("nan")
    return f1, f2


def estimate_pair_focal(kps1: np.ndarray, kps2: np.ndarray,
                        matches: np.ndarray, pp1, pp2,
                        max_error_px: float = 3.0, iters: int = 500,
                        seed: int = 0):
    """RANSAC-fit F on a match set, then Bougnoux focal estimates.
    Returns (f1, f2, num_inliers); (nan, nan, 0) when underdetermined."""
    n = len(matches)
    if n < 8:
        return float("nan"), float("nan"), 0
    p1 = np.asarray(kps1, np.float64)[matches[:, 0]]
    p2 = np.asarray(kps2, np.float64)[matches[:, 1]]
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    x1h = np.hstack([n1, np.ones((n, 1))])
    x2h = np.hstack([n2, np.ones((n, 1))])
    s = 0.5 * (T1[0, 0] + T2[0, 0])
    t2 = (max_error_px * s) ** 2
    rng = np.random.default_rng(seed)
    best_inl = np.zeros(n, bool)
    best_F = None
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        F = _fit_F(x1h[idx], x2h[idx])
        inl = _sampson_px(F, x1h, x2h) < t2
        if inl.sum() > best_inl.sum():
            for _ in range(3):
                if inl.sum() < 8:
                    break
                F = _fit_F(x1h[inl], x2h[inl])
                new = _sampson_px(F, x1h, x2h) < t2
                if new.sum() <= inl.sum():
                    break
                inl = new
            if inl.sum() > best_inl.sum():
                best_inl, best_F = inl, F
    if best_F is None or best_inl.sum() < 8:
        return float("nan"), float("nan"), int(best_inl.sum())
    F_px = T2.T @ best_F @ T1       # denormalize to pixel coordinates
    f1, f2 = estimate_focal_bougnoux(F_px, pp1, pp2)
    return f1, f2, int(best_inl.sum())


def verify_all_pairs(matches: Dict[Tuple[str, str], np.ndarray],
                     keypoints: Dict[str, np.ndarray],
                     scores: Optional[Dict] = None,
                     max_error_px: float = 3.0,
                     min_num_inliers: int = 15):
    """Filter every pair's matches; drops pairs with too few inliers."""
    out_m, out_s = {}, {} if scores is not None else None
    for (n1, n2), m in matches.items():
        inl = verify_matches(keypoints[n1], keypoints[n2], np.asarray(m),
                             max_error_px=max_error_px)
        if inl.sum() < min_num_inliers:
            continue
        out_m[(n1, n2)] = np.asarray(m)[inl]
        if scores is not None and (n1, n2) in scores:
            out_s[(n1, n2)] = np.asarray(scores[(n1, n2)])[inl]
    return out_m, out_s
