"""Visualization helpers (reference: pixsfm/util/visualize.py — epipolar line
drawing + plotly 3D init). Matplotlib-based; plotly used when available.

Copy of ``pixsfm_tpu/util/visualize.py`` for the port's ``Reconstruction``;
matplotlib (``Agg``) and plotly are imported inside the functions."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "plot_keypoint_displacements", "plot_reconstruction_3d",
    "epipolar_line", "draw_epipolar_lines",
]


def epipolar_line(F: np.ndarray, xy: np.ndarray, width: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Endpoints of the epipolar line of ``xy`` (in image 1) in image 2."""
    l = F @ np.array([xy[0], xy[1], 1.0])
    a, b, c = l
    if abs(b) < 1e-12:
        x = -c / a
        return np.array([x, 0.0]), np.array([x, 1e4])
    x0, x1 = 0.0, float(width)
    return (np.array([x0, -(a * x0 + c) / b]),
            np.array([x1, -(a * x1 + c) / b]))


def draw_epipolar_lines(ax, F: np.ndarray, points: np.ndarray, width: int,
                        color="lime", lw=0.5):
    for xy in np.atleast_2d(points):
        p0, p1 = epipolar_line(F, xy, width)
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], color=color, lw=lw)


def plot_keypoint_displacements(image, kps_before: np.ndarray,
                                kps_after: np.ndarray, scale: float = 5.0,
                                path=None):
    """Quiver plot of KA refinements over the image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(np.asarray(image), cmap="gray")
    d = (kps_after - kps_before) * scale
    ax.quiver(kps_before[:, 0], kps_before[:, 1], d[:, 0], d[:, 1],
              angles="xy", scale_units="xy", scale=1, color="red", width=2e-3)
    ax.set_axis_off()
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


def plot_reconstruction_3d(reconstruction, path=None, max_points=20000,
                           point_size=0.5):
    """3D scatter of points + camera frusta (plotly if available, else mpl)."""
    pts = np.array([p.xyz for p in reconstruction.points3D.values()])
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[idx]
    centers = np.array([im.projection_center()
                        for im in reconstruction.images.values()
                        if im.registered])
    try:
        import plotly.graph_objects as go
        fig = go.Figure()
        fig.add_trace(go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                                   mode="markers",
                                   marker=dict(size=point_size,
                                               color="black")))
        if len(centers):
            fig.add_trace(go.Scatter3d(
                x=centers[:, 0], y=centers[:, 1], z=centers[:, 2],
                mode="markers", marker=dict(size=4, color="red")))
        fig.update_layout(scene=dict(aspectmode="data"))
        if path:
            fig.write_html(str(path))
            return None
        return fig
    except ImportError:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size,
                       c="k")
        if len(centers):
            ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=30,
                       c="r", marker="^")
        if path:
            from pathlib import Path as _P
            path = _P(path)
            if path.suffix.lower() in (".html", ""):
                path = path.with_suffix(".png")
            fig.savefig(path, dpi=150)
            plt.close(fig)
            return None
        return fig
