"""Plot ETH3D triangulation results (reference: pixsfm/eval/eth3d/
plot_triangulation.py + notebooks/plot_eth3d_triangulation.ipynb).

Port of ``pixsfm_tpu/eval/eth3d/plot_triangulation.py``: a bar chart of
accuracy or completeness per scene and tolerance from the ``results.json``
files of ``triangulation.run_scene``. matplotlib is imported when a plot is
drawn, with the ``Agg`` backend::

    python -m pixsfm_tpu_torch.eval.eth3d.plot_triangulation \
        --results_dir O [--metric completeness] [--output plot.png]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import numpy as np

from .config import TRIANGULATION_TOLERANCES

__all__ = ["plot_results", "main"]


def plot_results(results: Dict[str, Dict], tolerances=TRIANGULATION_TOLERANCES,
                 metric: str = "accuracy", path=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scenes = [s for s in results if results[s] and metric in results[s]]
    if not scenes:
        raise ValueError("no results to plot")
    vals = np.array([results[s][metric] for s in scenes])  # [S, T]

    fig, ax = plt.subplots(figsize=(max(8, len(scenes)), 4.5))
    width = 0.8 / len(tolerances)
    x = np.arange(len(scenes))
    for ti, tol in enumerate(tolerances):
        ax.bar(x + ti * width, vals[:, ti], width,
               label=f"@{tol * 100:g}cm")
    ax.set_xticks(x + width)
    ax.set_xticklabels(scenes, rotation=45, ha="right")
    ax.set_ylabel(f"{metric} [%]")
    ax.set_ylim(0, 100)
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return None
    return fig


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_dir", type=Path, required=True)
    parser.add_argument("--output", type=Path, default=None)
    parser.add_argument("--metric", default="accuracy",
                        choices=["accuracy", "completeness"])
    args = parser.parse_args(argv)

    results = {}
    for scene_dir in sorted(args.results_dir.iterdir()):
        res = scene_dir / "results.json"
        if res.exists():
            results[scene_dir.name] = json.loads(res.read_text())
    out = args.output or args.results_dir / f"triangulation_{args.metric}.png"
    plot_results(results, metric=args.metric, path=out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
