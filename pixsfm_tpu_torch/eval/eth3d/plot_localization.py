"""Plot ETH3D localization results (reference: pixsfm/eval/eth3d/
plot_localization.py).

Reads per-scene ``results_localization.json`` files written by
``localization.run_scene_localization`` (one directory per method or per
evaluation tag), prints the AUC table, and draws the cumulative position-
recall curves the reference's figure 7 uses (recall [%] vs error [mm],
log-x), one line style per tag and one color per method.

Port of ``pixsfm_tpu/eval/eth3d/plot_localization.py``; matplotlib is
imported when a plot is drawn, with the ``Agg`` backend::

    python -m pixsfm_tpu_torch.eval.eth3d.plot_localization \
        --results_dir O --methods sift loftr [--tags .] [--output_path P]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from .config import LOCALIZATION_THRESHOLDS

__all__ = ["format_results", "plot_cumulative", "main"]

_COLORS = {"sift": "k", "superpoint": "r", "r2d2": "g", "d2net": "b",
           "d2-net": "b", "loftr": "m"}
_LINESTYLES = ["solid", "dashed", "dotted", "dashdot"]


def format_results(aucs: Dict[str, Dict[str, List[float]]],
                   thresholds: List[float]) -> str:
    """``aucs[tag][method] -> [auc@t]`` table, mirroring the reference's
    keypoints/tag/AUC layout."""
    methods = sorted({m for per_tag in aucs.values() for m in per_tag})
    tags = list(aucs)
    w1 = max(len("keypoints"), max(map(len, methods), default=0)) + 2
    w2 = max(len("tag"), max(map(len, tags), default=0)) + 2
    head = "keypoints".ljust(w1) + "tag".ljust(w2) + " AUC @ " + " / ".join(
        f"{t * 100:g}cm" for t in thresholds) + " (%)"
    lines = [head]
    for method in methods:
        for i, tag in enumerate(tags):
            if method not in aucs[tag]:
                continue
            a = aucs[tag][method]
            lines.append((method if i == 0 else "").ljust(w1)
                         + tag.ljust(w2) + "  "
                         + " / ".join(f"{v:6.2f}" for v in a))
    return "\n".join(lines)


def plot_cumulative(errors: Dict[str, Dict[str, List[float]]],
                    thresholds: List[float], path=None):
    """``errors[method][tag] -> [position error in m per query]`` (np.inf for
    failures) -> cumulative recall curves."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    ths = np.linspace(min(thresholds), max(thresholds), 100)
    tags = list(next(iter(errors.values())))
    fig = plt.figure(figsize=[5, 8])
    for mi, method in enumerate(errors):
        color = _COLORS.get(method, f"C{mi}")
        for i, tag in enumerate(tags):
            errs = np.asarray(
                [np.inf if e is None else e for e in errors[method][tag]])
            recall = [(errs <= t).mean() * 100 for t in ths]
            plt.plot(ths * 1000, recall, label=method, c=color,
                     linestyle=_LINESTYLES[i % len(_LINESTYLES)],
                     linewidth=3, zorder=10 + 100 * i)
    plt.grid()
    plt.xlabel("mm")
    plt.semilogx()
    plt.ylim([0, 100])
    plt.ylabel("Recall [%]")
    method_lines = [Line2D([0], [0], color=_COLORS.get(m, f"C{i}"), lw=3)
                    for i, m in enumerate(errors)]
    tag_lines = [Line2D([0], [0], color="black", lw=3,
                        linestyle=_LINESTYLES[i % len(_LINESTYLES)])
                 for i in range(len(tags))]
    plt.legend(method_lines + tag_lines, list(errors) + tags,
               loc="lower right", fontsize=9)
    plt.tight_layout()
    if path:
        fig.savefig(path, pad_inches=0, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


def _pose_auc(errors, thresholds):
    from .utils import pose_auc
    return pose_auc(errors, thresholds)


def collect(results_dir: Path, tags: List[str], methods: List[str],
            thresholds: List[float]):
    """Layout: results_dir/<tag>/<method>/<scene>/results_localization.json
    (any missing level collapses — e.g. a flat per-method dir)."""
    errors: Dict[str, Dict[str, List[float]]] = {}
    aucs: Dict[str, Dict[str, List[float]]] = {t: {} for t in tags}
    for method in methods:
        errors[method] = {}
        for tag in tags:
            base = results_dir / tag if tag != "." else results_dir
            errs: List[float] = []
            # bounded to the documented layout (tag/method/scene/...json,
            # scene level optional) and deduplicated — an unanchored **
            # glob merged nested tags into one series and could double-count
            # a results file whose path repeats the method name
            paths = {p.resolve()
                     for p in (base / method).glob(
                         "results_localization.json")} | \
                    {p.resolve()
                     for p in (base / method).glob(
                         "*/results_localization.json")}
            for res in sorted(paths):
                data = json.loads(res.read_text())
                errs.extend(np.inf if e is None else e
                            for e in data.get("errors_m", []))
            if errs:
                errors[method][tag] = errs
                aucs[tag][method] = _pose_auc(errs, thresholds)
    return errors, aucs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_dir", type=Path, required=True)
    parser.add_argument("--tags", nargs="+", default=["."],
                        help="evaluation-run subdirectories ('.' = flat)")
    parser.add_argument("--methods", nargs="+",
                        default=["sift", "superpoint", "r2d2"])
    parser.add_argument("--thresholds", type=float, nargs="+",
                        default=list(LOCALIZATION_THRESHOLDS))
    parser.add_argument("--output_path", type=Path, default=None)
    args = parser.parse_args(argv)

    errors, aucs = collect(args.results_dir, args.tags, args.methods,
                           args.thresholds)
    if not any(errors.values()):
        raise SystemExit(f"no results_localization.json under "
                         f"{args.results_dir}")
    print(format_results(aucs, args.thresholds))
    out = args.output_path or args.results_dir / "eth3d_localization.png"
    plot_cumulative(errors, args.thresholds, path=out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
