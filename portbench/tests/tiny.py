"""A copy of the benchmark with tiny cells of its own, for CPU tests.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and ``portbench/`` into
``tmp`` and adds, as new files and entries only, a tiny configuration
(the ``plane`` scene at 160x120) and one tiny cell per traffic module; ``run(root, cell, seed, plant)`` runs one of them on the
CPU through the harness and returns the result line as a dict.
"""

from __future__ import annotations

import io
import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

OBJECTIVE = {"ba": 0.25}
CONFIGS = {
    "tiny_plane": {"preset": "default", "patch_size": 16,
                   "objective": OBJECTIVE,
                   "ba_free_params": ["focal", "extra"],
                   "overrides": {"mapping": {"BA": {"optimizer": {"solver": {
                       "max_num_iterations": 10}}}}},
                   "scene": {"kind": "plane", "W": 160, "H": 120,
                             "n_views": 6, "n_points": 100, "min_track": 3,
                             "max_track": 5, "margin": 12, "noise_px": 0.5}},
}
# the tiny scene leaves its poses short of their optimum after 10 LM
# iterations (sound runs read 0.21-0.22, the cell's 0.0014 at most), and
# its camera's gradient at the input is all but nought, so that ratio
# swings (0.20-2.11; the cell's 0.0041 at most): both limits are loosened
# here, in the tiny cell only, and the faults still fail a number each
# (the points-only fault reads 1.08 on the poses)
CHECKS = {"tiny_plane.ba": {"pose_grad": 0.5, "cam_grad": 5.0}}
CELLS = {
    "tiny_plane.ba": ("tiny_plane", "run_ba"),
}


def tiny_root(tmp: Path, cells=CELLS) -> Path:
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, conf in CONFIGS.items():
        f = f"portbench/configs/{name}.json"
        (root / f).write_text(json.dumps(dict(conf, name=name)))
        spec["configs"].append({"name": name, "source": "tiny", "file": f,
                                "reduced": [], "why": "CPU test"})
    for cell, (config, entry) in cells.items():
        wl = next(w for w in (json.loads(f.read_text()) for f in sorted(
            (REPO / "portbench" / "workloads").glob("*.json")))
            if w["entry"] == entry)
        wl["config"] = config
        wl["checks"].update(CHECKS.get(cell, {}))
        (root / "portbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(wl))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": cell.split(".")[1], "chips": 1,
                                  "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run(root: Path, cell: str, seed: int = 5, plant=None, trace=0,
        seconds=0.01):
    from portbench import harness
    buf = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      time.perf_counter(), root, device="cpu", plant=plant,
                      out=buf)
    assert rc == 0, rc
    return json.loads(buf.getvalue().strip().splitlines()[-1])
