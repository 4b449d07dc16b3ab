"""A configuration, a cell and a per-layer metric added as new files and
new ``BENCHMARK.json`` entries only, in a copy of the benchmark, are found
by name and run: no file that was there is edited."""

import hashlib
import json

from portbench import harness
from portbench.tests import tiny

METRIC = '''"""Jobs the window completed (a test metric)."""

LAYER = "whole job"
UNIT = "count"
MOVES = "scene_s"
BETTER = "higher"


def read(ctx):
    return float(ctx.jobs)
'''


def _digests(d):
    return {p.relative_to(d).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in d.rglob("*") if p.is_file()
            and "_cache" not in p.parts and "__pycache__" not in p.parts}


def test_new_files_are_picked_up(tmp_path):
    cells = {"tiny_plane.ba": tiny.CELLS["tiny_plane.ba"]}
    root = tiny.tiny_root(tmp_path, cells)
    (root / "portbench" / "metrics" / "jobs_done.map.py").write_text(METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "jobs_done.map", "unit": "count",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "whole job", "moves": "scene_s",
                              "workloads": ["tiny_plane.ba"]})
    spec["end_to_end"][0]["workloads"].append("tiny_plane.ba")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    before = _digests(tiny.REPO / "portbench")
    after = _digests(root / "portbench")
    for rel, h in after.items():
        if rel in before:
            assert before[rel] == h, f"{rel} was edited"

    bench = harness.Bench(root)
    assert bench.config("tiny_plane")["scene"]["kind"] == "plane"
    assert bench.workload("tiny_plane.ba")["entry"] == "run_ba"
    assert [m["name"] for m in bench.metrics_of("tiny_plane.ba",
                                                "per_layer")] \
        == ["jobs_done.map"]
    r = tiny.run(root, "tiny_plane.ba", trace=1)
    assert r["metrics"]["jobs_done.map"] == {"value": 1.0, "unit": "count"}
    r = tiny.run(root, "tiny_plane.ba", trace=0)
    assert set(r["metrics"]) == {"scene_s", "setup_s"}
    assert r["correct"]
