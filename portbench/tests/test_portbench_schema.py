"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files the harness finds by that name.

    python -m pytest portbench/tests -q
"""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_a_full_check_with_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_command_names_files_under_paths_only():
    for word in SPEC["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (REPO / word).is_file()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://") and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body.get("reduced", []) == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            last = k.split(".")[-1]
            assert not last.endswith(("_dim", "_rank", "_size"))


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC[kind]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25
        else:
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
            # every cell it lists reports the end-to-end metric it moves
            moved = next(e for e in SPEC["end_to_end"]
                         if e["name"] == m["moves"])
            assert set(m.get("workloads", cells)) <= set(
                moved.get("workloads", cells))
    if kind == "end_to_end":
        assert "setup_s" in e2e
        assert 1 <= len(SPEC[kind]) <= 16
    else:
        assert 1 <= len(SPEC[kind]) <= 128


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        bench = harness.Bench(REPO)
        e2e = {m["name"] for m in bench.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_of(w["name"], "per_layer")


def test_every_name_is_found_by_the_harness():
    bench = harness.Bench(REPO)
    for w in SPEC["workloads"]:
        wl = bench.workload(w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert wl["checks"]
        bench.config(w["config"])
        assert hasattr(bench.traffic(wl["entry"]), "Traffic")
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            mod = bench.metric(m["name"])
            assert mod.UNIT == m["unit"] and mod.BETTER == m["better"]
            if kind == "per_layer":
                assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_roofline_and_peak_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            assert m["name"].split(".")[0].endswith(("_roofline", "mfu"))


def test_files_under_paths_are_named_from_names():
    for p in SPEC["paths"]:
        for f in (REPO / p).rglob("*"):
            if "_cache" in f.parts or "__pycache__" in f.parts:
                continue
            rel = f.relative_to(REPO).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
