"""The measurement path refuses to run without a card or outside a
checkout, and nothing it runs imports JAX or the JAX package; the plain
reference imports nothing of the program either. Module names are
compared whole at the first dot: ``pixsfm_tpu_torch`` is not
``pixsfm_tpu``."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


from portbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
CELL = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*dirs):
    for d in dirs:
        for f in sorted(d.rglob("*.py")):
            if "tests" not in f.relative_to(BENCH).parts:
                yield f


def test_no_source_imports_jax_or_the_jax_package():
    for f in _sources(BENCH):
        bad = set(_imports(f)) & set(harness.FORBIDDEN)
        assert not bad, (f, bad)


def test_the_reference_imports_nothing_of_the_program():
    for f in _sources(BENCH / "reference"):
        names = set(_imports(f))
        assert not names & {"pixsfm_tpu_torch", *harness.FORBIDDEN}, f


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "pixsfm_tpu_torch_x",
                        types.ModuleType("pixsfm_tpu_torch_x"))
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def _run(cwd, env=None):
    cmd = [sys.executable, "portbench/run.py", "--workload", CELL["name"],
           "--seed", "3000000001", "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(REPO, env)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_refuses_with_only_the_benchmark_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    p = _run(tmp_path, env)
    assert p.returncode != 0
    assert "{" not in p.stdout
