"""Port parity: ``pixsfm_tpu_torch/util/profiling.py`` against
``pixsfm_tpu/util/profiling.py`` — ``Timer`` and ``merge_summaries`` on the
same inputs (exact), and ``trace`` over ``torch.profiler`` (a Chrome trace
file on the CPU; ``None`` records nothing)."""

import json
import time

import pytest
import torch

from pixsfm_tpu.util.profiling import merge_summaries as j_merge
from pixsfm_tpu_torch.util import SolverSummary, Timer, merge_summaries, trace


def test_timer_pauses_and_restarts():
    t = Timer()
    assert t.elapsed_seconds == 0.0
    with t:
        time.sleep(0.02)
    paused = t.elapsed_seconds
    assert paused >= 0.02
    time.sleep(0.01)
    assert t.elapsed_seconds == paused          # paused: no time counted
    t.start()
    time.sleep(0.01)
    assert t.elapsed_seconds > paused
    t.restart()
    assert t.elapsed_seconds < paused
    t.print("test")


SUMMARIES = [
    dict(initial_cost=3.5, final_cost=1.25, num_problems=4, iterations=7,
         time=0.5),
    dict(initial_cost=2.0, final_cost=0.5, num_problems=3, iterations=12),
    dict(final_cost=0.125, iterations=2, time=1.5),
    {},
]


@pytest.mark.parametrize("n", [0, 1, 4])
def test_merge_summaries_matches_jax(n):
    """The shards' summaries merge as the JAX package merges them: costs,
    problems and times summed, the iterations their maximum."""
    t, j = merge_summaries(SUMMARIES[:n]), j_merge(SUMMARIES[:n])
    assert isinstance(t, SolverSummary)
    for k in ("initial_cost", "final_cost", "num_problems", "iterations",
              "time_s", "num_residual_evaluations", "extra"):
        assert getattr(t, k) == getattr(j, k)
    assert t.report() == j.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("trace(None) must not start the profiler")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with trace(None):
        assert torch.ones(2).sum().item() == 2.0
    assert list(tmp_path.iterdir()) == []
