"""Port parity: ``pixsfm_tpu_torch/util/profiling.py`` against
``pixsfm_tpu/util/profiling.py`` — ``Timer`` and ``merge_summaries`` on the
same inputs (exact), and ``trace`` over ``torch.profiler`` (a Chrome trace
file on the CPU; ``None`` records nothing).

The span and counter recorder: outside a ``torch.profiler`` session it
records nothing and starts no profiler; inside one, spans nest with their
parents and jobs on the clock of ``time.time_ns()``, and each session
starts a recording of its own; a tiny ``run_ba`` records the span tree of
its stages, counts each host read of BA and writes its spans into
``trace``'s file. On a card (``cuda`` marker; ``--noconftest``, as this
file imports JAX only inside the parity test) a span encloses a kernel's
interval in a CUDA-only profiler trace, and BA's ``sync.*`` counters equal
the synchronizing calls that ``torch.cuda.set_sync_debug_mode`` reports,
span by span."""

import collections
import dataclasses
import json
import time
import warnings

import numpy as np
import pytest
import torch

from pixsfm_tpu_torch.util import SolverSummary, Timer, merge_summaries, trace
from pixsfm_tpu_torch.util import profiling


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
    from pixsfm_tpu.util.profiling import merge_summaries as j_merge
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


# -- the span and counter recorder ------------------------------------------

@pytest.fixture
def recorder():
    """A ``torch.profiler`` session on the CPU, in which the recorder
    records: its recording."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        yield profiling.recorded()
    profiling.clear_recorded()


def test_recorder_off_records_nothing_and_starts_no_profiler(monkeypatch):
    import torch.autograd.profiler
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("a span must not start a profiler")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "profile", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.clear_recorded()
    with profiling.span("a") as a:
        profiling.count("x")
        with profiling.span("b", timed=True) as b:
            time.sleep(0.002)
        assert profiling.host(torch.ones(()), "y") == 1.0
        profiling.to_device([1.0], "meta")
    assert a is None                       # an untimed span is a no-op
    assert b.seconds >= 0.002              # a timed one reads the clock
    assert profiling.recorded().spans == []
    assert profiling.recorded().counters == {}


def test_spans_nest_with_parents_jobs_and_self_time(recorder):
    profiling.count("x")                   # no span open
    with profiling.span("a"):
        time.sleep(0.002)
        with profiling.span("b"):
            profiling.count("x", 2)
            time.sleep(0.002)
        with profiling.span("c"):
            time.sleep(0.001)
        profiling.count("x")
    with profiling.span("d"):
        profiling.count("y")
    by = {s.name: s for s in recorder.spans}
    assert [s.name for s in recorder.spans] == ["b", "c", "a", "d"]
    assert by["a"].parent is None and by["d"].parent is None
    assert by["b"].parent == by["a"].id == by["c"].parent
    assert by["a"].job == by["b"].job == by["c"].job != by["d"].job
    assert recorder.self_seconds(by["a"]) == pytest.approx(
        by["a"].seconds - by["b"].seconds - by["c"].seconds, abs=1e-9)
    assert recorder.self_seconds(by["a"]) >= 0.002
    assert recorder.counters == {(None, None, "x"): 1,
                                 (by["a"].job, by["b"].id, "x"): 2,
                                 (by["a"].job, by["a"].id, "x"): 1,
                                 (by["d"].job, by["d"].id, "y"): 1}
    assert recorder.counts() == {"x": 4, "y": 1}
    assert recorder.counts("x", within="a") == {"x": 3}
    assert recorder.counts(within="b") == {"x": 2}
    assert recorder.counts(within="d") == {"y": 1}
    assert recorder.seconds("b") == by["b"].seconds


def test_span_times_lie_between_clock_reads(recorder):
    for timed in (False, True):
        t0 = time.time_ns()
        with profiling.span("s", timed=timed):
            time.sleep(0.001)
        t1 = time.time_ns()
        s = recorder.spans[-1]
        assert t0 <= s.start_ns and s.start_ns + 1_000_000 <= s.end_ns <= t1


def test_each_profiler_session_records_anew():
    """A session's recording holds its own spans alone, and stays readable
    after it until the next session or ``clear_recorded``."""
    from torch.profiler import ProfilerActivity, profile
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(name):
                profiling.count("x")
        with profiling.span("after"):      # outside a session: not kept
            profiling.count("x")
        rec = profiling.recorded()
        assert [s.name for s in rec.spans] == [name]
        assert rec.counts() == {"x": 1}
    profiling.clear_recorded()
    assert profiling.recorded().spans == []


def test_to_device_counts_copies_from_host_memory(recorder):
    """One ``sync.upload`` for each copy of host data to a device that is
    not the CPU; none for an empty one, a tensor already there, or the
    CPU."""
    a = np.arange(3, dtype=np.float32)
    t = profiling.to_device(a, "meta", torch.int32)
    assert t.device.type == "meta" and t.dtype == torch.int32
    profiling.to_device(torch.as_tensor(a), "meta")
    profiling.to_device(np.zeros(0), "meta")
    profiling.to_device(t, "meta")
    assert torch.equal(profiling.to_device(a, "cpu"), torch.as_tensor(a))
    profiling.count_on("cpu", "sync.x")
    profiling.count_on("meta", "sync.x")
    assert recorder.counts() == {"sync.upload": 2, "sync.x": 1}


def _tiny_ba(device, solver, monkeypatch):
    """A tiny ``run_ba`` on ``device`` (6 views of 160x120, 100 points, 4 LM
    iterations) with ``solver``: ``"dense"`` or ``"cg"`` (flat layout), or
    ``"grid"`` (CG on the point-major grid layout, which the one-hot budget
    lowered to 0 forces at this size): ``(PixSfM, model, views)``."""
    from portbench.scenes import program
    from portbench.scenes.synthetic import make_scene
    from pixsfm_tpu_torch.ops import schur
    from pixsfm_tpu_torch.refine_colmap import PixSfM

    scene = make_scene("plane", seed=5, n_views=6, n_points=100, W=160,
                       H=120, device=device, min_track=3, max_track=5,
                       margin=12, noise_px=0.5)
    rec = program.reconstruction(scene, seed=6)
    sfm = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": 4}}}}}, device=device)
    adj = sfm.bundle_adjuster
    base = adj._ba_options()
    kw = dict(linear_solver="dense" if solver == "dense" else "cg")
    if solver == "grid":
        kw["obs_chunk"] = 256
        monkeypatch.setattr(schur, "_ONEHOT_BUDGET", 0)
    monkeypatch.setattr(adj, "_ba_options",
                        lambda **_: dataclasses.replace(base, **kw))
    return sfm, rec, scene.views


@pytest.fixture(scope="module")
def tiny_ba(tmp_path_factory):
    """The tiny ``run_ba`` on the CPU (CG, one torch thread) under
    ``trace``, with every ``Tensor.item``, ``__bool__`` and ``.cpu``
    counted while BA runs: ``(summary, what the recorder held, the counted
    calls, the trace file)``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    in_ba, calls = [False], [0]
    try:
        sfm, rec, views = _tiny_ba("cpu", "cg", mp)
        adj = sfm.bundle_adjuster
        inner = adj.refine_multilevel

        def refine_multilevel(*a, **kw):
            in_ba[0] = True
            try:
                return inner(*a, **kw)
            finally:
                in_ba[0] = False

        def counted(f):
            def wrapped(self, *a, **kw):
                calls[0] += in_ba[0]
                return f(self, *a, **kw)
            return wrapped

        mp.setattr(adj, "refine_multilevel", refine_multilevel)
        logdir = tmp_path_factory.mktemp("trace")
        for name in ("item", "__bool__", "cpu"):
            mp.setattr(torch.Tensor, name, counted(getattr(torch.Tensor,
                                                           name)))
        with trace(str(logdir)):
            out = sfm.run_ba(rec, views)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    yield out, profiling.recorded(), calls[0], logdir / "trace.json"
    profiling.clear_recorded()


def test_tiny_ba_records_the_span_tree(tiny_ba):
    out, rec, _, _ = tiny_ba
    by_id = {s.id: s for s in rec.spans}

    def parents(name):
        return {by_id[s.parent].name if s.parent else None
                for s in rec.spans if s.name == name}

    tree = {"run_ba": None, "extract": "run_ba", "extract.project": "extract",
            "extract.view": "extract", "ba": "run_ba", "ba.level": "ba",
            "ba.pack": "ba.level", "ba.references": "ba.level",
            "ba.layout": "ba.level", "ba.lm": "ba.level",
            "ba.unpack": "ba.level", "ba.lm.iter": "ba.lm",
            "ba.lm.step": "ba.lm.iter", "ba.lm.decide": "ba.lm.iter",
            "ba.lm.inner": "ba.lm.iter"}
    for name, parent in tree.items():
        assert parents(name) == {parent}, name
    assert parents("ba.lm.eval") == {"ba.lm", "ba.lm.iter"}
    assert len({s.job for s in rec.spans}) == 1
    names = [s.name for s in rec.spans]
    assert names.count("extract.view") == 6
    assert names.count("ba.lm.iter") == out["iterations"][0] == 4
    # the summary's times are the spans' durations
    spans = {s.name: s for s in rec.spans}      # the last of each name
    assert out["references_time"][0] == spans["ba.references"].seconds
    assert out["time"][0] == pytest.approx(
        spans["ba.layout"].seconds + spans["ba.lm"].seconds
        + spans["ba.unpack"].seconds, abs=1e-9)


def test_tiny_ba_counts_every_host_read(tiny_ba):
    """On the CPU each host read of BA is a call of ``item``,
    ``__bool__`` or ``cpu``: their count is the total of ``sync.*`` inside
    the ``ba`` span. Each is kept under the span it happened in."""
    out, rec, calls, _ = tiny_ba
    syncs = rec.counts("sync.", within="ba")
    assert syncs == rec.counts("sync.")
    assert sum(syncs.values()) == calls > 0
    by_id = {s.id: s for s in rec.spans}
    where = {}
    for (_, sid, name), n in rec.counters.items():
        if name.startswith("sync."):
            where.setdefault(name, set()).add(by_id[sid].name)
    assert where["sync.cg_stop"] == {"ba.lm.step"}
    assert where["sync.pred"] == {"ba.lm.decide"}
    assert where["sync.unpack"] == {"ba.unpack"}
    assert where["sync.references"] == {"ba.references"}
    assert where["sync.cost"] == {"ba.lm.eval", "ba.lm.inner"}
    # each CG solve stops on one more read than its steps
    assert syncs["sync.cg_stop"] == out["cg_iterations"][0] \
        + out["iterations"][0]
    assert syncs["sync.unpack"] == 4


def test_trace_writes_the_program_spans(tiny_ba):
    """``trace``'s file holds the spans as complete events on the
    profiler's timeline: ``ba.lm`` encloses the operators BA ran."""
    _, rec, _, path = tiny_ba
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert len(spans) == len(rec.spans)
    lm = next(e for e in spans if e["name"] == "ba.lm")
    inside = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "cpu_op"
              and lm["ts"] <= e["ts"] <= lm["ts"] + lm["dur"]]
    assert any(e["name"] == "aten::mul" for e in inside)


@pytest.mark.cuda
def test_span_encloses_the_kernel_on_the_device_trace_clock():
    """A span around a sleep kernel and a synchronize encloses the kernel's
    interval in a CUDA-only ``torch.profiler`` trace, within 50 us: the
    spans and the device trace share one clock. The recorder records
    while the profiler runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace has no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with profiling.span("sleep"):
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
    spans = [s for s in profiling.recorded().spans if s.name == "sleep"]
    profiling.clear_recorded()
    kernels = sorted((e.start_ns(), e.end_ns()) for e in
                     prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and "spin_kernel" in e.name())
    assert len(spans) == len(kernels) == 3
    for s, (k0, k1) in zip(spans, kernels):
        assert s.start_ns - 50_000 <= k0 < k1 <= s.end_ns + 50_000


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg", "grid"])
def test_sync_counters_equal_the_syncs_on_the_card(solver, monkeypatch):
    """Inside ``ba``, the ``sync.*`` counters of each span equal the
    synchronizing calls that ``torch.cuda.set_sync_debug_mode("warn")``
    reports while that span is the innermost open one (a tiny ``run_ba``
    after a warm-up run, recorded under a CUDA-only profiler)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the syncs are the card's")
    from torch.profiler import ProfilerActivity, profile
    sfm, rec0, views = _tiny_ba("cuda", solver, monkeypatch)
    sfm.run_ba(rec0.copy(), views)              # builds and loads kernels
    warned = collections.Counter()

    def show(message, *args, **kwargs):
        if "synchroniz" in str(message):
            open_spans = profiling.recorded()._open
            warned[open_spans[-1][0] if open_spans else None] += 1

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sfm.run_ba(rec0.copy(), views)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    rec = profiling.recorded()
    profiling.clear_recorded()
    by_id = {s.id: s for s in rec.spans}
    ba = next(s for s in rec.spans if s.name == "ba")

    def in_ba(sid):
        while sid in by_id:
            if sid == ba.id:
                return True
            sid = by_id[sid].parent
        return False

    counted = collections.Counter()
    for (_, sid, name), n in rec.counters.items():
        if name.startswith("sync.") and in_ba(sid):
            counted[sid] += n
    seen = {by_id[sid].name + f"#{sid}": n for sid, n in warned.items()
            if in_ba(sid)}
    assert {by_id[sid].name + f"#{sid}": n
            for sid, n in counted.items()} == seen
    assert sum(rec.counts("sync.", within="ba").values()) \
        == sum(seen.values()) > 0
