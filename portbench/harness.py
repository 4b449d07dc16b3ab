"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, and the result line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs the cell named in ``BENCHMARK.json`` once on the card
it is started on; see ``portbench/README`` in ``PERF.md`` for the layout.
The cell's file (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its entry (``traffic/<entry>.py``, the traffic
of that kind of call) and the limits of its comparison; each metric is
``metrics/<metric>.py``. The harness finds all of them by name.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "pixsfm_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``pixsfm_tpu_torch`` is not ``pixsfm_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names, found by name under the
    ``portbench`` folder of ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        return json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, entry: str) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{entry}.py",
                           f"portbench_traffic_{entry}")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{name}.py",
                           "portbench_metric_" + name.replace(".", "_"))

    def metrics_of(self, cell: str, kind: str):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]


class Context:
    """What a metric reader reads: the window, its jobs, the spans and
    counters of the run, and the traced job's kernels."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_job(self, span: str) -> Optional[float]:
        t = self.tracer.spans.get(span)
        return None if t is None or self.jobs == 0 else t / self.jobs

    def counter_per_job(self, name: str) -> Optional[float]:
        v = self.tracer.counters.get(name)
        return None if v is None or self.jobs == 0 else v / self.jobs

    def kernel_seconds(self, *tags: str) -> float:
        return sum(e - s for n, s, e in self.tracer.kernels
                   if any(t in n for t in tags)) * 1e-9

    def traced_seconds(self) -> Optional[float]:
        ns = self.tracer.traced_ns
        return None if ns is None else (ns[1] - ns[0]) * 1e-9

    def busy_seconds(self) -> float:
        """The union of the traced job's device operation intervals."""
        busy, end = 0, None
        for _, s, e in self.tracer.kernels:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9


def breakdown(tracer, top: int = 10) -> Dict:
    """The device operations that took most time in the traced job, and
    its longest idle gaps named by the innermost benchmark span around
    each (``host`` where none is open)."""
    by_name: Dict[str, int] = {}
    for n, s, e in tracer.kernels:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    t0, t1 = tracer.traced_ns
    cur = t0
    for _, s, e in tracer.kernels + [("end", t1, t1)]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        inner = [m for m in tracer.marks if m[1] <= mid <= m[2]]
        name = min(inner, key=lambda m: m[2] - m[1])[0] if inner else "host"
        named.append([name, (b - a) * 1e-9])
    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": named}


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell "
                                            "of pixsfm_tpu_torch.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float, root: Path, device: Optional[str] = None,
         plant: Optional[str] = None, out=None) -> int:
    """Run the cell; print the result line and return 0, or return
    another code with no result line. ``device=None`` is the measured run,
    which needs the card; tests pass ``"cpu"`` and a ``plant`` (a fault or
    the control of ``faults.py``) and read the result from ``out``."""
    args = parse(argv)
    out = sys.stdout if out is None else out
    bench = Bench(root)
    cell = bench.cell(args.workload)
    import torch
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if have < int(cell["chips"]):
            print(f"portbench: the cell needs {cell['chips']} CUDA "
                  f"device(s); this machine has {have}", file=sys.stderr)
            return 2
        device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    from .tracing import Tracer
    wl = bench.workload(args.workload)
    config = bench.config(wl["config"])
    tracer = Tracer(bool(args.trace), sync)
    drv = bench.traffic(wl["entry"]).Traffic(config, wl, args.seed, device,
                                           tracer)
    if plant:
        from . import faults
        faults.plant(plant, drv)
    drv.setup()
    tracer.reset()
    # set-up's objects (scene, inputs, weights) leave the collector's
    # generations, so its passes in the window scan what the jobs make
    gc.collect()
    gc.freeze()
    if args.trace:
        tracer.count_kernel_entries()

    # -- the measured window ----------------------------------------------
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    deadline = t_open + args.seconds
    jobs = units = failed = 0
    times = []
    while True:
        t_job = time.perf_counter()
        if args.trace and jobs == 0:
            with tracer.profiled():
                done, bad = drv.job()
        else:
            done, bad = drv.job()
        times.append(time.perf_counter() - t_job)
        jobs, units, failed = jobs + 1, units + done, failed + bad
        if time.perf_counter() >= deadline:
            break
    sync()
    t_close = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tracer.restore()

    ctx = Context(window_s=t_close - t_open, jobs=jobs, units=units,
                  failed=failed, setup_s=t_open - t_start, peak_bytes=peak,
                  tracer=tracer, unit=drv.unit)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(args.workload, kind):
        v = bench.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- the comparison with the plain reference, after the window --------
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    readings = drv.check()
    limits = wl["checks"]
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    drv.cleanup()
    print("job seconds: " + " ".join(f"{t:.3f}" for t in times),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)

    bad_mods = forbidden_modules()
    if bad_mods:
        print(f"portbench: the run loaded {bad_mods}", file=sys.stderr)
        return 3
    result = {
        "correct": bool(correct),
        "attempted": units,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if args.trace and tracer.traced_ns is not None:
        result["device"]["busy_s"] = ctx.busy_seconds()
        result["device"]["window_s"] = ctx.traced_seconds()
        result["breakdown"] = breakdown(tracer)
    result["checks"] = checks
    print(json.dumps(result), file=out, flush=True)
    return 0
