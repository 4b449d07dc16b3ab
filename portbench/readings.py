"""Readings of the comparison: the sound program, the control and every
planted fault, on the card, at a cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        [--plants none,control,<fault>,...] [--out FILE]

For each seed it sets the cell up once (scene, weights, program, warm-up
job), then for each plant runs one job with the timed path broken as
``faults.py`` says and prints the compared numbers as one JSON line per
(seed, plant); ``--plants`` defaults to none, control and every fault the
cell's entry can have. The limits in ``workloads/<cell>.json`` are set
from these readings (``PERF.md`` gives them). The benchmark's own runs do
not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
sys.path.insert(0, ROOT)


def readings(workload, seeds, plants, device="cuda", root=ROOT, out=None):
    import torch
    from portbench import faults, harness
    from portbench.tracing import Tracer
    bench = harness.Bench(root)
    wl = bench.workload(workload)
    config = bench.config(wl["config"])
    if plants is None:
        plants = ["none", "control", *faults.FAULTS[wl["entry"]]]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rows = []
    for seed in seeds:
        tracer = Tracer(False, sync)
        drv = bench.traffic(wl["entry"]).Traffic(config, wl, seed, device,
                                               tracer)
        t0 = time.perf_counter()
        drv.setup()
        base = len(tracer._restore)
        for plant in plants:
            if plant == "control":
                faults.plant("control", drv)
            elif plant != "none":
                faults.HOOKS[plant](drv)
            t1 = time.perf_counter()
            drv.job()
            t_job = time.perf_counter() - t1
            tracer.restore(keep=base)
            faults.unplant()
            drv.collect()
            got = drv.check()
            row = dict(workload=workload, seed=seed, plant=plant,
                       job_s=t_job, setup_s=t1 - t0 if plant == plants[0]
                       else None, readings=got,
                       correct=all(got.get(k) is not None and got[k] <= v
                                   for k, v in wl["checks"].items()))
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with open(out, "a") as fh:
                    fh.write(line + "\n")
        tracer.restore()
        drv.release()
        drv.cleanup()
        del drv
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--plants", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("readings: no CUDA device")
    readings(a.workload, [int(s) for s in a.seeds.split(",")],
             a.plants.split(",") if a.plants else None, out=a.out)
