#!/usr/bin/env python3
"""Kernel launch counts and results of three stages of ``chip_smoke.py``, on
the checkout this is run from (one NVIDIA GPU):

    python3 scripts/launch_counts.py

- ``vggnet``: VGGNet KA on phase 5's scene (phase 21(d)): launches, K1's
  launches by channel count, LM iterations and final cost per level;
- ``photometric_ka``: the ``photometric`` preset with KA on phase 11's
  scene (phase 23(b)): launches, KA iterations, KA and BA final costs and
  the point error to the truth;
- ``ba``: ``run_ba`` on phase 9's scene: launches, LM and CG iterations,
  final cost.

Prints one line ``LAUNCH_COUNTS {json}``. To tell a change in the counts
from their spread between runs (K3's float atomics make the BA's CG steps
vary), run it from two checkouts in turns in one call (A, B, B, A) and
compare each side with itself.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from pixsfm_tpu_torch import kernels
    from pixsfm_tpu_torch.config import load_config
    from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda, schur_cuda
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    from pixsfm_tpu_torch.sfm.model import Reconstruction

    if not torch.cuda.is_available():
        print("launch_counts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    kernels.build_all()
    zero, read = cs.kernel_counts(torch, interpolate_cuda, cg_cuda,
                                  schur_cuda)
    res = {"checkout": os.getcwd()}

    images, kps, _, matches, scores = cs.make_scene(
        np, seed=0, n_views=10, n_points=2000, W=1600, H=1200, margin=150)
    sfm = PixSfM({"dense_features": {"model": {"name": "vggnet"}}},
                 device="cuda")
    zero()
    _, out = sfm.run_ka(kps, images, matches=matches, scores=scores)
    res["vggnet"] = dict(
        read(), by_width=dict(interpolate_cuda.launches_by_channels),
        iterations=out["iterations"],
        final_cost=[float(x) for x in out["final_cost"]])
    del sfm, images
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="launch_counts_") as tmp:
        tmp = Path(tmp)
        _, views, truth = cs.make_ba_scene(
            torch, np, seed=5, n_views=24, n_points=8000, W=1600, H=1200,
            device="cuda", min_track=3, max_track=8, noise_px=1.0)
        kps, matches, scores, reference = cs.triangulation_inputs(np, truth)
        reference.write(tmp / "reference")
        reference = Reconstruction.read(tmp / "reference")
        conf = load_config("photometric", extra={"mapping": {
            "KA": {"apply": True},
            "BA": {"optimizer": {"solver": {
                "max_num_iterations": cs.OPT_PHOTO_BA_ITERATIONS}}}}})
        sfm = PixSfM(conf, device="cuda")
        zero()
        rec, out = sfm._triangulation(tmp / "out", reference, views, kps,
                                      matches, scores)
        ka, ba = cs._levels0(out["KA"]), cs._levels0(out["BA"])
        res["photometric_ka"] = dict(
            read(), ka_iterations=ka["iterations"],
            ka_cost=float(ka["final_cost"]), ba_cost=float(ba["final_cost"]),
            point_error=float(cs.triangulated_error(np, rec, truth)))
        del sfm, rec, views
        torch.cuda.empty_cache()

    rec, views, _ = cs.make_ba_scene(torch, np, seed=11, n_views=56,
                                     n_points=40000, W=1600, H=1200,
                                     device="cuda")
    sfm = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": cs.BA_ITERATIONS}}}}}, device="cuda")
    zero()
    out = {k: v[0] for k, v in sfm.run_ba(rec, views).items()}
    res["ba"] = dict(read(), lm=out["iterations"], cg=out["cg_iterations"],
                     cost=float(out["final_cost"]))
    print("LAUNCH_COUNTS " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
