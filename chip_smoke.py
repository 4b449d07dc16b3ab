#!/usr/bin/env python3
"""Smoke run of pixsfm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-out DIR]

Phases (any failure exits non-zero; no phase catches its own failure):

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build every CUDA kernel from ``pixsfm_tpu_torch/kernels/csrc``
   (one nvcc per source, all at once).
2. K1 (bicubic window interpolation, ``ops/interpolate_cuda.py``) against its
   plain PyTorch version on the card at the main path's shapes, bf16 and f32
   storage, L2 on and off, queries on the patch border.
3. K2 (batched Jacobi PCG, ``ops/cg_cuda.py``) against its plain version,
   folded-damping and explicit forms.
4. A small scene through ``PixSfM.run_ka`` on ``cuda`` and on ``cpu`` (the
   plain versions): the refined keypoints agree.
5. The main path at full width: ``PixSfM.run_ka`` with the default config
   (S2DNet 128 channels, bf16 patches of 16 px, 50 keypoints per problem,
   chunks of 128, 100 LM iterations) on 10 synthetic 1600x1200 views of one
   textured plane, 2000 points seen in every view. The kernel launch
   counters are zeroed just before and read just after; both kernels must
   have launched, the KA cost must fall, keypoints stay finite and within
   the bound.
6. Where the time goes: the same scene again, graph building, extraction
   and KA timed apart, the last two under ``torch.profiler`` (device-busy
   time and the top kernels; with ``--profile-out DIR`` the full tables go
   to ``DIR/chip_smoke_profile.txt``).

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path, its error against the plain version, its time per launch (CUDA
events), the plain version's time and the bound computed from this run's
inputs; and last ``{"ok": true, "device": {...}}``.

The weights are S2DNet's deterministic random init (no checkpoint ships
with the repository); the scene is made from a seed with numpy.
"""

import argparse
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=20, warmup=3):
    """Device time per call of ``fn`` (CUDA events around ``reps`` calls).

    A sleep kernel (~0.1 s) is queued first, so the host has enqueued every
    call before the device reaches them: the wrappers' host-side launch
    cost (tens of microseconds, like the kernels themselves) would
    otherwise show up as idle time between the events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------

def check_k1(torch, interpolate_cuda, n_patches, n_queries, ps=16, C=128):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((n_patches * ps, ps, C), generator=gen, device=dev)
    row_base = torch.randint(0, n_patches, (n_queries,), generator=gen,
                             device=dev) * ps
    r = torch.rand(n_queries, generator=gen, device=dev) * (ps + 2.0) - 1.5
    c = torch.rand(n_queries, generator=gen, device=dev) * (ps + 2.0) - 1.5
    r[:4] = torch.tensor([0.0, ps - 1.0, 0.25, ps - 1.25])
    c[:4] = torch.tensor([ps - 1.0, 0.0, ps - 1.5, 0.5])
    worst = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-3)):
        rows = base.to(dtype)
        for l2 in (False, True):
            out = interpolate_cuda.interpolate_rows(rows, ps, ps, C, row_base,
                                                    r, c, l2)
            ref = interpolate_cuda.interpolate_rows_plain(rows, ps, ps, C,
                                                          row_base, r, c, l2)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            print(f"K1 {str(dtype)[6:]} l2={l2}: max |kernel - plain| = "
                  f"{err:.3e} (atol {tol})")
            if not all(bool(torch.isfinite(o).all()) for o in out) \
                    or err > tol:
                raise SystemExit(f"K1 disagrees with its plain version "
                                 f"({dtype}, l2={l2}): {err}")
            worst = max(worst, err)
    # timing at the main path's configuration: bf16 storage, L2 on
    rows = base.to(torch.bfloat16)
    del base
    ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        rows, ps, ps, C, row_base, r, c, True))
    plain_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows_plain(
        rows, ps, ps, C, row_base, r, c, True), reps=5)
    # bound: the distinct tap pixels this input needs, read once, plus the
    # query inputs and the three float32 outputs
    taps = torch.arange(-1, 3, device=dev)
    ri = torch.clamp(torch.floor(r).long()[:, None] + taps, 0, ps - 1)
    ci = torch.clamp(torch.floor(c).long()[:, None] + taps, 0, ps - 1)
    pix = ((row_base.long()[:, None, None] + ri[:, :, None]) * ps
           + ci[:, None, :]).reshape(-1)
    n_pix = int(torch.unique(pix).numel())
    bytes_ = n_pix * C * 2 + n_queries * 12 + 3 * n_queries * C * 4
    flops = n_queries * C * (16 * 6 + 12)
    bound_ms = 1e3 * max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
    bound_by = "bytes" if bytes_ / HBM_BYTES_PER_S >= \
        flops / FP32_FLOP_PER_S else "operations"
    print(f"K1 timing (bf16, L2, N={n_queries}, {n_patches} patches): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------

def check_k2(torch, cg_cuda, P, N, iters):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    A = torch.randn((P, N, N), generator=gen, device=dev)
    H = A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)
    g = torch.randn((P, N), generator=gen, device=dev)
    damp = torch.rand((P, N), generator=gen, device=dev) * 0.1
    worst = 0.0
    for name, Hx, dx in (("folded damping", H, damp),
                         ("explicit Hd", H + torch.diag_embed(damp), None)):
        out = cg_cuda.pcg_solve(Hx, g, iters, damp=dx)
        ref = cg_cuda.pcg_solve_plain(Hx, g, iters, damp=dx)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and bool(
            ((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
        print(f"K2 {name}: max |kernel - plain| = {err:.3e} "
              f"(rtol/atol 1e-4)")
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version ({name})")
        worst = max(worst, err)
    ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, iters, damp=damp))
    plain_ms = _time_ms(lambda: cg_cuda.pcg_solve_plain(H, g, iters,
                                                        damp=damp))
    bytes_ = P * N * N * 4 + 3 * P * N * 4
    flops = P * (iters * (2 * N * N + 13 * N) + 5 * N)
    bound_ms = 1e3 * max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
    bound_by = "bytes" if bytes_ / HBM_BYTES_PER_S >= \
        flops / FP32_FLOP_PER_S else "operations"
    print(f"K2 timing (P={P}, N={N}, {iters} iters): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# synthetic scene: views of one textured plane under mild homographies
# ---------------------------------------------------------------------------

def make_scene(np, seed, n_views, n_points, W, H, margin):
    rng = np.random.default_rng(seed)
    n_waves = 8
    freq = rng.uniform(1 / 48, 1 / 10, n_waves) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, n_waves))
    fx, fy = freq.real.astype(np.float32), freq.imag.astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    mix = rng.normal(0, 1, (n_waves, 3)).astype(np.float32)
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))

    homs = []
    for v in range(n_views):
        if v == 0:
            homs.append(np.eye(3))
            continue
        a = rng.uniform(-0.05, 0.05)
        s = rng.uniform(0.97, 1.03)
        Hm = np.array([[s * np.cos(a), -s * np.sin(a), rng.uniform(-20, 20)],
                       [s * np.sin(a), s * np.cos(a), rng.uniform(-20, 20)],
                       [rng.uniform(-1e-5, 1e-5), rng.uniform(-1e-5, 1e-5),
                        1.0]])
        # keep the image centre fixed so every point stays in view
        ctr = np.array([W / 2, H / 2, 1.0])
        moved = Hm @ ctr
        T = np.eye(3)
        T[:2, 2] = ctr[:2] - moved[:2] / moved[2] + Hm[:2, 2]
        homs.append(T @ Hm)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)   # centres
    images = {}
    for v, Hm in enumerate(homs):
        q = pix @ np.linalg.inv(Hm).T.astype(np.float32)
        u, w = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
        img = np.full((H, W, 3), 127.5, np.float32)
        for k in range(n_waves):
            wave = np.sin(2 * np.pi * (fx[k] * u + fy[k] * w) + phase[k])
            img += wave[..., None] * mix[k]
        images[f"view{v:02d}.png"] = np.clip(img, 0, 255).astype(np.uint8)

    X = np.stack([rng.uniform(margin, W - margin, n_points),
                  rng.uniform(margin, H - margin, n_points),
                  np.ones(n_points)], -1)
    truth, keypoints = {}, {}
    for v, (name, Hm) in enumerate(zip(images, homs)):
        p = X @ Hm.T
        truth[name] = p[:, :2] / p[:, 2:]
        noise = rng.normal(0, 1.0, truth[name].shape) if v else 0.0
        keypoints[name] = truth[name] + noise
    names = list(images)
    ident = np.stack([np.arange(n_points)] * 2, axis=1)
    matches, scores = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            matches[(a, b)] = ident
            # the unperturbed reference view matches best, so its
            # keypoints become the (frozen) track roots
            scores[(a, b)] = np.full(n_points, 1.0 if i == 0 else 0.5)
    return images, keypoints, truth, matches, scores


def gt_error(np, keypoints, truth, names):
    return float(np.mean([np.linalg.norm(keypoints[n] - truth[n], axis=1)
                          for n in names]))


def profile_stage(torch, fn):
    """Run ``fn`` under torch.profiler: (result, wall s, device-busy s,
    [(kernel, calls, device ms)] by device time, full table)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in avg if e.device_type == DeviceType.CUDA),
                  key=lambda k: -k[2])
    busy = sum(k[2] for k in kern) / 1e3
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    return res, wall, busy, kern, table


# ---------------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-out", default=None,
                        help="directory for the profiler tables")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from pixsfm_tpu_torch import kernels
    from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda
    from pixsfm_tpu_torch.refine_hloc import PixSfM

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"phase 1: built {built} in {time.perf_counter() - t0:.1f} s")

    # -- phases 2-3: kernels against their plain versions ----------------------
    P, K = 128, 56                 # main path: chunk 128, 50 kps padded to 56
    k1 = check_k1(torch, interpolate_cuda, n_patches=20000,
                  n_queries=P * K)
    k2 = check_k2(torch, cg_cuda, P=P, N=2 * K, iters=15)

    # -- phase 4: small scene, cuda against cpu --------------------------------
    images, kps, truth, matches, scores = make_scene(
        np, seed=3, n_views=3, n_points=40, W=320, H=240, margin=60)
    kp_dev, _ = PixSfM(device="cuda").run_ka(
        {k: v.copy() for k, v in kps.items()}, images, matches=matches,
        scores=scores)
    kp_cpu, _ = PixSfM(device="cpu").run_ka(
        {k: v.copy() for k, v in kps.items()}, images, matches=matches,
        scores=scores)
    diff = max(float(np.abs(kp_dev[n] - kp_cpu[n]).max()) for n in kps)
    print(f"phase 4: small scene, max |kp(cuda) - kp(cpu)| = {diff:.2e} px "
          f"(limit 0.05 px)")
    if not diff <= 0.05:
        raise SystemExit("cuda and cpu KA disagree on the small scene")

    # -- phase 5: the main path at full width ----------------------------------
    t0 = time.perf_counter()
    images, kps, truth, matches, scores = make_scene(
        np, seed=0, n_views=10, n_points=2000, W=1600, H=1200, margin=150)
    names = list(images)
    print(f"phase 5: scene of {len(names)} views, "
          f"{sum(len(v) for v in kps.values())} keypoints, "
          f"{len(matches)} pairs made in {time.perf_counter() - t0:.1f} s")
    sfm = PixSfM(device="cuda")
    kp0 = {k: v.copy() for k, v in kps.items()}
    err0 = gt_error(np, kp0, truth, names[1:])
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    t0 = time.perf_counter()
    kp1, out = sfm.run_ka(kps, images, matches=matches, scores=scores)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches}
    ka_s = float(out["time"][0])
    err1 = gt_error(np, kp1, truth, names[1:])
    moved = max(float(np.abs(kp1[n] - kp0[n]).max()) for n in names)
    c0, c1 = float(out["initial_cost"][0]), float(out["final_cost"][0])
    print(f"phase 5: run_ka {wall:.2f} s (extraction + graph "
          f"{wall - ka_s:.2f} s, KA {ka_s:.2f} s), "
          f"{out['num_problems'][0]} problems, LM iterations "
          f"{out['iterations'][0]}, cost {c0:.4f} -> {c1:.4f}, mean error "
          f"to ground truth {err0:.3f} -> {err1:.3f} px, largest move "
          f"{moved:.3f} px, launches {launches}")
    if not all(np.isfinite(kp1[n]).all() for n in names):
        raise SystemExit("non-finite keypoints")
    if not c1 < c0:
        raise SystemExit("KA cost did not fall")
    if not moved <= 4.0 + 1e-3:
        raise SystemExit("a keypoint left its bound")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel did not launch on the main path: "
                         f"{launches}")

    # -- phase 6: where the time goes (a second run, not counted) --------------
    from pathlib import Path

    from pixsfm_tpu_torch.extract import features_from_graph
    from pixsfm_tpu_torch.keypoint_adjustment import build_matching_graph
    kps2 = {k: v.copy() for k, v in kp0.items()}
    t0 = time.perf_counter()
    graph = build_matching_graph(matches, scores)
    t_graph = time.perf_counter() - t0
    fm, t_ext, busy_ext, kern_ext, tab_ext = profile_stage(
        torch, lambda: features_from_graph(sfm.extractor, images, graph,
                                           kps2))
    _, t_ka, busy_ka, kern_ka, tab_ka = profile_stage(
        torch, lambda: sfm.keypoint_adjuster.refine_multilevel(kps2, fm,
                                                               graph))
    print(f"phase 6 (under the profiler): graph {t_graph:.3f} s; "
          f"extraction {t_ext:.3f} s wall, {busy_ext:.3f} s device busy; "
          f"KA {t_ka:.3f} s wall, {busy_ka:.3f} s device busy "
          f"(idle share {1 - busy_ka / t_ka:.2f})")
    for stage, kern in (("extraction", kern_ext), ("KA", kern_ka)):
        for name, calls, dev_ms in kern[:6]:
            print(f"  {stage}: {dev_ms:9.3f} ms in {calls:5d} launches  "
                  f"{name[:90]}")
    if args.profile_out:
        out_dir = Path(args.profile_out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke_profile.txt").write_text(
            f"{smi}\n\n== extraction ==\n{tab_ext}\n\n== KA ==\n"
            f"{tab_ka}\n")

    # -- report ----------------------------------------------------------------
    kernels_line = {"kernels": [
        dict(name="bicubic_window_interp_l2", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches["K1"], library_ms=None, **k1),
        dict(name="batched_jacobi_pcg", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/pcg.cu",
             replaces="pixsfm_tpu/ops/cg_pallas.py:88",
             launches=launches["K2"], library_ms=None, **k2),
    ]}
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
