#!/usr/bin/env python3
"""Smoke run of pixsfm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-out DIR]

Phases (any failure exits non-zero; no phase catches its own failure):

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build every CUDA kernel from ``pixsfm_tpu_torch/kernels/csrc``
   (one nvcc per source, all at once).
2. K1 (bicubic window interpolation, ``ops/interpolate_cuda.py``) against its
   plain PyTorch version on the card at the main path's shapes, bf16 and f32
   storage, L2 on and off, queries on the patch border; then at small shapes
   that reach its general variant and the edges of the vector one (channel
   counts that are no multiple of 8, f32 rows of 128 channels, 3 x 3
   patches, a base that is not 16-byte aligned).
3. K2 (batched Jacobi PCG, ``ops/cg_cuda.py``) against its plain version,
   folded-damping and explicit forms, each variant (register, general) at
   the main path's shape (P = 128 systems of N = 112, 15 steps) and at
   edge shapes (P = 300 and 1, 0 and 1 steps, N = 128, 51, 132 and 200);
   the main shape must take the register variant. Timed there on a
   repeated H, on 20 H sets that change from launch to launch, through the
   general variant (the earlier design), and with no CG step (load and set-up).
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
   to ``DIR/chip_smoke_profile.txt``). K2 must show its register variant
   only.
7. K3a/b/c (the Schur kernels of the grid-regime CG solve,
   ``ops/schur_cuda.py``) against their plain versions at the BA main
   path's shape (T = 8 ranks, SIMPLE_RADIAL so k = 4, 56 images, one
   camera, 65 536 padded points): error against a float64 reference and
   time per launch, K3b also forced to its one-pass variant; then at small
   shapes that reach every variant of K3a and of K3b (fused with one and
   two ranks per warp, two-pass / one-pass, tables in shared and in global
   memory; T not a power of two, k = 1 and 8, mixed camera slots).
   Then K1 again at the BA path's shape: 8192 queries (one
   chunk of observations) over 240 000 bf16 patches (one per observation,
   7.9e9 elements, so offsets past 2^31), L2 on and off.
8. A small scene through ``ba_solve`` on the grid layout on ``cuda`` and
   on ``cpu`` (the plain versions): final cost and points agree.
9. The second main path at full size: ``PixSfM.run_ba`` with the default
   config (featuremetric BA, S2DNet 128 channels, bf16 patches) on 56
   rendered 1600x1200 views of a textured plane, 40 000 points with tracks
   of 4-8 views (~240 000 observations), poses and points perturbed from
   the truth. The scene's size makes ``_run_ba_cached`` pick the grid
   regime by itself; the LM runs at most ``BA_ITERATIONS`` iterations. The
   counters are zeroed just before and read just after: K1 and K3a/b/c
   must have launched, the cost must fall, poses and points stay finite.
10. Where the BA time goes: the same BA again, extraction and references +
   solve (``BA_PROFILE_ITERATIONS`` LM iterations) under ``torch.profiler``:
   device-busy time, idle share, the top kernels and the in-situ time per
   launch of K1 and K3a/b/c (a kernel that launched and has no in-situ
   figure fails the run). K3b must show its fused variant only.
11. The triangulation main path at full width: the body of
   ``PixSfM.triangulation`` (KA -> triangulation with known poses -> BA,
   default config, BA capped at ``BA_ITERATIONS``) on 24 rendered
   1600x1200 views, 8000 points with tracks of 3-8 views, keypoints the
   true projections plus N(0, 1 px), matches over every view pair within
   each track (score 1), the true poses and intrinsics as the reference
   model (written and read back). Counters zeroed just before and read
   just after: K1 and K2 must have launched, the BA must take the flat CG
   layout and lower its cost, the points stay finite and at least
   ``TRI_MIN_SURVIVING`` of the tracks survive. Then the same path under
   the profiler (BA capped at ``BA_PROFILE_ITERATIONS``), and K1 timed at
   this path's BA shape.
12. The dense Schur step: a small rendered scene (12 views of 640x480,
   1500 points with tracks of 3: 13 500 track pairs, 76 camera unknowns)
   through ``refine_reconstruction`` (the ``bundle_adjuster`` command's
   function, geometric strategy) on ``cuda`` and on ``cpu``, with one
   camera model and with two (half the views on PINHOLE): both must take
   the dense step and agree within phase 8's limits.
13. ``refine_colmap``'s ``keypoint_adjuster`` command on a COLMAP database
   of phase 5's scene (written with the port's ``COLMAPDatabase``): the
   keypoints it writes agree with ``run_ka`` on the same inputs within
   ``DB_KP_ATOL``.
14. PnP (``localization/pnp.py``): ``PNP_QUERIES`` queries of 30-2000
   correspondences (general and planar scenes, 0-60 % outliers,
   SIMPLE_RADIAL and PINHOLE) through ``absolute_pose_estimation_batch`` on
   ``cuda`` and on ``cpu``, unpolished and polished: the same success,
   inlier counts within 1, each pose explains all but one of the other's
   inliers, poses within ``PNP_UNPOLISHED_TOL`` / ``PNP_POLISHED_TOL``
   (tied hypotheses; see the constants). Then one stage-1 program and one stage-2 program
   timed, with their kernel launches counted under the profiler.
15. The incremental mapper (``sfm/mapper.py``) on the ring of
   ``tests/test_mapper_scale.py`` at 12 views and 300 points (unknown
   intrinsics) on ``cuda`` and on ``cpu``: the same registered images and
   initial pair, point counts within 2 %, and after a similarity alignment
   rotations within 0.05 degrees and centres within 1e-3 of the extent.
16. The reconstruction main path at full width: the body of
   ``PixSfM.reconstruction`` (KA -> incremental mapper with unknown
   intrinsics -> BA, default config, BA capped at ``BA_ITERATIONS``, the
   mapper at its defaults) on 24 ray-cast 1600x1200 views of a valley of two
   textured planes, ``RECON_POINTS`` points with tracks of 3-8 views,
   keypoints the true projections plus N(0, ``RECON_NOISE_PX``), matches
   over every view pair within each track. Counters zeroed just before and
   read just after: at least 23 of the 24 views register, after a
   similarity to the truth rotations within 0.5 degrees and centres within
   1 % of the extent, the BA cost falls, K1 and K2 launched. Then the KA
   and the final BA (capped at ``BA_PROFILE_ITERATIONS``) under the
   profiler, and one call of each of the mapper's device stages (PnP, the
   retriangulation, a geometric BA) on the final map, from which the
   mapper's device-idle share is estimated; and K1 timed at this path's BA
   shape.
17. Phase 11's triangulation path again with ``configs/dsift.yaml`` (dense
   SIFT, no weights): the point error to the truth before and after KA and
   BA beside S2DNet's; costs fall, points stay finite.

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main paths (KA, BA, triangulation), its error against the plain version, its
time per launch (CUDA events), the plain version's time and the bound computed
from this run's inputs (``cold_ms``: K1 on query sets that change from launch
to launch, so that no tap is left in the L2 cache; ``general_ms`` and
``general_cold_ms``: the same two for K1's general variant, forced by a
misaligned copy of the rows, which is the kernel's earlier design; K2's
``variant``, ``cold_ms`` on changing systems and ``general_ms``, its earlier
design; K3b's ``variant`` and ``onepass_ms``, its earlier design;
``in_situ_ms``: the profiler's device time per launch inside the stage;
``max_abs_err`` is the error at the shape that was timed, K1's and K2's
``edge_max_abs_err`` the largest one over the edge shapes, whose tolerances are
printed with each case); K1, which every path launches at different shapes, has
one entry per path (``"path": "KA"`` / ``"BA"`` / ``"triangulation"`` /
``"reconstruction"``, the last two timed at their path's BA shape) with that
path's launches and the figures at its shape; K2's entry sums its launches over the paths and lists them in
``launches_by_path``; and last ``{"ok": true, "device": {...}}``.

The weights are S2DNet's deterministic random init (no checkpoint ships
with the repository); the scenes are made from seeds with numpy.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# depth of the full-size BA (the default config allows 100 LM iterations)
BA_ITERATIONS = 30
BA_PROFILE_ITERATIONS = 2
# least share of the triangulation scene's tracks that must survive the
# acceptance rules (8000 of 8000 on an H100 with 1 px keypoint noise and the
# default 4 px limit; fixed here with a margin)
TRI_MIN_SURVIVING = 0.98
# the database keypoint adjuster against run_ka (float32 storage: ~2e-4 px)
DB_KP_ATOL = 1e-3
# phase 14: PnP queries, and the limits of cuda against cpu on the poses.
# Unpolished, a pose is the first of the minimal-sample hypotheses with the
# largest consensus; float32 rounding (P3P's near-double roots, points at the
# threshold) can change which of several tied hypotheses comes first, and
# two such poses differ by up to 4.4e-2 rad on these queries (two sample
# seeds on one device). The polish starts its Cauchy scale from the
# unpolished pose's residuals, so it narrows that spread (to 6.9e-3 rad) but
# does not close it. Both results must hold the same consensus: inlier
# counts within 1, and each pose explains all but one of the other's
# inliers.
PNP_QUERIES = 64
PNP_UNPOLISHED_TOL = 5e-2
PNP_POLISHED_TOL = 1e-2
# phase 16: the reconstruction scene
RECON_POINTS = 4000
RECON_NOISE_PX = 0.5


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

def check_k1(torch, interpolate_cuda, n_patches, n_queries, dtypes,
             ps=16, C=128):
    """K1 against its plain version on random patches stored in each of
    ``dtypes`` (the first one makes the random base), L2 on and off; timed
    at the main paths' configuration, bf16 storage and L2 on."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((n_patches * ps, ps, C), generator=gen, device=dev,
                       dtype=dtypes[0])
    row_base = torch.randint(0, n_patches, (n_queries,), generator=gen,
                             device=dev) * ps
    row_base[-1] = (n_patches - 1) * ps      # the last patch: top offsets
    r = torch.rand(n_queries, generator=gen, device=dev) * (ps + 2.0) - 1.5
    c = torch.rand(n_queries, generator=gen, device=dev) * (ps + 2.0) - 1.5
    r[:4] = torch.tensor([0.0, ps - 1.0, 0.25, ps - 1.25])
    c[:4] = torch.tensor([ps - 1.0, 0.0, ps - 1.5, 0.5])
    worst = 0.0
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-3}
    for dtype in dtypes:
        tol = tols[dtype]
        rows = base.to(dtype)
        for l2 in (False, True):
            out = interpolate_cuda.interpolate_rows(rows, ps, ps, C, row_base,
                                                    r, c, l2)
            ref = interpolate_cuda.interpolate_rows_plain(rows, ps, ps, C,
                                                          row_base, r, c, l2)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            print(f"K1 {str(dtype)[6:]} l2={l2} (N={n_queries}, "
                  f"{n_patches} patches): max |kernel - plain| = {err:.3e} "
                  f"(atol {tol})")
            if not all(bool(torch.isfinite(o).all()) for o in out) \
                    or err > tol:
                raise SystemExit(f"K1 disagrees with its plain version "
                                 f"({dtype}, l2={l2}): {err}")
            worst = max(worst, err)
    # timing at the main path's configuration: bf16 storage, L2 on
    rows = base.to(torch.bfloat16)
    del base
    row_base = row_base.to(torch.int32)   # as the callers pass it: no cast
    ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        rows, ps, ps, C, row_base, r, c, True))
    plain_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows_plain(
        rows, ps, ps, C, row_base, r, c, True), reps=5)
    # the same launch on query sets that change every time: together they
    # read far more than the 50 MB L2 holds, as a caller's chunks do
    n_sets = 8
    sets = [(torch.randint(0, n_patches, (n_queries,), generator=gen,
                           device=dev).to(torch.int32) * ps,
             torch.rand(n_queries, generator=gen, device=dev) * (ps + 2.0)
             - 1.5,
             torch.rand(n_queries, generator=gen, device=dev) * (ps + 2.0)
             - 1.5) for _ in range(n_sets)]
    turn = iter(range(10 ** 9))
    cold_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        rows, ps, ps, C, *sets[next(turn) % n_sets], True), reps=40, warmup=8)
    # the general variant on the same queries: a copy of the rows one
    # element past an aligned base, which the 16-byte loads cannot take
    shifted = torch.empty(rows.numel() + 8, device=dev,
                          dtype=rows.dtype)[1:rows.numel() + 1].view_as(rows)
    shifted.copy_(rows)
    if interpolate_cuda.kernel_variant(shifted) != "general":
        raise SystemExit("K1 took 16-byte loads on a misaligned base")
    general_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        shifted, ps, ps, C, row_base, r, c, True))
    general_cold_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        shifted, ps, ps, C, *sets[next(turn) % n_sets], True), reps=40,
        warmup=8)
    del shifted
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
    variant = interpolate_cuda.kernel_variant(rows)
    print(f"K1 timing (bf16, L2, N={n_queries}, {n_patches} patches, "
          f"{variant} variant): kernel {ms:.4f} ms ({cold_ms:.4f} ms on "
          f"changing query sets), general variant {general_ms:.4f} ms "
          f"({general_cold_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB)")
    if variant != "vector":
        raise SystemExit("K1 did not take its vector variant at a main "
                         "path's shape")
    return dict(max_abs_err=worst, ms=ms, cold_ms=cold_ms,
                general_ms=general_ms, general_cold_ms=general_cold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k1_edges(torch, interpolate_cuda):
    """K1 against its plain version at small shapes that reach the general
    variant and the edges of the vector one, at the tolerances of
    :func:`check_k1`. Returns the largest error."""
    dev = torch.device("cuda")
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-3}
    # (dtype, C, H, W, misaligned base, expected variant)
    cases = [(torch.bfloat16, 20, 16, 16, False, "general"),
             (torch.bfloat16, 136, 16, 16, False, "general"),
             (torch.float32, 20, 16, 16, False, "general"),
             (torch.float32, 128, 16, 16, False, "vector"),
             (torch.bfloat16, 128, 3, 3, False, "vector"),
             (torch.float32, 128, 3, 3, False, "vector"),
             (torch.bfloat16, 20, 3, 3, False, "general"),
             (torch.bfloat16, 128, 16, 16, True, "general"),
             (torch.float32, 128, 16, 16, True, "general")]
    worst = 0.0
    for dtype, C, H, W, misaligned, want in cases:
        gen = torch.Generator(device=dev).manual_seed(C + H)
        n_patches, n = 40, 1501
        numel = n_patches * H * W * C
        buf = torch.randn(numel + 8, generator=gen, device=dev).to(dtype)
        # one element past an aligned base: 2 or 4 bytes off
        rows = buf[1:numel + 1] if misaligned else buf[:numel]
        rows = rows.view(n_patches * H, W, C)
        row_base = torch.randint(0, n_patches, (n,), generator=gen,
                                 device=dev) * H
        r = torch.rand(n, generator=gen, device=dev) * (H + 2.0) - 1.5
        c = torch.rand(n, generator=gen, device=dev) * (W + 2.0) - 1.5
        r[:4] = torch.tensor([0.0, H - 1.0, 0.25, H - 1.25])
        c[:4] = torch.tensor([W - 1.0, 0.0, W - 1.5, 0.5])
        got = interpolate_cuda.kernel_variant(rows)
        for l2 in (False, True):
            out = interpolate_cuda.interpolate_rows(rows, H, W, C, row_base,
                                                    r, c, l2)
            ref = interpolate_cuda.interpolate_rows_plain(rows, H, W, C,
                                                          row_base, r, c, l2)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            print(f"K1 edge {str(dtype)[6:]} C={C} {H}x{W} "
                  f"{'misaligned ' if misaligned else ''}l2={l2} ({got} "
                  f"variant): max |kernel - plain| = {err:.3e} (atol "
                  f"{tols[dtype]})")
            if got != want or err > tols[dtype] or not all(
                    bool(torch.isfinite(o).all()) for o in out):
                raise SystemExit(f"K1 edge case failed: {dtype} C={C} "
                                 f"{H}x{W} misaligned={misaligned} l2={l2}: "
                                 f"variant {got} (expected {want}), error "
                                 f"{err}")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------

def _spd(torch, P, N, seed):
    """A batch of SPD systems on the card: (H, g, damp)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((P, N, N), generator=gen, device=dev)
    H = A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)
    g = torch.randn((P, N), generator=gen, device=dev)
    damp = torch.rand((P, N), generator=gen, device=dev) * 0.1
    return H, g, damp


def _k2_err(torch, cg_cuda, H, g, damp, iters, variant, what):
    """Largest |kernel - plain| over the folded and explicit forms; fails
    past rtol/atol 1e-4."""
    worst = 0.0
    for name, Hx, dx in (("folded damping", H, damp),
                         ("explicit Hd", H + torch.diag_embed(damp), None)):
        out = cg_cuda.pcg_solve(Hx, g, iters, damp=dx, variant=variant)
        ref = cg_cuda.pcg_solve_plain(Hx, g, iters, damp=dx)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and bool(
            ((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
        print(f"K2 {what}, {variant} variant, {name}: max |kernel - plain| "
              f"= {err:.3e} (rtol/atol 1e-4)")
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version ({what}, "
                             f"{variant}, {name})")
        worst = max(worst, err)
    return worst


# (P, N, iters) besides the main path's: more systems than SMs, one system,
# zero and one step, the register variant's largest N, N that take the
# general variant (odd, the first multiple of 4 past 128, 200)
K2_EDGES = [(300, 112, 15), (1, 112, 15), (128, 112, 0), (128, 112, 1),
            (64, 128, 15), (64, 51, 15), (64, 132, 15), (9, 200, 15)]


def check_k2(torch, cg_cuda, P, N, iters):
    """K2 against its plain version, each variant that a shape allows, at
    the main path's shape and at :data:`K2_EDGES`; timed at the main path's
    shape on a repeated H, on H sets that change from launch to launch
    (``cold_ms``) and through the general variant (``general_ms``)."""
    variant = cg_cuda.kernel_variant(N)
    if variant != "register":
        raise SystemExit(f"K2 takes its {variant} variant at the main "
                         f"path's N={N}")
    H, g, damp = _spd(torch, P, N, seed=2)
    err = _k2_err(torch, cg_cuda, H, g, damp, iters, variant,
                  f"P={P} N={N} iters={iters}")
    edge = _k2_err(torch, cg_cuda, H, g, damp, iters, "general",
                   f"P={P} N={N} iters={iters}")
    seen = {variant, "general"}
    for Pe, Ne, it in K2_EDGES:
        He, ge, de = _spd(torch, Pe, Ne, seed=Pe + Ne + it)
        for v in sorted({cg_cuda.kernel_variant(Ne), "general"}):
            edge = max(edge, _k2_err(torch, cg_cuda, He, ge, de, it, v,
                                     f"P={Pe} N={Ne} iters={it}"))
            seen.add(v)
    if seen != set(cg_cuda.VARIANTS):
        raise SystemExit(f"K2 variants not reached: {seen}")
    ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, iters, damp=damp))
    general_ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, iters, damp=damp,
                                                    variant="general"))
    plain_ms = _time_ms(lambda: cg_cuda.pcg_solve_plain(H, g, iters,
                                                        damp=damp))
    # the load and set-up alone: the same launch with no CG step
    zero_ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, 0, damp=damp))
    general_zero_ms = _time_ms(lambda: cg_cuda.pcg_solve(
        H, g, 0, damp=damp, variant="general"))
    # 20 sets of 6.4 MB, more than the 50 MB L2 holds, as the LM's
    # systems change from launch to launch
    n_sets = 20
    sets = [_spd(torch, P, N, seed=1000 + k) for k in range(n_sets)]
    turn = iter(range(10 ** 9))

    def cold():
        Hs, gs, ds = sets[next(turn) % n_sets]
        cg_cuda.pcg_solve(Hs, gs, iters, damp=ds)
    cold_ms = _time_ms(cold, reps=40, warmup=8)
    del sets
    bytes_ = P * N * N * 4 + 3 * P * N * 4
    flops = P * (iters * (2 * N * N + 13 * N) + 5 * N)
    bound_ms, bound_by = _bound(bytes_, flops)
    print(f"K2 timing (P={P}, N={N}, {iters} iters, {variant} variant): "
          f"kernel {ms:.4f} ms ({cold_ms:.4f} ms on changing systems; "
          f"{zero_ms:.4f} ms with no step, so "
          f"{(ms - zero_ms) / iters * 1e3:.3f} us per step), general "
          f"variant {general_ms:.4f} ms ({general_zero_ms:.4f} ms with no "
          f"step, {(general_ms - general_zero_ms) / iters * 1e3:.3f} us per "
          f"step), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return dict(variant=variant, max_abs_err=err, edge_max_abs_err=edge,
                ms=ms, cold_ms=cold_ms, general_ms=general_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# synthetic scene: views of one textured plane under mild homographies
# ---------------------------------------------------------------------------

def _bound(bytes_, flops):
    """(bound ms, what sets it) at the H100's peak rates."""
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------------
# phase 7: K3a/b/c
# ---------------------------------------------------------------------------

def k3_inputs(torch, schur_cuda, T, I, Nc, k, P, n_obs, seed=7,
              device="cuda"):
    """Grid-packed Schur inputs at the BA main path's shape: ``n_obs`` real
    observations spread over P points x T ranks, the other slots holes
    (zero W blocks, indices at slot 0)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    NR = 6 + k
    O = P * T
    Bt = torch.randn((NR * 3, O), generator=gen, device=dev)
    img = torch.randint(0, I, (O,), generator=gen, device=dev)
    cam = torch.randint(0, Nc, (O,), generator=gen, device=dev)
    hole = torch.rand(O, generator=gen, device=dev) >= n_obs / O
    Bt[:, hole] = 0.0
    img[hole] = 0
    cam[hole] = 0
    A = torch.randn((P, 3, 3), generator=gen, device=dev)
    Vinv = torch.einsum("pab,pcb->acp", A, A) \
        + 3 * torch.eye(3, device=dev)[:, :, None]
    Btr, img_r, cam_r, Vi, Ppad = schur_cuda.pack_grid_blocks(
        Bt, img, cam, Vinv, T)
    return dict(vpT=torch.randn((6, I), generator=gen, device=dev),
                vcT=torch.randn((k, Nc), generator=gen, device=dev),
                Btr=Btr, img_r=img_r, cam_r=cam_r, Vinv=Vi,
                gx=torch.randn((3, Ppad), generator=gen, device=dev))


def check_k3(torch, schur_cuda, T, I, Nc, k, P, n_obs, device="cuda",
             timed=True, seed=7):
    """Each K3 kernel against its plain version (K3b also forced to its
    one-pass variant, ``"K3b onepass"``). Tolerance: |kernel - ref|
    <= 2e-5 |ref| + 1e-6 S per entry, ref the plain version in float64 and
    S the same sums over absolute values (the kernels add in another,
    atomic, order, so their float32 error grows with S, not |ref|). With
    ``timed`` each kernel and its plain version are also timed and the bound
    is computed."""
    x = k3_inputs(torch, schur_cuda, T, I, Nc, k, P, n_obs, seed=seed,
                  device=device)
    dims = dict(T=T, I=I, Nc=Nc, k=k)
    cases = {
        "K3a": (lambda a: schur_cuda.schur_term_matvec(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"],
                    a["Vinv"], **dims),
                lambda a: schur_cuda.schur_term_matvec_plain(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"],
                    a["Vinv"])),
        "K3b": (lambda a: schur_cuda.schur_rhs(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"],
                    **dims),
                lambda a: schur_cuda.schur_rhs_plain(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"], I,
                    Nc)),
        "K3b onepass": (lambda a: schur_cuda.schur_rhs(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"],
                    variant="onepass", **dims),
                lambda a: schur_cuda.schur_rhs_plain(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"], I,
                    Nc)),
        "K3c": (lambda a: (schur_cuda.schur_backsub(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"],
                    **dims),),
                lambda a: (schur_cuda.schur_backsub_plain(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"]),)),
    }
    x64 = {n: v.double() if v.is_floating_point() else v for n, v in x.items()}
    xabs = {n: v.abs() if v.is_floating_point() else v
            for n, v in x64.items()}
    NR = 6 + k
    n_in = x["Btr"].numel() * 4 + 2 * x["img_r"].numel() * 4
    tables = (6 * I + k * Nc) * 4
    bytes_ = {"K3a": n_in + x["Vinv"].numel() * 4 + 2 * tables,
              "K3b": n_in + x["Vinv"].numel() * 4 + x["gx"].numel() * 4
              + tables,
              "K3b onepass": n_in + x["Vinv"].numel() * 4
              + x["gx"].numel() * 4 + tables,
              "K3c": n_in + tables + x["gx"].numel() * 4}
    per_obs = P * T * NR * 3 * 2
    flops = {"K3a": 2 * per_obs + 18 * P, "K3b": per_obs + 18 * P,
             "K3b onepass": per_obs + 18 * P, "K3c": per_obs}
    out = {}
    for name, (kern, plain) in cases.items():
        got = kern(x)
        ref32 = plain(x)
        torch.cuda.synchronize()
        err = _max_err(got, ref32)
        ratio = max(float(((g.double() - r).abs()
                           / (2e-5 * r.abs() + 1e-6 * s + 1e-30)).max())
                    for g, r, s in zip(got, plain(x64), plain(xabs)))
        scale = max(float(r.abs().max()) for r in ref32)
        print(f"{name}: max |kernel - plain| = {err:.3e} (max |plain| "
              f"{scale:.3e}); error / tolerance (2e-5 |ref| + 1e-6 S vs "
              f"float64) = {ratio:.3f}")
        if not all(bool(torch.isfinite(g).all()) for g in got) \
                or not ratio <= 1.0:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"(T={T}, k={k}, I={I}, Nc={Nc}, P={P})")
        if not timed:
            out[name] = dict(max_abs_err=err)
            continue
        ms = _time_ms(lambda: kern(x))
        plain_ms = _time_ms(lambda: plain(x), reps=5)
        bound_ms, bound_by = _bound(bytes_[name], flops[name])
        print(f"{name} timing (T={T}, k={k}, I={I}, Nc={Nc}, P={P}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bytes_[name] / 1e6:.1f} MB)")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return out


def check_k3_edges(torch, schur_cuda):
    """K3a/b/c against their plain versions at small shapes that together
    reach every variant of K3a and of K3b, at :func:`check_k3`'s
    tolerance."""
    # (T, I, Nc, k, points, observations)
    cases = [(1, 13, 3, 4, 1024, 700),        # one rank, mixed camera slots
             (5, 13, 3, 1, 4096, 15000),      # T not a power of two, k = 1
             (8, 2, 1, 8, 4096, 30000),       # k = 8, few slots: large groups
             (12, 7, 2, 3, 2048, 20000),      # two ranks per warp, odd T / 2
             (16, 13, 3, 8, 4096, 50000),     # T = 16, k = 8
             (20, 13, 3, 4, 2048, 30000),     # T > 16: two passes
             (4, 3000, 2, 4, 4096, 12000),    # tables above shared memory
             (16, 3000, 2, 8, 4096, 50000),
             (20, 3000, 2, 4, 2048, 30000)]
    seen, seen_rhs = set(), set()
    for n, (T, I, Nc, k, P, n_obs) in enumerate(cases):
        variant = schur_cuda.matvec_variant(T, k, I, Nc, P)
        rhs = schur_cuda.rhs_variant(T, k, I, Nc, P)
        seen.add(variant)
        seen_rhs.add(rhs)
        print(f"K3 edge T={T} k={k} I={I} Nc={Nc} P={P} (K3a variant "
              f"{variant}, K3b variant {rhs}):")
        check_k3(torch, schur_cuda, T=T, I=I, Nc=Nc, k=k, P=P, n_obs=n_obs,
                 timed=False, seed=100 + n)
    for name, got, kinds in (("K3a", seen, ("fused1", "fused2", "twopass")),
                             ("K3b", seen_rhs,
                              ("fused1", "fused2", "onepass"))):
        want = {f"{v}/{m}" for v in kinds for m in ("shared", "global")}
        if got != want:
            raise SystemExit(f"{name} variants not reached: "
                             f"{sorted(want - got)}")


# ---------------------------------------------------------------------------
# phase 8: small BA, cuda against cpu
# ---------------------------------------------------------------------------

def small_ba(torch, np, device):
    """Geometric BA on a 5-view synthetic scene through ``ba_solve`` on the
    grid layout (T = 8, chunks of 64): (final cost, points, summary)."""
    from pixsfm_tpu_torch.base.geometry import (exp_quat_np, quat_mul,
                                                quat_normalize)
    from pixsfm_tpu_torch.bundle_adjustment.main import _RESIDUAL_BUILDERS
    from pixsfm_tpu_torch.bundle_adjustment.problem import pack_ba_problem
    from pixsfm_tpu_torch.base.losses import RobustLoss
    from pixsfm_tpu_torch.ops import schur
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=5, n_points=80, noise_px=0.4,
                                   seed=72)
    rng = np.random.default_rng(0)
    for iid in sorted(rec.images)[1:]:
        im = rec.images[iid]
        dq = torch.as_tensor(exp_quat_np(rng.normal(0, 0.003, 3)))
        im.qvec = quat_normalize(quat_mul(dq, torch.as_tensor(
            im.qvec))).numpy()
        im.tvec = im.tvec + rng.normal(0, 0.02, 3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.02, 3)
    packed = pack_ba_problem(rec)
    Np, T = len(packed.point_ids), 8
    order = np.argsort(packed.obs_pt, kind="stable")
    sp = packed.obs_pt[order]
    starts = np.searchsorted(sp, np.arange(Np), side="left")
    slot = sp * T + (np.arange(len(sp)) - starts[sp])
    src = np.zeros(Np * T, np.int64)
    valid = np.zeros(Np * T, bool)
    src[slot], valid[slot] = order, True

    def put(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    obs = schur.BAObservations(
        put(packed.obs_img[src], torch.long),
        put(packed.obs_cam[src], torch.long),
        put(np.arange(Np * T) // T, torch.long),
        (put(packed.obs_xy[src], torch.float32),), put(valid))
    state0 = schur.BAState(*(put(a, torch.float32) for a in (
        packed.qvec, packed.tvec, packed.cams, packed.xyz)))
    build, build_jac = _RESIDUAL_BUILDERS["geometric"]
    st, summ = schur.ba_solve(
        build(packed.cam_model), state0, obs, RobustLoss("trivial"),
        *(put(a) for a in (packed.pose_free, packed.tvec_free,
                           packed.cam_free, packed.point_free)),
        opts=schur.BAOptions(max_iterations=12, obs_chunk=64,
                             linear_solver="cg", obs_grid_T=T),
        residual_jac_fn=build_jac(packed.cam_model))
    return summ["final_cost"], st.xyz.cpu().numpy(), summ


# ---------------------------------------------------------------------------
# phase 9: rendered views of a textured plane for BA
# ---------------------------------------------------------------------------

def _look_at(np, eye, target):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])   # rows: camera axes (world)


def make_ba_scene(torch, np, seed, n_views, n_points, W, H, device,
                  min_track=4, max_track=8, margin=24, noise_px=0.3):
    """A reconstruction of ``n_points`` points on the textured plane z = 0,
    seen by ``n_views`` SIMPLE_RADIAL cameras (1.8-2.4 units away, tilted
    10-35 degrees); each point's track is a random subset of
    ``min_track``-``max_track`` of the views that see it (``margin`` px
    inside the image), its keypoints the true projections plus
    N(0, ``noise_px``). The views are rendered on ``device`` (plane ->
    image homographies of the true poses). Returns (reconstruction with
    perturbed poses and points, {name: [H, W, 3] uint8}, the true
    reconstruction, whose images hold the keypoints)."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.base.geometry import (exp_quat_np, quat_mul,
                                                quat_normalize,
                                                rotmat_to_quat_np)
    from pixsfm_tpu_torch.base.projection import project_np
    from pixsfm_tpu_torch.sfm.model import Image, Point3D, Reconstruction
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    cam = Camera(1, "SIMPLE_RADIAL", W, H, [f, W / 2, H / 2, 0.0])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    poses = []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views + rng.uniform(-0.2, 0.2)
        tilt = rng.uniform(0.17, 0.61)
        target = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                           0.0])
        eye = target + rng.uniform(1.8, 2.4) * np.array(
            [np.sin(tilt) * np.cos(ang), np.sin(tilt) * np.sin(ang),
             np.cos(tilt)])
        R = _look_at(np, eye, target)
        poses.append((R, -R @ eye))

    # texture: 8 plane waves of 20-100 cycles per unit, mixed into RGB
    n_waves = 8
    freq = rng.uniform(20, 100, n_waves) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, n_waves))
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    mix = rng.normal(0, 1, (n_waves, 3))
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))
    dev = torch.device(device)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1)
    fw = torch.as_tensor(np.stack([freq.real, freq.imag], 1), device=dev)
    images = {}
    for v, (R, t) in enumerate(poses):
        Hm = K @ np.stack([R[:, 0], R[:, 1], t], 1)     # plane -> image
        q = pix @ torch.as_tensor(np.linalg.inv(Hm).T, device=dev)
        X = q[..., :2] / q[..., 2:]
        img = torch.full((H, W, 3), 127.5, dtype=torch.float64, device=dev)
        for k in range(n_waves):
            wave = torch.sin(2 * np.pi * (X @ fw[k]) + phase[k])
            img += wave[..., None] * torch.as_tensor(mix[k], device=dev)
        images[f"view{v:03d}.png"] = img.clamp(0, 255).to(torch.uint8) \
            .cpu().numpy()

    # points and tracks
    n_cand = 2 * n_points
    P3 = np.concatenate([rng.uniform(-0.8, 0.8, (n_cand, 2)),
                         np.zeros((n_cand, 1))], 1)
    vis = np.zeros((n_cand, n_views), bool)
    proj = np.zeros((n_cand, n_views, 2))
    for v, (R, t) in enumerate(poses):
        xy, z = project_np(cam, rotmat_to_quat_np(R), t, P3)
        proj[:, v] = xy
        vis[:, v] = (z > 0) & (xy[:, 0] >= margin) & (xy[:, 0] < W - margin) \
            & (xy[:, 1] >= margin) & (xy[:, 1] < H - margin)
    keep = np.nonzero(vis.sum(1) >= min_track)[0][:n_points]
    if len(keep) < n_points:
        raise SystemExit(f"scene: only {len(keep)} points seen by "
                         f"{min_track} views")
    P3, vis, proj = P3[keep], vis[keep], proj[keep]
    L = np.minimum(rng.integers(min_track, max_track + 1, n_points),
                   vis.sum(1))
    keys = np.where(vis, rng.random(vis.shape), np.inf)
    chosen = np.argsort(keys, axis=1)
    in_track = np.zeros_like(vis)
    rows = np.repeat(np.arange(n_points), L)
    cols = chosen[rows, np.concatenate([np.arange(n) for n in L])]
    in_track[rows, cols] = True

    truth = Reconstruction()
    truth.add_camera(cam)
    tracks = [[] for _ in range(n_points)]
    for v, (R, t) in enumerate(poses):
        pts = np.nonzero(in_track[:, v])[0]
        xy = proj[pts, v] + rng.normal(0, noise_px, (len(pts), 2))
        for j, p in enumerate(pts):
            tracks[p].append((v + 1, j))
        truth.add_image(Image(v + 1, f"view{v:03d}.png", 1,
                              rotmat_to_quat_np(R), t, xy, pts))
    for p in range(n_points):
        truth.add_point3D(Point3D(p, P3[p], track=tracks[p]))
    rec = truth.copy()
    for iid in sorted(rec.images)[1:]:
        im = rec.images[iid]
        dq = torch.as_tensor(exp_quat_np(rng.normal(0, 3e-4, 3)))
        im.qvec = quat_normalize(quat_mul(dq, torch.as_tensor(
            im.qvec))).numpy()
        im.tvec = im.tvec + rng.normal(0, 1e-3, 3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 1e-3, 3)
    return rec, images, truth


def point_error(np, rec, truth):
    return float(np.mean([np.linalg.norm(rec.points3D[p].xyz - q.xyz)
                          for p, q in truth.points3D.items()]))


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


def _in_situ(kern, tags, launched):
    """Device ms per launch inside a profiled stage, per kernel id: every
    profiled kernel whose name contains the id's tag (the variants of one
    kernel share it). A kernel that ``launched`` on the main path and shows
    no launch in the profile fails the run."""
    out = {}
    for key, tag in tags.items():
        hits = [(c, ms) for n, c, ms in kern if tag in n]
        calls = sum(c for c, _ in hits)
        if calls:
            out[key] = sum(ms for _, ms in hits) / calls
        elif launched.get(key, 0) > 0:
            raise SystemExit(f"{key} launched on the main path but the "
                             f"profile shows no kernel named *{tag}*")
    return out


def _took_variant(kern, key, want, other):
    """Fail unless a profiled stage launched kernel ``want`` and never
    ``other`` (two variants of kernel ``key``)."""
    names = {n for n, _, _ in kern}
    if not any(want in n for n in names) or any(other in n for n in names):
        raise SystemExit(f"{key}: the main path did not take {want} alone")
    print(f"{key}: the main path launched {want} only")


# ---------------------------------------------------------------------------
# phases 11-13: the triangulation main path, the dense step, the database KA
# ---------------------------------------------------------------------------

def triangulation_inputs(np, truth):
    """What an hloc user hands ``PixSfM.triangulation``, from a scene of
    :func:`make_ba_scene`: keypoints per view (its images' ``xys``),
    matches over every view pair within each track (score 1) and the
    reference model (the true poses and intrinsics, no points)."""
    from pixsfm_tpu_torch.sfm.model import Image, Reconstruction
    keypoints = {im.name: im.xys.copy() for im in truth.images.values()}
    n_pts = len(truth.points3D)
    kp_of = {}                        # view name -> keypoint index per point
    for im in truth.images.values():
        idx = np.full(n_pts, -1)
        idx[im.point3D_ids] = np.arange(len(im.point3D_ids))
        kp_of[im.name] = idx
    names = sorted(kp_of)
    matches, scores = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            both = (kp_of[a] >= 0) & (kp_of[b] >= 0)
            if both.any():
                matches[(a, b)] = np.stack([kp_of[a][both], kp_of[b][both]],
                                           1)
                scores[(a, b)] = np.ones(int(both.sum()))
    reference = Reconstruction()
    for cam in truth.cameras.values():
        reference.add_camera(cam)
    for im in truth.images.values():
        reference.add_image(Image(im.image_id, im.name, im.camera_id,
                                  im.qvec.copy(), im.tvec.copy()))
    return keypoints, matches, scores, reference


def triangulated_error(np, rec, truth):
    """Mean distance of triangulated points to the true points they track
    (a track's first observation names its true point)."""
    errs = []
    for p in rec.points3D.values():
        iid, k = p.track[0]
        true_id = int(truth.images[iid].point3D_ids[k])
        errs.append(np.linalg.norm(p.xyz - truth.points3D[true_id].xyz))
    return float(np.mean(errs))


def dlt_stack(torch, np, truth):
    """The DLT constraint stack ``[tracks, 2 T, 4]`` (``T`` the longest
    track, zero rows past a track's end) of the keypoints of a scene of
    :func:`make_ba_scene` (SIMPLE_RADIAL with k = 0: undistortion is the
    identity), on the card: what ``triangulate_batch`` gets on the
    triangulation path."""
    f, cx, cy, _ = truth.cameras[1].params
    P = {iid: np.hstack([im.rotation_matrix(), im.tvec[:, None]])
         for iid, im in truth.images.items()}
    tracks = [p.track for p in truth.points3D.values()]
    T = max(len(t) for t in tracks)
    A = np.zeros((len(tracks), T, 2, 4))
    for i, track in enumerate(tracks):
        for k, (iid, j) in enumerate(track):
            u, v = (truth.images[iid].xys[j] - [cx, cy]) / f
            A[i, k] = [u * P[iid][2] - P[iid][0], v * P[iid][2] - P[iid][1]]
    return torch.as_tensor(A.reshape(len(tracks), 2 * T, 4),
                           dtype=torch.float32, device="cuda")


def dense_ba(torch, np, rec, views, device, tmp):
    """``refine_reconstruction`` (the ``bundle_adjuster`` command's function)
    of ``rec`` written to ``tmp`` on ``device`` with the geometric strategy:
    (summary of the one level, points, wall s). Geometric, because the
    featuremetric cost on S2DNet's random features has near-equal minima:
    two runs whose starts differ by 1e-6 end further apart than phase 8's
    limits, so a CUDA/CPU comparison there would test the landscape, not
    the step."""
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    src = Path(tmp) / "dense_in"
    rec.write(src)
    sfm = PixSfM({"mapping": {"BA": {
        "strategy": "geometric",
        "optimizer": {"solver": {"max_num_iterations": BA_ITERATIONS}}}}},
        device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_rec, out = sfm.refine_reconstruction(Path(tmp) / f"dense_{device}",
                                             src, views)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xyz = np.stack([out_rec.points3D[p].xyz for p in sorted(out_rec.points3D)])
    return {k: v[0] for k, v in out.items()}, xyz, wall


def mixed_models(rec):
    """``rec`` with its odd images moved to a PINHOLE camera of the same
    intrinsics (the scene's SIMPLE_RADIAL camera has k = 0, so the views
    and keypoints stay exact): two camera models in one BA."""
    from pixsfm_tpu_torch.base.cameras import Camera
    out = rec.copy()
    cam = out.cameras[1]
    f, cx, cy, _ = cam.params
    out.add_camera(Camera(2, "PINHOLE", cam.width, cam.height,
                          [f, f, cx, cy]))
    for iid, im in out.images.items():
        if iid % 2:
            im.camera_id = 2
    return out


def write_database(np, path, keypoints, matches, W, H):
    """A COLMAP database of ``keypoints`` (float32, as COLMAP stores them)
    and ``matches``, written with the port's ``COLMAPDatabase``."""
    from contextlib import closing
    from pixsfm_tpu_torch.util.database import COLMAPDatabase
    with closing(COLMAPDatabase.connect(path)) as db:
        db.create_tables()
        cam = db.add_camera(2, W, H, [1.2 * W, W / 2, H / 2, 0.0])
        ids = {name: db.add_image(name, cam) for name in keypoints}
        for name, kps in keypoints.items():
            db.add_keypoints(ids[name], kps)
        for (a, b), m in matches.items():
            db.add_matches(ids[a], ids[b], m)
        db.commit()


# ---------------------------------------------------------------------------
# phases 14-17: PnP, the incremental mapper, the reconstruction path, dsift
# ---------------------------------------------------------------------------

def _rot(np, phi):
    th = max(float(np.linalg.norm(phi)), 1e-300)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pnp_queries(np, seed, n_queries, n=None):
    """PnP queries of 30-2000 correspondences (log-uniform; ``n`` each when
    given): half of them on a plane, 0-60 % outliers, SIMPLE_RADIAL and
    PINHOLE cameras in turn, keypoints the true projections plus
    N(0, 0.5 px)."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.localization.pnp import (_rotmat_to_quat_np,
                                                   project_np)
    rng = np.random.default_rng(seed)
    queries = []
    for i in range(n_queries):
        n_i = int(np.exp(rng.uniform(np.log(30), np.log(2000))))
        n_i = n_i if n is None else n
        W, H = 1600, 1200
        cam = (Camera(1, "SIMPLE_RADIAL", W, H, [1700.0, W / 2, H / 2, 0.02])
               if i % 2 else Camera(1, "PINHOLE", W, H,
                                    [1650.0, 1700.0, W / 2, H / 2]))
        X = np.stack([rng.uniform(-2.5, 2.5, n_i), rng.uniform(-2, 2, n_i),
                      rng.uniform(-1.5, 1.5, n_i)], 1)
        if i % 4 < 2:
            X[:, 2] = 0.3 * X[:, 0] - 0.1 * X[:, 1]
        R = _rot(np, rng.normal(0, 0.3, 3))
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), 8.0])
        xy, _ = project_np(cam, _rotmat_to_quat_np(R), t, X)
        xy = xy + rng.normal(0, 0.5, xy.shape)
        k = int(rng.uniform(0, 0.6) * n_i)
        xy[:k] = rng.uniform(0, [W, H], (k, 2))
        queries.append(dict(points2D=xy, points3D=X, camera=cam))
    return queries


def pose_agreement(np, a, b, X):
    """(rotation angle between two PnP results, translation difference
    relative to max(|t|, median distance of the points to the camera))."""
    from pixsfm_tpu_torch.localization.pnp import _quat_to_rotmat_np
    dot = abs(float(np.dot(a["qvec"], b["qvec"])))
    ang = 2 * np.arccos(min(dot, 1.0))
    C = -_quat_to_rotmat_np(b["qvec"]).T @ b["tvec"]
    scale = max(np.linalg.norm(b["tvec"]),
                float(np.median(np.linalg.norm(X - C, axis=1))))
    return ang, float(np.linalg.norm(a["tvec"] - b["tvec"]) / scale)


def unexplained(np, a, b, q, max_error_px=12.0):
    """How many of result ``b``'s inliers the pose of result ``a`` leaves
    above the inlier threshold."""
    from pixsfm_tpu_torch.localization.pnp import _reproj_errors
    err = _reproj_errors(q["camera"], a["qvec"], a["tvec"], q["points3D"],
                         q["points2D"])
    return int((b["inliers"] & ~(err < max_error_px)).sum())


def ring_scene(np, n_views=12, n_points=300, W=1024, H=768, seed=42):
    """The ring of ``tests/test_mapper_scale.py`` at ``n_views`` views and
    ``n_points`` points: SIMPLE_RADIAL f = 1000, k = 0.02, keypoints with
    N(0, 0.3 px) noise, exhaustive matches of score 1. Returns (graph,
    keypoints, {name: blank image} for the image sizes)."""
    from pixsfm_tpu_torch.base.graph import Graph
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n_points, 3))
    xyz[:, 2] *= 0.6
    names = [f"im{i:02d}.png" for i in range(n_views)]
    keypoints, kp_of = {}, {}
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n_views, endpoint=False)):
        c = np.array([3.5 * np.cos(a), 0.5 * np.sin(2 * a), 3.5 * np.sin(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        xc = (xyz - c) @ R.T
        uv = xc[:, :2] / xc[:, 2:]
        xy = 1000.0 * uv * (1 + 0.02 * (uv ** 2).sum(1))[:, None] \
            + [W / 2, H / 2]
        vis = (xc[:, 2] > 0.5) & (xy > 10).all(1) & (xy < [W - 10, H - 10]
                                                      ).all(1)
        idx = np.nonzero(vis)[0]
        keypoints[names[i]] = xy[idx] + rng.normal(0, 0.3, (len(idx), 2))
        kp_of[names[i]] = {int(p): j for j, p in enumerate(idx)}
    graph = Graph()
    for a in range(n_views):
        for b in range(a + 1, n_views):
            na, nb = names[a], names[b]
            shared = sorted(set(kp_of[na]) & set(kp_of[nb]))
            if len(shared) >= 30:
                m = np.asarray([[kp_of[na][p], kp_of[nb][p]] for p in shared])
                graph.register_matches(na, nb, m, np.ones(len(m)))
    sizes = {n: np.zeros((H, W, 3), np.uint8) for n in names}
    return graph, keypoints, sizes


def aligned_errors(np, rec, ref, ids=None):
    """Rotation errors (degrees) and camera-centre errors (fractions of the
    extent of ``ref``'s centres) of ``rec``'s images ``ids`` after the
    similarity (Umeyama) that maps their centres onto ``ref``'s."""
    ids = sorted(ids if ids is not None else
                 (i for i, im in rec.images.items() if im.registered))
    C = [np.stack([r.images[i].projection_center() for i in ids])
         for r in (rec, ref)]
    ma, mb = C[0].mean(0), C[1].mean(0)
    U, S, Vt = np.linalg.svd((C[1] - mb).T @ (C[0] - ma) / len(ids))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((C[0] - ma) ** 2).sum(1).mean()
    t = mb - s * R @ ma
    ext = np.linalg.norm(C[1] - mb, axis=1).max()
    rot = [np.degrees(np.arccos(np.clip((np.trace(
        ref.images[i].rotation_matrix()
        @ (rec.images[i].rotation_matrix() @ R.T).T) - 1) / 2, -1, 1)))
        for i in ids]
    cen = np.linalg.norm((s * C[0] @ R.T + t) - C[1], axis=1) / ext
    return np.asarray(rot), cen


FOLD_SLOPE = 0.5


def make_fold_scene(torch, np, seed, n_views, n_points, W, H, device,
                    min_track=3, max_track=8, margin=24, noise_px=0.5):
    """A non-planar scene: the valley z = -FOLD_SLOPE |x| (two planes meeting
    at x = 0), textured by 3-D position (8 plane waves of 20-100 cycles per
    unit), seen by ``n_views`` SIMPLE_RADIAL cameras of focal W (1.8-2.4
    units away on a ring, tilted 10-35 degrees). The views are ray-cast on
    ``device``; each point's track is a random subset of ``min_track``-
    ``max_track`` of the views that see it unoccluded (``margin`` px inside
    the image), its keypoints the true projections plus N(0, ``noise_px``).
    Returns ({name: [H, W, 3] uint8}, the true reconstruction, whose images
    hold the keypoints)."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.base.geometry import rotmat_to_quat_np
    from pixsfm_tpu_torch.base.projection import project_np
    from pixsfm_tpu_torch.sfm.model import Image, Point3D, Reconstruction
    rng = np.random.default_rng(seed)
    f = float(W)
    cam = Camera(1, "SIMPLE_RADIAL", W, H, [f, W / 2, H / 2, 0.0])
    poses = []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views + rng.uniform(-0.2, 0.2)
        tilt = rng.uniform(0.17, 0.61)
        target = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                           -0.2])
        eye = target + rng.uniform(1.8, 2.4) * np.array(
            [np.sin(tilt) * np.cos(ang), np.sin(tilt) * np.sin(ang),
             np.cos(tilt)])
        R = _look_at(np, eye, target)
        poses.append((R, -R @ eye))

    n_waves = 8
    kdir = rng.normal(0, 1, (n_waves, 3))
    kvec = kdir / np.linalg.norm(kdir, axis=1, keepdims=True) \
        * rng.uniform(20, 100, (n_waves, 1))
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    mix = rng.normal(0, 1, (n_waves, 3))
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))
    dev = torch.device(device)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    d_cam = torch.stack([(xs + 0.5 - W / 2) / f, (ys + 0.5 - H / 2) / f,
                         torch.ones_like(xs)], -1)
    kv = torch.as_tensor(kvec, device=dev)
    images = {}
    for v, (R, t) in enumerate(poses):
        d = d_cam @ torch.as_tensor(R, device=dev)     # world rays R^T d_cam
        C = torch.as_tensor(-R.T @ t, device=dev)
        best = torch.full((H, W), float("inf"), dtype=torch.float64,
                          device=dev)
        P = torch.zeros((H, W, 3), dtype=torch.float64, device=dev)
        for sgn in (-1.0, 1.0):                 # planes z + slope sgn x = 0
            n = torch.tensor([FOLD_SLOPE * sgn, 0.0, 1.0], dtype=torch.float64,
                             device=dev)
            s = -(C @ n) / (d @ n)
            p = C + s[..., None] * d
            ok = (s > 0) & (sgn * p[..., 0] >= 0) & (s < best)
            best = torch.where(ok, s, best)
            P = torch.where(ok[..., None], p, P)
        img = torch.full((H, W, 3), 127.5, dtype=torch.float64, device=dev)
        for k in range(n_waves):
            wave = torch.sin(2 * np.pi * (P @ kv[k]) + phase[k])
            img += wave[..., None] * torch.as_tensor(mix[k], device=dev)
        images[f"view{v:03d}.png"] = img.clamp(0, 255).to(torch.uint8) \
            .cpu().numpy()

    n_cand = 3 * n_points
    x = rng.uniform(-0.8, 0.8, n_cand)
    P3 = np.stack([x, rng.uniform(-0.8, 0.8, n_cand),
                   -FOLD_SLOPE * np.abs(x)], 1)
    vis = np.zeros((n_cand, n_views), bool)
    proj = np.zeros((n_cand, n_views, 2))
    for v, (R, t) in enumerate(poses):
        xy, z = project_np(cam, rotmat_to_quat_np(R), t, P3)
        # occluded when the segment camera -> point meets the other plane
        C = -R.T @ t
        seg = P3 - C
        sgn = -np.sign(P3[:, 0])
        n = np.stack([FOLD_SLOPE * sgn, np.zeros(n_cand), np.ones(n_cand)], 1)
        den = (seg * n).sum(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = -(n @ C) / den
        hit = C + s[:, None] * seg
        occl = (s > 0) & (s < 1 - 1e-9) & (sgn * hit[:, 0] >= 0)
        proj[:, v] = xy
        vis[:, v] = (z > 0) & ~occl & (xy[:, 0] >= margin) \
            & (xy[:, 0] < W - margin) & (xy[:, 1] >= margin) \
            & (xy[:, 1] < H - margin)
    keep = np.nonzero(vis.sum(1) >= min_track)[0][:n_points]
    if len(keep) < n_points:
        raise SystemExit(f"fold scene: only {len(keep)} points seen by "
                         f"{min_track} views")
    P3, vis, proj = P3[keep], vis[keep], proj[keep]
    L = np.minimum(rng.integers(min_track, max_track + 1, n_points),
                   vis.sum(1))
    keys = np.where(vis, rng.random(vis.shape), np.inf)
    chosen = np.argsort(keys, axis=1)
    in_track = np.zeros_like(vis)
    rows = np.repeat(np.arange(n_points), L)
    in_track[rows, chosen[rows, np.concatenate([np.arange(k) for k in L])]] \
        = True
    truth = Reconstruction()
    truth.add_camera(cam)
    tracks = [[] for _ in range(n_points)]
    for v, (R, t) in enumerate(poses):
        pts = np.nonzero(in_track[:, v])[0]
        xy = proj[pts, v] + rng.normal(0, noise_px, (len(pts), 2))
        for j, p in enumerate(pts):
            tracks[p].append((v + 1, j))
        truth.add_image(Image(v + 1, f"view{v:03d}.png", 1,
                              rotmat_to_quat_np(R), t, xy, pts))
    for p in range(n_points):
        truth.add_point3D(Point3D(p, P3[p], track=tracks[p]))
    return images, truth


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
    from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda, schur_cuda
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
                  n_queries=P * K, dtypes=(torch.float32, torch.bfloat16))
    k1["edge_max_abs_err"] = check_k1_edges(torch, interpolate_cuda)
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
    in_situ_ka = _in_situ(kern_ka, {"K1": "interp_kernel",
                                    "K2": "pcg_kernel"}, launches)
    _took_variant(kern_ka, "K2", "pcg_kernel_register", "pcg_kernel_general")
    print(f"phase 6: in-situ device ms per launch {in_situ_ka}")
    if args.profile_out:
        out_dir = Path(args.profile_out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke_profile.txt").write_text(
            f"{smi}\n\n== extraction ==\n{tab_ext}\n\n== KA ==\n"
            f"{tab_ka}\n")

    # -- phase 7: K3a/b/c against their plain versions -----------------------
    # the BA main path's shape: 56 views, one SIMPLE_RADIAL camera, T = 8,
    # 40 000 points padded to 65 536, ~240 000 observations
    n_views, n_pts = 56, 40000
    k3 = check_k3(torch, schur_cuda, T=8, I=n_views, Nc=1, k=4, P=65536,
                  n_obs=240000)
    variant = schur_cuda.matvec_variant(8, 4, n_views, 1, 65536)
    rhs_variant = schur_cuda.rhs_variant(8, 4, n_views, 1, 65536)
    print(f"K3a / K3b variants at the BA path's shape: {variant} / "
          f"{rhs_variant}")
    if variant != "fused1/shared" or rhs_variant != "fused1/shared":
        raise SystemExit("K3a or K3b did not take its fused variant at the "
                         "BA path's shape")
    onepass = k3.pop("K3b onepass")
    k3["K3b"].update(variant=rhs_variant, onepass_ms=onepass["ms"])
    check_k3_edges(torch, schur_cuda)
    # K1 at the BA path's shape: one chunk of 8192 observations over one
    # bf16 patch per observation (~240 000)
    k1_ba = check_k1(torch, interpolate_cuda, n_patches=240000,
                     n_queries=8192, dtypes=(torch.bfloat16,))
    torch.cuda.empty_cache()

    # -- phase 8: small BA on the grid layout, cuda against cpu ----------------
    c_dev, x_dev, s_dev = small_ba(torch, np, "cuda")
    c_cpu, x_cpu, s_cpu = small_ba(torch, np, "cpu")
    dx = float(np.abs(x_dev - x_cpu).max())
    print(f"phase 8: small BA (grid layout, {s_dev['iterations']} LM / "
          f"{s_dev['cg_iterations']} CG iterations on cuda, "
          f"{s_cpu['cg_iterations']} CG on cpu): cost cuda {c_dev:.6f} / cpu "
          f"{c_cpu:.6f}, max |xyz(cuda) - xyz(cpu)| = {dx:.2e} (limits: cost "
          f"rtol 1e-4, xyz 1e-3)")
    if not (abs(c_dev - c_cpu) <= 1e-4 * abs(c_cpu) and dx <= 1e-3):
        raise SystemExit("cuda and cpu BA disagree on the small scene")

    # -- phase 9: the BA main path at full size --------------------------------
    t0 = time.perf_counter()
    rec, views, truth = make_ba_scene(torch, np, seed=11, n_views=n_views,
                                      n_points=n_pts, W=1600, H=1200,
                                      device="cuda")
    n_obs = sum(p.track_length for p in rec.points3D.values())
    print(f"phase 9: scene of {len(views)} views, {len(rec.points3D)} "
          f"points, {n_obs} observations made in "
          f"{time.perf_counter() - t0:.1f} s")
    rec_profile = rec.copy()
    ba_conf = {"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_ITERATIONS}}}}}
    sfm_ba = PixSfM(ba_conf, device="cuda")
    err0 = point_error(np, rec, truth)
    reproj0 = rec.mean_reprojection_error()
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    t0 = time.perf_counter()
    out_ba = sfm_ba.run_ba(rec, views)
    torch.cuda.synchronize()
    wall_ba = time.perf_counter() - t0
    launches_ba = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                   "K3a": schur_cuda.launches["matvec"],
                   "K3b": schur_cuda.launches["rhs"],
                   "K3c": schur_cuda.launches["backsub"]}
    ob = {k: v[0] for k, v in out_ba.items()}
    t_solve, t_refs = ob["time"], ob["references_time"]
    err1 = point_error(np, rec, truth)
    reproj1 = rec.mean_reprojection_error()
    print(f"phase 9: run_ba {wall_ba:.2f} s (extraction + packing "
          f"{wall_ba - t_refs - t_solve:.2f} s, references {t_refs:.2f} s, "
          f"BA solve {t_solve:.2f} s), grid T {ob['obs_grid_T']}, LM "
          f"iterations {ob['iterations']}, CG iterations "
          f"{ob['cg_iterations']}, cost {ob['initial_cost']:.4f} -> "
          f"{ob['final_cost']:.4f}, point error to truth {err0:.5f} -> "
          f"{err1:.5f}, reprojection error {reproj0:.3f} -> {reproj1:.3f} "
          f"px, launches {launches_ba}")
    finite = all(np.isfinite(im.qvec).all() and np.isfinite(im.tvec).all()
                 for im in rec.images.values()) and all(
        np.isfinite(p.xyz).all() for p in rec.points3D.values())
    if not finite:
        raise SystemExit("non-finite poses or points after BA")
    if ob["obs_grid_T"] != 8:
        raise SystemExit(f"the grid regime was not chosen: {ob}")
    if not ob["final_cost"] < ob["initial_cost"]:
        raise SystemExit("BA cost did not fall")
    if min(launches_ba[k] for k in ("K1", "K3a", "K3b", "K3c")) <= 0:
        raise SystemExit(f"a kernel did not launch on the BA main path: "
                         f"{launches_ba}")

    # -- phase 10: where the BA time goes (a second run, not counted) ---------
    from pixsfm_tpu_torch.extract import features_from_reconstruction
    sfm_prof = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}, device="cuda")
    fm_ba, t_exb, busy_exb, kern_exb, tab_exb = profile_stage(
        torch, lambda: features_from_reconstruction(sfm_prof.extractor,
                                                    rec_profile, views))
    out_p, t_bap, busy_bap, kern_bap, tab_bap = profile_stage(
        torch, lambda: sfm_prof.bundle_adjuster.refine_multilevel(
            rec_profile, fm_ba))
    del fm_ba
    print(f"phase 10 (under the profiler): extraction {t_exb:.3f} s wall, "
          f"{busy_exb:.3f} s device busy; references + BA "
          f"({BA_PROFILE_ITERATIONS} LM iterations, "
          f"{out_p['cg_iterations'][0]} CG iterations) {t_bap:.3f} s wall, "
          f"{busy_bap:.3f} s device busy (idle share "
          f"{1 - busy_bap / t_bap:.2f}); references "
          f"{out_p['references_time'][0]:.3f} s, BA solve "
          f"{out_p['time'][0]:.3f} s")
    for stage, kern in (("extraction", kern_exb), ("BA", kern_bap)):
        for name, calls, dev_ms in kern[:8]:
            print(f"  {stage}: {dev_ms:9.3f} ms in {calls:6d} launches  "
                  f"{name[:90]}")
    in_situ = _in_situ(kern_bap, {"K3a": "matvec_kernel",
                                  "K3b": "rhs_kernel",
                                  "K3c": "backsub_kernel",
                                  "K1": "interp_kernel"}, launches_ba)
    print(f"phase 10: in-situ device ms per launch {in_situ}")
    _took_variant(kern_bap, "K3b", "rhs_kernel_fused", "rhs_kernel_onepass")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            fh.write(f"\n\n== BA extraction ==\n{tab_exb}\n\n== BA "
                     f"references + solve ({BA_PROFILE_ITERATIONS} LM "
                     f"iterations) ==\n{tab_bap}\n")

    # -- phase 11: the triangulation main path at full width -----------------
    # phase 9's views and patches go first (~16 GB)
    del rec, views, truth, rec_profile, sfm_ba, sfm_prof
    torch.cuda.empty_cache()
    import tempfile
    from pixsfm_tpu_torch.keypoint_adjustment import build_matching_graph
    from pixsfm_tpu_torch.ops.schur import BAOptions
    from pixsfm_tpu_torch.sfm.model import Reconstruction
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_reconstruction
    from pixsfm_tpu_torch.util.misc import bucket
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    t0 = time.perf_counter()
    n_tri_pts = 8000
    _, views_t, truth_t = make_ba_scene(
        torch, np, seed=5, n_views=24, n_points=n_tri_pts, W=1600, H=1200,
        device="cuda", min_track=3, max_track=8, noise_px=1.0)
    kps_t, matches_t, scores_t, reference = triangulation_inputs(np, truth_t)
    reference.write(tmp / "reference")
    reference = Reconstruction.read(tmp / "reference")
    print(f"phase 11: scene of {len(views_t)} views, {n_tri_pts} points, "
          f"{sum(len(v) for v in kps_t.values())} keypoints, "
          f"{len(matches_t)} pairs made in {time.perf_counter() - t0:.1f} s")
    # the points the unrefined keypoints give (no kernel: not counted)
    rec_raw = triangulate_reconstruction(
        reference, build_matching_graph(matches_t, scores_t),
        {k: v.copy() for k, v in kps_t.items()}, device="cuda")
    err_raw = triangulated_error(np, rec_raw, truth_t)
    tri_conf = {"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_ITERATIONS}}}}}
    sfm_tri = PixSfM(tri_conf, device="cuda")
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    t0 = time.perf_counter()
    rec_t, out_t = sfm_tri._triangulation(
        tmp / "triangulated", reference, views_t,
        {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    launches_tri = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                    "K3a": schur_cuda.launches["matvec"],
                    "K3b": schur_cuda.launches["rhs"],
                    "K3c": schur_cuda.launches["backsub"]}
    oka = {k: v[0] for k, v in out_t["KA"].items()}
    oba = {k: v[0] for k, v in out_t["BA"].items()}
    t_tri = out_t["triangulation"]["time"]
    n_tri = len(rec_t.points3D)
    survived = n_tri / n_tri_pts
    track_lens = np.array([p.track_length for p in rec_t.points3D.values()])
    n_obs_t = int(track_lens.sum())
    n_pairs = int((track_lens ** 2).sum())
    np_pad_chunk = bucket(n_tri, minimum=4) * BAOptions().obs_chunk
    err_tri = triangulated_error(np, rec_t, truth_t)
    t_rest = wall_t - oka["time"] - t_tri - oba["references_time"] \
        - oba["time"]
    print(f"phase 11: triangulation path {wall_t:.2f} s (graph, extraction "
          f"and packing {t_rest:.2f} s, KA {oka['time']:.2f} s, "
          f"triangulation {t_tri:.2f} s, references "
          f"{oba['references_time']:.2f} s, BA solve {oba['time']:.2f} s); "
          f"KA {oka['iterations']} LM iterations, cost "
          f"{oka['initial_cost']:.4f} -> {oka['final_cost']:.4f}; "
          f"{n_tri} / {n_tri_pts} tracks triangulated ({survived:.4f}), "
          f"{n_obs_t} observations; BA regime {oba['linear_solver']} with "
          f"grid T {oba['obs_grid_T']} ({n_pairs} track pairs, Np_pad * "
          f"obs_chunk = {np_pad_chunk}), {oba['iterations']} LM / "
          f"{oba['cg_iterations']} CG iterations, cost "
          f"{oba['initial_cost']:.4f} -> {oba['final_cost']:.4f}; point "
          f"error to truth {err_raw:.5f} (unrefined keypoints) -> "
          f"{err_tri:.5f} (after KA and BA); launches {launches_tri}")
    if not all(np.isfinite(p.xyz).all() for p in rec_t.points3D.values()):
        raise SystemExit("non-finite points after the triangulation path")
    if not (oba["linear_solver"] == "cg" and oba["obs_grid_T"] == 0
            and n_pairs > 20_000 and np_pad_chunk <= 1 << 28):
        raise SystemExit("the triangulation path's BA did not take the flat "
                         "CG layout")
    if not oba["final_cost"] < oba["initial_cost"]:
        raise SystemExit("BA cost did not fall on the triangulation path")
    if not survived >= TRI_MIN_SURVIVING:
        raise SystemExit(f"only {survived:.4f} of the tracks survived "
                         f"triangulation (limit {TRI_MIN_SURVIVING})")
    if min(launches_tri["K1"], launches_tri["K2"]) <= 0:
        raise SystemExit(f"K1 or K2 did not launch on the triangulation "
                         f"path: {launches_tri}")
    # where the time goes: the path again under the profiler, BA capped at
    # BA_PROFILE_ITERATIONS (a second run, not counted)
    sfm_tri_prof = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}, device="cuda")
    (_, out_p), t_trp, busy_trp, kern_trp, tab_trp = profile_stage(
        torch, lambda: sfm_tri_prof._triangulation(
            tmp / "triangulated_profile", reference, views_t,
            {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t))
    print(f"phase 11 (under the profiler, {BA_PROFILE_ITERATIONS} BA "
          f"iterations): {t_trp:.3f} s wall, {busy_trp:.3f} s device busy "
          f"(idle share {1 - busy_trp / t_trp:.2f}); KA "
          f"{out_p['KA']['time'][0]:.3f} s, triangulation "
          f"{out_p['triangulation']['time']:.3f} s, references "
          f"{out_p['BA']['references_time'][0]:.3f} s, BA solve "
          f"{out_p['BA']['time'][0]:.3f} s")
    for name, calls, dev_ms in kern_trp[:10]:
        print(f"  triangulation path: {dev_ms:9.3f} ms in {calls:6d} "
              f"launches  {name[:90]}")
    in_situ_tri = _in_situ(kern_trp, {"K1": "interp_kernel",
                                      "K2": "pcg_kernel"}, launches_tri)
    print(f"phase 11: in-situ device ms per launch {in_situ_tri}")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            fh.write(f"\n\n== triangulation path ({BA_PROFILE_ITERATIONS} "
                     f"BA iterations) ==\n{tab_trp}\n")
    # the triangulation stage's parts: the track labels (host union-find)
    # and the batched DLT on the card (CUDA events), against the CPU
    from pixsfm_tpu_torch.base.graph import compute_track_labels
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_batch
    graph_t = build_matching_graph(matches_t, scores_t)
    t0 = time.perf_counter()
    compute_track_labels(graph_t)
    t_labels = time.perf_counter() - t0
    A_t = dlt_stack(torch, np, truth_t)
    svd_ms = _time_ms(lambda: triangulate_batch(A_t), reps=5, warmup=1)
    dlt_diff = float((triangulate_batch(A_t).cpu()
                      - triangulate_batch(A_t.cpu())).abs().max())
    print(f"phase 11: triangulation stage parts: track labels (host) "
          f"{t_labels:.3f} s; batched DLT on [{A_t.shape[0]}, "
          f"{A_t.shape[1]}, 4] {svd_ms:.3f} ms on the card, max |X(cuda) - "
          f"X(cpu)| = {dlt_diff:.2e} (scene units)")
    if not dlt_diff <= 1e-4:
        raise SystemExit("the batched DLT disagrees between cuda and cpu")
    del rec_raw, rec_t, A_t
    torch.cuda.empty_cache()
    # K1 at the triangulation path's BA shape: one chunk of 8192
    # observations over one bf16 patch per observation
    k1_tri = check_k1(torch, interpolate_cuda, n_patches=n_obs_t,
                      n_queries=8192, dtypes=(torch.bfloat16,))

    # -- phase 12: the dense step, cuda against cpu ----------------------------
    rec_d, views_d, _ = make_ba_scene(torch, np, seed=13, n_views=12,
                                      n_points=1500, W=640, H=480,
                                      device="cuda", min_track=3,
                                      max_track=3)
    for label, rec_in in (("one model", rec_d),
                          ("mixed models", mixed_models(rec_d))):
        o_dev, x_dev, w_dev = dense_ba(torch, np, rec_in, views_d, "cuda",
                                       tmp)
        o_cpu, x_cpu, w_cpu = dense_ba(torch, np, rec_in, views_d, "cpu",
                                       tmp)
        dx = float(np.abs(x_dev - x_cpu).max())
        n_models = len({c.model for c in rec_in.cameras.values()})
        print(f"phase 12: dense step, {label} ({n_models}), "
              f"{len(rec_in.images)} views, {len(rec_in.points3D)} points: "
              f"regime {o_dev['linear_solver']} / {o_cpu['linear_solver']}, "
              f"{o_dev['iterations']} LM iterations, cost cuda "
              f"{o_dev['initial_cost']:.6f} -> {o_dev['final_cost']:.6f} / "
              f"cpu {o_cpu['final_cost']:.6f}, max |xyz(cuda) - xyz(cpu)| = "
              f"{dx:.2e} (limits: cost rtol 1e-4, xyz 1e-3); "
              f"refine_reconstruction {w_dev:.2f} s on cuda (BA solve "
              f"{o_dev['time']:.3f} s), {w_cpu:.2f} s on cpu (BA solve "
              f"{o_cpu['time']:.3f} s)")
        if not (o_dev["linear_solver"] == o_cpu["linear_solver"] == "dense"):
            raise SystemExit("the small scene did not take the dense step")
        if not (abs(o_dev["final_cost"] - o_cpu["final_cost"])
                <= 1e-4 * abs(o_cpu["final_cost"]) and dx <= 1e-3):
            raise SystemExit(f"cuda and cpu dense BA disagree ({label})")
        if not o_dev["final_cost"] < o_dev["initial_cost"]:
            raise SystemExit(f"dense BA cost did not fall ({label})")
    del views_d

    # -- phase 13: keypoint_adjuster on a COLMAP database ----------------------
    import PIL.Image
    from pixsfm_tpu_torch import refine_colmap
    from pixsfm_tpu_torch.util.colmap import read_keypoints_from_db
    (tmp / "images").mkdir()
    for name, img in images.items():
        PIL.Image.fromarray(img).save(tmp / "images" / name)
    kp32 = {n: v.astype(np.float32) for n, v in kp0.items()}
    write_database(np, tmp / "db.db", kp32, matches, W=1600, H=1200)
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    t0 = time.perf_counter()
    refine_colmap.main(["keypoint_adjuster", "--database_path",
                        str(tmp / "db.db"), "--output_path",
                        str(tmp / "db_out.db"), "--image_dir",
                        str(tmp / "images")])
    wall_db = time.perf_counter() - t0
    launches_db = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches}
    kp_db = read_keypoints_from_db(tmp / "db_out.db")
    kp_ref, _ = sfm.run_ka({n: v.astype(np.float64) for n, v in kp32.items()},
                           images, matches=matches)
    diff_db = max(float(np.abs(kp_db[n] - kp_ref[n]).max()) for n in kp_ref)
    print(f"phase 13: keypoint_adjuster on a COLMAP database of phase 5's "
          f"scene {wall_db:.2f} s, launches {launches_db}; max |kp(database) "
          f"- kp(run_ka)| = {diff_db:.2e} px (limit {DB_KP_ATOL} px)")
    if not diff_db <= DB_KP_ATOL or min(launches_db.values()) <= 0:
        raise SystemExit("the database keypoint adjuster disagrees with "
                         "run_ka")

    # -- phase 14: PnP on the card against the CPU -----------------------------
    from pixsfm_tpu_torch.localization import (absolute_pose_estimation,
                                               absolute_pose_estimation_batch)
    queries = pnp_queries(np, seed=14, n_queries=PNP_QUERIES)
    sizes_q = [len(q["points2D"]) for q in queries]
    for polish in (False, True):
        t0 = time.perf_counter()
        o_dev = absolute_pose_estimation_batch(queries, polish=polish,
                                               device="cuda")
        torch.cuda.synchronize()
        w_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        o_cpu = absolute_pose_estimation_batch(queries, polish=polish,
                                               device="cpu")
        w_cpu = time.perf_counter() - t0
        tol = PNP_POLISHED_TOL if polish else PNP_UNPOLISHED_TOL
        rots, trans = [], []
        worst_n = worst_c = 0
        for a, b, q in zip(o_dev, o_cpu, queries):
            if a["success"] != b["success"]:
                raise SystemExit("PnP success differs between cuda and cpu")
            if not b["success"]:
                continue
            ang, dt = pose_agreement(np, a, b, q["points3D"])
            rots.append(ang)
            trans.append(dt)
            worst_n = max(worst_n, abs(a["num_inliers"] - b["num_inliers"]))
            worst_c = max(worst_c, unexplained(np, a, b, q),
                          unexplained(np, b, a, q))
        rots, trans = np.asarray(rots), np.asarray(trans)
        n_ok = len(rots)
        print(f"phase 14: PnP of {len(queries)} queries ({min(sizes_q)}-"
              f"{max(sizes_q)} correspondences), polish={polish}: "
              f"{n_ok} succeed; cuda {w_dev:.2f} s, cpu {w_cpu:.2f} s; "
              f"largest |inliers(cuda) - inliers(cpu)| {worst_n}, largest "
              f"count of one device's inliers the other's pose leaves out "
              f"{worst_c}; rotation median {np.median(rots):.2e} / largest "
              f"{rots.max():.2e} rad, translation median "
              f"{np.median(trans):.2e} / largest {trans.max():.2e} relative; "
              f"{int((rots <= 1e-6).sum())} of {n_ok} within 1e-6 rad "
              f"(limits 1, 1, {tol:g}, {tol:g})")
        if not (worst_n <= 1 and worst_c <= 1 and rots.max() <= tol
                and trans.max() <= tol):
            raise SystemExit(f"PnP disagrees between cuda and cpu "
                             f"(polish={polish})")
    # one stage-1 program (P3P, 256 samples) and one stage-2 program (the
    # full families, 512 samples) on one query of 500 correspondences, each
    # timed and its launches counted under the profiler
    from pixsfm_tpu_torch.localization import pnp
    q = pnp_queries(np, seed=140, n_queries=1, n=500)[0]
    xy_q = np.asarray(q["points2D"], np.float64)
    group = {(q["camera"].model, 512): [(0, xy_q, q["points3D"],
                                         q["camera"])]}
    pnp_calls = {}
    for label, H, fam in (("stage 1", 256, "p3p"), ("stage 2", 512, "full")):
        def one(H=H, fam=fam):
            return pnp._run_pnp_groups(group, H, 12.0,
                                       np.random.default_rng(0), "cuda", fam)
        one()
        _, t_call, busy_call, kern_call, _ = profile_stage(torch, one)
        t0 = time.perf_counter()
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        wall_call = (time.perf_counter() - t0) / 3
        n_launch = sum(c for _, c, _ in kern_call)
        pnp_calls[label] = dict(wall_s=wall_call, launches=n_launch,
                                device_busy_s=busy_call)
        print(f"phase 14: one {label} PnP program ({fam}, {H} samples, "
              f"{len(xy_q)} correspondences): {wall_call * 1e3:.1f} ms wall, "
              f"{n_launch} kernel launches, {busy_call * 1e3:.1f} ms device "
              f"busy (idle share {1 - busy_call / t_call:.2f} under the "
              f"profiler)")

    # -- phase 15: the incremental mapper on the card against the CPU ---------
    from pixsfm_tpu_torch.sfm.mapper import incremental_mapping
    graph_r, kps_r, sizes_r = ring_scene(np, n_views=12, n_points=300)
    maps = {}
    for device in ("cuda", "cpu"):
        st = {}
        t0 = time.perf_counter()
        rec_m = incremental_mapping(graph_r, {k: v.copy() for k, v in
                                              kps_r.items()}, sizes_r,
                                    device=device, stats=st)
        maps[device] = (rec_m, st, time.perf_counter() - t0)
    (r_d, s_d, w_d), (r_c, s_c, w_c) = maps["cuda"], maps["cpu"]
    reg_d = {i for i, im in r_d.images.items() if im.registered}
    reg_c = {i for i, im in r_c.images.items() if im.registered}
    init_d = s_d["init_pairs"][s_d["best_attempt"]]
    init_c = s_c["init_pairs"][s_c["best_attempt"]]
    rot_m, cen_m = aligned_errors(np, r_d, r_c, reg_c & reg_d)
    n_pd, n_pc = len(r_d.points3D), len(r_c.points3D)
    print(f"phase 15: mapper on a ring of {len(kps_r)} views / 300 points: "
          f"cuda {w_d:.2f} s ({s_d['attempts']} attempts, "
          f"{s_d['registrations']} registrations, {s_d['pnp_calls']} PnP "
          f"calls {s_d['pnp_time']:.2f} s, {s_d['ba_calls']} BA calls "
          f"{s_d['ba_time']:.2f} s), cpu {w_c:.2f} s ({s_c['attempts']} "
          f"attempts); registered {len(reg_d)} / {len(reg_c)}, initial pair "
          f"{init_d} / {init_c}, points {n_pd} / {n_pc}; after alignment "
          f"rotations within {rot_m.max():.2e} deg, centres within "
          f"{cen_m.max():.2e} of the extent (limits 0.05 deg, 1e-3)")
    if not (reg_d == reg_c and init_d == init_c
            and abs(n_pd - n_pc) <= 0.02 * n_pc
            and rot_m.max() < 0.05 and cen_m.max() < 1e-3):
        raise SystemExit("the mapper disagrees between cuda and cpu")

    # -- phase 16: the reconstruction main path at full width -----------------
    t0 = time.perf_counter()
    views_r, truth_r = make_fold_scene(
        torch, np, seed=16, n_views=24, n_points=RECON_POINTS, W=1600,
        H=1200, device="cuda", noise_px=RECON_NOISE_PX)
    kps_rc, matches_rc, scores_rc, _ = triangulation_inputs(np, truth_r)
    print(f"phase 16: fold scene of {len(views_r)} views, {RECON_POINTS} "
          f"points, {sum(len(v) for v in kps_rc.values())} keypoints, "
          f"{len(matches_rc)} pairs, keypoint noise {RECON_NOISE_PX} px, "
          f"made in {time.perf_counter() - t0:.1f} s")
    sfm_rc = PixSfM(tri_conf, device="cuda")
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    t0 = time.perf_counter()
    rec_r, out_r = sfm_rc._reconstruction(
        tmp / "reconstruction", views_r,
        {k: v.copy() for k, v in kps_rc.items()}, matches_rc, scores_rc)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    launches_rc = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                   "K3a": schur_cuda.launches["matvec"],
                   "K3b": schur_cuda.launches["rhs"],
                   "K3c": schur_cuda.launches["backsub"]}
    oka_r = {k: v[0] for k, v in out_r["KA"].items()}
    oba_r = {k: v[0] for k, v in out_r["BA"].items()}
    osfm = out_r["SfM"]
    reg_r = [i for i, im in rec_r.images.items() if im.registered]
    rot_r, cen_r = aligned_errors(np, rec_r, truth_r, reg_r)
    n_obs_r = sum(p.track_length for p in rec_r.points3D.values())
    t_rest = wall_r - oka_r["time"] - osfm["time"] \
        - oba_r["references_time"] - oba_r["time"]
    print(f"phase 16: reconstruction path {wall_r:.2f} s (graph, extraction "
          f"and packing {t_rest:.2f} s, KA {oka_r['time']:.2f} s, mapper "
          f"{osfm['time']:.2f} s, references {oba_r['references_time']:.2f} "
          f"s, BA solve {oba_r['time']:.2f} s); KA {oka_r['iterations']} LM "
          f"iterations, cost {oka_r['initial_cost']:.4f} -> "
          f"{oka_r['final_cost']:.4f}; mapper: {osfm['attempts']} attempts "
          f"(winner {osfm['best_attempt']}), {osfm['registrations']} "
          f"registrations, {osfm['pnp_calls']} PnP calls "
          f"{osfm['pnp_time']:.2f} s, {osfm['ba_calls']} geometric-BA calls "
          f"{osfm['ba_time']:.2f} s, {osfm['triangulations']} "
          f"triangulations {osfm['triangulation_time']:.2f} s; "
          f"{len(reg_r)} / {len(views_r)} views registered, "
          f"{len(rec_r.points3D)} points, {n_obs_r} observations; BA "
          f"regime {oba_r['linear_solver']}, {oba_r['iterations']} LM / "
          f"{oba_r['cg_iterations']} CG iterations, cost "
          f"{oba_r['initial_cost']:.4f} -> {oba_r['final_cost']:.4f}; after "
          f"a similarity to the truth rotations within {rot_r.max():.3f} "
          f"deg, centres within {cen_r.max():.2e} of the extent (limits "
          f"0.5 deg, 1e-2); launches {launches_rc}")
    if len(reg_r) < len(views_r) - 1:
        raise SystemExit(f"only {len(reg_r)} of {len(views_r)} views "
                         f"registered")
    if not (rot_r.max() < 0.5 and cen_r.max() < 1e-2):
        raise SystemExit("the reconstruction is off the truth")
    if not oba_r["final_cost"] < oba_r["initial_cost"]:
        raise SystemExit("BA cost did not fall on the reconstruction path")
    if min(launches_rc["K1"], launches_rc["K2"]) <= 0:
        raise SystemExit(f"K1 or K2 did not launch on the reconstruction "
                         f"path: {launches_rc}")
    # where the time goes, under the profiler (not counted): the KA and the
    # final BA again (BA capped at BA_PROFILE_ITERATIONS), and one call of
    # each of the mapper's device stages on the final map (PnP of a view,
    # the retriangulation, a geometric BA). The whole path under the
    # profiler is ~2.4 million launches, whose tables take ~20 minutes to
    # build; the mapper's device-busy time is estimated from the single
    # calls times their counts (calls on the final map are the largest, so
    # the estimate is an upper bound on busy time).
    from pixsfm_tpu_torch.bundle_adjustment import GeometricBundleAdjuster
    from pixsfm_tpu_torch.sfm.mapper import mapper_ba_conf
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_tracks
    sfm_rc_prof = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}, device="cuda")
    graph_rc = build_matching_graph(matches_rc, scores_rc)
    kps_p = {k: v.copy() for k, v in kps_rc.items()}
    fm_rc = features_from_graph(sfm_rc_prof.extractor, views_r, graph_rc,
                                kps_p)
    prof_rc = {}
    prof_rc["KA"] = profile_stage(torch, lambda: sfm_rc_prof.keypoint_adjuster
                                  .refine_multilevel(kps_p, fm_rc, graph_rc))
    del fm_rc
    rec_p = rec_r.copy()
    prof_rc["references + BA"] = profile_stage(
        torch, lambda: sfm_rc_prof.run_ba(rec_p, views_r))
    im0 = rec_r.images[reg_r[len(reg_r) // 2]]
    sel = np.nonzero(im0.point3D_ids >= 0)[0]
    X0 = np.stack([rec_r.points3D[int(p)].xyz for p in im0.point3D_ids[sel]])
    cam0 = rec_r.cameras[im0.camera_id]
    prof_rc["PnP"] = profile_stage(torch, lambda: absolute_pose_estimation(
        rec_r.images[im0.image_id].xys[sel], X0, cam0, polish=False,
        device="cuda"))
    rec_t2 = rec_r.copy()
    rec_t2.points3D.clear()
    for im in rec_t2.images.values():
        im.point3D_ids[:] = -1
    labels_rc = compute_track_labels(graph_rc)
    prof_rc["triangulation"] = profile_stage(torch, lambda: triangulate_tracks(
        rec_t2, graph_rc, {im.name: im.xys for im in rec_r.images.values()},
        track_labels=labels_rc, device="cuda"))
    ba_geo = GeometricBundleAdjuster(mapper_ba_conf(False), device="cuda")
    rec_g = rec_r.copy()
    prof_rc["geometric BA"] = profile_stage(torch,
                                            lambda: ba_geo.refine(rec_g))
    kern_rcp = {}
    for stage, (_, t_p, busy_p, kern_p, tab_p) in prof_rc.items():
        n_p = sum(c for _, c, _ in kern_p)
        print(f"phase 16 (under the profiler): {stage} {t_p:.3f} s wall, "
              f"{busy_p:.3f} s device busy (idle share "
              f"{1 - busy_p / t_p:.2f}), {n_p} kernel launches")
        for name, calls, dev_ms in kern_p:
            c0, ms0 = kern_rcp.get(name, (0, 0.0))
            kern_rcp[name] = (c0 + calls, ms0 + dev_ms)
    busy_map = sum(prof_rc[stage][2] * osfm[key] for stage, key in (
        ("PnP", "pnp_calls"), ("triangulation", "triangulations"),
        ("geometric BA", "ba_calls")))
    print(f"phase 16: the mapper's device busy time, estimated from the "
          f"single calls times their counts: {busy_map:.2f} s of "
          f"{osfm['time']:.2f} s (idle share at least "
          f"{1 - busy_map / osfm['time']:.2f})")
    kern_rcp = sorted(((n, c, ms) for n, (c, ms) in kern_rcp.items()),
                      key=lambda k: -k[2])
    for name, calls, dev_ms in kern_rcp[:12]:
        print(f"  reconstruction path: {dev_ms:9.3f} ms in {calls:7d} "
              f"launches  {name[:90]}")
    in_situ_rc = _in_situ(kern_rcp, {"K1": "interp_kernel",
                                     "K2": "pcg_kernel"}, launches_rc)
    print(f"phase 16: in-situ device ms per launch {in_situ_rc}")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            for stage, res in prof_rc.items():
                fh.write(f"\n\n== reconstruction path: {stage} ==\n"
                         f"{res[4]}\n")
    n_obs_rc = n_obs_r
    del views_r, rec_r, sfm_rc, sfm_rc_prof, prof_rc, rec_p, rec_g, rec_t2
    torch.cuda.empty_cache()
    k1_rc = check_k1(torch, interpolate_cuda, n_patches=n_obs_rc,
                     n_queries=8192, dtypes=(torch.bfloat16,))

    # -- phase 17: dsift on the triangulation path -----------------------------
    from pixsfm_tpu_torch.config import load_config
    sfm_ds = PixSfM(load_config("dsift"), device="cuda")
    t0 = time.perf_counter()
    rec_ds, out_ds = sfm_ds._triangulation(
        tmp / "triangulated_dsift", reference, views_t,
        {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
    torch.cuda.synchronize()
    wall_ds = time.perf_counter() - t0
    err_ds = triangulated_error(np, rec_ds, truth_t)
    oka_ds = {k: v[0] for k, v in out_ds["KA"].items()}
    oba_ds = {k: v[0] for k, v in out_ds["BA"].items()}
    print(f"phase 17: the triangulation path with configs/dsift.yaml "
          f"{wall_ds:.2f} s (KA {oka_ds['time']:.2f} s, {oka_ds['iterations']} "
          f"LM iterations, cost {oka_ds['initial_cost']:.4f} -> "
          f"{oka_ds['final_cost']:.4f}; BA {oba_ds['iterations']} LM "
          f"iterations, cost {oba_ds['initial_cost']:.4f} -> "
          f"{oba_ds['final_cost']:.4f}); {len(rec_ds.points3D)} points; "
          f"point error to truth {err_raw:.5f} (unrefined keypoints) -> "
          f"{err_ds:.5f} with dsift, -> {err_tri:.5f} with S2DNet (phase 11)")
    if not all(np.isfinite(p.xyz).all() for p in rec_ds.points3D.values()):
        raise SystemExit("non-finite points on the dsift triangulation path")
    if not (oka_ds["final_cost"] < oka_ds["initial_cost"]
            and oba_ds["final_cost"] <= oba_ds["initial_cost"]):
        raise SystemExit("dsift: a cost did not fall")
    tmp_dir.cleanup()

    # -- report ----------------------------------------------------------------
    # K1 runs on both paths at different shapes: one entry per path, each
    # with that path's launches and the figures measured at its shape
    paths = {"KA": launches, "BA": launches_ba,
             "triangulation": launches_tri, "reconstruction": launches_rc}
    both = {k: sum(n.get(k, 0) for n in paths.values())
            for k in ("K1", "K2", "K3a", "K3b", "K3c")}
    print(f"launches on the main paths: {paths}")
    kernels_line = {"kernels": [
        dict(name="bicubic_window_interp_l2", path="KA", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches["K1"], library_ms=None,
             in_situ_ms=in_situ_ka["K1"], **k1),
        dict(name="bicubic_window_interp_l2", path="BA", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_ba["K1"], library_ms=None,
             in_situ_ms=in_situ["K1"], **k1_ba),
        dict(name="bicubic_window_interp_l2", path="triangulation",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_tri["K1"], library_ms=None,
             in_situ_ms=in_situ_tri["K1"], **k1_tri),
        dict(name="bicubic_window_interp_l2", path="reconstruction",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_rc["K1"], library_ms=None,
             in_situ_ms=in_situ_rc["K1"], **k1_rc),
        dict(name="batched_jacobi_pcg", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/pcg.cu",
             replaces="pixsfm_tpu/ops/cg_pallas.py:88",
             launches=both["K2"],
             launches_by_path={n: c["K2"] for n, c in paths.items()},
             library_ms=None, in_situ_ms=in_situ_ka["K2"], **k2),
        dict(name="schur_term_matvec", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:253",
             launches=both["K3a"], library_ms=None,
             in_situ_ms=in_situ["K3a"], **k3["K3a"]),
        dict(name="schur_rhs", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:280",
             launches=both["K3b"], library_ms=None,
             in_situ_ms=in_situ["K3b"], **k3["K3b"]),
        dict(name="schur_backsub", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:302",
             launches=both["K3c"], library_ms=None,
             in_situ_ms=in_situ["K3c"], **k3["K3c"]),
    ]}
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
