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
7. K3a/b/c (the Schur kernels of the grid-regime CG solve,
   ``ops/schur_cuda.py``) against their plain versions at the BA main
   path's shape (T = 8 ranks, SIMPLE_RADIAL so k = 4, 56 images, one
   camera, 65 536 padded points): error against a float64 reference and
   time per launch. Then K1 again at the BA path's shape: 8192 queries (one
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
   launch of K1 and K3a/b/c.

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main paths (KA and BA), its error against the plain version, its time per
launch (CUDA events), the plain version's time and the bound computed from
this run's inputs; K1, which both paths launch at different shapes, has one
entry per path (``"path": "KA"`` / ``"BA"``) with that path's launches and
the figures at its shape; and last ``{"ok": true, "device": {...}}``.

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
BA_PROFILE_ITERATIONS = 5


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


def check_k3(torch, schur_cuda, T, I, Nc, k, P, n_obs, device="cuda"):
    """Each K3 kernel against its plain version. Tolerance: |kernel - ref|
    <= 2e-5 |ref| + 1e-6 S per entry, ref the plain version in float64 and
    S the same sums over absolute values (the kernels add in another,
    atomic, order, so their float32 error grows with S, not |ref|)."""
    x = k3_inputs(torch, schur_cuda, T, I, Nc, k, P, n_obs, device=device)
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
              "K3c": n_in + tables + x["gx"].numel() * 4}
    per_obs = P * T * NR * 3 * 2
    flops = {"K3a": 2 * per_obs + 18 * P, "K3b": per_obs + 18 * P,
             "K3c": per_obs}
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
            raise SystemExit(f"{name} disagrees with its plain version")
        ms = _time_ms(lambda: kern(x))
        plain_ms = _time_ms(lambda: plain(x), reps=5)
        bound_ms, bound_by = _bound(bytes_[name], flops[name])
        print(f"{name} timing (T={T}, k={k}, I={I}, Nc={Nc}, P={P}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bytes_[name] / 1e6:.1f} MB)")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return out


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
                  min_track=4, max_track=8, margin=24):
    """A reconstruction of ``n_points`` points on the textured plane z = 0,
    seen by ``n_views`` SIMPLE_RADIAL cameras (1.8-2.4 units away, tilted
    10-35 degrees); each point's track is a random subset of 4-8 of the
    views that see it (``margin`` px inside the image). The views are
    rendered on ``device`` (plane -> image homographies of the true poses).
    Returns (reconstruction with perturbed poses and points, {name: [H, W,
    3] uint8}, the true reconstruction)."""
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
        xy = proj[pts, v] + rng.normal(0, 0.3, (len(pts), 2))
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
    in_situ = {}
    for key, tag in (("K3a", "matvec_kernel"), ("K3b", "rhs_kernel"),
                     ("K3c", "backsub_kernel"), ("K1", "interp_kernel")):
        hits = [(c, ms) for n, c, ms in kern_bap if tag in n]
        calls = sum(c for c, _ in hits)
        if calls:
            in_situ[key] = sum(ms for _, ms in hits) / calls
    print(f"phase 10: in-situ device ms per launch {in_situ}")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            fh.write(f"\n\n== BA extraction ==\n{tab_exb}\n\n== BA "
                     f"references + solve ({BA_PROFILE_ITERATIONS} LM "
                     f"iterations) ==\n{tab_bap}\n")

    # -- report ----------------------------------------------------------------
    # K1 runs on both paths at different shapes: one entry per path, each
    # with that path's launches and the figures measured at its shape
    both = {k: launches.get(k, 0) + launches_ba.get(k, 0)
            for k in ("K1", "K2", "K3a", "K3b", "K3c")}
    print(f"launches on the main paths: KA {launches}, BA {launches_ba}")
    kernels_line = {"kernels": [
        dict(name="bicubic_window_interp_l2", path="KA", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches["K1"], library_ms=None, **k1),
        dict(name="bicubic_window_interp_l2", path="BA", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_ba["K1"], library_ms=None, **k1_ba),
        dict(name="batched_jacobi_pcg", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/pcg.cu",
             replaces="pixsfm_tpu/ops/cg_pallas.py:88",
             launches=both["K2"], library_ms=None, **k2),
        dict(name="schur_term_matvec", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:253",
             launches=both["K3a"], library_ms=None, **k3["K3a"]),
        dict(name="schur_rhs", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:280",
             launches=both["K3b"], library_ms=None, **k3["K3b"]),
        dict(name="schur_backsub", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:302",
             launches=both["K3c"], library_ms=None, **k3["K3c"]),
    ]}
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
