"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. These have no CPU mode (the kernels are CUDA C++), so they carry the
``cuda`` marker and skip without a GPU. On a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (``--noconftest`` skips ``tests/conftest.py``,
which sets JAX up).
"""

import pytest
import torch

from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda, schur_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _k1_inputs(dev, dtype, n_patches=64, n=1000, ps=16, C=128,
               misaligned=False):
    """``misaligned``: rows is a view one element (2 or 4 bytes) past an
    aligned base, which the kernel's 16-byte loads cannot take."""
    gen = torch.Generator(device=dev).manual_seed(0)
    numel = n_patches * ps * ps * C
    buf = torch.randn(numel + 8, generator=gen, device=dev).to(dtype)
    rows = (buf[1:numel + 1] if misaligned else buf[:numel]).view(
        n_patches * ps, ps, C)
    row_base = torch.randint(0, n_patches, (n,), generator=gen,
                             device=dev) * ps
    r = torch.rand(n, generator=gen, device=dev) * (ps + 2.0) - 1.5
    c = torch.rand(n, generator=gen, device=dev) * (ps + 2.0) - 1.5
    r[:4] = torch.tensor([0.0, ps - 1.0, 0.25, ps - 1.25])
    c[:4] = torch.tensor([ps - 1.0, 0.0, ps - 1.5, 0.5])
    return rows, row_base, r, c


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("l2", [False, True])
def test_k1_matches_plain(dev, dtype, atol, l2):
    rows, row_base, r, c = _k1_inputs(dev, dtype)
    before = interpolate_cuda.launches
    out = interpolate_cuda.interpolate_rows(rows, 16, 16, 128, row_base, r,
                                            c, l2)
    ref = interpolate_cuda.interpolate_rows_plain(rows, 16, 16, 128,
                                                  row_base, r, c, l2)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before + 1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


K1_ATOL = {torch.float32: 2e-5, torch.bfloat16: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("C,ps,misaligned,variant", [
    (20, 16, False, "general"),      # C no multiple of 8
    (136, 16, False, "general"),
    (64, 16, False, "general"),      # a multiple of 8 that is not 128
    (128, 3, False, "vector"),       # W = H = 3: every tap clamps
    (20, 3, False, "general"),
    (128, 16, True, "general"),      # base not 16-byte aligned
])
def test_k1_edge_shapes_match_plain(dev, dtype, l2, C, ps, misaligned,
                                    variant):
    rows, row_base, r, c = _k1_inputs(dev, dtype, n_patches=40, n=1501,
                                      ps=ps, C=C, misaligned=misaligned)
    assert interpolate_cuda.kernel_variant(rows) == variant
    assert (rows.data_ptr() % 16 != 0) == misaligned
    out = interpolate_cuda.interpolate_rows(rows, ps, ps, C, row_base, r, c,
                                            l2)
    ref = interpolate_cuda.interpolate_rows_plain(rows, ps, ps, C, row_base,
                                                  r, c, l2)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=K1_ATOL[dtype], rtol=0)


def test_k1_variant_by_width_and_type(dev):
    """The C entry point picks the vector variant for bf16 and f32 rows of
    128 channels, the general one otherwise."""
    for dtype in (torch.bfloat16, torch.float32):
        for C in (8, 20, 32, 64, 128, 136, 256):
            rows = torch.zeros((16, 16, C), device=dev, dtype=dtype)
            want = "vector" if C == 128 else "general"
            assert interpolate_cuda.kernel_variant(rows) == want, (dtype, C)


def test_k1_rejects_bad_layout(dev):
    rows, row_base, r, c = _k1_inputs(dev, torch.float32)
    with pytest.raises(ValueError):
        interpolate_cuda.interpolate_rows(rows, 16, 16, 64, row_base, r, c,
                                          True)


@pytest.mark.parametrize("folded", [True, False])
def test_k2_matches_plain(dev, folded):
    gen = torch.Generator(device=dev).manual_seed(1)
    P, N = 32, 112
    A = torch.randn((P, N, N), generator=gen, device=dev)
    H = A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)
    g = torch.randn((P, N), generator=gen, device=dev)
    damp = torch.rand((P, N), generator=gen, device=dev)
    if not folded:
        H, damp = H + torch.diag_embed(damp), None
    out = cg_cuda.pcg_solve(H, g, 15, damp=damp)
    ref = cg_cuda.pcg_solve_plain(H, g, 15, damp=damp)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def _spd(dev, P, N, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((P, N, N), generator=gen, device=dev)
    H = A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)
    g = torch.randn((P, N), generator=gen, device=dev)
    damp = torch.rand((P, N), generator=gen, device=dev)
    return H, g, damp


@pytest.mark.parametrize("variant", ["register", "general"])
@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("P,N,iters", [
    (1, 112, 15),        # one system
    (300, 112, 15),      # more systems than SMs
    (128, 112, 0),       # no step: dx = 0
    (128, 112, 1),
    (40, 128, 15),       # the register variant's largest N
    (40, 100, 15),       # N % 8 == 4: the last warp holds 4 rows
    (40, 4, 15),         # its smallest N
])
def test_k2_variants_match_plain(dev, variant, folded, P, N, iters):
    H, g, damp = _spd(dev, P, N, seed=P + N + iters)
    if not folded:
        H, damp = H + torch.diag_embed(damp), None
    before = cg_cuda.launches
    out = cg_cuda.pcg_solve(H, g, iters, damp=damp, variant=variant)
    ref = cg_cuda.pcg_solve_plain(H, g, iters, damp=damp)
    torch.cuda.synchronize()
    assert cg_cuda.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("N", [51, 129, 132, 200])
def test_k2_general_shapes_match_plain(dev, folded, N):
    """N that the register variant refuses: the automatic choice is the
    general variant, and forcing the register one raises."""
    assert cg_cuda.kernel_variant(N) == "general"
    H, g, damp = _spd(dev, 9, N, seed=N)
    if not folded:
        H, damp = H + torch.diag_embed(damp), None
    out = cg_cuda.pcg_solve(H, g, 15, damp=damp)
    ref = cg_cuda.pcg_solve_plain(H, g, 15, damp=damp)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="register"):
        cg_cuda.pcg_solve(H, g, 15, damp=damp, variant="register")


def test_k2_variant_at_the_boundaries(dev):
    """Register for every multiple of 4 up to 128, general otherwise."""
    for N in range(1, 260):
        want = "register" if N % 4 == 0 and N <= 128 else "general"
        assert cg_cuda.kernel_variant(N) == want, N


def test_k2_misaligned_h_takes_the_general_variant(dev):
    P, N = 8, 112
    H, g, damp = _spd(dev, P, N, seed=3)
    buf = torch.empty(H.numel() + 4, device=dev)
    Hm = buf[1:H.numel() + 1].view(P, N, N)
    Hm.copy_(H)
    assert Hm.data_ptr() % 16 != 0
    out = cg_cuda.pcg_solve(Hm, g, 15, damp=damp)
    ref = cg_cuda.pcg_solve_plain(H, g, 15, damp=damp)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="aligned"):
        cg_cuda.pcg_solve(Hm, g, 15, damp=damp, variant="register")


def test_k2_rejects_oversized_system(dev):
    N = 400  # 640 KB of float32: more than one block's shared memory
    H = torch.eye(N, device=dev)[None]
    with pytest.raises(ValueError, match="shared"):
        cg_cuda.pcg_solve(H, torch.ones((1, N), device=dev), 5)


def _k3_inputs(dev, T, I, Nc, k=4, Np=700, holes=0.3):
    """Grid-packed Schur inputs on the card: random W blocks, a fraction of
    track slots left as holes (zero blocks, indices at slot 0), Np not a
    multiple of the tile so the tail points are padding."""
    gen = torch.Generator(device=dev).manual_seed(T * 1000 + I)
    NR = 6 + k
    O = Np * T
    Bt = torch.randn((NR * 3, O), generator=gen, device=dev)
    img = torch.randint(0, I, (O,), generator=gen, device=dev)
    cam = torch.randint(0, Nc, (O,), generator=gen, device=dev)
    hole = torch.rand(O, generator=gen, device=dev) < holes
    Bt[:, hole] = 0.0
    img[hole] = 0
    cam[hole] = 0
    A = torch.randn((Np, 3, 3), generator=gen, device=dev)
    Vinv = torch.einsum("pab,pcb->acp", A, A) + 3 * torch.eye(
        3, device=dev)[:, :, None]
    vpT = torch.randn((6, I), generator=gen, device=dev)
    vcT = torch.randn((k, Nc), generator=gen, device=dev)
    gx = torch.randn((3, Np), generator=gen, device=dev)
    Btr, img_r, cam_r, Vi, Ppad = schur_cuda.pack_grid_blocks(
        Bt, img, cam, Vinv, T)
    gxp = torch.cat([gx, gx.new_zeros((3, Ppad - Np))], dim=1)
    return vpT, vcT, Btr, img_r, cam_r, Vi, gxp


def k3_error_ratio(out, fn, args):
    """Largest ``|out - ref| / (2e-5 |ref| + 1e-6 S)`` over the entries, with
    ``ref = fn(*args)`` in float64 and ``S = fn(*|args|)``: the sum of the
    absolute values of every product that went into an entry. The kernels
    sum in another (atomic) order than the plain version, so their float32
    error grows with S, not with |ref| (sums of hundreds of terms cancel);
    1e-6 S is ~16 float32 epsilons of it. A ratio <= 1 passes."""
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    ref = fn(*f64)
    S = fn(*[a.abs() if a.is_floating_point() else a for a in f64])
    if isinstance(ref, torch.Tensor):
        out, ref, S = (out,), (ref,), (S,)
    return max(float(((o.double() - r).abs() / (2e-5 * r.abs() + 1e-6 * s + 1e-30))
                     .max()) for o, r, s in zip(out, ref, S))


@pytest.mark.parametrize("T", [4, 8, 16])
@pytest.mark.parametrize("I,Nc", [(13, 3), (3000, 2)])
def test_k3_match_plain(dev, T, I, Nc):
    """K3a/b/c against their plain versions; (3000, 2) exceeds the
    shared-memory tables and takes the global-atomics variant."""
    vpT, vcT, Btr, img_r, cam_r, Vi, gxp = _k3_inputs(dev, T, I, Nc)
    dims = dict(T=T, I=I, Nc=Nc, k=4)
    before = dict(schur_cuda.launches)
    up_uc = schur_cuda.schur_term_matvec(vpT, vcT, Btr, img_r, cam_r, Vi,
                                         **dims)
    rhs = schur_cuda.schur_rhs(Btr, img_r, cam_r, Vi, gxp, **dims)
    t = schur_cuda.schur_backsub(vpT, vcT, Btr, img_r, cam_r, **dims)
    torch.cuda.synchronize()
    assert all(schur_cuda.launches[n] == before[n] + 1 for n in before)
    assert k3_error_ratio(up_uc, schur_cuda.schur_term_matvec_plain,
                          (vpT, vcT, Btr, img_r, cam_r, Vi)) <= 1.0
    assert k3_error_ratio(rhs, lambda *a: schur_cuda.schur_rhs_plain(
        *a, I, Nc), (Btr, img_r, cam_r, Vi, gxp)) <= 1.0
    assert k3_error_ratio(t, schur_cuda.schur_backsub_plain,
                          (vpT, vcT, Btr, img_r, cam_r)) <= 1.0


@pytest.mark.parametrize("T,I,Nc,k,variant", [
    (1, 13, 3, 4, "fused1/shared"),       # one rank, mixed camera slots
    (5, 13, 3, 1, "fused1/shared"),       # T no power of two, k = 1
    (8, 2, 1, 8, "fused1/shared"),        # k = 8, two image slots
    (12, 7, 2, 3, "fused2/shared"),       # two ranks per warp
    (16, 13, 3, 8, "fused2/shared"),
    (20, 13, 3, 4, "twopass/shared"),     # T > 16
    (5, 3000, 2, 4, "fused1/global"),     # tables above shared memory
    (16, 3000, 2, 8, "fused2/global"),
    (20, 3000, 2, 4, "twopass/global"),
])
def test_k3a_edge_shapes_match_plain(dev, T, I, Nc, k, variant):
    """Every variant of K3a (and K3b, which shares its scatter) against the
    plain versions, holes and a ragged Np included."""
    vpT, vcT, Btr, img_r, cam_r, Vi, gxp = _k3_inputs(dev, T, I, Nc, k=k)
    dims = dict(T=T, I=I, Nc=Nc, k=k)
    assert schur_cuda.matvec_variant(T, k, I, Nc, Btr.shape[2]) == variant
    if Nc > 1:   # camera slots are mixed inside a warp's 32 points
        assert cam_r[0, :32].unique().numel() > 1
    up_uc = schur_cuda.schur_term_matvec(vpT, vcT, Btr, img_r, cam_r, Vi,
                                         **dims)
    rhs = schur_cuda.schur_rhs(Btr, img_r, cam_r, Vi, gxp, **dims)
    torch.cuda.synchronize()
    assert k3_error_ratio(up_uc, schur_cuda.schur_term_matvec_plain,
                          (vpT, vcT, Btr, img_r, cam_r, Vi)) <= 1.0
    assert k3_error_ratio(rhs, lambda *a: schur_cuda.schur_rhs_plain(
        *a, I, Nc), (Btr, img_r, cam_r, Vi, gxp)) <= 1.0


def _k3b_ratio(out, Btr, img_r, cam_r, Vi, gxp, I, Nc):
    return k3_error_ratio(out, lambda *a: schur_cuda.schur_rhs_plain(
        *a, I, Nc), (Btr, img_r, cam_r, Vi, gxp))


@pytest.mark.parametrize("T,I,Nc,k,variant", [
    (1, 13, 3, 4, "fused1/shared"),
    (8, 56, 1, 4, "fused1/shared"),       # the BA path's T, k and camera
    (8, 2, 1, 8, "fused1/shared"),
    (12, 7, 2, 3, "fused2/shared"),
    (16, 13, 3, 8, "fused2/shared"),
    (17, 13, 3, 4, "onepass/shared"),     # the first T past the fused one
    (20, 13, 3, 4, "onepass/shared"),
    (5, 3000, 2, 4, "fused1/global"),     # accumulators above shared memory
    (16, 3000, 2, 8, "fused2/global"),
    (20, 3000, 2, 4, "onepass/global"),
])
def test_k3b_variants_match_plain(dev, T, I, Nc, k, variant):
    """Every K3b variant, and the one-pass kernel forced at the same shape,
    at K3a's tolerance (2e-5 |ref| + 1e-6 S against float64)."""
    _, _, Btr, img_r, cam_r, Vi, gxp = _k3_inputs(dev, T, I, Nc, k=k)
    P = Btr.shape[2]
    dims = dict(T=T, I=I, Nc=Nc, k=k)
    assert schur_cuda.rhs_variant(T, k, I, Nc, P) == variant
    before = schur_cuda.launches["rhs"]
    auto = schur_cuda.schur_rhs(Btr, img_r, cam_r, Vi, gxp, **dims)
    onepass = schur_cuda.schur_rhs(Btr, img_r, cam_r, Vi, gxp,
                                   variant="onepass", **dims)
    torch.cuda.synchronize()
    assert schur_cuda.launches["rhs"] == before + 2
    assert _k3b_ratio(auto, Btr, img_r, cam_r, Vi, gxp, I, Nc) <= 1.0
    assert _k3b_ratio(onepass, Btr, img_r, cam_r, Vi, gxp, I, Nc) <= 1.0


def test_k3b_variant_at_the_boundaries(dev):
    """Fused up to T = 16 (one rank per warp up to 8), one-pass past it;
    accumulators in shared memory while 6 I + k Nc floats fit 48 KB beside
    the fused kernel's 768 bytes (the one-pass kernel has no such array)."""
    P = 4096
    for T, want in ((1, "fused1"), (8, "fused1"), (9, "fused2"),
                    (16, "fused2"), (17, "onepass"), (40, "onepass")):
        assert schur_cuda.rhs_variant(T, 4, 13, 3, P) == want + "/shared"
    room = (48 * 1024 - 768) // 4          # floats beside the fused s_t
    I = (room - 4) // 6                    # k = 4, Nc = 1
    assert schur_cuda.rhs_variant(8, 4, I, 1, P) == "fused1/shared"
    assert schur_cuda.rhs_variant(8, 4, I + 1, 1, P) == "fused1/global"
    I = (48 * 1024 // 4 - 4) // 6
    assert schur_cuda.rhs_variant(20, 4, I, 1, P) == "onepass/shared"
    assert schur_cuda.rhs_variant(20, 4, I + 1, 1, P) == "onepass/global"
    # a rank block of 2^31 floats or more: the fused kernel's 32-bit offsets
    # do not reach
    big = (2 ** 31) // 30 + 1
    assert schur_cuda.rhs_variant(8, 4, 13, 3, big) == "onepass/shared"
    assert schur_cuda.rhs_variant(8, 4, 13, 3, big - 1) == "fused1/shared"


def test_k3_rejects_bad_layout(dev):
    vpT, vcT, Btr, img_r, cam_r, Vi, _ = _k3_inputs(dev, 4, 13, 3)
    with pytest.raises(ValueError, match="int32"):
        schur_cuda.schur_backsub(vpT, vcT, Btr, img_r.long(), cam_r, T=4,
                                 I=13, Nc=3, k=4)


# ---------------------------------------------------------------------------
# the dense Schur step and the batched triangulation: library calls on the
# card (cholesky_ex, solve_triangular, svd) held to the same code on the CPU
# ---------------------------------------------------------------------------

def _dense_refine(device, mixed):
    """``GeometricBundleAdjuster.refine`` on a small synthetic scene, which
    takes the dense step: (summary, points [Np, 3])."""
    import numpy as np
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.bundle_adjustment import GeometricBundleAdjuster
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=6, n_points=120, noise_px=0.3,
                                   seed=21, shared_camera=not mixed)
    if mixed:          # the even images on a PINHOLE camera of the same K
        for cid, cam in list(rec.cameras.items()):
            if cid % 2 == 0:
                f, cx, cy, _ = cam.params
                rec.cameras[cid] = Camera(cid, "PINHOLE", cam.width,
                                          cam.height, [f, f, cx, cy])
    rng = np.random.default_rng(21)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.02, 3)
    for iid in sorted(rec.images)[1:]:
        rec.images[iid].tvec = rec.images[iid].tvec + rng.normal(0, 0.01, 3)
    out = GeometricBundleAdjuster(
        {"optimizer": {"solver": {"max_num_iterations": 10}}},
        device=device).refine(rec)
    return out, np.stack([rec.points3D[p].xyz for p in sorted(rec.points3D)])


@pytest.mark.parametrize("mixed", [False, True])
def test_dense_step_cuda_matches_cpu(dev, mixed):
    """Phase 8's limits: final cost rtol 1e-4, points 1e-3."""
    out_d, x_d = _dense_refine("cuda", mixed)
    out_c, x_c = _dense_refine("cpu", mixed)
    assert out_d["linear_solver"] == out_c["linear_solver"] == "dense"
    assert out_d["final_cost"] < out_d["initial_cost"]
    assert abs(out_d["final_cost"] - out_c["final_cost"]) \
        <= 1e-4 * out_c["final_cost"]
    assert float(abs(x_d - x_c).max()) <= 1e-3


def test_dense_camera_solve_cuda_matches_cpu(dev):
    """The Jacobi-scaled Cholesky on the card against the CPU; a system that
    is not positive definite gives NaNs there too (no host sync, no zero
    step)."""
    from pixsfm_tpu_torch.ops.schur import dense_camera_solve
    gen = torch.Generator().manual_seed(4)
    A = torch.randn((60, 60), generator=gen, dtype=torch.float64)
    d = 10.0 ** (torch.rand(60, generator=gen, dtype=torch.float64) * 6 - 3)
    S = ((A @ A.T + 60 * torch.eye(60, dtype=torch.float64))
         * d[:, None] * d[None, :]).float()
    b = torch.randn(60, generator=gen)
    x_c = dense_camera_solve(S, b)
    x_d = dense_camera_solve(S.to(dev), b.to(dev)).cpu()
    torch.testing.assert_close(x_d, x_c, rtol=1e-4, atol=0)
    S[5, 5] = -S[5, 5]
    assert torch.isnan(dense_camera_solve(S.to(dev), b.to(dev))).all()


def test_triangulate_batch_cuda_matches_cpu(dev):
    """The batched DLT (``torch.linalg.svd`` of [N, 2T, 4] stacks) on the
    card against the CPU, on tracks of 2-8 views with missing rows; points
    within 1e-4 of each other (scene units) and of the truth."""
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_batch
    gen = torch.Generator().manual_seed(5)
    N, T = 4000, 8
    X = torch.rand((N, 3), generator=gen, dtype=torch.float64) * 2 - 1
    X[:, 2] += 6.0
    C = torch.rand((N, T, 3), generator=gen, dtype=torch.float64) * 2 - 1
    uv = (X[:, None, :2] - C[..., :2]) / (X[:, None, 2:] - C[..., 2:])
    # [I | -c] rows: u * P[2] - P[0], v * P[2] - P[1]
    P = torch.cat([torch.eye(3, dtype=torch.float64).expand(N, T, 3, 3),
                   -C[..., None]], -1)
    A = torch.stack([uv[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                     uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]], 2)
    L = torch.randint(2, T + 1, (N,), generator=gen)
    A[torch.arange(T)[None, :].expand(N, T) >= L[:, None]] = 0.0
    A = A.reshape(N, 2 * T, 4).float()
    x_c = triangulate_batch(A)
    x_d = triangulate_batch(A.to(dev)).cpu()
    torch.testing.assert_close(x_d, x_c, atol=1e-4, rtol=0)
    torch.testing.assert_close(x_d, X.float(), atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# PnP (localization/pnp.py) and dense SIFT: the card against the CPU
# ---------------------------------------------------------------------------

def _pnp_queries(seed=0):
    """PnP queries of 30-600 correspondences, general and planar scenes,
    0-60 % outliers, SIMPLE_RADIAL and PINHOLE cameras (numpy)."""
    import numpy as np

    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.localization.pnp import (_rotmat_to_quat_np,
                                                   project_np)
    rng = np.random.default_rng(seed)
    queries = []
    for i, (n, out, planar) in enumerate([(30, 0.0, False), (80, 0.3, True),
                                          (200, 0.6, False), (600, 0.1, True),
                                          (45, 0.5, False), (300, 0.0, True)]):
        cam = (Camera(1, "SIMPLE_RADIAL", 1024, 768, [900.0, 512, 384, 0.03])
               if i % 2 else Camera(1, "PINHOLE", 800, 600,
                                    [700.0, 720.0, 400, 300]))
        X = rng.uniform(-2, 2, (n, 3))
        if planar:
            X[:, 2] = 0.2 * X[:, 0]
        a = rng.normal(0, 0.3, 3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K
        t = np.array([0.1, -0.2, 7.0])
        xy, _ = project_np(cam, _rotmat_to_quat_np(R), t, X)
        xy = xy + rng.normal(0, 0.5, xy.shape)
        k = int(out * n)
        xy[:k] = rng.uniform(0, [cam.width, cam.height], (k, 2))
        queries.append(dict(points2D=xy, points3D=X, camera=cam))
    return queries


@pytest.mark.parametrize("polish", [False, True])
def test_pnp_batch_cuda_matches_cpu(dev, polish):
    """``absolute_pose_estimation_batch`` (staged: P3P, then the full
    program for queries below the bar) on the card against the CPU: the same
    success, inlier counts within 1, each pose explains all but one of the
    other's inliers, and rotations / translations within 5e-2 (unpolished)
    and 1e-2 (polished): a pose is the first of several tied minimal-sample
    hypotheses, float32 rounding can change which comes first, and the
    polish's Cauchy scale comes from the pose it starts at (the limits of
    ``chip_smoke.py`` phase 14)."""
    import numpy as np

    from pixsfm_tpu_torch.localization import absolute_pose_estimation_batch
    from pixsfm_tpu_torch.localization.pnp import _reproj_errors
    queries = _pnp_queries()
    o_d = absolute_pose_estimation_batch(queries, polish=polish,
                                         device="cuda")
    o_c = absolute_pose_estimation_batch(queries, polish=polish, device="cpu")
    tol = 1e-2 if polish else 5e-2
    for a, b, q in zip(o_d, o_c, queries):
        assert a["success"] == b["success"]
        if not b["success"]:
            continue
        assert abs(a["num_inliers"] - b["num_inliers"]) <= 1
        for x, y in ((a, b), (b, a)):
            err = _reproj_errors(q["camera"], x["qvec"], x["tvec"],
                                 q["points3D"], q["points2D"])
            assert int((y["inliers"] & ~(err < 12.0)).sum()) <= 1
        dot = abs(float(np.dot(a["qvec"], b["qvec"])))
        assert 2 * np.arccos(min(dot, 1.0)) <= tol
        assert np.linalg.norm(a["tvec"] - b["tvec"]) <= tol * max(
            np.linalg.norm(b["tvec"]), 1.0)


def test_minimal_solvers_degenerate_samples_cuda(dev):
    """P3P, the DLT and the homography on degenerate samples (coincident
    points, collinear points, points behind the camera) on the card: every
    hypothesis flagged ok is finite, and coincident samples are never ok."""
    from pixsfm_tpu_torch.localization import pnp
    gen = torch.Generator().manual_seed(3)
    B = 64
    X = torch.rand((B, 6, 3), generator=gen) * 2 - 1
    X[..., 2] += 5.0
    coinc = X.clone()
    coinc[:, 1] = coinc[:, 0]
    coinc[:, 2] = coinc[:, 0]
    lam = torch.rand((B, 6, 1), generator=gen)
    collin = X[:, :1] + lam * (X[:, 1:2] - X[:, :1])
    behind = X.clone()
    behind[..., 2] = -behind[..., 2]
    for Xs in (coinc, collin, behind):
        su = Xs[..., :2] / Xs[..., 2:]
        for solver in (pnp._p3p_batch, pnp._dlt_batch, pnp._homography_batch):
            R, t, ok = solver(su.to(dev), Xs.to(dev))
            fin = torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
            assert bool((fin | ~ok).all()), solver.__name__
            if Xs is coinc and solver is pnp._p3p_batch:
                assert not bool(ok.any())


@pytest.mark.parametrize("rootsift,bs", [(True, 4), (False, 3)])
def test_dsift_cuda_matches_cpu(dev, rootsift, bs):
    """Dense SIFT on the card (cuDNN depthwise convolutions, TF32 off)
    against the CPU on a 240x320 image: within 1e-4 (RootSIFT's square root
    lifts differences of 1e-8 near zero to 1e-4)."""
    from pixsfm_tpu_torch.features.models.dsift import DSIFT
    gen = torch.Generator().manual_seed(1)
    img = torch.rand((1, 3, 240, 320), generator=gen)
    conf = {"rootsift": rootsift, "spatial_bin_size": bs}
    a = DSIFT(conf, device="cpu")(img)[0]
    b = DSIFT(conf, device="cuda")(img.to(dev))[0].cpu()
    torch.testing.assert_close(b, a, atol=1e-4, rtol=0)
