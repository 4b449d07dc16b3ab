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
    (64, 16, False, "vector"),       # VGGNet's 64: 8 units a pixel
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
    """The C entry point picks the narrow variant for bf16 and f32 rows of
    1 to 8 channels, the vector one for 64 and 128, the wide one for 256
    and 512, the general one otherwise."""
    want = {1: "narrow", 3: "narrow", 5: "narrow", 8: "narrow",
            64: "vector", 128: "vector", 256: "wide", 512: "wide"}
    for dtype in (torch.bfloat16, torch.float32):
        for C in (1, 3, 5, 8, 9, 20, 32, 64, 128, 136, 256, 384, 512):
            rows = torch.zeros((16, 16, C), device=dev, dtype=dtype)
            assert interpolate_cuda.kernel_variant(rows) == \
                want.get(C, "general"), (dtype, C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("C,misaligned,variant", [
    (64, False, "vector"),      # VGGNet's conv1_2
    (64, True, "general"),
    (256, False, "wide"),       # VGGNet's conv3_3
    (256, True, "general"),
    (512, False, "wide"),       # VGGNet's conv5_3, D2-Net
    (512, True, "general"),
    (384, False, "general"),    # past 256, no vector width
])
def test_k1_wide_maps_match_plain(dev, dtype, l2, C, misaligned, variant):
    """K1 at the widths of VGGNet's and D2-Net's maps, each variant that
    takes them."""
    rows, row_base, r, c = _k1_inputs(dev, dtype, n_patches=24, n=777,
                                      C=C, misaligned=misaligned)
    assert interpolate_cuda.kernel_variant(rows) == variant
    before = interpolate_cuda.launches
    out = interpolate_cuda.interpolate_rows(rows, 16, 16, C, row_base, r, c,
                                            l2)
    ref = interpolate_cuda.interpolate_rows_plain(rows, 16, 16, C, row_base,
                                                  r, c, l2)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before + 1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=K1_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
def test_k1_dense_query_map_matches_plain(dev, dtype, l2):
    """K1 on one whole 1200x1600x128 map read as a single patch, as QKA and
    QBA read a query's dense map (``overwrite_features_sparse: false``, the
    ETH3D preset's), queries over the map and past its border."""
    gen = torch.Generator(device=dev).manual_seed(4)
    H, W, C, n = 1200, 1600, 128, 1000
    rows = torch.randn((H, W, C), generator=gen, device=dev).to(dtype)
    r = torch.rand(n, generator=gen, device=dev) * (H + 2.0) - 1.5
    c = torch.rand(n, generator=gen, device=dev) * (W + 2.0) - 1.5
    r[:2] = torch.tensor([0.0, H - 1.0])
    c[:2] = torch.tensor([W - 1.0, 0.0])
    row_base = torch.zeros(n, device=dev, dtype=torch.int32)
    assert interpolate_cuda.kernel_variant(rows) == "vector"
    before = interpolate_cuda.launches
    out = interpolate_cuda.interpolate_rows(rows, H, W, C, row_base, r, c,
                                            l2)
    ref = interpolate_cuda.interpolate_rows_plain(rows, H, W, C, row_base,
                                                  r, c, l2)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before + 1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=K1_ATOL[dtype], rtol=0)


def _k1_rect_inputs(dev, dtype, H, W, C, n, misaligned, seed, n_patches=40,
                    nodes=None, intensities=False):
    """K1 inputs on ``n_patches`` HxWxC patches of N(0, 1) values (of
    intensities uniform in [0.25, 1) with ``intensities``): queries uniform
    over each patch and up to 1.5 px past it, the first six on its corners
    and edges (every tap clamped at some border); with ``nodes``, ``n``
    centres expanded into their node windows on their own patch row, as
    ``interpolate_node_rows`` lays them out."""
    from pixsfm_tpu_torch.base.interpolation import node_queries
    gen = torch.Generator(device=dev).manual_seed(seed)
    numel = n_patches * H * W * C
    if intensities:
        buf = 0.25 + 0.75 * torch.rand(numel + 8, generator=gen, device=dev)
    else:
        buf = torch.randn(numel + 8, generator=gen, device=dev)
    buf = buf.to(dtype)
    rows = (buf[1:numel + 1] if misaligned else buf[:numel]).view(
        n_patches * H, W, C)
    row_base = torch.randint(0, n_patches, (n,), generator=gen,
                             device=dev) * H
    r = torch.rand(n, generator=gen, device=dev) * (H + 2.0) - 1.5
    c = torch.rand(n, generator=gen, device=dev) * (W + 2.0) - 1.5
    k = min(n, 6)
    r[:k] = torch.tensor([0.0, H - 1.0, -1.5, H + 0.5, 0.25, H - 1.25])[:k]
    c[:k] = torch.tensor([W - 1.0, 0.0, -1.5, W + 0.5, W - 1.5, 0.5])[:k]
    if nodes is not None:
        row_base, r, c = node_queries(row_base, r, c, nodes)
    return rows, row_base, r, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_l2_narrow_widths_against_float64(dev, dtype):
    """K1 with L2 at 1-3 channels on zero-crossing N(0, 1) maps (1501
    queries over 40 16x16 patches, up to 1.5 px past the border), where
    ||f|| comes near 0 and float32 orders part: the narrow variant's (it
    sums in double with L2 on) largest error against the plain version
    computed in float64 is at most twice the float32 plain version's, over
    three seeds. ``-s`` prints it beside the general variant's (forced; it
    sums in float32) and the plain version's."""
    H = W = 16
    n, n_patches = 1501, 40
    for C, seed in ((C, seed) for C in (1, 2, 3) for seed in (20, 21, 22)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = torch.randn((n_patches * H, W, C), generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
        rb = torch.randint(0, n_patches, (n,), generator=gen,
                           device=dev) * H
        r = torch.rand(n, generator=gen, device=dev) * (H + 2.0) - 1.5
        c = torch.rand(n, generator=gen, device=dev) * (W + 2.0) - 1.5
        args = (rows, H, W, C, rb, r, c, True)
        ref = interpolate_cuda.interpolate_rows_plain(*args,
                                                      dtype=torch.float64)
        errs = {}
        for name, out in (
                ("narrow", interpolate_cuda.interpolate_rows(
                    *args, variant="narrow")),
                ("general", interpolate_cuda.interpolate_rows(
                    *args, variant="general")),
                ("plain f32", interpolate_cuda.interpolate_rows_plain(*args))):
            assert all(a.dtype == torch.float32 for a in out)
            errs[name] = max(float((a.double() - b).abs().max())
                             for a, b in zip(out, ref))
        print(f"K1 L2 C={C} {dtype} seed {seed}: max |. - float64| {errs}")
        assert errs["narrow"] <= 2 * errs["plain f32"]


def test_patch_api_launches_k1(dev):
    """The patch API on CUDA tensors: one K1 launch per BICUBIC call
    (``interpolate`` / ``interpolate_with_grad`` / ``interpolate_nodes`` /
    ``interpolate_nodes_with_grad`` / ``bicubic_window_eval``, scalar or
    batched queries), none for BILINEAR, for ``cross=True`` or for a CPU
    patch; the results equal the CPU patch's within the K1 tolerances
    (NCC within 1e-4 of each array's largest entry)."""
    from pixsfm_tpu_torch.base import interpolation as api
    gen = torch.Generator(device=dev).manual_seed(5)
    patch = torch.randn((24, 20, 16), generator=gen, device=dev).to(
        torch.bfloat16)
    # inside, so that no NCC window is clamped flat past the border
    r = torch.rand((6, 7), generator=gen, device=dev) * 20.0 + 1.5
    c = torch.rand((6, 7), generator=gen, device=dev) * 16.0 + 1.5
    nodes = api.InterpolationConfig(ncc_normalize=True, l2_normalize=False,
                                    nodes=NODES16[:4])
    cases = [
        (lambda p, a, b: api.interpolate(p, a, b), 1, False),
        (lambda p, a, b: api.interpolate_with_grad(p, a, b), 1, False),
        (lambda p, a, b: api.interpolate_with_grad(p, 3.25, 4.5), 1, False),
        (lambda p, a, b: api.interpolate_nodes(p, a, b, nodes), 1, True),
        (lambda p, a, b: api.interpolate_nodes_with_grad(p, a, b, nodes), 1,
         True),
        (lambda p, a, b: api.interpolate_with_grad(p, a, b, nodes), 1, True),
        (lambda p, a, b: api.interpolate_with_grad(
            p, a, b, api.InterpolationConfig(mode="BILINEAR")), 0, False),
        (lambda p, a, b: api.interpolate_with_grad(p, a, b, cross=True), 0,
         False),
        (lambda p, a, b: api.bicubic_window_eval(
            p[None].expand(42, -1, -1, -1), a.reshape(-1), b.reshape(-1)), 1,
         False),
    ]
    for k, (fn, want, ncc) in enumerate(cases):
        before = interpolate_cuda.launches
        out = fn(patch, r, c)
        torch.cuda.synchronize()
        assert interpolate_cuda.launches - before == want, k
        cpu_before = interpolate_cuda.launches
        ref = fn(patch.cpu(), r.cpu(), c.cpu())
        assert interpolate_cuda.launches == cpu_before, k
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(out, ref):
            assert a.is_cuda and a.dtype == torch.float32 and \
                a.shape == b.shape, k
            atol = 1e-4 * float(b.abs().max()) if ncc else \
                K1_ATOL[torch.bfloat16]
            torch.testing.assert_close(a.cpu(), b, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("misaligned", [False, True])
def test_k1_narrow_matches_plain(dev, dtype, l2, C, misaligned):
    """The narrow variant (one thread per query, 1-8 channels, any base)
    against the plain version: 16x16 patches, W < 4 and H < 4 (every tap
    of an axis clamped), fewer queries than a warp and a ragged last warp,
    and 16 node queries per patch row.

    With L2 on, the maps hold intensities in [0.25, 1). L2 normalization
    divides by the norm ||f|| of the interpolated vector, so its
    derivatives grow as 1 / ||f|| and two float32 sums in different orders
    part by ~1e-7 / ||f||^2: at 1-3 channels of zero-mean or dark values
    ||f|| comes near 0 often enough that no two implementations agree
    within 2e-5. ``scripts/k1_l2_conditioning.py`` shows it: on N(0, 1)
    and [0, 1) maps the general kernel is as far from the plain version
    as this one (up to 3.9e-3), on [0.25, 1) maps both are within 5.1e-7.
    Wider maps keep ||f|| near sqrt(C), where the tolerance was set."""
    shapes = [(16, 16, 1501, None), (3, 3, 777, None), (16, 2, 333, None),
              (1, 5, 200, None), (16, 16, 5, None), (16, 16, 130, NODES16)]
    for i, (H, W, n, nodes) in enumerate(shapes):
        rows, row_base, r, c = _k1_rect_inputs(
            dev, dtype, H, W, C, n, misaligned, seed=10 * C + i, nodes=nodes,
            intensities=l2)
        assert (rows.data_ptr() % 16 != 0) == misaligned
        assert interpolate_cuda.kernel_variant(rows) == "narrow"
        before = interpolate_cuda.launches
        out = interpolate_cuda.interpolate_rows(rows, H, W, C, row_base, r,
                                                c, l2)
        ref = interpolate_cuda.interpolate_rows_plain(rows, H, W, C,
                                                      row_base, r, c, l2)
        torch.cuda.synchronize()
        assert interpolate_cuda.launches == before + 1
        for a, b in zip(out, ref):
            assert a.shape == (r.shape[0], C)
            torch.testing.assert_close(a, b, atol=K1_ATOL[dtype], rtol=0,
                                       msg=lambda m: f"{H}x{W} n={n}: {m}")


@pytest.mark.parametrize("C,misaligned,runs,refuses", [
    (3, False, ("narrow", "general"), ("vector", "wide")),
    (3, True, ("narrow", "general"), ("vector", "wide")),
    (64, False, ("vector", "general"), ("narrow", "wide")),
    (64, True, ("general",), ("vector", "wide", "narrow")),
    (128, False, ("vector", "general"), ("narrow", "wide")),
    (256, False, ("wide", "general"), ("narrow", "vector")),
    (20, False, ("general",), ("narrow", "vector", "wide")),
])
def test_k1_forced_variant(dev, C, misaligned, runs, refuses):
    """``interpolate_rows(..., variant=)`` launches the variant it names
    where that variant takes the rows (each agrees with the plain version
    and counts one launch), and raises where it does not."""
    rows, row_base, r, c = _k1_rect_inputs(dev, torch.bfloat16, 16, 16, C,
                                           300, misaligned, seed=C)
    ref = interpolate_cuda.interpolate_rows_plain(rows, 16, 16, C, row_base,
                                                  r, c, True)
    for variant in runs:
        before = interpolate_cuda.launches
        out = interpolate_cuda.interpolate_rows(rows, 16, 16, C, row_base, r,
                                                c, True, variant=variant)
        torch.cuda.synchronize()
        assert interpolate_cuda.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=5e-3, rtol=0)
    for variant in (*refuses, "fused"):
        with pytest.raises(ValueError):
            interpolate_cuda.interpolate_rows(rows, 16, 16, C, row_base, r,
                                              c, True, variant=variant)


def test_k1_rejects_more_than_512_channels(dev):
    rows, row_base, r, c = _k1_inputs(dev, torch.bfloat16, n_patches=2, n=8,
                                      C=520)
    with pytest.raises(ValueError):
        interpolate_cuda.interpolate_rows(rows, 16, 16, 520, row_base, r, c,
                                          True)


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


# ---------------------------------------------------------------------------
# localization: the fixed-target solver (K1), QKA, QBA, the localizer
# ---------------------------------------------------------------------------

def test_evaluate_descriptors_through_k1_matches_plain(dev):
    """``evaluate_descriptors`` launches K1 once per chunk of 1024 queries
    and agrees with the plain version on the CPU (float32, 2e-5)."""
    import numpy as np
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    from pixsfm_tpu_torch.keypoint_adjustment.solver import \
        evaluate_descriptors
    rng = np.random.default_rng(2)
    patches = rng.normal(size=(300, 16, 16, 128)).astype(np.float32)
    n = 2500
    rows = rng.integers(0, 300, n)
    corners = rng.integers(0, 1500, (300, 2)).astype(np.float32)
    kps = corners[rows] + 0.5 + rng.uniform(-1, 17, (n, 2))
    args = (rows, kps, corners[rows], np.ones((n, 2), np.float32),
            np.ones(n, np.float32), InterpolationConfig())
    before = interpolate_cuda.launches
    got = evaluate_descriptors(torch.as_tensor(patches, device=dev), *args)
    assert interpolate_cuda.launches == before + 3
    want = evaluate_descriptors(patches, *args, device="cpu")
    np.testing.assert_allclose(got, want, atol=2e-5)


def _loc_scene(seed=31, n_images=6, n_points=60, C=16, ps=16, qid=6):
    """A featuremetric scene in the port's data model alone (the card has
    no JAX): linear descriptor fields anchored at each point's true
    projection; image ``qid`` held out as the query. Returns (the model
    without it, its feature manager, the query's (camera, true pose,
    correspondences, keypoints moved by U(-1, 1) px, featuremap))."""
    import numpy as np
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap, FeatureSet
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=n_images, n_points=n_points,
                                   noise_px=0.0, seed=seed)
    rng = np.random.default_rng(seed)
    sig = {p: rng.normal(0, 1, C) for p in rec.points3D}
    grad = {p: rng.normal(0, 0.1, (C, 2)) for p in rec.points3D}
    fset = FeatureSet(C, ps, "float32")
    rr, cc = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    for im in rec.images.values():
        ids, patches, corners = [], [], []
        for idx, pid in enumerate(im.point3D_ids):
            if pid < 0:
                continue
            xy = im.xys[idx]
            corner = np.floor(xy - ps / 2).astype(np.int64)
            dx = corner[0] + cc + 0.5 - xy[0]
            dy = corner[1] + rr + 0.5 - xy[1]
            patches.append(sig[pid] + grad[pid][:, 0] * dx[..., None]
                           + grad[pid][:, 1] * dy[..., None])
            ids.append(idx)
            corners.append(corner)
        fset.emplace(im.name, FeatureMap.from_arrays(
            np.stack(patches).astype(np.float32), ids, np.stack(corners),
            np.ones(2)))
    query = rec.images[qid]
    model = rec.copy()
    for p in model.points3D.values():
        p.track = [(i, j) for (i, j) in p.track if i != qid]
    del model.images[qid]
    model.points3D = {p: v for p, v in model.points3D.items()
                      if v.track_length >= 2}
    p2D = [i for i, p in enumerate(query.point3D_ids)
           if p >= 0 and p in model.points3D]
    p3D = [int(query.point3D_ids[i]) for i in p2D]
    kps = query.xys.copy()
    kps[p2D] += rng.uniform(-1, 1, (len(p2D), 2))

    class _Manager:
        num_levels = 1

        def fset(self, level):
            return fset

    return model, _Manager(), (rec.cameras[query.camera_id],
                               (query.qvec, query.tvec), p2D, p3D, kps,
                               fset.get_map(query.name))


def _loc_conf(qba_steps=10):
    return {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
            "references": {"iters": 20, "keep_observations": True},
            "QKA": {"optimizer": {"solver": {"max_num_iterations": 20}}},
            "QBA": {"optimizer": {"solver": {
                "max_num_iterations": qba_steps}}}}


def test_qka_and_qba_cuda_match_cpu(dev):
    """QKA (fixed-target LM through K1) and QBA (exact Newton steps) on the
    card against the CPU on the same query: keypoints within 1e-3 px,
    poses within 1e-4, costs rtol 1e-4."""
    import numpy as np
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap
    from pixsfm_tpu_torch.localization import (QueryBundleAdjuster,
                                               QueryKeypointAdjuster,
                                               QueryLocalizer)
    model, mgr, (cam, (qv, tv), p2D, p3D, kps, fmap) = _loc_scene()
    loc = QueryLocalizer(model, _loc_conf(), dense_features=mgr,
                         device="cpu")
    refs = [loc.references[0][p].descriptor for p in p3D]
    X = [model.points3D[p].xyz for p in p3D]
    card = dev.type
    fmaps = {"cpu": fmap, card: FeatureMap(fmap.patches.to(dev),
                                           fmap.keypoint_ids(),
                                           fmap.corners, fmap.scale)}
    kp, qka_out, qba_out = {}, {}, {}
    for d in ("cpu", card):
        kp[d] = kps[p2D].copy()
        before = interpolate_cuda.launches
        qka_out[d] = QueryKeypointAdjuster(_loc_conf()["QKA"], device=d) \
            .refine(kp[d], fmaps[d], refs, p2D)
        if d == "cuda":
            assert interpolate_cuda.launches > before
        qba_out[d] = QueryBundleAdjuster(_loc_conf()["QBA"], device=d) \
            .refine(qv + 1e-3, tv + 5e-3, cam, X, fmaps[d], refs,
                    point2D_idxs=p2D)
    np.testing.assert_allclose(kp[card], kp["cpu"], atol=1e-3)
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(qka_out[card][key], qka_out["cpu"][key],
                                   rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(qba_out[card][key], qba_out["cpu"][key],
                                   rtol=1e-4, atol=1e-8)
    for key in ("qvec", "tvec"):
        np.testing.assert_allclose(qba_out[card][key], qba_out["cpu"][key],
                                   atol=1e-4)


def test_localize_cuda_matches_cpu(dev):
    """``QueryLocalizer.localize`` and ``localize_batch`` on the card
    against the CPU: the same success and inliers, poses within 1e-4."""
    import numpy as np
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap
    from pixsfm_tpu_torch.localization import QueryLocalizer
    model, mgr, (cam, gt, p2D, p3D, kps, fmap) = _loc_scene()
    out = {}
    for d in ("cpu", dev.type):
        loc = QueryLocalizer(model, _loc_conf(), dense_features=mgr,
                             device=d)
        fm = FeatureMap(fmap.patches.to(d), fmap.keypoint_ids(),
                        fmap.corners, fmap.scale)
        out[d] = [loc.localize(kps, p2D, p3D, cam, query_fmaps=[fm])] \
            + loc.localize_batch([dict(keypoints=kps, pnp_point2D_idxs=p2D,
                                       pnp_points3D_id=p3D,
                                       query_camera=cam,
                                       query_fmaps=[fm])])
    for a, b in zip(out[dev.type], out["cpu"]):
        assert a["success"] and b["success"]
        assert a["inliers"] == b["inliers"]
        np.testing.assert_allclose(a["qvec"], b["qvec"], atol=1e-4)
        np.testing.assert_allclose(a["tvec"], b["tvec"], atol=1e-4)
        np.testing.assert_allclose(a["tvec"], gt[1], atol=0.05)


# ---------------------------------------------------------------------------
# the low_memory preset: K1 at 8 x 8 x 128, costmap extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
def test_k1_low_memory_shape_matches_plain(dev, dtype, l2):
    """K1 on the ``low_memory`` preset's patches (8 x 8 x 128), queries on
    and beyond the border: the vector variant, within the tolerances of
    the 16 px shape."""
    rows, row_base, r, c = _k1_inputs(dev, dtype, n_patches=300, n=3000,
                                      ps=8)
    assert interpolate_cuda.kernel_variant(rows) == "vector"
    out = interpolate_cuda.interpolate_rows(rows, 8, 8, 128, row_base, r, c,
                                            l2)
    ref = interpolate_cuda.interpolate_rows_plain(rows, 8, 8, 128, row_base,
                                                  r, c, l2)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=K1_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("up,cross", [(1, False), (1, True), (2, False)])
def test_costmap_patches_cuda_matches_cpu(dev, up, cross):
    """``costmap_patches`` on bf16 patches of 8 x 8 x 128 on the card
    against the CPU from identical inputs, in several chunks: within 1e-5
    of the largest absolute value (up = 2 reads the patches through K1)."""
    from pixsfm_tpu_torch.base.losses import make_loss
    from pixsfm_tpu_torch.bundle_adjustment import costmaps
    gen = torch.Generator().manual_seed(3)
    patches = torch.nn.functional.normalize(
        torch.randn((400, 8, 8, 128), generator=gen), dim=-1) \
        .to(torch.bfloat16)
    rows = torch.randint(0, 400, (700,), generator=gen)
    targets = patches[rows, 4, 4].float() \
        + 0.05 * torch.randn((700, 128), generator=gen)
    loss = make_loss({"name": "cauchy", "params": [0.25]})
    before = interpolate_cuda.launches
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = costmaps.costmap_patches(
            patches.to(d), rows.to(d), targets.to(d), loss, True, cross, up)
    got, want = out[str(dev)].cpu(), out["cpu"]
    assert got.shape == (700, 8 * up, 8 * up, 4 if cross else 3)
    assert (interpolate_cuda.launches > before) == (up > 1)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the photometric preset: node windows at C = 3 and patch-warp BA
# ---------------------------------------------------------------------------

NODES16 = [[float(dx), float(dy)] for dy in (-1.5, -0.5, 0.5, 1.5)
           for dx in (-1.5, -0.5, 0.5, 1.5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ncc", [False, True])
def test_k1_node_windows_match_plain(dev, dtype, ncc):
    """``interpolate_node_rows`` at the photometric shape (16x16x3 windows,
    16 nodes per query, up to 1.5 px past the border; the narrow variant)
    in one launch, against the plain version at the K1 tolerances; with
    NCC across the nodes within 1e-4 (NCC divides by each channel's spread
    over the nodes)."""
    from pixsfm_tpu_torch.base.interpolation import (
        InterpolationConfig, interpolate_node_rows_with_grad,
        ncc_normalize_with_grad)
    rows, row_base, r, c = _k1_inputs(dev, dtype, n_patches=300, n=2000,
                                      C=3)
    assert interpolate_cuda.kernel_variant(rows) == "narrow"
    before = interpolate_cuda.launches
    out = interpolate_cuda.interpolate_node_rows(rows, 16, 16, 3, row_base,
                                                 r, c, NODES16, False)
    if ncc:
        g, d = ncc_normalize_with_grad(out[0], out[1:])
        out = (g, *d)
    ref = interpolate_node_rows_with_grad(
        rows.cpu(), 16, 16, 3, row_base.cpu(), r.cpu(), c.cpu(),
        InterpolationConfig(l2_normalize=False, ncc_normalize=ncc,
                            nodes=NODES16))
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before + 1
    for a, b in zip(out, ref):
        assert a.shape == (2000, 16, 3)
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 if ncc else K1_ATOL[dtype])


def _patch_warp_refine(device, joint, obs_chunk=8192):
    """``PatchWarpBundleAdjuster.refine`` (16 NCC nodes) on a synthetic
    scene whose windows are random waves around each point's true
    projection: (summary, points [Np, 3])."""
    import numpy as np
    from pixsfm_tpu_torch.bundle_adjustment import PatchWarpBundleAdjuster
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap, FeatureSet
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=5, n_points=60, noise_px=0.0,
                                   seed=23)
    ps, C = 16, 3
    fset = FeatureSet(C, ps, "half")
    rr, cc = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    for im in rec.images.values():
        ids = [k for k, p in enumerate(im.point3D_ids) if p >= 0]
        corners = np.floor(im.xys[ids] - ps / 2).astype(np.int64)
        patches = []
        for k, corner in zip(ids, corners):
            g = np.random.default_rng(int(im.point3D_ids[k]))
            dx = (corner[0] + cc + 0.5 - im.xys[k][0])[..., None]
            dy = (corner[1] + rr + 0.5 - im.xys[k][1])[..., None]
            # each channel a wave of 0.3-0.6 rad per pixel in a random
            # direction: NCC divides by the spread over the nodes, which
            # a near-flat channel would bring to ~0
            th, k = g.uniform(0, 2 * np.pi, C), g.uniform(0.3, 0.6, C)
            patches.append(0.5 + 0.2 * np.sin(
                k * (np.cos(th) * dx + np.sin(th) * dy) + g.uniform(0, 6, C)))
        fset.emplace(im.name, FeatureMap(
            torch.as_tensor(np.stack(patches), dtype=torch.bfloat16,
                            device=device), ids, corners, [1.0, 1.0]))
    rng = np.random.default_rng(23)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.004, 3)
    for iid in sorted(rec.images)[1:]:
        rec.images[iid].tvec = rec.images[iid].tvec + rng.normal(0, 0.004,
                                                                  3)
    class Adjuster(PatchWarpBundleAdjuster):
        def _ba_options(self, **kw):
            return super()._ba_options(obs_chunk=obs_chunk, **kw)

    out = Adjuster(
        {"optimizer": {"refine_extrinsics": joint,
                       "refine_focal_length": False,
                       "refine_extra_params": False,
                       "solver": {"max_num_iterations": 10}}},
        device=device).refine(rec, fset)
    return out, np.stack([rec.points3D[p].xyz for p in sorted(rec.points3D)])


@pytest.mark.parametrize("joint", [False, True])
def test_patch_warp_cuda_matches_cpu(dev, joint):
    """Patch-warp BA (bf16 windows read by K1, NCC, the dense step; with
    joint source poses the second pose block) on the card against the CPU:
    phase 8's limits, final cost rtol 1e-4, points 1e-3."""
    before = interpolate_cuda.launches
    out_d, x_d = _patch_warp_refine("cuda", joint)
    assert interpolate_cuda.launches > before
    out_c, x_c = _patch_warp_refine("cpu", joint)
    assert out_d["joint_source_poses"] is out_c["joint_source_poses"] is joint
    assert out_d["linear_solver"] == out_c["linear_solver"] == "dense"
    assert out_d["final_cost"] < out_d["initial_cost"]
    assert abs(out_d["final_cost"] - out_c["final_cost"]) \
        <= 1e-4 * out_c["final_cost"]
    assert float(abs(x_d - x_c).max()) <= 1e-3


@pytest.mark.parametrize("method", ["superpoint", "r2d2", "d2net"])
def test_detector_cuda_matches_cpu(dev, method):
    """Each detector on the card against the CPU on one seeded 96x128 image
    (convolutions with TF32 off on both), as ``chip_smoke.py`` phase 21(a)
    holds them: valid keypoint sets equal (D2-Net's detection cells; its
    sub-pixel Newton step moves positions by up to 1e-2 px), scores within
    1e-5 relative, descriptors within 1e-4 where positions agree within
    1e-3 px, which all but 1 % of the cells (at least one) must."""
    import numpy as np

    from pixsfm_tpu_torch.features.models import get_model

    conf = {"pretrained": None, "max_keypoints": 256}
    if method == "r2d2":
        conf.update(reliability_threshold=0.0, repeatability_threshold=0.0)
    img = np.random.default_rng(3).uniform(0, 1, (1, 96, 128, 3)).astype(
        np.float32)
    out = [get_model(method)(conf, device=d).detect(img)
           for d in ("cuda", "cpu")]
    stride, offset = (4, 1.5) if method == "d2net" else (1, 0.0)

    def keyed(o):
        v = o["valid"][0]
        kp, sc, de = (o[k][0][v] for k in ("keypoints", "scores",
                                           "descriptors"))
        cells = np.rint((kp - offset) / stride).astype(np.int64)
        return {tuple(c): (k, s, d) for c, k, s, d in zip(cells, kp, sc, de)}

    a, b = (keyed(o) for o in out)
    assert set(a) == set(b) and len(a) > 0
    top = max(abs(s) for _, s, _ in a.values())
    far = 0
    for c in a:
        dpos = float(np.abs(a[c][0] - b[c][0]).max())
        assert dpos <= (1e-2 if method == "d2net" else 0.0)
        assert abs(a[c][1] - b[c][1]) <= 1e-5 * top
        if dpos <= 1e-3:
            np.testing.assert_allclose(a[c][2], b[c][2], atol=1e-4)
        else:
            far += 1
    assert far <= max(1, 0.01 * len(a)), (far, len(a))


@pytest.mark.parametrize("pair", ["identical", "shifted"])
def test_loftr_cuda_matches_cpu(dev, pair):
    """LoFTR on the card against the CPU (float32, TF32 off on both) on a
    smooth seeded 96x128 pair at threshold 0, as ``chip_smoke.py`` phase
    22(a) holds it: coarse tokens within 1e-4 of the largest; the valid
    coarse index pairs equal but for at most 1 % of them (at least one:
    near-ties of the mutual maximum); on the common matches fine positions
    within 1e-3 px and confidences within 1e-4 of the largest."""
    import numpy as np
    import torch.nn.functional as F

    from pixsfm_tpu_torch.features.models.loftr import LoFTR

    g = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (14, 18)))
    big = F.interpolate(g[None, None], size=(112, 144), mode="bicubic",
                        align_corners=False)[0, 0].clamp(0, 1).float()
    img0 = big[:96, :128].contiguous()
    img1 = img0 if pair == "identical" else big[16:, 16:].contiguous()
    conf = {"pretrained": None, "max_matches": 1024, "match_threshold": 0.0}
    models = [LoFTR(conf, device=d) for d in ("cuda", "cpu")]
    toks = [m.coarse_features(m._image(img0), m._image(img1))[0].cpu()
            for m in models]
    top = float(toks[1].abs().max())
    assert float((toks[0] - toks[1]).abs().max()) <= 1e-4 * top

    def keyed(out):
        mk0, mk1, c, v = out
        return {(tuple(a.astype(int) // 8), tuple(np.rint(b / 8).astype(
            int))): (b, s) for a, b, s in zip(mk0[v], mk1[v], c[v])}

    a, b = (keyed(m.match_pair(img0, img1)) for m in models)
    common = set(a) & set(b)
    assert len(common) > 0
    assert len(set(a) ^ set(b)) <= max(1, 0.01 * len(set(a) | set(b)))
    top = max(s for _, s in b.values())
    for k in common:
        assert float(np.abs(a[k][0] - b[k][0]).max()) <= 1e-3
        assert abs(a[k][1] - b[k][1]) <= 1e-4 * top


# ---------------------------------------------------------------------------
# every interpolation config: node windows at 128 channels, the plain modes,
# forward mode through the kernel, block-Jacobi CG and the forward-mode BA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2,ncc", [(True, False), (False, True)])
def test_k1_node_rows_128_channels_match_plain(dev, dtype, l2, ncc):
    """``interpolate_cuda.interpolate_nodes`` (the solvers' node route) at
    128 channels and 16 nodes per query (the vector variant, one launch),
    against the plain version on the CPU: the K1 tolerances, NCC within
    1e-4 of each array's largest entry (it divides by each channel's
    spread over the nodes)."""
    from pixsfm_tpu_torch.base.interpolation import (
        InterpolationConfig, interpolate_node_rows_with_grad)
    rows, row_base, r, c = _k1_inputs(dev, dtype, n_patches=200, n=1000)
    assert interpolate_cuda.kernel_variant(rows) == "vector"
    interp = InterpolationConfig(l2_normalize=l2, ncc_normalize=ncc,
                                 nodes=NODES16)
    before = interpolate_cuda.launches
    out = interpolate_cuda.interpolate_nodes(rows, 16, 16, 128, row_base, r,
                                             c, interp)
    ref = interpolate_node_rows_with_grad(rows.cpu(), 16, 16, 128,
                                          row_base.cpu(), r.cpu(), c.cpu(),
                                          interp)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before + 1
    for a, b in zip(out, ref):
        assert a.shape == (1000, 16, 128)
        atol = 1e-4 * float(b.abs().max()) if ncc else K1_ATOL[dtype]
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["BILINEAR", "NEARESTNEIGHBOR",
                                  "BICUBICCHAIN"])
def test_plain_modes_never_launch_k1(dev, mode):
    """The modes that are XLA in the JAX package are plain PyTorch on the
    card too: no K1 launch, the CPU's numbers within 1e-5."""
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    rows, row_base, r, c = _k1_inputs(dev, torch.float32)
    interp = InterpolationConfig(mode=mode, nodes=NODES16[:4])
    before = interpolate_cuda.launches
    out = interpolate_cuda.interpolate(rows, 16, 16, 128, row_base, r, c,
                                       interp)
    ref = interpolate_cuda.interpolate(rows.cpu(), 16, 16, 128,
                                       row_base.cpu(), r.cpu(), c.cpu(),
                                       interp)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


def test_interpolate_fwd_through_k1_matches_cpu(dev):
    """Forward mode through the kernel (``interpolate_fwd`` under
    ``torch.func.jvp`` and ``vmap`` over three tangents): one launch, the
    CPU's value and tangents within the K1 tolerance."""
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    rows, row_base, r, c = _k1_inputs(dev, torch.float32)
    interp = InterpolationConfig(nodes=NODES16[:4])

    def jac(rows, row_base, r, c):
        def fn(d):
            return interpolate_cuda.interpolate_fwd(
                rows, 16, 16, 128, row_base, r + d[:, 0], c + d[:, 1],
                interp)
        d0 = torch.zeros((r.shape[0], 2), device=r.device)
        basis = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, -2.0]],
                             device=r.device)[:, None].expand(
                                 3, r.shape[0], 2)
        return torch.func.vmap(lambda t: torch.func.jvp(fn, (d0,), (t,)),
                               out_dims=(None, 0))(basis)

    before = interpolate_cuda.launches
    out = jac(rows, row_base, r, c)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches == before + 1
    ref = jac(rows.cpu(), row_base.cpu(), r.cpu(), c.cpu())
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("bs", [2, 4])
def test_block_jacobi_cuda_matches_cpu(dev, bs):
    """Block-Jacobi CG (plain PyTorch on every device) on the KA main
    path's system size, cuda against cpu: within 1e-4 relative."""
    from pixsfm_tpu_torch.ops.lm import block_jacobi_pcg
    gen = torch.Generator().manual_seed(5)
    A = torch.randn((16, 112, 112), generator=gen)
    H = A @ A.transpose(1, 2) / 112 + 0.5 * torch.eye(112)
    g = torch.randn((16, 112), generator=gen)
    damp = torch.rand((16, 112), generator=gen) * 0.1
    out = block_jacobi_pcg(H.to(dev), g.to(dev), 15, bs, damp=damp.to(dev))
    ref = block_jacobi_pcg(H, g, 15, bs, damp=damp)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def test_jacfwd_ba_solve_cuda_matches_cpu(dev):
    """``ba_solve`` without a closed-form Jacobian (forward mode over the
    residual) on cuda against cpu: the geometric residual on a synthetic
    scene, final cost rtol 1e-4, points within 1e-3."""
    import numpy as np
    from pixsfm_tpu_torch.base.losses import RobustLoss
    from pixsfm_tpu_torch.bundle_adjustment.main import _RESIDUAL_BUILDERS
    from pixsfm_tpu_torch.bundle_adjustment.problem import pack_ba_problem
    from pixsfm_tpu_torch.ops import schur
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=5, n_points=80, noise_px=0.4,
                                   seed=72)
    rng = np.random.default_rng(0)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.02, 3)
    packed = pack_ba_problem(rec)
    O = len(packed.obs_img)
    build, _ = _RESIDUAL_BUILDERS["geometric"]
    outs = []
    for d in (dev, torch.device("cpu")):
        def T(a, dtype=None):
            return torch.as_tensor(np.array(a), dtype=dtype, device=d)
        obs = schur.BAObservations(
            T(packed.obs_img, torch.long), T(packed.obs_cam, torch.long),
            T(packed.obs_pt, torch.long),
            (T(packed.obs_xy, torch.float32),),
            torch.ones(O, dtype=torch.bool, device=d))
        st, summ = schur.ba_solve(
            build(packed.cam_model), schur.BAState(
                T(packed.qvec, torch.float32), T(packed.tvec, torch.float32),
                T(packed.cams, torch.float32), T(packed.xyz, torch.float32)),
            obs, RobustLoss("cauchy", [2.0]), T(packed.pose_free),
            T(packed.tvec_free), T(packed.cam_free), T(packed.point_free),
            opts=schur.BAOptions(max_iterations=8, obs_chunk=64,
                                 linear_solver="cg"))
        outs.append((st, summ))
    (a, sa), (b, sb) = outs
    assert sa["final_cost"] < 0.5 * sa["initial_cost"]
    assert abs(sa["final_cost"] - sb["final_cost"]) <= 1e-4 * sb["final_cost"]
    torch.testing.assert_close(a.xyz.cpu(), b.xyz, rtol=0, atol=1e-3)


def test_sharded_ka_cuda_matches_unsharded(dev):
    """``sharded_ka_solve`` over a two-shard mesh that names the card twice
    (each shard's K1 reads and K2 solves launched on its own problems)
    against the unsharded solve on the card, with the same chunks:
    keypoints atol 5e-4, final cost rtol 1e-4
    (``tests/test_sharded_ba.py``'s limits)."""
    import numpy as np
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    from pixsfm_tpu_torch.base.losses import RobustLoss
    from pixsfm_tpu_torch.keypoint_adjustment.solver import (
        KAProblems, solve_ka_problems)
    from pixsfm_tpu_torch.ops.lm import LMOptions
    from pixsfm_tpu_torch.parallel import Mesh, sharded_ka_solve
    rng = np.random.default_rng(3)
    P, K, E, C, ps = 40, 24, 40, 128, 16       # N = 48: the CG path (K2)
    field = rng.normal(0, 1, (ps, ps, C)).astype(np.float32)
    patches = (field[None] + 0.05 * rng.normal(
        0, 1, (P * K, ps, ps, C))).astype(np.float32)
    kp0 = rng.uniform(5.0, 11.0, (P, K, 2)).astype(np.float32)
    problems = KAProblems(
        kp0=kp0, patch_row=np.arange(P * K).reshape(P, K),
        corner=np.zeros((P, K, 2), np.float32),
        scale=np.ones((P, K, 2), np.float32), ups=np.ones((P, K), np.float32),
        kp_free=np.ones((P, K), bool), kp_valid=np.ones((P, K), bool),
        edge_i=rng.integers(0, K, (P, E)), edge_j=rng.integers(0, K, (P, E)),
        edge_w=np.ones((P, E), np.float32), lower=kp0 - 3.0,
        upper=kp0 + 3.0, node_problem=np.zeros(1, np.int64),
        node_slot=np.zeros(1, np.int64), node_ids=np.zeros(1, np.int64))
    args = (torch.as_tensor(patches, device=dev),
            InterpolationConfig(mode="BICUBIC", l2_normalize=True),
            RobustLoss("cauchy", [0.25]),
            LMOptions(max_iterations=15, parameter_tolerance=1e-6))
    before = (interpolate_cuda.launches, cg_cuda.launches)
    kp_sh, sum_sh = sharded_ka_solve(problems, *args, Mesh([dev, dev]))
    torch.cuda.synchronize()
    assert interpolate_cuda.launches > before[0]
    assert cg_cuda.launches > before[1]
    kp_one, sum_one = solve_ka_problems(problems, *args, chunk=P // 2,
                                        device=dev)
    assert sum_sh["final_cost"] < sum_sh["initial_cost"]
    np.testing.assert_allclose(kp_sh, kp_one, atol=5e-4)
    np.testing.assert_allclose(sum_sh["final_cost"], sum_one["final_cost"],
                               rtol=1e-4)


def test_window_layout_ba_cuda_matches_unsharded(dev):
    """Feature-reference BA in its window layout over a two-shard mesh that
    names the card twice (each observation's window read by K1 on its
    shard, the references sharded by points) against the unsharded BA on
    the card: final cost rtol 1e-3, points atol 5e-3
    (``tests/test_parallel_pipeline.py``'s limits)."""
    import numpy as np
    from pixsfm_tpu_torch.bundle_adjustment import \
        FeatureReferenceBundleAdjuster
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap, FeatureSet
    from pixsfm_tpu_torch.parallel import Mesh
    model, mgr, _ = _loc_scene()
    cpu_set = mgr.fset(0)
    fset = FeatureSet(cpu_set.channels, cpu_set.patch_size, cpu_set.dtype)
    for name, m in cpu_set.maps.items():
        fset.emplace(name, FeatureMap(m.patches.to(dev), m.keypoint_ids(),
                                      m.corners, m.scale))
    rng = np.random.default_rng(5)
    for p in model.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.01, 3)
    rec_a, rec_b = model.copy(), model.copy()
    conf = {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
            "optimizer": {"solver": {"max_num_iterations": 10}}}

    class Sharded(FeatureReferenceBundleAdjuster):
        def _parallel_mesh(self):
            return Mesh([dev, dev])

    out_a = FeatureReferenceBundleAdjuster(conf, device=dev).refine(rec_a,
                                                                    fset)
    before = interpolate_cuda.launches
    out_b = Sharded(conf, device=dev).refine(rec_b, fset)
    torch.cuda.synchronize()
    assert interpolate_cuda.launches > before
    assert out_b["final_cost"] < out_b["initial_cost"]
    assert abs(out_b["final_cost"] - out_a["final_cost"]) \
        <= 1e-3 * out_a["final_cost"]
    pids = sorted(model.points3D)
    xa = np.stack([rec_a.points3D[p].xyz for p in pids])
    xb = np.stack([rec_b.points3D[p].xyz for p in pids])
    assert float(np.abs(xa - xb).max()) <= 5e-3


def test_parallel_knob_across_cards_matches_one_card(dev):
    """With two or more cards, the ``parallel`` knob with no ``n_devices``
    takes every card (``make_mesh``): KA's problems, feature-reference
    BA's observations (window layout) and references, and
    ``localize_batch``'s queries then run on distinct devices, and each
    result is held to the same call on one card with the limits of
    ``tests/test_parallel_pipeline.py`` (KA keypoints 5e-3 px and cost
    rtol 1e-3; BA cost rtol 1e-3, points 5e-3; localization: the same
    successes, qvec 2e-4, tvec 2e-3)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    import copy

    import numpy as np
    from pixsfm_tpu_torch.bundle_adjustment import \
        FeatureReferenceBundleAdjuster
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap, FeatureSet
    from pixsfm_tpu_torch.keypoint_adjustment import (
        FeatureMetricKeypointAdjuster, build_matching_graph)
    from pixsfm_tpu_torch.localization import QueryLocalizer
    n = torch.cuda.device_count()
    knob = {"parallel": {"enabled": True}}

    # KA: one track per problem and 8 problems per device chunk, so that
    # every card solves some
    rng = np.random.default_rng(7)
    C, ps, n_kps = 16, 16, 8 * (n + 1)
    field = rng.normal(0, 1, (96, 96, C)).astype(np.float32)
    xy = rng.uniform(ps, 96 - ps, (n_kps, 2))
    names = ["a.png", "b.png", "c.png"]
    fset_ka, kps0 = FeatureSet(C, ps, "float32"), {}
    for i, name in enumerate(names):
        kps0[name] = xy + (rng.uniform(-1, 1, xy.shape) if i else 0.0)
        corners = np.floor(kps0[name] - ps / 2).astype(np.int64)
        fset_ka.emplace(name, FeatureMap.from_arrays(
            np.stack([field[y:y + ps, x:x + ps] for x, y in corners]),
            list(range(n_kps)), corners, np.ones(2), device=dev))
    ident = np.stack([np.arange(n_kps)] * 2, axis=1)
    matches = {(a, b): ident for i, a in enumerate(names)
               for b in names[i + 1:]}

    class _One:
        num_levels = 1

        def __init__(self, fset):
            self._fset = fset

        def fset(self, level):
            return self._fset

    conf_ka = {"max_kps_per_problem": 3, "problem_chunk_size": 8}
    outs = []
    for conf in (conf_ka, dict(conf_ka, **knob)):
        adj = FeatureMetricKeypointAdjuster(conf, device=dev)
        k = {m: v.copy() for m, v in kps0.items()}
        o = adj.refine_multilevel(k, _One(fset_ka),
                                  build_matching_graph(matches))
        outs.append((k, float(np.sum(o["final_cost"])), adj))
    assert outs[1][2]._parallel_mesh().size == n
    assert abs(outs[1][1] - outs[0][1]) <= 1e-3 * abs(outs[0][1])
    for m in names:
        assert float(np.abs(outs[1][0][m] - outs[0][0][m]).max()) <= 5e-3

    # BA in the window layout, the references sharded too
    model, mgr, (cam, _, p2D, p3D, kps, qmap) = _loc_scene()
    cpu_set = mgr.fset(0)
    fset = FeatureSet(cpu_set.channels, cpu_set.patch_size, cpu_set.dtype)
    for name, m in cpu_set.maps.items():
        fset.emplace(name, FeatureMap(m.patches.to(dev), m.keypoint_ids(),
                                      m.corners, m.scale))
    rec_a, rec_b = model.copy(), model.copy()
    for r in (rec_a, rec_b):
        rng_p = np.random.default_rng(5)
        for pid in sorted(r.points3D):
            r.points3D[pid].xyz = r.points3D[pid].xyz + rng_p.normal(0, 0.01,
                                                                   3)
    conf_ba = {"interpolation": {"mode": "BICUBIC", "l2_normalize": True},
               "optimizer": {"solver": {"max_num_iterations": 10}}}
    out_a = FeatureReferenceBundleAdjuster(conf_ba, device=dev).refine(
        rec_a, fset)
    adj = FeatureReferenceBundleAdjuster(dict(conf_ba, **knob), device=dev)
    assert adj._parallel_mesh().size == n
    out_b = adj.refine(rec_b, fset)
    assert abs(out_b["final_cost"] - out_a["final_cost"]) \
        <= 1e-3 * out_a["final_cost"]
    pids = sorted(model.points3D)
    assert float(np.abs(np.stack([rec_a.points3D[p].xyz for p in pids])
                        - np.stack([rec_b.points3D[p].xyz for p in pids]))
                 .max()) <= 5e-3

    # localize_batch: QKA, PnP and QBA over the cards
    qfmap = FeatureMap(qmap.patches.to(dev), qmap.keypoint_ids(),
                       qmap.corners, qmap.scale)
    batch = [dict(keypoints=kps.copy(), pnp_point2D_idxs=p2D,
                  pnp_points3D_id=p3D, query_camera=cam,
                  query_fmaps=[qfmap])] * (n + 1)
    res = []
    for conf in (_loc_conf(), dict(copy.deepcopy(_loc_conf()), **knob)):
        loc = QueryLocalizer(model, conf=conf, dense_features=mgr,
                             device=dev)
        res.append(loc.localize_batch([dict(b, keypoints=b["keypoints"]
                                            .copy()) for b in batch]))
    assert loc._parallel_mesh().size == n
    for a, b in zip(*res):
        assert a["success"] and b["success"]
        np.testing.assert_allclose(b["qvec"], a["qvec"], atol=2e-4)
        np.testing.assert_allclose(b["tvec"], a["tvec"], atol=2e-3)


def _views(n, h, w, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {f"v{i}.png": rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for i in range(n)}


def test_batched_extraction_cuda_matches_cpu(dev):
    """``batch_size: 3`` over five views (groups of three and two) on the
    card against the CPU, and against ``batch_size: 1`` on the card: the
    same ids and corners, patches within one bf16 step (4e-3 at unit
    norm; cuDNN may choose other convolution algorithms per batch size)."""
    import numpy as np

    from pixsfm_tpu_torch.extract import features_from_image_list
    from pixsfm_tpu_torch.features.extractor import FeatureExtractor

    views = _views(5, 120, 160)
    rng = np.random.default_rng(1)
    kps = {n: rng.uniform([2, 2], [158, 118], (40, 2)) for n in views}
    out = {}
    for device, bs in (("cuda", 3), ("cpu", 3), ("cuda", 1)):
        ext = FeatureExtractor({"batch_size": bs}, device=device)
        out[device, bs] = features_from_image_list(ext, list(views), views,
                                                   kps)
    ref = out["cuda", 3].fset(0)
    for key in (("cpu", 3), ("cuda", 1)):
        other = out[key].fset(0)
        for n in views:
            a, b = ref.get_map(n), other.get_map(n)
            assert a.keypoint_ids() == b.keypoint_ids()
            np.testing.assert_array_equal(a.corners, b.corners)
            torch.testing.assert_close(a.patches.float().cpu(),
                                       b.patches.float().cpu(), atol=4e-3,
                                       rtol=0)


def test_s2dnet_combine_cuda_matches_cpu(dev):
    """``S2DNet(combine=True, num_layers=3)`` on the card against the CPU
    (float32, TF32 off on both) on a 100x76 image (non-integer ratios to
    the coarse levels), within 1e-4 of the largest value."""
    import numpy as np

    from pixsfm_tpu_torch.features.models.s2dnet import S2DNet

    img = np.random.default_rng(2).uniform(0, 1, (76, 100, 3)).astype(
        np.float32)
    conf = {"num_layers": 3, "combine": True, "pretrained": None}
    with torch.no_grad():
        outs = [S2DNet(conf, device=d)(
            torch.from_numpy(img).permute(2, 0, 1)[None].to(d))[0].cpu()
            for d in ("cuda", "cpu")]
    assert outs[0].shape == (1, 128, 76, 100)
    top = float(outs[1].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4 * top
