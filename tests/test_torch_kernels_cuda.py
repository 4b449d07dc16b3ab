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


def _k1_inputs(dev, dtype, n_patches=64, n=1000, ps=16, C=128):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((n_patches * ps, ps, C), generator=gen,
                       device=dev).to(dtype)
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


def test_k3_rejects_bad_layout(dev):
    vpT, vcT, Btr, img_r, cam_r, Vi, _ = _k3_inputs(dev, 4, 13, 3)
    with pytest.raises(ValueError, match="int32"):
        schur_cuda.schur_backsub(vpT, vcT, Btr, img_r.long(), cam_r, T=4,
                                 I=13, Nc=3, k=4)
