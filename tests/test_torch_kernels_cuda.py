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

from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda

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
