"""Port parity: the feature interpolation modes beyond the Catmull-Rom
window and the node-aware reads, against the JAX package on the CPU.

- BILINEAR, NEARESTNEIGHBOR and BICUBICCHAIN (``base.interpolation.
  mode_eval_rows`` / ``interpolate_rows_with_grad``): value and both
  derivatives against JAX's ``interpolate_with_grad`` per query, L2 on and
  off, queries inside, on cell borders and beyond the patch (clamped
  reads): atol 2e-5 with float32 patches, as
  ``tests/test_torch_interpolation.py``.
- ``ops/interpolate_cuda.interpolate`` (the solvers' one route) with 2x2
  node windows, with and without NCC, BICUBIC and BILINEAR, against JAX's
  ``interpolate_residual_with_grad`` (flattened ``[n_nodes * C]``): 2e-5,
  NCC 1e-4 of each array's largest entry (it divides the rounding by the
  window's spread: beyond the patch the clamped windows are nearly flat,
  and their derivatives reach ~33), on textured patches; only BICUBIC
  calls the kernel's wrapper.
- ``interpolate_nodes`` (the reference extraction's read) with one node
  and NCC against JAX's ``interpolate_nodes``: NCC over one node is 0.
- ``interpolate_fwd`` under ``torch.func.jvp``: the tangent is the read's
  own derivative (bilinear's forward difference), as the JAX package's
  custom JVP: 2e-5 (BICUBIC's takes K1's derivatives; the NCC
  feature-reference BA of ``tests/test_torch_ba_jacfwd.py`` holds it to
  JAX through whole solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
from pixsfm_tpu.base.interpolation import (interpolate_nodes,
                                           interpolate_residual,
                                           interpolate_residual_with_grad,
                                           interpolate_with_grad)
from pixsfm_tpu_torch.base.interpolation import (InterpolationConfig,
                                                 interpolate_rows_with_grad)
from pixsfm_tpu_torch.ops import interpolate_cuda
from tests.test_torch_localization import _one_torch_thread  # noqa: F401

NODES4 = [[-0.5, -0.5], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]
ATOL = 2e-5


def _inputs(seed=0, P=4, ps=12, C=6, n=40):
    """Textured float32 patches and queries: inside, on integer cell
    borders, and up to 1.5 px beyond the patch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    patches = np.stack([np.stack([
        np.sin(rng.uniform(0.3, 0.9) * xx + rng.uniform(0.3, 0.9) * yy
               + rng.uniform(0, 6)) for _ in range(C)], -1)
        for _ in range(P)]).astype(np.float32)
    row = rng.integers(0, P, n)
    r = rng.uniform(-1.5, ps + 0.5, n).astype(np.float32)
    c = rng.uniform(-1.5, ps + 0.5, n).astype(np.float32)
    r[:6] = np.floor(r[:6])
    c[6:12] = np.floor(c[6:12])
    return patches, row, r, c


def _jax(patches, row, r, c, fn):
    out = jax.vmap(lambda i, rr, cc: fn(jnp.asarray(patches)[i], rr, cc))(
        jnp.asarray(row), jnp.asarray(r), jnp.asarray(c))
    if isinstance(out, (tuple, list)):
        return [np.asarray(a) for a in out]
    return [np.asarray(out)]


def _port_args(patches, row, r, c):
    P, H, W, C = patches.shape
    return (torch.from_numpy(patches).reshape(P * H, W, C), H, W, C,
            torch.from_numpy(row * H), torch.from_numpy(r),
            torch.from_numpy(c))


@pytest.mark.parametrize("mode", ["BILINEAR", "NEARESTNEIGHBOR",
                                  "BICUBICCHAIN"])
@pytest.mark.parametrize("l2", [False, True])
def test_modes_match_jax(mode, l2):
    patches, row, r, c = _inputs()
    kw = dict(mode=mode, l2_normalize=l2)
    want = _jax(patches, row, r, c, lambda p, rr, cc: interpolate_with_grad(
        p, rr, cc, JInterp(**kw)))
    got = interpolate_rows_with_grad(*_port_args(patches, row, r, c),
                                     InterpolationConfig(**kw))
    for a, b in zip(got, want):
        assert a.shape == b.shape == (len(r), 1 if mode == "BICUBICCHAIN"
                                      else patches.shape[-1])
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)


@pytest.mark.parametrize("mode", ["BICUBIC", "BILINEAR"])
@pytest.mark.parametrize("ncc", [False, True])
def test_node_residual_route_matches_jax(monkeypatch, mode, ncc):
    patches, row, r, c = _inputs(seed=1)
    kw = dict(mode=mode, l2_normalize=not ncc, ncc_normalize=ncc,
              nodes=NODES4)
    want = _jax(patches, row, r, c,
                lambda p, rr, cc: interpolate_residual_with_grad(
                    p[None], 0, rr, cc, JInterp(**kw)))
    calls = []
    orig = interpolate_cuda.interpolate_rows
    monkeypatch.setattr(interpolate_cuda, "interpolate_rows",
                        lambda *a: calls.append(1) or orig(*a))
    got = interpolate_cuda.interpolate(*_port_args(patches, row, r, c),
                                       InterpolationConfig(**kw))
    assert bool(calls) == (mode == "BICUBIC")
    for a, b in zip(got, want):
        assert a.shape == b.shape == (len(r), 4 * patches.shape[-1])
        np.testing.assert_allclose(
            a.numpy(), b, atol=1e-4 * np.abs(b).max() if ncc else ATOL)


def test_single_node_ncc_reference_read_matches_jax():
    patches, row, r, c = _inputs(seed=2)
    kw = dict(mode="BICUBIC", l2_normalize=False, ncc_normalize=True)
    want = _jax(patches, row, r, c, lambda p, rr, cc: interpolate_nodes(
        p, rr, cc, JInterp(**kw)))[0]
    got = interpolate_cuda.interpolate_nodes(
        *_port_args(patches, row, r, c), InterpolationConfig(**kw))[0]
    assert got.shape == (len(r), 1, patches.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert np.abs(want).max() == 0.0


def test_interpolate_fwd_tangent_matches_jax():
    patches, row, r, c = _inputs(seed=3, n=16)
    kw = dict(mode="BILINEAR", l2_normalize=True, nodes=NODES4)
    tr, tc = np.float32(0.7), np.float32(-0.4)
    want = _jax(patches, row, r, c, lambda p, rr, cc: jax.jvp(
        lambda a, b: interpolate_residual(p[None], 0, a, b, JInterp(**kw)),
        (rr, cc), (tr, tc)))
    rows, H, W, C, rb, rt, ct = _port_args(patches, row, r, c)
    got = torch.func.jvp(
        lambda a, b: interpolate_cuda.interpolate_fwd(
            rows, H, W, C, rb, a, b, InterpolationConfig(**kw)),
        (rt, ct), (torch.full_like(rt, tr), torch.full_like(ct, tc)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
