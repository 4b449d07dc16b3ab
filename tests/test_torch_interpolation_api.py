"""Port parity: the JAX package's patch interpolation API
(``base.interpolation.interpolate`` / ``interpolate_with_grad`` /
``interpolate_nodes`` / ``interpolate_nodes_with_grad`` /
``bicubic_window_eval`` / ``inbounds_weight``) against JAX on the CPU.

Every mode of ``INTERPOLATOR_TYPES`` with L2 on and off, one node and a
2x2 node window, NCC on and off, each config at one of four (channels,
storage) pairs, 3 or 16 channels (the gradient-field modes read 4) in
float32 or bfloat16, so that every mode meets each pair with L2 on and
off; a batch of queries shaped ``[5, 8]`` (JAX: ``vmap`` of its single
query over the points) and a scalar query; ``cross=True``. Queries lie
inside, on integer cell borders and up to 1.5 px past the patch; with NCC
every node lies inside and off the cell borders (NCC divides float32
rounding by each channel's spread over the nodes, which a window clamped
flat past the border, or nearest-neighbour nodes rounded onto one row,
bring to 0, in both packages). Limits: atol 2e-5; with NCC 1e-4 of each array's
largest entry, as ``tests/test_torch_interp_modes.py`` holds it. L2 cases
read textures in [0.25, 1), the others zero-crossing ones (L2 at 1-3
channels is ill-conditioned near a zero vector).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base import interpolation as J
from pixsfm_tpu_torch.base import interpolation as T
from tests.test_torch_localization import _one_torch_thread  # noqa: F401

NODES4 = [[-0.5, -0.5], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]
ATOL = 2e-5
H, W = 9, 11


def _patch(seed, C, l2, dtype):
    """A textured ``[H, W, C]`` patch: sinusoids in [0.25, 1) with L2,
    zero-crossing ones without; the same stored values on both sides."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    p = np.stack([np.sin(rng.uniform(0.3, 0.9) * xx
                         + rng.uniform(0.3, 0.9) * yy + rng.uniform(0, 6))
                  for _ in range(C)], -1).astype(np.float32)
    if l2:
        p = 0.625 + 0.37 * p
    tp = torch.from_numpy(p).to(dtype)
    jp = jnp.asarray(tp.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return tp, jp


def _queries(seed, ncc=False):
    """Queries ``[5, 8]`` up to 1.5 px past the patch, some on integer cell
    borders; for NCC every 2x2 node inside the patch and off the borders
    (there the nearest-neighbour nodes at +-0.5 round to one row)."""
    rng = np.random.default_rng(seed + 100)
    lo, hi = (0.5, -1.5) if ncc else (-1.5, 0.5)
    r = rng.uniform(lo, H + hi, (5, 8)).astype(np.float32)
    c = rng.uniform(lo, W + hi, (5, 8)).astype(np.float32)
    if not ncc:
        r[0, :4] = np.floor(r[0, :4])
        c[1, :4] = np.floor(c[1, :4])
    return r, c


def _jax_points(fn, r, c):
    """JAX's single-query ``fn`` over the points ``r, c [n]``."""
    return jax.vmap(fn)(r, c)


def _tol(want, ncc):
    """atol 2e-5; with NCC 1e-4 of the array's largest entry."""
    return 1e-4 * float(np.abs(np.asarray(want)).max()) if ncc else ATOL


def _check(got, want, atol):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


MODES = ("BICUBIC", "BILINEAR", "NEARESTNEIGHBOR", "POLYGRADIENTFIELD",
         "BICUBICGRADIENTFIELD", "BICUBICCHAIN", "CERES_BICUBIC")


# the (channels, storage) pair of each (nodes, NCC) config: every mode
# meets all four pairs with L2 on and with L2 off
PAIRS = {(1, False): (3, torch.float32), (1, True): (16, torch.bfloat16),
         (4, False): (3, torch.bfloat16), (4, True): (16, torch.float32)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("nodes,ncc", list(PAIRS))
def test_patch_api_matches_jax(mode, l2, nodes, ncc):
    """One config at its (channels, storage) pair: batched reads, node
    windows, one scalar query; ``cross=True`` (one point whatever the
    nodes) with the 2x2 NCC window's config."""
    assert set(MODES) == set(T.INTERPOLATOR_TYPES)
    kw = dict(mode=mode, l2_normalize=l2, ncc_normalize=ncc,
              nodes=[[0.0, 0.0]] if nodes == 1 else NODES4)
    jconf, tconf = J.InterpolationConfig(**kw), T.InterpolationConfig(**kw)
    gradient_field = mode in ("POLYGRADIENTFIELD", "BICUBICGRADIENTFIELD")
    seed = MODES.index(mode)
    r, c = _queries(seed, ncc=ncc)
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    jr, jc = jnp.asarray(r.reshape(-1)), jnp.asarray(c.reshape(-1))
    window_ncc = ncc and T._node_path(tconf)
    C, dtype = PAIRS[nodes, ncc]
    C = 4 if gradient_field else C
    tp, jp = _patch(seed + C, C, l2, dtype)
    # batched queries [5, 8] against JAX vmapped over the points
    got = T.interpolate_with_grad(tp, tr, tc, tconf)
    want = [np.asarray(w).reshape(5, 8, -1) for w in _jax_points(
        lambda a, b: J.interpolate_with_grad(jp, a, b, jconf), jr, jc)]
    for g, w in zip(got, want):
        _check(g, w, _tol(w, window_ncc))
    _check(T.interpolate(tp, tr, tc, tconf), want[0],
           _tol(want[0], window_ncc))
    # one scalar query, outputs [D] (JAX's single query: vmap's row)
    k = 9 + C
    got = T.interpolate_with_grad(tp, float(r.flat[k]), float(c.flat[k]),
                                  tconf)
    for g, w in zip(got, want):
        _check(g, w.reshape(40, -1)[k], _tol(w, window_ncc))
    # the node windows [5, 8, n_nodes, D] (NCC over any mode's nodes)
    got = T.interpolate_nodes_with_grad(tp, tr, tc, tconf)
    want = [np.asarray(w).reshape(5, 8, nodes, -1) for w in _jax_points(
        lambda a, b: J.interpolate_nodes_with_grad(jp, a, b, jconf), jr, jc)]
    for g, w in zip(got, want):
        _check(g, w, _tol(w, ncc))
    _check(T.interpolate_nodes(tp, tr, tc, tconf), want[0],
           _tol(want[0], ncc))
    if nodes == 4 and ncc:
        # cross: one point, the mixed derivative not chain-ruled
        got = T.interpolate_with_grad(tp, tr, tc, tconf, cross=True)
        want = _jax_points(lambda a, b: J.interpolate_with_grad(
            jp, a, b, jconf, cross=True), jr, jc)
        assert len(got) == 4
        for g, w in zip(got, want):
            _check(g, np.asarray(w).reshape(5, 8, -1), ATOL)


@pytest.mark.parametrize("C", [3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bicubic_window_eval_matches_jax(C, dtype):
    """``bicubic_window_eval`` on a stack of 6 patches, one query each,
    and through the node route the other storage types JAX reads in
    float32 (float16, float64): atol 2e-5."""
    rng = np.random.default_rng(C)
    p = rng.standard_normal((6, H, W, C)).astype(np.float32)
    tp = torch.from_numpy(p).to(dtype)
    jp = jnp.asarray(tp.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    r = rng.uniform(-1.5, H + 0.5, 6).astype(np.float32)
    c = rng.uniform(-1.5, W + 0.5, 6).astype(np.float32)
    got = T.bicubic_window_eval(tp, torch.from_numpy(r), torch.from_numpy(c))
    want = J.bicubic_window_eval(jp, jnp.asarray(r), jnp.asarray(c))
    for g, w in zip(got, want):
        _check(g, w, ATOL)
    for other in (torch.float16, torch.float64):
        q = torch.from_numpy(p[0]).to(other)
        got = T.interpolate_with_grad(q, torch.from_numpy(r),
                                      torch.from_numpy(c))
        want = _jax_points(lambda a, b: J.interpolate_with_grad(
            jnp.asarray(q.numpy()), a, b), jnp.asarray(r), jnp.asarray(c))
        for g, w in zip(got, want):
            _check(g, w, ATOL)


def test_inbounds_weight_matches_jax():
    """``inbounds_weight`` on the extent's borders and past them: equal."""
    r = np.array([-0.5, 0.0, 3.0, H - 1.0, H - 0.99, 4.0], np.float32)
    c = np.array([1.0, 0.0, -1e-3, W - 1.0, 2.0, W - 1.0 + 1e-3],
                 np.float32)
    got = T.inbounds_weight(torch.from_numpy(r), torch.from_numpy(c), H, W)
    want = J.inbounds_weight(jnp.asarray(r), jnp.asarray(c), H, W)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(T.inbounds_weight(torch.tensor(2.0), torch.tensor(2.0),
                                   H, W)) == 1.0
