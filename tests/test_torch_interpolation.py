"""Port parity: the plain PyTorch version of kernel K1 (bicubic window
interpolation with derivatives and the L2 chain rule) against the JAX
package's XLA path and its Pallas kernel in interpret mode.

Tolerances are those of tests/test_pallas_interpolate.py: atol 2e-5 with
float32 storage, 5e-3 with bfloat16 storage (bf16 rounding of the inputs is
shared, but the two frameworks sum the taps in different orders).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.interpolation import (bicubic_window_eval_rows as
                                           jax_eval_rows,
                                           l2_normalize_with_grad as jax_l2)
from pixsfm_tpu.ops.interpolate_pallas import interpolate_rows_pallas
from pixsfm_tpu_torch.base.interpolation import (InterpolationConfig,
                                                 check_window_config)
from pixsfm_tpu_torch.ops.interpolate_cuda import interpolate_rows

ATOL = {"float32": 2e-5, "bfloat16": 5e-3}


def _inputs(rng, dtype, n_patches=6, n=24, ps=16, C=128):
    patches = rng.normal(0, 1, (n_patches, ps, ps, C)).astype(np.float32)
    if dtype == "bfloat16":
        patches = patches.astype(ml_dtypes.bfloat16)
    rows = patches.reshape(n_patches * ps, ps, C)
    patch_row = rng.integers(0, n_patches, n).astype(np.int32)
    r = rng.uniform(-1.5, ps + 0.5, n).astype(np.float32)
    c = rng.uniform(-1.5, ps + 0.5, n).astype(np.float32)
    # queries exactly on and next to the patch border
    r[:4] = [0.0, ps - 1.0, 0.25, ps - 1.25]
    c[:4] = [ps - 1.0, 0.0, ps - 1.5, 0.5]
    return rows, patch_row * ps, r, c


def _torch_rows(rows):
    if rows.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(rows.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l2", [False, True])
def test_plain_k1_matches_xla_path(dtype, l2):
    rng = np.random.default_rng(11)
    rows, row_base, r, c = _inputs(rng, dtype)
    ps, C = rows.shape[1], rows.shape[2]
    ref = jax_eval_rows(jnp.asarray(rows), ps, ps, C, jnp.asarray(row_base),
                        jnp.asarray(r), jnp.asarray(c))
    if l2:
        f, (dr, dc) = jax_l2(ref[0], (ref[1], ref[2]))
        ref = (f, dr, dc)
    out = interpolate_rows(_torch_rows(rows), ps, ps, C,
                           torch.from_numpy(row_base), torch.from_numpy(r),
                           torch.from_numpy(c), l2)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32 and a.shape == (len(r), C)
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(12)
    rows, row_base, r, c = _inputs(rng, dtype, n=16)
    ps, C = rows.shape[1], rows.shape[2]
    ref = interpolate_rows_pallas(jnp.asarray(rows), ps, ps, C,
                                  jnp.asarray(row_base), jnp.asarray(r),
                                  jnp.asarray(c), True, interpret=True)
    out = interpolate_rows(_torch_rows(rows), ps, ps, C,
                           torch.from_numpy(row_base), torch.from_numpy(r),
                           torch.from_numpy(c), True)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("conf", [
    {"mode": "BILINEAR"}, {"ncc_normalize": True},
    {"nodes": [[0.0, 0.0], [1.0, 0.0]]}])
def test_unported_modes_raise(conf):
    """Every feature config is ported, so ``check_window_config`` passes
    these. What still raises is what the JAX package refuses: single-point
    NCC in the residual-with-grad path (``check_residual_config``, JAX's
    exception and message) and the gradient-field modes on feature patches
    (``ValueError``)."""
    import jax.numpy as jnp
    from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
    from pixsfm_tpu.base.interpolation import interpolate_residual_with_grad
    from pixsfm_tpu_torch.base.interpolation import check_residual_config
    interp = InterpolationConfig(**conf)
    check_window_config(interp)
    if conf.get("ncc_normalize"):
        for fn in (lambda: check_residual_config(interp),
                   lambda: interpolate_residual_with_grad(
                       jnp.zeros((1, 4, 4, 2)), 0, 1.0, 1.0,
                       JInterp(**conf))):
            with pytest.raises(NotImplementedError,
                               match="single-point NCC configs use the "
                                     "autodiff path"):
                fn()
    else:
        check_residual_config(interp)
    gf = dict(conf, mode="POLYGRADIENTFIELD")
    with pytest.raises(ValueError, match="cost patches"):
        check_window_config(InterpolationConfig(**gf))


# Shapes that reach the general variant of the CUDA kernel (C no multiple of
# 8, narrow and wide) and the border handling of both variants (3 x 3
# patches: every query clamps taps in both directions; queries beyond the
# border). The card holds the kernel to the plain version at these shapes;
# these cases hold the plain version to the JAX package.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("C,ps", [(20, 16), (136, 16), (128, 3), (20, 3)])
def test_plain_k1_edge_shapes_match_xla_path(dtype, l2, C, ps):
    rng = np.random.default_rng(13)
    rows, row_base, r, c = _inputs(rng, dtype, n_patches=5, n=20, ps=ps, C=C)
    # far beyond the border on both sides
    r[4:8] = [-3.0, ps + 2.5, -0.75, ps - 0.25]
    c[4:8] = [ps + 4.0, -2.25, ps - 0.5, -0.5]
    ref = jax_eval_rows(jnp.asarray(rows), ps, ps, C, jnp.asarray(row_base),
                        jnp.asarray(r), jnp.asarray(c))
    if l2:
        f, (dr, dc) = jax_l2(ref[0], (ref[1], ref[2]))
        ref = (f, dr, dc)
    out = interpolate_rows(_torch_rows(rows), ps, ps, C,
                           torch.from_numpy(row_base), torch.from_numpy(r),
                           torch.from_numpy(c), l2)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32 and a.shape == (len(r), C)
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL[dtype])


# ---------------------------------------------------------------------------
# node windows and NCC (patch-warp BA and its references): atol 1e-5 with
# float32 storage against the JAX package's per-patch forms
# ---------------------------------------------------------------------------

NODES16 = [[float(dx), float(dy)] for dy in (-1.5, -0.5, 0.5, 1.5)
           for dx in (-1.5, -0.5, 0.5, 1.5)]


def test_ncc_normalize_matches():
    """``ncc_normalize`` / ``ncc_normalize_with_grad`` against JAX's, with
    a flat channel (sigma = 0: sigma := 1, dsigma := 0) and a flat node
    window: atol 1e-5."""
    from pixsfm_tpu.base.interpolation import ncc_normalize as j_ncc
    from pixsfm_tpu.base.interpolation import \
        ncc_normalize_with_grad as j_ncc_grad
    from pixsfm_tpu_torch.base.interpolation import (ncc_normalize,
                                                     ncc_normalize_with_grad)
    rng = np.random.default_rng(21)
    f = rng.normal(0, 1, (6, 16, 5)).astype(np.float32)
    f[:, :, 2] = 0.7            # a flat channel
    f[3] = 0.25                 # a flat window
    d = [rng.normal(0, 1, f.shape).astype(np.float32) for _ in range(2)]
    want_g, want_d = j_ncc_grad(jnp.asarray(f), [jnp.asarray(a) for a in d])
    got_g, got_d = ncc_normalize_with_grad(torch.from_numpy(f),
                                           [torch.from_numpy(a) for a in d])
    for a, b in zip([got_g, *got_d], [want_g, *want_d]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(ncc_normalize(torch.from_numpy(f)).numpy(),
                               np.asarray(j_ncc(jnp.asarray(f))), atol=1e-5)
    assert float(got_g[3].abs().max()) == 0.0
    # a Jacobian's columns on an axis of their own broadcast against f
    J = np.stack(d, axis=1)                                # [6, 2, 16, 5]
    _, (got_J,) = ncc_normalize_with_grad(torch.from_numpy(f)[:, None],
                                          [torch.from_numpy(J)])
    np.testing.assert_allclose(got_J.numpy(),
                               np.stack([np.asarray(a) for a in want_d], 1),
                               atol=1e-5)


@pytest.mark.parametrize("l2,ncc", [(False, True), (True, False),
                                    (True, True)])
def test_node_windows_match(l2, ncc):
    """``interpolate_node_rows_with_grad`` (16 nodes, queries up to and
    past the window border, one window flat: sigma = 0) against JAX's
    per-patch ``interpolate_nodes_with_grad``; ``interpolate_node_rows``,
    the kernel wrapper, gives the plain version's numbers on CPU tensors:
    atol 1e-5."""
    import jax
    from pixsfm_tpu.base.interpolation import InterpolationConfig as JInterp
    from pixsfm_tpu.base.interpolation import \
        interpolate_nodes_with_grad as j_nodes
    from pixsfm_tpu_torch.base.interpolation import \
        interpolate_node_rows_with_grad
    from pixsfm_tpu_torch.ops.interpolate_cuda import interpolate_node_rows
    rng = np.random.default_rng(22)
    rows, row_base, r, c = _inputs(rng, "float32", n_patches=5, n=12, ps=16,
                                   C=3)
    # a flat window of zeros reads exactly 0 at every node: sigma = 0 (at
    # any other value the Catmull-Rom weights sum to 1 only up to
    # rounding, and NCC divides that rounding by a spread of ~1e-8, in
    # both packages)
    rows[row_base[5]:row_base[5] + 16] = 0.0
    r[6:8], c[6:8] = [-1.0, 15.5], [16.0, -0.75]  # nodes beyond the border
    kw = dict(mode="BICUBIC", l2_normalize=l2, ncc_normalize=ncc,
              nodes=NODES16)
    patches = jnp.asarray(rows.reshape(5, 16, 16, 3))
    want = jax.vmap(lambda p, rr, cc: j_nodes(p, rr, cc, JInterp(**kw)))(
        patches[row_base // 16], jnp.asarray(r), jnp.asarray(c))
    got = interpolate_node_rows_with_grad(
        torch.from_numpy(rows), 16, 16, 3, torch.from_numpy(row_base),
        torch.from_numpy(r), torch.from_numpy(c), InterpolationConfig(**kw))
    for a, b in zip(got, want):
        assert a.shape == (12, 16, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    raw = interpolate_node_rows(
        torch.from_numpy(rows), 16, 16, 3, torch.from_numpy(row_base),
        torch.from_numpy(r), torch.from_numpy(c), NODES16, l2)
    if ncc:
        from pixsfm_tpu_torch.base.interpolation import \
            ncc_normalize_with_grad
        raw = (lambda g, d: (g, *d))(*ncc_normalize_with_grad(raw[0],
                                                              raw[1:]))
    for a, b in zip(raw, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_node_windows_config():
    """Node windows and NCC pass with every feature mode (BICUBIC and
    CERES_BICUBIC on kernel K1, the others plain); only the gradient-field
    modes raise."""
    conf = dict(ncc_normalize=True, nodes=NODES16)
    for mode in ("BICUBIC", "CERES_BICUBIC", "BILINEAR", "NEARESTNEIGHBOR",
                 "BICUBICCHAIN"):
        check_window_config(InterpolationConfig(mode=mode, **conf))
    for mode in ("POLYGRADIENTFIELD", "BICUBICGRADIENTFIELD"):
        with pytest.raises(ValueError):
            check_window_config(InterpolationConfig(mode=mode, **conf))
