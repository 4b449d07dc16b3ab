"""Port parity: ``interpolate_rows(..., variant=)`` (kernel K1's forced
variant) on the CPU. A CPU tensor takes the plain version whatever variant
is named, so every name gives the JAX package's XLA path, here at the
narrow variant's widths (1 and 3 channels, the latter as the photometric
node windows lay them out) and the vector variant's 64; a name that is no
variant raises on any device. Tolerance: tests/test_pallas_interpolate.py's
atol 2e-5 for float32 storage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.base.interpolation import (bicubic_window_eval_rows as
                                           jax_eval_rows,
                                           l2_normalize_with_grad as jax_l2)
from pixsfm_tpu_torch.base.interpolation import node_queries
from pixsfm_tpu_torch.ops.interpolate_cuda import VARIANTS, interpolate_rows

NODES16 = [[float(dx), float(dy)] for dy in (-1.5, -0.5, 0.5, 1.5)
           for dx in (-1.5, -0.5, 0.5, 1.5)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other port files: among the fast
    lane's parallel workers, torch's default threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, C, ps=16, n_patches=5, n=9, nodes=None):
    rows = rng.normal(0, 1, (n_patches * ps, ps, C)).astype(np.float32)
    row_base = torch.from_numpy(
        rng.integers(0, n_patches, n).astype(np.int32) * ps)
    r = torch.from_numpy(rng.uniform(-1.5, ps + 0.5, n).astype(np.float32))
    c = torch.from_numpy(rng.uniform(-1.5, ps + 0.5, n).astype(np.float32))
    if nodes is not None:
        row_base, r, c = node_queries(row_base, r, c, nodes)
    return rows, row_base, r, c


def test_forced_variant_on_cpu_matches_jax():
    rng = np.random.default_rng(15)
    for C, nodes in ((1, None), (3, NODES16), (64, None)):
        rows, row_base, r, c = _inputs(rng, C, nodes=nodes)
        ref3 = jax_eval_rows(jnp.asarray(rows), 16, 16, C,
                             jnp.asarray(row_base.numpy()),
                             jnp.asarray(r.numpy()), jnp.asarray(c.numpy()))
        for l2 in (False, True):
            ref = ref3
            if l2:
                f, (dr, dc) = jax_l2(ref3[0], (ref3[1], ref3[2]))
                ref = (f, dr, dc)
            for variant in (None, *VARIANTS):
                out = interpolate_rows(torch.from_numpy(rows), 16, 16, C,
                                       row_base, r, c, l2, variant=variant)
                for a, b in zip(out, ref):
                    assert a.shape == (r.shape[0], C)
                    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                               atol=2e-5, rtol=0,
                                               err_msg=f"C={C} l2={l2} "
                                                       f"{variant}")


def test_unknown_variant_raises():
    rows, row_base, r, c = _inputs(np.random.default_rng(16), 3)
    with pytest.raises(ValueError, match="unknown variant"):
        interpolate_rows(torch.from_numpy(rows), 16, 16, 3, row_base, r, c,
                         False, variant="fused")
