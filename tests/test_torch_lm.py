"""Port parity: the plain PyTorch version of kernel K2 (batched Jacobi PCG)
and the batched LM solver against the JAX package.

Tolerance rtol/atol 1e-4, as tests/test_cg_pallas.py: both sides run the
same float32 recurrences, summed in different orders.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.ops import lm as jlm
from pixsfm_tpu.ops.cg_pallas import pcg_solve_pallas
from pixsfm_tpu_torch.ops import lm as tlm
from pixsfm_tpu_torch.ops.cg_cuda import pcg_solve

TOL = dict(rtol=1e-4, atol=1e-4)


def _spd(rng, P, N):
    A = rng.normal(0, 1, (P, N, N)).astype(np.float32)
    return (A @ np.swapaxes(A, 1, 2) / N
            + 0.5 * np.eye(N, dtype=np.float32)).astype(np.float32)


# N of the CUDA kernel's variant boundaries: 64 (the first case), 112 (the
# KA main path's 2 x pad8(50)), 128 (the largest the register variant
# takes), 129 and 132 (the smallest it refuses: past 128, and the first
# multiple of 4 past it), 51 (odd: the general variant)
@pytest.mark.parametrize("N", [64, 112, 128, 129, 132, 51])
def test_plain_k2_matches_pallas_interpret(N):
    rng = np.random.default_rng(0)
    P = 8
    H = _spd(rng, P, N)
    g = rng.normal(0, 1, (P, N)).astype(np.float32)
    dinv = 1.0 / np.einsum("pii->pi", H)
    ref = pcg_solve_pallas(jnp.asarray(H), jnp.asarray(g), jnp.asarray(dinv),
                           iters=15, interpret=True)
    out = pcg_solve(torch.from_numpy(H), torch.from_numpy(g), 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _masked_inputs(rng, P=6, N=64):
    H = _spd(rng, P, N)
    g = rng.normal(0, 1, (P, N)).astype(np.float32)
    lam = rng.uniform(1e-4, 1e-1, P).astype(np.float32)
    mask = rng.uniform(size=(P, N)) > 0.2
    return H, g, lam, mask


@pytest.mark.parametrize("solver,folded", [
    ("cg", True), ("cg", False), ("cholesky", True), ("cholesky", False)])
def test_masked_solve_matches_jax(solver, folded):
    rng = np.random.default_rng(1)
    H, g, lam, mask = _masked_inputs(rng)
    if folded:
        # assume_masked_system: the caller zeroed frozen rows/cols and g
        m = mask.astype(np.float32)
        H = H * m[:, :, None] * m[:, None, :]
        g = g * m
    jopts = jlm.LMOptions(linear_solver=solver, assume_masked_system=folded)
    topts = tlm.LMOptions(linear_solver=solver, assume_masked_system=folded)
    dx_j, D_j = jlm._masked_solve(jnp.asarray(H), jnp.asarray(g),
                                  jnp.asarray(lam), jnp.asarray(mask), jopts)
    dx_t, D_t = tlm._masked_solve(torch.from_numpy(H), torch.from_numpy(g),
                                  torch.from_numpy(lam),
                                  torch.from_numpy(mask), topts)
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), **TOL)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **TOL)


def _range_problem(rng, P=5, n_obs=24):
    """Batched robust trilateration: a 3-D point per problem from noisy
    ranges to ``n_obs`` anchors (two of them outliers), Cauchy-weighted;
    N = 3 parameters per problem."""
    anchors = rng.uniform(-5.0, 5.0, (P, n_obs, 3)).astype(np.float32)
    truth = rng.uniform(-1.0, 1.0, (P, 3)).astype(np.float32)
    d = np.linalg.norm(anchors - truth[:, None], axis=-1)
    d = (d + rng.normal(0, 0.01, d.shape)).astype(np.float32)
    d[:, :2] += 2.0    # outliers
    x0 = (truth + rng.normal(0, 0.5, truth.shape)).astype(np.float32)
    x0[:, 0] = truth[:, 0] - 0.6
    lower = np.full_like(x0, -np.inf)
    upper = np.full_like(x0, np.inf)
    upper[:, 0] = truth[:, 0] + 0.02     # clips the first steps
    mask = np.ones_like(x0, bool)
    mask[1, 2] = False                   # a frozen parameter
    pmask = np.ones(P, bool)
    pmask[-1] = False                    # a padded problem
    return anchors, d, x0, lower, upper, mask, pmask


def _make_fns(xp, anchors, d):
    """(system_fn, cost_fn) in the array namespace ``xp``."""
    ssum = xp.sum

    def res_jac(x):
        diff = x[:, None, :] - anchors                     # [P, n, 3]
        rng_ = xp.sqrt(ssum(diff * diff, -1))
        return rng_ - d, diff / rng_[..., None]

    def cost_fn(x):
        r, _ = res_jac(x)
        return ssum(0.5 * 0.25 * xp.log1p(r * r / 0.25), 1)

    def system_fn(x):
        r, J = res_jac(x)
        w = 1.0 / (1.0 + r * r / 0.25)
        H = ssum(w[..., None, None] * J[..., :, None] * J[..., None, :], 1)
        g = ssum((w * r)[..., None] * J, 1)
        return cost_fn(x), H, g

    return system_fn, cost_fn


@pytest.mark.parametrize("nonmonotonic", [False, True])
def test_lm_solve_matches_jax(nonmonotonic):
    rng = np.random.default_rng(2)
    anchors, d, x0, lower, upper, mask, pmask = _range_problem(rng)
    opts = dict(max_iterations=50, use_nonmonotonic_steps=nonmonotonic,
                linear_solver="cholesky")
    js, jc = _make_fns(jnp, jnp.asarray(anchors), jnp.asarray(d))
    xj, sj = jlm.lm_solve(js, jc, jnp.asarray(x0), jnp.asarray(mask),
                          jnp.asarray(pmask), jnp.asarray(lower),
                          jnp.asarray(upper), jlm.LMOptions(**opts))
    ts, tc = _make_fns(torch, torch.from_numpy(anchors), torch.from_numpy(d))
    xt, st = tlm.lm_solve(ts, tc, torch.from_numpy(x0),
                          torch.from_numpy(mask), torch.from_numpy(pmask),
                          torch.from_numpy(lower), torch.from_numpy(upper),
                          tlm.LMOptions(**opts))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(st.final_cost.numpy(),
                               np.asarray(sj.final_cost), **TOL)
    np.testing.assert_allclose(st.initial_cost.numpy(),
                               np.asarray(sj.initial_cost), **TOL)
    np.testing.assert_array_equal(st.converged.numpy(),
                                  np.asarray(sj.converged))
    assert (xt[:, 0] <= torch.from_numpy(upper[:, 0]) + 1e-6).all()
    assert xt[1, 2] == torch.from_numpy(x0)[1, 2]
    assert (st.final_cost <= st.initial_cost + 1e-6).all()


def test_lm_options_from_default_conf():
    conf = {"max_num_iterations": 100, "use_nonmonotonic_steps": True,
            "max_consecutive_nonmonotonic_steps": 10,
            "parameter_tolerance": 1e-5}
    a = jlm.LMOptions.from_solver_conf(conf)
    b = tlm.LMOptions.from_solver_conf(conf)
    # the port has every field but cg_backend (its CG follows the device)
    assert set(a.__dataclass_fields__) - set(b.__dataclass_fields__) == \
        {"cg_backend"}
    assert all(getattr(a, k) == getattr(b, k) for k in b.__dataclass_fields__)


def test_block_jacobi_is_not_ported():
    """Block-Jacobi CG is ported (plain PyTorch): ``cg_block_size = 2``
    (closed-form block inverses) and ``4`` (Cholesky) match JAX's
    ``_masked_solve``, folded and not, within the module's tolerance; a
    block size that does not divide N falls back to Jacobi in both."""
    rng = np.random.default_rng(3)
    H, g, lam, mask = _masked_inputs(rng, N=60)
    for bs, folded in ((2, True), (4, False), (7, True)):
        Hc, gc = H, g
        if folded:
            m = mask.astype(np.float32)
            Hc = H * m[:, :, None] * m[:, None, :]
            gc = g * m
        kw = dict(linear_solver="cg", cg_block_size=bs,
                  assume_masked_system=folded)
        dx_j, _ = jlm._masked_solve(jnp.asarray(Hc), jnp.asarray(gc),
                                    jnp.asarray(lam), jnp.asarray(mask),
                                    jlm.LMOptions(**kw))
        dx_t, _ = tlm._masked_solve(torch.from_numpy(Hc),
                                    torch.from_numpy(gc),
                                    torch.from_numpy(lam),
                                    torch.from_numpy(mask),
                                    tlm.LMOptions(**kw))
        np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **TOL)
