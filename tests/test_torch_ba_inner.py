"""``ba_solve`` with inner point iterations and non-monotonic steps (the BA
defaults) against the JAX package: the flat layout and the dense step at
``tests/test_torch_ba.py``'s tolerances (final cost rtol 1e-5, states atol
1e-4); the grid layout, where JAX raises ``KeyError: 'V'``, against the
port's flat one. Moved out of ``tests/test_torch_ba.py``, whose helpers
they use, so that the test suite's workers share the long tests.
"""

import pytest
import torch

from tests.test_torch_ba import _assert_solves_match, _solve_both


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side, as in the file these tests
    came from: among the fast lane's parallel workers, torch's default
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ba_solve_inner_iterations():
    """Inner point iterations + non-monotonic steps (the BA defaults): the
    flat layout matches JAX; the grid layout (where JAX raises) matches the
    port's flat one."""
    kw = dict(use_nonmonotonic_steps=True)
    (j_st, j_cost), (t_st, t_sum) = _solve_both(False, **kw)
    _assert_solves_match(t_st, t_sum["final_cost"], j_st, j_cost)
    kw["use_inner_iterations"] = True
    (j_st, j_cost), (flat_st, flat_sum) = _solve_both(False, **kw)
    assert flat_sum["iterations"] == 12
    _assert_solves_match(flat_st, flat_sum["final_cost"], j_st, j_cost)
    j_out, (grid_st, grid_sum) = _solve_both(True, **kw)
    assert j_out is None
    _assert_solves_match(grid_st, grid_sum["final_cost"], flat_st,
                         flat_sum["final_cost"])


def test_ba_solve_dense_inner_iterations():
    """The dense step with inner point iterations and non-monotonic steps
    (the BA defaults) matches JAX's; the point-only iterations run on the
    flat layout the dense step leaves."""
    kw = dict(use_nonmonotonic_steps=True, use_inner_iterations=True)
    (j_st, j_cost), (t_st, t_sum) = _solve_both("dense", **kw)
    assert t_sum["iterations"] == 12 and t_sum["cg_iterations"] == 0
    assert t_sum["final_cost"] < t_sum["initial_cost"]
    _assert_solves_match(t_st, t_sum["final_cost"], j_st, j_cost)
