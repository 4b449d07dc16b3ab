"""Batched bounded Levenberg-Marquardt on dense normal equations.

Port of ``pixsfm_tpu/ops/lm.py``. All P problems run lock-stepped: state is
``[P, N]`` parameters with per-problem damping, acceptance and convergence
masks. The JAX ``lax.while_loop`` becomes a Python loop that stops when
every problem is done or the iteration cap is hit; its condition is the one
device-to-host sync per iteration.

The damping/acceptance schedule is Madsen-Nielsen's gain-ratio LM, with
optional GLL non-monotonic acceptance and best-iterate tracking. Box bounds
are enforced by step projection ``x_new = clip(x + dx, lower, upper)``.
The linear solve is Jacobi-preconditioned CG (kernel K2 on CUDA, see
``ops/cg_cuda.py``) for N >= 48 and a batched Cholesky below. With
``cg_block_size = b > 1`` and ``N % b == 0`` the CG is preconditioned by the
inverses of the ``b x b`` diagonal blocks (closed form at ``b = 2``,
Cholesky above), in plain PyTorch on every device, as the JAX package runs
it in XLA (``ops/lm.py:150-190`` there); otherwise it falls back to Jacobi.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .cg_cuda import pcg_solve, pcg_solve_plain

__all__ = ["LMOptions", "LMState", "LMSummary", "lm_solve",
           "block_jacobi_pcg"]


@dataclass(frozen=True)
class LMOptions:
    max_iterations: int = 100
    parameter_tolerance: float = 1e-5
    function_tolerance: float = 0.0
    gradient_tolerance: float = 0.0
    initial_lambda: float = 1e-4          # = 1 / Ceres initial trust radius (1e4)
    min_lambda: float = 1e-14
    max_lambda: float = 1e32
    min_diagonal: float = 1e-6            # Ceres min_lm_diagonal
    max_diagonal: float = 1e32
    # Ceres use_nonmonotonic_steps: accept steps that beat the MAX cost of the
    # last `nonmonotonic_window` accepted iterates (GLL acceptance).
    use_nonmonotonic_steps: bool = False
    nonmonotonic_window: int = 10         # max_consecutive_nonmonotonic_steps
    # "cholesky" | "cg" | "auto" (cg for N >= 48, cholesky below)
    linear_solver: str = "auto"
    cg_iterations: int = 15
    # CG preconditioner block size: 1 = diagonal Jacobi (kernel K2 on
    # CUDA); b > 1 with N % b == 0 = block-Jacobi over b x b diagonal
    # blocks (plain PyTorch); other b fall back to Jacobi. The JAX
    # package's cg_backend has no counterpart: the CG implementation
    # follows the device.
    cg_block_size: int = 1
    # Caller guarantees system_fn already zeroes frozen parameters' Hessian
    # rows/cols and gradient entries; the damping diagonal is then folded
    # into the CG matvec and the [P, N, N] masking passes are skipped.
    assume_masked_system: bool = False

    @classmethod
    def from_solver_conf(cls, conf) -> "LMOptions":
        """Build from a reference-style solver config subtree."""
        if conf is None:
            return cls()
        get = conf.get if hasattr(conf, "get") else lambda k, d=None: conf[k]
        return cls(
            max_iterations=int(get("max_num_iterations", 100)),
            parameter_tolerance=float(get("parameter_tolerance", 1e-5) or 0.0),
            function_tolerance=float(get("function_tolerance", 0.0) or 0.0),
            gradient_tolerance=float(get("gradient_tolerance", 0.0) or 0.0),
            use_nonmonotonic_steps=bool(get("use_nonmonotonic_steps", False)),
            nonmonotonic_window=int(
                get("max_consecutive_nonmonotonic_steps", 10) or 10),
            linear_solver=str(get("linear_solver", "auto") or "auto"),
            cg_iterations=int(get("cg_iterations", 15) or 15),
            cg_block_size=int(get("cg_block_size", 1) or 1),
        )


class LMState(NamedTuple):
    """What one LM iteration hands the next (the JAX package's loop
    carry); ``it`` is the host's iteration count."""
    x: torch.Tensor            # [P, N]
    H: torch.Tensor            # [P, N, N] normal equations at x (carried so
    g: torch.Tensor            # [P, N]    each iteration runs ONE system eval)
    lam: torch.Tensor          # [P]
    nu: torch.Tensor           # [P] lambda growth factor
    cost: torch.Tensor         # [P]
    done: torch.Tensor         # [P] bool
    it: int
    iterations: torch.Tensor   # [P] iterations actually used
    cost_window: torch.Tensor  # [P, W] recent accepted costs (nonmonotonic)
    best_x: torch.Tensor       # [P, N] lowest-cost iterate seen
    best_cost: torch.Tensor    # [P]


class LMSummary(NamedTuple):
    initial_cost: torch.Tensor   # [P]
    final_cost: torch.Tensor     # [P]
    iterations: torch.Tensor     # [P]
    converged: torch.Tensor      # [P] bool
    lam: torch.Tensor            # [P] final damping


def _masked_solve(H, g, lam, param_mask, opts: LMOptions):
    """Solve (H + lam * diag(D)) dx = -g with frozen params masked out.

    H: [P, N, N], g: [P, N], lam: [P], param_mask: [P, N] bool (True = free).
    Returns (dx, D) with D the clipped diagonal used for damping.
    """
    P, N = g.shape
    m = param_mask.to(H.dtype)
    if opts.assume_masked_system:
        # frozen rows/cols are already zero: damp the free diagonal and put
        # 1 on the frozen one. CG folds this into its matvec; Cholesky
        # builds the damped matrix below.
        D = torch.clamp(torch.diagonal(H, dim1=1, dim2=2),
                        opts.min_diagonal, opts.max_diagonal)
        damp = lam[:, None] * D * m + (1.0 - m)
        Hd = None
    else:
        mm = m[:, :, None] * m[:, None, :]
        H = H * mm
        D = torch.clamp(torch.diagonal(H, dim1=1, dim2=2),
                        opts.min_diagonal, opts.max_diagonal)
        eye = torch.eye(N, dtype=H.dtype, device=H.device)
        Hd = H + torch.diag_embed(lam[:, None] * D) + (1.0 - mm) * eye
        g = g * m
        damp = None
    solver = opts.linear_solver
    if solver == "auto":
        solver = "cg" if N >= 48 else "cholesky"
    if solver == "cg":
        bs = int(opts.cg_block_size)
        if bs > 1 and N % bs == 0:
            dx = block_jacobi_pcg(H, g, int(opts.cg_iterations), bs,
                                  damp=damp if Hd is None else None,
                                  Hd=Hd)
            return dx * m, D
        dx = pcg_solve(H if Hd is None else Hd, g, int(opts.cg_iterations),
                       damp=damp)
        return dx * m, D
    if solver != "cholesky":
        raise ValueError(f"unknown linear_solver {opts.linear_solver!r}")
    if Hd is None:
        Hd = H + torch.diag_embed(damp)
    # damped GN Hessians are SPD; a factorization that still fails gives a
    # zero step (rejected by LM, which raises the damping) — the JAX
    # Cholesky returns NaNs there, which LM rejects the same way
    L, info = torch.linalg.cholesky_ex(Hd)
    dx = torch.cholesky_solve(-g[..., None], L)[..., 0]
    dx = torch.where((info == 0)[:, None], dx, torch.zeros_like(dx))
    return dx * m, D


def _block_inverse(Hd, bs: int):
    """Inverses ``[P, N / bs, bs, bs]`` of the ``bs x bs`` diagonal blocks
    of ``Hd [P, N, N]``: closed form at ``bs = 2`` (determinant clamped at
    1e-24), else Cholesky of the block plus 1e-12 I and two triangular
    solves, as the JAX package. A block whose factorization fails gets a
    zero inverse (its rows take no step; JAX's NaNs are rejected by LM the
    same way)."""
    P, N, _ = Hd.shape
    nb = N // bs
    blocks = torch.diagonal(Hd.reshape(P, nb, bs, nb, bs), dim1=1, dim2=3)
    blocks = blocks.permute(0, 3, 1, 2)                  # [P, nb, bs, bs]
    if bs == 2:
        a, b = blocks[..., 0, 0], blocks[..., 0, 1]
        c, d = blocks[..., 1, 0], blocks[..., 1, 1]
        det = torch.clamp(a * d - b * c, min=1e-24)
        return torch.stack([torch.stack([d, -b], -1),
                            torch.stack([-c, a], -1)], -2) / det[..., None,
                                                               None]
    eye = torch.eye(bs, dtype=Hd.dtype, device=Hd.device)
    L, info = torch.linalg.cholesky_ex(blocks + 1e-12 * eye)
    inv = torch.cholesky_inverse(L)
    return torch.where((info == 0)[..., None, None], inv,
                       torch.zeros_like(inv))


def block_jacobi_pcg(H, g, iters: int, bs: int,
                     damp: Optional[torch.Tensor] = None, Hd=None):
    """Solve ``(H + diag(damp)) dx = -g`` (or ``Hd dx = -g`` when ``Hd`` is
    given) by ``iters`` block-Jacobi-preconditioned CG steps from zero: the
    JAX package's CG scan with ``cg_block_size = bs`` (``N % bs == 0``),
    in plain PyTorch (K2's plain loop with this preconditioner)."""
    P, N = g.shape
    inv = _block_inverse(H + torch.diag_embed(damp) if Hd is None else Hd,
                         bs)

    def prec(v):
        return torch.einsum("pnab,pnb->pna", inv,
                            v.reshape(P, N // bs, bs)).reshape(P, N)

    return pcg_solve_plain(H if Hd is None else Hd, g, iters,
                           damp=damp if Hd is None else None, prec=prec)


def lm_solve(system_fn: Callable,
             cost_fn: Callable,
             x0: torch.Tensor,
             param_mask: Optional[torch.Tensor] = None,
             problem_mask: Optional[torch.Tensor] = None,
             lower: Optional[torch.Tensor] = None,
             upper: Optional[torch.Tensor] = None,
             opts: LMOptions = LMOptions(),
             lam0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, LMSummary]:
    """Run batched LM.

    system_fn(x) -> (cost [P], H [P, N, N], g [P, N]) robustified normal
    equations. cost_fn(x) -> cost [P] (kept for API parity; the loop
    evaluates the full system once per iteration and needs no separate cost).
    x0: [P, N]. param_mask: [P, N] bool, True = free parameter.
    problem_mask: [P] bool, True = real problem (False = padding).
    lower/upper: [P, N] box bounds (use +-inf when absent).
    """
    P, N = x0.shape
    dev, f32 = x0.device, x0.dtype
    if param_mask is None:
        param_mask = torch.ones((P, N), dtype=torch.bool, device=dev)
    if problem_mask is None:
        problem_mask = torch.ones((P,), dtype=torch.bool, device=dev)
    if lower is None:
        lower = torch.full((P, N), -torch.inf, dtype=f32, device=dev)
    if upper is None:
        upper = torch.full((P, N), torch.inf, dtype=f32, device=dev)
    mask_f = param_mask.to(f32)

    x = torch.clamp(x0, lower, upper)
    cost0, H, g = system_fn(x)
    cost0 = torch.where(problem_mask, cost0, torch.zeros_like(cost0))

    # problems with no free params are trivially done
    done = ~param_mask.any(dim=1) | ~problem_mask
    W = max(int(opts.nonmonotonic_window), 1)
    lam = (torch.full((P,), opts.initial_lambda, dtype=f32, device=dev)
           if lam0 is None else lam0.to(device=dev, dtype=f32))
    state = LMState(
        x=x, H=H, g=g, lam=lam,
        nu=torch.full((P,), 2.0, dtype=f32, device=dev), cost=cost0,
        done=done, it=0,
        iterations=torch.zeros((P,), dtype=torch.int32, device=dev),
        cost_window=cost0[:, None].expand(P, W).clone(), best_x=x,
        best_cost=cost0)

    # the loop condition is the one host sync of each iteration
    while state.it < opts.max_iterations and bool((~state.done).any()):
        state = _lm_iteration(state, system_fn, param_mask, mask_f, lower,
                              upper, opts)

    x, cost, lam = state.x, state.cost, state.lam
    best_x, best_cost = state.best_x, state.best_cost
    # with non-monotonic acceptance the final iterate may be worse than the
    # best one seen; return the best (Ceres returns the lowest-cost state)
    x_out = torch.where((best_cost < cost)[:, None], best_x, x)
    cost_out = torch.minimum(best_cost, cost)
    summary = LMSummary(initial_cost=cost0, final_cost=cost_out,
                        iterations=state.iterations,
                        converged=state.done & problem_mask, lam=lam)
    return x_out, summary


def _lm_iteration(s: LMState, system_fn, param_mask, mask_f, lower, upper,
                  opts: LMOptions) -> LMState:
    """One LM iteration of :func:`lm_solve` on its carried state."""
    x, H, g, lam, nu, cost, done = s.x, s.H, s.g, s.lam, s.nu, s.cost, s.done
    # ONE system eval per iteration: H/g at the current iterate are
    # carried; on rejection x is unchanged, so they stay exact.
    dx, D = _masked_solve(H, g, lam, param_mask, opts)
    x_new = torch.clamp(x + dx, lower, upper)
    dx_eff = x_new - x

    new_cost, H_new, g_new = system_fn(x_new)
    # Madsen-Nielsen gain ratio: predicted reduction of the damped model
    pred = 0.5 * torch.sum(dx_eff * (lam[:, None] * D * dx_eff - g), dim=1)
    actual = cost - new_cost
    rho = actual / torch.clamp(pred, min=1e-30)
    if opts.use_nonmonotonic_steps:
        # GLL acceptance: beat the max cost over the recent window
        ref_cost = torch.amax(s.cost_window, dim=1)
        accept = (new_cost < ref_cost) & (pred > 0) & ~done
    else:
        accept = (actual > 0) & (pred > 0) & ~done

    # lambda update (Nielsen)
    lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_new = torch.clamp(torch.where(accept, lam_acc, lam * nu),
                          opts.min_lambda, opts.max_lambda)
    nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)

    if opts.gradient_tolerance > 0:
        # gradient at the iterate this step started from
        grad_inf = torch.amax(torch.abs(g * mask_f), dim=1)

    a1 = accept[:, None]
    x = torch.where(a1, x_new, x)
    H = torch.where(accept[:, None, None], H_new, H)
    g = torch.where(a1, g_new, g)
    cost_prev = cost
    cost = torch.where(accept, new_cost, cost)

    # rolling window of accepted costs + best-iterate tracking
    cost_window = torch.where(
        a1, torch.cat([s.cost_window[:, 1:], new_cost[:, None]], dim=1),
        s.cost_window)
    improve = accept & (new_cost < s.best_cost)
    best_x = torch.where(improve[:, None], x_new, s.best_x)
    best_cost = torch.where(improve, new_cost, s.best_cost)

    # convergence tests (Ceres semantics)
    step_norm = torch.linalg.vector_norm(dx_eff * mask_f, dim=1)
    x_norm = torch.linalg.vector_norm(x * mask_f, dim=1)
    ptol = opts.parameter_tolerance
    conv = accept & (step_norm <= ptol * (x_norm + ptol))
    if opts.function_tolerance > 0:
        conv = conv | (accept & (torch.abs(actual) <= opts.function_tolerance
                                 * torch.clamp(cost_prev, min=1e-30)))
    if opts.gradient_tolerance > 0:
        conv = conv | (grad_inf <= opts.gradient_tolerance)
    # stuck: lambda blown up
    conv = conv | (lam_new >= opts.max_lambda)
    return LMState(x=x, H=H, g=g, lam=lam_new, nu=nu, cost=cost,
                   done=done | conv, it=s.it + 1,
                   iterations=s.iterations + (~done).to(torch.int32),
                   cost_window=cost_window, best_x=best_x,
                   best_cost=best_cost)
