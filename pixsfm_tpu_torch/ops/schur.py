"""Bundle-adjustment Levenberg-Marquardt with a CG Schur-complement step.

Port of ``pixsfm_tpu/ops/schur.py`` (reference: the Ceres BA solves of
pixsfm/bundle_adjustment/src/bundle_optimizer.h:114-245). Design:

- Parameters: poses ``(qvec [I, 4], tvec [I, 3])`` updated through a 6-DoF
  left so(3) + R^3 tangent, shared intrinsics ``cams [Nc, k]`` with
  per-coordinate free masks, and points ``xyz [Np, 3]``.
- Residuals and analytic Jacobians (``residual_jac_fn``) evaluated in
  observation chunks of ``obs_chunk``; robustified by IRLS weights
  ``rho'(||r||^2)``; the normal equations come out of one per-observation
  Gram matrix ``G = w [J | r]^T [J | r]`` and are reduced with
  ``index_add_`` into pose blocks ``[I, 6, 6]``, intrinsics ``[Nc, k, k]``,
  pose-intrinsics cross terms ``[I, 6, k]``, point blocks ``V [Np, 3, 3]``
  and per-observation W blocks ``B [O, 6+k, 3]``.
- Linear step: matrix-free preconditioned CG on the Schur complement over
  points (ITERATIVE_SCHUR + block Jacobi). Two layouts apply the Schur term
  ``W V^-1 W^T``: the flat one (gathers + ``index_add_`` over the
  observation axis; the JAX package's flat, ``pt_slot`` and ``img_slot``
  regimes all reduce to it) and the GRID one (``opts.obs_grid_T > 0``:
  observations packed point-major, slot ``point * T + rank``), where the
  Schur term, its right-hand side and the point back-substitution run on
  the hand-written CUDA kernels K3a/b/c (``ops/schur_cuda.py``).
- The CG loop copies ``jax.scipy.sparse.linalg.cg``: stop when
  ``r.r <= max(tol^2 b.b, 0)`` (unpreconditioned residual) or after
  ``max_linear_solver_iterations`` steps.
- LM with Ceres-style non-monotonic (GLL) acceptance, best-state return and
  optional inner point-only iterations after each accepted step.

The LM loop runs on the host (one device sync per iteration and per CG
step). Out of scope here, each raising ``NotImplementedError``: the dense
Schur step, the generic autodiff path (no ``residual_jac_fn``) and a second
pose block per observation (``src_idx``, patch-warp BA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..base.geometry import exp_quat, quat_mul, quat_normalize
from . import schur_cuda

__all__ = ["BAOptions", "BAState", "BAObservations", "ba_solve",
           "make_pair_list", "make_point_major"]

# one-hot segment-sum budget of the JAX package (S targets x n items); the
# BA adjuster compares ``Np_pad * obs_chunk`` against it to pick the
# large-scene layout, exactly as the JAX package does
_ONEHOT_BUDGET = 1 << 28


@dataclass(frozen=True)
class BAOptions:
    max_iterations: int = 100
    parameter_tolerance: float = 0.0
    function_tolerance: float = 0.0
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-14
    max_lambda: float = 1e32
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32
    use_inner_iterations: bool = False
    inner_iteration_count: int = 2
    # Ceres use_nonmonotonic_steps: GLL acceptance against the max cost of
    # the last `nonmonotonic_window` accepted iterates; the best-seen state
    # is returned
    use_nonmonotonic_steps: bool = False
    nonmonotonic_window: int = 10
    obs_chunk: int = 8192
    # "dense" (DENSE_SCHUR, not ported yet) or "cg" (ITERATIVE_SCHUR)
    linear_solver: str = "dense"
    max_linear_solver_iterations: int = 100
    # inexact-Newton forcing tolerance of the CG solve (relative residual)
    linear_solver_tol: float = 0.1
    progress: bool = False
    segment_iterations: int = 0
    # >0: the observation axis is packed point-major (slot = point * T +
    # rank, exactly Np * T slots, holes carry valid=False): the grid layout
    obs_grid_T: int = 0

    @classmethod
    def from_solver_conf(cls, conf, **overrides) -> "BAOptions":
        if conf is None:
            return cls(**overrides)
        get = conf.get if hasattr(conf, "get") else lambda k, d=None: conf[k]
        kw = dict(
            max_iterations=int(get("max_num_iterations", 100)),
            parameter_tolerance=float(get("parameter_tolerance", 0.0) or 0.0),
            function_tolerance=float(get("function_tolerance", 0.0) or 0.0),
            use_inner_iterations=bool(get("use_inner_iterations", False)),
            use_nonmonotonic_steps=bool(get("use_nonmonotonic_steps", False)),
            nonmonotonic_window=int(
                get("max_consecutive_nonmonotonic_steps", 10) or 10),
            max_linear_solver_iterations=int(
                get("max_linear_solver_iterations", 100) or 100),
            linear_solver_tol=float(get("linear_solver_tol", 0.1) or 0.1),
            progress=bool(get("minimizer_progress_to_stdout", False)),
            segment_iterations=int(get("segment_iterations", 0) or 0),
        )
        kw.update(overrides)
        return cls(**kw)


class BAState(NamedTuple):
    qvec: torch.Tensor   # [I, 4]
    tvec: torch.Tensor   # [I, 3]
    cams: torch.Tensor   # [Nc, k]
    xyz: torch.Tensor    # [Np, 3]


class BAObservations(NamedTuple):
    """Flat observation arrays (int64 slots, bool ``valid``)."""
    img_idx: torch.Tensor    # [O] -> image slot
    cam_idx: torch.Tensor    # [O] -> camera slot
    pt_idx: torch.Tensor     # [O] -> point slot
    obs_data: Tuple          # per-observation tensors [O, ...]
    valid: torch.Tensor      # [O] bool (padding mask)
    # second pose block per observation (patch-warp source view)
    src_idx: Optional[torch.Tensor] = None


def make_pair_list(pt_idx: np.ndarray, n_points: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """All ordered pairs (o1, o2) of observations sharing a point (host)."""
    order = np.argsort(pt_idx, kind="stable")
    sorted_pts = pt_idx[order]
    starts = np.searchsorted(sorted_pts, np.arange(n_points), side="left")
    ends = np.searchsorted(sorted_pts, np.arange(n_points), side="right")
    o1, o2 = [], []
    for s, e in zip(starts, ends):
        obs = order[s:e]
        if len(obs) == 0:
            continue
        g1, g2 = np.meshgrid(obs, obs, indexing="ij")
        o1.append(g1.ravel())
        o2.append(g2.ravel())
    if not o1:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (np.concatenate(o1).astype(np.int32),
            np.concatenate(o2).astype(np.int32))


def make_point_major(pt_idx: np.ndarray, n_points: int, zero_slot: int,
                     min_T: int = 4) -> np.ndarray:
    """Point-major observation table ``[n_points, T]`` (host): row p holds
    the observation indices of point p's track, empty slots ``zero_slot``;
    T = max track length rounded up to a power of two (>= ``min_T``)."""
    pt_idx = np.asarray(pt_idx)
    order = np.argsort(pt_idx, kind="stable")
    sorted_pts = pt_idx[order]
    starts = np.searchsorted(sorted_pts, np.arange(n_points), side="left")
    counts = np.searchsorted(sorted_pts, np.arange(n_points),
                             side="right") - starts
    T = max(int(counts.max(initial=1)), 1)
    T = max(1 << int(np.ceil(np.log2(T))), min_T)
    out = np.full((n_points, T), zero_slot, np.int32)
    cols = np.arange(len(order)) - starts[sorted_pts]
    out[sorted_pts, cols] = order
    return out


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / determinant, with the
    determinant clamped away from 0 at +-1e-30 as in the JAX package)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    tiny = torch.where(det < 0, torch.full_like(det, -1e-30),
                       torch.full_like(det, 1e-30))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, tiny, det)
    adj = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                       torch.stack([A21, A22, A23], dim=-1),
                       torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return adj * inv_det[..., None, None]


def _apply_tangent(state: BAState, d_pose, d_cam, d_xyz) -> BAState:
    q = quat_normalize(quat_mul(exp_quat(d_pose[:, :3]), state.qvec))
    return BAState(q, state.tvec + d_pose[:, 3:], state.cams + d_cam,
                   state.xyz + d_xyz)


def _cg(A, b, M, maxiter: int, tol: float):
    """``jax.scipy.sparse.linalg.cg`` on a tuple of tensors, step for step:
    x0 = 0 (so r0 = b), stop when ``r.r <= tol^2 * b.b`` or after
    ``maxiter`` steps. Returns (x, steps)."""
    def vdot(u, v):
        return sum(torch.sum(a * c) for a, c in zip(u, v))

    atol2 = torch.tensor(tol, dtype=torch.float32) ** 2 * vdot(b, b)
    x = tuple(torch.zeros_like(bi) for bi in b)
    r = b
    z = M(r)
    p = z
    gamma = vdot(r, z)
    k = 0
    while k < maxiter and bool(vdot(r, r) > atol2):
        Ap = A(p)
        alpha = gamma / vdot(p, Ap)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * api for ri, api in zip(r, Ap))
        z = M(r)
        gamma_new = vdot(r, z)
        beta = gamma_new / gamma
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        gamma = gamma_new
        k += 1
    return x, k


def ba_solve(residual_fn: Callable,
             state0: BAState,
             obs: BAObservations,
             loss,
             pose_free: torch.Tensor,      # [I] bool
             tvec_free: torch.Tensor,      # [I, 3] bool
             cam_free: torch.Tensor,       # [Nc, k] bool
             point_free: torch.Tensor,     # [Np] bool
             opts: BAOptions = BAOptions(),
             ctx=(),
             residual_jac_fn: Optional[Callable] = None,
             lam0=None,
             max_iters=None) -> Tuple[BAState, Dict]:
    """Run the Schur LM on the device of ``state0``.

    ``residual_fn(q [n, 4], t [n, 3], cam [n, k], X [n, 3], obs_slice,
    ctx) -> r [n, C]`` evaluates a chunk of observations (``obs_slice`` is
    the tuple ``obs.obs_data`` sliced to the chunk); ``residual_jac_fn``
    with the same arguments returns ``(r [n, C], J [n, C, 6+k+3])``, the
    Jacobian in the tangent layout ``[omega(3), dt(3), dcam(k), dX(3)]``.
    ``residual_fn`` serves the cost-only evaluations, so the two must agree
    on the residual.

    Returns the best state and a summary ``{initial_cost, final_cost,
    iterations, cg_iterations, lam, done}``."""
    if residual_jac_fn is None:
        raise NotImplementedError(
            "ba_solve without residual_jac_fn (the generic autodiff path) is "
            "not ported yet; see ROADMAP.md section 1, 'The jacfwd path'")
    if obs.src_idx is not None:
        raise NotImplementedError(
            "a second pose block per observation (src_idx, patch-warp BA) "
            "is not ported yet; see ROADMAP.md section 1, 'The other BA "
            "strategies'")
    if opts.linear_solver != "cg":
        raise NotImplementedError(
            "the dense Schur step (linear_solver='dense') is not ported yet; "
            "see ROADMAP.md section 1, 'The dense Schur step'")
    dev = state0.xyz.device
    I = state0.qvec.shape[0]
    Nc, k = state0.cams.shape
    Np = state0.xyz.shape[0]
    O = obs.img_idx.shape[0]
    NR = 6 + k
    grid_T = int(opts.obs_grid_T or 0)
    if grid_T > 0 and O != Np * grid_T:
        raise ValueError(f"obs_grid_T={grid_T}: obs axis must be exactly "
                         f"Np*T ({Np}*{grid_T}={Np * grid_T}), got O={O}")
    img_idx = obs.img_idx.to(dev).long()
    cam_idx = obs.cam_idx.to(dev).long()
    pt_idx = obs.pt_idx.to(dev).long()
    valid = obs.valid.to(dev).bool()
    obs_data = tuple(a.to(dev) for a in obs.obs_data)
    pose_free = pose_free.to(dev).bool()
    pose_mask6 = torch.cat([pose_free[:, None].expand(I, 3),
                            tvec_free.to(dev).bool() & pose_free[:, None]],
                           dim=1)                                  # [I, 6]
    cam_mask = cam_free.to(dev).bool()                              # [Nc, k]
    point_free = point_free.to(dev).bool()
    pm = pose_mask6.float()
    cm = cam_mask.float()
    xm = point_free.float()[:, None].expand(Np, 3)                 # [Np, 3]
    chunk = int(opts.obs_chunk)
    bounds = [(s, min(s + chunk, O)) for s in range(0, O, chunk)]
    # camera slot per image (for the pose-intrinsics cross blocks)
    cam_of_img = torch.zeros(I, dtype=torch.long, device=dev)
    cam_of_img[img_idx] = cam_idx

    def gather(state, s, e):
        return (state.qvec[img_idx[s:e]], state.tvec[img_idx[s:e]],
                state.cams[cam_idx[s:e]], state.xyz[pt_idx[s:e]],
                tuple(a[s:e] for a in obs_data))

    def eval_chunked(state: BAState, with_jac: bool,
                     points_only: bool = False) -> Dict:
        """Chunked per-observation eval -> cost (+ the normal equations)."""
        cost = torch.zeros((), dtype=torch.float32, device=dev)
        out: Dict = {}
        if with_jac:
            img_acc = torch.zeros((I, 42 + 6 * k), device=dev)
            cam_acc = torch.zeros((Nc, k * k + k), device=dev)
            ptv = torch.zeros((O, 12), device=dev)
            B = torch.empty((O, NR, 3), device=dev)
        for s, e in bounds:
            q, t, c, X, sl = gather(state, s, e)
            vm = valid[s:e]
            if with_jac:
                r, J = residual_jac_fn(q, t, c, X, sl, ctx)
            else:
                r = residual_fn(q, t, c, X, sl, ctx)
            sq = torch.sum(r * r, dim=-1)
            cost = cost + 0.5 * torch.sum(torch.where(
                vm, loss(sq), torch.zeros_like(sq)))
            if not with_jac:
                continue
            w = torch.where(vm, loss.weight(sq), torch.zeros_like(sq))
            Ja = torch.where(vm[:, None, None],                   # [n, C, nj]
                             torch.cat([J, r[..., None]], dim=-1), 0.0)
            G = torch.einsum("nci,ncj->nij", Ja * w[:, None, None], Ja)
            n = e - s
            px, xe = 6 + k, 9 + k                                  # xe: r col
            ptv[s:e] = torch.cat([G[:, px:xe, px:xe].reshape(n, 9),
                                  G[:, px:xe, xe]], dim=1)
            if points_only:
                continue
            img_acc.index_add_(0, img_idx[s:e], torch.cat([
                G[:, :6, :6].reshape(n, 36), G[:, :6, xe],
                G[:, :6, 6:px].reshape(n, 6 * k)], dim=1))
            cam_acc.index_add_(0, cam_idx[s:e], torch.cat([
                G[:, 6:px, 6:px].reshape(n, k * k), G[:, 6:px, xe]], dim=1))
            B[s:e] = G[:, :px, px:xe]
        out["cost"] = cost
        if not with_jac:
            return out
        if grid_T > 0:       # point-major slots: a reshape-sum per point
            pt_acc = ptv.reshape(Np, grid_T, 12).sum(1)
        else:
            pt_acc = torch.zeros((Np, 12), device=dev).index_add_(
                0, pt_idx, ptv)
        out["V"] = pt_acc[:, :9].reshape(Np, 3, 3)
        out["gx"] = pt_acc[:, 9:]
        if not points_only:
            out["Hpp"] = img_acc[:, :36].reshape(I, 6, 6)
            out["gp"] = img_acc[:, 36:42]
            out["Hpc"] = img_acc[:, 42:].reshape(I, 6, k)
            out["Hcc"] = cam_acc[:, :k * k].reshape(Nc, k, k)
            out["gc"] = cam_acc[:, k * k:]
            out["B"] = B
        return out

    def cost_at(state: BAState):
        return eval_chunked(state, with_jac=False)["cost"]

    def mask_system(sysd: Dict) -> Dict:
        """Zero out frozen parameter rows/cols in the block system."""
        sysd = dict(sysd)
        sysd["V"] = sysd["V"] * xm[:, :, None] * xm[:, None, :]
        sysd["gx"] = sysd["gx"] * xm
        if "B" not in sysd:
            return sysd
        sysd["Hpp"] = sysd["Hpp"] * pm[:, :, None] * pm[:, None, :]
        sysd["Hcc"] = sysd["Hcc"] * cm[:, :, None] * cm[:, None, :]
        sysd["gp"] = sysd["gp"] * pm
        sysd["gc"] = sysd["gc"] * cm
        sysd["Hpc"] = sysd["Hpc"] * pm[:, :, None] * cm[cam_of_img][:, None, :]
        bm = torch.cat([pm[img_idx], cm[cam_idx]], dim=1)          # [O, NR]
        sysd["B"] = sysd["B"] * bm[:, :, None] * xm[pt_idx][:, None, :]
        return sysd

    def clip_diag(H):
        return torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                           opts.min_diagonal, opts.max_diagonal)

    def damp(Hb, mask, lam: float):
        fill = 1.0 - mask.to(Hb.dtype)
        return Hb + torch.diag_embed(lam * clip_diag(Hb) + fill)

    def schur_terms(B, Vinv):
        """(Schur term, rhs correction, back-substitution) closures of the
        layout in use: K3a/b/c on the grid layout, gathers + index_add_
        on the flat one."""
        if grid_T > 0:
            Btr, img_r, cam_r, Vinv_p, Ppad = schur_cuda.pack_grid_blocks(
                B.reshape(O, 3 * NR).t(), img_idx, cam_idx,
                Vinv.permute(1, 2, 0), grid_T)
            dims = dict(T=grid_T, I=I, Nc=Nc, k=k)

            def term(vp, vc):
                up, uc = schur_cuda.schur_term_matvec(
                    vp.t(), vc.t(), Btr, img_r, cam_r, Vinv_p, **dims)
                return up.t(), uc.t()

            def rhs(gx):
                gxp = torch.cat([gx.t(), gx.new_zeros((3, Ppad - Np))], 1)
                up, uc = schur_cuda.schur_rhs(Btr, img_r, cam_r, Vinv_p,
                                              gxp, **dims)
                return up.t(), uc.t()

            def backsub(vp, vc):
                return schur_cuda.schur_backsub(
                    vp.t(), vc.t(), Btr, img_r, cam_r, **dims)[:, :Np].t()
            return term, rhs, backsub

        def rows(vp, vc):
            return torch.cat([vp[img_idx], vc[cam_idx]], dim=1)    # [O, NR]

        def scatter(u_o):
            up = torch.zeros((I, 6), device=dev).index_add_(0, img_idx,
                                                            u_o[:, :6])
            uc = torch.zeros((Nc, k), device=dev).index_add_(0, cam_idx,
                                                             u_o[:, 6:])
            return up, uc

        def per_point(s_o):
            return torch.zeros((Np, 3), device=dev).index_add_(0, pt_idx,
                                                               s_o)

        def term(vp, vc):
            t_p = per_point(torch.einsum("oa,oab->ob", rows(vp, vc), B))
            w_p = torch.einsum("pab,pb->pa", Vinv, t_p)
            return scatter(torch.einsum("oab,ob->oa", B, w_p[pt_idx]))

        def rhs(gx):
            y = torch.einsum("pab,pb->pa", Vinv, gx)
            return scatter(torch.einsum("oab,ob->oa", B, y[pt_idx]))

        def backsub(vp, vc):
            return per_point(torch.einsum("oab,oa->ob", B, rows(vp, vc)))
        return term, rhs, backsub

    def schur_step(sysd: Dict, lam: float):
        """One damped CG Schur solve -> (d_pose [I, 6], d_cam [Nc, k],
        d_xyz [Np, 3], predicted reduction, CG steps)."""
        Hpp, Hcc, Hpc = sysd["Hpp"], sysd["Hcc"], sysd["Hpc"]
        V, gp, gc, gx = sysd["V"], sysd["gp"], sysd["gc"], sysd["gx"]
        Vinv = _inv3x3(damp(V, xm, lam))
        Hpp_d = damp(Hpp, pose_mask6, lam)
        Hcc_d = damp(Hcc, cam_mask, lam)
        term, rhs, backsub = schur_terms(sysd["B"], Vinv)

        def s_matvec(v):
            vp, vc = v
            avp = torch.einsum("iab,ib->ia", Hpp_d, vp) \
                + torch.einsum("iak,ik->ia", Hpc, vc[cam_of_img])
            avc = torch.einsum("cab,cb->ca", Hcc_d, vc).index_add(
                0, cam_of_img, torch.einsum("iak,ia->ik", Hpc, vp))
            up, uc = term(vp, vc)
            return avp - up, avc - uc

        Minv_p = torch.linalg.inv(Hpp_d)
        Minv_c = torch.linalg.inv(Hcc_d)

        def precond(v):
            return (torch.einsum("iab,ib->ia", Minv_p, v[0]),
                    torch.einsum("cab,cb->ca", Minv_c, v[1]))

        cp, cc = rhs(gx)                     # rhs = g_cam - W Vinv g_x
        (dp_neg, dc_neg), n_cg = _cg(
            s_matvec, (gp - cp, gc - cc), precond,
            opts.max_linear_solver_iterations, opts.linear_solver_tol)
        d_pose = -dp_neg * pm
        d_cam = -dc_neg * cm
        t = backsub(d_pose, d_cam)
        d_xyz = -torch.einsum("pab,pb->pa", Vinv, gx + t) * xm
        g_all = torch.cat([gp.reshape(-1), gc.reshape(-1), gx.reshape(-1)])
        d_all = torch.cat([d_pose.reshape(-1), d_cam.reshape(-1),
                           d_xyz.reshape(-1)])
        Dv = torch.cat([clip_diag(Hpp).reshape(-1),
                        clip_diag(Hcc).reshape(-1),
                        clip_diag(V).reshape(-1)])
        pred = 0.5 * torch.sum(d_all * (lam * Dv * d_all - g_all))
        return d_pose, d_cam, d_xyz, pred, n_cg

    def inner_point_iterations(state: BAState, lam: float, cur_cost):
        """Point-only refinement with cameras fixed (use_inner_iterations)."""
        for _ in range(int(opts.inner_iteration_count)):
            sysd = mask_system(eval_chunked(state, with_jac=True,
                                            points_only=True))
            dx = -torch.einsum("pab,pb->pa", _inv3x3(damp(sysd["V"], xm,
                                                          lam)),
                               sysd["gx"]) * xm
            cand = BAState(state.qvec, state.tvec, state.cams,
                           state.xyz + dx)
            cand_cost = np.float32(cost_at(cand).item())
            if cand_cost < cur_cost:
                state, cur_cost = cand, cand_cost
        return state, cur_cost

    # ------------------------------------------------------------------ loop
    # Without inner iterations the normal equations of an accepted candidate
    # become the next iteration's system (one Jacobian eval per iteration);
    # inner point iterations move xyz after acceptance, so there the system
    # is re-evaluated at the top of each iteration instead.
    f32 = np.float32
    carry_sys = not opts.use_inner_iterations
    state = BAState(*(a.to(dev, torch.float32) for a in state0))
    if carry_sys:
        sysd = mask_system(eval_chunked(state, with_jac=True))
        cost0 = f32(sysd["cost"].item())
    else:
        sysd = None
        cost0 = f32(cost_at(state).item())
    iter_cap = opts.max_iterations if max_iters is None else int(max_iters)
    lam = f32(opts.initial_lambda if lam0 is None else lam0)
    nu = f32(2.0)
    cost = cost0
    window = [cost0] * max(int(opts.nonmonotonic_window), 1)
    best_state, best_cost = state, cost0
    it = 0
    cg_steps = 0
    done = False
    while it < iter_cap and not done:
        if not carry_sys:
            sysd = mask_system(eval_chunked(state, with_jac=True))
        d_pose, d_cam, d_xyz, pred_t, n_cg = schur_step(sysd, float(lam))
        cg_steps += n_cg
        cand = _apply_tangent(state, d_pose, d_cam, d_xyz)
        if carry_sys:
            sys_new = mask_system(eval_chunked(cand, with_jac=True))
            new_cost = f32(sys_new["cost"].item())
        else:
            new_cost = f32(cost_at(cand).item())
        pred = f32(pred_t.item())
        actual = f32(cost - new_cost)
        rho = f32(actual / max(pred, f32(1e-30)))
        if opts.use_nonmonotonic_steps:
            accept = bool(new_cost < max(window)) and bool(pred > 0)
        else:
            accept = bool(actual > 0) and bool(pred > 0)
        lam_acc = f32(lam * max(f32(1.0 / 3.0),
                                f32(1.0 - (f32(2.0) * rho - f32(1.0)) ** 3)))
        lam = f32(np.clip(lam_acc if accept else f32(lam * nu),
                          opts.min_lambda, opts.max_lambda))
        nu = f32(2.0) if accept else f32(nu * 2.0)
        state_before = state
        if accept:
            state = cand
        if opts.use_inner_iterations:
            if accept:
                state, cost_after = inner_point_iterations(state, float(lam),
                                                           new_cost)
            else:
                cost_after = cost
        else:
            cost_after = new_cost if accept else cost
            if accept:
                sysd = sys_new
        conv = False
        if accept and opts.parameter_tolerance > 0:
            ptol = opts.parameter_tolerance
            step = torch.cat([d_pose.reshape(-1), d_cam.reshape(-1),
                              d_xyz.reshape(-1)])
            xn = torch.sqrt(sum(torch.sum(a ** 2) for a in (
                state_before.tvec, state_before.cams, state_before.xyz))
                + 1.0)
            conv = bool(torch.linalg.vector_norm(step) <= ptol * (xn + ptol))
        if accept and opts.function_tolerance > 0:
            conv = conv or bool(abs(actual) <= opts.function_tolerance
                                * max(cost, f32(1e-30)))
        done = conv or bool(lam >= opts.max_lambda)
        if accept:
            window = window[1:] + [cost_after]
            if cost_after < best_cost:
                best_state, best_cost = state, cost_after
        if opts.progress:
            print(f"  LM iter {it:4d}: cost {float(cost_after):.6g} "
                  f"(candidate {float(new_cost):.6g}, lambda "
                  f"{float(lam):.2e}, {'accepted' if accept else 'rejected'}"
                  f", {n_cg} CG steps)", flush=True)
        cost = cost_after
        it += 1
    out_state = best_state if best_cost < cost else state
    summary = dict(initial_cost=float(cost0),
                   final_cost=float(min(cost, best_cost)), iterations=it,
                   cg_iterations=cg_steps, lam=float(lam), done=done)
    return out_state, summary
