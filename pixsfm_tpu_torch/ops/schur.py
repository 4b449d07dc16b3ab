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
- Linear step, DENSE (``opts.linear_solver == "dense"``, DENSE_SCHUR; the
  small scenes): the reduced camera system ``S = A - W V^-1 W^T`` is
  assembled on the device, the Schur term from the observation pairs of
  each track (``obs.pair_o1/pair_o2``, ``make_pair_list``) in chunks of
  ``opts.pair_chunk`` pairs with ``index_add_`` into the flattened ``S``,
  and solved by a Jacobi-scaled Cholesky (``cholesky_ex`` + two triangular
  solves). A failed factorization gives a NaN step, which LM rejects, as
  in the JAX package.
- Linear step, CG (``"cg"``, ITERATIVE_SCHUR + block Jacobi): matrix-free
  preconditioned CG on the Schur complement over points. Two layouts apply
  the Schur term ``W V^-1 W^T``: the flat one (gathers + ``index_add_``
  over the observation axis; the JAX package's flat, ``pt_slot`` and
  ``img_slot`` regimes all reduce to it) and the GRID one
  (``opts.obs_grid_T > 0``: observations packed point-major, slot
  ``point * T + rank``), where the Schur term, its right-hand side and the
  point back-substitution run on the hand-written CUDA kernels K3a/b/c
  (``ops/schur_cuda.py``).
- The CG loop copies ``jax.scipy.sparse.linalg.cg``: stop when
  ``r.r <= max(tol^2 b.b, 0)`` (unpreconditioned residual) or after
  ``max_linear_solver_iterations`` steps.
- A second pose block per observation (``obs.src_idx``, the source view of
  patch-warp BA): the Jacobian's columns are ``[img pose 6 | src pose 6 |
  cam k | X 3]``, both pose blocks' diagonals go to the pose blocks, and
  each observation keeps its full camera-side block ``Aob [O, 12+k,
  12+k]``, which carries every img<->src<->intrinsics cross term: the CG
  matvec applies it per observation, the dense step places it at the
  observation's rows (an observation whose source is its own image puts
  both pose blocks on one slot, and ``index_add_`` sums them). Flat layout
  only, as in the JAX package.
- LM with Ceres-style non-monotonic (GLL) acceptance, best-state return and
  optional inner point-only iterations after each accepted step.
- A device mesh (``mesh``, ``parallel/sharded.py``) splits the observation
  axis into shards, each evaluated on its own device; their partial sums
  meet on the mesh's first device (the JAX package's ``psum``s), flat
  layout only. The dense step's pairs go to the shard of their first
  observation, which reads the second one's block from its shard.

The LM loop runs on the host (one device sync per iteration and per CG
step). Without a ``residual_jac_fn`` the Jacobian is forward mode over
``residual_fn`` (:func:`jacfwd_residual_jac`, the JAX package's per-
observation ``jax.jacfwd`` at tangent 0): one ``torch.func.jvp`` per
tangent direction, vmapped over the directions, with every observation of
a chunk at once (each residual depends on its own observation's tangent
only, so the Jacobian is the block diagonal of the chunk's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..base.geometry import exp_quat, quat_mul, quat_normalize
from ..parallel.sharded import replicate, shard_bounds, sum_onto
from ..util.profiling import count, count_on, host, span, to_device
from . import schur_cuda

__all__ = ["BAOptions", "BAState", "BAObservations", "ba_solve",
           "dense_camera_solve", "make_pair_list", "make_point_major",
           "jacfwd_residual_jac"]

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
    # dense step: pairs per chunk of the Schur reduction (bounds the
    # [pair_chunk, 6+k, 6+k] pair blocks that exist at a time)
    pair_chunk: int = 131072
    # "dense" (DENSE_SCHUR) or "cg" (ITERATIVE_SCHUR)
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
    """Flat observation arrays (int64 slots, bool ``valid``) and, for the
    dense step, the ordered same-track observation pairs."""
    img_idx: torch.Tensor    # [O] -> image slot
    cam_idx: torch.Tensor    # [O] -> camera slot
    pt_idx: torch.Tensor     # [O] -> point slot
    obs_data: Tuple          # per-observation tensors [O, ...]
    valid: torch.Tensor      # [O] bool (padding mask)
    pair_o1: Optional[torch.Tensor] = None   # [Q] observation index
    pair_o2: Optional[torch.Tensor] = None   # [Q]
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


def dense_camera_solve(S, rhs):
    """Solve ``S x = rhs`` for the damped reduced camera system by a
    Jacobi-scaled Cholesky (``pixsfm_tpu/ops/schur.py:1325-1338``): BA
    camera systems are badly conditioned at pixel scale, and the symmetric
    diagonal scaling keeps the float32 factorization accurate. A failed
    factorization (``S`` not positive definite) gives NaNs, as JAX's
    Cholesky does, with no host sync."""
    ds = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S)),
                                      min=1e-12))
    L, info = torch.linalg.cholesky_ex(S * ds[:, None] * ds[None, :])
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, (ds * rhs)[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.t(), y, upper=True)[:, 0]
    return ds * x


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
    while k < maxiter and host(vdot(r, r) > atol2, "sync.cg_stop"):
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


def jacfwd_residual_jac(residual_fn: Callable, has_src: bool = False
                        ) -> Callable:
    """A ``residual_jac_fn`` for :func:`ba_solve` from ``residual_fn``
    alone: the residual of a chunk at the tangent ``d = 0`` and its
    Jacobian ``[n, C, D]`` in ``ba_solve``'s tangent layout (``D = 6 + k +
    3``, or ``12 + k + 3`` with a source pose), by forward mode
    (``obs_residual`` under ``jax.jacfwd`` in the JAX package,
    ``ops/schur.py:481-500``, ``:664-681``). The pose moves by ``q <-
    normalize(exp(omega) q)``, ``t <- t + dt``; intrinsics and point
    additively. ``torch.func.vmap`` runs the D tangents of every
    observation of the chunk in one pass; a feature read inside
    ``residual_fn`` must be forward-differentiable
    (``ops/interpolate_cuda.interpolate_fwd`` is, and reads once)."""
    PB = 12 if has_src else 6

    def residual_jac_fn(*args):
        if has_src:
            q, t, qs, ts, cam, X, sl, ctx = args
        else:
            q, t, cam, X, sl, ctx = args
        n, k = cam.shape
        D = PB + k + 3

        def rfun(d):
            pose = (quat_normalize(quat_mul(exp_quat(d[:, :3]), q)),
                    t + d[:, 3:6])
            if has_src:
                pose += (quat_normalize(quat_mul(exp_quat(d[:, 6:9]), qs)),
                         ts + d[:, 9:12])
            return residual_fn(*pose, cam + d[:, PB:PB + k],
                               X + d[:, PB + k:], sl, ctx)

        d0 = X.new_zeros((n, D))
        basis = torch.eye(D, dtype=X.dtype, device=X.device)[:, None, :] \
            .expand(D, n, D)
        r, Jt = torch.func.vmap(
            lambda tan: torch.func.jvp(rfun, (d0,), (tan,)),
            out_dims=(None, 0))(basis)
        return r, Jt.permute(1, 2, 0)

    return residual_jac_fn


class _Shard(NamedTuple):
    """Shard ``index`` of the observation axis, a contiguous slice of it
    on device ``dev`` (the whole axis when no mesh is given), with ``ctx``
    on that device and the evaluation chunks ``bounds`` local to it."""
    index: int
    dev: torch.device
    img_idx: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    src_idx: Optional[torch.Tensor]
    valid: torch.Tensor
    obs_data: Tuple
    ctx: object
    bounds: List[Tuple[int, int]]


def _observation_shards(obs: BAObservations, mesh, dev: torch.device, ctx,
                        chunk: int) -> List[_Shard]:
    """The observation axis as :func:`ba_solve` evaluates it: one shard on
    ``dev`` without a mesh; with one, ``mesh.size`` contiguous slices of
    equal length (the axis must be padded to a multiple of the mesh size),
    each moved to its mesh device with a copy of the tensors of ``ctx``."""
    O = obs.img_idx.shape[0]
    devices = (dev,) if mesh is None else mesh.devices
    if O % len(devices):
        raise ValueError(f"{O} observation slots do not split evenly over "
                         f"a mesh of {len(devices)}; pad them to a multiple")
    shards = []
    for i, ((s, e), d) in enumerate(zip(shard_bounds(O, len(devices)),
                                        devices)):
        def part(a, dtype=None):
            return None if a is None else a[s:e].to(d, dtype)
        shards.append(_Shard(
            i, d, part(obs.img_idx, torch.long),
            part(obs.cam_idx, torch.long), part(obs.pt_idx, torch.long),
            part(obs.src_idx, torch.long), part(obs.valid, torch.bool),
            tuple(part(a) for a in obs.obs_data), replicate(ctx, d),
            [(b, min(b + chunk, e - s)) for b in range(0, e - s, chunk)]))
    return shards


def _pair_shards(obs: BAObservations, shards: List[_Shard]):
    """The dense step's observation pairs by shard: for each shard, the
    pairs whose first observation it holds, grouped by the shard holding
    the second, as ``[(owner, local o1, owner-local o2, both valid)]`` on
    the shard's device (one group, in the pair list's order, without a
    mesh)."""
    L = shards[0].img_idx.shape[0]
    o1 = host(obs.pair_o1.long(), "sync.pairs")
    o2 = host(obs.pair_o2.long(), "sync.pairs")
    valid = torch.cat([host(sh.valid, "sync.pairs") for sh in shards])
    ok = valid[o1] & valid[o2]
    out = []
    for sh in shards:
        groups = []
        mine = (o1 // L) == sh.index
        for t in range(len(shards)):
            sel = mine & ((o2 // L) == t)
            if not bool(sel.any()):
                continue
            groups.append((t, to_device(o1[sel] - sh.index * L, sh.dev),
                           to_device(o2[sel] - t * L, sh.dev),
                           to_device(ok[sel], sh.dev)))
        out.append(groups)
    return out


def _eval_chunks(residual_fn: Callable, residual_jac_fn: Callable, loss,
                 state: BAState, sh: _Shard, I: int, with_jac: bool,
                 points_only: bool) -> Dict:
    """The chunk loop of :func:`ba_solve`'s evaluation: shard ``sh``'s
    observations (``state`` on its device) in chunks of its ``bounds``,
    each through ``residual_fn`` (cost only) or ``residual_jac_fn`` and the
    Gram matrix ``G = w [J | r]^T [J | r]`` of each observation -> its cost
    and, with the Jacobian, each observation's point rows ``ptv [n, 12]``
    (point block and gradient); unless ``points_only`` also the camera-
    point blocks ``B [n, NR, 3]``, the image rows ``img [I, ...]`` and
    camera rows ``cam [Nc, k*k+k]`` summed over the observations (and, with
    a source pose, the camera-side blocks ``Aob``)."""
    has_src = sh.src_idx is not None
    Nc, k = state.cams.shape
    PB = 12 if has_src else 6
    NR = PB + k

    def gather(state, sh, s, e):
        """The arguments of the residual functions for chunk [s, e) of
        shard ``sh`` (``state`` on the shard's device)."""
        src = ((state.qvec[sh.src_idx[s:e]], state.tvec[sh.src_idx[s:e]])
               if has_src else ())
        return (state.qvec[sh.img_idx[s:e]], state.tvec[sh.img_idx[s:e]],
                *src, state.cams[sh.cam_idx[s:e]],
                state.xyz[sh.pt_idx[s:e]],
                tuple(a[s:e] for a in sh.obs_data), sh.ctx)

    d, n_sh = sh.dev, sh.img_idx.shape[0]
    cost = torch.zeros((), dtype=torch.float32, device=d)
    out: Dict = {}
    if with_jac:
        img_acc = torch.zeros((I, 42 if has_src else 42 + 6 * k),
                              device=d)
        cam_acc = torch.zeros((Nc, k * k + k), device=d)
        ptv = torch.zeros((n_sh, 12), device=d)
        B = torch.empty((n_sh, NR, 3), device=d)
        if has_src and not points_only:
            Aob = torch.empty((n_sh, NR, NR), device=d)
    for s, e in sh.bounds:
        args = gather(state, sh, s, e)
        vm = sh.valid[s:e]
        if with_jac:
            r, J = residual_jac_fn(*args)
        else:
            r = residual_fn(*args)
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
        px, xe = NR, NR + 3                                    # xe: r col
        ptv[s:e] = torch.cat([G[:, px:xe, px:xe].reshape(n, 9),
                              G[:, px:xe, xe]], dim=1)
        if points_only:
            continue
        if has_src:
            img_acc.index_add_(0, sh.img_idx[s:e], torch.cat([
                G[:, :6, :6].reshape(n, 36), G[:, :6, xe]], dim=1))
            img_acc.index_add_(0, sh.src_idx[s:e], torch.cat([
                G[:, 6:12, 6:12].reshape(n, 36), G[:, 6:12, xe]], dim=1))
            Aob[s:e] = G[:, :px, :px]
        else:
            img_acc.index_add_(0, sh.img_idx[s:e], torch.cat([
                G[:, :6, :6].reshape(n, 36), G[:, :6, xe],
                G[:, :6, 6:px].reshape(n, 6 * k)], dim=1))
        cam_acc.index_add_(0, sh.cam_idx[s:e], torch.cat([
            G[:, PB:px, PB:px].reshape(n, k * k), G[:, PB:px, xe]],
            dim=1))
        B[s:e] = G[:, :px, px:xe]
    out["cost"] = cost
    if not with_jac:
        return out
    out["ptv"] = ptv
    if not points_only:
        out.update(img=img_acc, cam=cam_acc, B=B)
        if has_src:
            out["Aob"] = Aob
    return out


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
             max_iters=None,
             mesh=None,
             fused_eval: Optional[Callable] = None) -> Tuple[BAState, Dict]:
    """Run the Schur LM on the device of ``state0``.

    ``residual_fn(q [n, 4], t [n, 3], cam [n, k], X [n, 3], obs_slice,
    ctx) -> r [n, C]`` evaluates a chunk of observations (``obs_slice`` is
    the tuple ``obs.obs_data`` sliced to the chunk); ``residual_jac_fn``
    with the same arguments returns ``(r [n, C], J [n, C, 6+k+3])``, the
    Jacobian in the tangent layout ``[omega(3), dt(3), dcam(k), dX(3)]``.
    ``residual_fn`` serves the cost-only evaluations, so the two must agree
    on the residual. Without ``residual_jac_fn`` the Jacobian is forward
    mode over ``residual_fn`` (:func:`jacfwd_residual_jac`). With
    ``obs.src_idx`` both take the source pose after the image's, ``(q, t,
    q_src, t_src, cam, X, obs_slice, ctx)``, and the Jacobian's layout is
    ``[omega, dt, omega_src, dt_src, dcam, dX]`` (JAX's ``ba_solve`` takes
    ``jax.jacfwd`` there and refuses a ``residual_jac_fn``).

    ``mesh`` (a ``parallel.Mesh``): the observation axis, padded to a
    multiple of the mesh size, splits into one contiguous shard per mesh
    device (``_observation_shards``). Each shard evaluates its
    observations' residuals and Jacobians on its device and accumulates its
    partial normal-equation terms there; the partials, and each Schur
    product over the observations, are summed onto the first device, where
    the parameters and the camera-side solve live. The flat regime only,
    as in the JAX package: no grid layout, so K3 is not reached.

    ``fused_eval(state, shard, mode)``: a whole-shard evaluator in place of
    the chunk loop (``_eval_chunks``), for a single shard without
    ``src_idx`` (anything else raises): ``mode`` is ``"cost"``, ``"points"`` or ``"full"`` and it
    returns what ``_eval_chunks`` returns for that mode (the fused feature-
    reference evaluation, ``ops/ba_eval_cuda.ba_eval``, kernel K4, which
    ``bundle_adjustment/main.py`` hands over where it takes the inputs).
    Each evaluation counts one under ``ba.eval.fused`` or
    ``ba.eval.chunked`` (``util/profiling.count``).

    Returns the best state and a summary ``{initial_cost, final_cost,
    iterations, cg_iterations, lam, done}``."""
    if opts.linear_solver not in ("dense", "cg"):
        raise ValueError(f"unknown linear_solver {opts.linear_solver!r}")
    dense = opts.linear_solver == "dense"
    if dense and (obs.pair_o1 is None or obs.pair_o2 is None
                  or opts.obs_grid_T):
        raise ValueError("the dense step needs the flat layout and the "
                         "observation pairs (obs.pair_o1/pair_o2, "
                         "make_pair_list)")
    dev = state0.xyz.device if mesh is None else mesh.devices[0]
    I = state0.qvec.shape[0]
    Nc, k = state0.cams.shape
    Np = state0.xyz.shape[0]
    O = obs.img_idx.shape[0]
    has_src = obs.src_idx is not None
    if residual_jac_fn is None:
        residual_jac_fn = jacfwd_residual_jac(residual_fn, has_src)
    PB = 12 if has_src else 6          # pose tangent rows per observation
    NR = PB + k
    grid_T = int(opts.obs_grid_T or 0)
    if has_src and grid_T:
        raise ValueError("the grid layout does not take a second pose block "
                         "per observation (src_idx)")
    if grid_T > 0 and O != Np * grid_T:
        raise ValueError(f"obs_grid_T={grid_T}: obs axis must be exactly "
                         f"Np*T ({Np}*{grid_T}={Np * grid_T}), got O={O}")
    shards = _observation_shards(obs, mesh, dev, ctx, int(opts.obs_chunk))
    if grid_T > 0 and len(shards) > 1:
        raise ValueError("the grid layout takes no mesh: a sharded "
                         "observation axis runs the flat regime")
    if fused_eval is not None and (len(shards) > 1 or has_src):
        raise ValueError("fused_eval evaluates one shard without a source "
                         "pose: a mesh or src_idx runs the chunk loop")
    pose_free = pose_free.to(dev).bool()
    pose_mask6 = torch.cat([pose_free[:, None].expand(I, 3),
                            tvec_free.to(dev).bool() & pose_free[:, None]],
                           dim=1)                                  # [I, 6]
    cam_mask = cam_free.to(dev).bool()                              # [Nc, k]
    point_free = point_free.to(dev).bool()
    pm = pose_mask6.float()
    cm = cam_mask.float()
    xm = point_free.float()[:, None].expand(Np, 3)                 # [Np, 3]
    # camera slot per image (for the pose-intrinsics cross blocks), from
    # the valid slots: the padding slots point at image 0 and camera 0,
    # which need not belong together
    cam_of_img = torch.zeros(I, dtype=torch.long, device=dev)
    for sh in shards:
        count_on(sh.dev, "sync.mask")
        img = sh.img_idx[sh.valid]
        count_on(sh.dev, "sync.mask")
        cam_of_img[img.to(dev)] = sh.cam_idx[sh.valid].to(dev)

    def reduce(parts):
        """The shards' partial results summed onto ``dev``."""
        return sum_onto(parts, dev)

    def eval_shard(state, sh, with_jac: bool, points_only: bool):
        """Per-observation eval of one shard on its device -> its cost (+
        its partial normal equations and observation blocks): one call of
        ``fused_eval`` where it is given, else the chunk loop."""
        if fused_eval is not None:
            raw = fused_eval(state, sh, "full" if with_jac and not points_only
                             else "points" if with_jac else "cost")
        else:
            raw = _eval_chunks(residual_fn, residual_jac_fn, loss, state, sh,
                               I, with_jac, points_only)
        out: Dict = {"cost": raw["cost"]}
        if not with_jac:
            return out
        if grid_T > 0:       # point-major slots: a reshape-sum per point
            out["pt"] = raw["ptv"].reshape(Np, grid_T, 12).sum(1)
        else:
            out["pt"] = torch.zeros((Np, 12), device=sh.dev).index_add_(
                0, sh.pt_idx, raw["ptv"])
        if not points_only:
            out.update(img=raw["img"], cam=raw["cam"], B=raw["B"])
            if has_src:
                out["Aob"] = raw["Aob"]
        return out

    def eval_chunked(state: BAState, with_jac: bool,
                     points_only: bool = False) -> Dict:
        """Per-observation eval of every shard -> cost (+ the normal
        equations, summed over the shards onto ``dev``; the per-
        observation blocks ``B`` / ``Aob`` stay on their shards, one entry
        per shard)."""
        count("ba.eval.chunked" if fused_eval is None else "ba.eval.fused")
        parts = [eval_shard(replicate(state, sh.dev), sh, with_jac,
                            points_only) for sh in shards]
        out: Dict = {"cost": reduce([p["cost"] for p in parts])}
        if not with_jac:
            return out
        pt_acc = reduce([p["pt"] for p in parts])
        out["V"] = pt_acc[:, :9].reshape(Np, 3, 3)
        out["gx"] = pt_acc[:, 9:]
        if not points_only:
            img_acc = reduce([p["img"] for p in parts])
            cam_acc = reduce([p["cam"] for p in parts])
            out["Hpp"] = img_acc[:, :36].reshape(I, 6, 6)
            out["gp"] = img_acc[:, 36:42]
            if has_src:
                out["Aob"] = [p["Aob"] for p in parts]
            else:
                out["Hpc"] = img_acc[:, 42:].reshape(I, 6, k)
            out["Hcc"] = cam_acc[:, :k * k].reshape(Nc, k, k)
            out["gc"] = cam_acc[:, k * k:]
            out["B"] = [p["B"] for p in parts]
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
        if not has_src:
            sysd["Hpc"] = (sysd["Hpc"] * pm[:, :, None]
                           * cm[cam_of_img][:, None, :])
        Bs, Aobs = [], []
        for i, sh in enumerate(shards):
            pm_d, cm_d, xm_d = replicate((pm, cm, xm), sh.dev)
            src = (pm_d[sh.src_idx],) if has_src else ()
            bm = torch.cat([pm_d[sh.img_idx], *src, cm_d[sh.cam_idx]],
                           dim=1)                                  # [O, NR]
            if has_src:
                Aobs.append(sysd["Aob"][i] * bm[:, :, None]
                            * bm[:, None, :])
            Bs.append(sysd["B"][i] * bm[:, :, None]
                      * xm_d[sh.pt_idx][:, None, :])
        sysd["B"] = Bs
        if has_src:
            sysd["Aob"] = Aobs
        return sysd

    def clip_diag(H):
        return torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                           opts.min_diagonal, opts.max_diagonal)

    def damp(Hb, mask, lam: float):
        fill = 1.0 - mask.to(Hb.dtype)
        return Hb + torch.diag_embed(lam * clip_diag(Hb) + fill)

    def schur_terms(Bs, Vinv):
        """(Schur term, rhs correction, back-substitution) closures of the
        layout in use: K3a/b/c on the grid layout, gathers + index_add_
        on the flat one (each shard's observations on its device, their
        partial sums reduced onto ``dev``)."""
        if grid_T > 0:
            sh, B = shards[0], Bs[0]
            Btr, img_r, cam_r, Vinv_p, Ppad = schur_cuda.pack_grid_blocks(
                B.reshape(O, 3 * NR).t(), sh.img_idx, sh.cam_idx,
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

        def per_point(parts):
            """``[Np, 3]`` sums of the shards' per-observation vectors."""
            return reduce([torch.zeros((Np, 3), device=sh.dev).index_add_(
                0, sh.pt_idx, s_o) for sh, s_o in zip(shards, parts)])

        def to_obs(y):
            """A per-point vector through each shard's ``B`` blocks."""
            return [torch.einsum("oab,ob->oa", B, y.to(sh.dev)[sh.pt_idx])
                    for sh, B in zip(shards, Bs)]

        def term(vp, vc):
            t_p = per_point([torch.einsum("oa,oab->ob", obs_rows(sh, vp, vc),
                                          B) for sh, B in zip(shards, Bs)])
            return scatter(to_obs(torch.einsum("pab,pb->pa", Vinv, t_p)))

        def rhs(gx):
            return scatter(to_obs(torch.einsum("pab,pb->pa", Vinv, gx)))

        def backsub(vp, vc):
            return per_point([torch.einsum("oab,oa->ob", B,
                                           obs_rows(sh, vp, vc))
                              for sh, B in zip(shards, Bs)])
        return term, rhs, backsub

    def obs_rows(sh, vp, vc):
        """The camera-side rows ``[n, NR]`` of shard ``sh``'s observations
        from per-image / per-camera vectors (both pose blocks with a source
        view)."""
        vp, vc = vp.to(sh.dev), vc.to(sh.dev)
        src = (vp[sh.src_idx],) if has_src else ()
        return torch.cat([vp[sh.img_idx], *src, vc[sh.cam_idx]], dim=1)

    def scatter(parts):
        """The shards' per-observation rows ``[n, NR]`` reduced back to
        per-image / per-camera vectors on ``dev``."""
        ups, ucs = [], []
        for sh, u_o in zip(shards, parts):
            up = torch.zeros((I, 6), device=sh.dev).index_add_(
                0, sh.img_idx, u_o[:, :6])
            if has_src:
                up.index_add_(0, sh.src_idx, u_o[:, 6:12])
            ups.append(up)
            ucs.append(torch.zeros((Nc, k), device=sh.dev).index_add_(
                0, sh.cam_idx, u_o[:, PB:]))
        return reduce(ups), reduce(ucs)

    def schur_step(sysd: Dict, lam: float):
        """One damped CG Schur solve -> (d_pose [I, 6], d_cam [Nc, k],
        d_xyz [Np, 3], predicted reduction, CG steps)."""
        Hpp, Hcc = sysd["Hpp"], sysd["Hcc"]
        V, gp, gc, gx = sysd["V"], sysd["gp"], sysd["gc"], sysd["gx"]
        Vinv = _inv3x3(damp(V, xm, lam))
        Hpp_d = damp(Hpp, pose_mask6, lam)
        Hcc_d = damp(Hcc, cam_mask, lam)
        term, rhs, backsub = schur_terms(sysd["B"], Vinv)

        if has_src:
            # the camera-side matrix through the per-observation blocks;
            # the damping (and the fill of frozen rows) on its diagonal
            Aobs = sysd["Aob"]
            diag_p = lam * clip_diag(Hpp) + (1.0 - pm)
            diag_c = lam * clip_diag(Hcc) + (1.0 - cm)

            def a_matvec(vp, vc):
                avp, avc = scatter([
                    torch.einsum("oab,ob->oa", A, obs_rows(sh, vp, vc))
                    for sh, A in zip(shards, Aobs)])
                return avp + diag_p * vp, avc + diag_c * vc
        else:
            Hpc = sysd["Hpc"]

            def a_matvec(vp, vc):
                avp = torch.einsum("iab,ib->ia", Hpp_d, vp) \
                    + torch.einsum("iak,ik->ia", Hpc, vc[cam_of_img])
                avc = torch.einsum("cab,cb->ca", Hcc_d, vc).index_add(
                    0, cam_of_img, torch.einsum("iak,ia->ik", Hpc, vp))
                return avp, avc

        def s_matvec(v):
            avp, avc = a_matvec(*v)
            up, uc = term(*v)
            return avp - up, avc - uc

        count_on(dev, "sync.inv")      # inv checks its info on the host
        Minv_p = torch.linalg.inv(Hpp_d)
        count_on(dev, "sync.inv")
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

    if dense:
        # global row of each observation's camera-side block in the reduced
        # camera system: [pose rows of its image | intrinsics rows of its
        # camera]
        M = 6 * I + Nc * k
        r6 = torch.arange(6, device=dev)
        rk = torch.arange(k, device=dev)
        pose_rows = torch.arange(I, device=dev)[:, None] * 6 + r6    # [I, 6]
        cam_rows = 6 * I + torch.arange(Nc, device=dev)[:, None] * k + rk
        obs_rows_g = [obs_rows(sh, pose_rows, cam_rows)              # [n, NR]
                      for sh in shards]
        free_rows = torch.cat([pose_mask6.reshape(-1),
                               cam_mask.reshape(-1)]).float()
        pairs = _pair_shards(obs, shards)
        Q = obs.pair_o1.shape[0]
        pc = max(min(int(opts.pair_chunk), Q), 1)

    def place(S, rows, cols, blocks):
        """``S[rows[n, a], cols[n, b]] += blocks[n, a, b]`` on the flattened
        ``[M * M]`` system."""
        idx = rows[:, :, None] * M + cols[:, None, :]
        S.index_add_(0, idx.reshape(-1), blocks.reshape(-1))

    def dense_step(sysd: Dict, lam: float):
        """One damped dense Schur solve (``pixsfm_tpu/ops/schur.py:1253-
        1354``) -> (d_pose, d_cam, d_xyz, predicted reduction, 0)."""
        V, gp, gc, gx, Bs = (sysd["V"], sysd["gp"], sysd["gc"], sysd["gx"],
                             sysd["B"])
        Vinv = _inv3x3(damp(V, xm, lam))
        # the camera-side matrix A from its blocks, placed by index: with a
        # source view, every term (both poses, intrinsics, all cross
        # blocks) lives in the per-observation blocks
        if has_src:
            parts = []
            for sh, rows_o, Aob in zip(shards, obs_rows_g, sysd["Aob"]):
                A_s = torch.zeros(M * M, device=sh.dev)
                place(A_s, rows_o, rows_o, Aob)
                parts.append(A_s)
            A = reduce(parts)
        else:
            A = torch.zeros(M * M, device=dev)
            Hpc = sysd["Hpc"]
            crow_img = cam_rows[cam_of_img]                          # [I, k]
            place(A, pose_rows, pose_rows, sysd["Hpp"])
            place(A, pose_rows, crow_img, Hpc)
            place(A, crow_img, pose_rows, Hpc.transpose(1, 2))
            place(A, cam_rows, cam_rows, sysd["Hcc"])
        A = A.view(M, M)
        diagA = clip_diag(A)
        A = A + torch.diag(lam * diagA + (1.0 - free_rows))
        # the Schur term B[o1] V^-1 B[o2]^T of every same-track pair, placed
        # at (rows(o1), rows(o2)); padded pairs point at an invalid slot. A
        # shard takes the pairs whose first observation it holds, and reads
        # the second one's block and rows from the shard that holds it.
        parts = []
        for sh, B, rows_o, by_owner in zip(shards, Bs, obs_rows_g, pairs):
            Ssub = torch.zeros(M * M, device=sh.dev)
            Vinv_s = Vinv.to(sh.dev)
            for t, p1, p2, ok in by_owner:
                B2 = Bs[t].to(sh.dev) if t != sh.index else B
                rows2 = obs_rows_g[t].to(sh.dev)
                for s in range(0, p1.shape[0], pc):
                    q1, q2 = p1[s:s + pc], p2[s:s + pc]
                    T1 = torch.einsum("qab,qbc->qac", B[q1],
                                      Vinv_s[sh.pt_idx[q1]])
                    Cp = torch.einsum("qac,qdc->qad", T1, B2[q2])
                    Cp = torch.where(ok[s:s + pc, None, None], Cp, 0.0)
                    place(Ssub, rows_o[q1], rows2[q2], Cp)
            parts.append(Ssub)
        S = A - reduce(parts).view(M, M)
        # rhs: g_cam - sum_obs B_o Vinv_p g_p
        corr = []
        for sh, B, rows_o in zip(shards, Bs, obs_rows_g):
            Vinv_s, gx_s = replicate((Vinv, gx), sh.dev)
            c_o = torch.einsum("oab,ob->oa", torch.einsum(
                "oab,obc->oac", B, Vinv_s[sh.pt_idx]), gx_s[sh.pt_idx])
            corr.append(torch.zeros(M, device=sh.dev).index_add_(
                0, rows_o.reshape(-1), c_o.reshape(-1)))
        g_cam = torch.cat([gp.reshape(-1), gc.reshape(-1)])
        rhs = g_cam - reduce(corr)
        dc_full = -dense_camera_solve(S, rhs) * free_rows
        d_pose = dc_full[:6 * I].reshape(I, 6)
        d_cam = dc_full[6 * I:].reshape(Nc, k)
        # back-substitute the points: dx = -Vinv (gx + sum_obs B^T dc_obs)
        t = reduce([torch.zeros((Np, 3), device=sh.dev).index_add_(
            0, sh.pt_idx, torch.einsum("oab,oa->ob", B,
                                       dc_full.to(sh.dev)[rows_o]))
            for sh, B, rows_o in zip(shards, Bs, obs_rows_g)])
        d_xyz = -torch.einsum("pab,pb->pa", Vinv, gx + t) * xm
        g_all = torch.cat([g_cam, gx.reshape(-1)])
        d_all = torch.cat([dc_full, d_xyz.reshape(-1)])
        Dv = torch.cat([diagA, clip_diag(V).reshape(-1)])
        pred = 0.5 * torch.sum(d_all * (lam * Dv * d_all - g_all))
        return d_pose, d_cam, d_xyz, pred, 0

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
            cand_cost = np.float32(host(cost_at(cand), "sync.cost"))
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
    with span("ba.lm.eval"):
        if carry_sys:
            sysd = mask_system(eval_chunked(state, with_jac=True))
            cost0 = f32(host(sysd["cost"], "sync.cost"))
        else:
            sysd = None
            cost0 = f32(host(cost_at(state), "sync.cost"))
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
        with span("ba.lm.iter"):
            if not carry_sys:
                with span("ba.lm.eval"):
                    sysd = mask_system(eval_chunked(state, with_jac=True))
            with span("ba.lm.step"):
                d_pose, d_cam, d_xyz, pred_t, n_cg = (
                    dense_step if dense else schur_step)(sysd, float(lam))
                cg_steps += n_cg
                cand = _apply_tangent(state, d_pose, d_cam, d_xyz)
            with span("ba.lm.eval"):
                if carry_sys:
                    sys_new = mask_system(eval_chunked(cand, with_jac=True))
                    new_cost = f32(host(sys_new["cost"], "sync.cost"))
                else:
                    new_cost = f32(host(cost_at(cand), "sync.cost"))
            with span("ba.lm.decide"):
                pred = f32(host(pred_t, "sync.pred"))
                actual = f32(cost - new_cost)
                rho = f32(actual / max(pred, f32(1e-30)))
                if opts.use_nonmonotonic_steps:
                    accept = bool(new_cost < max(window)) and bool(pred > 0)
                else:
                    accept = bool(actual > 0) and bool(pred > 0)
                lam_acc = f32(lam * max(f32(1.0 / 3.0), f32(
                    1.0 - (f32(2.0) * rho - f32(1.0)) ** 3)))
                lam = f32(np.clip(lam_acc if accept else f32(lam * nu),
                                  opts.min_lambda, opts.max_lambda))
                nu = f32(2.0) if accept else f32(nu * 2.0)
                state_before = state
                if accept:
                    state = cand
            if opts.use_inner_iterations:
                if accept:
                    with span("ba.lm.inner"):
                        state, cost_after = inner_point_iterations(
                            state, float(lam), new_cost)
                else:
                    cost_after = cost
            else:
                cost_after = new_cost if accept else cost
                if accept:
                    sysd = sys_new
            with span("ba.lm.decide"):
                conv = False
                if accept and opts.parameter_tolerance > 0:
                    ptol = opts.parameter_tolerance
                    step = torch.cat([d_pose.reshape(-1), d_cam.reshape(-1),
                                      d_xyz.reshape(-1)])
                    xn = torch.sqrt(sum(torch.sum(a ** 2) for a in (
                        state_before.tvec, state_before.cams,
                        state_before.xyz)) + 1.0)
                    conv = host(torch.linalg.vector_norm(step)
                                <= ptol * (xn + ptol), "sync.conv")
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
                          f"{float(lam):.2e}, "
                          f"{'accepted' if accept else 'rejected'}"
                          f", {n_cg} CG steps)", flush=True)
            cost = cost_after
            it += 1
    out_state = best_state if best_cost < cost else state
    summary = dict(initial_cost=float(cost0),
                   final_cost=float(min(cost, best_cost)), iterations=it,
                   cg_iterations=cg_steps, lam=float(lam), done=done)
    return out_state, summary
