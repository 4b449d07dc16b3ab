"""Multi-device sharding of the batched solvers (port of
``pixsfm_tpu/parallel/sharded.py``; SURVEY.md §2.9 / §5.8).

The reference's only parallelism is a thread pool over subproblems plus
Ceres threads (parallel_optimizer.h). The JAX package shards inside one
process: a ``Mesh`` of local devices and ``NamedSharding`` annotations, with
the reductions turned into ``psum``s by XLA. PyTorch has no SPMD compiler,
so this package does the same by hand, in one process and one call:

- a :class:`Mesh` is an ordered tuple of ``torch.device``s with an axis
  name; each entry holds one shard;
- a batch or observation axis splits into contiguous slices in the JAX
  package's order (:func:`shard_bounds`), each slice placed on its shard's
  device, where its kernels (K1, K2) run;
- what the JAX package keeps replicated (parameters, patch stacks) is
  copied to each shard's device (:func:`replicate`, a no-op on the same
  device), and partial results reduce by an explicit sum onto the mesh's
  first device (:func:`sum_onto`) in place of XLA's ``psum``.

The scaling axes are the JAX package's:

- **KA** (and the fixed-target QKA problems): the problem axis of every
  chunk; no cross-shard step at all;
- **references**: the point axis with its tracks' observations (both the
  per-observation reads and the per-point IRLS run on the shard);
- **BA**: the observation axis, padded to a multiple of the mesh size, in
  the flat regime only (``ops/schur.py``); the normal-equation terms and
  each Schur-complement product sum over the shards;
- **PnP** and **QBA**: the query axis.

A mesh may name one device more than once (``Mesh(["cpu"] * 8)``, or
``(cuda:0, cuda:0)`` on a one-card machine): its shards then run in turn on
that device, the counterpart of the JAX tests' virtual host devices
(``--xla_force_host_platform_device_count``). Shards always run in turn from
the calling thread; the kernels of different cards still overlap where no
host read sits between them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "parallel_mesh", "shard_bounds",
           "shard_ka_chunk", "replicate", "sum_onto", "device_scope",
           "sharded_ka_solve", "sharded_ba_solve",
           "sharded_reference_extraction"]


class Mesh:
    """An ordered tuple of devices along one named axis (the JAX package's
    one-axis ``jax.sharding.Mesh``). A device may repeat."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis: str = "data") -> Mesh:
    """The mesh of ``n_devices`` devices of ``device``'s type (``cuda``
    unless ``"cpu"`` is passed). On CUDA: ``cuda:0 .. min(n,
    device_count) - 1`` (all cards when ``n_devices`` is None), as the JAX
    package truncates ``jax.devices()``. On the CPU: ``n_devices`` entries
    of ``cpu`` (one when None), whose shards run in turn."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else min(int(n_devices), count)
        return Mesh([torch.device("cuda", i) for i in range(max(n, 1))],
                    axis)
    return Mesh([dev] * max(int(n_devices or 1), 1), axis)


def parallel_mesh(parallel, device) -> Optional[Mesh]:
    """The mesh of an adjuster's ``parallel: {enabled, n_devices}`` knob
    (``_parallel_mesh`` of the JAX package's adjusters): None unless
    enabled with more than one device. On CUDA ``n_devices`` (all cards
    when None) is clamped to the card count, so a one-card machine runs
    unsharded as JAX does on one chip; on the CPU ``n_devices`` shards of
    the CPU are taken as asked (one, i.e. unsharded, when None)."""
    par = parallel or {}
    if not par.get("enabled"):
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = min(int(par.get("n_devices") or count), count)
    else:
        n = int(par.get("n_devices") or 1)
    if n <= 1:
        return None
    return make_mesh(n, dev)


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """The contiguous slices of an axis of length ``n`` over ``n_shards``
    shards: ``ceil(n / n_shards)`` each in order, the last ones shorter or
    empty (an axis padded to a multiple of the mesh size splits evenly,
    as ``PartitionSpec(axis)`` splits it)."""
    per = -(-int(n) // max(int(n_shards), 1))
    return [(min(i * per, n), min((i + 1) * per, n))
            for i in range(n_shards)]


def replicate(tree, device: torch.device):
    """``tree`` with every tensor in it (through tuples, lists and named
    tuples) on ``device``; other leaves stay as they are. A tensor already
    there is returned as is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(a, device) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(a, device) for a in tree)
    return tree


def sum_onto(parts: Sequence[torch.Tensor], device: torch.device
             ) -> torch.Tensor:
    """The sum of the shards' partial results on ``device`` (the mesh's
    first), in shard order: the port's counterpart of XLA's ``psum``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def device_scope(device: torch.device):
    """The context that makes ``device`` current for the launches of a
    shard (a CUDA device; nothing for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_ka_chunk(mesh: Mesh, axis: str = "data") -> Callable:
    """The placement of a problem batch over ``mesh`` (the JAX package's
    ``NamedSharding(mesh, P(axis))``): a function ``place(a, dtype=None)
    -> [tensor per shard]`` that splits the leading axis of ``a`` by
    :func:`shard_bounds` and puts each slice on its shard's device."""
    def place(a, dtype=None):
        bounds = shard_bounds(len(a), mesh.size)
        out = []
        for (s, e), dev in zip(bounds, mesh.devices):
            part = a[s:e]
            if isinstance(part, torch.Tensor):
                out.append(part.to(device=dev, dtype=dtype))
            else:
                out.append(torch.as_tensor(np.ascontiguousarray(part),
                                           dtype=dtype, device=dev))
        return out
    return place


def sharded_ka_solve(problems, packed_patches, interp, loss, lm_opts,
                     mesh: Mesh, axis: str = "data"):
    """The batched KA LM with the problem axis split over ``mesh``: one
    chunk of ``ceil(P / n)`` problems per shard, each solved on its device
    with the packed patches copied there (KA subproblems are independent:
    no cross-shard step). Returns ``(kp [P, K, 2], summary dict)`` like
    ``solve_ka_problems``."""
    from ..keypoint_adjustment.solver import solve_ka_problems

    nP = problems.kp0.shape[0]
    return solve_ka_problems(problems, packed_patches, interp, loss,
                             lm_opts, chunk=max(-(-nP // mesh.size), 1),
                             mesh=mesh)


def sharded_ba_solve(residual_fn, state0, obs, loss, pose_free, tvec_free,
                     cam_free, point_free, opts, mesh: Mesh,
                     axis: str = "data", ctx=(), residual_jac_fn=None):
    """``ops.schur.ba_solve`` with the observation axis split over
    ``mesh``. As in the JAX package the axis is padded to ``(O // n + 1) *
    n`` slots (at least one invalid slot, the target of padded Schur
    pairs); the parameters stay on the mesh's first device and each
    shard's normal-equation terms are summed there."""
    from ..ops.schur import BAObservations, ba_solve

    n = mesh.size
    O = obs.img_idx.shape[0]
    L = (O // n + 1) * n

    def pad(a, fill=0):
        a = torch.as_tensor(a)
        return torch.cat([a, a.new_full((L - O,) + tuple(a.shape[1:]),
                                        fill)])

    obs_p = BAObservations(
        img_idx=pad(obs.img_idx), cam_idx=pad(obs.cam_idx),
        pt_idx=pad(obs.pt_idx),
        obs_data=tuple(pad(a) for a in obs.obs_data),
        valid=pad(obs.valid, False),
        # the pairs stay: a shard takes those whose first observation it
        # holds, and slot O is now padding for pairs padded onto it
        pair_o1=obs.pair_o1, pair_o2=obs.pair_o2,
        src_idx=None if obs.src_idx is None else pad(obs.src_idx))
    dev = mesh.devices[0]
    state0 = type(state0)(*(torch.as_tensor(a).to(dev) for a in state0))
    return ba_solve(residual_fn, state0, obs_p, loss,
                    torch.as_tensor(pose_free), torch.as_tensor(tvec_free),
                    torch.as_tensor(cam_free), torch.as_tensor(point_free),
                    opts=opts, ctx=ctx, residual_jac_fn=residual_jac_fn,
                    mesh=mesh)


def sharded_reference_extraction(reconstruction, feature_set, view, conf,
                                 interp, mesh: Mesh, axis: str = "data",
                                 **kwargs):
    """Reference extraction with both device stages (the per-observation
    reads and the per-point IRLS) split over ``mesh`` by points; the same
    signature and result as
    ``bundle_adjustment.references.extract_references``."""
    from ..bundle_adjustment.references import extract_references

    return extract_references(reconstruction, feature_set, view, conf,
                              interp, mesh=mesh, **kwargs)
