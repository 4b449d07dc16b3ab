"""Featuremetric keypoint adjustment as one batched LM program.

Port of ``pixsfm_tpu/keypoint_adjustment/solver.py`` (reference:
pixsfm/keypoint_adjustment/src/featuremetric_keypoint_optimizer.h). All
subproblems (FFD bins of tracks) are solved lock-stepped per chunk:

- parameters: ``kp [P, K, 2]`` image-coordinate keypoints, padded per problem;
- residuals: per intra-track match edge ``r_e = f_i(kp_i) - f_j(kp_j)`` with
  ``f`` the interpolated (by default L2-normalized bicubic) descriptor of
  each keypoint's feature patch, read straight from the flat row view of
  the packed patch tensor through ``ops/interpolate_cuda.interpolate``
  (kernel K1 on CUDA for BICUBIC / CERES_BICUBIC; plain PyTorch for
  BILINEAR, NEARESTNEIGHBOR and BICUBICCHAIN); with node windows ``f`` is
  the flattened ``[n_nodes * C]`` window, NCC-normalized across the nodes
  when configured (the reference's EvaluateNodes residual);
- robustification: IRLS weights ``sim_e * rho'(||r||^2)``;
- normal equations in Gram form (``make_ka_system``), solved by the batched
  LM of ``ops/lm.py`` (Jacobi CG, kernel K2 on CUDA);
- bounds: patch extent intersected with ``kp0 +- bound/scale``.

Root keypoints are frozen (SetMaskedNodesConstant).

The fixed-target solver (:func:`solve_target_problems`): one 2-DoF keypoint
per problem against constant reference descriptors —
``topological_reference`` KA (the root descriptor is the target) and query
keypoint adjustment (QKA, the references of the matched 3D points). Its
system is built from the same read's ``(f, dfdr, dfdc)``, and
:func:`evaluate_descriptors` reads descriptors through it too.

``compaction_segment > 0`` runs the LM in segments of that many iterations
and re-packs the unconverged problems between segments, their damping
warm-started (``solve_ka_problems``).

``mesh`` (a ``parallel.Mesh``, both solvers): the problem axis of every
chunk splits into one contiguous shard per mesh device, each solved on its
device (its K1 reads and K2 solves there) with the packed patches copied
to it. The problems are independent, so no shard waits on another; the
chunk scales by the mesh size, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import logger, resolve_device
from ..base.interpolation import (InterpolationConfig, check_window_config,
                                  output_dim)
from ..base.losses import RobustLoss
from ..ops.interpolate_cuda import interpolate
from ..ops.lm import LMOptions, lm_solve
from ..parallel.sharded import device_scope, replicate, shard_bounds
from ..util.misc import bucket
from ..util.profiling import merge_summaries

__all__ = ["KAProblems", "build_ka_problems", "make_ka_system",
           "solve_ka_problems", "evaluate_descriptors", "make_target_system",
           "solve_target_problems"]


@dataclass
class KAProblems:
    """Padded, batched KA subproblems (host arrays; shipped to the device
    per chunk)."""
    kp0: np.ndarray          # [P, K, 2] image coords
    patch_row: np.ndarray    # [P, K] row into packed patches
    corner: np.ndarray       # [P, K, 2]
    scale: np.ndarray        # [P, K, 2]
    ups: np.ndarray          # [P, K]
    kp_free: np.ndarray      # [P, K] bool
    kp_valid: np.ndarray     # [P, K] bool
    edge_i: np.ndarray       # [P, E] local kp index
    edge_j: np.ndarray       # [P, E]
    edge_w: np.ndarray       # [P, E] similarity weight (0 for padding)
    lower: np.ndarray        # [P, K, 2]
    upper: np.ndarray        # [P, K, 2]
    # write-back bookkeeping: node -> (problem, slot)
    node_problem: np.ndarray
    node_slot: np.ndarray
    node_ids: np.ndarray     # original graph node indices


def build_ka_problems(keypoints: Dict[str, np.ndarray], graph,
                      problem_labels: np.ndarray, root_labels: np.ndarray,
                      packed, bound: float,
                      edges: Optional[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]] = None,
                      constant_nodes: Optional[np.ndarray] = None,
                      weight_by_sim: bool = True,
                      root_edges_only: bool = False) -> KAProblems:
    """Pack graph subproblems into padded arrays.

    problem_labels: per-node problem id (-1 = skip). packed: PackedFeatures for the
    participating (image, keypoint) pairs. ``edges`` overrides the graph's edge list
    (used by the topological_reference strategy to pass star edges toward roots).
    """
    image_ids, feature_idxs = graph.nodes_array()
    src, dst, sim = edges if edges is not None else graph.edges_array()
    labels = np.asarray(problem_labels)

    active = labels >= 0
    node_ids = np.nonzero(active)[0]
    n_problems = int(labels.max()) + 1 if len(node_ids) else 0

    # local slot per node within its problem
    order = np.argsort(labels[node_ids], kind="stable")
    sorted_nodes = node_ids[order]
    sorted_probs = labels[sorted_nodes]
    slot = np.zeros(len(sorted_nodes), dtype=np.int64)
    if len(sorted_nodes):
        new_prob = np.r_[True, sorted_probs[1:] != sorted_probs[:-1]]
        starts = np.nonzero(new_prob)[0]
        slot = np.arange(len(sorted_nodes))
        slot -= np.repeat(starts, np.diff(np.r_[starts, len(sorted_nodes)]))
    node_problem = np.full(graph.num_nodes, -1, dtype=np.int64)
    node_slot = np.full(graph.num_nodes, -1, dtype=np.int64)
    node_problem[sorted_nodes] = sorted_probs
    node_slot[sorted_nodes] = slot

    K = int(slot.max()) + 1 if len(sorted_nodes) else 1

    # intra-track edges with both ends in the same (active) problem
    keep = (active[src] & active[dst] & (labels[src] == labels[dst])
            & (src != dst))
    if root_edges_only:
        keep &= (root_labels[src] | root_labels[dst])
    e_src, e_dst, e_sim = src[keep], dst[keep], sim[keep]
    e_prob = labels[e_src]

    # per-problem edge slots
    eorder = np.argsort(e_prob, kind="stable")
    e_src, e_dst, e_sim, e_prob = (e_src[eorder], e_dst[eorder],
                                   e_sim[eorder], e_prob[eorder])
    eslot = np.arange(len(e_prob))
    if len(e_prob):
        enew = np.r_[True, e_prob[1:] != e_prob[:-1]]
        estarts = np.nonzero(enew)[0]
        eslot -= np.repeat(estarts, np.diff(np.r_[estarts, len(e_prob)]))
    E = int(eslot.max()) + 1 if len(e_prob) else 1

    def pad8(x):
        return max(int(np.ceil(x / 8)) * 8, 8)

    K, E = pad8(K), pad8(E)

    P = max(n_problems, 1)
    kp0 = np.zeros((P, K, 2), np.float32)
    patch_row = np.zeros((P, K), np.int32)
    corner = np.zeros((P, K, 2), np.float32)
    scale = np.ones((P, K, 2), np.float32)
    ups = np.ones((P, K), np.float32)
    kp_free = np.zeros((P, K), bool)
    kp_valid = np.zeros((P, K), bool)
    lower = np.full((P, K, 2), -np.inf, np.float32)
    upper = np.full((P, K, 2), np.inf, np.float32)

    const = (np.zeros(graph.num_nodes, bool) if constant_nodes is None
             else np.asarray(constant_nodes, bool))

    # patch extent per keypoint axis (x, y) -> (W, H): dense maps aren't square
    ext = (np.array([packed.patches.shape[2], packed.patches.shape[1]],
                    np.float64) if packed.num_patches else np.zeros(2))
    if len(sorted_nodes):
        # vectorized packing: per-image numpy gathers instead of a Python
        # loop per node (the loop dominated host time at Aachen-scale scenes)
        p_arr = node_problem[sorted_nodes]
        k_arr = node_slot[sorted_nodes]
        img_arr = image_ids[sorted_nodes]
        fid_arr = np.asarray(feature_idxs)[sorted_nodes]
        rows_all = np.empty(len(sorted_nodes), np.int64)
        kp_all = np.empty((len(sorted_nodes), 2), np.float64)
        for iid in np.unique(img_arr):
            m = img_arr == iid
            name = graph.image_id_to_name[int(iid)]
            fi = fid_arr[m]
            kp_all[m] = np.asarray(keypoints[name])[fi]
            rows_all[m] = packed.rows_for_image(name, fi)
        kp0[p_arr, k_arr] = kp_all
        patch_row[p_arr, k_arr] = rows_all
        corner[p_arr, k_arr] = packed.corners[rows_all]
        scale[p_arr, k_arr] = packed.scales[rows_all]
        ups[p_arr, k_arr] = packed.upsampling[rows_all]
        kp_valid[p_arr, k_arr] = True
        kp_free[p_arr, k_arr] = ~(
            np.asarray(root_labels, bool)[sorted_nodes]
            | const[sorted_nodes])
        # bounds: patch extent (in image coords) intersect kp +- bound/scale
        sc = packed.scales[rows_all]
        lo = (packed.corners[rows_all] + 0.5) / sc
        hi = lo + ext / sc
        if bound > 0:
            lo = np.maximum(lo, kp_all - bound / sc)
            hi = np.minimum(hi, kp_all + bound / sc)
        lower[p_arr, k_arr] = lo
        upper[p_arr, k_arr] = hi

    edge_i = np.zeros((P, E), np.int32)
    edge_j = np.zeros((P, E), np.int32)
    edge_w = np.zeros((P, E), np.float32)
    edge_i[e_prob, eslot] = node_slot[e_src]
    edge_j[e_prob, eslot] = node_slot[e_dst]
    edge_w[e_prob, eslot] = e_sim if weight_by_sim else 1.0

    return KAProblems(kp0, patch_row, corner, scale, ups, kp_free, kp_valid,
                      edge_i, edge_j, edge_w, lower, upper,
                      node_problem, node_slot, node_ids)



# ---------------------------------------------------------------------------
# device-side system assembly
# ---------------------------------------------------------------------------

def _eval_keypoints(rows_spec, kp, corner, scale, ups,
                    interp: InterpolationConfig):
    """Batched per-keypoint interpolation: returns f, dfdx, dfdy [P, K, D]
    (derivatives w.r.t. image coordinates; ``D`` the config's descriptor
    length, ``n_nodes * C`` with node windows).

    ``rows_spec = (rows, H, W, C, patch_row)``: the read indexes the flat
    ``[n * H, W, C]`` row view of the PACKED patch tensor; no per-problem
    patch gather happens."""
    rows, H, W, C, patch_row = rows_spec
    uv = (kp * scale - 0.5 - corner) * ups[..., None]
    r = uv[..., 1]
    c = uv[..., 0]
    P, K = r.shape
    row_base = patch_row.reshape(-1).to(torch.int32) * H
    f, dfdr, dfdc = interpolate(rows, H, W, C, row_base, r.reshape(-1),
                                c.reshape(-1), interp)
    D = f.shape[-1]
    f = f.reshape(P, K, D)
    su = scale * ups[..., None]
    dfdx = dfdc.reshape(P, K, D) * su[..., 0:1]
    dfdy = dfdr.reshape(P, K, D) * su[..., 1:2]
    return f, dfdx, dfdy


def make_ka_system(rows_spec, interp: InterpolationConfig, loss: RobustLoss,
                   K: int, kp_free_mask=None):
    """Return (system_fn, cost_fn) over the padded problem arrays.

    ``rows_spec = (rows, H, W, C)`` is the flat row view of the packed patch
    tensor. ``data = (patch_row, corner, scale, ups, edge_i, edge_j,
    edge_w)``. Every residual has the read's length ``D`` (``n_nodes * C``
    with node windows). ``kp_free_mask [P, K]`` zeroes the frozen keypoints'
    Jacobians, so their H rows/cols and g entries vanish exactly.
    """
    rows, H, W, C = rows_spec

    def _delta_edges(edge_i, edge_j):
        """Signed edge incidence Delta = Si - Sj, [P, E, K]."""
        iota = torch.arange(K, device=edge_i.device)
        return ((edge_i[..., None] == iota).to(torch.float32)
                - (edge_j[..., None] == iota).to(torch.float32))

    def _common(x, data):
        (patch_row, corner, scale, ups, edge_i, edge_j, edge_w) = data
        P = x.shape[0]
        kp = x.reshape(P, K, 2)
        f, dfdx, dfdy = _eval_keypoints((rows, H, W, C, patch_row), kp,
                                        corner, scale, ups, interp)
        if kp_free_mask is not None:
            mfree = kp_free_mask.to(f.dtype)[..., None]
            dfdx = dfdx * mfree
            dfdy = dfdy * mfree
        Delta = _delta_edges(edge_i, edge_j)
        r = torch.einsum("pek,pkc->pec", Delta, f)    # f_i - f_j, [P, E, D]
        s = torch.sum(r * r, dim=-1)                  # [P, E]
        return kp, f, dfdx, dfdy, Delta, r, s

    def cost_fn(x, data):
        edge_w = data[-1]
        *_, s = _common(x, data)
        return 0.5 * torch.sum(edge_w * loss(s), dim=1)

    def system_fn(x, data):
        """Gram-factorized normal equations: the edge Jacobian separates,
        d r_e / d kp_m = Delta[e, k_m] * df[k_m], so

            H = (Delta^T diag(w) Delta) (x)_{2x2} (DF DF^T)
            g = rows(DF) . rows(Delta^T diag(w) r)
        """
        edge_w = data[-1]
        kp, f, dfdx, dfdy, Delta, r, s = _common(x, data)
        P, Df = kp.shape[0], f.shape[-1]

        cost = 0.5 * torch.sum(edge_w * loss(s), dim=1)
        w = edge_w * loss.weight(s)                  # [P, E]

        # DF [P, 2K, Df]: row m = 2k+a holds df_a(kp_k), a in {x, y}
        DF = torch.stack([dfdx, dfdy], dim=2).reshape(P, 2 * K, Df)
        G = torch.einsum("pek,pe,pel->pkl", Delta, w, Delta)   # [P, K, K]
        D = torch.einsum("pmc,pnc->pmn", DF, DF)               # [P, 2K, 2K]
        G2 = G[:, :, None, :, None].expand(P, K, 2, K, 2).reshape(
            P, 2 * K, 2 * K)
        Hs = G2 * D

        Rt = torch.einsum("pek,pe,pec->pkc", Delta, w, r)      # [P, K, D]
        gx = torch.sum(dfdx * Rt, dim=-1)                      # [P, K]
        gy = torch.sum(dfdy * Rt, dim=-1)
        g = torch.stack([gx, gy], dim=2).reshape(P, 2 * K)
        return cost, Hs, g

    return system_fn, cost_fn


def _run_chunk(rows_spec, interp, loss, lm_opts: LMOptions, K: int, x0, data,
               kp_free, lower, upper, pmask, lam0=None):
    """One lock-stepped LM solve over a chunk of padded problems."""
    system_fn, cost_fn = make_ka_system(rows_spec, interp, loss, K,
                                        kp_free_mask=kp_free)
    mask = kp_free.repeat_interleave(2, dim=1)
    return lm_solve(lambda x: system_fn(x, data), lambda x: cost_fn(x, data),
                    x0, param_mask=mask, problem_mask=pmask,
                    lower=lower.reshape(x0.shape),
                    upper=upper.reshape(x0.shape),
                    opts=replace(lm_opts, assume_masked_system=True),
                    lam0=lam0)


# Bytes of float32 per-chunk temporaries a KA chunk may hold: per problem
# the read (f, dfdx, dfdy, [K, D] each), the residuals and their weighted
# sums ([E, D], [K, D]) and the Gram factor DF [2K, D], i.e. about 4 * D *
# (6K + E) bytes. A node window multiplies D by the node count (16 nodes at
# 128 channels: 2048 floats per keypoint), so the chunk is cut to the
# largest power of two under this budget (never below 8); at one node and
# the default chunk of 128 the budget is far from reached.
_KA_CHUNK_BYTES = 1 << 30


def ka_chunk_size(chunk: int, K: int, E: int, D: int) -> int:
    """The KA chunk for ``K`` keypoints, ``E`` edges and descriptor length
    ``D`` under ``_KA_CHUNK_BYTES`` (see there)."""
    per_problem = 4 * D * (6 * K + E)
    fit = max(_KA_CHUNK_BYTES // max(per_problem, 1), 1)
    return int(max(min(chunk, 1 << (int(fit).bit_length() - 1)), 8))


def solve_ka_problems(problems: KAProblems, packed_patches,
                      interp: InterpolationConfig, loss: RobustLoss,
                      lm_opts: LMOptions, chunk: int = 128,
                      compaction_segment: int = 0,
                      device=None, mesh=None) -> Tuple[np.ndarray, Dict]:
    """Run all padded problems through the batched LM, chunked to bound
    memory. ``packed_patches [n, H, W, C]`` (tensor or array) is moved to
    ``device`` (``cuda`` unless ``"cpu"`` is passed), or to the first
    device of ``mesh``.

    ``mesh``: the problem axis of each chunk splits over the mesh's
    devices; the per-device chunk stays ``chunk`` (the chunk scales by the
    mesh size, ``:739-745`` of the JAX package) and the patches are copied
    to each device.

    ``compaction_segment > 0`` runs the LM in segments of that many
    iterations and re-packs only the unconverged problems into fresh
    chunks between segments, their damping warm-started from the last
    segment (the JAX package's ``solve_ka_problems``, ``:700-840``). It
    changes the trajectory, not the optimum.

    Returns refined kp [P, K, 2] and a merged summary dict (the reference
    merges per-subset Ceres summaries — util/src/statistics.h:14-60).
    """
    check_window_config(interp)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    devices = (dev,) if mesh is None else mesh.devices
    P, K, _ = problems.kp0.shape
    E = problems.edge_i.shape[1]
    patches = torch.as_tensor(packed_patches, device=dev)
    n, H, W, C = patches.shape
    rows_specs = [(rows, H, W, C) for rows in (
        replicate(patches.reshape(n * H, W, C), d) for d in devices)]
    chunk = len(devices) * ka_chunk_size(
        chunk, K, E, output_dim(interp.mode, C, interp.n_nodes))

    seg = int(compaction_segment) if compaction_segment else 0
    if seg <= 0 or seg >= lm_opts.max_iterations:
        seg = lm_opts.max_iterations
    seg_opts = replace(lm_opts, max_iterations=seg)

    x_cur = problems.kp0.reshape(P, K * 2).astype(np.float32).copy()
    lam_cur = np.full(P, lm_opts.initial_lambda, np.float32)
    init_cost = np.zeros(P, np.float32)
    final_cost = np.zeros(P, np.float32)
    iters_used = np.zeros(P, np.int32)
    lower_np = np.nan_to_num(problems.lower, neginf=-1e30).astype(np.float32)
    upper_np = np.nan_to_num(problems.upper, posinf=1e30).astype(np.float32)

    from ..util.prefetch import prefetch_map

    def put(a, d):
        a = np.asarray(a)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    active = np.arange(P)
    it_done = 0
    first_segment = True
    interrupted = False
    while len(active) and it_done < lm_opts.max_iterations \
            and not interrupted:
        still = []
        n_chunks = int(np.ceil(len(active) / chunk))

        def pack_chunk(ci, active=active):
            """Host packing of one chunk, pipelined one chunk ahead of the
            running solve (chunks index disjoint problem rows)."""
            idx = active[ci * chunk:(ci + 1) * chunk]
            pad = chunk - len(idx)

            def pad0(a, fill=0):
                if pad == 0:
                    return a
                return np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)],
                    axis=0)

            arrays = (pad0(x_cur[idx]),
                      tuple(pad0(a[idx]) for a in (
                          problems.patch_row, problems.corner,
                          problems.scale, problems.ups, problems.edge_i,
                          problems.edge_j, problems.edge_w)),
                      pad0(problems.kp_free[idx]),
                      pad0(lower_np[idx], -1e30), pad0(upper_np[idx], 1e30),
                      np.arange(chunk) < len(idx),
                      pad0(lam_cur[idx], lm_opts.initial_lambda))
            return idx, arrays

        for ci, (idx, arrays) in enumerate(prefetch_map(
                pack_chunk, range(n_chunks), depth=1)):
            try:
                for (s, e), d, rows_spec in zip(
                        shard_bounds(chunk, len(devices)), devices,
                        rows_specs):
                    if s >= len(idx):       # a shard of padding only
                        break
                    x0, data, kp_free, lower, upper, pmask, lam0 = (
                        tuple(a[s:e] for a in arr) if isinstance(arr, tuple)
                        else arr[s:e] for arr in arrays)
                    with device_scope(d):
                        x, summary = _run_chunk(
                            rows_spec, interp, loss, seg_opts, K,
                            put(x0, d), tuple(put(a, d) for a in data),
                            put(kp_free, d), put(lower, d), put(upper, d),
                            put(pmask, d), lam0=put(lam0, d))
                    m = min(e, len(idx)) - s
                    sl = idx[s:s + m]
                    x_cur[sl] = x.cpu().numpy()[:m]
                    lam_cur[sl] = summary.lam.cpu().numpy()[:m]
                    if first_segment:
                        init_cost[sl] = \
                            summary.initial_cost.cpu().numpy()[:m]
                    final_cost[sl] = summary.final_cost.cpu().numpy()[:m]
                    iters_used[sl] += summary.iterations.cpu().numpy()[:m]
                    still.append(sl[~summary.converged.cpu().numpy()[:m]])
            except KeyboardInterrupt:
                # keep every completed chunk's keypoints (reference
                # PyInterruptCallback, base/src/callbacks.h:10-37)
                interrupted = True
                logger.warning("KA interrupted after %d/%d chunks of this "
                               "segment: keeping all completed results.",
                               ci, n_chunks)
                break
        active = np.concatenate(still) if still else np.zeros(0, np.int64)
        it_done += seg
        first_segment = False

    tot = dict(initial_cost=float(init_cost.sum()),
               final_cost=float(final_cost.sum()),
               num_problems=P, iterations=int(iters_used.max(initial=0)))
    if interrupted:
        tot["interrupted"] = True
    return x_cur.reshape(P, K, 2), tot


# ---------------------------------------------------------------------------
# fixed-target problems (topological_reference KA, QKA)
# ---------------------------------------------------------------------------

def _patch_tensor(packed_patches, device):
    """The packed patches on ``device``; a tensor stays where it is unless a
    device is named."""
    if isinstance(packed_patches, torch.Tensor) and device is None:
        return packed_patches
    return torch.as_tensor(packed_patches, device=resolve_device(device))


def evaluate_descriptors(packed_patches, rows, kps, corners, scales, ups,
                         interp: InterpolationConfig,
                         query_chunk: int = 1024, device=None) -> np.ndarray:
    """Descriptors at image coordinates (no gradients): ``[N, D]`` float32
    (``D = n_nodes * C`` with node windows, 1 for BICUBICCHAIN), used to
    freeze root and reference descriptors. One read per chunk of
    ``query_chunk`` queries (a K1 launch for BICUBIC), from the flat row
    view of the packed patches (``solver.py:406`` of the JAX package, whose
    chunks pad to power-of-two buckets that eager torch does not need)."""
    check_window_config(interp)
    patches = _patch_tensor(packed_patches, device)
    dev = patches.device
    rows = np.asarray(rows, np.int64)
    n = len(rows)
    kps = np.asarray(kps, np.float32).reshape(-1, 2)
    corners = np.asarray(corners, np.float32).reshape(-1, 2)
    scales = np.asarray(scales, np.float32).reshape(-1, 2)
    ups = np.asarray(ups, np.float32).reshape(-1)
    uv = (kps * scales - 0.5 - corners) * ups[..., None]

    N, H, W, C = patches.shape
    rows_view = patches.reshape(N * H, W, C)
    out = np.empty((n, output_dim(interp.mode, C, interp.n_nodes)),
                   np.float32)
    for s in range(0, n, query_chunk):
        e = min(s + query_chunk, n)
        f, _, _ = interpolate(
            rows_view, H, W, C,
            torch.as_tensor(rows[s:e] * H, dtype=torch.int32, device=dev),
            torch.as_tensor(uv[s:e, 1], device=dev),
            torch.as_tensor(uv[s:e, 0], device=dev), interp)
        out[s:e] = f.cpu().numpy()
    return out


def make_target_system(rows_spec, interp: InterpolationConfig,
                       loss: RobustLoss):
    """Fixed-target system: per problem one 2-DoF keypoint against constant
    reference descriptors (reference residuals/src/feature_reference.h:23-66).

    ``rows_spec = (rows, H, W, C)`` is the flat row view of the packed patch
    tensor. Problem data: ``patch_row [P]``, ``corner/scale [P, 2]``, ``ups
    [P]``, ``targets [P, T, D]`` (``D`` the read's length, ``n_nodes * C``
    with node windows), ``target_w [P, T]`` (0 = padding). One J
    per problem serves all T targets: ``H = sum_t w_t J^T J``, ``g = sum_t
    w_t r_t^T J``.
    """
    rows, H, W, C = rows_spec

    def _eval(x, data):
        patch_row, corner, scale, ups, targets, _ = data
        uv = (x * scale - 0.5 - corner) * ups[..., None]
        f, dfdr, dfdc = interpolate(
            rows, H, W, C, patch_row.to(torch.int32) * H, uv[..., 1],
            uv[..., 0], interp)
        su = scale * ups[..., None]
        dfdx = dfdc * su[..., 0:1]
        dfdy = dfdr * su[..., 1:2]
        r = f[:, None, :] - targets                 # [P, T, D]
        s = torch.sum(r * r, dim=-1)                # [P, T]
        return dfdx, dfdy, r, s

    def cost_fn(x, data):
        *_, s = _eval(x, data)
        return 0.5 * torch.sum(data[-1] * loss(s), dim=1)

    def system_fn(x, data):
        target_w = data[-1]
        dfdx, dfdy, r, s = _eval(x, data)
        cost = 0.5 * torch.sum(target_w * loss(s), dim=1)
        w = target_w * loss.weight(s)               # [P, T]
        J = torch.stack([dfdx, dfdy], dim=-1)       # [P, D, 2]
        JtJ = torch.einsum("pca,pcb->pab", J, J)
        Hs = torch.sum(w, dim=1)[:, None, None] * JtJ
        g = torch.einsum("pt,ptc,pca->pa", w, r, J)
        return cost, Hs, g

    return system_fn, cost_fn


def _run_target_chunk(rows_spec, interp, loss, lm_opts: LMOptions, x0, data,
                      lower, upper, pmask, fmask):
    """One lock-stepped LM solve over a chunk of fixed-target problems
    (``_target_chunk_core`` of the JAX package)."""
    system_fn, cost_fn = make_target_system(rows_spec, interp, loss)
    return lm_solve(lambda x: system_fn(x, data), lambda x: cost_fn(x, data),
                    x0, param_mask=fmask, problem_mask=pmask, lower=lower,
                    upper=upper, opts=lm_opts)


def solve_target_problems(kp0, patch_row, corner, scale, ups, targets,
                          target_w, lower, upper, packed_patches,
                          interp: InterpolationConfig, loss: RobustLoss,
                          lm_opts: LMOptions, chunk: int = 8192,
                          free_mask: Optional[np.ndarray] = None,
                          mesh=None, device=None):
    """Batched fixed-target LM over P independent keypoints. Returns
    ``(kp [P, 2], summary)``.

    The chunk size is the JAX package's power-of-two rule (at most
    ``chunk``, at least 8), so the problems that share one LM solve are the
    same; a chunk is not padded to its size, which eager torch does not
    need. ``packed_patches`` is moved to ``device`` when one is named (a
    tensor otherwise stays where it is; an array goes to ``cuda``).

    ``mesh``: each chunk (at least one problem per device) splits into one
    contiguous shard per mesh device, solved there with the patches copied
    to it (the QKA serving fan-out, ``:570-582`` of the JAX package); the
    shards' summaries merge as ``util.profiling.merge_summaries`` merges
    them."""
    check_window_config(interp)
    patches = _patch_tensor(packed_patches,
                            device if mesh is None else mesh.devices[0])
    devices = (patches.device,) if mesh is None else mesh.devices
    n_p, H, W, C = patches.shape
    rows_specs = [(rows, H, W, C) for rows in (
        replicate(patches.reshape(n_p * H, W, C), d) for d in devices)]

    P = kp0.shape[0]
    out = np.array(kp0, np.float32, copy=True)
    if free_mask is None:
        free_mask = np.ones(P, bool)
    chunk = min(chunk, bucket(P)) if P else 8
    chunk = max(chunk, len(devices))     # powers of two keep divisibility

    def put(a, d, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=d)

    summaries = []
    for c0 in range(0, P, chunk):
        c1 = min(c0 + chunk, P)
        for (s0, s1), d, rows_spec in zip(shard_bounds(c1 - c0,
                                                       len(devices)),
                                          devices, rows_specs):
            if s1 == s0:
                continue
            sl = slice(c0 + s0, c0 + s1)
            data = (put(patch_row[sl], d, torch.int64), put(corner[sl], d),
                    put(scale[sl], d), put(ups[sl], d), put(targets[sl], d),
                    put(target_w[sl], d))
            lo = np.nan_to_num(np.asarray(lower[sl], np.float64),
                               neginf=-1e30)
            hi = np.nan_to_num(np.asarray(upper[sl], np.float64),
                               posinf=1e30)
            pmask = put(free_mask[sl], d, torch.bool)
            fmask = pmask[:, None].expand(-1, 2)
            with device_scope(d):
                x, summary = _run_target_chunk(
                    rows_spec, interp, loss, lm_opts, put(kp0[sl], d), data,
                    put(lo, d), put(hi, d), pmask, fmask)
            packed = torch.cat([x.reshape(-1),
                                summary.initial_cost.sum()[None],
                                summary.final_cost.sum()[None],
                                summary.iterations.max()[None].to(x.dtype)])
            packed = packed.cpu().numpy()             # one fetch per shard
            n = sl.stop - sl.start
            out[sl] = np.where(free_mask[sl][:, None],
                               packed[:2 * n].reshape(n, 2), out[sl])
            summaries.append(dict(initial_cost=packed[2 * n],
                                  final_cost=packed[2 * n + 1],
                                  iterations=packed[2 * n + 2]))
    merged = merge_summaries(summaries)
    return out, dict(initial_cost=merged.initial_cost,
                     final_cost=merged.final_cost, num_problems=P,
                     iterations=merged.iterations)
