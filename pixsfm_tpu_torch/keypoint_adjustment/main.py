"""Keypoint adjustment orchestration (reference: pixsfm/keypoint_adjustment/main.py).

Port of ``pixsfm_tpu/keypoint_adjustment/main.py``:

- ``featuremetric``: minimize featuremetric error along every intra-track
  match edge with the track roots fixed. Subproblems are first-fit-decreasing
  bins of tracks (``find_problem_labels``), solved as one batched LM per
  chunk on the device.
- ``topological_reference`` (the ``low_memory`` preset's KA): a star toward
  each track root with the root constant, so every keypoint is an
  independent 2-DoF problem against its root's descriptor
  (``solver.solve_target_problems``).

``parallel: {enabled, n_devices}`` shards the featuremetric problem axis
over a device mesh (``parallel/sharded.py``), as in the JAX package.
"""

from __future__ import annotations

import sys
import time
from collections import Counter
from copy import deepcopy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import logger, resolve_device
from ..base import interpolation_default_conf, solver_default_conf
from ..base.graph import (Graph, compute_root_labels, compute_score_labels,
                          compute_track_labels)
from ..base.interpolation import InterpolationConfig
from ..base.losses import make_loss
from ..config import merge
from ..features.featuremaps import FeatureView
from ..ops.lm import LMOptions
from ..parallel.sharded import parallel_mesh
from ..util.profiling import span
from .solver import (build_ka_problems, evaluate_descriptors,
                     solve_ka_problems, solve_target_problems)

__all__ = [
    "KeypointAdjuster", "FeatureMetricKeypointAdjuster",
    "TopologicalReferenceKeypointAdjuster",
    "KeypointAdjustmentSetup", "find_problem_labels",
    "ffd_bin_packing_numpy", "build_matching_graph",
    "extract_patchdata_from_graph",
]


class KeypointAdjustmentSetup:
    """Constant keypoint/image sets (reference: keypoint_adjustment_options.h:24-45)."""

    def __init__(self):
        self.constant_images: set = set()
        self.constant_keypoints: set = set()  # (image_name, p2D_idx)

    def set_image_constant(self, image_name: str):
        self.constant_images.add(image_name)

    def set_keypoint_constant(self, image_name: str, p2D_idx: int):
        self.constant_keypoints.add((image_name, int(p2D_idx)))

    def is_constant(self, image_name: str, p2D_idx: int) -> bool:
        return (image_name in self.constant_images
                or (image_name, int(p2D_idx)) in self.constant_keypoints)

    def constant_node_mask(self, graph: Graph) -> np.ndarray:
        image_ids, feature_idxs = graph.nodes_array()
        mask = np.zeros(graph.num_nodes, bool)
        if not (self.constant_images or self.constant_keypoints):
            return mask
        for nid in range(graph.num_nodes):
            name = graph.image_id_to_name[int(image_ids[nid])]
            if self.is_constant(name, int(feature_idxs[nid])):
                mask[nid] = True
        return mask


# above this many tracks the FFD packing runs in the native graph core
_NATIVE_FFD_MIN_TRACKS = 10000


def _ffd(items, max_per_problem: int, n_tracks: int):
    """First-fit decreasing over ``(track, count)`` items in decreasing
    count order: (track -> problem list, problem sizes)."""
    bins: List[int] = []
    track_to_problem = [-1] * n_tracks
    start = 0
    last_v = sys.maxsize
    for k, v in items:
        if v < last_v:
            start = 0
            last_v = v
        found = False
        if v < max_per_problem:
            for i in range(start, len(bins)):
                if bins[i] + v <= max_per_problem:
                    bins[i] += v
                    track_to_problem[k] = i
                    found = True
                    start = i
                    break
        if not found:
            track_to_problem[k] = len(bins)
            start = len(bins)
            bins.append(v)
    return track_to_problem, bins


def ffd_bin_packing_numpy(track_counts, max_per_problem: int):
    """The plain version of ``native.ffd_bin_packing_native``: (track ->
    problem array, number of problems), ties broken by track id."""
    counts = np.asarray(track_counts, np.int64)
    order = sorted(range(len(counts)), key=lambda k: -int(counts[k]))
    t2p, bins = _ffd([(k, int(counts[k])) for k in order], max_per_problem,
                     len(counts))
    return np.asarray(t2p, np.int64), len(bins)


def find_problem_labels(track_labels: Sequence[int], max_per_problem: int,
                        track_edge_counts: Optional[Sequence[int]] = None
                        ) -> Tuple[List[int], List[int]]:
    """First-fit-decreasing bin packing of tracks into problems
    (reference: ka/main.py:13-57). Returns per-node problem labels and bin sizes."""
    track_labels = list(track_labels)
    if len(track_labels) == 0 and not track_edge_counts:
        return [], []
    if track_edge_counts is None:
        track_count = Counter(track_labels)
    else:
        track_count = Counter({i: v for i, v in enumerate(track_edge_counts)})
    if max_per_problem == -1:
        max_per_problem = max(track_count.values())

    if len(track_count) > _NATIVE_FFD_MIN_TRACKS:
        # the native core, as the JAX package packs where its core is built
        # (ties by track id; the loop below breaks them by first appearance)
        from .. import native
        n_tracks = max(track_count) + 1
        counts = np.zeros(n_tracks, np.int64)
        for k, v in track_count.items():
            counts[k] = v
        t2p, n_bins = native.ffd_bin_packing_native(counts, max_per_problem)
        bins_arr = np.zeros(n_bins, np.int64)
        np.add.at(bins_arr, t2p[counts > 0], counts[counts > 0])
        return [int(t2p[t]) for t in track_labels], bins_arr.tolist()
    track_to_problem, bins = _ffd(track_count.most_common(),
                                  max_per_problem, max(track_count) + 1)
    problem_labels = [track_to_problem[t] for t in track_labels]
    n_oversized = int(np.sum(np.array(bins) > max_per_problem))
    if n_oversized > 0 and max_per_problem > -1:
        logger.warning(
            "%d / %d problems have more than %d keypoints (max %d).",
            n_oversized, len(bins), max_per_problem, int(np.max(bins)))
    if -1 in problem_labels:
        raise ValueError("unassigned track in problem labeling")
    return problem_labels, bins


class KeypointAdjuster:
    """Strategy factory + multilevel loop (reference: ka/main.py:60-137)."""

    default_conf = {
        "strategy": "featuremetric",
        "apply": True,
        "interpolation": interpolation_default_conf,
        "level_indices": None,
        "max_kps_per_problem": 50,
        "optimizer": {
            "loss": {"name": "cauchy", "params": [0.25]},
            "solver": {**solver_default_conf, "parameter_tolerance": 1.0e-5,
                       "num_threads": 1},
            "print_summary": False,
            "bound": 4.0,
            "num_threads": -1,
        },
        "split_in_subproblems": True,
        # device batching: problems solved lock-stepped per chunk
        "problem_chunk_size": 128,
        # LM segment length between convergence compactions (0 = off):
        # unconverged problems are re-packed into fresh chunks every this
        # many iterations, their damping warm-started
        "compaction_segment": 0,
        "parallel": {"enabled": False, "n_devices": None},
    }

    def __init__(self, conf=None, device=None):
        self.conf = merge(self.default_conf, conf or {})
        self.device = resolve_device(device)

    def _parallel_mesh(self):
        """The device mesh of ``parallel.enabled`` when more than one
        device is available, else None (``parallel.sharded.parallel_mesh``):
        the problem batch axis then shards over it."""
        return parallel_mesh(self.conf.get("parallel"), self.device)

    @classmethod
    def create(cls, conf=None, device=None):
        strategy = cls.default_conf["strategy"]
        if conf is not None and "strategy" in conf:
            strategy = conf["strategy"]
        strategy_to_solver = {
            "featuremetric": FeatureMetricKeypointAdjuster,
            "topological_reference": TopologicalReferenceKeypointAdjuster,
        }
        return strategy_to_solver[strategy](conf, device=device)

    # -- API ----------------------------------------------------------------
    def refine(self, keypoints_dict: Dict[str, np.ndarray], feature_set,
               graph: Graph, track_labels, root_labels,
               problem_setup: Optional[KeypointAdjustmentSetup] = None) -> dict:
        raise NotImplementedError

    def refine_multilevel(self, keypoints_dict, feature_manager, graph: Graph,
                          track_labels=None, root_labels=None,
                          problem_setup=None) -> dict:
        with span("ka"):
            if track_labels is None:
                track_labels = compute_track_labels(graph)
            if root_labels is None:
                score_labels = compute_score_labels(graph, track_labels)
                root_labels = compute_root_labels(graph, track_labels,
                                                  score_labels)

            level_indices = self.conf.get("level_indices")
            levels = (level_indices if level_indices not in (None, "all")
                      else list(reversed(range(feature_manager.num_levels))))

            outputs: Dict[str, list] = {}
            for level_index in levels:
                with span("ka.level"):
                    out = self.refine(keypoints_dict,
                                      feature_manager.fset(level_index),
                                      graph, track_labels, root_labels,
                                      problem_setup=problem_setup)
                for k, v in out.items():
                    outputs.setdefault(k, []).append(v)
        return outputs

    # -- shared machinery ---------------------------------------------------
    def _run(self, keypoints_dict, feature_set, graph, track_labels,
             root_labels, problem_labels, edges, weight_by_sim,
             root_edges_only, problem_setup) -> dict:
        t0 = time.time()
        labels = np.asarray(problem_labels)
        if graph.num_nodes == 0 or not (labels >= 0).any():
            # empty match graph (e.g. a detector that found no keypoints):
            # nothing to adjust — succeed as a no-op like the reference's
            # ParallelOptimizer over zero subsets
            logger.info("KA: empty problem (no adjustable keypoints); "
                        "skipping.")
            return dict(initial_cost=0.0, final_cost=0.0, num_problems=0,
                        time=time.time() - t0)
        with span("ka.pack"):
            view = FeatureView.from_graph(feature_set, graph,
                                          np.nonzero(labels >= 0)[0],
                                          keypoints=keypoints_dict)
            packed = view.packed

            const = None
            if problem_setup is not None:
                const = problem_setup.constant_node_mask(graph)

            opt = self.conf.optimizer
            problems = build_ka_problems(
                keypoints_dict, graph, labels, np.asarray(root_labels),
                packed, bound=float(opt.get("bound", 4.0)), edges=edges,
                constant_nodes=const, weight_by_sim=weight_by_sim,
                root_edges_only=root_edges_only)

        interp = InterpolationConfig.from_conf(self.conf.get("interpolation"))
        loss = make_loss(opt.get("loss"))
        lm_opts = LMOptions.from_solver_conf(opt.get("solver"))
        with span("ka.lm"):
            kp_refined, summary = solve_ka_problems(
                problems, packed.patches, interp, loss, lm_opts,
                chunk=int(self.conf.get("problem_chunk_size", 128)),
                compaction_segment=int(self.conf.get("compaction_segment",
                                                     0)),
                device=self.device, mesh=self._parallel_mesh())

        # write back refined keypoints (vectorized per image)
        with span("ka.unpack"):
            image_ids, feature_idxs = graph.nodes_array()
            ids = np.asarray(problems.node_ids)
            if len(ids):
                p_arr = problems.node_problem[ids]
                k_arr = problems.node_slot[ids]
                img_arr = np.asarray(image_ids)[ids]
                fid_arr = np.asarray(feature_idxs)[ids]
                for iid in np.unique(img_arr):
                    m = img_arr == iid
                    name = graph.image_id_to_name[int(iid)]
                    keypoints_dict[name][fid_arr[m]] = kp_refined[p_arr[m],
                                                                  k_arr[m]]

        dt = time.time() - t0
        summary["time"] = dt
        cost0, cost1 = summary["initial_cost"], summary["final_cost"]
        logger.info(
            "KA Time: %.3fs, cost change: %.4f --> %.4f (%d problems)",
            dt, cost0, cost1, summary["num_problems"])
        if opt.get("print_summary"):
            # merged-solver report (reference: merged Ceres summaries,
            # util/src/statistics.h + print_summary option)
            logger.info(
                "KA summary:\n  problems: %d\n  keypoints: %d\n"
                "  initial cost: %.6g\n  final cost: %.6g\n"
                "  cost change: %.3f%%\n  max iterations used: %d\n"
                "  wall time: %.3fs",
                summary["num_problems"], len(problems.node_ids), cost0, cost1,
                100.0 * (cost0 - cost1) / max(cost0, 1e-12),
                summary.get("iterations", 0), dt)
        return summary


class FeatureMetricKeypointAdjuster(KeypointAdjuster):
    """Default KA strategy (reference: ka/main.py:140-218).

    Extra optimizer params (reference parity): ``root_regularize_weight`` (add
    missing edges toward the root with this weight; -1 disables), ``weight_by_sim``,
    ``root_edges_only``.
    """

    default_conf = deepcopy(KeypointAdjuster.default_conf)
    default_conf["optimizer"].update({
        "root_regularize_weight": -1,
        "weight_by_sim": True,
        "root_edges_only": False,
    })

    def refine(self, keypoints_dict, feature_set, graph, track_labels,
               root_labels, problem_setup=None) -> dict:
        track_labels = np.asarray(track_labels)
        if self.conf.get("split_in_subproblems", True):
            problem_labels, bins = find_problem_labels(
                track_labels, int(self.conf.get("max_kps_per_problem", 50)))
            if bins and max(bins) > 512:
                logger.warning(
                    "KA: largest subproblem has %d keypoints; the dense "
                    "per-problem solve scales as O(K^3) — consider a smaller "
                    "max_kps_per_problem.", max(bins))
        else:
            problem_labels = np.zeros(graph.num_nodes, np.int64)
            if graph.num_nodes > 512:
                logger.warning(
                    "KA: split_in_subproblems=False with %d keypoints builds "
                    "one dense problem; this is O(K^3) — enable splitting for "
                    "large scenes.", graph.num_nodes)

        opt = self.conf.optimizer
        edges = None
        rrw = float(opt.get("root_regularize_weight", -1))
        if rrw > 0:
            edges = _augment_root_edges(graph, track_labels,
                                        np.asarray(root_labels), rrw)
        return self._run(keypoints_dict, feature_set, graph, track_labels,
                         root_labels, np.asarray(problem_labels), edges,
                         bool(opt.get("weight_by_sim", True)),
                         bool(opt.get("root_edges_only", False)),
                         problem_setup)


class TopologicalReferenceKeypointAdjuster(KeypointAdjuster):
    """Star-graph KA toward track roots: linear in track size and, with the
    root constant, fully decoupled per keypoint — each keypoint becomes an
    independent 2-DoF problem in the batch (reference preset:
    topological_reference_keypoint_optimizer.h:5-28)."""

    default_conf = deepcopy(KeypointAdjuster.default_conf)
    default_conf["max_kps_per_problem"] = 1000
    default_conf["optimizer"].update({
        "root_regularize_weight": 1.0,
        "weight_by_sim": False,
        "root_edges_only": True,
    })

    def refine(self, keypoints_dict, feature_set, graph, track_labels,
               root_labels, problem_setup=None) -> dict:
        t0 = time.time()
        track_labels = np.asarray(track_labels)
        root_labels = np.asarray(root_labels, bool)
        opt = self.conf.optimizer
        rrw = float(opt.get("root_regularize_weight", 1.0))
        weight_by_sim = bool(opt.get("weight_by_sim", False))

        image_ids, feature_idxs = graph.nodes_array()
        src, dst, sim = graph.edges_array()

        n_tracks = int(track_labels.max()) + 1 if graph.num_nodes else 0
        root_of_track = np.full(n_tracks, -1, np.int64)
        root_idx = np.nonzero(root_labels)[0]
        root_of_track[track_labels[root_idx]] = root_idx

        # per-node accumulated weight of edges toward its root; nodes with
        # no root edge get the regularization weight (star augmentation)
        wsum = np.zeros(graph.num_nodes)
        same = track_labels[src] == track_labels[dst]
        for a, b in ((src, dst), (dst, src)):
            m = same & root_labels[b] & ~root_labels[a]
            np.add.at(wsum, a[m], sim[m] if weight_by_sim else 1.0)
        has_root = root_of_track[track_labels] >= 0
        nodes = np.nonzero(~root_labels & has_root)[0]
        const_mask = (problem_setup.constant_node_mask(graph)
                      if problem_setup is not None
                      else np.zeros(graph.num_nodes, bool))
        nodes = nodes[~const_mask[nodes]]
        w = wsum[nodes]
        w[w == 0] = max(rrw, 0.0)
        keep = w > 0
        nodes, w = nodes[keep], w[keep]

        if len(nodes) == 0:
            # no non-root node with a root to pull toward: no-op success
            logger.info("KA (topological_reference): empty problem; "
                        "skipping.")
            return dict(initial_cost=0.0, final_cost=0.0, num_problems=0,
                        time=time.time() - t0)

        view = FeatureView.from_graph(
            feature_set, graph,
            np.concatenate([nodes, root_of_track[track_labels[nodes]]]),
            keypoints=keypoints_dict)
        packed = view.packed

        def node_data(nids):
            names = [graph.image_id_to_name[int(image_ids[n])] for n in nids]
            rows = np.asarray([packed.index[(name, int(feature_idxs[n]))]
                               for name, n in zip(names, nids)], np.int64)
            kps = np.asarray([keypoints_dict[name][int(feature_idxs[n])]
                              for name, n in zip(names, nids)], np.float64)
            return rows, kps

        interp = InterpolationConfig.from_conf(self.conf.get("interpolation"))
        roots = root_of_track[track_labels[nodes]]
        r_rows, r_kps = node_data(roots)
        targets = evaluate_descriptors(
            packed.patches, r_rows, r_kps, packed.corners[r_rows],
            packed.scales[r_rows], packed.upsampling[r_rows], interp,
            device=self.device)

        n_rows, n_kps = node_data(nodes)
        corner = packed.corners[n_rows]
        scale = packed.scales[n_rows]
        ups = packed.upsampling[n_rows]
        # patch extent per axis: keypoints are (x, y), so the box is (W, H)
        ext = np.array([packed.patches.shape[2], packed.patches.shape[1]],
                       np.float64)
        bound = float(opt.get("bound", 4.0))
        lo = (corner + 0.5) / scale
        hi = lo + ext / scale
        if bound > 0:
            lo = np.maximum(lo, n_kps - bound / scale)
            hi = np.minimum(hi, n_kps + bound / scale)

        loss = make_loss(opt.get("loss"))
        lm_opts = LMOptions.from_solver_conf(opt.get("solver"))
        kp_new, summary = solve_target_problems(
            n_kps, n_rows.astype(np.int32), corner.astype(np.float32),
            scale.astype(np.float32), ups.astype(np.float32),
            targets[:, None, :], w[:, None].astype(np.float32),
            lo, hi, packed.patches, interp, loss, lm_opts,
            device=self.device)

        for i, nid in enumerate(nodes):
            name = graph.image_id_to_name[int(image_ids[nid])]
            keypoints_dict[name][int(feature_idxs[nid])] = kp_new[i]

        summary["time"] = time.time() - t0
        logger.info("KA (topological_reference) Time: %.3fs, cost: %.4f -> "
                    "%.4f (%d keypoints)", summary["time"],
                    summary["initial_cost"], summary["final_cost"],
                    summary["num_problems"])
        return summary


def _augment_root_edges(graph: Graph, track_labels: np.ndarray,
                        root_labels: np.ndarray, weight: float):
    """Add missing node->root edges (TopologicalKeypointOptimizer root
    regularization, topological_keypoint_optimizer.h:103-175)."""
    src, dst, sim = graph.edges_array()
    n_tracks = int(track_labels.max()) + 1 if graph.num_nodes else 0
    root_of_track = np.full(n_tracks, -1, np.int64)
    root_idx = np.nonzero(root_labels)[0]
    root_of_track[track_labels[root_idx]] = root_idx

    has_root_edge = np.zeros(graph.num_nodes, bool)
    same = track_labels[src] == track_labels[dst]
    r_edge = same & (root_labels[src] | root_labels[dst])
    has_root_edge[src[r_edge & root_labels[dst]]] = True
    has_root_edge[dst[r_edge & root_labels[src]]] = True

    need = (~has_root_edge) & (~root_labels) & (root_of_track[track_labels] >= 0)
    add_src = np.nonzero(need)[0]
    add_dst = root_of_track[track_labels[add_src]]
    add_sim = np.full(len(add_src), weight)
    return (np.concatenate([src, add_src]), np.concatenate([dst, add_dst]),
            np.concatenate([sim, add_sim]))


def build_matching_graph(matches: Dict[Tuple[str, str], np.ndarray],
                         scores: Optional[Dict[Tuple[str, str], np.ndarray]]
                         = None) -> Graph:
    """Assemble a Graph from pairwise matches (reference: ka/main.py:262-271)."""
    graph = Graph()
    for (name1, name2), m in matches.items():
        s = None if scores is None else scores.get((name1, name2))
        graph.register_matches(name1, name2, np.asarray(m), s)
    return graph


def extract_patchdata_from_graph(graph: Graph) -> Dict[str, List[int]]:
    """{image_name: sorted unique keypoint ids} (reference: ka/main.py:274-279)."""
    image_ids, feature_idxs = graph.nodes_array()
    out: Dict[str, set] = {}
    for nid in range(graph.num_nodes):
        name = graph.image_id_to_name[int(image_ids[nid])]
        out.setdefault(name, set()).add(int(feature_idxs[nid]))
    return {k: sorted(v) for k, v in out.items()}
