"""Match graph and track labeling (reference: pixsfm/base/src/graph.{h,cc}).

Behavioral rebuild of the reference's feature match graph:

- ``Graph.register_matches`` builds nodes ``(image, keypoint_idx)`` and directed
  similarity-weighted edges (graph.cc:66-80).
- ``compute_track_labels``: maximum-similarity spanning forest via union-find, rejecting
  merges that would place two keypoints of the same image in one track (graph.cc:126-206).
- ``compute_score_labels``: per-node sum of intra-track edge similarities (graph.cc:208-223).
- ``compute_root_labels``: highest-score node per track (graph.cc:225-256).

Host-side bookkeeping. Copy of ``pixsfm_tpu/base/graph.py``: the three labelings
run in the native C++ graph core (``native/graph_core.cpp``, built with g++ at
first use), as the JAX package's do where its core is built; the ``*_numpy``
functions are the plain versions the tests hold the core to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "Graph", "compute_track_labels", "compute_score_labels",
    "compute_root_labels", "compute_track_labels_numpy",
    "compute_score_labels_numpy", "compute_root_labels_numpy",
    "count_track_edges", "count_edges_AB",
]


class Graph:
    """Feature match graph over (image_name, keypoint_idx) nodes."""

    def __init__(self):
        self.image_name_to_id: Dict[str, int] = {}
        self.image_id_to_name: Dict[int, str] = {}
        # arrays grow in chunks; edges stored as (src_node, dst_node, sim)
        self.node_image_ids: List[int] = []
        self.node_feature_idxs: List[int] = []
        self._node_map: Dict[Tuple[int, int], int] = {}
        self.edges_src: List[int] = []
        self.edges_dst: List[int] = []
        self.edges_sim: List[float] = []

    # -- construction -------------------------------------------------------
    def _image_id(self, image_name: str) -> int:
        iid = self.image_name_to_id.get(image_name)
        if iid is None:
            iid = len(self.image_name_to_id)
            self.image_name_to_id[image_name] = iid
            self.image_id_to_name[iid] = image_name
        return iid

    def find_or_create_node(self, image_name: str, feature_idx: int) -> int:
        iid = self._image_id(image_name)
        key = (iid, int(feature_idx))
        nid = self._node_map.get(key)
        if nid is None:
            nid = len(self.node_image_ids)
            self._node_map[key] = nid
            self.node_image_ids.append(iid)
            self.node_feature_idxs.append(int(feature_idx))
        return nid

    def add_node(self, image_name: str, feature_idx: int) -> int:
        return self.find_or_create_node(image_name, feature_idx)

    def register_matches(self, image_name1: str, image_name2: str,
                         matches: np.ndarray,
                         similarities: Optional[np.ndarray] = None) -> None:
        """matches: (N, 2) keypoint index pairs; similarities: (N,) or None (=1.0)."""
        matches = np.asarray(matches)
        if matches.size == 0:
            return
        sims = (np.ones(len(matches)) if similarities is None
                else np.asarray(similarities, dtype=np.float64).reshape(-1))
        for (f1, f2), sim in zip(matches, sims):
            n1 = self.find_or_create_node(image_name1, int(f1))
            n2 = self.find_or_create_node(image_name2, int(f2))
            self.edges_src.append(n1)
            self.edges_dst.append(n2)
            self.edges_sim.append(float(sim))

    # -- accessors ----------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.node_image_ids)

    @property
    def num_edges(self) -> int:
        return len(self.edges_src)

    def nodes_array(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.node_image_ids, dtype=np.int64),
                np.asarray(self.node_feature_idxs, dtype=np.int64))

    def edges_array(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.asarray(self.edges_src, dtype=np.int64),
                np.asarray(self.edges_dst, dtype=np.int64),
                np.asarray(self.edges_sim, dtype=np.float64))

    def get_degrees(self) -> np.ndarray:
        """Edges per node."""
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        src, dst, _ = self.edges_array()
        np.add.at(deg, src, 1)
        np.add.at(deg, dst, 1)
        return deg

    def get_scores(self) -> np.ndarray:
        """Summed edge similarities per node."""
        scores = np.zeros(self.num_nodes)
        src, dst, sim = self.edges_array()
        np.add.at(scores, src, sim)
        np.add.at(scores, dst, sim)
        return scores

    def get_edges(self) -> List[Tuple[int, int, float]]:
        src, dst, sim = self.edges_array()
        return list(zip(src.tolist(), dst.tolist(), sim.tolist()))


def _uf_find(parent: np.ndarray, i: int) -> int:
    root = i
    while parent[root] >= 0:
        root = parent[root]
    while parent[i] >= 0:  # path compression
        nxt = parent[i]
        parent[i] = root
        i = nxt
    return root


def compute_track_labels(graph: Graph) -> np.ndarray:
    """Maximum-similarity spanning forest; merges rejected if the two components
    share an image (one keypoint per image per track). Reference: graph.cc:126-206.
    Track ids are assigned in node order of the forest roots (parity with the
    reference's labeling pass). Runs in the native core."""
    if not graph.num_nodes:
        return compute_track_labels_numpy(graph)
    from .. import native
    src, dst, sim = graph.edges_array()
    ids, _ = graph.nodes_array()
    return native.compute_track_labels_native(src, dst, sim, ids)


def compute_track_labels_numpy(graph: Graph) -> np.ndarray:
    """The plain version of :func:`compute_track_labels`."""
    n = graph.num_nodes
    src, dst, sim = graph.edges_array()

    # Reference sorts edge tuples (sim, src, dst) descending; replicate exactly.
    order = np.lexsort((dst, src, sim))[::-1]

    parent = np.full(n, -1, dtype=np.int64)
    images_in_track: List[set] = [{graph.node_image_ids[i]} for i in range(n)]

    for e in order:
        r1 = _uf_find(parent, int(src[e]))
        r2 = _uf_find(parent, int(dst[e]))
        if r1 == r2:
            continue
        s1, s2 = images_in_track[r1], images_in_track[r2]
        if not s1.isdisjoint(s2):
            continue
        if len(s1) < len(s2):
            r1, r2 = r2, r1
            s1, s2 = s2, s1
        parent[r2] = r1
        s1.update(s2)
        s2.clear()

    track_labels = np.full(n, -1, dtype=np.int64)
    n_tracks = 0
    for i in range(n):
        if parent[i] < 0:
            track_labels[i] = n_tracks
            n_tracks += 1
    for i in range(n):
        if track_labels[i] < 0:
            track_labels[i] = track_labels[_uf_find(parent, i)]
    return track_labels


def compute_score_labels(graph: Graph, track_labels: np.ndarray) -> np.ndarray:
    """Sum of intra-track edge similarities per node. Reference: graph.cc:208-223.
    Runs in the native core."""
    if not graph.num_nodes:
        return compute_score_labels_numpy(graph, track_labels)
    from .. import native
    src, dst, sim = graph.edges_array()
    return native.compute_score_labels_native(graph.num_nodes, src, dst, sim,
                                              track_labels)


def compute_score_labels_numpy(graph: Graph,
                               track_labels: np.ndarray) -> np.ndarray:
    """The plain version of :func:`compute_score_labels`."""
    src, dst, sim = graph.edges_array()
    scores = np.zeros(graph.num_nodes)
    same = track_labels[src] == track_labels[dst]
    np.add.at(scores, src[same], sim[same])
    np.add.at(scores, dst[same], sim[same])
    return scores


def compute_root_labels(graph: Graph, track_labels: np.ndarray,
                        score_labels: np.ndarray) -> np.ndarray:
    """Boolean mask: top-score node per track (stable by descending score then node
    order — parity with the reference's sort, graph.cc:225-256). Runs in the
    native core."""
    if not graph.num_nodes:
        return compute_root_labels_numpy(graph, track_labels, score_labels)
    from .. import native
    return native.compute_root_labels_native(track_labels, score_labels)


def compute_root_labels_numpy(graph: Graph, track_labels: np.ndarray,
                              score_labels: np.ndarray) -> np.ndarray:
    """The plain version of :func:`compute_root_labels`."""
    n = graph.num_nodes
    # reference sorts (score, node_idx) descending: larger node_idx wins ties.
    order = np.lexsort((np.arange(n), score_labels))[::-1]
    is_root = np.zeros(n, dtype=bool)
    n_tracks = int(track_labels.max()) + 1 if n else 0
    has_root = np.zeros(n_tracks, dtype=bool)
    for i in order:
        t = track_labels[i]
        if not has_root[t]:
            has_root[t] = True
            is_root[i] = True
    return is_root


def count_track_edges(graph: Graph, track_labels: np.ndarray) -> np.ndarray:
    """Intra-track edge count per track. Reference: graph.cc:283-302."""
    n_tracks = int(track_labels.max()) + 1 if graph.num_nodes else 0
    counts = np.zeros(n_tracks, dtype=np.int64)
    src, dst, _ = graph.edges_array()
    same = track_labels[src] == track_labels[dst]
    np.add.at(counts, track_labels[src[same]], 1)
    return counts


def count_edges_AB(graph: Graph, track_labels: np.ndarray,
                   is_root: np.ndarray) -> np.ndarray:
    """Per-track (root-touching, non-root) intra-track edge counts
    ``[n_tracks, 2]``. Reference: graph.cc:258-281."""
    n_tracks = int(track_labels.max()) + 1 if graph.num_nodes else 0
    counts = np.zeros((n_tracks, 2), dtype=np.int64)
    src, dst, _ = graph.edges_array()
    same = track_labels[src] == track_labels[dst]
    root_edge = is_root[src] | is_root[dst]
    np.add.at(counts[:, 0], track_labels[src[same & root_edge]], 1)
    np.add.at(counts[:, 1], track_labels[src[same & ~root_edge]], 1)
    return counts
