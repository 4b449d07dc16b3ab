// Native graph core: union-find track labeling, scoring, root selection, and
// FFD problem binning for very large match graphs.
//
// Counterpart of the reference's C++ graph layer (pixsfm/base/src/graph.cc) —
// independent implementation exposed through a flat C ABI consumed via ctypes
// (no pybind11). Copy of pixsfm_tpu/native/graph_core.cpp: the Python layer
// (pixsfm_tpu_torch/native/__init__.py) builds it with g++ at first use and
// base/graph.py dispatches to it; the numpy branches there are its plain
// versions.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

int64_t find_root(std::vector<int64_t>& parent, int64_t i) {
  int64_t root = i;
  while (parent[root] >= 0) root = parent[root];
  while (parent[i] >= 0) {
    int64_t next = parent[i];
    parent[i] = root;
    i = next;
  }
  return root;
}

}  // namespace

extern "C" {

// Maximum-similarity spanning forest with the one-keypoint-per-image-per-track
// constraint; labels assigned in node order of forest roots.
void psf_compute_track_labels(int64_t n_nodes, int64_t n_edges,
                              const int64_t* src, const int64_t* dst,
                              const double* sim,
                              const int64_t* node_image_ids,
                              int64_t* track_labels) {
  std::vector<int64_t> order(n_edges);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (sim[a] != sim[b]) return sim[a] > sim[b];
    if (src[a] != src[b]) return src[a] > src[b];
    return dst[a] > dst[b];
  });

  std::vector<int64_t> parent(n_nodes, -1);
  std::vector<std::unordered_set<int64_t>> images(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) images[i].insert(node_image_ids[i]);

  for (int64_t e : order) {
    int64_t r1 = find_root(parent, src[e]);
    int64_t r2 = find_root(parent, dst[e]);
    if (r1 == r2) continue;
    auto& s1 = images[r1];
    auto& s2 = images[r2];
    const auto& small = s1.size() < s2.size() ? s1 : s2;
    const auto& large = s1.size() < s2.size() ? s2 : s1;
    bool overlap = false;
    for (int64_t im : small) {
      if (large.count(im)) { overlap = true; break; }
    }
    if (overlap) continue;
    if (s1.size() < s2.size()) {
      parent[r1] = r2;
      s2.insert(s1.begin(), s1.end());
      s1.clear();
    } else {
      parent[r2] = r1;
      s1.insert(s2.begin(), s2.end());
      s2.clear();
    }
  }

  int64_t n_tracks = 0;
  for (int64_t i = 0; i < n_nodes; ++i)
    track_labels[i] = parent[i] < 0 ? n_tracks++ : -1;
  for (int64_t i = 0; i < n_nodes; ++i)
    if (track_labels[i] < 0)
      track_labels[i] = track_labels[find_root(parent, i)];
}

// Sum of intra-track edge similarities per node.
void psf_compute_score_labels(int64_t n_nodes, int64_t n_edges,
                              const int64_t* src, const int64_t* dst,
                              const double* sim, const int64_t* track_labels,
                              double* scores) {
  std::memset(scores, 0, sizeof(double) * n_nodes);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (track_labels[src[e]] == track_labels[dst[e]]) {
      scores[src[e]] += sim[e];
      scores[dst[e]] += sim[e];
    }
  }
}

// Top-score node per track (ties: larger node index).
void psf_compute_root_labels(int64_t n_nodes, const int64_t* track_labels,
                             const double* scores, uint8_t* is_root) {
  std::vector<int64_t> order(n_nodes);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (scores[a] != scores[b]) return scores[a] > scores[b];
    return a > b;
  });
  int64_t n_tracks = 0;
  for (int64_t i = 0; i < n_nodes; ++i)
    n_tracks = std::max(n_tracks, track_labels[i] + 1);
  std::vector<uint8_t> has_root(n_tracks, 0);
  std::memset(is_root, 0, n_nodes);
  for (int64_t i : order) {
    int64_t t = track_labels[i];
    if (!has_root[t]) {
      has_root[t] = 1;
      is_root[i] = 1;
    }
  }
}

// First-fit-decreasing bin packing of per-track counts into problems of at
// most `max_per_problem` (reference scheduler semantics, ka/main.py:13-57).
// Returns the number of bins; track_to_problem gets one entry per track.
int64_t psf_ffd_bin_packing(int64_t n_tracks, const int64_t* track_counts,
                            int64_t max_per_problem,
                            int64_t* track_to_problem) {
  std::vector<int64_t> order(n_tracks);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (track_counts[a] != track_counts[b])
      return track_counts[a] > track_counts[b];
    return a < b;
  });
  std::vector<int64_t> bins;
  int64_t start = 0;
  int64_t last_v = INT64_MAX;
  for (int64_t k : order) {
    int64_t v = track_counts[k];
    if (v < last_v) {
      start = 0;
      last_v = v;
    }
    bool found = false;
    if (v < max_per_problem) {
      for (int64_t i = start; i < (int64_t)bins.size(); ++i) {
        if (bins[i] + v <= max_per_problem) {
          bins[i] += v;
          track_to_problem[k] = i;
          found = true;
          start = i;
          break;
        }
      }
    }
    if (!found) {
      track_to_problem[k] = bins.size();
      start = bins.size();
      bins.push_back(v);
    }
  }
  return (int64_t)bins.size();
}

// Build node ids for (image_id, feature_idx) pairs: hash-consing used by the
// Python Graph to vectorize register_matches for big scenes.
// pairs: [n, 2]; out_ids: [n]; returns number of unique nodes.
int64_t psf_assign_node_ids(int64_t n, const int64_t* pairs,
                            int64_t* out_ids) {
  std::unordered_map<int64_t, int64_t> map;
  map.reserve(n * 2);
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t key = (pairs[2 * i] << 32) | (pairs[2 * i + 1] & 0xFFFFFFFF);
    auto it = map.emplace(key, next);
    if (it.second) ++next;
    out_ids[i] = it.first->second;
  }
  return next;
}

}  // extern "C"
