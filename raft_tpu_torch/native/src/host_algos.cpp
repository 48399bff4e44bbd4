// Native host-side algorithms — a copy of raft_tpu/native/src/host_algos.cpp
// for the PyTorch port (only this header comment differs); the analog of the reference's
// precompiled native runtime entry points (cpp/src/distance/pairwise_distance.cu:24
// runtime API pattern): sequential, latency-sensitive host loops that sit at
// the device->host boundary of the pipelines (the same boundary where the
// reference runs build_dendrogram_host, sparse/hierarchy/detail/agglomerative.cuh).
//
// Exposed as a C ABI for ctypes (no pybind11).
//
// Build: raft_tpu_torch/native/__init__.py compiles this at first use with
// g++ -O3 into build/raft_tpu_torch/native/<source hash>/, falling back to
// numpy implementations when no toolchain is present.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find with path halving (shared by the dendrogram + flatten + label
// merge entry points; the reference's host union-find in agglomerative.cuh).
// ---------------------------------------------------------------------------
static inline int64_t uf_find(int64_t* parent, int64_t a) {
  while (parent[a] != a) {
    parent[a] = parent[parent[a]];
    a = parent[a];
  }
  return a;
}

// Agglomerative merge of weight-sorted MST edges into a dendrogram
// (reference sparse/hierarchy/detail/agglomerative.cuh build_dendrogram_host).
// children: (n-1, 2) int64, deltas: (n-1) double, sizes: (n-1) int64.
// Returns the number of merges performed.
int64_t rt_build_dendrogram(const int32_t* src, const int32_t* dst,
                            const float* weights, int64_t n_edges, int32_t n,
                            int64_t* children, double* deltas,
                            int64_t* sizes) {
  const int64_t total = 2 * static_cast<int64_t>(n) - 1;
  std::vector<int64_t> parent(total);
  std::vector<int64_t> csize(total, 1);
  for (int64_t i = 0; i < total; ++i) parent[i] = i;

  int64_t nxt = n;
  for (int64_t e = 0; e < n_edges && nxt < total; ++e) {
    const int64_t a = uf_find(parent.data(), src[e]);
    const int64_t b = uf_find(parent.data(), dst[e]);
    if (a == b) continue;
    const int64_t m = nxt - n;
    children[2 * m] = a;
    children[2 * m + 1] = b;
    deltas[m] = static_cast<double>(weights[e]);
    csize[nxt] = csize[a] + csize[b];
    sizes[m] = csize[nxt];
    parent[a] = nxt;
    parent[b] = nxt;
    ++nxt;
  }
  return nxt - n;
}

// Cut a dendrogram into n_clusters flat, first-occurrence-monotonic labels
// (reference detail/agglomerative.cuh extract_flattened_clusters +
// label/classlabels.cuh make_monotonic).
void rt_extract_flat(const int64_t* children, int64_t n_merges, int32_t n,
                     int32_t n_clusters, int32_t* labels) {
  const int64_t total = 2 * static_cast<int64_t>(n) - 1;
  std::vector<int64_t> parent(total);
  for (int64_t i = 0; i < total; ++i) parent[i] = i;

  const int64_t keep = n_merges - (n_clusters - 1);
  for (int64_t e = 0; e < keep; ++e) {
    const int64_t a = uf_find(parent.data(), children[2 * e]);
    const int64_t b = uf_find(parent.data(), children[2 * e + 1]);
    const int64_t m = uf_find(parent.data(), n + e);
    parent[a] = m;
    parent[b] = m;
  }
  std::vector<int32_t> remap(total, -1);
  int32_t nxt = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int64_t r = uf_find(parent.data(), i);
    if (remap[r] < 0) remap[r] = nxt++;
    labels[i] = remap[r];
  }
}

// Relabel arbitrary non-negative labels to consecutive first-occurrence ids
// (reference label/classlabels.cuh make_monotonic). Returns #unique.
int32_t rt_make_monotonic(const int32_t* in, int32_t* out, int64_t n,
                          int32_t n_max) {
  std::vector<int32_t> remap(n_max, -1);
  int32_t nxt = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = in[i];
    if (v < 0 || v >= n_max) { out[i] = -1; continue; }
    if (remap[v] < 0) remap[v] = nxt++;
    out[i] = remap[v];
  }
  return nxt;
}

// Merge P sorted k-lists per query on host (reference knn_merge_parts
// fallback for host-resident results). parts_d: (P, m, k), parts_i idem.
void rt_merge_topk(const float* parts_d, const int32_t* parts_i, int32_t P,
                   int32_t m, int32_t k, float* out_d, int32_t* out_i) {
  std::vector<int32_t> cursor(P);
  for (int32_t q = 0; q < m; ++q) {
    std::fill(cursor.begin(), cursor.end(), 0);
    for (int32_t j = 0; j < k; ++j) {
      int32_t best_p = -1;
      float best = 0.f;
      for (int32_t p = 0; p < P; ++p) {
        if (cursor[p] >= k) continue;
        const float v =
            parts_d[(static_cast<int64_t>(p) * m + q) * k + cursor[p]];
        if (best_p < 0 || v < best) {
          best = v;
          best_p = p;
        }
      }
      const int64_t off =
          (static_cast<int64_t>(best_p) * m + q) * k + cursor[best_p];
      out_d[static_cast<int64_t>(q) * k + j] = parts_d[off];
      out_i[static_cast<int64_t>(q) * k + j] = parts_i[off];
      ++cursor[best_p];
    }
  }
}

}  // extern "C"
