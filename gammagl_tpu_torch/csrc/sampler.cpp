// Host-side graph sampling kernels.
//
// TPU-native equivalent of the reference's C++ sampling extension
// (reference: gammagl/ops/sparse/cpu/neighbor_sample.cpp:22 fanout loop over
// CSC with hash-map relabeling; rw.cpp:1-58 random walks; saint.cpp subgraph;
// sample.cpp per-layer adj sampling; convert.cpp ind2ptr/ptr2ind).
// Sampling is data-dependent-shape host work, so it stays native C++ on the
// TPU host VM; Python binds via ctypes (no pybind11 in this image).
//
// All functions are extern "C", operate on caller-allocated int64 buffers,
// and return actual sizes; callers pad the results to static shapes before
// device transfer.

#include <cstdint>
#ifdef _OPENMP
#include <omp.h>
#endif
#include <cstring>
#include <random>
#include <vector>

namespace {

// Open-addressing node->local-id map (linear probing, power-of-two
// capacity). The relabel lookup runs once per sampled edge and is the
// sampler's hottest path; std::unordered_map's chained buckets cost a
// heap allocation per node and a pointer chase per probe (the reference
// uses phmap::flat_hash_map for the same reason — this is the
// dependency-free equivalent).
struct FlatMap {
  std::vector<int64_t> keys;
  std::vector<int64_t> vals;
  size_t mask;

  explicit FlatMap(int64_t expected) {
    size_t cap = 16;
    while (cap < static_cast<size_t>(expected) * 2) cap <<= 1;
    keys.assign(cap, -1);
    vals.resize(cap);
    mask = cap - 1;
  }

  static size_t mix(int64_t k) {
    uint64_t x = static_cast<uint64_t>(k);
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    return static_cast<size_t>(x);
  }

  // Returns the local id of `k`, inserting `fresh` if absent;
  // sets `inserted`.
  int64_t get_or_insert(int64_t k, int64_t fresh, bool* inserted) {
    size_t i = mix(k) & mask;
    while (true) {
      if (keys[i] == k) {
        *inserted = false;
        return vals[i];
      }
      if (keys[i] < 0) {
        keys[i] = k;
        vals[i] = fresh;
        *inserted = true;
        return fresh;
      }
      i = (i + 1) & mask;
    }
  }

  int64_t find(int64_t k) const {  // k must be present
    size_t i = mix(k) & mask;
    while (keys[i] != k) i = (i + 1) & mask;
    return vals[i];
  }

  int64_t find_or(int64_t k, int64_t dflt) const {
    size_t i = mix(k) & mask;
    while (keys[i] != k) {
      if (keys[i] < 0) return dflt;
      i = (i + 1) & mask;
    }
    return vals[i];
  }
};

// splitmix64 + Lemire bounded draw: one multiply per uniform int vs
// libstdc++'s uniform_int_distribution (divide + rejection loop) on
// mt19937_64. The sampler burns one draw per sampled edge (~250k/batch
// at the Reddit protocol) — this is several ms/batch.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // unbiased integer in [0, n) (Lemire's multiply-shift with rejection)
  int64_t below(int64_t n) {
    uint64_t range = static_cast<uint64_t>(n);
    uint64_t x = next();
    __uint128_t m = static_cast<__uint128_t>(x) * range;
    uint64_t l = static_cast<uint64_t>(m);
    if (l < range) {
      uint64_t t = (-range) % range;
      while (l < t) {
        x = next();
        m = static_cast<__uint128_t>(x) * range;
        l = static_cast<uint64_t>(m);
      }
    }
    return static_cast<int64_t>(m >> 64);
  }
};

// Floyd's algorithm: `fanout` distinct CSC positions from [lo, hi)
// WITHOUT the O(deg) index-array init of partial Fisher-Yates (Reddit
// fanout-25 sampling visits many deg-500 nodes; FY's per-node init
// dominated). Membership is a linear scan of the current draws --
// O(fanout^2) worst case, cheap for the small fanouts samplers use.
inline void floyd_sample(Rng& rng, int64_t lo, int64_t deg,
                         int64_t fanout, std::vector<int64_t>& take) {
  for (int64_t j = deg - fanout; j < deg; ++j) {
    int64_t t = lo + rng.below(j + 1);
    bool seen = false;
    for (int64_t v : take)
      if (v == t) {
        seen = true;
        break;
      }
    take.push_back(seen ? lo + j : t);
  }
}

}  // namespace

extern "C" {

// COO (sorted) row indices -> CSR pointer array of length n+1.
void ind2ptr(const int64_t* ind, int64_t num_ind, int64_t n, int64_t* out) {
  int64_t i = 0;
  for (int64_t r = 0; r <= n; ++r) {
    while (i < num_ind && ind[i] < r) ++i;
    out[r] = i;
  }
}

// CSR pointer array -> per-nonzero row indices.
void ptr2ind(const int64_t* ptr, int64_t n, int64_t* out) {
  for (int64_t r = 0; r < n; ++r)
    for (int64_t e = ptr[r]; e < ptr[r + 1]; ++e) out[e] = r;
}

// Multi-hop fixed-fanout neighbor sampling over CSC (colptr, row).
//
// seeds come first in the output node list; edges are (row_local,
// col_local, edge_global). Returns 0 on success, -1 if a capacity was
// exceeded. out_num_{nodes,edges} receive actual counts;
// hop_nodes/hop_edges (length num_hops[+1]) receive per-hop counts.
int neighbor_sample(const int64_t* colptr, const int64_t* row,
                    const int64_t* edge_perm,  // CSC position -> global edge
                    const int64_t* seeds, int64_t num_seeds,
                    const int64_t* fanouts, int64_t num_hops, int replace,
                    uint64_t rng_seed,
                    int64_t node_cap, int64_t edge_cap,
                    int64_t* out_nodes, int64_t* out_rows,
                    int64_t* out_cols, int64_t* out_edges,
                    int64_t* out_num_nodes, int64_t* out_num_edges,
                    int64_t* hop_nodes, int64_t* hop_edges) {
  Rng rng(rng_seed);
  FlatMap local(node_cap);
  int64_t n_nodes = 0, n_edges = 0;
  for (int64_t i = 0; i < num_seeds; ++i) {
    if (n_nodes >= node_cap) return -1;
    bool ins;
    local.get_or_insert(seeds[i], n_nodes, &ins);
    out_nodes[n_nodes++] = seeds[i];
  }
  hop_nodes[0] = num_seeds;
  std::vector<int64_t> frontier(seeds, seeds + num_seeds);
  std::vector<int64_t> next;
  std::vector<int64_t> take;
  for (int64_t hop = 0; hop < num_hops; ++hop) {
    next.clear();
    int64_t hop_edge_count = 0;
    const int64_t fanout = fanouts[hop];
    for (int64_t dst : frontier) {
      const int64_t lo = colptr[dst], hi = colptr[dst + 1];
      const int64_t deg = hi - lo;
      if (deg == 0) continue;
      take.clear();
      if (fanout < 0 || (deg <= fanout && !replace)) {
        for (int64_t e = lo; e < hi; ++e) take.push_back(e);
      } else if (replace) {
        for (int64_t k = 0; k < fanout; ++k)
          take.push_back(lo + rng.below(deg));
      } else {
        floyd_sample(rng, lo, deg, fanout, take);
      }
      const int64_t dst_local = local.find(dst);
      for (int64_t e : take) {
        const int64_t src = row[e];
        bool inserted;
        const int64_t src_local =
            local.get_or_insert(src, n_nodes, &inserted);
        if (inserted) {
          if (n_nodes >= node_cap) return -1;
          out_nodes[n_nodes++] = src;
          next.push_back(src);
        }
        if (n_edges >= edge_cap) return -1;
        out_rows[n_edges] = src_local;
        out_cols[n_edges] = dst_local;
        out_edges[n_edges] = edge_perm ? edge_perm[e] : e;
        ++n_edges;
        ++hop_edge_count;
      }
    }
    hop_nodes[hop + 1] = static_cast<int64_t>(next.size());
    hop_edges[hop] = hop_edge_count;
    frontier.swap(next);
  }
  *out_num_nodes = n_nodes;
  *out_num_edges = n_edges;
  return 0;
}

// Uniform random walks over CSR (reference rw.cpp).
void random_walk(const int64_t* rowptr, const int64_t* col,
                 const int64_t* starts, int64_t num_starts,
                 int64_t walk_length, uint64_t rng_seed, int64_t* out) {
  Rng rng(rng_seed);
  for (int64_t i = 0; i < num_starts; ++i) {
    int64_t cur = starts[i];
    out[i * (walk_length + 1)] = cur;
    for (int64_t t = 1; t <= walk_length; ++t) {
      const int64_t lo = rowptr[cur], hi = rowptr[cur + 1];
      if (hi > lo) {
        cur = col[lo + rng.below(hi - lo)];
      }
      out[i * (walk_length + 1) + t] = cur;
    }
  }
}

// Node-induced subgraph: edges with both endpoints in the node set,
// relabeled (reference saint.cpp). Returns edge count.
int64_t saint_subgraph(const int64_t* rowptr, const int64_t* col,
                       const int64_t* edge_perm,
                       const int64_t* nodes, int64_t num_nodes_sub,
                       int64_t* out_rows, int64_t* out_cols,
                       int64_t* out_edges, int64_t edge_cap) {
  FlatMap local(num_nodes_sub);
  for (int64_t i = 0; i < num_nodes_sub; ++i) {
    bool ins;
    local.get_or_insert(nodes[i], i, &ins);
  }
  int64_t n_edges = 0;
  for (int64_t i = 0; i < num_nodes_sub; ++i) {
    const int64_t u = nodes[i];
    for (int64_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      const int64_t v = local.find_or(col[e], -1);
      if (v < 0) continue;
      if (n_edges >= edge_cap) return -1;
      out_rows[n_edges] = i;
      out_cols[n_edges] = v;
      out_edges[n_edges] = edge_perm ? edge_perm[e] : e;
      ++n_edges;
    }
  }
  return n_edges;
}

// Batch-parallel neighbor sampling: B independent seed batches sampled
// concurrently (OpenMP), each with its own relabel map and RNG stream.
// seeds are flattened with seeds_ptr (length B+1); every output array is
// strided by the per-batch capacity. out_status[b] = 0 ok / -1 overflow.
// Replaces the reference's process-pool DataLoader workers
// (gammagl/loader/utils.py DataLoaderIter) with shared-memory threads.
void neighbor_sample_many(const int64_t* colptr, const int64_t* row,
                          const int64_t* edge_perm,
                          const int64_t* seeds, const int64_t* seeds_ptr,
                          int64_t num_batches,
                          const int64_t* fanouts, int64_t num_hops,
                          int replace, uint64_t rng_seed,
                          int64_t node_cap, int64_t edge_cap,
                          int64_t* out_nodes, int64_t* out_rows,
                          int64_t* out_cols, int64_t* out_edges,
                          int64_t* out_num_nodes, int64_t* out_num_edges,
                          int64_t* hop_nodes, int64_t* hop_edges,
                          int64_t* out_status) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t b = 0; b < num_batches; ++b) {
    const int64_t lo = seeds_ptr[b], hi = seeds_ptr[b + 1];
    out_status[b] = neighbor_sample(
        colptr, row, edge_perm, seeds + lo, hi - lo, fanouts, num_hops,
        replace, rng_seed + static_cast<uint64_t>(b) * 0x9E3779B97F4A7C15ull,
        node_cap, edge_cap,
        out_nodes + b * node_cap, out_rows + b * edge_cap,
        out_cols + b * edge_cap, out_edges + b * edge_cap,
        out_num_nodes + b, out_num_edges + b,
        hop_nodes + b * (num_hops + 1), hop_edges + b * num_hops);
  }
}

}  // extern "C"

extern "C" {

// Heterogeneous multi-hop fanout sampling (reference
// gammagl/ops/sparse/cpu/neighbor_sample.cpp:125 hetero_neighbor_sample).
//
// Edge types are flattened: per edge type e, its CSC lives at
// colptr_cat[colptr_off[e] ...] (length n_dst(e)+1) and
// row_cat/eperm_cat[row_off[e] ...]. fanouts is (num_hops x num_etypes)
// row-major; -1 = full neighborhood. Seeds carry their node type.
// Outputs: per-node-type node lists (node_cap slots each, counts in
// out_node_counts) and per-edge-type edge triples (edge_cap slots each,
// counts in out_edge_counts), with local ids per node type.
// Returns 0, or -1 on capacity overflow.
int hetero_neighbor_sample(
    int64_t num_ntypes, int64_t num_etypes,
    const int64_t* et_src_type, const int64_t* et_dst_type,
    const int64_t* colptr_cat, const int64_t* colptr_off,
    const int64_t* row_cat, const int64_t* eperm_cat,
    const int64_t* row_off,
    const int64_t* fanouts, int64_t num_hops,
    const int64_t* seed_nodes, const int64_t* seed_types,
    int64_t num_seeds,
    uint64_t rng_seed, int64_t node_cap, int64_t edge_cap,
    int64_t* out_nodes,        // (num_ntypes * node_cap)
    int64_t* out_node_counts,  // (num_ntypes)
    int64_t* out_rows,         // (num_etypes * edge_cap)
    int64_t* out_cols, int64_t* out_edges,
    int64_t* out_edge_counts)  // (num_etypes)
{
  Rng rng(rng_seed);
  std::vector<FlatMap> local;
  local.reserve(num_ntypes);
  for (int64_t t = 0; t < num_ntypes; ++t) local.emplace_back(node_cap);
  std::vector<std::vector<int64_t>> frontier(num_ntypes), next(num_ntypes);
  for (int64_t t = 0; t < num_ntypes; ++t) out_node_counts[t] = 0;
  for (int64_t e = 0; e < num_etypes; ++e) out_edge_counts[e] = 0;
  for (int64_t i = 0; i < num_seeds; ++i) {
    const int64_t t = seed_types[i];
    bool inserted;
    local[t].get_or_insert(seed_nodes[i], out_node_counts[t], &inserted);
    if (!inserted) continue;
    if (out_node_counts[t] >= node_cap) return -1;
    out_nodes[t * node_cap + out_node_counts[t]++] = seed_nodes[i];
    frontier[t].push_back(seed_nodes[i]);
  }
  std::vector<int64_t> take;
  for (int64_t hop = 0; hop < num_hops; ++hop) {
    for (auto& v : next) v.clear();
    for (int64_t e = 0; e < num_etypes; ++e) {
      const int64_t fanout = fanouts[hop * num_etypes + e];
      if (fanout == 0) continue;
      const int64_t st = et_src_type[e], dt = et_dst_type[e];
      const int64_t* colptr = colptr_cat + colptr_off[e];
      const int64_t* row = row_cat + row_off[e];
      const int64_t* eperm = eperm_cat + row_off[e];
      const int64_t n_dst =
          colptr_off[e + 1] - colptr_off[e] - 1;
      for (int64_t dst : frontier[dt]) {
        if (dst >= n_dst) continue;
        const int64_t lo = colptr[dst], hi = colptr[dst + 1];
        const int64_t deg = hi - lo;
        if (deg == 0) continue;
        take.clear();
        if (fanout < 0 || deg <= fanout) {
          for (int64_t k = lo; k < hi; ++k) take.push_back(k);
        } else {
          floyd_sample(rng, lo, deg, fanout, take);
        }
        const int64_t dst_local = local[dt].find(dst);
        for (int64_t k : take) {
          const int64_t src = row[k];
          bool inserted;
          const int64_t src_local = local[st].get_or_insert(
              src, out_node_counts[st], &inserted);
          if (inserted) {
            if (out_node_counts[st] >= node_cap) return -1;
            out_nodes[st * node_cap + out_node_counts[st]++] = src;
            next[st].push_back(src);
          }
          int64_t& ec = out_edge_counts[e];
          if (ec >= edge_cap) return -1;
          out_rows[e * edge_cap + ec] = src_local;
          out_cols[e * edge_cap + ec] = dst_local;
          out_edges[e * edge_cap + ec] = eperm[k];
          ++ec;
        }
      }
    }
    frontier.swap(next);
  }
  return 0;
}

}  // extern "C"
