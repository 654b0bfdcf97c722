// The work-item schedule shared by the CSR kernels (csrc/spmm_csr.cu,
// csrc/segment_max.cu and the flash forward of csrc/flash_attention.cu):
// items of consecutive CSR edges taken by lane groups, the walk of an
// item's edges through a cp.async ring in shared memory (also the HGT
// kernels', csrc/hetero_flash.cu), and the fold of cut rows' per-item
// partials in item order.
//
// A row of up to K edges (the wrappers' ROW_SPLIT) is one item, a longer
// row is cut into ceil(deg / K) items, an empty row is one empty item. An
// item that owns its row writes the row; an item of a cut row writes an
// f32 partial into its scratch slot, and a fold kernel combines each cut
// row's partials in item order. A plan without cut rows passes no item
// table: item i is row i.
//
// An item is taken by a group of L = 2^lg lanes, the power of two >= F / V
// (at most 32, with a loop over column chunks above 32 V), so a warp runs
// 32 / L items at once; consecutive groups take consecutive items.
#pragma once

#include "common.cuh"

namespace {

// Lanes a block of the item kernels and the folds.
constexpr int kThreads = kWarp * kWarpsPerBlock;

// The items of one launch. Item i holds CSR edges [ptr[i], ptr[i + 1]);
// meta[i] = {its row, its scratch slot or -1 for an item that owns its
// row}, or meta is null and item i is row i (ptr is then rowptr).
struct Items {
  const int64_t* ptr;
  const int2* meta;
  int64_t n;
  float* part;     // (slots, stride) f32 partials of cut rows
  int64_t stride;  // a multiple of 4 that is >= F
};

// One item: its row, its slot (-1: it owns its row), its first CSR edge
// and its number of edges.
struct Item {
  int64_t row;
  int slot;
  int64_t lo, n;
};

__device__ __forceinline__ Item item_at(const Items& items, int64_t i) {
  Item it;
  it.row = i;
  it.slot = -1;
  if (items.meta != nullptr) {
    const int2 m = __ldg(items.meta + i);
    it.row = m.x;
    it.slot = m.y;
  }
  it.lo = __ldg(items.ptr + i);
  it.n = __ldg(items.ptr + i + 1) - it.lo;
  return it;
}

// The mask of this lane's aligned group of L lanes, for shuffles inside a
// group while other groups of the warp walk items of other lengths.
__device__ __forceinline__ unsigned group_mask(int L) {
  if (L == kWarp) return kFullMask;
  return ((1u << L) - 1u) << ((threadIdx.x % kWarp) & ~(L - 1));
}

// V f32 values at p (aligned to min(V, 4) floats).
template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  } else {
    load_vec<float, V>(p, f);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* __restrict__ p,
                                          const float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
    store_vec<float, V>(p, f);
  }
}

// Walk n edges from CSR edge lo, in order, through a ring of kStages
// stages in shared memory: copy(s, source(e)) issues this lane's copies of
// edge e's data into stage s by cp.async, kStages edges ahead, and for
// edge e = lo + j, once its stage has landed, take(j, weight(e), s) reads
// the stage and returns what the rest of the edge's work needs; this
// lane's copy of edge e + kStages into that stage is issued next, and then
// use(j, what take returned) runs, so work that does not read the stage (a
// sum across lanes, a store) overlaps the copies in flight. The next
// edge's source (a row index, or a struct of the rows its copies read) and
// weight are loaded a step ahead. Each lane reads back only what it
// copied, so the ring needs no barrier; every lane runs every step, so
// lanes of a group stay together for shuffles.
template <int kStages, class Source, class Weight, class Copy, class Take,
          class Use>
__device__ __forceinline__ void walk_ring_split(int64_t lo, int64_t n,
                                                Source source, Weight weight,
                                                Copy copy, Take take,
                                                Use use) {
  using Index = decltype(source(lo));
  // the first kStages edges: all their indices, then all their copies
  Index r0[kStages + 1];
#pragma unroll
  for (int s = 0; s <= kStages; ++s)
    r0[s] = s < n ? source(lo + s) : Index{};
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < n) copy(s, r0[s]);
    commit_stage();
  }
  Index r_next = r0[kStages];
  float w_cur = n > 0 ? weight(lo) : 0.f;
  for (int64_t j = 0; j < n; ++j) {
    const float w_next = j + 1 < n ? weight(lo + j + 1) : 0.f;
    wait_stages<kStages - 1>();  // edge j has landed
    const int s = static_cast<int>(j % kStages);
    const auto taken = take(j, w_cur, s);
    // the stage's reads in take leave the load/store unit before this
    // lane's next copy into it (shared-memory accesses of a warp are
    // issued in order; the copy lands a global round trip later)
    if (j + kStages < n) {
      copy(s, r_next);
      if (j + kStages + 1 < n) r_next = source(lo + j + kStages + 1);
    }
    commit_stage();
    use(j, taken);
    w_cur = w_next;
  }
}

// walk_ring_split whose visit(j, weight(e), s) does all of an edge's work
// before the next copy into its stage.
template <int kStages, class Source, class Weight, class Copy, class Visit>
__device__ __forceinline__ void walk_ring(int64_t lo, int64_t n,
                                          Source source, Weight weight,
                                          Copy copy, Visit visit) {
  walk_ring_split<kStages>(
      lo, n, source, weight, copy,
      [&](int64_t j, float w, int s) {
        visit(j, w, s);
        return 0;
      },
      [](int64_t, int) {});
}

// walk_ring over rows of x: stage s is this lane's 16-byte slot
// ring[s][threadIdx.x], into which it copies V elements at xc + source(e)
// * F (a lone bf16 by a plain load; nothing when `copy` is false), and
// visit(j, weight(e), the slot) runs on them.
template <typename T, int V, int kStages, class Source, class Weight,
          class Visit>
__device__ __forceinline__ void walk_edges(uint4 (*ring)[kThreads],
                                           const T* xc, int64_t F,
                                           int64_t lo, int64_t n, bool copy,
                                           Source source, Weight weight,
                                           Visit visit) {
  walk_ring<kStages>(
      lo, n, source, weight,
      [&](int s, int64_t r) {
        if (copy) stage_copy<T, V>(&ring[s][threadIdx.x], xc + r * F);
      },
      [&](int64_t j, float w, int s) {
        visit(j, w, reinterpret_cast<const T*>(&ring[s][threadIdx.x]));
      });
}

// The fold of cut rows: cut row i (row cut_row[i]) owns scratch slots
// [cut_ptr[i], cut_ptr[i + 1]), one per item in item order. For each
// column chunk, acc = fold.start(row, c), then acc = fold.add(acc, part of
// slot s) for each slot in order, then fold.finish(row, c, s0, s1, acc).
// Groups of 2^lg lanes as in the item kernels.
template <int V, class Fold>
__global__ void __launch_bounds__(kThreads)
    csr_fold_kernel(const float* __restrict__ part,
                    const int32_t* __restrict__ cut_row,
                    const int64_t* __restrict__ cut_ptr, int64_t n_cut,
                    int lg, int64_t F, int64_t stride, Fold fold) {
  constexpr int kUnroll = 8;  // slots in flight: a hub row has hundreds
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = t >> lg;
  if (i >= n_cut) return;
  const int64_t L = int64_t{1} << lg;
  const int64_t row = __ldg(cut_row + i);
  const int64_t s0 = __ldg(cut_ptr + i), s1 = __ldg(cut_ptr + i + 1);
  for (int64_t c = (t & (L - 1)) * V; c < F; c += L * V) {
    float acc[V];
    fold.start(row, c, acc);
    const float* p = part + c;
    int64_t s = s0;
    for (; s + kUnroll <= s1; s += kUnroll) {
      float a[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_f32<V>(p + (s + u) * stride, a[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold.add(acc, a[u]);
    }
    for (; s < s1; ++s) {
      float a[V];
      load_f32<V>(p + s * stride, a);
      fold.add(acc, a);
    }
    fold.finish(row, c, s0, s1, acc);
  }
}

// log2 of the lanes an item takes: the power of two >= ceil(F / V), at
// most 32.
inline int lanes_log2(int64_t F, int V) {
  const int64_t per = (F + V - 1) / V;
  int lg = 0;
  while (lg < 5 && (int64_t{1} << lg) < per) ++lg;
  return lg;
}

inline bool grid_ok(int64_t n, int lg) {
  return n >= 0 && ((n << lg) + kThreads - 1) / kThreads <= 0x7fffffff;
}

inline dim3 grid_of(int64_t n, int lg) {
  return dim3(static_cast<unsigned>(((n << lg) + kThreads - 1) / kThreads));
}

// The items as the entry points receive them; false where they cannot be
// launched.
inline bool make_items(const void* item_ptr, const void* item_meta,
                       int64_t n_items, void* part, int64_t stride,
                       int64_t F, Items* items) {
  if (n_items < 0 || item_ptr == nullptr || stride < F || stride % 4 != 0 ||
      !grid_ok(n_items, 5))
    return false;
  items->ptr = static_cast<const int64_t*>(item_ptr);
  items->meta = static_cast<const int2*>(item_meta);
  items->n = n_items;
  items->part = static_cast<float*>(part);
  items->stride = stride;
  return item_meta == nullptr || part != nullptr;
}

// The arguments of a fold launch; false where it cannot be launched.
inline bool fold_ok(const void* part, int64_t stride, int64_t n_cut,
                    int64_t F) {
  return F >= 0 && stride >= F && stride % 4 == 0 && grid_ok(n_cut, 5) &&
         !(n_cut > 0 && F > 0 && part == nullptr);
}

}  // namespace
