// Segment max (and min) over a destination-sorted CSR for Hopper (sm_90a),
// forward and backward, with a plain C interface loaded by ctypes.
//
// Forward, per destination row d and column c, over the CSR edges e of d:
//   msg[e, c] = x[r(e), c] * w_T[e]    rounded to T (the dtype of x)
//   out[d, c] = max_e msg[e, c]        (negate: -max_e -msg[e, c], the min)
// where r(e) = col[e] (source rows gathered) or e (per-edge rows in CSR
// order), w_T is the weight rounded to T (1 when w is null), and a row
// without edges gives 0, as does a winner of -inf (+inf for the min), whose
// gradient is then 0. The running value starts at -inf and takes a
// message only when it is larger, so the output is the winning message, bit
// for bit (negation is a sign flip, so the min is exact too).
//
// Backward, with g = dL/dout: per row and column the winners are the edges
// whose message equals out[d, c]; each gets g[d, c] / (number of winners),
// rounded to T, every other edge 0:
//   dmsg[e, c]  (E, F) in CSR order
//   dw[e] = sum_c dmsg[e, c] * x[r(e), c]   (only with weights, on request)
// The caller sums dmsg into source rows (the SpMM kernel on the plan's
// edge-scatter transpose, with the weight folded in).
//
// Replaces the TPU kernel of gammagl_tpu/ops/pallas/segment_max.py:
// _segment_max_pallas (:85, a segmented max-scan and a one-hot pick on the
// matrix unit, with f32 values moved as four 8-bit chunks so the pick stays
// exact) and the function of its VJP _segment_max_bwd (:195, tie counts by
// a segment sum over the same plan). Here the messages are compared in
// registers, so the exactness needs no chunked transport, and the tie
// count is a register per column.
//
// What bounds it on the card: bytes, and the latency of reaching them.
// Each edge reads one row of F elements (a random source row, or the next
// row in CSR order) and does one compare per element; the backward also
// writes one row of dmsg an edge. The design is the CSR SpMM kernel's
// schedule (csrc/spmm_csr.cu, csrc/csr_items.cuh) with max in place of +:
//  * work items of at most ROW_SPLIT consecutive CSR edges, so a hub row
//    of a power-law graph is spread over many lane groups. An item that
//    owns its row writes it; an item of a cut row writes its partial
//    maximum (a message of T, exact in f32, -inf where it has no winner)
//    into its scratch slot, and segment_max_fold takes each cut row's
//    maximum over its slots in item order, then applies the rule for an
//    infinite winner once, to the row's final value;
//  * lane groups sized by F (F = 128 bf16: two items a warp), 16-byte
//    loads where F and the pointers allow them;
//  * a cp.async ring of gathered (or per-edge) rows, kStages a lane.
// The backward gathers each message once where a row allows: while it
// counts the ties of an item of up to kTieBits edges, each lane keeps which
// edges won each of its columns as bits in registers (8 bytes a column),
// and writes dmsg from them without reading a message again, so the
// backward needs no more shared memory than the forward's ring. A longer
// item, an item of a cut row (whose count comes from the fold) and a
// backward that takes dw (which needs each raw row) gather the messages a
// second time.
// A cut row needs the whole row's tie count before any share is written:
// segment_max_count counts each of its items' winners into the item's
// slot, segment_max_count_fold sums each cut row's counts in item order
// (exact integers in f32) into every slot of the row, and the backward
// reads its item's total from there. dw sums within each lane group by
// butterfly, then over the column chunks in order. No atomics: every
// result is deterministic.

#include "csr_items.cuh"

namespace {

// Rows in flight a lane, forward and backward: 16 bytes each in shared
// memory, 32 KB a block of 256 lanes, as the CSR SpMM kernel's ring. On the
// H100 (bf16, the arxiv-shape graph), 4 rows took the backward at F = 256
// 3% longer and the forward at F = 128 4% less (scripts/max_hgt_probe.py).
constexpr int kStages = 8;
// Edges of an item whose wins the backward keeps as bits: items of up to
// kTieBits edges (98% of the arxiv-shape graph's edges) gather once. On
// the H100 this took the backward at F = 256 / 128 0.906 / 0.541 ms where
// a stage of 32 messages a lane in shared memory (64-lane blocks) took
// 1.087 / 0.577 (scripts/max_hgt_probe.py, in one call).
constexpr int kTieBits = 64;
// Blocks of the backward an SM must hold, which caps its registers at 80.
// Without a minimum ptxas held some instantiations to 64 registers and
// spilled; on the H100 (bf16, F = 256 / 128) 3 blocks took 0.901 / 0.537
// ms, 2 blocks 0.995 / 0.527, 4 blocks (64 registers, spills) 0.933 /
// 0.606 (scripts/max_hgt_probe.py, in one call).
constexpr int kBwdBlocks = 3;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// f32 v rounded to T and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  return __uint_as_float(bf16_bits(v) << 16);
}

// One edge's message from its row as loaded (raw), with the weight wj
// (f32, rounded to T here) when kWeighted, rounded to T.
template <typename T, int V, bool kWeighted>
__device__ __forceinline__ void message(const float (&raw)[V], float wj,
                                        float (&v)[V]) {
  const float wv = kWeighted ? round_to<T>(wj) : 1.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = kWeighted ? round_to<T>(raw[i] * wv) : raw[i];
}

// Edge e's row: col[e] (gathered) or e (per-edge rows).
template <bool kPerEdge>
struct EdgeRow {
  const int32_t* col;
  __device__ int64_t operator()(int64_t e) const {
    if constexpr (kPerEdge) return e;
    return static_cast<int64_t>(__ldg(col + e));
  }
};

template <bool kWeighted>
struct EdgeWeight {
  const float* w;
  __device__ float operator()(int64_t e) const {
    return kWeighted ? __ldg(w + e) : 1.f;
  }
};

// One group of L = 2^lg lanes per item. kNegate: the max of the negated
// messages, negated (the min).
template <typename T, int V, bool kPerEdge, bool kWeighted, bool kNegate>
__global__ void __launch_bounds__(kThreads)
    segment_max_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const int32_t* __restrict__ col, T* __restrict__ out,
                       Items items, int lg, int64_t F) {
  __shared__ uint4 ring[kStages][kThreads];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> lg;
  if (item >= items.n) return;  // no lane waits on another
  const int64_t L = int64_t{1} << lg;
  const Item it = item_at(items, item);
  const float sign = kNegate ? -1.f : 1.f;

  for (int64_t c = (t & (L - 1)) * V; c < F; c += L * V) {
    float m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = neg_inf();
    walk_edges<T, V, kStages>(
        ring, x + c, F, it.lo, it.n, true, EdgeRow<kPerEdge>{col},
        EdgeWeight<kWeighted>{w}, [&](int64_t, float wj, const T* staged) {
          float raw[V], v[V];
          load_vec<T, V, false>(staged, raw);
          message<T, V, kWeighted>(raw, wj, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float s = sign * v[i];
            m[i] = s > m[i] ? s : m[i];
          }
        });
    if (it.slot < 0) {
      // m is still -inf in a row without edges and where every message is
      // -inf (+inf for the min): both give 0, as the JAX kernel's `where`
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = m[i] == neg_inf() ? 0.f : sign * m[i];
      store_vec<T, V>(out + it.row * F + c, o);
    } else {  // the partial, in the negated space for the min
      store_f32<V>(items.part + it.slot * items.stride + c, m);
    }
  }
}

// The forward's fold: a cut row's maximum over its items' partials, taken
// in item order as the walk takes edges, then the rule for an infinite
// winner, once.
template <typename T, int V, bool kNegate>
struct MaxFold {
  T* out;
  int64_t F;
  __device__ void start(int64_t, int64_t, float (&acc)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = neg_inf();
  }
  __device__ void add(float (&acc)[V], const float (&a)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = a[k] > acc[k] ? a[k] : acc[k];
  }
  __device__ void finish(int64_t row, int64_t c, int64_t, int64_t,
                         const float (&acc)[V]) const {
    const float sign = kNegate ? -1.f : 1.f;
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = acc[k] == neg_inf() ? 0.f : sign * acc[k];
    store_vec<T, V>(out + row * F + c, o);
  }
};

// The backward's fold of tie counts: a cut row's counts summed in item
// order (exact integers), written to every slot of the row in `total`.
template <int V>
struct CountFold {
  float* total;
  int64_t stride;
  __device__ void start(int64_t, int64_t, float (&acc)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
  }
  __device__ void add(float (&acc)[V], const float (&a)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += a[k];
  }
  __device__ void finish(int64_t, int64_t c, int64_t s0, int64_t s1,
                         const float (&acc)[V]) const {
    for (int64_t s = s0; s < s1; ++s) store_f32<V>(total + s * stride + c, acc);
  }
};

// One group of L = 2^lg lanes per item; every lane of a group runs every
// column chunk and edge (the dw butterfly needs the whole group).
// kCount: the tie counts of the items of cut rows, into their slots of
// items.part (items that own their row do nothing). Else: each item's
// dmsg (and dw); an item of a cut row reads its row's total count from its
// slot of items.part (segment_max_count_fold's output).
template <typename T, int V, bool kPerEdge, bool kWeighted, bool kDw,
          bool kCount>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    segment_max_bwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ w,
                           const int32_t* __restrict__ col,
                           const T* __restrict__ out,
                           const T* __restrict__ grad, T* __restrict__ dmsg,
                           float* __restrict__ dw, Items items, int lg,
                           int64_t F) {
  __shared__ uint4 ring[kStages][kThreads];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> lg;
  if (item >= items.n) return;  // the whole group leaves together
  const int L = 1 << lg;
  const int lane = static_cast<int>(t & (L - 1));
  const Item it = item_at(items, item);
  if (it.n == 0 || (kCount && it.slot < 0)) return;
  const unsigned mask = group_mask(L);
  const EdgeRow<kPerEdge> source{col};
  const EdgeWeight<kWeighted> weight{w};
  const int64_t row = it.row;
  float* slot = it.slot < 0 ? nullptr : items.part + it.slot * items.stride;
  // the wins of this item's edges are kept as bits, and its messages read
  // once
  const bool bits = !kDw && !kCount && it.slot < 0 && it.n <= kTieBits;

  for (int64_t c0 = 0; c0 < F; c0 += static_cast<int64_t>(L) * V) {
    const int64_t c = c0 + static_cast<int64_t>(lane) * V;
    const bool active = c < F;  // V divides F whenever V > 1
    float o[V], cnt[V];
    uint64_t won[V];  // bit j: edge j wins the column
#pragma unroll
    for (int i = 0; i < V; ++i) {
      o[i] = cnt[i] = 0.f;
      won[i] = 0;
    }
    if (active) load_vec<T, V>(out + row * F + c, o);
    auto count = [&](int64_t j, float wj, const T* staged) {
      if (!active) return;
      float raw[V], v[V];
      load_vec<T, V, false>(staged, raw);
      message<T, V, kWeighted>(raw, wj, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool eq = v[i] == o[i];
        cnt[i] += eq ? 1.f : 0.f;
        if (bits) won[i] |= static_cast<uint64_t>(eq) << j;
      }
    };
    if (kCount || it.slot < 0)  // pass 1: how many edges win each column
      walk_edges<T, V, kStages>(
          ring, x + c, F, it.lo, it.n, active, source, weight, count);
    if constexpr (kCount) {
      if (active) store_f32<V>(slot + c, cnt);
      continue;
    }
    if (it.slot >= 0 && active) load_f32<V>(slot + c, cnt);
    float share[V];
    {
      float gv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) gv[i] = 0.f;
      if (active) load_vec<T, V>(grad + row * F + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i)
        share[i] = round_to<T>(gv[i] / fmaxf(cnt[i], 1.f));
    }
    // pass 2: each edge's cotangent, and its weight's
    auto write = [&](int64_t j, float wj, const T* staged) {
      const int64_t e = it.lo + j;
      float part = 0.f;
      if (active) {
        float raw[V], v[V], d[V];
        load_vec<T, V, false>(staged, raw);
        message<T, V, kWeighted>(raw, wj, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          d[i] = v[i] == o[i] ? share[i] : 0.f;
          part = fmaf(d[i], raw[i], part);
        }
        store_vec<T, V>(dmsg + e * F + c, d);
      }
      if constexpr (kDw) {
        for (int off = L / 2; off > 0; off /= 2)
          part += __shfl_xor_sync(mask, part, off);
        if (lane == 0) dw[e] = (c0 == 0 ? 0.f : dw[e]) + part;
      }
    };
    if (bits) {  // dmsg from the wins alone
      if (active) {
        for (int64_t j = 0; j < it.n; ++j) {
          float d[V];
#pragma unroll
          for (int i = 0; i < V; ++i)
            d[i] = (won[i] >> j) & 1 ? share[i] : 0.f;
          store_vec<T, V>(dmsg + (it.lo + j) * F + c, d);
        }
      }
    } else {
      walk_edges<T, V, kStages>(
          ring, x + c, F, it.lo, it.n, active, source, weight, write);
    }
  }
}

template <typename T, bool kPerEdge, bool kWeighted>
void launch_fwd(const void* x, const float* w, const int32_t* col,
                void* out, Items items, int64_t F, int negate,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const void* ptrs[] = {x, out};
  const bool vec = pick_vec<T>(F, ptrs, 2) == kVec;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int lg = lanes_log2(F, vec ? kVec : 1);
  const dim3 grid = grid_of(items.n, lg);
#define GAMMAGL_MAX(VV, NEG)                                                \
  segment_max_kernel<T, VV, kPerEdge, kWeighted, NEG>                       \
      <<<grid, kThreads, 0, stream>>>(xt, w, col, ot, items, lg, F)
  if (vec && negate) GAMMAGL_MAX(kVec, true);
  else if (vec) GAMMAGL_MAX(kVec, false);
  else if (negate) GAMMAGL_MAX(1, true);
  else GAMMAGL_MAX(1, false);
#undef GAMMAGL_MAX
}

template <typename T, bool kPerEdge, bool kWeighted>
void launch_bwd(const void* x, const float* w, const int32_t* col,
                const void* out, const void* grad, void* dmsg, float* dw,
                Items items, int64_t F, bool count, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const void* ptrs[] = {x, out, grad, dmsg};
  const bool vec = pick_vec<T>(F, ptrs, 4) == kVec;
  const T* xt = static_cast<const T*>(x);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(grad);
  T* dt = static_cast<T*>(dmsg);
  const int lg = lanes_log2(F, vec ? kVec : 1);
  const dim3 grid = grid_of(items.n, lg);
#define GAMMAGL_MAX_BWD(VV, DW, CNT)                                        \
  segment_max_bwd_kernel<T, VV, kPerEdge, kWeighted, DW, CNT>               \
      <<<grid, kThreads, 0, stream>>>(xt, w, col, ot, gt, dt, dw, items,    \
                                         lg, F)
  const bool want_dw = kWeighted && dw != nullptr;
  if (count && vec) GAMMAGL_MAX_BWD(kVec, false, true);
  else if (count) GAMMAGL_MAX_BWD(1, false, true);
  else if (vec && want_dw) GAMMAGL_MAX_BWD(kVec, kWeighted, false);
  else if (vec) GAMMAGL_MAX_BWD(kVec, false, false);
  else if (want_dw) GAMMAGL_MAX_BWD(1, kWeighted, false);
  else GAMMAGL_MAX_BWD(1, false, false);
#undef GAMMAGL_MAX_BWD
}

template <typename T>
void fwd_mode(const void* x, const float* w, const int32_t* col, void* out,
              Items items, int64_t F, int per_edge, int negate,
              cudaStream_t s) {
  if (per_edge)
    launch_fwd<T, true, false>(x, w, col, out, items, F, negate, s);
  else if (w != nullptr)
    launch_fwd<T, false, true>(x, w, col, out, items, F, negate, s);
  else
    launch_fwd<T, false, false>(x, w, col, out, items, F, negate, s);
}

template <typename T>
void bwd_mode(const void* x, const float* w, const int32_t* col,
              const void* out, const void* grad, void* dmsg, float* dw,
              Items items, int64_t F, int per_edge, bool count,
              cudaStream_t s) {
  if (per_edge)
    launch_bwd<T, true, false>(x, w, col, out, grad, dmsg, dw, items, F,
                               count, s);
  else if (w != nullptr)
    launch_bwd<T, false, true>(x, w, col, out, grad, dmsg, dw, items, F,
                               count, s);
  else
    launch_bwd<T, false, false>(x, w, col, out, grad, dmsg, dw, items, F,
                                count, s);
}

template <typename T>
void launch_max_fold(const float* part, const int32_t* cut_row,
                     const int64_t* cut_ptr, void* out, int64_t n_cut,
                     int64_t F, int64_t stride, int negate,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const void* ptrs[] = {out};
  const bool vec = pick_vec<T>(F, ptrs, 1) == kVec;
  T* ot = static_cast<T*>(out);
  const int lg = lanes_log2(F, vec ? kVec : 1);
  const dim3 grid = grid_of(n_cut, lg);
#define GAMMAGL_MAX_FOLD(VV, NEG)                                           \
  csr_fold_kernel<VV><<<grid, kThreads, 0, stream>>>(             \
      part, cut_row, cut_ptr, n_cut, lg, F, stride,                         \
      MaxFold<T, VV, NEG>{ot, F})
  if (vec && negate) GAMMAGL_MAX_FOLD(kVec, true);
  else if (vec) GAMMAGL_MAX_FOLD(kVec, false);
  else if (negate) GAMMAGL_MAX_FOLD(1, true);
  else GAMMAGL_MAX_FOLD(1, false);
#undef GAMMAGL_MAX_FOLD
}

bool bad_sizes(int64_t F, int per_edge, const void* w) {
  return F < 0 || (per_edge && w != nullptr);
}

}  // namespace

extern "C" {

// x: (rows, F) bf16 (x_is_bf16 != 0) or f32, contiguous, read at col[e]
// (per_edge == 0: node rows) or at e (per_edge != 0: one row per CSR edge;
// col may then be null and w must be null); w: (E,) f32 in CSR order or
// null for unit weights; col: (E,) int32; out: (n_dst, F) of x's type, the
// max (negate == 0) or the min (negate != 0).
// The items, as gammagl_spmm_csr's: item_ptr (n_items + 1,) int64 edge
// offsets; item_meta (n_items, 2) int32 {row, slot}, slot -1 for an item
// that owns its row, or null (item i is row i, item_ptr the plan's
// rowptr); part: f32 scratch of (slots, part_stride) for the partials of
// cut rows (null when no item has a slot), part_stride a multiple of 4 that
// is >= F. A cut row is written by gammagl_segment_max_fold, launched after
// this on the same stream.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
int gammagl_segment_max_fwd(const void* x, const void* w,
                            const void* item_ptr, const void* item_meta,
                            int64_t n_items, const void* col, void* part,
                            int64_t part_stride, void* out, int64_t F,
                            int per_edge, int negate, int x_is_bf16,
                            void* stream) {
  Items items;
  if (bad_sizes(F, per_edge, w) ||
      !make_items(item_ptr, item_meta, n_items, part, part_stride, F, &items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      fwd_mode<__nv_bfloat16>(x, wf, cl, out, items, F, per_edge, negate, s);
    else
      fwd_mode<float>(x, wf, cl, out, items, F, per_edge, negate, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's fold of cut rows: part (slots, part_stride) f32 as
// gammagl_segment_max_fwd wrote it (with the same negate); cut_row
// (n_cut,) int32 the rows; cut_ptr (n_cut + 1,) int64, cut row i owning
// slots [cut_ptr[i], cut_ptr[i + 1]) in item order; out (n_dst, F) of x's
// type.
int gammagl_segment_max_fold(const void* part, int64_t part_stride,
                             const void* cut_row, const void* cut_ptr,
                             int64_t n_cut, void* out, int64_t F, int negate,
                             int x_is_bf16, void* stream) {
  if (!fold_ok(part, part_stride, n_cut, F))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cut > 0 && F > 0) {
    const float* pf = static_cast<const float*>(part);
    const int32_t* cr = static_cast<const int32_t*>(cut_row);
    const int64_t* cp = static_cast<const int64_t*>(cut_ptr);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch_max_fold<__nv_bfloat16>(pf, cr, cp, out, n_cut, F, part_stride,
                                     negate, s);
    else
      launch_max_fold<float>(pf, cr, cp, out, n_cut, F, part_stride, negate,
                             s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward (x, w, the items, col), plus out: its output and grad:
// dL/dout, both (n_dst, F) of x's type. count == 0: writes dmsg, (E, F) of
// x's type in CSR order, and, when w and dw are not null, dw, (E,) f32 in
// CSR order; an item of a cut row reads its row's tie counts from its slot
// of part (gammagl_segment_max_count_fold's total). count != 0: writes
// only the tie counts of the items of cut rows into their slots of part
// (dmsg and dw are not touched). Rows without edges write nothing (they
// own no entries of dmsg or dw).
int gammagl_segment_max_bwd(const void* x, const void* w,
                            const void* item_ptr, const void* item_meta,
                            int64_t n_items, const void* col, void* part,
                            int64_t part_stride, const void* out,
                            const void* grad, void* dmsg, void* dw,
                            int64_t F, int per_edge, int count,
                            int x_is_bf16, void* stream) {
  Items items;
  if (bad_sizes(F, per_edge, w) ||
      !make_items(item_ptr, item_meta, n_items, part, part_stride, F,
                  &items) ||
      (count && item_meta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* dwf = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      bwd_mode<__nv_bfloat16>(x, wf, cl, out, grad, dmsg, dwf, items, F,
                              per_edge, count != 0, s);
    else
      bwd_mode<float>(x, wf, cl, out, grad, dmsg, dwf, items, F, per_edge,
                      count != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's fold of tie counts: counts (slots, part_stride) f32 as
// gammagl_segment_max_bwd with count != 0 wrote them; cut_ptr (n_cut + 1,)
// int64 as for the forward's fold; writes each cut row's total, summed in
// item order, into each of its slots of total (slots, part_stride) f32.
int gammagl_segment_max_count_fold(const void* counts, int64_t part_stride,
                                   const void* cut_row, const void* cut_ptr,
                                   int64_t n_cut, void* total, int64_t F,
                                   void* stream) {
  if (!fold_ok(counts, part_stride, n_cut, F) ||
      (n_cut > 0 && F > 0 && total == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cut > 0 && F > 0) {
    const float* pf = static_cast<const float*>(counts);
    const int32_t* cr = static_cast<const int32_t*>(cut_row);
    const int64_t* cp = static_cast<const int64_t*>(cut_ptr);
    float* tf = static_cast<float*>(total);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* ptrs[] = {counts, total};
    const bool vec = pick_vec<float>(F, ptrs, 2) == 4;
    const int lg = lanes_log2(F, vec ? 4 : 1);
    const dim3 grid = grid_of(n_cut, lg);
    if (vec)
      csr_fold_kernel<4><<<grid, kThreads, 0, s>>>(
          pf, cr, cp, n_cut, lg, F, part_stride,
          CountFold<4>{tf, part_stride});
    else
      csr_fold_kernel<1><<<grid, kThreads, 0, s>>>(
          pf, cr, cp, n_cut, lg, F, part_stride,
          CountFold<1>{tf, part_stride});
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
