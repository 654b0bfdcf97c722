// CSR SpMM for Hopper (sm_90a), with a plain C interface loaded by ctypes.
//
//   out[d, c] = sum_{e in [rowptr[d], rowptr[d+1])} w[e, head(c)] * x[r(e), c]
//
// where r(e) = col[e] (the SpMM: a gathered source row) or r(e) = e (the
// per-edge segment sum: x holds one row per edge in CSR order), and w is
// null (every weight 1), (E,) or (E, H) with head(c) = c / (F / H).
//
// Replaces the TPU kernels of gammagl_tpu/ops/pallas/segment_matmul.py that
// compute this one function in several layouts: segment_matmul_dyn (:243),
// _spmm_win_forward (:774, _packed_win_kernel and _plain_win_kernel),
// _spmm_packed_forward (:686, _packed_kernel) and, with r(e) = e,
// segment_sum_win (:849, the backward of expand_dst_csr). Their one-hot
// matmuls, packed bf16 halves and window plans fit the TPU's matrix unit
// and gather engine; here the destination-sorted CSR is read directly, and
// a window layout has no counterpart: per-edge rows are read in CSR order.
//
// What bounds it on the card: bytes, and the latency of reaching them.
// Every edge reads one row of x (F elements; a random source row for the
// SpMM, the next row in order for the segment sum) and does 2 flops per
// element read, far below the H100's ridge point; a gathered row that
// misses L2 costs a full trip to HBM. Two shapes of graph starve the card
// of bytes in flight when one warp walks one destination row:
//  * skewed in-degree: a hub row of power-law sources (1.4M edges on the
//    papers shard's transpose) runs on one warp while the rest of the card
//    idles;
//  * narrow rows: 8 bf16 columns a lane leave most of a warp idle at
//    F <= 128 (F = 40 uses 5 lanes of 32), and short rows spend the
//    row's fixed cost (offsets, prev, the store) on a couple of edges.
//
// What the design does about it:
//  * work items of at most K consecutive CSR edges (K is the wrappers'
//    ROW_SPLIT, built once per plan on the host): a row of up to K edges
//    is one item, a longer row is cut into ceil(deg / K) items, an empty
//    row is one empty item. An item that owns its row stores prev (or 0)
//    plus its sum, rounded once. An item of a cut row stores its f32
//    partial in a scratch slot, and a second kernel (csr_fold_kernel)
//    sums each cut row's partials in item order, starting from prev, and
//    rounds once. No atomics: the result is deterministic, and it differs
//    from one warp's walk of the row only by f32 reassociation. A plan
//    without cut rows passes no item table: item i is row i;
//  * lane groups sized by the row: an item is taken by L lanes, the power
//    of two >= F / V (at most 32, with a loop over column chunks above
//    32 V), so a warp runs 32 / L items at once (F = 128 bf16: 2; C = 40
//    or 64: 4). Consecutive groups take consecutive items, so per-edge rows
//    stay coalesced across a warp, and groups never combine results;
//  * 16-byte loads where F and the pointers allow (8 bf16 or 4 f32 columns
//    a lane), so each row is read in whole 32-byte sectors; else one
//    column a lane;
//  * each lane keeps kStages gathered rows in flight through a ring in
//    shared memory filled by cp.async (a lone bf16 column, which no async
//    copy carries, by a plain load), so latency is hidden without holding
//    the rows in registers. Each lane reads back only what it copied, so
//    the ring needs no barrier. The copies go through L1 (.ca): rows that
//    neighbouring rows share, as on a banded or a halo block's graph, are
//    read from L2 once an SM (on the H100, .cg, past L1, took the
//    accumulating form 12% longer at F = 128 and was within 4% elsewhere:
//    scripts/csr_variants_probe.py).
//    The next edge's source index and weight are loaded one step ahead;
//  * sums in f32 registers in CSR edge order, stored once, rounded once.
// Tensor cores do not apply: the kernel does 2 flops per byte it reads.
//
// The accumulating form (kAcc, entry gammagl_spmm_csr_acc) computes
//
//   out[d, c] = prev[d, c]
//             + sum_{e in [rowptr[d], rowptr[d+1])} w[e] * x[col[e], c]
//
// and replaces the TPU kernel segment_matmul_dyn_packed
// (gammagl_tpu/ops/pallas/segment_matmul.py:897, with out_acc), which the
// JAX package's planned halo tiers (gammagl_tpu/parallel/halo_plan.py) run
// once per source block of a partition, folding each block's partial sum
// into the previous one. An item that owns its row reads prev[row] into
// its f32 accumulator before its edge loop, so a row with no edges in
// this block stores prev unchanged, bit for bit, and the sum is rounded
// once to T; a cut row's prev is read by the fold. prev may be out itself
// (in place): neither is restrict-qualified, and prev is read with plain
// loads, not through the read-only data cache, since the kernels write
// that memory. Each element of prev is read by the lane that then writes
// the same element of out, so the in-place form has no race. x may be a
// row slice of a larger table (a pointer offset into it). Its bound is
// spmm_csr's plus prev read once: bytes.

#include "csr_items.cuh"

namespace {

// Rows in flight per lane: 16 bytes each in shared memory, so a block of
// 256 lanes holds kStages * 4 KB (32 KB: seven blocks an SM). On the H100,
// 4 stages took the per-edge segment sum 20-35% longer and the accumulating
// form at F = 256 5% less (scripts/csr_variants_probe.py).
constexpr int kStages = 8;

// acc += weight * v, with the weight of column i w[e, head[i]] (kHeads) or
// wv for the whole row.
template <int V, bool kHeads>
__device__ __forceinline__ void add_row(float (&acc)[V], const float (&v)[V],
                                        float wv, const float* __restrict__ w,
                                        int64_t e, int64_t H,
                                        const int64_t (&head)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    acc[i] = fmaf(kHeads ? __ldg(w + e * H + head[i]) : wv, v[i], acc[i]);
}

// One group of L = 2^lg lanes per item. kPerEdge: row e of x is read for
// CSR edge e (col is not read); else row col[e]. kHeads: w is (E, H) and
// column c takes w[e, c / Fh]; else w is (E,) or null (every weight 1).
// kAcc: an item that owns its row starts from prev[row] (which may alias
// out), else from 0.
template <typename T, int V, bool kPerEdge, bool kHeads, bool kAcc>
__global__ void __launch_bounds__(kThreads)
    spmm_csr_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const int32_t* __restrict__ col, const T* prev, T* out,
                    Items items, int lg, int64_t F, int64_t H) {
  __shared__ uint4 ring[kStages][kThreads];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> lg;
  if (item >= items.n) return;  // no lane waits on another
  const int64_t L = int64_t{1} << lg;
  const int64_t lane = t & (L - 1);
  const Item it = item_at(items, item);
  const int64_t Fh = F / H;
  auto source = [&](int64_t e) -> int64_t {
    if constexpr (kPerEdge) return e;
    return static_cast<int64_t>(__ldg(col + e));
  };
  auto weight = [&](int64_t e) -> float {
    return (kHeads || w == nullptr) ? 1.f : __ldg(w + e);
  };

  for (int64_t c = lane * V; c < F; c += L * V) {
    int64_t head[V];
#pragma unroll
    for (int i = 0; i < V; ++i) head[i] = kHeads ? (c + i) / Fh : 0;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    if (kAcc && it.slot < 0)
      load_vec<T, V, false>(prev + it.row * F + c, acc);
    walk_edges<T, V, kStages>(
        ring, x + c, F, it.lo, it.n, true, source, weight,
        [&](int64_t j, float wv, const T* staged) {
          float v[V];
          load_vec<T, V, false>(staged, v);
          add_row<V, kHeads>(acc, v, wv, w, it.lo + j, H, head);
        });
    if (it.slot < 0)
      store_vec<T, V>(out + it.row * F + c, acc);
    else
      store_f32<V>(items.part + it.slot * items.stride + c, acc);
  }
}

// The fold of spmm_csr_kernel's cut rows: out[row] = prev[row] (kAcc, else
// 0) plus each slot in turn, in f32, rounded once.
template <typename T, int V, bool kAcc>
struct SumFold {
  const T* prev;
  T* out;
  int64_t F;
  __device__ void start(int64_t row, int64_t c, float (&acc)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    if (kAcc) load_vec<T, V, false>(prev + row * F + c, acc);
  }
  __device__ void add(float (&acc)[V], const float (&a)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += a[k];
  }
  __device__ void finish(int64_t row, int64_t c, int64_t, int64_t,
                         const float (&acc)[V]) const {
    store_vec<T, V>(out + row * F + c, acc);
  }
};

// 16-byte rows where F and every row pointer allow them, else one column
// a lane.
template <typename T, bool kPerEdge, bool kHeads, bool kAcc>
void launch(const void* x, const float* w, const int32_t* col,
            const void* prev, void* out, Items items, int64_t F, int64_t H,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const void* ptrs[] = {x, out, prev};
  const bool vec = pick_vec<T>(F, ptrs, kAcc ? 3 : 2) == kVec;
  const T* xt = static_cast<const T*>(x);
  const T* pt = static_cast<const T*>(prev);
  T* ot = static_cast<T*>(out);
  const int lg = lanes_log2(F, vec ? kVec : 1);
  const dim3 grid = grid_of(items.n, lg);
  if (vec)
    spmm_csr_kernel<T, kVec, kPerEdge, kHeads, kAcc>
        <<<grid, kThreads, 0, stream>>>(xt, w, col, pt, ot, items, lg, F, H);
  else
    spmm_csr_kernel<T, 1, kPerEdge, kHeads, kAcc>
        <<<grid, kThreads, 0, stream>>>(xt, w, col, pt, ot, items, lg, F, H);
}

template <typename T>
void launch_mode(const void* x, const float* w, const int32_t* col,
                 void* out, Items items, int64_t F, int64_t H, int per_edge,
                 cudaStream_t stream) {
  const bool heads = w != nullptr && H > 1;
  if (per_edge && heads)
    launch<T, true, true, false>(x, w, col, nullptr, out, items, F, H,
                                 stream);
  else if (per_edge)
    launch<T, true, false, false>(x, w, col, nullptr, out, items, F, H,
                                  stream);
  else if (heads)
    launch<T, false, true, false>(x, w, col, nullptr, out, items, F, H,
                                  stream);
  else
    launch<T, false, false, false>(x, w, col, nullptr, out, items, F, H,
                                   stream);
}

template <typename T, int V, bool kAcc>
void fold_with(const float* part, const int32_t* cut_row,
               const int64_t* cut_ptr, const T* prev, T* out, int64_t n_cut,
               int lg, int64_t F, int64_t stride, cudaStream_t stream) {
  csr_fold_kernel<V>
      <<<grid_of(n_cut, lg), kThreads, 0, stream>>>(
          part, cut_row, cut_ptr, n_cut, lg, F, stride,
          SumFold<T, V, kAcc>{prev, out, F});
}

template <typename T>
void launch_fold(const float* part, const int32_t* cut_row,
                 const int64_t* cut_ptr, const void* prev, void* out,
                 int64_t n_cut, int64_t F, int64_t stride,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const void* ptrs[] = {out, prev};
  const bool vec = pick_vec<T>(F, ptrs, 2) == kVec;
  const T* pt = static_cast<const T*>(prev);
  T* ot = static_cast<T*>(out);
  const int lg = lanes_log2(F, vec ? kVec : 1);
  if (vec && prev)
    fold_with<T, kVec, true>(part, cut_row, cut_ptr, pt, ot, n_cut, lg, F,
                             stride, stream);
  else if (vec)
    fold_with<T, kVec, false>(part, cut_row, cut_ptr, pt, ot, n_cut, lg, F,
                              stride, stream);
  else if (prev)
    fold_with<T, 1, true>(part, cut_row, cut_ptr, pt, ot, n_cut, lg, F,
                          stride, stream);
  else
    fold_with<T, 1, false>(part, cut_row, cut_ptr, pt, ot, n_cut, lg, F,
                           stride, stream);
}

}  // namespace

extern "C" {

// x: (rows, F) bf16 (x_is_bf16 != 0) or f32, contiguous, whose rows are
// read at col[e] (per_edge == 0: node rows) or at e (per_edge != 0: one row
// per CSR edge; col may then be null); w: f32 in CSR order, (E,) for H == 1
// or (E, H) with F % H == 0, or null for unit weights; col: (E,) int32;
// out: (n_dst, F) of x's type.
// The items: item_ptr (n_items + 1,) int64 edge offsets; item_meta
// (n_items, 2) int32 {row, slot} with slot -1 for an item that owns its
// row, or null, and then item i is row i and item_ptr is the plan's rowptr
// (n_items = n_dst); part: f32 scratch of (slots, part_stride), written
// for the items of cut rows (null when no item has a slot), part_stride a
// multiple of 4 that is >= F. A cut row is written by gammagl_csr_fold,
// launched after this on the same stream.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// does not synchronise.
int gammagl_spmm_csr(const void* x, const void* w, const void* item_ptr,
                     const void* item_meta, int64_t n_items, const void* col,
                     void* part, int64_t part_stride, void* out, int64_t F,
                     int64_t H, int per_edge, int x_is_bf16, void* stream) {
  Items items;
  if (F < 0 || H < 1 || (F > 0 && F % H != 0) ||
      !make_items(item_ptr, item_meta, n_items, part, part_stride, F, &items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch_mode<__nv_bfloat16>(x, wf, cl, out, items, F, H, per_edge, s);
    else
      launch_mode<float>(x, wf, cl, out, items, F, H, per_edge, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The accumulating form: out = prev + A x over node rows (col gathered),
// x, the items, part and out as gammagl_spmm_csr's; prev (n_dst, F) of
// x's type, contiguous, may be out itself. w: (E,) f32 in CSR order or
// null. Launches on `stream` and returns cudaGetLastError(); does not
// synchronise.
int gammagl_spmm_csr_acc(const void* x, const void* w, const void* item_ptr,
                         const void* item_meta, int64_t n_items,
                         const void* col, void* part, int64_t part_stride,
                         const void* prev, void* out, int64_t F,
                         int x_is_bf16, void* stream) {
  Items items;
  if (F < 0 || prev == nullptr ||
      !make_items(item_ptr, item_meta, n_items, part, part_stride, F, &items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch<__nv_bfloat16, false, false, true>(x, wf, cl, prev, out, items,
                                                F, 1, s);
    else
      launch<float, false, false, true>(x, wf, cl, prev, out, items, F, 1,
                                        s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fold of cut rows after gammagl_spmm_csr(_acc): part (slots,
// part_stride) f32 as that launch wrote it; cut_row (n_cut,) int32 the
// rows; cut_ptr (n_cut + 1,) int64, cut row i owning slots [cut_ptr[i],
// cut_ptr[i + 1]) in item order; prev null (the sum starts from 0) or as
// gammagl_spmm_csr_acc's; out (n_dst, F) of x's type. Launches on `stream`
// and returns cudaGetLastError(); does not synchronise.
int gammagl_csr_fold(const void* part, int64_t part_stride,
                     const void* cut_row, const void* cut_ptr, int64_t n_cut,
                     const void* prev, void* out, int64_t F, int x_is_bf16,
                     void* stream) {
  if (!fold_ok(part, part_stride, n_cut, F))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cut > 0 && F > 0) {
    const float* pf = static_cast<const float*>(part);
    const int32_t* cr = static_cast<const int32_t*>(cut_row);
    const int64_t* cp = static_cast<const int64_t*>(cut_ptr);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch_fold<__nv_bfloat16>(pf, cr, cp, prev, out, n_cut, F,
                                 part_stride, s);
    else
      launch_fold<float>(pf, cr, cp, prev, out, n_cut, F, part_stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gammagl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
