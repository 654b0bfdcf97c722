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
// What bounds it on the card: bytes. Every edge reads one row of x (F
// elements; a random source row for the SpMM, the next row in order for the
// segment sum) and does 2 flops per element read, far below the ridge point
// of the H100. At the ogbn-arxiv shape (2.48M edges with self-loops, F =
// 256, bf16) the SpMM gathers about 1.27 GB per call, against about 0.09 GB
// of output and 0.03 GB of CSR arrays.
//
// What this simple design does about it:
//  * one warp per destination row; its lanes cover the feature columns
//    with 16-byte loads where F and the pointers allow (8 bf16 or 4 f32
//    columns a lane), so each row is read in whole 32-byte sectors;
//    otherwise one column a lane with scalar loads;
//  * a loop over column chunks when F is wider than one warp pass;
//  * the warp reads 32 (col, w) pairs with one coalesced load and hands
//    them out by shuffle; per-head weights are read per column from L1;
//  * kUnroll rows are loaded before they are summed, so each warp keeps
//    several loads in flight;
//  * sums are kept in f32 registers in CSR edge order, and out is written
//    once, rounded once. No atomics: the result is deterministic.
// Row blocking, load balancing for skewed degrees, TMA, an L2-aware edge
// order and more lanes at work for narrow rows (F = 40 bf16 uses 5 of 32)
// are left for later.
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
// into the previous one. Each warp reads prev[row] into its f32 accumulator
// before its edge loop, so a row with no edges in this block stores prev
// unchanged, bit for bit, and the sum is rounded once to T. prev may be out
// itself (in place): neither is restrict-qualified, and prev is read with
// plain loads, not through the read-only data cache, since the kernel
// writes that memory. Each element of prev is read by the warp that then
// writes the same element of out, so the in-place form has no race. x may
// be a row slice of a larger table (a pointer offset into it). Its bound is
// spmm_csr's plus prev read once: bytes.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;

// The row of x that CSR edge e reads: e itself (kPerEdge), else col[e],
// handed out by shuffle from the lane that loaded it (`mine`).
template <bool kPerEdge>
__device__ __forceinline__ int64_t row_of(int mine, int j, int64_t e) {
  if constexpr (kPerEdge) return e;
  return static_cast<int64_t>(__shfl_sync(kFullMask, mine, j));
}

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

// One warp per destination row. kPerEdge: row e of x is read for CSR edge e
// (col is not read); else row col[e]. kHeads: w is (E, H) and column c takes
// w[e, c / Fh]; else w is (E,) or null (every weight 1). kAcc: the sum starts
// from prev[row] (which may alias out), else from 0.
template <typename T, int V, bool kPerEdge, bool kHeads, bool kAcc>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    spmm_csr_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const int64_t* __restrict__ rowptr,
                    const int32_t* __restrict__ col, const T* prev, T* out,
                    int64_t n_dst, int64_t F, int64_t H) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  const int64_t Fh = F / H;

  // Every lane runs every chunk, so the shuffles below see the full warp.
  for (int64_t chunk = 0; chunk < F; chunk += kWarp * V) {
    const int64_t c = chunk + static_cast<int64_t>(lane) * V;
    const bool active = c < F;  // V divides F whenever V > 1
    int64_t head[V];
#pragma unroll
    for (int i = 0; i < V; ++i) head[i] = kHeads ? (c + i) / Fh : 0;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    if (kAcc && active) load_vec<T, V, false>(prev + row * F + c, acc);

    for (int64_t base = begin; base < end; base += kWarp) {
      const int64_t left = end - base;
      const int n = left < kWarp ? static_cast<int>(left) : kWarp;
      int my_col = 0;
      float my_w = 1.f;
      if (lane < n) {
        if constexpr (!kPerEdge) my_col = __ldg(col + base + lane);
        if (!kHeads && w != nullptr) my_w = __ldg(w + base + lane);
      }
      int j = 0;
      for (; j + kUnroll <= n; j += kUnroll) {
        float v[kUnroll][V];
        float wj[kUnroll];
        int64_t r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          r[u] = row_of<kPerEdge>(my_col, j + u, base + j + u);
          wj[u] = __shfl_sync(kFullMask, my_w, j + u);
          if (active) load_vec<T, V>(x + r[u] * F + c, v[u]);
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            add_row<V, kHeads>(acc, v[u], wj[u], w, base + j + u, H, head);
        }
      }
      for (; j < n; ++j) {
        const int64_t r = row_of<kPerEdge>(my_col, j, base + j);
        const float wv = __shfl_sync(kFullMask, my_w, j);
        if (active) {
          float v[V];
          load_vec<T, V>(x + r * F + c, v);
          add_row<V, kHeads>(acc, v, wv, w, base + j, H, head);
        }
      }
    }
    if (active) store_vec<T, V>(out + row * F + c, acc);
  }
}

template <typename T, bool kPerEdge, bool kHeads, bool kAcc = false>
void launch(const void* x, const float* w, const int64_t* rowptr,
            const int32_t* col, const void* prev, void* out, int64_t n_dst,
            int64_t F, int64_t H, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarp * kWarpsPerBlock);
  const void* ptrs[] = {x, out, prev};
  const bool vec = pick_vec<T>(F, ptrs, kAcc ? 3 : 2) == kVec;
  const T* xt = static_cast<const T*>(x);
  const T* pt = static_cast<const T*>(prev);
  T* ot = static_cast<T*>(out);
  if (vec)
    spmm_csr_kernel<T, kVec, kPerEdge, kHeads, kAcc>
        <<<grid_for(n_dst), block, 0, stream>>>(xt, w, rowptr, col, pt, ot,
                                                n_dst, F, H);
  else
    spmm_csr_kernel<T, 1, kPerEdge, kHeads, kAcc>
        <<<grid_for(n_dst), block, 0, stream>>>(xt, w, rowptr, col, pt, ot,
                                                n_dst, F, H);
}

template <typename T>
void launch_mode(const void* x, const float* w, const int64_t* rowptr,
                 const int32_t* col, void* out, int64_t n_dst, int64_t F,
                 int64_t H, int per_edge, cudaStream_t stream) {
  const bool heads = w != nullptr && H > 1;
  if (per_edge && heads)
    launch<T, true, true>(x, w, rowptr, col, nullptr, out, n_dst, F, H,
                          stream);
  else if (per_edge)
    launch<T, true, false>(x, w, rowptr, col, nullptr, out, n_dst, F, H,
                           stream);
  else if (heads)
    launch<T, false, true>(x, w, rowptr, col, nullptr, out, n_dst, F, H,
                           stream);
  else
    launch<T, false, false>(x, w, rowptr, col, nullptr, out, n_dst, F, H,
                            stream);
}

}  // namespace

extern "C" {

// x: (rows, F) bf16 (x_is_bf16 != 0) or f32, contiguous, whose rows are
// read at col[e] (per_edge == 0: node rows) or at e (per_edge != 0: one row
// per CSR edge; col may then be null); w: f32 in CSR order, (E,) for H == 1
// or (E, H) with F % H == 0, or null for unit weights; rowptr: (n_dst + 1,)
// int64; col: (E,) int32; out: (n_dst, F) of x's type. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise.
int gammagl_spmm_csr(const void* x, const void* w, const void* rowptr,
                     const void* col, void* out, int64_t n_dst, int64_t F,
                     int64_t H, int per_edge, int x_is_bf16, void* stream) {
  if (n_dst < 0 || F < 0 || H < 1 || (F > 0 && F % H != 0) ||
      grid_too_large(n_dst))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch_mode<__nv_bfloat16>(x, wf, rp, cl, out, n_dst, F, H, per_edge,
                                 s);
    else
      launch_mode<float>(x, wf, rp, cl, out, n_dst, F, H, per_edge, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The accumulating form: out = prev + A x over node rows (col gathered),
// x, prev and out as gammagl_spmm_csr's x and out; prev (n_dst, F) of x's
// type, contiguous, may be out itself. w: (E,) f32 in CSR order or null.
// Launches on `stream` and returns cudaGetLastError(); does not
// synchronise.
int gammagl_spmm_csr_acc(const void* x, const void* w, const void* rowptr,
                         const void* col, const void* prev, void* out,
                         int64_t n_dst, int64_t F, int x_is_bf16,
                         void* stream) {
  if (n_dst < 0 || F < 0 || prev == nullptr || grid_too_large(n_dst))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch<__nv_bfloat16, false, false, true>(x, wf, rp, cl, prev, out,
                                                n_dst, F, 1, s);
    else
      launch<float, false, false, true>(x, wf, rp, cl, prev, out, n_dst, F,
                                        1, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gammagl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
