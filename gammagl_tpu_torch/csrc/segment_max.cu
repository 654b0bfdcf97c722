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
// a segment sum over the same plan). Here one warp owns a destination row
// and compares in registers, so the exactness needs no chunked transport,
// and the tie count is a register per column.
//
// What bounds it on the card: bytes. Each edge reads one row of F elements
// (a random source row, or the next row in CSR order) and does one compare
// per element. The design is the SpMM kernel's walk (csrc/spmm_csr.cu) with
// max in place of +: one warp per destination row, 16-byte loads where F
// and the pointers allow, kUnroll rows in flight, the warp's next 32 (col,
// w) pairs read with one coalesced load and handed out by shuffle, no
// atomics. The backward walks each row's edges twice (count, then write):
// the messages are recomputed rather than stored.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// f32 v rounded to T and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  return __uint_as_float(bf16_bits(v) << 16);
}

// The message of one edge: row `r` of x at columns [c, c + V), times the
// weight wv (already rounded to T) when kWeighted, rounded to T.
template <typename T, int V, bool kWeighted>
__device__ __forceinline__ void load_msg(const T* __restrict__ x, int64_t r,
                                         int64_t F, int64_t c, float wv,
                                         float (&raw)[V], float (&v)[V]) {
  load_vec<T, V>(x + r * F + c, raw);
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = kWeighted ? round_to<T>(raw[i] * wv) : raw[i];
}

// The warp's next n <= 32 edges from `base`: each lane loads the source and
// the weight of one of them, handed out by shuffle.
template <bool kPerEdge, bool kWeighted>
__device__ __forceinline__ void load_edges(const int32_t* __restrict__ col,
                                           const float* __restrict__ w,
                                           int64_t base, int n, int lane,
                                           int& my_col, float& my_w) {
  my_col = 0;
  my_w = 1.f;
  if (lane < n) {
    if constexpr (!kPerEdge) my_col = __ldg(col + base + lane);
    if constexpr (kWeighted) my_w = __ldg(w + base + lane);
  }
}

template <typename T, bool kPerEdge, bool kWeighted>
__device__ __forceinline__ void edge_at(int my_col, float my_w, int j,
                                        int64_t e, int64_t& r, float& wv) {
  const int src = __shfl_sync(kFullMask, my_col, j);
  const float wj = __shfl_sync(kFullMask, my_w, j);
  r = kPerEdge ? e : static_cast<int64_t>(src);
  wv = kWeighted ? round_to<T>(wj) : 1.f;
}

// One warp per destination row. kNegate: the max of the negated messages,
// negated (the min).
template <typename T, int V, bool kPerEdge, bool kWeighted, bool kNegate>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    segment_max_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const int64_t* __restrict__ rowptr,
                       const int32_t* __restrict__ col, T* __restrict__ out,
                       int64_t n_dst, int64_t F) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  const float sign = kNegate ? -1.f : 1.f;

  // Every lane runs every chunk, so the shuffles below see the full warp.
  for (int64_t chunk = 0; chunk < F; chunk += kWarp * V) {
    const int64_t c = chunk + static_cast<int64_t>(lane) * V;
    const bool active = c < F;  // V divides F whenever V > 1
    float m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = neg_inf();

    for (int64_t base = begin; base < end; base += kWarp) {
      const int64_t left = end - base;
      const int n = left < kWarp ? static_cast<int>(left) : kWarp;
      int my_col;
      float my_w;
      load_edges<kPerEdge, kWeighted>(col, w, base, n, lane, my_col, my_w);
      for (int j = 0; j < n; j += kUnroll) {
        float v[kUnroll][V], raw[V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          int64_t r;
          float wv;
          edge_at<T, kPerEdge, kWeighted>(my_col, my_w,
                                          j + u < n ? j + u : 0,
                                          base + j + u, r, wv);
          if (active && j + u < n)
            load_msg<T, V, kWeighted>(x, r, F, c, wv, raw, v[u]);
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (j + u < n) {
#pragma unroll
              for (int i = 0; i < V; ++i) {
                const float s = sign * v[u][i];
                m[i] = s > m[i] ? s : m[i];
              }
            }
          }
        }
      }
    }
    if (active) {
      // m is still -inf in a row without edges and where every message is
      // -inf (+inf for the min): both give 0, as the JAX kernel's `where`
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = m[i] == neg_inf() ? 0.f : sign * m[i];
      store_vec<T, V>(out + row * F + c, o);
    }
  }
}

// One warp per destination row: the tie counts of each column over the
// row's edges, then dmsg (and dw) for each edge.
template <typename T, int V, bool kPerEdge, bool kWeighted, bool kDw>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    segment_max_bwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ w,
                           const int64_t* __restrict__ rowptr,
                           const int32_t* __restrict__ col,
                           const T* __restrict__ out,
                           const T* __restrict__ grad, T* __restrict__ dmsg,
                           float* __restrict__ dw, int64_t n_dst, int64_t F) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  if (begin == end) return;

  for (int64_t chunk = 0; chunk < F; chunk += kWarp * V) {
    const int64_t c = chunk + static_cast<int64_t>(lane) * V;
    const bool active = c < F;
    float o[V], gv[V], cnt[V];
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = gv[i] = cnt[i] = 0.f;
    if (active) {
      load_vec<T, V>(out + row * F + c, o);
      load_vec<T, V>(grad + row * F + c, gv);
    }
    // pass 1: how many edges win each column
    for (int64_t base = begin; base < end; base += kWarp) {
      const int64_t left = end - base;
      const int n = left < kWarp ? static_cast<int>(left) : kWarp;
      int my_col;
      float my_w;
      load_edges<kPerEdge, kWeighted>(col, w, base, n, lane, my_col, my_w);
      for (int j = 0; j < n; j += kUnroll) {
        float v[kUnroll][V], raw[V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          int64_t r;
          float wv;
          edge_at<T, kPerEdge, kWeighted>(my_col, my_w,
                                          j + u < n ? j + u : 0,
                                          base + j + u, r, wv);
          if (active && j + u < n)
            load_msg<T, V, kWeighted>(x, r, F, c, wv, raw, v[u]);
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (j + u < n) {
#pragma unroll
              for (int i = 0; i < V; ++i)
                cnt[i] += v[u][i] == o[i] ? 1.f : 0.f;
            }
        }
      }
    }
    float share[V];
#pragma unroll
    for (int i = 0; i < V; ++i) share[i] = gv[i] / fmaxf(cnt[i], 1.f);
    // pass 2: each edge's cotangent, and its weight's
    for (int64_t base = begin; base < end; base += kWarp) {
      const int64_t left = end - base;
      const int n = left < kWarp ? static_cast<int>(left) : kWarp;
      int my_col;
      float my_w;
      load_edges<kPerEdge, kWeighted>(col, w, base, n, lane, my_col, my_w);
      for (int j = 0; j < n; ++j) {
        int64_t r;
        float wv;
        const int64_t e = base + j;
        edge_at<T, kPerEdge, kWeighted>(my_col, my_w, j, e, r, wv);
        float part = 0.f;
        if (active) {
          float raw[V], v[V], d[V];
          load_msg<T, V, kWeighted>(x, r, F, c, wv, raw, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            d[i] = v[i] == o[i] ? round_to<T>(share[i]) : 0.f;
            part = fmaf(d[i], raw[i], part);
          }
          store_vec<T, V>(dmsg + e * F + c, d);
        }
        if constexpr (kDw) {
          part = group_sum(part, kWarp);
          if (lane == 0) dw[e] = (chunk == 0 ? 0.f : dw[e]) + part;
        }
      }
    }
  }
}

template <typename T, bool kPerEdge, bool kWeighted>
void launch_fwd(const void* x, const float* w, const int64_t* rowptr,
                const int32_t* col, void* out, int64_t n_dst, int64_t F,
                int negate, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarp * kWarpsPerBlock);
  const void* ptrs[] = {x, out};
  const bool vec = pick_vec<T>(F, ptrs, 2) == kVec;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
#define GAMMAGL_MAX(VV, NEG)                                                 \
  segment_max_kernel<T, VV, kPerEdge, kWeighted, NEG>                        \
      <<<grid_for(n_dst), block, 0, stream>>>(xt, w, rowptr, col, ot, n_dst, \
                                              F)
  if (vec && negate) GAMMAGL_MAX(kVec, true);
  else if (vec) GAMMAGL_MAX(kVec, false);
  else if (negate) GAMMAGL_MAX(1, true);
  else GAMMAGL_MAX(1, false);
#undef GAMMAGL_MAX
}

template <typename T, bool kPerEdge, bool kWeighted>
void launch_bwd(const void* x, const float* w, const int64_t* rowptr,
                const int32_t* col, const void* out, const void* grad,
                void* dmsg, float* dw, int64_t n_dst, int64_t F,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarp * kWarpsPerBlock);
  const void* ptrs[] = {x, out, grad, dmsg};
  const bool vec = pick_vec<T>(F, ptrs, 4) == kVec;
  const T* xt = static_cast<const T*>(x);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(grad);
  T* dt = static_cast<T*>(dmsg);
#define GAMMAGL_MAX_BWD(VV, DW)                                             \
  segment_max_bwd_kernel<T, VV, kPerEdge, kWeighted, DW>                    \
      <<<grid_for(n_dst), block, 0, stream>>>(xt, w, rowptr, col, ot, gt,   \
                                              dt, dw, n_dst, F)
  const bool want_dw = kWeighted && dw != nullptr;
  if (vec && want_dw) GAMMAGL_MAX_BWD(kVec, kWeighted);
  else if (vec) GAMMAGL_MAX_BWD(kVec, false);
  else if (want_dw) GAMMAGL_MAX_BWD(1, kWeighted);
  else GAMMAGL_MAX_BWD(1, false);
#undef GAMMAGL_MAX_BWD
}

template <typename T>
void fwd_mode(const void* x, const float* w, const int64_t* rowptr,
              const int32_t* col, void* out, int64_t n_dst, int64_t F,
              int per_edge, int negate, cudaStream_t s) {
  if (per_edge)
    launch_fwd<T, true, false>(x, w, rowptr, col, out, n_dst, F, negate, s);
  else if (w != nullptr)
    launch_fwd<T, false, true>(x, w, rowptr, col, out, n_dst, F, negate, s);
  else
    launch_fwd<T, false, false>(x, w, rowptr, col, out, n_dst, F, negate, s);
}

template <typename T>
void bwd_mode(const void* x, const float* w, const int64_t* rowptr,
              const int32_t* col, const void* out, const void* grad,
              void* dmsg, float* dw, int64_t n_dst, int64_t F, int per_edge,
              cudaStream_t s) {
  if (per_edge)
    launch_bwd<T, true, false>(x, w, rowptr, col, out, grad, dmsg, dw, n_dst,
                               F, s);
  else if (w != nullptr)
    launch_bwd<T, false, true>(x, w, rowptr, col, out, grad, dmsg, dw, n_dst,
                               F, s);
  else
    launch_bwd<T, false, false>(x, w, rowptr, col, out, grad, dmsg, dw,
                                n_dst, F, s);
}

bool bad_sizes(int64_t n_dst, int64_t F) {
  return n_dst < 0 || F < 0 || grid_too_large(n_dst);
}

}  // namespace

extern "C" {

// x: (rows, F) bf16 (x_is_bf16 != 0) or f32, contiguous, read at col[e]
// (per_edge == 0: node rows) or at e (per_edge != 0: one row per CSR edge;
// col may then be null and w must be null); w: (E,) f32 in CSR order or
// null for unit weights; rowptr: (n_dst + 1,) int64; col: (E,) int32; out:
// (n_dst, F) of x's type, the max (negate == 0) or the min (negate != 0).
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
int gammagl_segment_max_fwd(const void* x, const void* w, const void* rowptr,
                            const void* col, void* out, int64_t n_dst,
                            int64_t F, int per_edge, int negate,
                            int x_is_bf16, void* stream) {
  if (bad_sizes(n_dst, F) || (per_edge && w != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      fwd_mode<__nv_bfloat16>(x, wf, rp, cl, out, n_dst, F, per_edge,
                              negate, s);
    else
      fwd_mode<float>(x, wf, rp, cl, out, n_dst, F, per_edge, negate, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus out: its output and grad: dL/dout, both (n_dst, F)
// of x's type. Writes dmsg: (E, F) of x's type in CSR order and, when w and
// dw are not null, dw: (E,) f32 in CSR order. Rows without edges write
// nothing (they own no entries of dmsg or dw).
int gammagl_segment_max_bwd(const void* x, const void* w, const void* rowptr,
                            const void* col, const void* out,
                            const void* grad, void* dmsg, void* dw,
                            int64_t n_dst, int64_t F, int per_edge,
                            int x_is_bf16, void* stream) {
  if (bad_sizes(n_dst, F) || (per_edge && w != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* dwf = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      bwd_mode<__nv_bfloat16>(x, wf, rp, cl, out, grad, dmsg, dwf, n_dst, F,
                              per_edge, s);
    else
      bwd_mode<float>(x, wf, rp, cl, out, grad, dmsg, dwf, n_dst, F,
                      per_edge, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
