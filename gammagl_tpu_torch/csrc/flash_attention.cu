// Fused GAT edge attention for Hopper (sm_90a), forward and backward, with a
// plain C interface loaded by ctypes.
//
// Forward, per destination row d and head h, over the edges e of row d in the
// destination-sorted CSR (rowptr, col):
//   s_e   = leaky_relu(score[e, h] + a_dst[d, h], slope)
//   m     = max_e s_e,   l = sum_e exp(s_e - m)
//   out   = sum_e exp(s_e - m) * keep[e, h] * msg[e, h, :] / max(l, 1e-16)
// and (m, l) are saved for the backward. Backward, with g = dL/dout:
//   alpha_e = exp(min(s_e - m, 0)) / max(l, 1e-16)
//   c       = <out[d, h], g[d, h]>
//   dalpha  = keep[e, h] * <g[d, h], msg[e, h]>
//   ds[e,h] = alpha_e * (dalpha - c) * leaky_relu'(s_e before the leak)
//   da_dst  = sum_e ds[e, h]
//   dmsg[e, h, :] = alpha_e * keep[e, h] * g[d, h, :]
// A row without edges gives out = 0, m = -1e30, l = 0 and da_dst = 0.
//
// Replaces the TPU kernels of gammagl_tpu/ops/pallas/flash_attention.py:
// _flash_forward_mh (:566, _flash_kernel) and _flash_backward_mh (:704,
// _flash_bwd_kernel). Those build a dense (R, ET) score tile per block of
// destination rows, pick rows with one-hot matmuls and carry (m, l) across
// grid steps in VMEM; here each warp owns one destination row and walks its
// CSR edges, so no one-hot, no padded lanes and no atomics: the results are
// deterministic. The score and message rows are read either per edge in CSR
// order (gather = 0) or from node rows at col[e] (gather = 1), so GAT's
// source features are gathered inside the kernel and no (E, H*F) message
// tensor is built in the forward.
//
// What bounds it on the card: bytes. Every edge reads one row of H*F
// message elements and H scores (and the backward writes a row of dmsg), for
// a few flops per element. The design:
//  * lanes lie across the H*F columns of a row, V columns a lane (V up to
//    16 bytes), with the lanes of one head in an aligned group of L lanes
//    (L a power of two), so per-head dot products reduce with L-lane xor
//    shuffles. GAT's narrow heads (H=8, F=8, bf16) fill all 32 lanes with
//    4-byte loads; a head wider than L*V columns loops over column chunks;
//  * the score of (e, h) is a scalar, so every lane of a head runs the online
//    softmax recurrence itself and no lane waits on another in the forward;
//  * the online softmax takes one exp an edge: exp(-|s - m|) is either the
//    rescale of the running sums (a new max) or the edge's weight;
//  * the warp reads 32 col indices with one coalesced load and hands them out
//    by shuffle; the forward loads kUnroll message rows before it uses
//    them, so several gathers are in flight for each warp. The backward
//    loads kBwdUnroll edges at a time: with kUnroll it needs more
//    registers, fewer warps fit on an SM, and it measured slower;
//  * sums are f32 in CSR edge order, rounded once when stored.
// Load balancing for skewed degrees and keeping g in registers across the
// backward's two passes are left for later.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;     // edges whose loads the forward issues at once
constexpr int kBwdUnroll = 2;  // the same for the backward
constexpr float kNeg = -1e30f;  // the row max before any edge

// The row of keep that CSR edge e reads is keep_row[e] (kKeepRow), else e
// itself. Each lane loads the entry of one of the warp's next 32 edges
// (`mine`, valid when `ok`), and `keep_row_at` hands edge j's out by
// shuffle. Without keep_row both compile to nothing.
template <bool kKeepRow>
__device__ __forceinline__ int64_t keep_row_mine(
    const int64_t* __restrict__ keep_row, int64_t e, bool ok) {
  if constexpr (kKeepRow) return ok ? __ldg(keep_row + e) : 0;
  return 0;
}

template <bool kKeepRow>
__device__ __forceinline__ int64_t keep_row_at(int64_t mine, int j,
                                               int64_t e) {
  if constexpr (kKeepRow) return __shfl_sync(kFullMask, mine, j);
  return e;
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// One warp per destination row.
template <typename T, int V, bool kKeepRow>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    flash_fwd_kernel(const T* __restrict__ msg,
                     const float* __restrict__ score,
                     const float* __restrict__ a_dst,
                     const float* __restrict__ keep,
                     const int64_t* __restrict__ keep_row,
                     const int64_t* __restrict__ rowptr,
                     const int32_t* __restrict__ col, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int64_t n_dst, Layout g, float slope, int gather) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  const int64_t HF = g.H * g.F;

  for (int pass = 0; pass < g.passes; ++pass) {
    for (int k = 0; k < g.K; ++k) {
      const Lane ln = lane_at<V>(g, lane, pass, k);
      const int64_t h = ln.head ? ln.h : 0;
      const float a = a_dst != nullptr ? a_dst[row * g.H + h] : 0.f;
      float m = kNeg, l = 0.f, acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;

      for (int64_t base = begin; base < end; base += kWarp) {
        const int64_t left = end - base;
        const int n = left < kWarp ? static_cast<int>(left) : kWarp;
        const int my_col = lane < n ? __ldg(col + base + lane) : 0;
        const int64_t my_krow =
            keep_row_mine<kKeepRow>(keep_row, base + lane, lane < n);
        for (int j = 0; j < n; j += kUnroll) {
          float v[kUnroll][V], s[kUnroll], kp[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int src = __shfl_sync(kFullMask, my_col,
                                        j + u < n ? j + u : 0);
            const int64_t e = base + j + u;
            const int64_t krow =
                keep_row_at<kKeepRow>(my_krow, j + u < n ? j + u : 0, e);
            const int64_t r = gather ? static_cast<int64_t>(src) : e;
            s[u] = kNeg;
            kp[u] = 1.f;
            if (ln.head && j + u < n) {
              s[u] = leaky(__ldg(score + r * g.H + h) + a, slope);
              if (keep != nullptr) kp[u] = __ldg(keep + krow * g.H + h);
              if (ln.cols) load_vec<T, V>(msg + r * HF + h * g.F + ln.cin, v[u]);
            }
          }
          if (ln.head) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (j + u < n) {
                // one exp an edge: exp(-|s - m|) is the rescale of the old
                // sums when s is the new max, else the edge's weight
                const float d = s[u] - m;
                const float t = expf(-fabsf(d));
                const bool up = d > 0.f;
                const float scale = up ? t : 1.f;
                const float p = up ? 1.f : t;
                l = fmaf(l, scale, p);
                const float pk = p * kp[u];
                if (ln.cols) {
#pragma unroll
                  for (int i = 0; i < V; ++i)
                    acc[i] = fmaf(pk, v[u][i], acc[i] * scale);
                }
                m = up ? s[u] : m;
              }
            }
          }
        }
      }
      if (ln.cols) {
        const float inv = 1.f / fmaxf(l, 1e-16f);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] *= inv;
        store_vec<T, V>(out + row * HF + h * g.F + ln.cin, acc);
      }
      if (k == 0 && ln.leader) {
        m_out[row * g.H + h] = m;
        l_out[row * g.H + h] = l;
      }
    }
  }
}

// One warp per destination row; writes ds and dmsg for the row's edges (in
// CSR order) and da_dst for the row.
template <typename T, int V, bool kKeepRow>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    flash_bwd_kernel(const T* __restrict__ msg,
                     const float* __restrict__ score,
                     const float* __restrict__ a_dst,
                     const float* __restrict__ keep,
                     const int64_t* __restrict__ keep_row,
                     const int64_t* __restrict__ rowptr,
                     const int32_t* __restrict__ col,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const T* __restrict__ out, const T* __restrict__ grad,
                     float* __restrict__ ds_out, float* __restrict__ da_out,
                     T* __restrict__ dmsg, int64_t n_dst, Layout g,
                     float slope, int gather) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  const int64_t HF = g.H * g.F;
  const T* g_row = grad + row * HF;

  for (int pass = 0; pass < g.passes; ++pass) {
    const Lane l0 = lane_at<V>(g, lane, pass, 0);
    const int64_t h = l0.head ? l0.h : 0;
    // c = <out[d, h], g[d, h]>
    float part = 0.f;
    for (int k = 0; k < g.K; ++k) {
      const Lane ln = lane_at<V>(g, lane, pass, k);
      if (ln.cols) {
        float o[V], gv[V];
        load_vec<T, V>(out + row * HF + h * g.F + ln.cin, o);
        load_vec<T, V>(g_row + h * g.F + ln.cin, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) part = fmaf(o[i], gv[i], part);
      }
    }
    const float c = group_sum(part, g.L);
    const float m = m_in[row * g.H + h];
    const float inv_l = 1.f / fmaxf(l_in[row * g.H + h], 1e-16f);
    const float a = a_dst != nullptr ? a_dst[row * g.H + h] : 0.f;
    float da = 0.f;

    for (int64_t base = begin; base < end; base += kWarp) {
      const int64_t left = end - base;
      const int n = left < kWarp ? static_cast<int>(left) : kWarp;
      const int my_col = lane < n ? __ldg(col + base + lane) : 0;
      const int64_t my_krow =
          keep_row_mine<kKeepRow>(keep_row, base + lane, lane < n);
      for (int j = 0; j < n; j += kBwdUnroll) {
        // lanes past the row's last edge compute on zeros and store nothing
        int64_t r[kBwdUnroll];
        float s_pre[kBwdUnroll], kp[kBwdUnroll], part_u[kBwdUnroll];
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          const int jj = j + u < n ? j + u : 0;
          const int src = __shfl_sync(kFullMask, my_col, jj);
          const int64_t e = base + j + u;
          const int64_t krow = keep_row_at<kKeepRow>(my_krow, jj, e);
          r[u] = gather ? static_cast<int64_t>(src) : e;
          s_pre[u] = 0.f;
          kp[u] = 1.f;
          part_u[u] = 0.f;
          if (l0.head && j + u < n) {
            s_pre[u] = __ldg(score + r[u] * g.H + h) + a;
            if (keep != nullptr) kp[u] = __ldg(keep + krow * g.H + h);
          }
        }
        for (int k = 0; k < g.K; ++k) {
          const Lane ln = lane_at<V>(g, lane, pass, k);
          if (ln.cols) {
            float gv[V], mv[kBwdUnroll][V];
            load_vec<T, V>(g_row + h * g.F + ln.cin, gv);
#pragma unroll
            for (int u = 0; u < kBwdUnroll; ++u)
              if (j + u < n)
                load_vec<T, V>(msg + r[u] * HF + h * g.F + ln.cin, mv[u]);
#pragma unroll
            for (int u = 0; u < kBwdUnroll; ++u)
              if (j + u < n) {
#pragma unroll
                for (int i = 0; i < V; ++i)
                  part_u[u] = fmaf(gv[i], mv[u][i], part_u[u]);
              }
          }
        }
        float aw[kBwdUnroll];
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          const float dalpha = group_sum(part_u[u], g.L) * kp[u];
          const float alpha =
              expf(fminf(leaky(s_pre[u], slope) - m, 0.f)) * inv_l;
          const float ds =
              alpha * (dalpha - c) * (s_pre[u] >= 0.f ? 1.f : slope);
          aw[u] = alpha * kp[u];
          if (j + u < n) {
            if (l0.leader) ds_out[(base + j + u) * g.H + h] = ds;
            da += ds;
          }
        }
        for (int k = 0; k < g.K; ++k) {
          const Lane ln = lane_at<V>(g, lane, pass, k);
          if (ln.cols) {
            float gv[V];
            load_vec<T, V>(g_row + h * g.F + ln.cin, gv);
#pragma unroll
            for (int u = 0; u < kBwdUnroll; ++u)
              if (j + u < n) {
                float d[V];
#pragma unroll
                for (int i = 0; i < V; ++i) d[i] = aw[u] * gv[i];
                store_vec<T, V>(dmsg + (base + j + u) * HF + h * g.F + ln.cin,
                                d);
              }
          }
        }
      }
    }
    if (l0.leader) da_out[row * g.H + h] = da;
  }
}

template <typename T>
void launch_fwd(const void* msg, const float* score, const float* a_dst,
                const float* keep, const int64_t* keep_row,
                const int64_t* rowptr, const int32_t* col, void* out,
                float* m, float* l, int64_t n_dst, int64_t H,
                int64_t F, float slope, int gather, cudaStream_t stream) {
  const void* ptrs[] = {msg, out};
  Layout g;
  const int V = pick_layout<T>(H, F, ptrs, 2, &g);
  const dim3 block(kWarp * kWarpsPerBlock);
  const T* mt = static_cast<const T*>(msg);
  T* ot = static_cast<T*>(out);
#define GAMMAGL_FWD(VV)                                                    \
  if (keep_row != nullptr)                                                 \
    flash_fwd_kernel<T, VV, true><<<grid_for(n_dst), block, 0, stream>>>(  \
        mt, score, a_dst, keep, keep_row, rowptr, col, ot, m, l, n_dst, g, \
        slope, gather);                                                    \
  else                                                                     \
    flash_fwd_kernel<T, VV, false><<<grid_for(n_dst), block, 0, stream>>>( \
        mt, score, a_dst, keep, keep_row, rowptr, col, ot, m, l, n_dst, g, \
        slope, gather)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_FWD(8); } break;
    case 4: GAMMAGL_FWD(4); break;
    case 2: GAMMAGL_FWD(2); break;
    default: GAMMAGL_FWD(1); break;
  }
#undef GAMMAGL_FWD
}

template <typename T>
void launch_bwd(const void* msg, const float* score, const float* a_dst,
                const float* keep, const int64_t* keep_row,
                const int64_t* rowptr, const int32_t* col,
                const float* m, const float* l, const void* out,
                const void* grad, float* ds, float* da, void* dmsg,
                int64_t n_dst, int64_t H, int64_t F, float slope, int gather,
                cudaStream_t stream) {
  const void* ptrs[] = {msg, out, grad, dmsg};
  Layout g;
  const int V = pick_layout<T>(H, F, ptrs, 4, &g);
  const dim3 block(kWarp * kWarpsPerBlock);
  const T* mt = static_cast<const T*>(msg);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(grad);
  T* dt = static_cast<T*>(dmsg);
#define GAMMAGL_BWD(VV)                                                    \
  if (keep_row != nullptr)                                                 \
    flash_bwd_kernel<T, VV, true><<<grid_for(n_dst), block, 0, stream>>>(  \
        mt, score, a_dst, keep, keep_row, rowptr, col, m, l, ot, gt, ds,   \
        da, dt, n_dst, g, slope, gather);                                  \
  else                                                                     \
    flash_bwd_kernel<T, VV, false><<<grid_for(n_dst), block, 0, stream>>>( \
        mt, score, a_dst, keep, keep_row, rowptr, col, m, l, ot, gt, ds,   \
        da, dt, n_dst, g, slope, gather)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_BWD(8); } break;
    case 4: GAMMAGL_BWD(4); break;
    case 2: GAMMAGL_BWD(2); break;
    default: GAMMAGL_BWD(1); break;
  }
#undef GAMMAGL_BWD
}

bool bad_sizes(int64_t n_dst, int64_t H, int64_t F) {
  return n_dst < 0 || H < 1 || F < 1 || grid_too_large(n_dst);
}

}  // namespace

extern "C" {

// msg: (rows, H*F) bf16 (is_bf16 != 0) or f32, contiguous, where rows are
// node rows read at col[e] (gather != 0) or edges in CSR order (gather ==
// 0); score: (rows, H) f32 read the same way; a_dst: (n_dst, H) f32 or
// null for 0; keep: (E, H) f32 or null for 1, whose row for CSR edge e is
// keep_row[e] ((E,) int64, e.g. the plan's perm for a mask in the caller's
// edge order) or e when keep_row is null; rowptr:
// (n_dst + 1,) int64; col: (E,) int32; out: (n_dst, H*F) of msg's type;
// m, l: (n_dst, H) f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int gammagl_flash_attention_fwd(const void* msg, const void* score,
                                const void* a_dst, const void* keep,
                                const void* keep_row, const void* rowptr,
                                const void* col,
                                void* out, void* m, void* l, int64_t n_dst,
                                int64_t H, int64_t F, float slope,
                                int gather, int is_bf16, void* stream) {
  if (bad_sizes(n_dst, H, F)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0) {
    const float* sc = static_cast<const float*>(score);
    const float* ad = static_cast<const float*>(a_dst);
    const float* kp = static_cast<const float*>(keep);
    const int64_t* kr = static_cast<const int64_t*>(keep_row);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* mf = static_cast<float*>(m);
    float* lf = static_cast<float*>(l);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_fwd<__nv_bfloat16>(msg, sc, ad, kp, kr, rp, cl, out, mf, lf,
                                n_dst, H, F, slope, gather, s);
    else
      launch_fwd<float>(msg, sc, ad, kp, kr, rp, cl, out, mf, lf, n_dst, H,
                        F, slope, gather, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus m, l: the forward's statistics; out: the forward's
// output and grad: dL/dout, both (n_dst, H*F) of msg's type. Writes ds:
// (E, H) f32 and dmsg: (E, H*F) of msg's type, both in CSR order, and da:
// (n_dst, H) f32.
int gammagl_flash_attention_bwd(const void* msg, const void* score,
                                const void* a_dst, const void* keep,
                                const void* keep_row, const void* rowptr,
                                const void* col,
                                const void* m, const void* l, const void* out,
                                const void* grad, void* ds, void* da,
                                void* dmsg, int64_t n_dst, int64_t H,
                                int64_t F, float slope, int gather,
                                int is_bf16, void* stream) {
  if (bad_sizes(n_dst, H, F)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0) {
    const float* sc = static_cast<const float*>(score);
    const float* ad = static_cast<const float*>(a_dst);
    const float* kp = static_cast<const float*>(keep);
    const int64_t* kr = static_cast<const int64_t*>(keep_row);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    const float* mf = static_cast<const float*>(m);
    const float* lf = static_cast<const float*>(l);
    float* dsf = static_cast<float*>(ds);
    float* daf = static_cast<float*>(da);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_bwd<__nv_bfloat16>(msg, sc, ad, kp, kr, rp, cl, mf, lf, out,
                                grad, dsf, daf, dmsg, n_dst, H, F, slope,
                                gather, s);
    else
      launch_bwd<float>(msg, sc, ad, kp, kr, rp, cl, mf, lf, out, grad, dsf,
                        daf, dmsg, n_dst, H, F, slope, gather, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
