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
// a few flops per element. The forward:
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
//    them, so several gathers are in flight for each warp;
//  * sums are f32 in CSR edge order, rounded once when stored.
// Load balancing for skewed degrees is left for later.
//
// The backward is bound by bytes too: it writes a row of dmsg and H scalars
// of ds for every edge and reads a message row, its score and its keep.
// One warp still owns a destination row, but its lanes work in groups of
// L lanes, one edge a group (GAT's (8, 8) and (1, 40) rows in bf16 take 8
// lanes, so a warp works on 4 edges at once; HGT's (4, 64) takes 32):
//  * each lane loads V columns (16 bytes where F and the pointers allow)
//    of one head; a head takes Lh lanes (the power of two >= F / V), and
//    the per-head dot <g[d, h], msg[e, h]> is the lane's own sum where a
//    head fits one lane (bf16 (8, 8)), else a shuffle over the head's
//    lanes; a group takes L / Lh heads a pass;
//  * per row and pass, g[d] (the lane's columns), c = <out[d], g[d]> and
//    m, l, a_dst are loaded once and kept in registers;
//  * each lane keeps kBwdStages edges in flight through a ring in shared
//    memory filled by cp.async: its message columns, score and keep,
//    with the source row and keep row of the next edge to copy loaded a
//    step ahead;
//  * the groups of a warp take consecutive edges, so their ds and dmsg
//    stores are coalesced; each group sums its own partial da_dst per
//    head, and the partials are added in group order at the row's end, so
//    repeats are bitwise equal.
// Heads wider than 32 lanes of V columns take flash_bwd_wide_kernel: a
// warp per edge, the head's columns in chunks.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;     // edges whose loads the forward issues at once
constexpr int kThreads = kWarp * kWarpsPerBlock;
// Edges in flight per lane in the backward: 24 bytes each in shared memory
// (16 of message, the score and keep), 24 KB a block of 256 lanes.
constexpr int kBwdStages = 4;
// Blocks of the backward an SM must hold where a warp works on several
// edges at once (L < 32), which caps their registers at 80. Their rows are
// short, each with a load latency to hide, and more warps hide it; a warp
// that takes one edge at a time streams its ring without the cap
// (scripts/bp_flash_probe.py compares the caps on the card).
constexpr int kNarrowBlocks = 3;
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

// How the backward lays a warp's lanes over edges' rows of H heads of F
// columns.
struct BwdLayout {
  int64_t H, F;
  int Lh;      // lanes per head: a power of two, at most 32
  int L;       // lanes per edge: Lh times the heads of a pass
  int K;       // column chunks per head: > 1 only for heads wider than 32 V
  int passes;  // head passes
};

// V (the widest load F and the pointers allow) and the layout for it.
template <typename T>
int pick_bwd_layout(int64_t H, int64_t F, const void* const* ptrs,
                    int n_ptrs, BwdLayout* g) {
  const int V = pick_vec<T>(F, ptrs, n_ptrs);
  const int64_t per_head = F / V;
  int Lh = 1;
  while (Lh < kWarp && Lh < per_head) Lh *= 2;
  int heads = 1;
  while (heads * Lh < kWarp && heads < H) heads *= 2;
  g->H = H;
  g->F = F;
  g->Lh = Lh;
  g->L = heads * Lh;
  g->K = static_cast<int>((per_head + Lh - 1) / Lh);
  g->passes = static_cast<int>((H + heads - 1) / heads);
  return V;
}

// The arguments of both backward kernels.
#define GAMMAGL_BWD_PARAMS                                                 \
  const T *__restrict__ msg, const float *__restrict__ score,              \
      const float *__restrict__ a_dst, const float *__restrict__ keep,     \
      const int64_t *__restrict__ keep_row,                                \
      const int64_t *__restrict__ rowptr, const int32_t *__restrict__ col, \
      const float *__restrict__ m_in, const float *__restrict__ l_in,      \
      const T *__restrict__ out, const T *__restrict__ grad,               \
      float *__restrict__ ds_out, float *__restrict__ da_out,              \
      T *__restrict__ dmsg, int64_t n_dst, BwdLayout g, float slope,       \
      int gather
#define GAMMAGL_BWD_ARGS                                                   \
  msg, score, a_dst, keep, keep_row, rowptr, col, m_in, l_in, out, grad,   \
      ds_out, da_out, dmsg, n_dst, g, slope, gather

// One warp per destination row, one edge per group of g.L lanes (g.K ==
// 1); writes ds and dmsg for the row's edges (in CSR order) and da_dst for
// the row. The kernels below launch it with and without a register cap.
template <typename T, int V, bool kKeepRow>
__device__ __forceinline__ void flash_bwd_rows(GAMMAGL_BWD_PARAMS) {
  __shared__ uint4 ring[kBwdStages][kThreads];    // message columns
  __shared__ float2 ring_sk[kBwdStages][kThreads];  // score, keep
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int groups = kWarp / g.L;
  const int q = lane / g.L;           // the lane's group: edges q, q + groups..
  const int hl = lane % g.L / g.Lh;   // its head within the pass
  const int cl = lane % g.Lh;         // its place within the head
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  const int steps = static_cast<int>((end - begin + groups - 1) / groups);
  const int64_t HF = g.H * g.F;
  auto source = [&](int64_t e) -> int64_t {
    return gather ? static_cast<int64_t>(__ldg(col + e)) : e;
  };
  auto keep_at = [&](int64_t e) -> int64_t {
    if constexpr (kKeepRow) return __ldg(keep_row + e);
    return e;
  };

  for (int pass = 0; pass < g.passes; ++pass) {
    const int64_t h = static_cast<int64_t>(pass) * (g.L / g.Lh) + hl;
    const bool head = h < g.H;
    const bool cols = head && static_cast<int64_t>(cl) * V < g.F;
    const int64_t hh = head ? h : 0;
    const int64_t off = hh * g.F + cl * V;  // the lane's first column
    float gv[V], part = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) gv[i] = 0.f;
    if (cols) {
      float o[V];
      load_vec<T, V>(grad + row * HF + off, gv);
      load_vec<T, V>(out + row * HF + off, o);
#pragma unroll
      for (int i = 0; i < V; ++i) part = fmaf(o[i], gv[i], part);
    }
    const float c = group_sum(part, g.Lh);  // <out[d, h], g[d, h]>
    const float m = m_in[row * g.H + hh];
    const float inv_l = 1.f / fmaxf(l_in[row * g.H + hh], 1e-16f);
    const float a = a_dst != nullptr ? a_dst[row * g.H + hh] : 0.f;
    auto issue = [&](int slot, int64_t r, int64_t kr) {
      if (cols)
        stage_copy<T, V>(&ring[slot][threadIdx.x], msg + r * HF + off);
      stage_copy<float, 1>(&ring_sk[slot][threadIdx.x].x,
                           score + r * g.H + hh);
      if (keep != nullptr)
        stage_copy<float, 1>(&ring_sk[slot][threadIdx.x].y,
                             keep + kr * g.H + hh);
    };

    // the first kBwdStages edges: all their indices, then all their copies
    int64_t r0[kBwdStages + 1], k0[kBwdStages + 1];
#pragma unroll
    for (int s = 0; s <= kBwdStages; ++s) {
      const int64_t e = begin + q + static_cast<int64_t>(s) * groups;
      r0[s] = k0[s] = 0;
      if (head && e < end) {
        r0[s] = source(e);
        k0[s] = keep_at(e);
      }
    }
#pragma unroll
    for (int s = 0; s < kBwdStages; ++s) {
      if (head && begin + q + static_cast<int64_t>(s) * groups < end)
        issue(s, r0[s], k0[s]);
      commit_stage();
    }
    int64_t r_next = r0[kBwdStages], k_next = k0[kBwdStages];
    float da = 0.f;
    for (int j = 0; j < steps; ++j) {
      const int64_t e = begin + q + static_cast<int64_t>(j) * groups;
      const bool valid = head && e < end;
      wait_stages<kBwdStages - 1>();  // edge j has landed
      const int slot = j % kBwdStages;
      float v[V];
      load_vec<T, V, false>(
          reinterpret_cast<const T*>(&ring[slot][threadIdx.x]), v);
      const float2 sk = ring_sk[slot][threadIdx.x];
      float dot = 0.f;
      if (valid && cols) {
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(gv[i], v[i], dot);
      }
      dot = group_sum(dot, g.Lh);  // the same for every lane of the head
      const float kp = keep != nullptr && valid ? sk.y : 1.f;
      const float s_pre = (valid ? sk.x : 0.f) + a;
      const float alpha = expf(fminf(leaky(s_pre, slope) - m, 0.f)) * inv_l;
      const float ds = alpha * (dot * kp - c) * (s_pre >= 0.f ? 1.f : slope);
      if (valid) {
        if (cl == 0) ds_out[e * g.H + h] = ds;
        da += ds;
        if (cols) {
          float d[V];
#pragma unroll
          for (int i = 0; i < V; ++i) d[i] = alpha * kp * gv[i];
          store_vec<T, V>(dmsg + e * HF + off, d);
        }
      }
      // the slot's reads above leave the load/store unit before this lane's
      // next copy into it (as in spmm_csr.cu's ring)
      const int64_t en = e + static_cast<int64_t>(kBwdStages) * groups;
      if (head && en < end) {
        issue(slot, r_next, k_next);
        if (en + groups < end) {
          r_next = source(en + groups);
          k_next = keep_at(en + groups);
        }
      }
      commit_stage();
    }
    // the groups' partial sums, added in group order
    float total = 0.f;
    for (int g2 = 0; g2 < groups; ++g2)
      total += __shfl_sync(kFullMask, da, g2 * g.L + lane % g.L);
    if (q == 0 && cl == 0 && head) da_out[row * g.H + h] = total;
  }
}

// A warp an edge (g.L == 32).
template <typename T, int V, bool kKeepRow>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(GAMMAGL_BWD_PARAMS) {
  flash_bwd_rows<T, V, kKeepRow>(GAMMAGL_BWD_ARGS);
}

// Several edges a warp (g.L < 32): kNarrowBlocks blocks an SM.
template <typename T, int V, bool kKeepRow>
__global__ void __launch_bounds__(kThreads, kNarrowBlocks)
    flash_bwd_narrow_kernel(GAMMAGL_BWD_PARAMS) {
  flash_bwd_rows<T, V, kKeepRow>(GAMMAGL_BWD_ARGS);
}

// Heads wider than 32 lanes of V columns (g.L == g.Lh == 32, g.K > 1): one
// warp per destination row and one edge at a time, a head a pass, its
// columns in g.K chunks.
template <typename T, int V, bool kKeepRow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wide_kernel(const T* __restrict__ msg,
                          const float* __restrict__ score,
                          const float* __restrict__ a_dst,
                          const float* __restrict__ keep,
                          const int64_t* __restrict__ keep_row,
                          const int64_t* __restrict__ rowptr,
                          const int32_t* __restrict__ col,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const T* __restrict__ out,
                          const T* __restrict__ grad,
                          float* __restrict__ ds_out,
                          float* __restrict__ da_out, T* __restrict__ dmsg,
                          int64_t n_dst, BwdLayout g, float slope,
                          int gather) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  const int64_t HF = g.H * g.F;
  const T* g_row = grad + row * HF;
  for (int64_t h = 0; h < g.H; ++h) {
    float part = 0.f;
    for (int k = 0; k < g.K; ++k) {
      const int64_t cin = (static_cast<int64_t>(k) * kWarp + lane) * V;
      if (cin < g.F) {
        float o[V], gv[V];
        load_vec<T, V>(out + row * HF + h * g.F + cin, o);
        load_vec<T, V>(g_row + h * g.F + cin, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) part = fmaf(o[i], gv[i], part);
      }
    }
    const float c = group_sum(part, kWarp);
    const float m = m_in[row * g.H + h];
    const float inv_l = 1.f / fmaxf(l_in[row * g.H + h], 1e-16f);
    const float a = a_dst != nullptr ? a_dst[row * g.H + h] : 0.f;
    float da = 0.f;
    for (int64_t e = begin; e < end; ++e) {
      const int64_t r = gather ? static_cast<int64_t>(__ldg(col + e)) : e;
      int64_t kr = e;
      if constexpr (kKeepRow) kr = __ldg(keep_row + e);
      const float s_pre = __ldg(score + r * g.H + h) + a;
      const float kp = keep != nullptr ? __ldg(keep + kr * g.H + h) : 1.f;
      part = 0.f;
      for (int k = 0; k < g.K; ++k) {
        const int64_t cin = (static_cast<int64_t>(k) * kWarp + lane) * V;
        if (cin < g.F) {
          float mv[V], gv[V];
          load_vec<T, V>(msg + r * HF + h * g.F + cin, mv);
          load_vec<T, V>(g_row + h * g.F + cin, gv);
#pragma unroll
          for (int i = 0; i < V; ++i) part = fmaf(gv[i], mv[i], part);
        }
      }
      const float dot = group_sum(part, kWarp);
      const float alpha = expf(fminf(leaky(s_pre, slope) - m, 0.f)) * inv_l;
      const float ds = alpha * (dot * kp - c) * (s_pre >= 0.f ? 1.f : slope);
      if (lane == 0) ds_out[e * g.H + h] = ds;
      da += ds;
      for (int k = 0; k < g.K; ++k) {
        const int64_t cin = (static_cast<int64_t>(k) * kWarp + lane) * V;
        if (cin < g.F) {
          float gv[V], d[V];
          load_vec<T, V>(g_row + h * g.F + cin, gv);
#pragma unroll
          for (int i = 0; i < V; ++i) d[i] = alpha * kp * gv[i];
          store_vec<T, V>(dmsg + e * HF + h * g.F + cin, d);
        }
      }
    }
    if (lane == 0) da_out[row * g.H + h] = da;
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
  BwdLayout g;
  const int V = pick_bwd_layout<T>(H, F, ptrs, 4, &g);
  const T* mt = static_cast<const T*>(msg);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(grad);
  T* dt = static_cast<T*>(dmsg);
#define GAMMAGL_BWD(...)                                                  \
  __VA_ARGS__<<<grid_for(n_dst), kThreads, 0, stream>>>(                   \
      mt, score, a_dst, keep, keep_row, rowptr, col, m, l, ot, gt, ds, da, \
      dt, n_dst, g, slope, gather)
#define GAMMAGL_BWD_R(VV, KR)                                              \
  if (g.K > 1)                                                             \
    GAMMAGL_BWD(flash_bwd_wide_kernel<T, VV, KR>);                         \
  else if (g.L < kWarp)                                                    \
    GAMMAGL_BWD(flash_bwd_narrow_kernel<T, VV, KR>);                       \
  else                                                                     \
    GAMMAGL_BWD(flash_bwd_kernel<T, VV, KR>)
#define GAMMAGL_BWD_V(VV)                                                  \
  if (keep_row != nullptr) {                                               \
    GAMMAGL_BWD_R(VV, true);                                               \
  } else {                                                                 \
    GAMMAGL_BWD_R(VV, false);                                              \
  }
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_BWD_V(8); } break;
    case 4: GAMMAGL_BWD_V(4); break;
    case 2: GAMMAGL_BWD_V(2); break;
    default: GAMMAGL_BWD_V(1); break;
  }
#undef GAMMAGL_BWD_V
#undef GAMMAGL_BWD_R
#undef GAMMAGL_BWD
#undef GAMMAGL_BWD_ARGS
#undef GAMMAGL_BWD_PARAMS
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
