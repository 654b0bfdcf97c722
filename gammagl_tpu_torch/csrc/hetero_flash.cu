// HGT relation attention for Hopper (sm_90a), forward and backward, with a
// plain C interface loaded by ctypes.
//
// kv holds one row per source node, [k | v], each H heads of D columns; q
// one row per destination node (the relation prior and 1/sqrt(D) folded
// in). Forward, per destination row d and head h, over the CSR edges e of d
// with source s = col[e]:
//   s_e = <q[d, h], k[s, h]>
//   m   = max_e s_e,   l = sum_e exp(s_e - m)
//   out[d, h] = sum_e exp(s_e - m) * v[s, h] / max(l, 1e-16)
// and (m, l) are saved for the backward. Backward, with g = dL/dout:
//   alpha_e  = exp(min(s_e - m, 0)) / max(l, 1e-16)
//   c        = <out[d, h], g[d, h]>
//   ds_e     = alpha_e * (<g[d, h], v[s, h]> - c)
//   dq[d, h] = sum_e ds_e * k[s, h]
//   dk_e     = ds_e * q[d, h],   dv_e = alpha_e * g[d, h]
// with [dk_e | dv_e] written per CSR edge, (E, 2*H*D); the caller sums them
// into source rows with the SpMM kernel on the plan's edge-scatter
// transpose, so no atomics are needed. A row without edges gives out = 0,
// m = -1e30, l = 0 and dq = 0.
//
// Replaces the TPU kernels of gammagl_tpu/ops/pallas/hetero_flash.py:
// _hetero_fwd (:206, _fwd_kernel :92) and _hetero_bwd_kernelcall (:257,
// _bwd_kernel :138). Those compute the scores of a (dst block, edge tile)
// pair as dense (R, D) x (D, ET) matrix products on a half-packed k|v
// gather (bf16 pairs in f32 words) and carry (m, l) across grid steps; here
// one warp owns a destination row, keeps its q (and g) in registers, walks
// the row's CSR edges reading k|v rows at col[e] inside the kernel, and
// sums everything in f32. The TPU kernels round p and ds to bf16 before
// their products; these do not.
//
// What bounds it on the card: bytes. Each edge gathers one k|v row (2*H*D
// elements) for about 4*H*D flops forward (a dot and an axpy per head) and
// writes one dk|dv row backward. The design follows csrc/flash_attention.cu:
//  * the lanes lie across one head's D columns, V a lane (16-byte loads),
//    with the lanes of a head in an aligned group of L, so several heads
//    share a warp (H = 4, D = 64, bf16: 8 lanes a head, all four heads in
//    one pass) and the per-head dot reduces with L-lane xor shuffles, after
//    which every lane of the group holds the score;
//  * a head wider than L*V columns takes K chunks (K up to 4), kept in
//    registers, so the score is whole before the softmax update;
//  * the online softmax takes one exp an edge (flash_attention.cu);
//  * the forward keeps gathered k|v rows in flight without a break: each
//    lane copies its own columns of an edge's k and v rows (16 bytes each
//    at HGT's (4, 64) in bf16) into a ring in shared memory by cp.async,
//    kFwdStages<K> edges ahead (4 at K = 1), and loads the next source
//    index a step ahead, so the loads of later edges are in flight while
//    the score shuffles and the softmax of the current one run (the CSR
//    kernels' walk_ring, csrc/csr_items.cuh; a bf16 head of odd D, V = 1,
//    copies its 2-byte pieces by plain loads, which no async copy
//    carries). The sums are
//    those of a walk in CSR edge order, one exp an edge. A row is not
//    split over warps: the relation's in-degree tops out at a few hundred
//    edges;
//  * the backward walks a row's edges through the same ring, with the
//    forward's 4-warp blocks and lanes: per row and head pass, q, g,
//    c = <out, g>, m and 1/l are loaded once and kept in registers; each
//    edge's two dots reduce by the head's shuffles, dq sums in registers
//    in CSR order, and [dk | dv] is stored per CSR edge, V columns a lane
//    (16 bytes at HGT's (4, 64) bf16), coalesced across the warp, so the
//    results are those of a one-warp walk in CSR order, bit for bit.

#include "csr_items.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the row max before any edge

// Load K chunks of V columns of one head from row p (column chunk k at
// p + k * L * V); chunks past the head's end are zero.
template <typename T, int V, int K>
__device__ __forceinline__ void load_head(const T* __restrict__ p,
                                          const Layout& g, int lane, int pass,
                                          float (&f)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Lane ln = lane_at<V>(g, lane, pass, k);
    if (ln.cols) {
      load_vec<T, V>(p + ln.cin, f[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[k][i] = 0.f;
    }
  }
}

template <int V, int K>
__device__ __forceinline__ float dot_part(const float (&a)[K][V],
                                          const float (&b)[K][V]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s = fmaf(a[k][i], b[k][i], s);
  return s;
}

// The forward's blocks: kFwdWarps rows, each lane with a ring of
// kFwdStages<K> edges in shared memory, 2 * K 16-byte slots an edge (its
// k and v column chunks): 16 KB a block at K = 1 and 2, 32 KB at K = 4.
// On the H100 at HGT's (4, 64) bf16, 4 edges a lane took 0.645 ms, 8
// edges 0.716 and 2 edges 0.661 (scripts/max_hgt_probe.py, in turns).
// Registers are capped so that kFwdBlocks<K> blocks fit on an SM.
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kWarp * kFwdWarps;
template <int K>
constexpr int kFwdStages = K == 1 ? 4 : 2;
template <int K>
constexpr int kFwdBlocks = K == 1 ? 6 : K == 2 ? 4 : 2;

// One lane's K column chunks of head pass `pass` in the k and v rows of kv,
// staged through a ring of 2 * K 16-byte slots an edge: copy issues the
// copies of a source's k|v row into stage s, load reads piece 0 (k) or K
// (v) of stage s back, zeros past the head's end.
template <typename T, int V, int K>
struct HeadStage {
  uint4 (*ring)[2 * K][kFwdThreads];
  const T* kv;
  int64_t HD, off;  // the row width; the head's first column
  bool cols[K];
  int64_t cin[K];

  __device__ HeadStage(uint4 (*ring_)[2 * K][kFwdThreads], const T* kv_,
                       const Layout& g, int lane, int pass, int64_t off_)
      : ring(ring_), kv(kv_), HD(g.H * g.F), off(off_) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Lane ln = lane_at<V>(g, lane, pass, k);
      cols[k] = ln.cols;
      cin[k] = ln.cin;
    }
  }
  __device__ void copy(int s, int64_t src) const {
    const T* r = kv + src * 2 * HD + off;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (cols[k]) {
        stage_copy<T, V>(&ring[s][k][threadIdx.x], r + cin[k]);
        stage_copy<T, V>(&ring[s][K + k][threadIdx.x], r + HD + cin[k]);
      }
    }
  }
  __device__ void load(int s, int piece, float (&f)[K][V]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (cols[k]) {
        load_vec<T, V, false>(
            reinterpret_cast<const T*>(&ring[s][piece + k][threadIdx.x]),
            f[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[k][i] = 0.f;
      }
    }
  }
};

// A CSR edge's source row.
struct SourceOf {
  const int32_t* col;
  __device__ int64_t operator()(int64_t e) const {
    return static_cast<int64_t>(__ldg(col + e));
  }
};

// One warp per destination row, its edges walked through walk_ring: each
// lane copies its own columns of an edge's k and v rows into its stage.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks<K>)
    hgt_fwd_kernel(const T* __restrict__ kv, const T* __restrict__ q,
                   const int64_t* __restrict__ rowptr,
                   const int32_t* __restrict__ col, T* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int64_t n_dst, Layout g) {
  constexpr int kStages = kFwdStages<K>;
  __shared__ uint4 ring[kStages][2 * K][kFwdThreads];
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kFwdWarps + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int64_t begin = rowptr[row];
  const int64_t n = rowptr[row + 1] - begin;
  const int64_t HD = g.H * g.F;

  for (int pass = 0; pass < g.passes; ++pass) {
    const Lane l0 = lane_at<V>(g, lane, pass, 0);
    const int64_t h = l0.head ? l0.h : 0;
    const int64_t off = h * g.F;  // the head's first column
    const HeadStage<T, V, K> st(ring, kv, g, lane, pass, off);
    float qv[K][V], acc[K][V];
    load_head<T, V, K>(q + row * HD + off, g, lane, pass, qv);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    float m = kNeg, l = 0.f;

    walk_ring<kStages>(
        begin, n, SourceOf{col}, [](int64_t) { return 1.f; },
        [&](int s, int64_t src) { st.copy(s, src); },
        [&](int64_t, float, int s) {
          float kk[K][V];
          st.load(s, 0, kk);
          // every lane takes part in the shuffles; lanes past the heads
          // change nothing
          const float sc =
              group_sum(l0.head ? dot_part<V, K>(qv, kk) : 0.f, g.L);
          if (!l0.head) return;
          float vv[K][V];
          st.load(s, K, vv);
          // one exp an edge: exp(-|s - m|) is the rescale of the old sums
          // when s is the new max, else the edge's weight
          const float d = sc - m;
          const float t = expf(-fabsf(d));
          const bool up = d > 0.f;
          const float scale = up ? t : 1.f;
          const float p = up ? 1.f : t;
          l = fmaf(l, scale, p);
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[k][i] = fmaf(p, vv[k][i], acc[k][i] * scale);
          m = up ? sc : m;
        });
    const float inv = 1.f / fmaxf(l, 1e-16f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (st.cols[k]) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = acc[k][i] * inv;
        store_vec<T, V>(out + row * HD + off + st.cin[k], o);
      }
    }
    if (l0.leader) {
      m_out[row * g.H + h] = m;
      l_out[row * g.H + h] = l;
    }
  }
}

// The backward's blocks: the forward's 4 warps, each lane with a ring of
// kBwdStages<K> edges (2 * K 16-byte slots an edge, as the forward's), and
// registers capped so that kBwdBlocks<K> blocks fit on an SM: a lane holds
// q, g and dq (3 K V floats) besides the staged k and v. On the H100 at
// HGT's (4, 64) bf16 every ring of 2 to 8 edges and every cap from 4
// blocks to none took 1.43-1.45 ms, near the bytes the call moves
// (scripts/max_hgt_probe.py, in turns).
template <int K>
constexpr int kBwdStages = K == 1 ? 4 : 2;
template <int K>
constexpr int kBwdBlocks = K == 1 ? 5 : K == 2 ? 3 : 2;

// One warp per destination row, its edges walked through walk_ring; writes
// dq for the row and dk|dv for each of its edges (in CSR order).
template <typename T, int V, int K>
__global__ void __launch_bounds__(kFwdThreads, kBwdBlocks<K>)
    hgt_bwd_kernel(const T* __restrict__ kv, const T* __restrict__ q,
                   const int64_t* __restrict__ rowptr,
                   const int32_t* __restrict__ col, const T* __restrict__ out,
                   const T* __restrict__ grad, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, T* __restrict__ dq,
                   T* __restrict__ dkv, int64_t n_dst, Layout g) {
  constexpr int kStages = kBwdStages<K>;
  __shared__ uint4 ring[kStages][2 * K][kFwdThreads];
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kFwdWarps + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int64_t begin = rowptr[row];
  const int64_t n = rowptr[row + 1] - begin;
  const int64_t HD = g.H * g.F;

  for (int pass = 0; pass < g.passes; ++pass) {
    const Lane l0 = lane_at<V>(g, lane, pass, 0);
    const int64_t h = l0.head ? l0.h : 0;
    const int64_t off = h * g.F;
    const HeadStage<T, V, K> st(ring, kv, g, lane, pass, off);
    float qv[K][V], gv[K][V], dqa[K][V];
    load_head<T, V, K>(q + row * HD + off, g, lane, pass, qv);
    load_head<T, V, K>(grad + row * HD + off, g, lane, pass, gv);
    load_head<T, V, K>(out + row * HD + off, g, lane, pass, dqa);
    // c = <out[d, h], g[d, h]>; dqa held out[d, h] until here
    const float c = group_sum(dot_part<V, K>(dqa, gv), g.L);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) dqa[k][i] = 0.f;
    const float m = m_in[row * g.H + h];
    const float inv_l = 1.f / fmaxf(l_in[row * g.H + h], 1e-16f);
    T* de_row = dkv + begin * 2 * HD + off;  // the row's first dk|dv

    walk_ring<kStages>(
        begin, n, SourceOf{col}, [](int64_t) { return 1.f; },
        [&](int s, int64_t src) { st.copy(s, src); },
        [&](int64_t j, float, int s) {
          float kk[K][V], vv[K][V];
          st.load(s, 0, kk);
          st.load(s, K, vv);
          // every lane takes part in the shuffles; lanes past the heads
          // store nothing
          const float sc = group_sum(dot_part<V, K>(qv, kk), g.L);
          const float dalpha = group_sum(dot_part<V, K>(gv, vv), g.L);
          if (!l0.head) return;
          const float alpha = expf(fminf(sc - m, 0.f)) * inv_l;
          const float ds = alpha * (dalpha - c);
          T* de = de_row + j * 2 * HD;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float dk[V], dv[V];
#pragma unroll
            for (int i = 0; i < V; ++i) {
              dqa[k][i] = fmaf(ds, kk[k][i], dqa[k][i]);
              dk[i] = ds * qv[k][i];
              dv[i] = alpha * gv[k][i];
            }
            if (st.cols[k]) {
              store_vec<T, V>(de + st.cin[k], dk);
              store_vec<T, V>(de + HD + st.cin[k], dv);
            }
          }
        });
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (st.cols[k])
        store_vec<T, V>(dq + row * HD + off + st.cin[k], dqa[k]);
  }
}

// The lane layout for heads of D columns, with every row pointer aligned;
// returns V, and K rounded up to 1, 2 or 4, or 0 when a head needs more
// than 4 column chunks.
template <typename T>
int layout_for(int64_t H, int64_t D, const void* const* ptrs, int n_ptrs,
               Layout* g, int* K) {
  const int V = pick_layout<T>(H, D, ptrs, n_ptrs, g);
  *K = g->K <= 1 ? 1 : g->K <= 2 ? 2 : g->K <= 4 ? 4 : 0;
  return V;
}

// V = 8 exists for bf16 only (16-byte loads of 8 elements).
#define GAMMAGL_HGT_DISPATCH(LAUNCH)                                   \
  switch (V * 8 + K) {                                                 \
    case 8 * 8 + 1:                                                    \
      if constexpr (16 / sizeof(T) >= 8) { LAUNCH(8, 1); }             \
      break;                                                           \
    case 8 * 8 + 2:                                                    \
      if constexpr (16 / sizeof(T) >= 8) { LAUNCH(8, 2); }             \
      break;                                                           \
    case 8 * 8 + 4:                                                    \
      if constexpr (16 / sizeof(T) >= 8) { LAUNCH(8, 4); }             \
      break;                                                           \
    case 4 * 8 + 1: LAUNCH(4, 1); break;                               \
    case 4 * 8 + 2: LAUNCH(4, 2); break;                               \
    case 4 * 8 + 4: LAUNCH(4, 4); break;                               \
    case 2 * 8 + 1: LAUNCH(2, 1); break;                               \
    case 2 * 8 + 2: LAUNCH(2, 2); break;                               \
    case 2 * 8 + 4: LAUNCH(2, 4); break;                               \
    case 1 * 8 + 1: LAUNCH(1, 1); break;                               \
    case 1 * 8 + 2: LAUNCH(1, 2); break;                               \
    case 1 * 8 + 4: LAUNCH(1, 4); break;                               \
    default: return static_cast<int>(cudaErrorInvalidValue);           \
  }

template <typename T>
int launch_fwd(const void* kv, const void* q, const int64_t* rowptr,
               const int32_t* col, void* out, float* m, float* l,
               int64_t n_dst, int64_t H, int64_t D, cudaStream_t stream) {
  const void* ptrs[] = {kv, q, out};
  Layout g;
  int K;
  const int V = layout_for<T>(H, D, ptrs, 3, &g, &K);
  const T* kt = static_cast<const T*>(kv);
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  const dim3 grid(
      static_cast<unsigned>((n_dst + kFwdWarps - 1) / kFwdWarps));
#define GAMMAGL_HGT_FWD(VV, KK)                                          \
  hgt_fwd_kernel<T, VV, KK><<<grid, kFwdThreads, 0, stream>>>(           \
      kt, qt, rowptr, col, ot, m, l, n_dst, g)
  GAMMAGL_HGT_DISPATCH(GAMMAGL_HGT_FWD)
#undef GAMMAGL_HGT_FWD
  return 0;
}

template <typename T>
int launch_bwd(const void* kv, const void* q, const int64_t* rowptr,
               const int32_t* col, const void* out, const void* grad,
               const float* m, const float* l, void* dq, void* dkv,
               int64_t n_dst, int64_t H, int64_t D, cudaStream_t stream) {
  const void* ptrs[] = {kv, q, out, grad, dq, dkv};
  Layout g;
  int K;
  const int V = layout_for<T>(H, D, ptrs, 6, &g, &K);
  const dim3 grid(
      static_cast<unsigned>((n_dst + kFwdWarps - 1) / kFwdWarps));
  const T* kt = static_cast<const T*>(kv);
  const T* qt = static_cast<const T*>(q);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(grad);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dkv);
#define GAMMAGL_HGT_BWD(VV, KK)                                          \
  hgt_bwd_kernel<T, VV, KK><<<grid, kFwdThreads, 0, stream>>>(          \
      kt, qt, rowptr, col, ot, gt, m, l, dqt, dkt, n_dst, g)
  GAMMAGL_HGT_DISPATCH(GAMMAGL_HGT_BWD)
#undef GAMMAGL_HGT_BWD
  return 0;
}

#undef GAMMAGL_HGT_DISPATCH

bool bad_sizes(int64_t n_dst, int64_t H, int64_t D) {
  return n_dst < 0 || H < 1 || D < 1 || grid_too_large(n_dst) ||
         (n_dst + kFwdWarps - 1) / kFwdWarps > 0x7fffffff;
}

}  // namespace

extern "C" {

// kv: (rows, 2*H*D) bf16 (is_bf16 != 0) or f32, contiguous, [k | v] per
// source row, read at col[e]; q: (n_dst, H*D) of kv's type; rowptr:
// (n_dst + 1,) int64; col: (E,) int32; out: (n_dst, H*D) of kv's type; m,
// l: (n_dst, H) f32. Launches on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a head wider than four column
// chunks of 32 lanes; does not synchronise.
int gammagl_hgt_fwd(const void* kv, const void* q, const void* rowptr,
                    const void* col, void* out, void* m, void* l,
                    int64_t n_dst, int64_t H, int64_t D, int is_bf16,
                    void* stream) {
  if (bad_sizes(n_dst, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0) {
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* mf = static_cast<float*>(m);
    float* lf = static_cast<float*>(l);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int code =
        is_bf16 ? launch_fwd<__nv_bfloat16>(kv, q, rp, cl, out, mf, lf,
                                            n_dst, H, D, s)
                : launch_fwd<float>(kv, q, rp, cl, out, mf, lf, n_dst, H, D,
                                    s);
    if (code != 0) return code;
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus out: its output; grad: dL/dout, (n_dst, H*D) of kv's
// type; m, l: its statistics. Writes dq: (n_dst, H*D) and dkv: (E, 2*H*D),
// [dk | dv] per CSR edge, both of kv's type.
int gammagl_hgt_bwd(const void* kv, const void* q, const void* rowptr,
                    const void* col, const void* out, const void* grad,
                    const void* m, const void* l, void* dq, void* dkv,
                    int64_t n_dst, int64_t H, int64_t D, int is_bf16,
                    void* stream) {
  if (bad_sizes(n_dst, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0) {
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    const float* mf = static_cast<const float*>(m);
    const float* lf = static_cast<const float*>(l);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int code =
        is_bf16 ? launch_bwd<__nv_bfloat16>(kv, q, rp, cl, out, grad, mf, lf,
                                            dq, dkv, n_dst, H, D, s)
                : launch_bwd<float>(kv, q, rp, cl, out, grad, mf, lf, dq,
                                    dkv, n_dst, H, D, s);
    if (code != 0) return code;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
