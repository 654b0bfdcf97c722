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
// grid steps in VMEM; here lanes walk a destination row's CSR edges in
// order (the forward's lane groups an item of them, the backward's warps a
// row), so no one-hot, no padded lanes and no atomics: the results are
// deterministic. The score and message rows are read either per edge in CSR
// order (gather = 0) or from node rows at col[e] (gather = 1), so GAT's
// source features are gathered inside the kernel and no (E, H*F) message
// tensor is built in the forward.
//
// What bounds it on the card: bytes, and the latency of reaching them.
// Every edge reads one row of H*F message elements, H scores and H keeps
// (and the backward writes a row of dmsg), for a few flops per element.
// The forward runs on the CSR kernels' schedule (csrc/csr_items.cuh, as
// csrc/spmm_csr.cu):
//  * work items of at most ROW_SPLIT consecutive CSR edges, so a hub row
//    is spread over many lane groups. An item that owns its row writes
//    out, m and l; an item of a cut row writes its f32 partial (acc of
//    H*F columns, then m and l of each head) into its scratch slot, and
//    flash_fwd_fold_kernel merges each cut row's partials in item order
//    by the walk's own recurrence: m = max_i m_i, l and acc the items'
//    sums each rescaled by exp(m_i - m), out = acc / max(l, 1e-16). An
//    empty partial is m = -1e30, l = 0. A plan without cut rows passes no
//    item table;
//  * lane groups sized by the row: a lane holds V columns of one head (16
//    bytes where F and the pointers allow), an item takes L lanes, the
//    power of two >= H*F / V (at most 32, with a loop over column chunks
//    above 32 V), so GAT's (8, 8) and (1, 40) in bf16 take 8 lanes, 4
//    items a warp, and HGT's (4, 64) takes 32. The score of (e, h) is a
//    scalar, so every lane runs the online softmax recurrence of its head
//    in its own registers and no lane waits on another;
//  * each lane walks its item's edges through a cp.async ring of
//    kFwdStages edges (walk_ring): its message columns, the edge's score
//    and keep (4-byte copies); the next edge's col and keep_row are read a
//    step ahead, so the chain col / keep_row -> row never stalls a step;
//  * the online softmax takes one exp an edge: exp(-|s - m|) is either the
//    rescale of the running sums (a new max) or the edge's weight;
//  * sums are f32 in CSR edge order, rounded once when stored, so a row
//    that is not cut gives the bits of a one-warp walk of the row.
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

#include "csr_items.cuh"

namespace {

// Edges in flight per lane in the forward: 24 bytes each in shared memory
// (16 of message, the score and keep), 24 KB a block of 256 lanes. On the
// H100 (bf16, the arxiv-shape graph, scripts/bp_flash_probe.py in turns)
// 8 edges, 2 edges and loading col and keep_row 2 or 4 edges ahead were
// all slower at (8, 8) and (1, 40).
constexpr int kFwdStages = 4;
// Blocks of the forward an SM must hold, which caps its registers at 85.
// Capped at 64 registers (4 blocks), ptxas kept 0.29 ms at (8, 8) where 85
// took 0.25; 128 or no cap took the same as 85 (same probe, in turns).
constexpr int kFwdBlocks = 3;
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

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// CSR edge e's row of msg and score (col[e] with gathered rows, else e)
// and its row of keep (keep_row[e], else e).
struct EdgeRows {
  int64_t r, k;
};

// One group of L = 2^lg lanes per item, V columns of one head a lane.
// kGather: rows of msg and score at col[e], else e; kKeepRow: keep's row
// at keep_row[e], else e.
template <typename T, int V, bool kGather, bool kKeepRow>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
    flash_fwd_kernel(const T* __restrict__ msg,
                     const float* __restrict__ score,
                     const float* __restrict__ a_dst,
                     const float* __restrict__ keep,
                     const int64_t* __restrict__ keep_row,
                     const int32_t* __restrict__ col, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     Items items, int lg, int64_t H, int64_t F,
                     float slope) {
  __shared__ uint4 ring[kFwdStages][kThreads];      // message columns
  __shared__ float2 ring_sk[kFwdStages][kThreads];  // score, keep
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> lg;
  if (item >= items.n) return;  // no lane waits on another
  const int64_t L = int64_t{1} << lg;
  const Item it = item_at(items, item);
  const int64_t HF = H * F;
  auto rows = [&](int64_t e) {
    EdgeRows r;
    r.r = kGather ? static_cast<int64_t>(__ldg(col + e)) : e;
    r.k = e;
    if constexpr (kKeepRow) r.k = __ldg(keep_row + e);
    return r;
  };

  for (int64_t c = (t & (L - 1)) * V; c < HF; c += L * V) {
    // V divides F: the lane's columns are head h's (32-bit division: a
    // 64-bit one is a call, which spilled)
    const int h = static_cast<int>(c) / static_cast<int>(F);
    const float a = a_dst != nullptr ? a_dst[it.row * H + h] : 0.f;
    float m = kNeg, l = 0.f, acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    walk_ring<kFwdStages>(
        it.lo, it.n, rows, [](int64_t) { return 1.f; },
        [&](int s, EdgeRows r) {
          stage_copy<T, V>(&ring[s][threadIdx.x], msg + r.r * HF + c);
          stage_copy<float, 1>(&ring_sk[s][threadIdx.x].x,
                               score + r.r * H + h);
          if (keep != nullptr)
            stage_copy<float, 1>(&ring_sk[s][threadIdx.x].y,
                                 keep + r.k * H + h);
        },
        [&](int64_t, float, int s) {
          float v[V];
          load_vec<T, V, false>(
              reinterpret_cast<const T*>(&ring[s][threadIdx.x]), v);
          const float2 sk = ring_sk[s][threadIdx.x];
          const float sc = leaky(sk.x + a, slope);
          const float kp = keep != nullptr ? sk.y : 1.f;
          // one exp an edge: exp(-|s - m|) is the rescale of the old sums
          // when s is the new max, else the edge's weight
          const float d = sc - m;
          const float e = expf(-fabsf(d));
          const bool up = d > 0.f;
          const float scale = up ? e : 1.f;
          const float p = up ? 1.f : e;
          l = fmaf(l, scale, p);
          const float pk = p * kp;
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(pk, v[i], acc[i] * scale);
          m = up ? sc : m;
        });
    // the lane with the head's first column writes its m and l
    const bool first = c == static_cast<int64_t>(h) * F;
    if (it.slot < 0) {
      const float inv = 1.f / fmaxf(l, 1e-16f);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] *= inv;
      store_vec<T, V>(out + it.row * HF + c, acc);
      if (first) {
        m_out[it.row * H + h] = m;
        l_out[it.row * H + h] = l;
      }
    } else {  // the partial: acc, then m and l of each head
      float* part = items.part + it.slot * items.stride;
      store_f32<V>(part + c, acc);
      if (first) {
        part[HF + h] = m;
        part[HF + H + h] = l;
      }
    }
  }
}

// One step of the fold: the running (m, l, acc) takes an item's partial
// (mi, li, ai) as the forward's walk takes an edge, with one exp:
// exp(-|mi - m|) is the rescale of the running sums when mi is the new
// maximum, else the partial's weight.
template <int V>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[V],
                                      float mi, float li,
                                      const float (&ai)[V]) {
  const float d = mi - m;
  const float e = expf(-fabsf(d));
  const bool up = d > 0.f;
  const float scale = up ? e : 1.f;
  const float w = up ? 1.f : e;
  l = fmaf(l, scale, li * w);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaf(w, ai[i], acc[i] * scale);
  m = up ? mi : m;
}

// The forward's fold of cut rows: cut row i (row cut_row[i]) owns slots
// [cut_ptr[i], cut_ptr[i + 1]) in item order, each holding an item's
// partial (acc of H*F columns, then m and l of each head). Per head, the
// partials are merged in item order by the forward's recurrence (`merge`):
// m = max_i m_i, and l and acc are the items' sums each rescaled by
// exp(m_i - m); out = acc / max(l, 1e-16), rounded once. kUnroll slots'
// loads are issued before their merges. Groups of 2^lg lanes as in the
// forward.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fold_kernel(const float* __restrict__ part,
                          const int32_t* __restrict__ cut_row,
                          const int64_t* __restrict__ cut_ptr, int64_t n_cut,
                          int lg, int64_t H, int64_t F, int64_t stride,
                          T* __restrict__ out, float* __restrict__ m_out,
                          float* __restrict__ l_out) {
  constexpr int kUnroll = 8;  // slots in flight: a hub row has hundreds
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = t >> lg;
  if (i >= n_cut) return;
  const int64_t L = int64_t{1} << lg;
  const int64_t row = __ldg(cut_row + i);
  const int64_t s0 = __ldg(cut_ptr + i), s1 = __ldg(cut_ptr + i + 1);
  const int64_t HF = H * F;
  for (int64_t c = (t & (L - 1)) * V; c < HF; c += L * V) {
    const int h = static_cast<int>(c) / static_cast<int>(F);
    const float* pm = part + HF + h;  // slot s's m of head h: pm[s * stride]
    const float* pl = pm + H;         // and its l
    float m = kNeg, l = 0.f, acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    int64_t s = s0;
    for (; s + kUnroll <= s1; s += kUnroll) {
      float mi[kUnroll], li[kUnroll], ai[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        mi[u] = __ldg(pm + (s + u) * stride);
        li[u] = __ldg(pl + (s + u) * stride);
        load_f32<V>(part + (s + u) * stride + c, ai[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) merge<V>(m, l, acc, mi[u], li[u], ai[u]);
    }
    for (; s < s1; ++s) {
      float ai[V];
      load_f32<V>(part + s * stride + c, ai);
      merge<V>(m, l, acc, __ldg(pm + s * stride), __ldg(pl + s * stride), ai);
    }
    const float inv = 1.f / fmaxf(l, 1e-16f);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] *= inv;
    store_vec<T, V>(out + row * HF + c, acc);
    if (c == static_cast<int64_t>(h) * F) {
      m_out[row * H + h] = m;
      l_out[row * H + h] = l;
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

// V: 16 bytes where F and the pointers allow (F = 8, 40, 64 or 640 bf16:
// 8 columns), else the widest that divides F; L lanes an item.
template <typename T>
void launch_fwd(const void* msg, const float* score, const float* a_dst,
                const float* keep, const int64_t* keep_row,
                const int32_t* col, void* out, float* m, float* l,
                Items items, int64_t H, int64_t F, float slope, int gather,
                cudaStream_t stream) {
  const void* ptrs[] = {msg, out};
  const int V = pick_vec<T>(F, ptrs, 2);
  const int lg = lanes_log2(H * F, V);
  const dim3 grid = grid_of(items.n, lg);
  const T* mt = static_cast<const T*>(msg);
  T* ot = static_cast<T*>(out);
#define GAMMAGL_FWD_M(VV, G, KR)                                           \
  flash_fwd_kernel<T, VV, G, KR><<<grid, kThreads, 0, stream>>>(           \
      mt, score, a_dst, keep, keep_row, col, ot, m, l, items, lg, H, F,    \
      slope)
#define GAMMAGL_FWD(VV)                                                    \
  if (gather && keep_row != nullptr)                                       \
    GAMMAGL_FWD_M(VV, true, true);                                         \
  else if (gather)                                                         \
    GAMMAGL_FWD_M(VV, true, false);                                        \
  else if (keep_row != nullptr)                                            \
    GAMMAGL_FWD_M(VV, false, true);                                        \
  else                                                                     \
    GAMMAGL_FWD_M(VV, false, false)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_FWD(8); } break;
    case 4: GAMMAGL_FWD(4); break;
    case 2: GAMMAGL_FWD(2); break;
    default: GAMMAGL_FWD(1); break;
  }
#undef GAMMAGL_FWD
#undef GAMMAGL_FWD_M
}

template <typename T>
void launch_fold(const float* part, int64_t stride, const int32_t* cut_row,
                 const int64_t* cut_ptr, int64_t n_cut, void* out, float* m,
                 float* l, int64_t H, int64_t F, cudaStream_t stream) {
  const void* ptrs[] = {out};
  const int V = pick_vec<T>(F, ptrs, 1);
  const int lg = lanes_log2(H * F, V);
  const dim3 grid = grid_of(n_cut, lg);
  T* ot = static_cast<T*>(out);
#define GAMMAGL_FOLD(VV)                                                   \
  flash_fwd_fold_kernel<T, VV><<<grid, kThreads, 0, stream>>>(             \
      part, cut_row, cut_ptr, n_cut, lg, H, F, stride, ot, m, l)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_FOLD(8); } break;
    case 4: GAMMAGL_FOLD(4); break;
    case 2: GAMMAGL_FOLD(2); break;
    default: GAMMAGL_FOLD(1); break;
  }
#undef GAMMAGL_FOLD
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

// The forward's rows (and a slot: H*F sums, m and l) index in 32 bits.
bool bad_width(int64_t H, int64_t F) {
  return H < 1 || F < 1 || H > 0x7fffffff / (F + 2);
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
// edge order) or e when keep_row is null; col: (E,) int32; out: (n_dst,
// H*F) of msg's type; m, l: (n_dst, H) f32.
// The items, as gammagl_spmm_csr's: item_ptr (n_items + 1,) int64 edge
// offsets; item_meta (n_items, 2) int32 {row, slot}, slot -1 for an item
// that owns its row, or null (item i is row i, item_ptr the plan's
// rowptr); part: f32 scratch of (slots, part_stride) for the partials of
// cut rows (null when no item has a slot), part_stride a multiple of 4
// that is >= H*F + 2*H. A cut row is written by
// gammagl_flash_attention_fwd_fold, launched after this on the same
// stream. Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
int gammagl_flash_attention_fwd(const void* msg, const void* score,
                                const void* a_dst, const void* keep,
                                const void* keep_row, const void* item_ptr,
                                const void* item_meta, int64_t n_items,
                                const void* col, void* part,
                                int64_t part_stride, void* out, void* m,
                                void* l, int64_t H, int64_t F, float slope,
                                int gather, int is_bf16, void* stream) {
  Items items;
  if (bad_width(H, F) ||
      !make_items(item_ptr, item_meta, n_items, part, part_stride,
                  H * F + 2 * H, &items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0) {
    const float* sc = static_cast<const float*>(score);
    const float* ad = static_cast<const float*>(a_dst);
    const float* kp = static_cast<const float*>(keep);
    const int64_t* kr = static_cast<const int64_t*>(keep_row);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* mf = static_cast<float*>(m);
    float* lf = static_cast<float*>(l);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_fwd<__nv_bfloat16>(msg, sc, ad, kp, kr, cl, out, mf, lf, items,
                                H, F, slope, gather, s);
    else
      launch_fwd<float>(msg, sc, ad, kp, kr, cl, out, mf, lf, items, H, F,
                        slope, gather, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's fold of cut rows: part (slots, part_stride) f32 as
// gammagl_flash_attention_fwd wrote it; cut_row (n_cut,) int32 the rows;
// cut_ptr (n_cut + 1,) int64, cut row i owning slots [cut_ptr[i],
// cut_ptr[i + 1]) in item order; writes the cut rows of out (n_dst, H*F)
// of msg's type and of m, l (n_dst, H) f32.
int gammagl_flash_attention_fwd_fold(const void* part, int64_t part_stride,
                                     const void* cut_row,
                                     const void* cut_ptr, int64_t n_cut,
                                     void* out, void* m, void* l, int64_t H,
                                     int64_t F, int is_bf16, void* stream) {
  if (bad_width(H, F) || !fold_ok(part, part_stride, n_cut, H * F + 2 * H))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cut > 0) {
    const float* pf = static_cast<const float*>(part);
    const int32_t* cr = static_cast<const int32_t*>(cut_row);
    const int64_t* cp = static_cast<const int64_t*>(cut_ptr);
    float* mf = static_cast<float*>(m);
    float* lf = static_cast<float*>(l);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_fold<__nv_bfloat16>(pf, part_stride, cr, cp, n_cut, out, mf, lf,
                                 H, F, s);
    else
      launch_fold<float>(pf, part_stride, cr, cp, n_cut, out, mf, lf, H, F,
                         s);
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
