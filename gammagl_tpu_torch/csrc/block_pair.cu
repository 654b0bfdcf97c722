// Block-pair SpMM for Hopper (sm_90a), with a plain C interface loaded by
// ctypes. For the edges (s -> d) of a graph whose nodes are cut into
// destination blocks of R rows and source blocks of S rows:
//
//   forward:  out[d, c] = sum_{(s, d)} w_e * x[s, c]          (f32 sums)
//   dw:       dw[slot(e)] = sum_c g[d_e, c] * x[s_e, c]         (f32)
//
// with w_e = w[wperm[e]] (wperm null: w[e]; w null: every weight 1) and
// slot(e) = slot[e] (null: e).
//
// The forward replaces the TPU kernel of gammagl_tpu/ops/pallas/
// block_pair.py: _forward (:198; body _kernel :156, call :229). On the TPU
// each tile of ET edges of one (dst block, src block) pair has the source
// block DMA'd into VMEM, and the per-edge "gather" and the reduce into the
// destination block are one-hot matmuls on the matrix unit (f32 through a
// bf16 hi/lo split, F padded to 128). None of that carries over: here the
// source block is staged in shared memory and each edge reads its row there
// directly. The dw kernel has no Pallas counterpart: the JAX VJP
// (_bwd :264) gathers both endpoint rows in XLA. The gradient of x is this
// forward kernel on the plan's transpose, as _bwd's segment_sum computes.
//
// What bounds the forward on the card: bytes, and the latency of reaching
// them. After a bandwidth-reducing order (RCM) or a clustering order, each
// destination block draws its sources from a few source blocks, so a CTA
// reads a source block once from memory (mostly from L2: the neighbouring
// destination blocks read the same one) and every edge of the pair reads
// its row from shared memory, where the CSR kernel gathers one row of x per
// edge from L2 or HBM. At the ogbn-arxiv shape (2.48M edges, F = 256, bf16)
// the function must move about 0.2 GB (x, out, the edge arrays, w); the
// CSR kernel's per-edge rows alone are 1.27 GB of L2 or HBM reads.
//
// What this simple design does about it:
//  * one CTA of kBpWarps warps per (destination block, column chunk of
//    FT = 64 columns; 32 where R and S leave no room for 64);
//  * per (dst block, src block) pair: the S x FT source slab is staged in
//    shared memory with 16-byte coalesced loads (scalar ones where F or the
//    pointer does not allow them), each thread's loads in flight together;
//    rows past N_src are not staged (no edge reads them);
//  * lanes work in groups of L = FT / VC, each lane reading VC columns (16
//    bytes: 8 bf16 or 4 f32) of an edge's slab row with one load, so a warp
//    has 32 / L edges in flight at each step. Each pair's edges are sorted
//    by destination row, then source, and cut into kSegs row segments (the
//    plan's seg_ptr); each group owns whole segments, reads their edges 4L
//    at a time with coalesced loads (the first 4L together with the slab,
//    the next 4L while it works), and hands them out by shuffle within the
//    group;
//  * a group keeps the running sum of its current row in registers (VC
//    columns a lane) and adds it into the R x FT f32 accumulator in shared
//    memory when the row changes: one group owns each row, so there are no
//    atomics, and each row is summed in a fixed order (pair by pair, source
//    ascending). The result is deterministic;
//  * the accumulator is written once, rounded once to x's dtype; a
//    destination block without edges writes zeros.
// At R = S = 256 the slab and accumulator take 96 KB (bf16) or 128 KB (f32)
// of shared memory, above the 48 KB default, so the launch raises the
// limit with cudaFuncSetAttribute. cp.async double buffering of the slabs,
// TMA, wider chunks and mma are left for later. Two first versions, which
// waited on one load at a time in the staging loop and on each edge batch
// in turn, took about 70 us a CTA on an H100, whatever the lanes did with
// the edges (PERF.md).
//
// The dw kernel (the weight gradient) walks the plan's edges, one warp per
// 32 consecutive edges: each edge's two rows are read from L1/L2 (the plan's
// order keeps each destination row's edges together), dotted in f32 and
// reduced across the warp by xor shuffles, and written to the edge's slot.
// The slots are distinct, so the writes are deterministic.

#include "common.cuh"

namespace {

constexpr int kBpWarps = 8;          // warps of a forward CTA
constexpr int kSegs = 32;            // row segments of a destination block
                                     // in the plan's seg_ptr
constexpr size_t kMaxSmem = 232448;  // the opt-in limit of an H100 block
constexpr int kUnrollEdges = 4;      // edges whose rows are read at once

__host__ __device__ inline size_t acc_bytes(int R, int FT) {
  return (static_cast<size_t>(R) * FT * sizeof(float) + 15) / 16 * 16;
}

inline size_t fwd_smem(int R, int S, int FT, size_t elem) {
  return acc_bytes(R, FT) + static_cast<size_t>(S) * FT * elem;
}

// 16 bytes of the slab at p (shared memory) as f32: 8 bf16 or 4 f32.
template <typename T>
__device__ __forceinline__ void slab_vals(const T* p,
                                          float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const uint4 b = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: low half first
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ T round_to(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// Copy rows [src0, src0 + srows) and columns [c0, c0 + fcols) of x (row
// stride F) into the slab (row stride FT), VS elements a load; VS divides
// fcols, F and c0. Each thread issues kStageUnroll loads before it stores
// any, so they are in flight together.
constexpr int kStageUnroll = 8;

template <typename T, int VS>
__device__ __forceinline__ void stage(const T* __restrict__ x, T* slab,
                                      int64_t src0, int srows, int64_t F,
                                      int64_t c0, int fcols, int FT) {
  using Raw = typename RawBits<VS * static_cast<int>(sizeof(T))>::type;
  const int per_row = fcols / VS;
  const int n = srows * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += kStageUnroll * blockDim.x) {
    Raw v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int r = i / per_row;
        v[u] = __ldg(reinterpret_cast<const Raw*>(
            x + (src0 + r) * F + c0 + (i - r * per_row) * VS));
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int r = i / per_row;
        *reinterpret_cast<Raw*>(slab + r * FT + (i - r * per_row) * VS) =
            v[u];
      }
    }
  }
}

constexpr int kBatch = 4;  // edges a lane holds of a group's batch

// A group's batch of kBatch * L edges: lane tl holds edges b + k * L + tl
// (dummies past the group's last edge: slab row 0, never added).
struct EdgeBatch {
  int r[kBatch];
  int s[kBatch];
  float w[kBatch];
};

__device__ __forceinline__ EdgeBatch fetch_edges(
    const float* __restrict__ w, const int32_t* __restrict__ wperm,
    const int32_t* __restrict__ row, const int32_t* __restrict__ col,
    int64_t lo, int n, int b, int L, int tl, int64_t src0) {
  EdgeBatch eb;
  int64_t at[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int j = b + k * L + tl;
    eb.r[k] = 0;
    eb.s[k] = static_cast<int>(src0);
    eb.w[k] = 1.f;
    at[k] = lo + j;
    if (j < n) {
      eb.r[k] = __ldg(row + at[k]);
      eb.s[k] = __ldg(col + at[k]);
      if (wperm != nullptr) at[k] = __ldg(wperm + at[k]);
    }
  }
  if (w != nullptr) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (b + k * L + tl < n) eb.w[k] = __ldg(w + at[k]);
  }
  return eb;
}

// One lane group's edges [lo, lo + n) of one pair, the first batch already
// fetched: adds w_e * slab[col_e - src0] into the accumulator row of
// row_e - row0, through a running sum per row. A group of L = FT / VC lanes
// covers the chunk's FT columns, VC = 16 bytes of them a lane; the warp's
// 32 / L groups walk their own edges side by side, for as many steps as
// the longest needs (the others idle).
template <typename T, int FT>
__device__ __forceinline__ void accumulate(
    const T* slab, float* acc, const float* __restrict__ w,
    const int32_t* __restrict__ wperm, const int32_t* __restrict__ row,
    const int32_t* __restrict__ col, int64_t lo, int n, EdgeBatch eb,
    int64_t row0, int64_t src0, int lane) {
  constexpr int VC = 16 / static_cast<int>(sizeof(T));
  constexpr int L = FT / VC;
  const int tl = lane % L;
  const int c = tl * VC;
  int n_max = n;
#pragma unroll
  for (int off = L; off < kWarp; off *= 2)
    n_max = max(n_max, __shfl_xor_sync(kFullMask, n_max, off));

  int cur = -1;  // the row whose sum is in `part`
  float part[VC];
#pragma unroll
  for (int i = 0; i < VC; ++i) part[i] = 0.f;
  auto flush = [&]() {
    if (cur >= 0) {
      float* a = acc + (static_cast<int64_t>(cur) - row0) * FT + c;
#pragma unroll
      for (int i = 0; i < VC; i += 4) {
        float4 o = *reinterpret_cast<float4*>(a + i);
        o.x += part[i];
        o.y += part[i + 1];
        o.z += part[i + 2];
        o.w += part[i + 3];
        *reinterpret_cast<float4*>(a + i) = o;
      }
    }
  };

  for (int b = 0; b < n_max; b += kBatch * L) {
    // the next batch is loaded while this one is summed
    const EdgeBatch nx = fetch_edges(w, wperm, row, col, lo, n,
                                     b + kBatch * L, L, tl, src0);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (b + k * L >= n_max) break;  // the warp's groups are all done
#pragma unroll
      for (int j0 = 0; j0 < L; j0 += kUnrollEdges) {
        int r[kUnrollEdges];
        float wj[kUnrollEdges], v[kUnrollEdges][VC];
#pragma unroll
        for (int u = 0; u < kUnrollEdges; ++u) {
          r[u] = __shfl_sync(kFullMask, eb.r[k], j0 + u, L);
          wj[u] = __shfl_sync(kFullMask, eb.w[k], j0 + u, L);
          const int s = __shfl_sync(kFullMask, eb.s[k], j0 + u, L);
          slab_vals<T>(slab + (static_cast<int64_t>(s) - src0) * FT + c,
                       v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnrollEdges; ++u) {
          if (b + k * L + j0 + u < n) {  // the same for the whole group
            if (r[u] != cur) {
              flush();
              cur = r[u];
#pragma unroll
              for (int i = 0; i < VC; ++i) part[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < VC; ++i)
              part[i] = fmaf(wj[u], v[u][i], part[i]);
          }
        }
      }
    }
    eb = nx;
  }
  flush();
}

// One CTA per (destination block, column chunk of FT): blockIdx.x = block *
// nchunks + chunk, so the chunks of one block run side by side and share
// its edge arrays in L2.
template <typename T, int FT, int VS>
__global__ void __launch_bounds__(kWarp * kBpWarps)
    block_pair_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const int32_t* __restrict__ wperm,
                          const int32_t* __restrict__ row,
                          const int32_t* __restrict__ col,
                          const int64_t* __restrict__ seg_ptr,
                          const int64_t* __restrict__ block_ptr,
                          const int32_t* __restrict__ pair_src,
                          T* __restrict__ out, int64_t n_dst, int64_t n_src,
                          int64_t F, int R, int S, int nchunks) {
  constexpr int L = FT * static_cast<int>(sizeof(T)) / 16;
  constexpr int kGroups = kBpWarps * (kWarp / L);
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  T* slab = reinterpret_cast<T*>(smem + acc_bytes(R, FT));
  const int lane = threadIdx.x % kWarp;
  const int group = threadIdx.x / L;  // its segments of every pair:
  const int seg_lo = group * kSegs / kGroups;
  const int seg_hi = (group + 1) * kSegs / kGroups;
  const int64_t b = blockIdx.x / nchunks;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % nchunks) * FT;
  const int fcols = static_cast<int>(F - c0 < FT ? F - c0 : FT);
  const int64_t row0 = b * R;
  const int nrows = static_cast<int>(n_dst - row0 < R ? n_dst - row0 : R);

  for (int i = threadIdx.x; i < nrows * FT; i += blockDim.x) acc[i] = 0.f;
  for (int64_t p = block_ptr[b]; p < block_ptr[b + 1]; ++p) {
    const int64_t src0 = static_cast<int64_t>(pair_src[p]) * S;
    const int srows =
        static_cast<int>(n_src - src0 < S ? n_src - src0 : S);
    const int64_t lo = seg_ptr[p * kSegs + seg_lo];
    const int n = static_cast<int>(seg_ptr[p * kSegs + seg_hi] - lo);
    // the group's first edges load while the slab does
    const EdgeBatch eb = fetch_edges(w, wperm, row, col, lo, n, 0, L,
                                     lane % L, src0);
    __syncthreads();  // the accumulator is zeroed; the last slab is read
    stage<T, VS>(x, slab, src0, srows, F, c0, fcols, FT);
    __syncthreads();
    accumulate<T, FT>(slab, acc, w, wperm, row, col, lo, n, eb, row0, src0,
                      lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * FT; i += blockDim.x) {
    const int r = i / FT;
    const int cc = i - r * FT;
    if (cc < fcols) out[(row0 + r) * F + c0 + cc] = round_to<T>(acc[i]);
  }
}

template <typename T, int FT>
int launch_fwd(const void* x, const float* w, const int32_t* wperm,
               const int32_t* row, const int32_t* col, const int64_t* seg_ptr,
               const int64_t* block_ptr, const int32_t* pair_src, void* out,
               int64_t n_dst, int64_t n_src, int64_t F, int R, int S,
               cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const size_t smem = fwd_smem(R, S, FT, sizeof(T));
  const int64_t nchunks = (F + FT - 1) / FT;
  const int64_t grid = (n_dst + R - 1) / R * nchunks;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x};
  auto kern = pick_vec<T>(F, ptrs, 1) == kVec
                  ? block_pair_fwd_kernel<T, FT, kVec>
                  : block_pair_fwd_kernel<T, FT, 1>;
  const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch reports it
    return static_cast<int>(set);
  }
  kern<<<static_cast<unsigned>(grid), kWarp * kBpWarps, smem, stream>>>(
      static_cast<const T*>(x), w, wperm, row, col, seg_ptr, block_ptr,
      pair_src, static_cast<T*>(out), n_dst, n_src, F, R, S,
      static_cast<int>(nchunks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_type(const void* x, const float* w, const int32_t* wperm,
                    const int32_t* row, const int32_t* col,
                    const int64_t* seg_ptr, const int64_t* block_ptr,
                    const int32_t* pair_src, void* out, int64_t n_dst,
                    int64_t n_src, int64_t F, int R, int S,
                    cudaStream_t stream) {
  if (fwd_smem(R, S, 64, sizeof(T)) <= kMaxSmem)
    return launch_fwd<T, 64>(x, w, wperm, row, col, seg_ptr, block_ptr,
                             pair_src, out, n_dst, n_src, F, R, S, stream);
  if (fwd_smem(R, S, 32, sizeof(T)) <= kMaxSmem)
    return launch_fwd<T, 32>(x, w, wperm, row, col, seg_ptr, block_ptr,
                             pair_src, out, n_dst, n_src, F, R, S, stream);
  return static_cast<int>(cudaErrorInvalidValue);  // R and S too large
}

// One warp per kWarp consecutive plan edges; lane j keeps edge j's dot.
template <typename T, int V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    block_pair_dw_kernel(const T* __restrict__ g, const T* __restrict__ x,
                         const int32_t* __restrict__ row,
                         const int32_t* __restrict__ col,
                         const int32_t* __restrict__ slot,
                         float* __restrict__ dw, int64_t n_edges, int64_t F) {
  const int lane = threadIdx.x % kWarp;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp) *
      kWarp;
  if (base >= n_edges) return;  // the whole warp leaves together
  const int n = static_cast<int>(n_edges - base < kWarp ? n_edges - base : kWarp);
  int my_r = 0, my_s = 0;
  if (lane < n) {
    my_r = __ldg(row + base + lane);
    my_s = __ldg(col + base + lane);
  }
  float mine = 0.f;
  for (int j = 0; j < n; j += kUnrollEdges) {
    int64_t r[kUnrollEdges], s[kUnrollEdges];
    float dot[kUnrollEdges];
#pragma unroll
    for (int u = 0; u < kUnrollEdges; ++u) {
      const int jj = j + u < n ? j + u : j;
      r[u] = __shfl_sync(kFullMask, my_r, jj);
      s[u] = __shfl_sync(kFullMask, my_s, jj);
      dot[u] = 0.f;
    }
    for (int64_t cc = static_cast<int64_t>(lane) * V; cc < F;
         cc += static_cast<int64_t>(kWarp) * V) {
      float gv[kUnrollEdges][V], xv[kUnrollEdges][V];
#pragma unroll
      for (int u = 0; u < kUnrollEdges; ++u) {
        load_vec<T, V>(g + r[u] * F + cc, gv[u]);
        load_vec<T, V>(x + s[u] * F + cc, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnrollEdges; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) dot[u] = fmaf(gv[u][i], xv[u][i], dot[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnrollEdges; ++u) {
      const float d = group_sum(dot[u], kWarp);  // every lane: the same bits
      if (lane == j + u) mine = d;
    }
  }
  if (lane < n)
    dw[slot != nullptr ? static_cast<int64_t>(__ldg(slot + base + lane))
                       : base + lane] = mine;
}

template <typename T>
void launch_dw(const void* g, const void* x, const int32_t* row,
               const int32_t* col, const int32_t* slot, float* dw,
               int64_t n_edges, int64_t F, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const void* ptrs[] = {g, x};
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(static_cast<unsigned>(
      (n_edges + kWarp * kWarpsPerBlock - 1) / (kWarp * kWarpsPerBlock)));
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  if (pick_vec<T>(F, ptrs, 2) == kVec)
    block_pair_dw_kernel<T, kVec><<<grid, block, 0, stream>>>(
        gt, xt, row, col, slot, dw, n_edges, F);
  else
    block_pair_dw_kernel<T, 1><<<grid, block, 0, stream>>>(
        gt, xt, row, col, slot, dw, n_edges, F);
}

}  // namespace

extern "C" {

// x: (>= n_src, F) bf16 (x_is_bf16 != 0) or f32, contiguous; w: f32 weights
// read at wperm[e] (int32; null: at e), or null for unit weights; row, col:
// (E,) int32 destination and source of each plan edge, grouped by
// destination block, then by source block (pair_src order), then sorted by
// row and source; seg_ptr: (n_pairs * 8 + 1,) int64, the edges of warp k's
// rows in pair p are [seg_ptr[p * 8 + k], seg_ptr[p * 8 + k + 1]), warp k
// owning rows [k * ceil(R / 8), (k + 1) * ceil(R / 8)) of the block;
// block_ptr: (ceil(n_dst / R) + 1,) int64 into the pairs; pair_src: the
// source block of each pair, ascending within a destination block; out:
// (n_dst, F) of x's type. Launches on `stream` and returns the CUDA error
// (0 on success); does not synchronise.
int gammagl_block_pair_fwd(const void* x, const void* w, const void* wperm,
                           const void* row, const void* col,
                           const void* seg_ptr, const void* block_ptr,
                           const void* pair_src, void* out, int64_t n_dst,
                           int64_t n_src, int64_t F, int R, int S,
                           int x_is_bf16, void* stream) {
  if (n_dst < 0 || n_src < 0 || F < 0 || R < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const float* wf = static_cast<const float*>(w);
  const int32_t* wp = static_cast<const int32_t*>(wperm);
  const int32_t* rw = static_cast<const int32_t*>(row);
  const int32_t* cl = static_cast<const int32_t*>(col);
  const int64_t* sp = static_cast<const int64_t*>(seg_ptr);
  const int64_t* bp = static_cast<const int64_t*>(block_ptr);
  const int32_t* ps = static_cast<const int32_t*>(pair_src);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_fwd_type<__nv_bfloat16>(x, wf, wp, rw, cl, sp, bp, ps, out,
                                          n_dst, n_src, F, R, S, s);
  return launch_fwd_type<float>(x, wf, wp, rw, cl, sp, bp, ps, out, n_dst,
                                n_src, F, R, S, s);
}

// g: (>= max row + 1, F), x: (>= max col + 1, F), both bf16 (x_is_bf16 != 0)
// or f32, contiguous; row, col: (n_edges,) int32 as for the forward; slot:
// (n_edges,) int32 distinct output positions, or null for e; dw: f32, written
// at every slot. Launches on `stream` and returns the CUDA error.
int gammagl_block_pair_dw(const void* g, const void* x, const void* row,
                          const void* col, const void* slot, void* dw,
                          int64_t n_edges, int64_t F, int x_is_bf16,
                          void* stream) {
  if (n_edges < 0 || F < 0 ||
      (n_edges + kWarp * kWarpsPerBlock - 1) / (kWarp * kWarpsPerBlock) >
          0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges > 0) {
    const int32_t* rw = static_cast<const int32_t*>(row);
    const int32_t* cl = static_cast<const int32_t*>(col);
    const int32_t* sl = static_cast<const int32_t*>(slot);
    float* d = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch_dw<__nv_bfloat16>(g, x, rw, cl, sl, d, n_edges, F, s);
    else
      launch_dw<float>(g, x, rw, cl, sl, d, n_edges, F, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
