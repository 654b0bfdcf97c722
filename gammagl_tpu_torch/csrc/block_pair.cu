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
// What bounds the forward on the card: bytes, and the instructions that
// move them. After a bandwidth-reducing order (RCM) or a clustering order,
// each destination block draws its sources from a few source blocks, so a
// CTA reads a source block's slab once from memory (mostly from L2: the
// neighbouring destination blocks read the same one) and every edge reads
// its row from shared memory, where the CSR kernel gathers one row of x per
// edge from L2 or HBM. At the ogbn-arxiv shape (2.48M edges, F = 256, bf16)
// the function must move about 0.2 GB (x, out, the edge arrays, w); the
// CSR kernel's per-edge rows alone are 1.27 GB of L2 or HBM reads, the
// slab rows read from shared memory here as many.
//
// The design, for Hopper:
//  * one CTA per (destination block, column chunk of FT = 16 L bytes),
//    lanes in groups of L (4, 8 or 16: the fewest that cover F at 16
//    bytes a lane, fewer where shared memory runs short), each lane
//    reading VC columns (8 bf16 or 4 f32) of a slab row with one 16-byte
//    load. At F = 256 bf16 that is 2 chunks of 128 columns, so every edge
//    is walked twice, not four times as with a 64-column chunk;
//  * each group owns kRowsPerGroup = 8 whole rows of the block (32 groups,
//    512 threads, at R = 256 and L = 16) across all its pairs, and keeps
//    their f32 sums in registers (8 rows x VC a lane), the row index
//    static in an unrolled loop: no accumulator in shared memory and no
//    read-modify-write when the row changes. Each row is written once,
//    rounded once;
//  * the CTA walks its block's pairs in steps of at most edge_chunk(L)
//    edges (4096 at L = 16; a pair with more takes several steps on the
//    same slab). The next step's sources (and weights in the plan's order)
//    and, at a new pair, its S x FT source slab are copied into shared
//    memory with cp.async into the second of two buffers while this step
//    is summed: pair p + 1 streams in while pair p is summed. Weights in
//    the caller's order (read through w_perm) are gathered into registers
//    a step ahead, kWeightsAhead a thread, and stored beside the sources
//    after the sum, so no step waits on them but a CTA's first;
//  * the plan carries each pair's per-row edge offsets (row_ptr), so a
//    group finds its rows' edges in a step without walking them. Each row
//    is summed in a fixed order, pair by pair (source blocks ascending),
//    sources ascending within a pair: no atomics, repeats are bitwise
//    equal;
//  * a destination block without edges writes zeros; rows past N_src are
//    not staged (no edge reads them); where F or x's alignment rules out
//    16-byte copies the slab is staged a column at a time (the sums still
//    read 16 bytes of the slab row).
// At R = S = 256, L = 16 the two slabs and edge buffers take 192 KB of
// shared memory, above the 48 KB default, so the launch raises the limit
// with cudaFuncSetAttribute. R above 256 (more than 32 groups) or an S
// whose slabs do not fit even at L = 4 is refused. Tensor cores do not
// help: a dense bf16 pair tile at the banded graph's fill does tens of
// times the needed arithmetic, and the sum is bound by bytes.
// On the H100 (scripts/bp_flash_probe.py): steps of half the edges cost
// 3% at F = 256 and 6% at F = 40; 64-column chunks cost a first version
// 7% at F = 256; persistent CTAs (a stream of items each) spilled and took 0.437 ms
// against 0.359 at F = 256; weights read through w_perm cost 0.075 ms of
// the 0.359 (0.284 with weights in the plan's order).
//
// The dw kernel (the weight gradient) walks the plan's edges, one warp per
// 32 consecutive edges: each edge's two rows are read from L1/L2 (the plan's
// order keeps each destination row's edges together), dotted in f32 and
// reduced across the warp by xor shuffles, and written to the edge's slot.
// The slots are distinct, so the writes are deterministic.

#include "common.cuh"

namespace {

constexpr int kRowsPerGroup = 8;     // destination rows a lane group owns
constexpr int kMaxGroups = 32;       // lane groups of a forward CTA: R <= 256
constexpr int kWeightsAhead = 8;     // weights a thread gathers a step ahead
constexpr size_t kMaxSmem = 232448;  // the opt-in limit of an H100 block
constexpr int kUnrollEdges = 4;      // edges whose rows the dw kernel reads

// Edges a step of a CTA of groups of L lanes: as many as its full 32
// groups gather kWeightsAhead weights each (4096 at L = 16).
__host__ __device__ constexpr int edge_chunk(int L) {
  return kMaxGroups * L * kWeightsAhead;
}

// Shared memory of a forward CTA: two buffers, each an S x FT slab of T
// and edge_chunk(L) sources and weights (int32 and f32).
inline size_t fwd_smem(int S, int L, size_t elem) {
  const int FT = L * 16 / static_cast<int>(elem);
  return 2 * (static_cast<size_t>(S) * FT * elem +
              2 * static_cast<size_t>(edge_chunk(L)) * sizeof(int32_t));
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

// One CTA per (destination block, column chunk of FT = L * VC):
// blockIdx.x = block * nchunks + chunk, so the chunks of one block run side
// by side and share its edge arrays in L2. kVec: x's rows are staged 16
// bytes a copy, else a column a copy. 16 / L blocks an SM, as many as
// their shared memory allows (at S = 256), and 128 registers a thread.
template <typename T, int L, bool kVec>
__global__ void __launch_bounds__(kMaxGroups * L, 16 / L)
    block_pair_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const int32_t* __restrict__ wperm,
                          const int32_t* __restrict__ col,
                          const int32_t* __restrict__ row_ptr,
                          const int64_t* __restrict__ block_ptr,
                          const int32_t* __restrict__ pair_src,
                          T* __restrict__ out, int64_t n_dst, int64_t n_src,
                          int64_t F, int R, int S, int nchunks) {
  constexpr int VC = 16 / static_cast<int>(sizeof(T));
  constexpr int FT = L * VC;
  constexpr int RG = kRowsPerGroup;
  constexpr int EC = edge_chunk(L);
  constexpr int VS = kVec ? VC : 1;  // columns a staging copy moves
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t slab_elems = static_cast<int64_t>(S) * FT;
  T* slabs = reinterpret_cast<T*>(smem);  // [2][S][FT]
  int32_t* srcs = reinterpret_cast<int32_t*>(slabs + 2 * slab_elems);
  float* wts = reinterpret_cast<float*>(srcs + 2 * EC);
  const int tid = threadIdx.x;
  const int r0 = tid / L * RG;  // the group's first row in the block
  const int c = tid % L * VC;   // the lane's first column in the chunk
  const int64_t b = blockIdx.x / nchunks;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % nchunks) * FT;
  const int fcols = static_cast<int>(F - c0 < FT ? F - c0 : FT);
  const bool live = r0 < R && c < fcols;  // the lane sums something
  const bool gather = w != nullptr && wperm != nullptr;
  const int64_t p_end = block_ptr[b + 1];
  int64_t p = block_ptr[b];

  // Copy pair q's source slab into slab buffer `buf`.
  auto stage_slab = [&](int64_t q, int buf) {
    const int64_t src0 = static_cast<int64_t>(pair_src[q]) * S;
    const int srows = static_cast<int>(n_src - src0 < S ? n_src - src0 : S);
    const int per_row = fcols / VS;
    const int n = srows * per_row;
    T* slab = slabs + buf * slab_elems;
    for (int i = tid; i < n; i += blockDim.x) {
      const int r = i / per_row;
      const int k = (i - r * per_row) * VS;
      stage_copy<T, VS>(slab + r * FT + k, x + (src0 + r) * F + c0 + k);
    }
  };
  // Copy the sources of edges [a, a_end) into edge buffer `buf`, and their
  // weights where they lie in the plan's order (the caller's order is
  // gathered by the threads themselves).
  auto stage_edges = [&](int64_t a, int64_t a_end, int buf) {
    const int ne = static_cast<int>(a_end - a);
    for (int j = tid; j < ne; j += blockDim.x) {
      stage_copy<int32_t, 1>(srcs + buf * EC + j, col + a + j);
      if (w != nullptr && wperm == nullptr)
        stage_copy<float, 1>(wts + buf * EC + j, w + a + j);
    }
  };
  // The end of the step of pair q that starts at edge a.
  auto step_end = [&](int64_t q, int64_t a) -> int64_t {
    const int64_t qe = row_ptr[(q + 1) * R];
    return a + EC < qe ? a + EC : qe;
  };

  float acc[RG][VC];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < VC; ++i) acc[r][i] = 0.f;

  int64_t a = p < p_end ? row_ptr[p * R] : 0;
  int64_t a_end = p < p_end ? step_end(p, a) : 0;
  int sbuf = 0, ebuf = 0;
  if (p < p_end) {
    stage_slab(p, 0);
    stage_edges(a, a_end, 0);
    if (gather)  // the first step's weights: the one gather not hidden
      for (int j = tid; j < a_end - a; j += blockDim.x)
        wts[j] = __ldg(w + __ldg(wperm + a + j));
  }
  commit_stage();
  while (p < p_end) {
    // the next step: the rest of pair p, or the next pair
    const int64_t np = a_end < row_ptr[(p + 1) * R] ? p : p + 1;
    const bool more = np < p_end;
    const int64_t na_end = more ? step_end(np, a_end) : a_end;
    const int nne = static_cast<int>(na_end - a_end);
    if (more) {
      if (np != p) stage_slab(np, sbuf ^ 1);
      stage_edges(a_end, na_end, ebuf ^ 1);
    }
    commit_stage();
    // the next step's weights in the caller's order, gathered into
    // registers while this step is summed
    float wnext[kWeightsAhead];
    if (gather) {
#pragma unroll
      for (int u = 0; u < kWeightsAhead; ++u) {
        const int j = tid + u * static_cast<int>(blockDim.x);
        wnext[u] = j < nne ? __ldg(w + __ldg(wperm + a_end + j)) : 0.f;
      }
    }
    // the group's rows' edge offsets in pair p (rows past R: none)
    int off[RG + 1];
#pragma unroll
    for (int r = 0; r <= RG; ++r)
      off[r] = __ldg(row_ptr + p * R + (r0 + r < R ? r0 + r : R));
    const int src0 = pair_src[p] * S;
    wait_stages<1>();  // this step's copies have landed, the next's may not
    __syncthreads();
    if (live) {
      const T* slab = slabs + sbuf * slab_elems + c;
      const int32_t* sb = srcs + ebuf * EC;
      const float* wb = wts + ebuf * EC;
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int lo = static_cast<int>((off[r] > a ? off[r] : a) - a);
        const int hi =
            static_cast<int>((off[r + 1] < a_end ? off[r + 1] : a_end) - a);
        int j = lo;
        for (; j + 1 < hi; j += 2) {  // two rows' loads in flight
          float v0[VC], v1[VC];
          slab_vals<T>(slab + (sb[j] - src0) * FT, v0);
          slab_vals<T>(slab + (sb[j + 1] - src0) * FT, v1);
          const float w0 = w != nullptr ? wb[j] : 1.f;
          const float w1 = w != nullptr ? wb[j + 1] : 1.f;
#pragma unroll
          for (int i = 0; i < VC; ++i)
            acc[r][i] = fmaf(w1, v1[i], fmaf(w0, v0[i], acc[r][i]));
        }
        if (j < hi) {
          float v0[VC];
          slab_vals<T>(slab + (sb[j] - src0) * FT, v0);
          const float w0 = w != nullptr ? wb[j] : 1.f;
#pragma unroll
          for (int i = 0; i < VC; ++i) acc[r][i] = fmaf(w0, v0[i], acc[r][i]);
        }
      }
    }
    if (gather && more) {
      float* wn = wts + (ebuf ^ 1) * EC;
#pragma unroll
      for (int u = 0; u < kWeightsAhead; ++u) {
        const int j = tid + u * static_cast<int>(blockDim.x);
        if (j < nne) wn[j] = wnext[u];
      }
      // a CTA of fewer than 32 groups (R < 256) gathers the rest here
      for (int j = tid + kWeightsAhead * static_cast<int>(blockDim.x);
           j < nne; j += blockDim.x)
        wn[j] = __ldg(w + __ldg(wperm + a_end + j));
    }
    __syncthreads();  // the buffers are read before they are staged again
    if (np != p) sbuf ^= 1;
    ebuf ^= 1;
    p = np;
    a = a_end;
    a_end = na_end;
  }

  if (!live) return;
  const int64_t row0 = b * R + r0;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const int64_t row = row0 + r;
    if (r0 + r >= R || row >= n_dst) break;
    T* o = out + row * F + c0 + c;
    if constexpr (kVec) {
      store_vec<T, VC>(o, acc[r]);
    } else {
#pragma unroll
      for (int i = 0; i < VC; ++i) {
        const float one[1] = {acc[r][i]};
        if (c + i < fcols) store_vec<T, 1>(o + i, one);
      }
    }
  }
}

template <typename T, int L>
int launch_fwd(const void* x, const float* w, const int32_t* wperm,
               const int32_t* col, const int32_t* row_ptr,
               const int64_t* block_ptr, const int32_t* pair_src, void* out,
               int64_t n_dst, int64_t n_src, int64_t F, int R, int S,
               cudaStream_t stream) {
  constexpr int VC = 16 / static_cast<int>(sizeof(T));
  constexpr int FT = L * VC;
  const size_t smem = fwd_smem(S, L, sizeof(T));
  const int64_t nchunks = (F + FT - 1) / FT;
  const int64_t grid = (n_dst + R - 1) / R * nchunks;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (R + kRowsPerGroup - 1) / kRowsPerGroup;
  const int threads = (groups * L + kWarp - 1) / kWarp * kWarp;
  const void* ptrs[] = {x, out};
  auto kern = pick_vec<T>(F, ptrs, 2) == VC
                  ? block_pair_fwd_kernel<T, L, true>
                  : block_pair_fwd_kernel<T, L, false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch reports it
    return static_cast<int>(set);
  }
  kern<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const T*>(x), w, wperm, col, row_ptr, block_ptr, pair_src,
      static_cast<T*>(out), n_dst, n_src, F, R, S,
      static_cast<int>(nchunks));
  return static_cast<int>(cudaGetLastError());
}

// L: the fewest lanes (4, 8 or 16) whose 16-byte loads cover F, halved
// while the slabs do not fit shared memory.
template <typename T>
int launch_fwd_type(const void* x, const float* w, const int32_t* wperm,
                    const int32_t* col, const int32_t* row_ptr,
                    const int64_t* block_ptr, const int32_t* pair_src,
                    void* out, int64_t n_dst, int64_t n_src, int64_t F, int R,
                    int S, cudaStream_t stream) {
  constexpr int VC = 16 / static_cast<int>(sizeof(T));
  if (R > kMaxGroups * kRowsPerGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  int L = 4;
  while (L < 16 && static_cast<int64_t>(L) * VC < F) L *= 2;
  while (L > 4 && fwd_smem(S, L, sizeof(T)) > kMaxSmem) L /= 2;
  if (fwd_smem(S, L, sizeof(T)) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);  // S too large
  auto launch = L == 16 ? launch_fwd<T, 16>
                : L == 8  ? launch_fwd<T, 8>
                          : launch_fwd<T, 4>;
  return launch(x, w, wperm, col, row_ptr, block_ptr, pair_src, out, n_dst,
                n_src, F, R, S, stream);
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
// read at wperm[e] (int32; null: at e), or null for unit weights; col: (E,)
// int32 source of each plan edge, the edges grouped by destination block,
// then by source block (pair_src order), then sorted by row and source;
// row_ptr: (n_pairs * R + 1,) int32, the edges of row r of pair p's block
// are [row_ptr[p * R + r], row_ptr[p * R + r + 1]); block_ptr:
// (ceil(n_dst / R) + 1,) int64 into the pairs; pair_src: the source block
// of each pair, ascending within a destination block; out: (n_dst, F) of
// x's type. R <= 256. Launches on `stream` and returns the CUDA error (0 on
// success); does not synchronise.
int gammagl_block_pair_fwd(const void* x, const void* w, const void* wperm,
                           const void* col, const void* row_ptr,
                           const void* block_ptr, const void* pair_src,
                           void* out, int64_t n_dst, int64_t n_src, int64_t F,
                           int R, int S, int x_is_bf16, void* stream) {
  if (n_dst < 0 || n_src < 0 || F < 0 || R < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const float* wf = static_cast<const float*>(w);
  const int32_t* wp = static_cast<const int32_t*>(wperm);
  const int32_t* cl = static_cast<const int32_t*>(col);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const int64_t* bp = static_cast<const int64_t*>(block_ptr);
  const int32_t* ps = static_cast<const int32_t*>(pair_src);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_fwd_type<__nv_bfloat16>(x, wf, wp, cl, rp, bp, ps, out,
                                          n_dst, n_src, F, R, S, s);
  return launch_fwd_type<float>(x, wf, wp, cl, rp, bp, ps, out, n_dst, n_src,
                                F, R, S, s);
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
