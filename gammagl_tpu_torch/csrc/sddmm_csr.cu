// Edge-endpoint kernels over a destination-sorted CSR for Hopper (sm_90a),
// with a plain C interface loaded by ctypes. For CSR edge e of destination
// row d = row(e):
//
//   expand:  out[e, c] = x[d, c]                       (scale null: a copy)
//            out[e, c] = scale[e, c / (C / H)] * x[d, c]   (rounded once)
//   sddmm:   out[e, h] = sum_f a[r(e), h, f] * xd[d, h, f]   (f32)
//            with r(e) = col[e] (gathered source rows) or e (per-edge rows)
//
// Replaces the TPU kernels of gammagl_tpu/ops/pallas/sddmm_csr.py:
// expand_dst_csr (:386; _expand_kernel :347 and the compact
// _expand_kernel_win :359) and _sddmm_backward_mh (:134, the expand with a
// per-edge scale) by the expand; _sddmm_forward_mh (:92, per-edge rows) and
// _sddmm_fused_forward (:222, gathered packed rows) by the sddmm. On the TPU
// each tile of ET edges picks its destination rows out of a dense (R, F)
// block with a one-hot matmul on the matrix unit, so that no second trip
// through the gather engine is needed. On the card a warp reads its own
// destination row directly: no one-hot, no padded lanes, no window layout.
//
// What bounds them on the card: bytes. The expand reads each destination row
// once and writes it once for every edge of the row (E x C elements out
// against N x C in); the sddmm reads one row of a per edge (gathered or in
// order) and writes one f32 per edge and head, for 2 flops per element.
//
// What the design does about it:
//  * expand: one warp per destination row, which holds its row of x in
//    registers and walks the row's edges, so the row is read once; the
//    lanes split into groups of `lpe` lanes, one group per edge, each lane
//    moving V columns (up to 16 bytes) of that edge; a warp writes 32 / lpe
//    edges at a time, in whole rows, so the stores coalesce. Without a
//    scale the bits are copied, not converted: the result is bitwise equal
//    to x[row(e)];
//  * sddmm: the work items of the CSR kernels' schedule (csrc/
//    csr_items.cuh), cut at the wrappers' SDDMM_SPLIT edges, much shorter
//    than the CSR kernels' items: every edge's score is its own output, so
//    an item of a cut row writes its own edges' scores and needs no slot,
//    scratch or fold, and a hub row is spread over many lane groups. The
//    kernel reads only each item's edges and row;
//  * sddmm: an item takes a group of L lanes, a lane V columns (16 bytes
//    where F and the pointers allow: the widest load, not the narrowest)
//    of one head, Lh lanes a head (the power of two >= F / V, at most 32)
//    and L / Lh heads a pass, so a warp runs several items at once: (H, F)
//    = (8, 8) in bf16 takes 8 lanes, one head each, 4 items a warp; F = 256
//    in bf16 takes 32. The group holds its lanes' columns of xd[row] in
//    registers for the whole item;
//  * sddmm: each lane walks its item's edges through a cp.async ring of
//    kSddmmStages edges (walk_ring_split); the source row (col[e] for
//    gathered rows, e for per-edge rows: a template parameter, not a
//    runtime flag) of the next edge is loaded a step ahead. A lane's dot
//    reads its stage, the next copy into the stage is issued, and only
//    then the head's sums run, so they overlap the copies in flight
//    (0.375 ms at F = 256 against 0.379 with the sums first);
//  * sddmm: sums only inside a head: a lane's V products in order, then
//    the xor tree over the head's Lh lanes (none where a head is one lane,
//    as at (8, 8) in bf16: the group's 8 lanes then store 32 coalesced
//    bytes an edge). A head of 8 lanes or more keeps the partials of a run
//    of kSddmmBatch edges in registers and sums them at once, the tree's
//    first levels transposed (head_sums: 9 shuffles for 8 edges at F =
//    256 where a tree an edge takes 40: shuffles, not bytes, bounded the
//    tree), bitwise the tree's sums; 8 lanes then store the run's 8
//    scores together. A head wider than 32 V columns takes the wide
//    kernel, whose lanes add their column chunks of an edge in registers
//    and write once;
//  * sums in f32, in a fixed order, no atomics: repeats are bitwise equal.
// A fully transposed sum of 32 edges (31 shuffles) lost on the H100 at
// F = 256: its 32 partials went to the stack, and the arxiv-shape graph's
// items are short (PERF.md). TMA stores are left for later.

#include "csr_items.cuh"

namespace {

// One warp per destination row. Lane groups of lpe lanes each take one edge;
// a lane's first column in chunk k is (k * lpe + lane % lpe) * V.
template <typename T, int V, bool kScale>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    expand_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const int64_t* __restrict__ rowptr, T* __restrict__ out,
                  int64_t n_dst, int64_t C, int64_t H, int lpe, int K) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int groups = kWarp / lpe;
  const int group = lane / lpe;
  // no shuffles below, so lanes may leave on their own
  if (row >= n_dst || group >= groups) return;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  if (begin == end) return;
  const int64_t Fh = C / H;
  using Raw = typename RawBits<V * static_cast<int>(sizeof(T))>::type;

  for (int k = 0; k < K; ++k) {
    const int64_t c = (static_cast<int64_t>(k) * lpe + lane % lpe) * V;
    if (c >= C) break;
    const T* src = x + row * C + c;
    if constexpr (kScale) {
      float xv[V];
      load_vec<T, V>(src, xv);
      int64_t head[V];
#pragma unroll
      for (int i = 0; i < V; ++i) head[i] = (c + i) / Fh;
      for (int64_t e = begin + group; e < end; e += groups) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = __ldg(scale + e * H + head[i]) * xv[i];
        store_vec<T, V>(out + e * C + c, o);
      }
    } else {
      const Raw bits = *reinterpret_cast<const Raw*>(src);
      for (int64_t e = begin + group; e < end; e += groups)
        *reinterpret_cast<Raw*>(out + e * C + c) = bits;
    }
  }
}

// Edges in flight per lane in the SDDMM's ring: 16 bytes each in shared
// memory, 16 KB a block of 256 lanes.
constexpr int kSddmmStages = 4;
// Blocks of the SDDMM an SM must hold, which caps its registers at 64.
constexpr int kSddmmBlocks = 4;
// Edges whose partials a head of at least that many lanes sums at once
// (head_sums). On the H100 at F = 256 (scripts/sddmm_probe.py, in turns):
// 8 took 0.375 ms, 4 0.379, 1 (a tree an edge) 0.469, 16 1.85 (its
// partials went to the stack); with no sum at all 0.317.
constexpr int kSddmmBatch = 8;

// How an item's group lays its lanes over a row of H heads of F columns:
// lane q of the group takes head pass * heads + (q >> lh) and, in column
// chunk k, the V columns from ((k << lh) + (q & (Lh - 1))) * V of it.
struct SddmmGeom {
  int64_t H, F;
  int lg;      // log2 of L, the lanes an item takes (at most 5)
  int lh;      // log2 of Lh, the lanes a head takes
  int K;       // column chunks a lane takes in a head: ceil(F / (Lh V))
  int heads;   // heads a pass: L / Lh
  int passes;  // ceil(H / heads)
};

// Item i's row (row i where the plan has no cut rows) and edges.
struct SddmmItem {
  int64_t row, lo, n;
};

__device__ __forceinline__ SddmmItem sddmm_item(const int64_t* item_ptr,
                                                const int2* item_meta,
                                                int64_t i) {
  SddmmItem it;
  it.row = item_meta != nullptr ? __ldg(&item_meta[i].x) : i;
  it.lo = __ldg(item_ptr + i);
  it.n = __ldg(item_ptr + i + 1) - it.lo;
  return it;
}

// The dot's sum over the Lh lanes of a head, an xor tree: every lane of
// the head gets the same bits.
__device__ __forceinline__ float head_sum(float p, int Lh, unsigned mask) {
  for (int off = Lh >> 1; off > 0; off >>= 1)
    p += __shfl_xor_sync(mask, p, off);
  return p;
}

// The head's sums of B = 2^b edges' partials p[0..B) at once (B <= Lh =
// 2^lh): the tree's first b levels are transposed (at offset o a lane
// keeps the half of its partials that its bit o picks and adds its
// partner's of the same edges: one shuffle for two values), the rest are
// head_sum's over Lh / B lanes, so B edges take B - 1 + lh - b shuffles
// in place of B lh.
// Lane li ends with the sum of edge (li >> (lh - b)) of the B: the bits
// the xor tree gives every lane for that edge (each step adds the same
// two values).
template <int B>
__device__ __forceinline__ float head_sums(float (&p)[B], int lh, int li,
                                           unsigned mask) {
  int o = (1 << lh) >> 1;
#pragma unroll
  for (int live = B; live > 1; live /= 2, o >>= 1) {
    const bool up = li & o;
#pragma unroll
    for (int i = 0; i < live / 2; ++i) {
      const float mine = up ? p[i + live / 2] : p[i];
      const float theirs = up ? p[i] : p[i + live / 2];
      p[i] = mine + __shfl_xor_sync(mask, theirs, o);
    }
  }
  return head_sum(p[0], o << 1, mask);
}

__host__ __device__ constexpr int log2_of(int B) {
  return B > 1 ? 1 + log2_of(B / 2) : 0;
}

// One group of L lanes per item, one column chunk a lane in each head
// (K == 1): out[e, h] for the item's edges. kGather: rows of a at col[e],
// else e. B: edges a head sums at once (at most Lh).
template <typename T, int V, bool kGather, int B>
__global__ void __launch_bounds__(kThreads, kSddmmBlocks)
    sddmm_kernel(const T* __restrict__ a, const T* __restrict__ xd,
                 const int64_t* __restrict__ item_ptr,
                 const int2* __restrict__ item_meta, int64_t n_items,
                 const int32_t* __restrict__ col, float* __restrict__ out,
                 SddmmGeom g) {
  __shared__ uint4 ring[kSddmmStages][kThreads];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> g.lg;
  if (item >= n_items) return;  // whole groups leave together
  const int q = static_cast<int>(t & ((1 << g.lg) - 1));
  const int Lh = 1 << g.lh;
  const int li = q & (Lh - 1);
  const unsigned mask = group_mask(Lh);
  const SddmmItem it = sddmm_item(item_ptr, item_meta, item);
  const int64_t HF = g.H * g.F;
  auto source = [&](int64_t e) -> int64_t {
    if constexpr (kGather) return __ldg(col + e);
    return e;
  };

  for (int pass = 0; pass < g.passes; ++pass) {
    const int64_t h = static_cast<int64_t>(pass) * g.heads + (q >> g.lh);
    const int64_t cin = static_cast<int64_t>(li) * V;
    const bool cols = h < g.H && cin < g.F;
    const int64_t off = h * g.F + cin;
    float xv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) xv[i] = 0.f;
    if (cols) load_vec<T, V>(xd + it.row * HF + off, xv);
    // the partials of the run of B edges the walk is in; the head's lanes
    // sum and store them together at the run's last edge
    float pend[B];
#pragma unroll
    for (int k = 0; k < B; ++k) pend[k] = 0.f;
    auto copy = [&](int s, int64_t r) {
      if (cols) stage_copy<T, V>(&ring[s][threadIdx.x], a + r * HF + off);
    };
    auto take = [&](int64_t, float, int s) {  // the lane's dot
      float p = 0.f;
      if (cols) {
        float v[V];
        load_vec<T, V, false>(
            reinterpret_cast<const T*>(&ring[s][threadIdx.x]), v);
#pragma unroll
        for (int i = 0; i < V; ++i) p = fmaf(v[i], xv[i], p);
      }
      return p;
    };
    auto use = [&](int64_t j, float p) {
      const int k = static_cast<int>(j) & (B - 1);
#pragma unroll
      for (int m = 0; m < B; ++m) pend[m] = m == k ? p : pend[m];
      if (k == B - 1 || j == it.n - 1) {  // the same for the whole head
#pragma unroll
        for (int m = 0; m < B; ++m) pend[m] = m > k ? 0.f : pend[m];
        const float sum = head_sums<B>(pend, g.lh, li, mask);
        constexpr int b = log2_of(B);
        const int held = li >> (g.lh - b);  // the edge of the run it holds
        if ((li & ((Lh >> b) - 1)) == 0 && held <= k && h < g.H)
          out[(it.lo + j - k + held) * g.H + h] = sum;
      }
    };
    walk_ring_split<kSddmmStages>(
        it.lo, it.n, source, [](int64_t) { return 1.f; }, copy, take, use);
  }
}

// V values of a stage, as the wide kernel's take hands them on.
template <int V>
struct Chunk {
  float f[V];
};

// As sddmm_kernel, for heads wider than 32 V columns (K > 1): the ring
// walks (edge, chunk) steps, chunk k of edge j at step j * K + k, and the
// lane adds the K chunks of an edge in registers before the head's sum
// and the one store, after the step's next copy is issued. The chunk of
// xd[row] is read again at each step (a hit in L1: the item's row).
template <typename T, int V, bool kGather>
__global__ void __launch_bounds__(kThreads, kSddmmBlocks)
    sddmm_wide_kernel(const T* __restrict__ a, const T* __restrict__ xd,
                      const int64_t* __restrict__ item_ptr,
                      const int2* __restrict__ item_meta, int64_t n_items,
                      const int32_t* __restrict__ col,
                      float* __restrict__ out, SddmmGeom g) {
  __shared__ uint4 ring[kSddmmStages][kThreads];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> g.lg;
  if (item >= n_items) return;  // whole groups leave together
  const int q = static_cast<int>(t & ((1 << g.lg) - 1));
  const int Lh = 1 << g.lh;
  const int li = q & (Lh - 1);
  const unsigned mask = group_mask(Lh);
  const SddmmItem it = sddmm_item(item_ptr, item_meta, item);
  const int64_t HF = g.H * g.F;
  const int K = g.K;
  // steps index in 32 bits: an item has at most SDDMM_SPLIT edges
  const int steps = static_cast<int>(it.n) * K;

  for (int pass = 0; pass < g.passes; ++pass) {
    const int64_t h = static_cast<int64_t>(pass) * g.heads + (q >> g.lh);
    const bool head = h < g.H;
    const T* xrow = xd + it.row * HF + h * g.F;
    // step u's column in the head, or -1 where the lane has none
    auto column = [&](int u) -> int64_t {
      const int64_t c = static_cast<int64_t>((u % K) * Lh + li) * V;
      return head && c < g.F ? c : -1;
    };
    float p = 0.f;
    walk_ring_split<kSddmmStages>(
        int64_t{0}, static_cast<int64_t>(steps),
        [&](int64_t u) -> int64_t {  // element offset of the step's chunk
          const int64_t c = column(static_cast<int>(u));
          if (c < 0) return -1;
          const int64_t e = it.lo + static_cast<int>(u) / K;
          const int64_t r = kGather ? static_cast<int64_t>(__ldg(col + e)) : e;
          return r * HF + h * g.F + c;
        },
        [](int64_t) { return 1.f; },
        [&](int s, int64_t o) {
          if (o >= 0) stage_copy<T, V>(&ring[s][threadIdx.x], a + o);
        },
        [&](int64_t, float, int s) {  // the stage's values, before the copy
          Chunk<V> v;
          load_vec<T, V, false>(
              reinterpret_cast<const T*>(&ring[s][threadIdx.x]), v.f);
          return v;
        },
        [&](int64_t u, const Chunk<V>& v) {  // the rest, after it
          const int64_t c = column(static_cast<int>(u));
          if (c >= 0) {
            float x[V];
            load_vec<T, V>(xrow + c, x);
#pragma unroll
            for (int i = 0; i < V; ++i) p = fmaf(v.f[i], x[i], p);
          }
          if (static_cast<int>(u) % K == K - 1) {  // the edge's last chunk
            p = head_sum(p, Lh, mask);
            if (li == 0 && head)
              out[(it.lo + static_cast<int>(u) / K) * g.H + h] = p;
            p = 0.f;
          }
        });
  }
}

template <typename T>
void launch_expand(const void* x, const float* scale, const int64_t* rowptr,
                   void* out, int64_t n_dst, int64_t C, int64_t H,
                   cudaStream_t stream) {
  const void* ptrs[] = {x, out};
  const int V = pick_vec<T>(C, ptrs, 2);
  const int64_t chunks = (C + V - 1) / V;
  const int lpe = chunks < kWarp ? static_cast<int>(chunks) : kWarp;
  const int K = static_cast<int>((chunks + lpe - 1) / lpe);
  const dim3 block(kWarp * kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
#define GAMMAGL_EXPAND(VV)                                                  \
  if (scale != nullptr)                                                     \
    expand_kernel<T, VV, true><<<grid_for(n_dst), block, 0, stream>>>(      \
        xt, scale, rowptr, ot, n_dst, C, H, lpe, K);                        \
  else                                                                      \
    expand_kernel<T, VV, false><<<grid_for(n_dst), block, 0, stream>>>(     \
        xt, scale, rowptr, ot, n_dst, C, H, lpe, K)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_EXPAND(8); } break;
    case 4: GAMMAGL_EXPAND(4); break;
    case 2: GAMMAGL_EXPAND(2); break;
    default: GAMMAGL_EXPAND(1); break;
  }
#undef GAMMAGL_EXPAND
}

// V: the widest load (16 bytes at most) that divides F and to which a
// and xd are aligned; Lh lanes a head, the heads of a pass filling at most
// 32 lanes.
template <typename T>
int pick_sddmm_geom(int64_t H, int64_t F, const void* a, const void* xd,
                    SddmmGeom* g) {
  const void* ptrs[] = {a, xd};
  const int V = pick_vec<T>(F, ptrs, 2);
  const int64_t per_head = F / V;
  int lh = 0;
  while (lh < 5 && (int64_t{1} << lh) < per_head) ++lh;
  int heads = 1;
  while ((heads << lh) < kWarp && heads < H) heads *= 2;
  int lg = lh;
  while ((1 << lg) < (heads << lh)) ++lg;
  g->H = H;
  g->F = F;
  g->lg = lg;
  g->lh = lh;
  g->K = static_cast<int>((per_head + (int64_t{1} << lh) - 1) >> lh);
  g->heads = heads;
  g->passes = static_cast<int>((H + heads - 1) / heads);
  return V;
}

template <typename T>
void launch_sddmm(const void* a, const void* xd, const int64_t* item_ptr,
                  const int2* item_meta, int64_t n_items, const int32_t* col,
                  float* out, int64_t H, int64_t F, int gather,
                  cudaStream_t stream) {
  SddmmGeom g;
  const int V = pick_sddmm_geom<T>(H, F, a, xd, &g);
  const dim3 grid = grid_of(n_items, g.lg);
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(xd);
#define GAMMAGL_SDDMM_LAUNCH(...)                                         \
  __VA_ARGS__<<<grid, kThreads, 0, stream>>>(at, xt, item_ptr, item_meta,  \
                                             n_items, col, out, g)
#define GAMMAGL_SDDMM(VV)                                                  \
  if (g.K > 1 && gather)                                                   \
    GAMMAGL_SDDMM_LAUNCH(sddmm_wide_kernel<T, VV, true>);                  \
  else if (g.K > 1)                                                        \
    GAMMAGL_SDDMM_LAUNCH(sddmm_wide_kernel<T, VV, false>);                 \
  else if ((1 << g.lh) >= kSddmmBatch && gather)                           \
    GAMMAGL_SDDMM_LAUNCH(sddmm_kernel<T, VV, true, kSddmmBatch>);          \
  else if ((1 << g.lh) >= kSddmmBatch)                                     \
    GAMMAGL_SDDMM_LAUNCH(sddmm_kernel<T, VV, false, kSddmmBatch>);         \
  else if (gather)                                                         \
    GAMMAGL_SDDMM_LAUNCH(sddmm_kernel<T, VV, true, 1>);                    \
  else                                                                     \
    GAMMAGL_SDDMM_LAUNCH(sddmm_kernel<T, VV, false, 1>)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_SDDMM(8); } break;
    case 4: GAMMAGL_SDDMM(4); break;
    case 2: GAMMAGL_SDDMM(2); break;
    default: GAMMAGL_SDDMM(1); break;
  }
#undef GAMMAGL_SDDMM
#undef GAMMAGL_SDDMM_LAUNCH
}

}  // namespace

extern "C" {

// x: (n_dst, C) bf16 (is_bf16 != 0) or f32, contiguous; scale: (E, H) f32
// in CSR order with C % H == 0, or null for a plain copy; rowptr: (n_dst +
// 1,) int64; out: (E, C) of x's type, in CSR order. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise.
int gammagl_expand_csr(const void* x, const void* scale, const void* rowptr,
                       void* out, int64_t n_dst, int64_t C, int64_t H,
                       int is_bf16, void* stream) {
  if (n_dst < 0 || C < 0 || H < 1 || (C > 0 && C % H != 0) ||
      grid_too_large(n_dst))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && C > 0) {
    const float* sc = static_cast<const float*>(scale);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_expand<__nv_bfloat16>(x, sc, rp, out, n_dst, C, H, s);
    else
      launch_expand<float>(x, sc, rp, out, n_dst, C, H, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// a: (rows, H*F) bf16 (is_bf16 != 0) or f32, contiguous, whose rows are
// node rows read at col[e] (gather != 0) or edges in CSR order (gather ==
// 0); xd: (n_dst, H*F) of a's type; col: (E,) int32; out: (E, H) f32 in
// CSR order. The items, as gammagl_spmm_csr's at the wrappers' item size:
// item_ptr (n_items + 1,) int64 edge offsets; item_meta (n_items, 2) int32
// {row, slot}, of which only the row is read, or null (item i is row i,
// item_ptr the plan's rowptr). An item has at most 2^31 / K edges, K the
// column chunks of a lane (ceil(F / (32 V)) where F > 32 V). Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int gammagl_sddmm_csr(const void* a, const void* xd, const void* item_ptr,
                      const void* item_meta, int64_t n_items,
                      const void* col, void* out, int64_t H, int64_t F,
                      int gather, int is_bf16, void* stream) {
  if (n_items < 0 || H < 1 || F < 1 || !grid_ok(n_items, 5) ||
      (n_items > 0 && item_ptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0) {
    const int64_t* ip = static_cast<const int64_t*>(item_ptr);
    const int2* im = static_cast<const int2*>(item_meta);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_sddmm<__nv_bfloat16>(a, xd, ip, im, n_items, cl, of, H, F,
                                  gather, s);
    else
      launch_sddmm<float>(a, xd, ip, im, n_items, cl, of, H, F, gather, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
