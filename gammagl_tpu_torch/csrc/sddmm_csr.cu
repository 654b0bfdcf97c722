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
//  * expand: the work items of the CSR kernels' schedule, cut at the
//    wrapper's EDGE_SPLIT edges, one warp an item: a hub row (a
//    1,200,000-edge star) is spread over thousands of warps, and since an
//    item writes only its own edges, nothing is folded and the output is
//    written once (repeats are bitwise equal);
//  * expand: an item's output out[lo*C, hi*C) is one contiguous run of
//    memory whatever C is, and element j of it is x[row, j mod C]. The
//    lanes store it in 16-byte chunks, lane l the chunks l, l + 32, ...,
//    from the run's first 16-byte boundary on (a scalar prologue before
//    it, a scalar epilogue after the last whole chunk), so a row whose
//    bytes are no multiple of 16 (C = 349 f32: 1396 bytes) still takes
//    16-byte stores and every lane works; a lane's column and edge move
//    by fixed increments from one chunk to the next, with no division in
//    the loop. A chunk is assembled from the row, read through L1 (the
//    two aligned 16-byte blocks that hold it, shifted into place; one
//    element at a time only where it wraps to the row's start). Without a
//    scale the bits are copied, not converted: the result is bitwise
//    equal to x[row(e)]. Rows of a multiple of 16 bytes on aligned
//    pointers take their own instance, whose chunks are single loads;
//  * expand, scaled: where a head is a multiple of 16 bytes wide on
//    aligned rows (GATv2's (8, 8) in bf16), a chunk lies in one head and
//    reads its scale once, in its own instance (a scale an element is
//    slower there, PERF.md section 6); other widths read a scale an
//    element. Each product is rounded once;
//  * sddmm: the work items of the CSR kernels' schedule (csrc/
//    csr_items.cuh), cut at the same EDGE_SPLIT edges, much shorter
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
// items are short (PERF.md). TMA stores are left for later: the expand's
// 16-byte stores from registers are one instruction a lane for 16 bytes.

#include "csr_items.cuh"

namespace {

// Item i's row (row i where the plan has no cut rows) and edges: the
// SDDMM's and the expand's work items.
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

// The expand's geometry: C columns in H heads of Fh; a lane's column and
// edge move by inc_c and inc_e (and one more edge where the column wraps)
// from one of its 16-byte chunks to the next, kWarp chunks on.
struct ExpandGeom {
  int C, H, Fh;
  int inc_c;  // (kWarp P) mod C
  int inc_e;  // (kWarp P) div C
};

// The P elements of T at columns c .. c + P - 1 of a row (wrapping to
// its start), as the 16 bytes one store writes. A run that lies in the
// row is read as the two aligned 16-byte blocks that hold it, each of
// which holds a byte of the row, and shifted into place (bits moved,
// never converted); a run that wraps (or a row narrower than P) is read
// element by element.
template <typename T>
__device__ __forceinline__ uint4 row_chunk(const T* __restrict__ xrow, int c,
                                           int C) {
  constexpr int P = 16 / sizeof(T);
  unsigned w[4];
  if (c + P <= C) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(xrow + c);
    const uint4* blk = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
    const int s = static_cast<int>(a & 15);  // a multiple of sizeof(T)
    const uint4 u0 = __ldg(blk);
    const uint4 u1 = s != 0 ? __ldg(blk + 1) : u0;
    const unsigned b[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    const int ws = s >> 2, sh = (s & 3) * 8;
    unsigned v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      v[k] = ws & 2 ? (ws & 1 ? b[k + 3] : b[k + 2])
                    : (ws & 1 ? b[k + 1] : b[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(v[k], v[k + 1], sh);
  } else {
    using Raw = typename RawBits<sizeof(T)>::type;
    const Raw* r = reinterpret_cast<const Raw*>(xrow);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = 0u;
    int cc = c;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const unsigned bits = __ldg(r + cc);
      if constexpr (sizeof(T) == 4)
        w[i] = bits;
      else
        w[i / 2] |= bits << (16 * (i % 2));
      if (++cc == C) cc = 0;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The P values of a chunk as f32.
template <typename T>
__device__ __forceinline__ void chunk_values(const uint4& u,
                                             float (&f)[16 / sizeof(T)]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      f[k] = __uint_as_float(w[k]);
    } else {  // little-endian: low half first
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// Round P f32 values once to T and store them as one 16-byte chunk at dst
// (16-byte aligned), marked evict-first (st.global.cs): the expand's
// output streams through L2 once, and leaves it to the rows of x.
template <typename T>
__device__ __forceinline__ void store_chunk(T* dst,
                                            const float (&o)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(o[0], o[1], o[2], o[3]));
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bf16_bits(o[2 * k]) | (bf16_bits(o[2 * k + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// out[e, c] alone (the scalar prologue and epilogue of an item's run).
template <typename T, bool kScale>
__device__ __forceinline__ void expand_one(const T* __restrict__ xrow,
                                           const float* __restrict__ scale,
                                           T* __restrict__ out, int64_t e,
                                           int c, const ExpandGeom& g) {
  T* dst = out + e * g.C + c;
  if constexpr (kScale) {
    float v[1];
    load_vec<T, 1>(xrow + c, v);
    v[0] *= __ldg(scale + e * g.H + c / g.Fh);
    store_vec<T, 1>(dst, v);
  } else {
    using Raw = typename RawBits<sizeof(T)>::type;
    *reinterpret_cast<Raw*>(dst) =
        __ldg(reinterpret_cast<const Raw*>(xrow) + c);
  }
}

// One warp per work item (at most the wrapper's EDGE_SPLIT consecutive
// CSR edges of one row). Its output out[lo*C, hi*C) is one contiguous run
// of n*C elements, whatever C is, and element j of it is x[row, j mod C].
// From the run's first 16-byte boundary on, the warp stores 32 16-byte
// chunks a round, a chunk a lane, evict-first (each round one aligned
// 512-byte span where rows are no multiple of 16 bytes); a lane's column
// and edge are stepped by the geometry's increments (no division in the
// loop). Lanes 0..P-2 store the elements before that boundary and lanes
// 8.. those after the last whole chunk, one by one. kAligned (C a
// multiple of P, x and out on 16 bytes): every chunk starts a row's
// 16-byte block, so nothing is stored one by one and a chunk is one load
// of x. kScale: out = scale[e, c / Fh] * x, rounded once;
// kHeadChunk (kAligned and Fh a multiple of P): a chunk lies in one head,
// so it takes one scale (else one an element).
template <typename T, bool kScale, bool kAligned, bool kHeadChunk>
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const int64_t* __restrict__ item_ptr,
                  const int2* __restrict__ item_meta, int64_t n_items,
                  T* __restrict__ out, ExpandGeom g) {
  constexpr int P = 16 / sizeof(T);
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  // no shuffles below, so lanes may leave on their own
  if (item >= n_items) return;
  const int lane = threadIdx.x % kWarp;
  const SddmmItem it = sddmm_item(item_ptr, item_meta, item);
  const T* xrow = x + it.row * g.C;
  T* run = out + it.lo * g.C;
  const int64_t len = it.n * g.C;
  int pro = 0;  // elements before the run's first 16-byte boundary
  if constexpr (!kAligned) {
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(run) & 15);
    pro = ((16 - off) & 15) / static_cast<int>(sizeof(T));
    if (pro > len) pro = static_cast<int>(len);
  }
  const int64_t chunks = (len - pro) / P;
  if constexpr (!kAligned) {
    // fewer than P elements each side: the prologue's element j at edge
    // j / C, the epilogue's m-th from the run's end at edge n - 1 - (m -
    // 1) / C (32-bit divisions of small numbers, once an item)
    const int tail = static_cast<int>(len - pro - chunks * P);
    if (lane < pro) {
      expand_one<T, kScale>(xrow, scale, out, it.lo + lane / g.C,
                            lane % g.C, g);
    } else if (lane >= 8 && lane - 8 < tail) {
      const int m = lane - 7;
      expand_one<T, kScale>(xrow, scale, out,
                            it.lo + it.n - 1 - (m - 1) / g.C,
                            g.C - 1 - (m - 1) % g.C, g);
    }
  }
  // chunk q lies 16 q bytes past the run's first 16-byte boundary, in
  // the 16-byte slot (q + r) mod 32 of an aligned 512-byte span. Where
  // rows are no multiple of 16 bytes, runs start at any slot: lane l takes
  // the chunks l - r + 32 t (a lane l < r idles the first round), so each
  // round of the warp's stores fills one aligned span, whole 32-byte
  // sectors, but at an item's two ends. Aligned rows keep r = 0 (lane l
  // on chunk l): their short items would pay the extra round (PERF.md).
  int r = 0;
  if constexpr (!kAligned)
    r = static_cast<int>((reinterpret_cast<uintptr_t>(run + pro) >> 4) &
                         (kWarp - 1));
  const int q0 = lane - r;
  const int qf = q0 < 0 ? q0 + kWarp : q0;  // the lane's first chunk
  if (qf >= chunks) return;
  // its first element: pro + qf P < 8 + 32 P of the run
  const int j = pro + qf * P;
  int64_t e = j / g.C;
  int c = j - static_cast<int>(e) * g.C;
  const bool moves = g.inc_c != 0;  // else the lane keeps its column
  uint4 bits;
  float xv[P];
  for (int64_t q = q0; q < chunks; q += kWarp) {
    if (q < 0) continue;
    if (moves || q == qf) {
      if constexpr (kAligned)
        bits = __ldg(reinterpret_cast<const uint4*>(xrow + c));
      else
        bits = row_chunk<T>(xrow, c, g.C);
      if constexpr (kScale) chunk_values<T>(bits, xv);
    }
    T* dst = run + pro + q * P;
    if constexpr (kScale) {
      const float* srow = scale + (it.lo + e) * g.H;
      int h = c / g.Fh;
      float o[P];
      if constexpr (kHeadChunk) {
        const float sc = __ldg(srow + h);
#pragma unroll
        for (int i = 0; i < P; ++i) o[i] = sc * xv[i];
      } else {
        // heads narrower than a chunk, or chunks across rows: a scale an
        // element (L1 hits; a load under the head's branch spilled)
        int ch = c - h * g.Fh;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          o[i] = __ldg(srow + h) * xv[i];
          if (++ch == g.Fh) {
            ch = 0;
            if (++h == g.H) {
              h = 0;
              srow += g.H;
            }
          }
        }
      }
      store_chunk<T>(dst, o);
    } else {
      __stcs(reinterpret_cast<uint4*>(dst), bits);
    }
    c += g.inc_c;
    e += g.inc_e;
    if (c >= g.C) {
      c -= g.C;
      ++e;
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
  // steps index in 32 bits: an item has at most EDGE_SPLIT edges
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
void launch_expand(const void* x, const float* scale, const int64_t* item_ptr,
                   const int2* item_meta, int64_t n_items, void* out,
                   int64_t C, int64_t H, cudaStream_t stream) {
  constexpr int P = 16 / sizeof(T);
  ExpandGeom g;
  g.C = static_cast<int>(C);
  g.H = static_cast<int>(H);
  g.Fh = static_cast<int>(C / H);
  g.inc_c = static_cast<int>((kWarp * P) % C);
  g.inc_e = static_cast<int>((kWarp * P) / C);
  const bool aligned_rows =
      C % P == 0 && aligned(x, 16) && aligned(out, 16);
  const dim3 grid = grid_of(n_items, 5);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
#define GAMMAGL_EXPAND(...)                                               \
  __VA_ARGS__<<<grid, kThreads, 0, stream>>>(xt, scale, item_ptr,         \
                                             item_meta, n_items, ot, g)
  if (scale == nullptr && aligned_rows)
    GAMMAGL_EXPAND(expand_kernel<T, false, true, false>);
  else if (scale == nullptr)
    GAMMAGL_EXPAND(expand_kernel<T, false, false, false>);
  else if (aligned_rows && g.Fh % P == 0)
    GAMMAGL_EXPAND(expand_kernel<T, true, true, true>);
  else if (aligned_rows)
    GAMMAGL_EXPAND(expand_kernel<T, true, true, false>);
  else
    GAMMAGL_EXPAND(expand_kernel<T, true, false, false>);
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

// x: (n_dst, C) bf16 (is_bf16 != 0) or f32, contiguous, aligned to its
// element; scale: (E, H) f32 in CSR order with C % H == 0, or null for a
// plain copy; out: (E, C) of x's type, in CSR order, aligned to its
// element. The items, as gammagl_sddmm_csr's at the wrappers' item size:
// item_ptr (n_items + 1,) int64 edge offsets; item_meta (n_items, 2)
// int32 {row, slot}, of which only the row is read, or null (item i is
// row i, item_ptr the plan's rowptr). C and H fit int32. Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int gammagl_expand_csr(const void* x, const void* scale, const void* item_ptr,
                       const void* item_meta, int64_t n_items, void* out,
                       int64_t C, int64_t H, int is_bf16, void* stream) {
  if (n_items < 0 || C < 0 || C > 0x7fffffff || H < 1 ||
      (C > 0 && C % H != 0) || !grid_ok(n_items, 5) ||
      (n_items > 0 && item_ptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items > 0 && C > 0) {
    const float* sc = static_cast<const float*>(scale);
    const int64_t* ip = static_cast<const int64_t*>(item_ptr);
    const int2* im = static_cast<const int2*>(item_meta);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_expand<__nv_bfloat16>(x, sc, ip, im, n_items, out, C, H, s);
    else
      launch_expand<float>(x, sc, ip, im, n_items, out, C, H, s);
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
