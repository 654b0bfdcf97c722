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
//  * one warp per destination row, which holds its row of x (or xd) in
//    registers and walks the row's edges, so the row is read once;
//  * expand: the lanes split into groups of `lpe` lanes, one group per
//    edge, each lane moving V columns (up to 16 bytes) of that edge; a warp
//    writes 32 / lpe edges at a time, in whole rows, so the stores coalesce.
//    Without a scale the bits are copied, not converted: the result is
//    bitwise equal to x[row(e)];
//  * sddmm: the lanes lie over the H*F columns with the lanes of one head in
//    an aligned group of L lanes (the layout of flash_attention.cu), each
//    lane's partial dot reduced by L-lane xor shuffles; the warp reads 32 col
//    indices with one load and hands them out by shuffle, and loads kUnroll
//    rows before it reduces them. A head wider than L*V columns loops over
//    column chunks and adds each chunk's sum into the score in order;
//  * sums in f32, in a fixed order, no atomics: repeats are bitwise equal.
// Several short rows per warp, load balancing for skewed degrees and TMA
// stores are left for later.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // edges whose rows the sddmm loads at once

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

// One warp per destination row; writes out[e, h] for the row's edges.
template <typename T, int V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    sddmm_kernel(const T* __restrict__ a, const T* __restrict__ xd,
                 const int64_t* __restrict__ rowptr,
                 const int32_t* __restrict__ col, float* __restrict__ out,
                 int64_t n_dst, Layout g, int gather) {
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
      const int64_t off = (ln.head ? ln.h : 0) * g.F + ln.cin;
      float xv[V];
      if (ln.cols) load_vec<T, V>(xd + row * HF + off, xv);

      for (int64_t base = begin; base < end; base += kWarp) {
        const int64_t left = end - base;
        const int n = left < kWarp ? static_cast<int>(left) : kWarp;
        const int my_col = gather && lane < n ? __ldg(col + base + lane) : 0;
        for (int j = 0; j < n; j += kUnroll) {
          // lanes past the row's last edge reduce zeros and store nothing
          float v[kUnroll][V], part[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int jj = j + u < n ? j + u : 0;
            const int src = __shfl_sync(kFullMask, my_col, jj);
            const int64_t r = gather ? static_cast<int64_t>(src) : base + j + u;
            part[u] = 0.f;
            if (ln.cols && j + u < n) load_vec<T, V>(a + r * HF + off, v[u]);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (ln.cols && j + u < n) {
#pragma unroll
              for (int i = 0; i < V; ++i) part[u] = fmaf(v[u][i], xv[i], part[u]);
            }
            const float s = group_sum(part[u], g.L);
            if (ln.leader && j + u < n) {
              float* o = out + (base + j + u) * g.H + ln.h;
              *o = k == 0 ? s : *o + s;
            }
          }
        }
      }
    }
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

template <typename T>
void launch_sddmm(const void* a, const void* xd, const int64_t* rowptr,
                  const int32_t* col, float* out, int64_t n_dst, int64_t H,
                  int64_t F, int gather, cudaStream_t stream) {
  const void* ptrs[] = {a, xd};
  Layout g;
  const int V = pick_layout<T>(H, F, ptrs, 2, &g);
  const dim3 block(kWarp * kWarpsPerBlock);
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(xd);
#define GAMMAGL_SDDMM(VV)                                          \
  sddmm_kernel<T, VV><<<grid_for(n_dst), block, 0, stream>>>(      \
      at, xt, rowptr, col, out, n_dst, g, gather)
  switch (V) {
    case 8: if constexpr (16 / sizeof(T) >= 8) { GAMMAGL_SDDMM(8); } break;
    case 4: GAMMAGL_SDDMM(4); break;
    case 2: GAMMAGL_SDDMM(2); break;
    default: GAMMAGL_SDDMM(1); break;
  }
#undef GAMMAGL_SDDMM
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
// 0); xd: (n_dst, H*F) of a's type; rowptr: (n_dst + 1,) int64; col: (E,)
// int32; out: (E, H) f32 in CSR order. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int gammagl_sddmm_csr(const void* a, const void* xd, const void* rowptr,
                      const void* col, void* out, int64_t n_dst, int64_t H,
                      int64_t F, int gather, int is_bf16, void* stream) {
  if (n_dst < 0 || H < 1 || F < 1 || grid_too_large(n_dst))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0) {
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      launch_sddmm<__nv_bfloat16>(a, xd, rp, cl, of, n_dst, H, F, gather, s);
    else
      launch_sddmm<float>(a, xd, rp, cl, of, n_dst, H, F, gather, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
