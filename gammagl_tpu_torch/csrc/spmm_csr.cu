// CSR SpMM for Hopper (sm_90a), with a plain C interface loaded by ctypes.
//
//   out[d, :] = sum_{e in [rowptr[d], rowptr[d+1])} w[e] * x[col[e], :]
//
// Replaces the TPU kernels of gammagl_tpu/ops/pallas/segment_matmul.py that
// compute this one function in three layouts: segment_matmul_dyn (:243),
// _spmm_win_forward (:774, _packed_win_kernel and _plain_win_kernel) and
// _spmm_packed_forward (:686, _packed_kernel). Their one-hot matmuls, packed
// bf16 halves and window plans fit the TPU's matrix unit and gather engine;
// here the destination-sorted CSR is read directly.
//
// What bounds it on the card: bytes. Every edge reads one random row of x
// (F elements) and does 2 flops per element read, far below the ridge
// point of the H100. At the ogbn-arxiv shape (2.48M edges with self-loops,
// F = 256, bf16) the gather is about 1.27 GB per call, against about 0.09 GB
// of output and 0.03 GB of CSR arrays.
//
// What this simple design does about it:
//  * one warp per destination row; its lanes cover the feature columns
//    with 16-byte loads where F and the pointers allow (8 bf16 or 4 f32
//    columns a lane), so each gathered row is read in whole 32-byte sectors;
//    otherwise one column a lane with scalar loads;
//  * a loop over column chunks when F is wider than one warp pass;
//  * the warp reads 32 (col, w) pairs with one coalesced load and hands
//    them out by shuffle;
//  * kUnroll rows are loaded before they are summed, so each warp keeps
//    several gathers in flight;
//  * sums are kept in f32 registers in CSR edge order, and out is written
//    once, rounded once. No atomics: the result is deterministic.
// Row blocking, load balancing for skewed degrees, TMA and an L2-aware edge
// order are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Load V consecutive elements of x at p and widen them to f32. V is
// 16 / sizeof(T) on the vector path (p 16-byte aligned) and 1 otherwise.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = __ldg(p + i);
    }
  } else {
    if constexpr (V == 8) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // little-endian: low half comes first
        f[2 * i] = __uint_as_float(words[i] << 16);
        f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = bf16_bits_to_float(__ldg(q + i));
    }
  }
}

// Round V f32 sums once to T and store them at p.
template <typename T, int V>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p,
                                               const float (&f)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = f[i];
    }
  } else {
    if constexpr (V == 8) {
      unsigned words[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        words[i] = float_to_bf16_bits(f[2 * i]) |
                   (float_to_bf16_bits(f[2 * i + 1]) << 16);
      *reinterpret_cast<uint4*>(p) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(f[i]);
    }
  }
}

// One warp per destination row. w may be null: every weight is then 1.
template <typename T, int V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    spmm_csr_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const int64_t* __restrict__ rowptr,
                    const int32_t* __restrict__ col, T* __restrict__ out,
                    int64_t n_dst, int64_t F) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];

  // Every lane runs every chunk, so the shuffles below see the full warp.
  for (int64_t chunk = 0; chunk < F; chunk += kWarp * V) {
    const int64_t c = chunk + static_cast<int64_t>(lane) * V;
    const bool active = c < F;  // V divides F whenever V > 1
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;

    for (int64_t base = begin; base < end; base += kWarp) {
      const int64_t left = end - base;
      const int n = left < kWarp ? static_cast<int>(left) : kWarp;
      int my_col = 0;
      float my_w = 0.f;
      if (lane < n) {
        my_col = __ldg(col + base + lane);
        my_w = w != nullptr ? __ldg(w + base + lane) : 1.f;
      }
      int j = 0;
      for (; j + kUnroll <= n; j += kUnroll) {
        float v[kUnroll][V];
        float wj[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(kFullMask, my_col, j + u);
          wj[u] = __shfl_sync(kFullMask, my_w, j + u);
          if (active) load_f32<T, V>(x + static_cast<int64_t>(s) * F + c, v[u]);
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(wj[u], v[u][i], acc[i]);
        }
      }
      for (; j < n; ++j) {
        const int s = __shfl_sync(kFullMask, my_col, j);
        const float wv = __shfl_sync(kFullMask, my_w, j);
        if (active) {
          float v[V];
          load_f32<T, V>(x + static_cast<int64_t>(s) * F + c, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(wv, v[i], acc[i]);
        }
      }
    }
    if (active) store_from_f32<T, V>(out + row * F + c, acc);
  }
}

template <typename T>
void launch(const void* x, const float* w, const int64_t* rowptr,
            const int32_t* col, void* out, int64_t n_dst, int64_t F,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(
      static_cast<unsigned>((n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const bool vec = F % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    spmm_csr_kernel<T, kVec>
        <<<grid, block, 0, stream>>>(xt, w, rowptr, col, ot, n_dst, F);
  else
    spmm_csr_kernel<T, 1>
        <<<grid, block, 0, stream>>>(xt, w, rowptr, col, ot, n_dst, F);
}

}  // namespace

extern "C" {

// x: (N_src, F) bf16 (x_is_bf16 != 0) or f32, contiguous; w: (E,) f32 in
// CSR order, or null for unit weights; rowptr: (n_dst + 1,) int64;
// col: (E,) int32; out: (n_dst, F) of x's type. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int gammagl_spmm_csr(const void* x, const void* w, const void* rowptr,
                     const void* col, void* out, int64_t n_dst, int64_t F,
                     int x_is_bf16, void* stream) {
  if (n_dst < 0 || F < 0 ||
      (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && F > 0) {
    const float* wf = static_cast<const float*>(w);
    const int64_t* rp = static_cast<const int64_t*>(rowptr);
    const int32_t* cl = static_cast<const int32_t*>(col);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch<__nv_bfloat16>(x, wf, rp, cl, out, n_dst, F, s);
    else
      launch<float>(x, wf, rp, cl, out, n_dst, F, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gammagl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
