// Helpers shared by the package's kernels: vector loads and stores that
// widen bf16 to f32, cp.async copies into shared memory, the per-head lane
// layout of a warp over one row of H heads of F columns, and grid sizing
// for one warp per destination row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// One load of U at p: through the read-only data cache (__ldg) by default;
// a plain load when kLdg is false, for memory the same kernel also writes.
template <bool kLdg, typename U>
__device__ __forceinline__ U ld(const U* p) {
  if constexpr (kLdg) return __ldg(p);
  return *p;
}

// Load V consecutive elements at p (aligned to V elements) as f32.
template <typename T, int V, bool kLdg = true>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      const float4 v = ld<kLdg>(reinterpret_cast<const float4*>(p));
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = ld<kLdg>(reinterpret_cast<const float2*>(p));
      f[0] = v.x; f[1] = v.y;
    } else {
      f[0] = ld<kLdg>(p);
    }
  } else {
    constexpr int kWords = V / 2;
    unsigned words[kWords > 0 ? kWords : 1];
    if constexpr (V == 8) {
      const uint4 r = ld<kLdg>(reinterpret_cast<const uint4*>(p));
      words[0] = r.x; words[1] = r.y; words[2] = r.z; words[3] = r.w;
    } else if constexpr (V == 4) {
      const uint2 r = ld<kLdg>(reinterpret_cast<const uint2*>(p));
      words[0] = r.x; words[1] = r.y;
    } else if constexpr (V == 2) {
      words[0] = ld<kLdg>(reinterpret_cast<const unsigned*>(p));
    }
    if constexpr (V == 1) {
      f[0] = __uint_as_float(
          static_cast<unsigned>(
              ld<kLdg>(reinterpret_cast<const unsigned short*>(p)))
          << 16);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {  // little-endian: low half first
        f[2 * i] = __uint_as_float(words[i] << 16);
        f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    }
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Round V f32 values once to T and store them at p (aligned to V elements).
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&f)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      p[0] = f[0];
    }
  } else {
    if constexpr (V == 1) {
      p[0] = __float2bfloat16_rn(f[0]);
    } else {
      constexpr int kWords = V / 2;
      unsigned words[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        words[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
      if constexpr (V == 8)
        *reinterpret_cast<uint4*>(p) =
            make_uint4(words[0], words[1], words[2], words[3]);
      else if constexpr (V == 4)
        *reinterpret_cast<uint2*>(p) = make_uint2(words[0], words[1]);
      else
        *reinterpret_cast<unsigned*>(p) = words[0];
    }
  }
}

// Copy V elements of T (16, 8, 4 or 2 bytes, aligned to their size) from
// global memory into shared memory at dst: cp.async through L1, or a plain
// load and store for a lone bf16, which no async copy carries.
template <typename T, int V>
__device__ __forceinline__ void stage_copy(void* dst, const T* src) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes)
                 : "memory");
  } else {  // one bf16: no async copy of 2 bytes
    static_assert(kBytes == 2, "unsupported row piece");
    *static_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this lane's committed stages are in flight.
template <int N>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bits of B bytes (2, 4, 8 or 16), moved with one load or store.
template <int B> struct RawBits;
template <> struct RawBits<2> { using type = unsigned short; };
template <> struct RawBits<4> { using type = unsigned; };
template <> struct RawBits<8> { using type = uint2; };
template <> struct RawBits<16> { using type = uint4; };

// Sum over the aligned group of L lanes; every lane of the group gets the
// same bits (each butterfly step adds the same two values in either order).
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int off = L / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// How a warp lays its lanes over one row of H heads of F columns.
struct Layout {
  int64_t H, F;
  int L;       // lanes per head: a power of two, at most 32
  int K;       // column chunks per head: ceil(F / (L * V))
  int passes;  // head passes: ceil(H / (32 / L))
};

// Geometry of one lane in head pass `pass` and column chunk `k`.
struct Lane {
  int64_t h;    // head
  int64_t cin;  // first column within the head
  bool head;    // h < H
  bool cols;    // head && cin < F
  bool leader;  // the group's first lane: writes the per-head results
};

template <int V>
__device__ __forceinline__ Lane lane_at(const Layout& g, int lane, int pass,
                                        int k) {
  Lane r;
  r.h = static_cast<int64_t>(pass) * (kWarp / g.L) + lane / g.L;
  r.cin = (static_cast<int64_t>(k) * g.L + lane % g.L) * V;
  r.head = r.h < g.H;
  r.cols = r.head && r.cin < g.F;
  r.leader = r.head && lane % g.L == 0;
  return r;
}

inline bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The layout with the fewest (head pass x column chunk) trips over a row's
// edges, and among those the narrowest loads (the most lanes at work). V
// must divide F, and every row pointer must be aligned to V elements.
template <typename T>
int pick_layout(int64_t H, int64_t F, const void* const* ptrs, int n_ptrs,
                Layout* out) {
  constexpr int kMaxV = 16 / sizeof(T);
  int best_v = 0;
  int64_t best_trips = 0;
  for (int V = 1; V <= kMaxV; V *= 2) {
    if (F % V != 0) continue;
    bool ok = true;
    for (int i = 0; i < n_ptrs; ++i)
      ok = ok && aligned(ptrs[i], V * static_cast<int>(sizeof(T)));
    if (!ok) continue;
    const int64_t per_head = (F + V - 1) / V;
    int L = 1;
    while (L < kWarp && L < per_head) L *= 2;
    const int64_t K = (F + static_cast<int64_t>(L) * V - 1) / (L * V);
    const int64_t passes = (H + kWarp / L - 1) / (kWarp / L);
    if (best_v == 0 || K * passes < best_trips) {
      best_v = V;
      best_trips = K * passes;
      out->L = L;
      out->K = static_cast<int>(K);
      out->passes = static_cast<int>(passes);
    }
  }
  out->H = H;
  out->F = F;
  return best_v;
}

// The widest V (16 bytes at most) that divides C and to which every row
// pointer is aligned.
template <typename T>
int pick_vec(int64_t C, const void* const* ptrs, int n_ptrs) {
  for (int V = 16 / static_cast<int>(sizeof(T)); V > 1; V /= 2) {
    if (C % V != 0) continue;
    bool ok = true;
    for (int i = 0; i < n_ptrs; ++i)
      ok = ok && aligned(ptrs[i], V * static_cast<int>(sizeof(T)));
    if (ok) return V;
  }
  return 1;
}

// One warp per destination row.
inline dim3 grid_for(int64_t n_dst) {
  return dim3(
      static_cast<unsigned>((n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

inline bool grid_too_large(int64_t n_dst) {
  return (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffff;
}

}  // namespace
