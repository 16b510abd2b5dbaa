// Small device helpers shared by the kernels of this directory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;      // finite on purpose, as in the reference
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// N contiguous elements of T -> f32, with the widest aligned loads N allows.
// `p` must be aligned to min(16, N·sizeof(T)) bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  } else if constexpr (BYTES == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  } else if constexpr (BYTES == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(p[e]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

}  // namespace repro
