// Device helpers shared by the port's kernels: loads that widen f32 or
// bf16 to f32 registers, stores that narrow back, and a warp sum.  Each
// kernel source includes this header and compiles alone.
#pragma once

#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;

// N consecutive elements at p (aligned to N elements) into f32 registers.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&o)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      o[i] = f.x; o[i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace
