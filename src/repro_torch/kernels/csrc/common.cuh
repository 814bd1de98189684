// Device helpers shared by the port's kernels: loads that widen f32 or
// bf16 to f32 registers, stores that narrow back, a warp sum, cp.async
// copies into shared memory, and the merge of split-KV decode partials.
// Each kernel source includes this header and compiles alone.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// 16 bytes at p (16-byte aligned) as raw bits, and those bits as f32
// registers: 4 floats or 8 bf16 values.
__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void to_float(uint4 raw, float (&o)[4]) {
  o[0] = __uint_as_float(raw.x); o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z); o[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void to_float(uint4 raw, float (&o)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies from global into shared memory that bypass the
// registers, in commit groups a thread can wait on.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Split-KV merge.  A decode kernel that splits a row's keys over `splits`
// CTAs leaves, per query row (b, head) and split s, the partial softmax
// state of the keys it saw: m (the running max, in log2 units: score *
// scale * log2(e)), l (the sum of exp2(score - m)) and acc (the sum of
// exp2(score - m) * v, unnormalised), at
//   part_ml[row * splits + s]              = (m, l)
//   part_acc[(row * splits + s) * dh + d]  = acc[d]
// A split with no valid key writes m = NEG_INF, l = 0 and no acc; the
// merge never reads its acc, and its weight exp2(m - M) * l is 0 anyway.
// out[row] = sum_s exp2(m_s - M) acc_s / sum_s exp2(m_s - M) l_s, with M
// the largest m_s; a row with no valid key in any split comes out as
// zeros.  One CTA per row, one thread per element of the head dim.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void split_merge_kernel(const float* __restrict__ part_acc,
                                   const float2* __restrict__ part_ml,
                                   T* __restrict__ out, int splits, int dh) {
  const int64_t row = blockIdx.x;
  const float2* ml = part_ml + row * splits;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s].x);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 f = ml[s];
      if (f.y > 0.f) {
        const float w = exp2f(f.x - mx);
        lsum += f.y * w;
        a += part_acc[(row * splits + s) * dh + d] * w;
      }
    }
    store_one(out + row * dh + d, lsum > 0.f ? a / lsum : 0.f);
  }
}

}  // namespace
