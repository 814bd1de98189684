// Device helpers shared by the port's kernels: loads that widen f32 or
// bf16 to f32 registers, stores that narrow back, a warp sum, cp.async
// copies into shared memory, the split-KV decode core that the ring and
// the paged decode kernels share, and the merge of its partials.  Each
// kernel source includes this header and compiles alone.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <typename T>
cudaError_t launch_split_merge(const float* part_acc, const float2* part_ml,
                               T* out, int rows, int splits, int dh,
                               cudaStream_t stream) {
  split_merge_kernel<T><<<rows, dh, 0, stream>>>(part_acc, part_ml, out,
                                                 splits, dh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The split-KV decode core of the ring and the paged decode kernels.  A
// CTA of NWARPS warps takes up to G query heads of one KV head (the whole
// GQA group, or a chunk of it, as the wrapper's group_chunk chooses) for
// one query token, over a range of keys that each warp splits further.
//
// Head dims.  A lane loads 16 bytes of a K/V row (VEC elements), so LPR
// = DH / VEC lanes cover a row of the DH-wide instantiation (32, 64 or
// 128) and a warp loads RPW = 32 / LPR rows at once.  Any dh <= DH that
// is a multiple of 8 runs on it: the lanes past dh skip their loads and
// hold zeros, and every row is addressed with the real dh, so q, the
// pool and the rings are read in place and nothing is padded in memory
// (dh 112 and 120 run on the 128 instantiation with 14 or 15 of a row's
// 16 bf16 lanes busy).  A multiple of 8 keeps every row start 16-byte
// aligned in f32 and bf16.
// ---------------------------------------------------------------------------

// the instantiated width that holds head dim dh; 0 where none does
inline int head_width(int dh) {
  if (dh <= 0 || dh > 128 || dh % 8) return 0;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : 128;
}

template <typename T, int DH>
struct DecodeLanes {
  static constexpr int VEC = 16 / sizeof(T);   // elements of a 16-byte load
  static constexpr int LPR = DH / VEC;         // lanes per K/V row
  static constexpr int RPW = 32 / LPR;         // rows a warp loads at once
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
};

// K/V rows a lane has in flight
constexpr int DECODE_UNROLL = 4;

// One lane's running softmax state of its G query heads: q scaled into
// log2 units, the running max m, the sum l and the unnormalised
// accumulator over the lane's VEC head dims.
template <typename T, int DH, int G>
struct DecodeState {
  static constexpr int VEC = DecodeLanes<T, DH>::VEC;
  float qr[G][VEC];
  float m[G], l[G], acc[G][VEC];
};

template <int DH, int G, int NWARPS>
struct DecodeSmem {
  float acc[NWARPS][G][DH];
  float m[NWARPS][G];
  float l[NWARPS][G];
};

// q rows row0 .. row0 + heads - 1 (heads <= G, dh apart) into the
// state, scaled by scale_log2 (= scale * log2(e): scores in log2 units,
// softmax by exp2f); zeros past dh and past the chunk's heads.  m starts
// at the finite NEG_INF, so a masked row's exp2 is exactly 0.
template <typename T, int DH, int G>
__device__ __forceinline__ void decode_begin(DecodeState<T, DH, G>& st,
                                             const T* __restrict__ q,
                                             int64_t row0, int heads, int dh,
                                             float scale_log2) {
  using L = DecodeLanes<T, DH>;
  const int sub = (threadIdx.x & 31) % L::LPR;
  const bool in = sub * L::VEC < dh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (in && g < heads) {
      to_float(load16(q + (row0 + g) * dh + sub * L::VEC), st.qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < L::VEC; ++i) st.qr[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < L::VEC; ++i) {
      st.qr[g][i] *= scale_log2;
      st.acc[g][i] = 0.f;
    }
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
  }
}

// Fold the warp's n valid rows into the state; row j of them (0 <= j <
// n) starts at element row_off(j) of k and of v.  Each step lane (grp,
// sub) loads 16 bytes of rows j0 + u * RPW + grp, U of them in flight;
// the dot products reduce over a row's LPR lanes with shuffles, and each
// row serves all G heads.  n is the same across the warp.
template <typename T, int DH, int G, typename RowOff>
__device__ __forceinline__ void decode_rows(DecodeState<T, DH, G>& st,
                                            const T* __restrict__ k,
                                            const T* __restrict__ v, int n,
                                            int dh, RowOff row_off) {
  using L = DecodeLanes<T, DH>;
  constexpr int VEC = L::VEC, LPR = L::LPR, RPW = L::RPW;
  constexpr int U = DECODE_UNROLL;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPR;                // the row this lane loads
  const int sub = lane % LPR;                // its 16 bytes of the row
  const bool in = sub * VEC < dh;
  for (int j0 = 0; j0 < n; j0 += RPW * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * RPW + grp;
      ok[u] = j < n;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && in) {
        const int64_t off = row_off(j) + sub * VEC;
        kr[u] = load16(k + off);
        vr[u] = load16(v + off);
      }
    }
    // scores of the U rows for each head, summed over the row's lanes
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      to_float(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(st.qr[g][i], kf[i], part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[g][u] = ok[u] ? part : -INFINITY;
      }
    }
    // online softmax; s becomes p
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = st.m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[g][u]);
      const float alpha = exp2f(st.m[g] - mx);
      st.l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) st.acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = exp2f(s[g][u] - mx);
        st.l[g] += s[g][u];
      }
      st.m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      to_float(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          st.acc[g][i] = fmaf(s[g][u], vf[i], st.acc[g][i]);
    }
  }
}

// Merge the state over the RPW row groups of each warp (shuffles) and the
// NWARPS warps of the CTA (shared memory, in a fixed order), then write
// query rows row0 .. row0 + heads - 1: with one split the normalised
// output (zeros for a row with no valid key), else this split's partial
// (m, l, acc) in the layout split_merge_kernel reads.  Every thread
// calls it.
template <typename T, int DH, int G, int NWARPS>
__device__ __forceinline__ void decode_end(DecodeState<T, DH, G>& st,
                                           DecodeSmem<DH, G, NWARPS>& sm,
                                           int heads, int dh,
                                           T* __restrict__ out,
                                           float* __restrict__ part_acc,
                                           float2* __restrict__ part_ml,
                                           int64_t row0, int split,
                                           int splits) {
  using L = DecodeLanes<T, DH>;
  constexpr int VEC = L::VEC, LPR = L::LPR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, st.m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, st.l[g], o);
      const float mx = fmaxf(st.m[g], mo);
      const float a = exp2f(st.m[g] - mx);
      const float c = exp2f(mo - mx);
      st.l[g] = st.l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        st.acc[g][i] = st.acc[g][i] * a
                       + __shfl_xor_sync(0xffffffffu, st.acc[g][i], o) * c;
      st.m[g] = mx;
    }
  }
  if (lane < LPR) {                          // row group 0 holds the warp's
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm.acc[warp][g][lane * VEC + i] =
          st.acc[g][i];
      if (lane == 0) {
        sm.m[warp][g] = st.m[g];
        sm.l[warp][g] = st.l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < heads * dh; idx += NWARPS * 32) {
    const int g = idx / dh;
    const int d = idx % dh;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm.m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = exp2f(sm.m[w][g] - mx);
      lsum += sm.l[w][g] * f;
      a += sm.acc[w][g][d] * f;
    }
    if (splits == 1) {
      store_one(out + (row0 + g) * dh + d, lsum > 0.f ? a / lsum : 0.f);
    } else {
      const int64_t pr = (row0 + g) * splits + split;
      part_acc[pr * dh + d] = a;
      if (d == 0) part_ml[pr] = make_float2(mx, lsum);
    }
  }
}

// A range with no valid key: with one split, zeros into out; else (m, l)
// = (NEG_INF, 0) and no accumulator, which the merge weighs as 0.
template <typename T>
__device__ __forceinline__ void decode_empty(int heads, int dh,
                                             T* __restrict__ out,
                                             float2* __restrict__ part_ml,
                                             int64_t row0, int split,
                                             int splits) {
  if (splits == 1) {
    for (int i = threadIdx.x; i < heads * dh; i += blockDim.x)
      store_one(out + row0 * dh + i, 0.f);
  } else if (threadIdx.x < heads) {
    part_ml[(row0 + threadIdx.x) * splits + split] = make_float2(NEG_INF, 0.f);
  }
}

// Launch<T, DH, GC>::run(a) for the width that holds dh and the group
// chunk gc (the wrapper's group_chunk: 1 to 5); -1 where none is
// instantiated.
template <template <typename, int, int> class Launch, typename T, int DH,
          typename A>
int dispatch_group(int gc, const A& a) {
  switch (gc) {
    case 1: return Launch<T, DH, 1>::run(a);
    case 2: return Launch<T, DH, 2>::run(a);
    case 3: return Launch<T, DH, 3>::run(a);   // chunks of G 6
    case 4: return Launch<T, DH, 4>::run(a);   // also chunks of G 7-16
    case 5: return Launch<T, DH, 5>::run(a);   // hymba-1.5b
    default: return -1;
  }
}

template <template <typename, int, int> class Launch, typename T,
          typename A>
int dispatch_decode(int dh, int gc, const A& a) {
  switch (head_width(dh)) {
    case 32: return dispatch_group<Launch, T, 32>(gc, a);
    case 64: return dispatch_group<Launch, T, 64>(gc, a);
    case 128: return dispatch_group<Launch, T, 128>(gc, a);
    default: return -1;
  }
}

}  // namespace
