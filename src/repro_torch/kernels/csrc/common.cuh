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

// 2^x in one MUFU op (flush to zero; 2^-inf = 0): the tensor-core
// attention bodies' softmax, whose P is rounded to bf16 next, far coarser
// than its ~2^-22 relative error.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// Merging partial softmax states.  A decode kernel that splits a row's
// keys over `splits` CTAs leaves, per query row (b, head) and split s, the
// partial softmax state of the keys it saw: m (the running max, in log2
// units: score * scale * log2(e)), l (the sum of exp2(score - m)) and acc
// (the sum of exp2(score - m) * v, unnormalised), at
//   part_ml[row * splits + s]              = (m, l)
//   part_acc[(row * splits + s) * dh + d]  = acc[d]
// A split with no valid key writes m = NEG_INF, l = 0 and no acc; the
// merge never reads its acc, and its weight exp2(m - M) * l is 0 anyway.
// out[row] = sum_s exp2(m_s - M) acc_s / sum_s exp2(m_s - M) l_s, with M
// the largest m_s; a row with no valid key in any split comes out as
// zeros.  The same arithmetic combines the ranks of a sequence-sharded
// ring (attention_combine.cu), each rank a part with m = its log-sum-exp
// in log2 units, l = 1 and acc = its normalised output.
// ---------------------------------------------------------------------------

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// The natural log-sum-exp of a row's scaled scores from its merged state
// (m in log2 units, l the sum of exp2(score - m)); NEG_INF for a row with
// no valid key.
__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : NEG_INF;
}

// Merge one row's `parts` states into out[0 .. dh) and, where lse is not
// null, *lse.  ml(s) gives part s's (m, l), acc(s, d) element d of its
// accumulator; the threads of the CTA take the elements in turn.
template <typename T, typename ML, typename Acc>
__device__ __forceinline__ void merge_parts(int parts, int dh, ML ml,
                                            Acc acc, T* __restrict__ out,
                                            float* __restrict__ lse) {
  float mx = NEG_INF;
  for (int s = 0; s < parts; ++s) mx = fmaxf(mx, ml(s).x);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < parts; ++s) {
      const float2 f = ml(s);
      if (f.y > 0.f) {
        const float w = exp2f(f.x - mx);
        lsum += f.y * w;
        a += acc(s, d) * w;
      }
    }
    store_one(out + d, lsum > 0.f ? a / lsum : 0.f);
    if (lse != nullptr && d == 0) *lse = lse_of(mx, lsum);
  }
}

// The split-KV merge: one CTA per row, one thread per element of the
// head dim (at most 256, each taking every 256th past that); lse (one
// float per row) may be null.
template <typename T>
__global__ void split_merge_kernel(const float* __restrict__ part_acc,
                                   const float2* __restrict__ part_ml,
                                   T* __restrict__ out,
                                   float* __restrict__ lse, int splits,
                                   int dh) {
  const int64_t row = blockIdx.x;
  const float2* ml = part_ml + row * splits;
  const float* acc = part_acc + row * splits * dh;
  merge_parts(
      splits, dh, [=](int s) { return ml[s]; },
      [=](int s, int d) { return acc[s * dh + d]; }, out + row * dh,
      lse == nullptr ? nullptr : lse + row);
}

template <typename T>
cudaError_t launch_split_merge(const float* part_acc, const float2* part_ml,
                               T* out, float* lse, int rows, int splits,
                               int dh, cudaStream_t stream) {
  split_merge_kernel<T><<<rows, dh < 256 ? dh : 256, 0, stream>>>(
      part_acc, part_ml, out, lse, splits, dh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The split-KV decode core of the ring and the paged decode kernels.  A
// CTA of NWARPS warps takes up to G query heads of one KV head (the whole
// GQA group, or a chunk of it, as the wrapper's group_chunk chooses) for
// one query token, over a range of keys that each warp splits further.
//
// Head dims.  LPR lanes cover a K/V row of the DH-wide instantiation (32,
// 64, 128 or 256), each holding VEC consecutive elements, and a warp
// loads RPW = 32 / LPR rows at once.  Up to DH 128 a lane's share is one
// 16-byte load (LPR = DH / VEC); at DH 256 a row takes the whole warp,
// 8 elements a lane: one 16-byte load in bf16, two in f32.  Any dh <= DH
// runs on the narrowest width that holds it: the lanes past dh skip
// their loads and hold zeros, and every row is addressed with the real
// dh, so q, the pool and the rings are read in place and nothing is
// padded in memory (dh 112 and 120 run on the 128 instantiation with 14
// or 15 of a row's 16 bf16 lanes busy; Gemma 3's 256 on the 256 one).  A
// dh that is a multiple of 8 keeps every row start 16-byte aligned in f32
// and bf16; any other dh (NARROW) takes the same lanes, each loading its
// elements one at a time, with zeros past dh.
//
// Past 256 (WIDE).  A head wider than 256 runs in column blocks of 256:
// the grid takes one CTA per block of the output's columns, and every CTA
// computes the whole row's scores, each K row read block by block against
// the chunk's q rows, which sit in shared memory (f32, already scaled),
// then folds only its own block of V into its state: the DH 256 lanes, a
// whole warp a row, 8 elements a lane.  The CTAs of a row compute the
// same scores in the same order, so they agree on m and l bit for bit,
// and the first block's CTA writes them (and the log-sum-exp).  The body
// is generic in the number of blocks, and takes a dh that is not a
// multiple of 8 at run time (element by element, as NARROW).
// ---------------------------------------------------------------------------

constexpr int WIDE = 0;              // the DH of the column-block body
constexpr int WIDE_COLS = 256;       // a column block
// the most dynamic shared memory the q rows of a wide CTA take: up to 5
// heads x 38 blocks (dh 9728), f32
constexpr int WIDE_Q_SMEM = 192 * 1024;

// the instantiated width that holds head dim dh (1 to 256; WIDE past it);
// -1 for a dh below 1
inline int head_width(int dh) {
  if (dh <= 0) return -1;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128
                                  : dh <= 256 ? 256 : WIDE;
}

// the dynamic shared memory of a wide CTA of g query heads: their q rows
// over whole column blocks
inline int64_t wide_q_bytes(int dh, int g) {
  return static_cast<int64_t>(g) * ((dh + WIDE_COLS - 1) / WIDE_COLS)
         * WIDE_COLS * static_cast<int64_t>(sizeof(float));
}

template <typename T, int DH>
struct DecodeLanes {
  static constexpr int VEC16 = 16 / sizeof(T);   // elements of 16 bytes
  static constexpr int LPR = DH / VEC16 < 32 ? DH / VEC16 : 32;  // a row's
  static constexpr int VEC = DH / LPR;           // elements a lane holds
  static constexpr int LOADS = VEC / VEC16;      // its 16-byte pieces
  static constexpr int RPW = 32 / LPR;           // rows a warp loads at once
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
  static_assert(LOADS >= 1 && LOADS * VEC16 == VEC, "lane share");
};

// the first n elements of the 16 bytes at p (n may pass their count), as
// raw bits with zeros after: element by element, for a row start that is
// not 16-byte aligned
__device__ __forceinline__ uint4 load16_narrow(const float* p, int n) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = i < n ? __float_as_uint(p[i]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load16_narrow(const __nv_bfloat16* p,
                                               int n) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (2 * i < n ? static_cast<unsigned>(h[2 * i]) : 0u)
           | (2 * i + 1 < n ? static_cast<unsigned>(h[2 * i + 1]) << 16
                            : 0u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a lane's VEC elements of a row from p (its first element), n of them
// inside dh, as LOADS pieces of raw bits
template <typename T, int DH, bool NARROW>
__device__ __forceinline__ void load_lane(
    const T* __restrict__ p, int n,
    uint4 (&raw)[DecodeLanes<T, DH>::LOADS]) {
  using L = DecodeLanes<T, DH>;
#pragma unroll
  for (int i = 0; i < L::LOADS; ++i)
    raw[i] = NARROW ? load16_narrow(p + i * L::VEC16, n - i * L::VEC16)
                    : load16(p + i * L::VEC16);
}

template <typename T, int DH>
__device__ __forceinline__ void lane_to_float(
    const uint4 (&raw)[DecodeLanes<T, DH>::LOADS],
    float (&o)[DecodeLanes<T, DH>::VEC]) {
  using L = DecodeLanes<T, DH>;
#pragma unroll
  for (int i = 0; i < L::LOADS; ++i) {
    float f[L::VEC16];
    to_float(raw[i], f);
#pragma unroll
    for (int e = 0; e < L::VEC16; ++e) o[i * L::VEC16 + e] = f[e];
  }
}

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
template <typename T, int DH, int G, bool NARROW>
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
      uint4 raw[L::LOADS];
      load_lane<T, DH, NARROW>(q + (row0 + g) * dh + sub * L::VEC,
                               dh - sub * L::VEC, raw);
      lane_to_float<T, DH>(raw, st.qr[g]);
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
// sub) loads its VEC elements of rows j0 + u * RPW + grp, U of them in
// flight; the dot products reduce over a row's LPR lanes with shuffles,
// and each row serves all G heads.  n is the same across the warp.
template <typename T, int DH, int G, bool NARROW, typename RowOff>
__device__ __forceinline__ void decode_rows(DecodeState<T, DH, G>& st,
                                            const T* __restrict__ k,
                                            const T* __restrict__ v, int n,
                                            int dh, RowOff row_off) {
  using L = DecodeLanes<T, DH>;
  constexpr int VEC = L::VEC, LPR = L::LPR, RPW = L::RPW, LD = L::LOADS;
  constexpr int U = DECODE_UNROLL;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPR;                // the row this lane loads
  const int sub = lane % LPR;                // its share of the row
  const bool in = sub * VEC < dh;
  for (int j0 = 0; j0 < n; j0 += RPW * U) {
    uint4 kr[U][LD], vr[U][LD];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * RPW + grp;
      ok[u] = j < n;
#pragma unroll
      for (int i = 0; i < LD; ++i)
        kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && in) {
        const int64_t off = row_off(j) + sub * VEC;
        load_lane<T, DH, NARROW>(k + off, dh - sub * VEC, kr[u]);
        load_lane<T, DH, NARROW>(v + off, dh - sub * VEC, vr[u]);
      }
    }
    // scores of the U rows for each head, summed over the row's lanes
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      lane_to_float<T, DH>(kr[u], kf);
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
      lane_to_float<T, DH>(vr[u], vf);
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
// output (zeros for a row with no valid key) and, where lse is not null,
// each row's log-sum-exp (lse_of), else this split's partial (m, l, acc)
// in the layout split_merge_kernel reads.  A wide CTA (COLS: a dh past
// DH) writes columns col0 .. col0 + DH - 1 of the rows inside dh, and
// (m, l) and the log-sum-exp only from its first block.  Every thread
// calls it.
template <typename T, int DH, int G, int NWARPS, bool COLS = false>
__device__ __forceinline__ void decode_end(DecodeState<T, DH, G>& st,
                                           DecodeSmem<DH, G, NWARPS>& sm,
                                           int heads, int dh,
                                           T* __restrict__ out,
                                           float* __restrict__ part_acc,
                                           float2* __restrict__ part_ml,
                                           float* __restrict__ lse,
                                           int64_t row0, int split,
                                           int splits, int col0 = 0) {
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
  if constexpr (!COLS) col0 = 0;
  const int cw = COLS ? min(dh - col0, DH) : dh;   // the columns written
  for (int idx = threadIdx.x; idx < heads * cw; idx += NWARPS * 32) {
    const int g = idx / cw;
    const int d = idx % cw;
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
      store_one(out + (row0 + g) * dh + col0 + d,
                lsum > 0.f ? a / lsum : 0.f);
      if (lse != nullptr && col0 + d == 0) lse[row0 + g] = lse_of(mx, lsum);
    } else {
      const int64_t pr = (row0 + g) * splits + split;
      part_acc[pr * dh + col0 + d] = a;
      if (col0 + d == 0) part_ml[pr] = make_float2(mx, lsum);
    }
  }
}

// A range with no valid key: with one split, zeros into out (and NEG_INF
// into lse, where it is not null); else (m, l) = (NEG_INF, 0) and no
// accumulator, which the merge weighs as 0.  A wide CTA (COLS: a dh past
// 256) zeros its own columns col0 .. col0 + 255 inside dh, and writes
// (m, l) and lse from its first block only.
template <bool COLS = false, typename T>
__device__ __forceinline__ void decode_empty(int heads, int dh,
                                             T* __restrict__ out,
                                             float2* __restrict__ part_ml,
                                             float* __restrict__ lse,
                                             int64_t row0, int split,
                                             int splits, int col0 = 0) {
  const int cw = COLS ? min(dh - col0, WIDE_COLS) : dh;
  const bool first = !COLS || col0 == 0;
  if (splits == 1) {
    for (int i = threadIdx.x; i < heads * cw; i += blockDim.x)
      store_one(COLS ? out + (row0 + i / cw) * dh + col0 + i % cw
                     : out + row0 * dh + i, 0.f);
    if (lse != nullptr && first && threadIdx.x < heads)
      lse[row0 + threadIdx.x] = NEG_INF;
  } else if (first && threadIdx.x < heads) {
    part_ml[(row0 + threadIdx.x) * splits + split] = make_float2(NEG_INF, 0.f);
  }
}

// The wide body's state: the DH 256 lanes' running softmax of G heads
// (its q lives in shared memory, so qr stays unused).
template <typename T, int G>
using WideState = DecodeState<T, WIDE_COLS, G>;

// q rows row0 .. row0 + heads - 1 into qs (heads x dhp floats, dhp the
// whole blocks), scaled into log2 units, zeros past dh and past the
// chunk's heads; the state empty.  Every thread calls it; it ends with a
// barrier.
template <typename T, int G>
__device__ __forceinline__ void wide_begin(WideState<T, G>& st,
                                           float* __restrict__ qs,
                                           const T* __restrict__ q,
                                           int64_t row0, int heads, int dh,
                                           int dhp, float scale_log2) {
  for (int i = threadIdx.x; i < G * dhp; i += blockDim.x) {
    const int g = i / dhp, d = i % dhp;
    qs[i] = g < heads && d < dh
                ? load_one(q + (row0 + g) * dh + d) * scale_log2 : 0.f;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) st.acc[g][i] = 0.f;
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
  }
  __syncthreads();
}

// Fold the warp's n valid rows into the state, as decode_rows does, for a
// head of dh columns in column blocks (qs from wide_begin): lane l takes
// elements 8 l .. 8 l + 7 of each block of a row, so a row's scores sum
// every block's products in the lane, then over the warp; only block cb
// of V enters the state.  narrow: dh is not a multiple of 8 (loads
// element by element).
template <typename T, int G, typename RowOff>
__device__ __forceinline__ void wide_rows(WideState<T, G>& st,
                                          const float* __restrict__ qs,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v, int n,
                                          int dh, int dhp, int cb,
                                          bool narrow, RowOff row_off) {
  using L = DecodeLanes<T, WIDE_COLS>;
  constexpr int VEC = L::VEC, LD = L::LOADS;
  constexpr int U = DECODE_UNROLL;
  static_assert(VEC == 8 && L::LPR == 32, "a row a warp, 8 a lane");
  const int lane = threadIdx.x & 31;
  const auto load = [&](const T* p, int left, uint4 (&raw)[LD]) {
    if (narrow)
      load_lane<T, WIDE_COLS, true>(p, left, raw);
    else
      load_lane<T, WIDE_COLS, false>(p, left, raw);
  };
  const int vcol = cb * WIDE_COLS + lane * VEC;
  for (int j0 = 0; j0 < n; j0 += U) {
    bool ok[U];
    int64_t off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = j0 + u < n;
      off[u] = ok[u] ? row_off(j0 + u) : 0;
    }
    float s[G][U];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) s[g][u] = 0.f;
    for (int col = lane * VEC; col < dhp; col += WIDE_COLS) {
      uint4 kr[U][LD];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < LD; ++i) kr[u][i] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u] && col < dh) load(k + off[u] + col, dh - col, kr[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        lane_to_float<T, WIDE_COLS>(kr[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 q0 =
              *reinterpret_cast<const float4*>(qs + g * dhp + col);
          const float4 q1 =
              *reinterpret_cast<const float4*>(qs + g * dhp + col + 4);
          const float qf[VEC] = {q0.x, q0.y, q0.z, q0.w,
                                 q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int i = 0; i < VEC; ++i) s[g][u] = fmaf(qf[i], kf[i], s[g][u]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = s[g][u];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[g][u] = ok[u] ? part : -INFINITY;
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
    uint4 vr[U][LD];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < LD; ++i) vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && vcol < dh) load(v + off[u] + vcol, dh - vcol, vr[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      lane_to_float<T, WIDE_COLS>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          st.acc[g][i] = fmaf(s[g][u], vf[i], st.acc[g][i]);
    }
  }
}

// Launch<T, DH, GC, NARROW>::run(a) for the width that holds dh and the
// group chunk gc (the wrapper's group_chunk: 1 to 5), NARROW for a dh
// that is not a multiple of 8; -1 where none is instantiated.
template <template <typename, int, int, bool> class Launch, typename T,
          int DH, bool NARROW, typename A>
int dispatch_group(int gc, const A& a) {
  switch (gc) {
    case 1: return Launch<T, DH, 1, NARROW>::run(a);
    case 2: return Launch<T, DH, 2, NARROW>::run(a);
    case 3: return Launch<T, DH, 3, NARROW>::run(a);   // G 3, 9; chunks of 6
    case 4: return Launch<T, DH, 4, NARROW>::run(a);   // chunks of G 7-16, 48
    case 5: return Launch<T, DH, 5, NARROW>::run(a);   // hymba-1.5b
    default: return -1;
  }
}

template <template <typename, int, int, bool> class Launch, typename T,
          bool NARROW, typename A>
int dispatch_width(int dh, int gc, const A& a) {
  switch (head_width(dh)) {
    case 32: return dispatch_group<Launch, T, 32, NARROW>(gc, a);
    case 64: return dispatch_group<Launch, T, 64, NARROW>(gc, a);
    case 128: return dispatch_group<Launch, T, 128, NARROW>(gc, a);
    case 256: return dispatch_group<Launch, T, 256, NARROW>(gc, a);
    default: return -1;
  }
}

// A head past 256 takes the column-block body, Launch<T, WIDE, gc,
// false>, which reads a dh that is not a multiple of 8 at run time.
template <template <typename, int, int, bool> class Launch, typename T,
          typename A>
int dispatch_decode(int dh, int gc, const A& a) {
  if (head_width(dh) == WIDE)
    return dispatch_group<Launch, T, WIDE, false>(gc, a);
  return dh % 8 ? dispatch_width<Launch, T, true>(dh, gc, a)
                : dispatch_width<Launch, T, false>(dh, gc, a);
}

}  // namespace
