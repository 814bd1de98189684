// Flash-decoding over a slot-contiguous ring KV cache, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::decode_attention.  On the port's path it is
// the ring layout's decode (self_attention_cached with one query token).
//
// What it computes: one query token per sequence attends over its ring.
// out[b, h] = softmax(q[b,h] . K_b^T / sqrt(dh)) . V_b over the slots t
// whose absolute position kpos[b, t] is valid: 0 <= kpos <= q_pos[b], and
// with a window also kpos > q_pos[b] - window.  Ring wraparound, empty
// slots (kpos = -1) and partly filled rings need no special case.  f32
// arithmetic throughout, NEG_INF = -1e30; a row with no valid slot is
// written as zeros (the plain version, like the reference, gives the
// uniform average there; ring decode never has such a live row, since
// each step writes its token before it attends).
//
// Layouts are the model's, so nothing is transposed or padded:
//   q, out (B, 1, Hkv*G, DH)
//   k, v   (B, T, Hkv, DH)   element (b, t, h, d) at ((b*T + t)*Hkv + h)*DH + d
//   kpos   (B, T) int32, q_pos (B,) int32
//
// What bounds it: the bytes of K and V of the valid slots, 2 * valid *
// Hkv * DH * sizeof(T) per sequence, against 3.35 TB/s of HBM.  The
// arithmetic, 4 * G * DH per valid slot and KV head, is far below the
// card's rates, so the kernel has to keep enough loads in flight on every
// SM.  One CTA per (sequence, KV head) gave 40-64 CTAs for 132 SMs, each
// walking its whole ring alone; this design splits the ring:
//
// * Split-KV.  The grid is (splits, Hkv, B): each CTA takes a contiguous
//   range of split_len ring slots, chosen by the wrapper's planner from
//   the shapes alone (decode_splits in decode_attention.py, so no host
//   sync), enough for about four CTAs per SM at the serve shapes.  It
//   writes the partial softmax state (m, l, unnormalised acc) of each of
//   its G query heads into an f32 scratch the wrapper allocates, and a
//   second small kernel (split_merge_kernel, common.cuh) folds the splits
//   into out on the same stream.  With one split the CTA writes out
//   itself and the merge is not launched.  A range with no valid slot
//   reads only its kpos and writes m = NEG_INF, l = 0, which the merge
//   weighs as 0.
// * Inside a range, each warp compacts the valid slots of its 32-slot
//   chunks with ballots into a warp-private list (no block barrier), then
//   loads only their K/V rows, each once for the whole GQA group.  A lane
//   loads 16 bytes of a row (8 bf16 or 4 f32), so DH / 8 (bf16) lanes
//   cover a row and a warp reads 2-8 rows per load; each lane keeps U = 4
//   rows of K and V in flight (2 at G >= 7, where the registers of 4
//   would leave room for only two CTAs an SM).  The dot product reduces
//   over the lanes of a row with shuffles.  Scores are in log2 units (q
//   is scaled by scale * log2(e) once), so the softmax is exp2f.  The
//   lane groups of a warp merge with shuffles, the warps of a CTA in
//   shared memory.
//
// Later work: prefetching the next rows while the current ones are
// reduced, and planning the splits from the live context where a host
// sync is acceptable (a ring sized for 4096 slots with 515 live tokens
// leaves most ranges empty, and the few live ones set the time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int SPLIT_MAX = 1024;              // most slots a CTA takes
constexpr int IDS = SPLIT_MAX / NWARPS;      // compacted slots a warp holds

template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ kpos,
                    const int32_t* __restrict__ q_pos, T* __restrict__ out,
                    float* __restrict__ part_acc,
                    float2* __restrict__ part_ml, int t_len, int hkv,
                    int split_len, int window, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);        // elements of a 16-byte load
  constexpr int LPR = DH / VEC;              // lanes per K/V row
  constexpr int RPW = 32 / LPR;              // rows a warp loads at once
  // rows a lane has in flight: 4, or 2 where G >= 7, whose registers for
  // 4 would leave room for only two CTAs an SM
  constexpr int U = G >= 7 ? 2 : 4;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
  __shared__ int ids[NWARPS][IDS];
  __shared__ float sm_acc[NWARPS][G][DH];
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, t_len);
  // query rows (b, h*G + g) are rows row0 + g of q, out and the partials
  const int64_t row0 = (static_cast<int64_t>(b) * hkv + h) * G;

  // compact the valid slots of this warp's chunks: 32-slot chunks of the
  // range, dealt round the warps
  const int qp = q_pos[b];
  const int lo = window > 0 ? qp - window + 1 : 0;  // kpos >= 0 always
  const int32_t* kp_b = kpos + static_cast<int64_t>(b) * t_len;
  int n = 0;
  for (int c0 = s0 + warp * 32; c0 < s1; c0 += NWARPS * 32) {
    const int t = c0 + lane;
    const int kp = t < s1 ? kp_b[t] : -1;
    const bool valid = kp >= 0 && kp >= lo && kp <= qp;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (valid) ids[warp][n + __popc(ballot & ((1u << lane) - 1u))] = t;
    n += __popc(ballot);
  }
  __syncwarp();

  if (!__syncthreads_or(n > 0)) {         // no valid slot in the range
    if (splits == 1) {
      for (int i = threadIdx.x; i < G * DH; i += NT)
        store_one(out + row0 * DH + i, 0.f);
    } else if (threadIdx.x < G) {
      part_ml[(row0 + threadIdx.x) * splits + split] =
          make_float2(NEG_INF, 0.f);
    }
    return;
  }

  const int grp = lane / LPR;                // the row this lane loads
  const int sub = lane % LPR;                // its 16 bytes of the row
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    to_float(load16(q + (row0 + g) * DH + sub * VEC), qr[g]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[g][i] *= scale_log2;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const int64_t rs = static_cast<int64_t>(hkv) * DH;   // one slot's stride
  const T* kb = k + static_cast<int64_t>(b) * t_len * rs + h * DH + sub * VEC;
  const T* vb = v + static_cast<int64_t>(b) * t_len * rs + h * DH + sub * VEC;

  for (int j0 = 0; j0 < n; j0 += RPW * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * RPW + grp;
      ok[u] = j < n;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const int64_t off = ids[warp][j] * rs;
        kr[u] = load16(kb + off);
        vr[u] = load16(vb + off);
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
        for (int i = 0; i < VEC; ++i) part = fmaf(qr[g][i], kf[i], part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[g][u] = ok[u] ? part : -INFINITY;
      }
    }
    // online softmax; s becomes p.  m starts at the finite NEG_INF, so a
    // masked row's exp2 is exactly 0
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[g][u]);
      const float alpha = exp2f(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = exp2f(s[g][u] - mx);
        l[g] += s[g][u];
      }
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      to_float(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[g][i] = fmaf(s[g][u], vf[i], acc[g][i]);
    }
  }

  // merge the RPW row groups of the warp (lanes LPR apart)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mx);
      const float c = exp2f(mo - mx);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[g][i] = acc[g][i] * a
                    + __shfl_xor_sync(0xffffffffu, acc[g][i], o) * c;
      m[g] = mx;
    }
  }

  // then the warps, in shared memory, in a fixed order
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][sub * VEC + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += NT) {
    const int g = idx / DH;
    const int d = idx % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = exp2f(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      a += sm_acc[w][g][d] * f;
    }
    if (splits == 1) {
      store_one(out + (row0 + g) * DH + d, lsum > 0.f ? a / lsum : 0.f);
    } else {
      const int64_t pr = (row0 + g) * splits + split;
      part_acc[pr * DH + d] = a;
      if (d == 0) part_ml[pr] = make_float2(mx, lsum);
    }
  }
}

template <typename T, int DH, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* kpos, const int32_t* q_pos, void* out,
                   float* part_acc, float2* part_ml, int batch, int t_len,
                   int hkv, int splits, int split_len, int window,
                   float scale, cudaStream_t stream) {
  dim3 grid(splits, hkv, batch);
  decode_split_kernel<T, DH, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, q_pos, static_cast<T*>(out), part_acc,
      part_ml, t_len, hkv, split_len, window, scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  split_merge_kernel<T><<<batch * hkv * G, DH, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), splits, DH);
  return cudaGetLastError();
}

template <typename T, int DH>
int dispatch_g(int g, const void* q, const void* k, const void* v,
               const int32_t* kpos, const int32_t* q_pos, void* out,
               float* acc, float2* ml, int batch, int t_len, int hkv,
               int splits, int split_len, int window, float scale,
               cudaStream_t s) {
#define DECODE_G(G_)                                                        \
  case G_:                                                                  \
    return launch<T, DH, G_>(q, k, v, kpos, q_pos, out, acc, ml, batch,     \
                             t_len, hkv, splits, split_len, window, scale, s)
  switch (g) {
    DECODE_G(1);
    DECODE_G(2);
    DECODE_G(4);
    DECODE_G(5);
    DECODE_G(7);
    DECODE_G(8);
    default: return -1;
  }
#undef DECODE_G
}

template <typename T>
int dispatch_dh(int dh, int g, const void* q, const void* k, const void* v,
                const int32_t* kpos, const int32_t* q_pos, void* out,
                float* acc, float2* ml, int batch, int t_len, int hkv,
                int splits, int split_len, int window, float scale,
                cudaStream_t s) {
  switch (dh) {
    case 32: return dispatch_g<T, 32>(g, q, k, v, kpos, q_pos, out, acc, ml,
                                      batch, t_len, hkv, splits, split_len,
                                      window, scale, s);
    case 64: return dispatch_g<T, 64>(g, q, k, v, kpos, q_pos, out, acc, ml,
                                      batch, t_len, hkv, splits, split_len,
                                      window, scale, s);
    case 128: return dispatch_g<T, 128>(g, q, k, v, kpos, q_pos, out, acc,
                                        ml, batch, t_len, hkv, splits,
                                        split_len, window, scale, s);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  The ring's T slots are split into ceil(T / split_len) ranges
// (1 <= split_len <= 1024); with more than one, `scratch` holds
// B * Hkv * G * splits * (DH + 2) floats: the partial accumulators, then
// the (m, l) pairs.  Returns the CUDA error of the launches (0 on
// success), or -1 when the (dtype, dh, G) combination has no
// instantiation or the split is out of range.  The launches are
// asynchronous on `stream` and allocate nothing.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* kpos, const void* q_pos,
                                       void* out, int batch, int t_len,
                                       int hkv, int g, int dh, int window,
                                       float scale, void* stream,
                                       void* scratch, int split_len) {
  if (t_len <= 0 || batch <= 0 || batch > 65535 || hkv <= 0 || hkv > 65535 ||
      split_len <= 0 || split_len > SPLIT_MAX)
    return -1;
  const int splits = (t_len + split_len - 1) / split_len;
  if (splits > 1 && scratch == nullptr) return -1;
  float* acc = static_cast<float*>(scratch);
  float2* ml = splits > 1
      ? reinterpret_cast<float2*>(
            acc + static_cast<int64_t>(batch) * hkv * g * splits * dh)
      : nullptr;
  const auto* kp = static_cast<const int32_t*>(kpos);
  const auto* qp = static_cast<const int32_t*>(q_pos);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, g, q, k, v, kp, qp, out, acc, ml, batch,
                              t_len, hkv, splits, split_len, window, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, g, q, k, v, kp, qp, out, acc, ml,
                                      batch, t_len, hkv, splits, split_len,
                                      window, scale, s);
  return -1;
}
