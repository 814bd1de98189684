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
// card's rates.  The ring is sized for the longest context (4096 slots at
// agent-7b) while most rows hold far fewer tokens, so the design makes
// the work follow the valid slots, not the ring: one CTA per (sequence,
// KV head) reads kpos in tiles of 256 slots, compacts the valid slot ids
// of a tile into shared memory (warp ballots and a prefix count), and only
// then loads K/V rows, each once for the whole GQA group.  Each warp owns
// UNROLL compacted slots at a time; a lane holds DH/32 contiguous
// elements, so a warp reads one K row as one coalesced transaction.  The
// running (m, l, acc) of the G heads stay in registers; the NWARPS partial
// states merge once, in shared memory, at the end.  Split-KV across CTAs,
// TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int UNROLL = 4;

template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kpos,
                        const int32_t* __restrict__ q_pos, T* __restrict__ out,
                        int t_len, int hkv, int window, float scale) {
  constexpr int N = DH / 32;  // elements of a row each lane holds
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int qp = q_pos[b];
  const int lo = window > 0 ? qp - window + 1 : 0;  // kpos >= 0 always

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* p = q + ((static_cast<int64_t>(b) * hkv + h) * G + g) * DH
                 + lane * N;
    load_row<N>(p, qr[g]);
#pragma unroll
    for (int i = 0; i < N; ++i) qr[g][i] *= scale;
  }

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  __shared__ int slot_ids[NT];
  __shared__ int warp_count[NWARPS];
  const int64_t row = static_cast<int64_t>(hkv) * DH;   // one slot's stride
  const T* kb = k + static_cast<int64_t>(b) * t_len * row + h * DH + lane * N;
  const T* vb = v + static_cast<int64_t>(b) * t_len * row + h * DH + lane * N;
  const int32_t* kp_b = kpos + static_cast<int64_t>(b) * t_len;

  for (int base = 0; base < t_len; base += NT) {
    // compact this tile's valid slots into slot_ids[0, n)
    const int t = base + threadIdx.x;
    const int kp = t < t_len ? kp_b[t] : -1;
    const bool valid = kp >= 0 && kp >= lo && kp <= qp;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const int cnt = warp_count[w];
      offset += w < warp ? cnt : 0;
      n += cnt;
    }
    if (valid)
      slot_ids[offset + __popc(ballot & ((1u << lane) - 1u))] = t;
    __syncthreads();

    for (int j0 = warp * UNROLL; j0 < n; j0 += NWARPS * UNROLL) {
      float kr[UNROLL][N], vr[UNROLL][N];
      bool ok[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ok[u] = j0 + u < n;
        const int slot = slot_ids[ok[u] ? j0 + u : j0];
        load_row<N>(kb + slot * row, kr[u]);
        load_row<N>(vb + slot * row, vr[u]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[UNROLL];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) part += qr[g][i] * kr[u][i];
          s[u] = ok[u] ? warp_sum(part) : NEG_INF;
          mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float p = ok[u] ? expf(s[u] - mx) : 0.f;
          l[g] += p;
#pragma unroll
          for (int i = 0; i < N; ++i) acc[g][i] += p * vr[u][i];
        }
        m[g] = mx;
      }
    }
    __syncthreads();  // slot_ids and warp_count are rewritten next tile
  }

  // cross-warp merge of the NWARPS partial softmax states
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][DH];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][g][lane * N + i] = acc[g][i];
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
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      a += sm_acc[w][g][d] * f;
    }
    store_one(out + ((static_cast<int64_t>(b) * hkv + h) * G + g) * DH + d,
              a / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, int DH, int G>
void launch(const void* q, const void* k, const void* v, const int32_t* kpos,
            const int32_t* q_pos, void* out, int batch, int t_len, int hkv,
            int window, float scale, cudaStream_t stream) {
  dim3 grid(hkv, batch);
  decode_attention_kernel<T, DH, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, q_pos, static_cast<T*>(out), t_len, hkv,
      window, scale);
}

template <typename T, int DH>
bool dispatch_g(int g, const void* q, const void* k, const void* v,
                const int32_t* kpos, const int32_t* q_pos, void* out,
                int batch, int t_len, int hkv, int window, float scale,
                cudaStream_t s) {
  switch (g) {
    case 1: launch<T, DH, 1>(q, k, v, kpos, q_pos, out, batch, t_len, hkv,
                             window, scale, s); return true;
    case 2: launch<T, DH, 2>(q, k, v, kpos, q_pos, out, batch, t_len, hkv,
                             window, scale, s); return true;
    case 4: launch<T, DH, 4>(q, k, v, kpos, q_pos, out, batch, t_len, hkv,
                             window, scale, s); return true;
    case 5: launch<T, DH, 5>(q, k, v, kpos, q_pos, out, batch, t_len, hkv,
                             window, scale, s); return true;
    case 7: launch<T, DH, 7>(q, k, v, kpos, q_pos, out, batch, t_len, hkv,
                             window, scale, s); return true;
    case 8: launch<T, DH, 8>(q, k, v, kpos, q_pos, out, batch, t_len, hkv,
                             window, scale, s); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch_dh(int dh, int g, const void* q, const void* k, const void* v,
                 const int32_t* kpos, const int32_t* q_pos, void* out,
                 int batch, int t_len, int hkv, int window, float scale,
                 cudaStream_t s) {
  switch (dh) {
    case 32: return dispatch_g<T, 32>(g, q, k, v, kpos, q_pos, out, batch,
                                      t_len, hkv, window, scale, s);
    case 64: return dispatch_g<T, 64>(g, q, k, v, kpos, q_pos, out, batch,
                                      t_len, hkv, window, scale, s);
    case 128: return dispatch_g<T, 128>(g, q, k, v, kpos, q_pos, out, batch,
                                        t_len, hkv, window, scale, s);
    default: return false;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launch, or -1 when the
// (dtype, dh, G) combination has no instantiation.  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* kpos, const void* q_pos,
                                       void* out, int batch, int t_len,
                                       int hkv, int g, int dh, int window,
                                       float scale, void* stream) {
  if (t_len <= 0) return -1;
  const auto* kp = static_cast<const int32_t*>(kpos);
  const auto* qp = static_cast<const int32_t*>(q_pos);
  auto s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_dh<float>(dh, g, q, k, v, kp, qp, out, batch, t_len, hkv,
                            window, scale, s);
  else if (dtype == 1)
    ok = dispatch_dh<__nv_bfloat16>(dh, g, q, k, v, kp, qp, out, batch, t_len,
                                    hkv, window, scale, s);
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
