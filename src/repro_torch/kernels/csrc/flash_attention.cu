// Blocked causal (or non-causal) GQA attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::flash_attention.  On the port's path it is the
// ring layout's one-shot causal prefill (self_attention_prefill).
//
// What it computes: out[b, i, h] = softmax(q[b,i,h] . K_b^T / sqrt(dh)) . V_b
// over the keys of KV head h / G.  Causal: key j is valid for query i when
// j <= i, and with a window also j > i - window; non-causal: every key
// j < T.  kv_len is the real T (keys are never padded).  f32 arithmetic
// throughout; the output takes q's type.  A query row with no valid key
// (causal with a window and S > T only) is written as zeros.
//
// Layouts are the model's, so nothing is transposed or padded:
//   q, out (B, S, H, DH)    element (b, i, h, d) at ((b*S + i)*H + h)*DH + d
//   k, v   (B, T, Hkv, DH)  element (b, j, h, d) at ((b*T + j)*Hkv + h)*DH + d
//
// What bounds it: operations.  4 * DH per (query row, head, valid key) --
// about 8.6 GFLOP for S = T = 1024, H = 32, DH = 128 causal -- against
// bytes of a few tens of MB.  The card's bf16 tensor-core rate would put
// it near 9 us; this kernel does the products on the f32 CUDA cores, so it
// sits far above that bound by design.  What the design does about it:
// Pallas carried (m, l, acc) across a sequential grid axis; here one CTA
// owns (b, q head, BQ query rows) and loops over key tiles itself, only
// from the first to the last tile that the causal and window masks leave
// live.  Each BK-key tile of K and V is staged in shared memory as f32
// once for all BQ rows.  Four threads share a query row: each holds DH/4
// of q and of the accumulator in registers, interleaved by float4 so the
// four read one 64-byte span of a shared K/V row (no bank conflicts, and
// the eight rows of a warp read it as a broadcast).  A row's running max
// and sum live in registers; scores of a tile reduce over the four
// threads with two shuffles.  wgmma, TMA and sharing a tile across the G
// heads of a KV head are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 32;           // keys per shared-memory tile
constexpr int TPR = 4;           // threads per query row
constexpr int NT = BQ * TPR;     // threads per CTA

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int t_len, int h_q, int g, int causal, int window,
                       float scale) {
  constexpr int NF = DH / (4 * TPR);  // float4 chunks of a row per thread
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int r = threadIdx.x / TPR;    // query row within the block
  const int c = threadIdx.x % TPR;    // this thread's share of the row
  const int qi = q0 + r;
  const bool live = qi < s_len;

  // this row's valid keys: [lo, hi]
  int lo = 0, hi = t_len - 1;
  if (causal) {
    hi = min(qi, t_len - 1);
    if (window > 0) lo = max(qi - window + 1, 0);
  }
  // the CTA's live key range: the union of its rows' ranges
  int k_begin = 0, k_end = t_len;
  if (causal) {
    const int last = min(q0 + BQ, s_len) - 1;
    k_end = min(last + 1, t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / BK) * BK;

  float qr[NF][4], acc[NF][4];
  {
    const T* qp = q + ((static_cast<int64_t>(b) * s_len + (live ? qi : 0))
                       * h_q + h) * DH;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      load_row<4>(qp + (f * TPR + c) * 4, qr[f]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qr[f][e] *= scale;
        acc[f][e] = 0.f;
      }
    }
  }
  float m = NEG_INF, l = 0.f;

  const int64_t krow = static_cast<int64_t>(hkv) * DH;  // one key's stride
  const T* kb = k + static_cast<int64_t>(b) * t_len * krow + kh * DH;
  const T* vb = v + static_cast<int64_t>(b) * t_len * krow + kh * DH;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x * 4; idx < BK * DH; idx += NT * 4) {
      const int j = idx / DH;
      const int d = idx % DH;
      const int t = t0 + j;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < t_len) {
        load_row<4>(kb + t * krow + d, kx);
        load_row<4>(vb + t * krow + d, vx);
      }
      *reinterpret_cast<float4*>(&ks[j][d]) =
          make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(&vs[j][d]) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();
    // a warp skips a tile that none of its eight rows needs; a row of a
    // warp that goes on finds every key masked and changes nothing
    const bool need = live && t0 <= hi && t0 + BK - 1 >= lo;
    if (!__any_sync(0xffffffffu, need)) continue;

    float sc[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float4 kx = *reinterpret_cast<const float4*>(
            &ks[j][(f * TPR + c) * 4]);
        part += qr[f][0] * kx.x + qr[f][1] * kx.y + qr[f][2] * kx.z +
                qr[f][3] * kx.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int t = t0 + j;
      const bool ok = t >= lo && t <= hi;
      sc[j] = ok ? part : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int t = t0 + j;
      const float p = (t >= lo && t <= hi) ? expf(sc[j] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float4 vx = *reinterpret_cast<const float4*>(
            &vs[j][(f * TPR + c) * 4]);
        acc[f][0] += p * vx.x; acc[f][1] += p * vx.y;
        acc[f][2] += p * vx.z; acc[f][3] += p * vx.w;
      }
    }
    m = mx;
  }

  if (!live) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* op = out + ((static_cast<int64_t>(b) * s_len + qi) * h_q + h) * DH;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_one(op + (f * TPR + c) * 4 + e, acc[f][e] * inv);
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* out, int batch,
            int s_len, int t_len, int h_q, int g, int causal, int window,
            float scale, cudaStream_t stream) {
  dim3 grid((s_len + BQ - 1) / BQ, h_q, batch);
  flash_attention_kernel<T, DH><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, t_len, h_q, g,
      causal, window, scale);
}

template <typename T>
bool dispatch_dh(int dh, const void* q, const void* k, const void* v,
                 void* out, int batch, int s_len, int t_len, int h_q, int g,
                 int causal, int window, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: launch<T, 32>(q, k, v, out, batch, s_len, t_len, h_q, g, causal,
                           window, scale, s); return true;
    case 64: launch<T, 64>(q, k, v, out, batch, s_len, t_len, h_q, g, causal,
                           window, scale, s); return true;
    case 128: launch<T, 128>(q, k, v, out, batch, s_len, t_len, h_q, g,
                             causal, window, scale, s); return true;
    default: return false;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launch, or -1 when the
// (dtype, dh, G) combination is not supported.  The launch is asynchronous
// on `stream` and allocates nothing.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int s_len, int t_len, int h_q, int hkv,
                                      int dh, int causal, int window,
                                      float scale, void* stream) {
  if (hkv <= 0 || h_q % hkv != 0 || s_len <= 0 || t_len <= 0) return -1;
  const int g = h_q / hkv;
  if (g != 1 && g != 2 && g != 4 && g != 5 && g != 7 && g != 8) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_dh<float>(dh, q, k, v, out, batch, s_len, t_len, h_q, g,
                            causal, window, scale, st);
  else if (dtype == 1)
    ok = dispatch_dh<__nv_bfloat16>(dh, q, k, v, out, batch, s_len, t_len,
                                    h_q, g, causal, window, scale, st);
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
