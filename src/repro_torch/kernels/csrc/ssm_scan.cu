// Chunked decayed linear-recurrence scan (mamba-2 / SSD form) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan /
// _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::ssm_scan.  On the port's path it is the chunked
// scan of every hymba layer's mamba branch at prefill (models/ssm.py).
//
// What it computes, per (batch b, head h), with an f32 state H (dk x dv):
//   H_t = exp(log_a_t) H_{t-1} + k_t v_t^T,   y_t = q_t . H_t,   H_0 = h0
// chunk-parallel: with L the inclusive cumulative sum of log_a inside a
// chunk,
//   y_i   = sum_{j <= i} (q_i . k_j) exp(L_i - L_j) v_j + exp(L_i) q_i . H
//   H_new = exp(L_last) H + sum_j exp(L_last - L_j) k_j v_j^T
// The mask j <= i is applied before the exponential: L_i - L_j for j > i is
// a large positive number (L reaches about -90 within 128 tokens at hymba's
// decay), and exp of it times a zero would be inf * 0 = NaN.  f32
// arithmetic throughout; y takes v's type, H_T is f32.  The real T is
// taken: rows of a ragged last chunk past T read as log_a = 0, k = q = v =
// 0, so the state passes them unchanged (as ops.ssm_scan's padding does),
// and their y is not written.
//
// Layouts are the model's, so nothing is transposed:
//   q, k   (B, T, H, dk)  at b*s_b + t*s_t + h*s_h + d, strides given (a
//          head stride of 0 broadcasts one row over all heads: hymba's
//          B/C projections are shared by its 50 SSM heads)
//   v, y   (B, T, H, dv)  contiguous
//   log_a  (B, T, H) f32 contiguous;  h0, h_T (B, H, dk, dv) f32 contiguous
//
// What bounds it: bytes.  At hymba's prefill (B = 1, H = 50, T = 1024, dk
// 16, dv 64, bf16) q, k, v and y are ~16.4 MB and the f32 state and log_a
// ~0.6 MB: ~5 us at 3.35 TB/s, against ~1.3 GFLOP (~1.3 us on the tensor
// cores).  What the design does about it: the TPU walks (B, H, T/chunk)
// with the chunk axis sequential and the state in VMEM scratch; here one
// CTA owns (b, h, a tile of DVT = 16 state columns) and loops over the
// chunks itself, with its (dk x 16) slice of the state in shared memory.
// The recurrence is independent per state column, so tiling dv gives a B
// = 1 prefill 4 x 50 = 200 CTAs on 132 SMs instead of 50; each CTA reads
// q, k and log_a of its head (4x re-read, from L2) and only its 16
// columns of v.  Inside a chunk one thread owns one row i: q_i in
// registers, k and the v tile of the chunk in shared memory (read as
// broadcasts), L from a warp-shuffle scan, then y_i's inner products over
// j <= i, then every thread updates DK*16/128 entries of the state.  The
// products run on the f32 CUDA cores; wgmma tiles for the (C x C) scores
// and the state update, and a CTA per (b, h) that shares the scores among
// its column tiles, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CMAX = 128;        // largest chunk: one thread per chunk row
constexpr int NT = CMAX;         // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int DVT = 16;          // state columns per CTA

template <typename T, int DK>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ log_a,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_t, int t_len, int heads, int dk, int dv,
                int chunk, int64_t qsb, int64_t qst, int64_t qsh, int64_t ksb,
                int64_t kst, int64_t ksh) {
  constexpr int NE = DK * DVT / NT;  // state entries each thread updates
  static_assert(NE >= 1 && DK * DVT % NT == 0, "state tile vs threads");
  __shared__ float ks[CMAX][DK];     // k of the chunk, zero-padded to DK
  __shared__ float vs[CMAX][DVT];    // v of the chunk, this CTA's columns
  __shared__ float hs[DK][DVT];      // the state slice
  __shared__ float Ls[CMAX];         // inclusive cumsum of log_a
  __shared__ float rem[CMAX];        // exp(L_last - L_j)
  __shared__ float warp_tot[NWARPS];

  const int e0 = blockIdx.x * DVT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const int64_t vrow = static_cast<int64_t>(heads) * dv;  // one token of v
  const T* vb = v + static_cast<int64_t>(b) * t_len * vrow
                + static_cast<int64_t>(h) * dv + e0;
  T* yb = y + static_cast<int64_t>(b) * t_len * vrow
          + static_cast<int64_t>(h) * dv + e0;
  const float* lab = log_a + static_cast<int64_t>(b) * t_len * heads + h;
  const int64_t hoff = (static_cast<int64_t>(b) * heads + h) * dk * dv + e0;

  for (int idx = i; idx < DK * DVT; idx += NT) {
    const int d = idx / DVT, e = idx % DVT;
    hs[d][e] = (d < dk && e0 + e < dv) ? h0[hoff + d * dv + e] : 0.f;
  }

  for (int c0 = 0; c0 < t_len; c0 += chunk) {
    const int n = min(chunk, t_len - c0);  // live rows of this chunk
    // stage k and this CTA's columns of v; rows >= n and padding are 0
    for (int idx = i; idx < chunk * DK; idx += NT) {
      const int j = idx / DK, d = idx % DK;
      ks[j][d] = (j < n && d < dk) ? load_one(kb + (c0 + j) * kst + d) : 0.f;
    }
    for (int idx = i; idx < chunk * DVT; idx += NT) {
      const int j = idx / DVT, e = idx % DVT;
      vs[j][e] = (j < n && e0 + e < dv)
                     ? load_one(vb + (c0 + j) * vrow + e) : 0.f;
    }
    float qr[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d)
      qr[d] = (i < n && d < dk) ? load_one(qb + (c0 + i) * qst + d) : 0.f;
    // inclusive scan of log_a over the chunk's rows
    float L = i < n ? lab[static_cast<int64_t>(c0 + i) * heads] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, L, off);
      if (lane >= off) L += up;
    }
    if (lane == 31) warp_tot[warp] = L;
    __syncthreads();  // ks, vs, warp totals, and hs of the previous chunk
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) L += w < warp ? warp_tot[w] : 0.f;
    Ls[i] = L;
    __syncthreads();
    const float l_last = Ls[n - 1];  // rows past n add 0 to the sum
    rem[i] = i < n ? expf(l_last - L) : 0.f;

    // y_i = exp(L_i) q_i . H + sum_{j <= i} (q_i . k_j) exp(L_i - L_j) v_j
    float acc[DVT];
    {
      const float a = expf(L);
#pragma unroll
      for (int e = 0; e < DVT; ++e) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) s += qr[d] * hs[d][e];
        acc[e] = a * s;
      }
    }
    // the warp's rows are 32*warp .. 32*warp+31: a uniform loop bound
    const int j_end = min(warp * 32 + 31, n - 1);
    for (int j = 0; j <= j_end; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) s += qr[d] * ks[j][d];
      const float w = j <= i ? s * expf(L - Ls[j]) : 0.f;  // mask, then exp
#pragma unroll
      for (int e = 0; e < DVT; ++e) acc[e] += w * vs[j][e];
    }
    if (i < n) {
      T* yp = yb + (c0 + i) * vrow;
#pragma unroll
      for (int e = 0; e < DVT; ++e)
        if (e0 + e < dv) store_one(yp + e, acc[e]);
    }
    __syncthreads();  // every read of hs and rem's writes are done

    // H = exp(L_last) H + sum_j exp(L_last - L_j) k_j v_j^T
    const float decay = expf(l_last);
#pragma unroll
    for (int r = 0; r < NE; ++r) {
      const int idx = i + r * NT;
      const int d = idx / DVT, e = idx % DVT;
      float s = decay * hs[d][e];
      for (int j = 0; j < n; ++j) s += rem[j] * ks[j][d] * vs[j][e];
      hs[d][e] = s;
    }
    __syncthreads();  // ks and vs are restaged next chunk
  }

  for (int idx = i; idx < DK * DVT; idx += NT) {
    const int d = idx / DVT, e = idx % DVT;
    if (d < dk && e0 + e < dv) h_t[hoff + d * dv + e] = hs[d][e];
  }
}

template <typename T, int DK>
void launch(const void* q, const void* k, const void* v, const float* log_a,
            const float* h0, void* y, float* h_t, int batch, int t_len,
            int heads, int dk, int dv, int chunk, const int64_t* qs,
            const int64_t* ks, cudaStream_t stream) {
  dim3 grid((dv + DVT - 1) / DVT, heads, batch);
  ssm_scan_kernel<T, DK><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_a, h0, static_cast<T*>(y), h_t, t_len,
      heads, dk, dv, chunk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2]);
}

template <typename T>
void dispatch_dk(const void* q, const void* k, const void* v,
                 const float* log_a, const float* h0, void* y, float* h_t,
                 int batch, int t_len, int heads, int dk, int dv, int chunk,
                 const int64_t* qs, const int64_t* ks, cudaStream_t s) {
  if (dk <= 16)
    launch<T, 16>(q, k, v, log_a, h0, y, h_t, batch, t_len, heads, dk, dv,
                  chunk, qs, ks, s);
  else if (dk <= 32)
    launch<T, 32>(q, k, v, log_a, h0, y, h_t, batch, t_len, heads, dk, dv,
                  chunk, qs, ks, s);
  else
    launch<T, 64>(q, k, v, log_a, h0, y, h_t, batch, t_len, heads, dk, dv,
                  chunk, qs, ks, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16 (q, k, v and y; log_a, h0 and h_T are float32).  Strides are in
// elements.  Returns cudaGetLastError() after the launch, or -1 when a
// size is out of range (dk and dv 1..64, chunk 1..128).  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int ssm_scan_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* log_a,
                               const void* h0, void* y, void* h_t, int batch,
                               int t_len, int heads, int dk, int dv,
                               int chunk, long long qsb, long long qst,
                               long long qsh, long long ksb, long long kst,
                               long long ksh, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || dk < 1 || dk > 64 ||
      dv < 1 || dv > 64 || chunk < 1 || chunk > CMAX)
    return -1;
  const int64_t qs[3] = {qsb, qst, qsh};
  const int64_t ks[3] = {ksb, kst, ksh};
  const auto* la = static_cast<const float*>(log_a);
  const auto* hi = static_cast<const float*>(h0);
  auto* ho = static_cast<float*>(h_t);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch_dk<float>(q, k, v, la, hi, y, ho, batch, t_len, heads, dk, dv,
                       chunk, qs, ks, s);
  else if (dtype == 1)
    dispatch_dk<__nv_bfloat16>(q, k, v, la, hi, y, ho, batch, t_len, heads,
                               dk, dv, chunk, qs, ks, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
