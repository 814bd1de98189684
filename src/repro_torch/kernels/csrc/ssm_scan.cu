// Chunked decayed linear-recurrence scan (mamba-2 / SSD form) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan /
// _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::ssm_scan.  On the port's path it is the chunked
// scan of every hymba layer's mamba branch at prefill (models/ssm.py); at
// dk 512 and dv 513 it is an xlstm-350m mLSTM layer's.
//
// What it computes, per (batch b, head h), with an f32 state H (dk x dv):
//   H_t = exp(log_a_t) H_{t-1} + k_t v_t^T,   y_t = q_t . H_t,   H_0 = h0
// chunk-parallel: with L the inclusive cumulative sum of log_a inside a
// chunk,
//   y_i   = sum_{j <= i} (q_i . k_j) exp(L_i - L_j) v_j + exp(L_i) q_i . H
//   H_new = exp(L_last) H + sum_j exp(L_last - L_j) k_j v_j^T
// The mask j <= i is applied before the exponential: L_i - L_j for j > i is
// a large positive number (L reaches about -90 within 128 tokens at hymba's
// decay), and exp of it times a zero would be inf * 0 = NaN.  y takes v's
// type; log_a, h0, H_T and every state are f32.  The real T is taken: rows
// of a ragged last chunk past T act as log_a = 0, k = q = v = 0, so the
// state passes them unchanged (as ops.ssm_scan's padding does), and their
// y is not written.
//
// Layouts are the model's, so nothing is transposed:
//   q, k   (B, T, H, dk)  at b*s_b + t*s_t + h*s_h + d, strides given (a
//          head stride of 0 broadcasts one row over all heads: hymba's
//          B/C projections are shared by its 50 SSM heads)
//   v, y   (B, T, H, dv)  contiguous
//   log_a  (B, T, H) f32 contiguous;  h0, h_T (B, H, dk, dv) f32 contiguous
//   states (B, H, nc, dk, dv) f32 and decay (B, H, nc) f32: scratch
//
// What bounds it: bytes.  At hymba's prefill (B = 1, H = 50, T = 1024, dk
// 16, dv 64, bf16) q, k (one row for all heads), v and y are ~13 MB:
// ~4 us at 3.35 TB/s, against ~1.3 GFLOP.  The TPU walks (B, H, chunks)
// with the chunk axis sequential and the state in VMEM; a CTA that loops
// over the chunks, as the first port did, leaves 200 CTAs of 128 threads
// on a card that holds 270 K threads, each chunk a chain of sequential
// row loops.  The design here is mamba-2's chunk decomposition, in three
// launches, with only nc elementwise steps sequential:
//
// 1. ssm_chunk_state_kernel, one CTA per (b, h, chunk, state tile of 16,
//    32 or 64 rows of dk x 64 of dv): S_c = sum_j exp(L_last - L_j) k_j
//    v_j^T on the CUDA cores in f32 (a 16 x 64 x 128 product at hymba),
//    and a_c = exp(L_last).  400 CTAs at hymba's T = 1024.
// 2. ssm_state_pass_kernel, one thread per (b, h, state entry): H_c =
//    a_c H_{c-1} + S_c from h0 over the chunks in order; it overwrites S_c
//    with the state entering chunk c and writes H_T.
// 3. the chunk outputs, one CTA per (b, h, chunk, 64 columns of dv):
//    y_i = sum_{j <= i} (q_i . k_j) exp(L_i - L_j) v_j + exp(L_i) q_i . H.
//    * bf16 with dk <= 64 (hymba; dk and dv multiples of 8 and 16-byte
//      aligned rows): ssm_chunk_output_mma_kernel.  Four warps, each two
//      16-row blocks (w and 7 - w, nine key steps a warp under the causal
//      mask); per 16-key step, Q K^T on mma.sync m16n8k16 with f32
//      accumulators, the mask-then-exp decay in registers, the weighted
//      scores (signed) as the A fragments of P V in bf16 (the C layout of
//      m16n8 is the A layout of m16n8k16), as flash_attention.cu does
//      with P.  P in bf16 moves y's f32 sums by up to 7.4e-3 at |y| ~ 4
//      (on the CPU), within the bf16 band of 2e-2 (PERF.md §6).  Only the
//      key steps at or below a warp's rows run.  The inter-chunk term
//      q . H stays in f32 FMAs (dk per output).
//    * otherwise (f32, or dk above 64, e.g. mLSTM's 512 and 513, and at
//      xLSTM's 1.3B width 1024 and 1025): ssm_chunk_output_kernel, f32
//      FMAs on the CUDA cores (no TF32),
//      the (chunk x chunk) scores in shared memory from dk tiles of 32,
//      then q . H over the same tiles and P V; the scores are computed
//      again for every 64 columns of dv.
// Nothing is reduced across CTAs with atomics, so the result does not
// depend on scheduling.  The three launches and their grids read no
// device value on the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CMAX = 128;        // largest chunk
constexpr int NT = 256;          // threads per CTA
constexpr int TILE = 64;         // state tile of phases 1-2; dv tile of 3
constexpr int JB = 64;           // chunk rows staged at a time in phase 1
constexpr int DKT = 32;          // dk staged at a time in the f32 phase 3
constexpr int PASS_BATCH = 8;    // chunks whose loads phase 2 issues at once

struct Strides {
  int64_t qb, qt, qh, kb, kt, kh;
};

// Ls[i] = log_a summed over rows 0 .. i of the chunk (rows past n as 0),
// by the first CMAX threads: warp-shuffle scans and the warps' totals.
// Every thread of the CTA calls it.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ la,
                                             int64_t step, int n, float* Ls,
                                             float* warp_tot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float L = 0.f;
  if (tid < CMAX) {
    L = tid < n ? la[tid * step] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, L, off);
      if (lane >= off) L += up;
    }
    if (lane == 31) warp_tot[warp] = L;
  }
  __syncthreads();
  if (tid < CMAX) {
#pragma unroll
    for (int w = 0; w < CMAX / 32; ++w) L += w < warp ? warp_tot[w] : 0.f;
    Ls[tid] = L;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Phase 1: chunk states.  grid (nc, H * dk tiles * dv tiles, B), state
// tiles of DKR (16, 32 or 64, the least that holds dk up to 64) x 64: a
// thread owns DKR / 16 rows x 4 columns, so no thread works on rows past
// dk at hymba's dk 16.
// ---------------------------------------------------------------------------

template <typename T, int DKR, bool VEC>
__global__ void __launch_bounds__(NT)
ssm_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ log_a,
                       float* __restrict__ states, float* __restrict__ decay,
                       int t_len, int heads, int dk, int dv, int chunk,
                       int nc, int n_dvt, int64_t ksb, int64_t kst,
                       int64_t ksh) {
  constexpr int RPT = DKR / 16;               // state rows per thread
  __shared__ float Ls[CMAX];
  __shared__ float rem[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) float ks[JB][DKR];
  __shared__ __align__(16) float vs[JB][TILE];

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y % heads;
  const int dv0 = (blockIdx.y / heads % n_dvt) * TILE;
  const int dk0 = (blockIdx.y / heads / n_dvt) * DKR;
  const int b = blockIdx.z;
  const int c0 = c * chunk;
  const int n = min(chunk, t_len - c0);       // live rows of this chunk

  chunk_cumsum(log_a + (static_cast<int64_t>(b) * t_len + c0) * heads + h,
               heads, n, Ls, warp_tot);
  const float l_last = Ls[n - 1];             // rows past n add 0
  if (tid < CMAX) rem[tid] = tid < n ? expf(l_last - Ls[tid]) : 0.f;

  const T* kb = k + b * ksb + h * ksh + c0 * kst;
  const int64_t vrow = static_cast<int64_t>(heads) * dv;   // one token of v
  const T* vb = v + (static_cast<int64_t>(b) * t_len + c0) * vrow
                + static_cast<int64_t>(h) * dv;
  const int ty = tid / 16;                    // rows dk0 + RPT ty ..
  const int tx = tid % 16;                    // columns dv0 + 4 tx ..
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j0 = 0; j0 < n; j0 += JB) {
    __syncthreads();            // rem is written; the last block consumed
    if constexpr (VEC) {
      // 16 bytes a load (bf16, dk and dv multiples of 8, aligned rows)
      for (int idx = tid; idx < JB * DKR / 8; idx += NT) {
        const int jj = idx / (DKR / 8), d = (idx % (DKR / 8)) * 8;
        const int j = j0 + jj;
        float f[8];
        if (j < n && dk0 + d < dk) {
          to_float(load16(kb + j * kst + dk0 + d), f);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = 0.f;
        }
        const float r = j < n ? rem[j] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) ks[jj][d + i] = f[i] * r;
      }
#pragma unroll
      for (int i = 0; i < JB * TILE / 8 / NT; ++i) {
        const int idx = tid + i * NT;
        const int jj = idx / (TILE / 8), e = (idx % (TILE / 8)) * 8;
        const int j = j0 + jj;
        float f[8];
        if (j < n && dv0 + e < dv) {
          to_float(load16(vb + j * vrow + dv0 + e), f);
        } else {
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8) f[c8] = 0.f;
        }
        *reinterpret_cast<float4*>(&vs[jj][e]) =
            make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(&vs[jj][e + 4]) =
            make_float4(f[4], f[5], f[6], f[7]);
      }
    } else {
      for (int idx = tid; idx < JB * DKR; idx += NT) {
        const int jj = idx / DKR, d = idx % DKR, j = j0 + jj;
        ks[jj][d] = j < n && dk0 + d < dk
                        ? load_one(kb + j * kst + dk0 + d) * rem[j] : 0.f;
      }
      for (int idx = tid; idx < JB * TILE; idx += NT) {
        const int jj = idx / TILE, e = idx % TILE, j = j0 + jj;
        vs[jj][e] = j < n && dv0 + e < dv
                        ? load_one(vb + j * vrow + dv0 + e) : 0.f;
      }
    }
    __syncthreads();
    const int jn = min(JB, n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 vr = *reinterpret_cast<const float4*>(&vs[jj][tx * 4]);
      const float vv[4] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float kv = ks[jj][ty * RPT + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(kv, vv[e], acc[i][e]);
      }
    }
  }

  float* sp = states + ((static_cast<int64_t>(b) * heads + h) * nc + c)
                       * dk * dv;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int d = dk0 + ty * RPT + i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = dv0 + tx * 4 + e;
      if (d < dk && col < dv) sp[static_cast<int64_t>(d) * dv + col] =
          acc[i][e];
    }
  }
  if (dk0 == 0 && dv0 == 0 && tid == 0)
    decay[(static_cast<int64_t>(b) * heads + h) * nc + c] = expf(l_last);
}

// ---------------------------------------------------------------------------
// Phase 2: the state pass.  grid (ceil(dk dv / NT), H, B).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
ssm_state_pass_kernel(const float* __restrict__ h0, float* __restrict__ states,
                      const float* __restrict__ decay,
                      float* __restrict__ h_t, int heads, int dk, int dv,
                      int nc) {
  const int64_t sz = static_cast<int64_t>(dk) * dv;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (idx >= sz) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * heads + blockIdx.y;
  float H = h0[bh * sz + idx];
  float* sp = states + bh * nc * sz + idx;
  const float* ap = decay + bh * nc;
  // the loads of a batch of chunks do not wait on H
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float s[PASS_BATCH], a[PASS_BATCH];
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i) {
      s[i] = c0 + i < nc ? sp[(c0 + i) * sz] : 0.f;
      a[i] = c0 + i < nc ? ap[c0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i) {
      if (c0 + i < nc) {
        sp[(c0 + i) * sz] = H;                // the state entering the chunk
        H = fmaf(a[i], H, s[i]);
      }
    }
  }
  h_t[bh * sz + idx] = H;
}

// ---------------------------------------------------------------------------
// Phase 3, f32 FMAs: grid (nc, H * dv tiles, B), dynamic shared memory
// GEN_SMEM.
// ---------------------------------------------------------------------------

constexpr int PP = CMAX + 1;            // score tile pitch
constexpr int TP = CMAX + 4;            // transposed q / k tile pitch
constexpr int VP = TILE + 4;            // v and state tile pitch
constexpr int BUF = CMAX * VP > 2 * DKT * TP ? CMAX * VP : 2 * DKT * TP;
constexpr int GEN_SMEM = (CMAX * PP + BUF) * 4;

// rows 0 .. CMAX-1 (zero past n) and dk d0 .. d0 + DKT - 1 (zero past dk)
// of a q or k chunk into a transposed f32 tile t[d * TP + row]
template <typename T>
__device__ __forceinline__ void stage_transposed(float* t, const T* base,
                                                 int64_t row_stride, int n,
                                                 int d0, int dk) {
  for (int idx = threadIdx.x; idx < CMAX * DKT; idx += NT) {
    const int r = idx / DKT, d = idx % DKT;
    t[d * TP + r] = r < n && d0 + d < dk
                        ? load_one(base + r * row_stride + d0 + d) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssm_chunk_output_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ log_a,
                        const float* __restrict__ states, T* __restrict__ y,
                        int t_len, int heads, int dk, int dv, int chunk,
                        int nc, Strides st) {
  extern __shared__ __align__(16) float sm[];
  float* P = sm;                    // [CMAX][PP] decayed, masked scores
  float* buf = sm + CMAX * PP;      // q^T, k^T; then q^T, H; then v
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y % heads;
  const int dv0 = (blockIdx.y / heads) * TILE;
  const int b = blockIdx.z;
  const int c0 = c * chunk;
  const int n = min(chunk, t_len - c0);

  chunk_cumsum(log_a + (static_cast<int64_t>(b) * t_len + c0) * heads + h,
               heads, n, Ls, warp_tot);
  const T* qb = q + b * st.qb + h * st.qh + c0 * st.qt;
  const T* kb = k + b * st.kb + h * st.kh + c0 * st.kt;
  const int64_t vrow = static_cast<int64_t>(heads) * dv;
  const int64_t yoff = (static_cast<int64_t>(b) * t_len + c0) * vrow
                       + static_cast<int64_t>(h) * dv;

  // scores: thread (ty, tx) owns rows 8 ty .. and keys 8 tx ..; a block
  // with every key past every row (tx > ty) is all zeros
  {
    const int ty = tid / 16, tx = tid % 16;
    const bool need = tx <= ty;
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    float* Qt = buf;
    float* Kt = buf + DKT * TP;
    for (int d0 = 0; d0 < dk; d0 += DKT) {
      __syncthreads();
      stage_transposed(Qt, qb, st.qt, n, d0, dk);
      stage_transposed(Kt, kb, st.kt, n, d0, dk);
      __syncthreads();
      if (need) {
        const int dn = min(DKT, dk - d0);
        for (int d = 0; d < dn; ++d) {
          float qr[8], kr[8];
          const float4 q0 = *reinterpret_cast<const float4*>(
              &Qt[d * TP + ty * 8]);
          const float4 q1 = *reinterpret_cast<const float4*>(
              &Qt[d * TP + ty * 8 + 4]);
          const float4 k0 = *reinterpret_cast<const float4*>(
              &Kt[d * TP + tx * 8]);
          const float4 k1 = *reinterpret_cast<const float4*>(
              &Kt[d * TP + tx * 8 + 4]);
          qr[0] = q0.x; qr[1] = q0.y; qr[2] = q0.z; qr[3] = q0.w;
          qr[4] = q1.x; qr[5] = q1.y; qr[6] = q1.z; qr[7] = q1.w;
          kr[0] = k0.x; kr[1] = k0.y; kr[2] = k0.z; kr[3] = k0.w;
          kr[4] = k1.x; kr[5] = k1.y; kr[6] = k1.z; kr[7] = k1.w;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
        }
      }
    }
    // P_ij = s_ij exp(L_i - L_j) for j <= i, masked before the exponential
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = tx * 8 + j;
        const float ld = key <= row ? Ls[row] - Ls[key] : -INFINITY;
        P[row * PP + key] = need ? s[i][j] * expf(ld) : 0.f;
      }
    }
  }

  // y tile: thread (ry, cx) owns rows 4 ry .. and columns dv0 + 8 cx ..
  const int ry = tid / 8, cx = tid % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  // inter-chunk: exp(L_i) q_i . H, over dk tiles
  const float* hp = states + ((static_cast<int64_t>(b) * heads + h) * nc + c)
                             * dk * dv;
  float* Qt = buf;
  float* Hs = buf + DKT * TP;
  for (int d0 = 0; d0 < dk; d0 += DKT) {
    __syncthreads();                // the scores' (or last tile's) reads
    stage_transposed(Qt, qb, st.qt, n, d0, dk);
    for (int idx = tid; idx < DKT * TILE; idx += NT) {
      const int d = idx / TILE, e = idx % TILE;
      Hs[d * VP + e] = d0 + d < dk && dv0 + e < dv
                           ? hp[static_cast<int64_t>(d0 + d) * dv + dv0 + e]
                           : 0.f;
    }
    __syncthreads();
    const int dn = min(DKT, dk - d0);
    for (int d = 0; d < dn; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * TP + ry * 4]);
      const float4 h0v = *reinterpret_cast<const float4*>(
          &Hs[d * VP + cx * 8]);
      const float4 h1v = *reinterpret_cast<const float4*>(
          &Hs[d * VP + cx * 8 + 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float hr[8] = {h0v.x, h0v.y, h0v.z, h0v.w,
                           h1v.x, h1v.y, h1v.z, h1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(qr[i], hr[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = expf(Ls[ry * 4 + i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] *= a;
  }

  // intra-chunk: P V over the keys up to this thread's last row
  __syncthreads();
  float* Vs = buf;
  for (int idx = tid; idx < CMAX * TILE; idx += NT) {
    const int j = idx / TILE, e = idx % TILE;
    Vs[j * VP + e] = j < n && dv0 + e < dv
                         ? load_one(v + yoff + j * vrow + dv0 + e) : 0.f;
  }
  __syncthreads();
  const int j_end = min(ry * 4 + 3, n - 1);
  for (int j = 0; j <= j_end; ++j) {
    const float4 v0 = *reinterpret_cast<const float4*>(&Vs[j * VP + cx * 8]);
    const float4 v1 = *reinterpret_cast<const float4*>(
        &Vs[j * VP + cx * 8 + 4]);
    const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = P[(ry * 4 + i) * PP + j];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p, vr[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ry * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = dv0 + cx * 8 + e;
      if (col < dv) store_one(y + yoff + row * vrow + col, acc[i][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Phase 3, bf16 on the tensor cores (dk <= DKP <= 64): grid (nc, H * dv
// tiles, B), MMA_NT threads, dynamic shared memory MmaLayout<DKP>::SMEM.
// Four warps, each two 16-row blocks of the chunk, w and 7 - w: the
// causal triangle gives row block r r + 1 key steps, so every warp takes
// nine.
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;

template <int DKP>
struct MmaLayout {
  static constexpr int QP = DKP + 8;     // q, k tile pitch, bf16
  static constexpr int VPB = TILE + 8;   // v tile pitch, bf16
  static constexpr int HP = TILE + 4;    // state tile pitch, f32
  static constexpr int Q_ELEMS = CMAX * QP;
  static constexpr int V_ELEMS = CMAX * VPB;
  static constexpr int SMEM = (2 * Q_ELEMS + V_ELEMS) * 2 + DKP * HP * 4;
};

template <int DKP>
__global__ void __launch_bounds__(MMA_NT, 3)
ssm_chunk_output_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ log_a,
                            const float* __restrict__ states,
                            __nv_bfloat16* __restrict__ y, int t_len,
                            int heads, int dk, int dv, int chunk, int nc,
                            Strides st) {
  using L = MmaLayout<DKP>;
  constexpr int QP = L::QP, VPB = L::VPB, HP = L::HP;
  constexpr int KS = DKP / 16;                // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + L::Q_ELEMS;
  __nv_bfloat16* Vs = Ks + L::Q_ELEMS;
  float* Hs = reinterpret_cast<float*>(Vs + L::V_ELEMS);
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = blockIdx.x;
  const int h = blockIdx.y % heads;
  const int dv0 = (blockIdx.y / heads) * TILE;
  const int b = blockIdx.z;
  const int c0 = c * chunk;
  const int n = min(chunk, t_len - c0);

  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh + c0 * st.qt;
  const __nv_bfloat16* kb = k + b * st.kb + h * st.kh + c0 * st.kt;
  const int64_t vrow = static_cast<int64_t>(heads) * dv;
  const int64_t yoff = (static_cast<int64_t>(b) * t_len + c0) * vrow
                       + static_cast<int64_t>(h) * dv;
  const float* hp = states + ((static_cast<int64_t>(b) * heads + h) * nc + c)
                             * dk * dv;

  // q, k and this CTA's 64 columns of v, 16 bytes at a time, zeros past
  // n, dk and dv; the entering state's columns as f32
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < CMAX * (DKP / 8) / MMA_NT; ++i) {
    const int idx = tid + i * MMA_NT;
    const int r = idx / (DKP / 8), col = (idx % (DKP / 8)) * 8;
    const bool ok = r < n && col < dk;
    *reinterpret_cast<uint4*>(&Qs[r * QP + col]) =
        ok ? *reinterpret_cast<const uint4*>(qb + r * st.qt + col) : zero;
    *reinterpret_cast<uint4*>(&Ks[r * QP + col]) =
        ok ? *reinterpret_cast<const uint4*>(kb + r * st.kt + col) : zero;
  }
#pragma unroll
  for (int i = 0; i < CMAX * (TILE / 8) / MMA_NT; ++i) {
    const int idx = tid + i * MMA_NT;
    const int r = idx / (TILE / 8), col = (idx % (TILE / 8)) * 8;
    const bool ok = r < n && dv0 + col < dv;
    *reinterpret_cast<uint4*>(&Vs[r * VPB + col]) =
        ok ? *reinterpret_cast<const uint4*>(v + yoff + r * vrow + dv0 + col)
           : zero;
  }
#pragma unroll
  for (int i = 0; i < DKP * TILE / MMA_NT; ++i) {
    const int idx = tid + i * MMA_NT;
    const int d = idx / TILE, e = idx % TILE;
    Hs[d * HP + e] = d < dk && dv0 + e < dv
                         ? hp[static_cast<int64_t>(d) * dv + dv0 + e] : 0.f;
  }
  // (its barriers also publish the tiles above)
  chunk_cumsum(log_a + (static_cast<int64_t>(b) * t_len + c0) * heads + h,
               heads, n, Ls, warp_tot);

  for (int pass = 0; pass < 2; ++pass) {
    const int rb = pass == 0 ? warp : CMAX / 16 - 1 - warp;   // row block
    const int w0 = rb * 16;                     // its first row
    if (w0 >= n) continue;                      // no barrier follows
    const int gq = lane >> 2, tq = lane & 3;
    const int r0 = w0 + gq, r1 = r0 + 8;
    const float L0 = Ls[r0], L1 = Ls[r1];

    // inter-chunk, f32: acc = exp(L_i) q_i . H
    float acc[TILE / 8][4];
#pragma unroll
    for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    for (int d = 0; d < dk; ++d) {
      const float qa0 = __bfloat162float(Qs[r0 * QP + d]);
      const float qa1 = __bfloat162float(Qs[r1 * QP + d]);
#pragma unroll
      for (int nd = 0; nd < TILE / 8; ++nd) {
        const float2 hv = *reinterpret_cast<const float2*>(
            &Hs[d * HP + nd * 8 + 2 * tq]);
        acc[nd][0] = fmaf(qa0, hv.x, acc[nd][0]);
        acc[nd][1] = fmaf(qa0, hv.y, acc[nd][1]);
        acc[nd][2] = fmaf(qa1, hv.x, acc[nd][2]);
        acc[nd][3] = fmaf(qa1, hv.y, acc[nd][3]);
      }
    }
    {
      const float e0 = expf(L0), e1 = expf(L1);
#pragma unroll
      for (int nd = 0; nd < TILE / 8; ++nd) {
        acc[nd][0] *= e0;
        acc[nd][1] *= e0;
        acc[nd][2] *= e1;
        acc[nd][3] *= e1;
      }
    }

    // the warp's 16 rows of q as A fragments
    unsigned qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::ldmatrix_x4(qa[kk], Qs + (w0 + (lane & 15)) * QP + kk * 16
                                      + (lane >> 4) * 8);

    // intra-chunk, one 16-key step at a time, up to the warp's last row
#pragma unroll
    for (int ks = 0; ks < CMAX / 16; ++ks) {
      if (ks > rb) break;                       // keys past every row
      float s[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half][e] = 0.f;
        const int key0 = ks * 16 + half * 8;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          unsigned b0, b1;
          hopper::ldmatrix_x2(b0, b1, Ks + (key0 + (lane & 7)) * QP + kk * 16
                                          + ((lane >> 3) & 1) * 8);
          hopper::mma_bf16(s[half], qa[kk], b0, b1);
        }
      }
      // decay, the mask before the exponential; P as the A fragments
      unsigned pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = ks * 16 + half * 8 + 2 * tq;
        const float lk0 = Ls[key], lk1 = Ls[key + 1];
        pa[half * 2] = hopper::pack_bf16x2(
            s[half][0] * expf(key <= r0 ? L0 - lk0 : -INFINITY),
            s[half][1] * expf(key + 1 <= r0 ? L0 - lk1 : -INFINITY));
        pa[half * 2 + 1] = hopper::pack_bf16x2(
            s[half][2] * expf(key <= r1 ? L1 - lk0 : -INFINITY),
            s[half][3] * expf(key + 1 <= r1 ? L1 - lk1 : -INFINITY));
      }
      // y += P V: keys ks*16 .. +15, columns nd*8 .. nd*8+15
#pragma unroll
      for (int nd = 0; nd < TILE / 8; nd += 2) {
        unsigned vf[4];
        hopper::ldmatrix_x4_trans(
            vf, Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VPB
                    + nd * 8 + (lane >> 4) * 8);
        hopper::mma_bf16(acc[nd], pa, vf[0], vf[1]);
        hopper::mma_bf16(acc[nd + 1], pa, vf[2], vf[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (row >= n) continue;
      __nv_bfloat16* yp = y + yoff + row * vrow + dv0 + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < TILE / 8; ++nd)
        if (dv0 + nd * 8 < dv)            // dv % 8 == 0: whole 8-column tiles
          *reinterpret_cast<__nv_bfloat162*>(yp + nd * 8) =
              __floats2bfloat162_rn(acc[nd][2 * r], acc[nd][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename KernelT>
cudaError_t allow_smem(KernelT* kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int DKP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* log_a, const float* states, void* y,
                       int batch, int t_len, int heads, int dk, int dv,
                       int chunk, int nc, const Strides& st,
                       cudaStream_t stream) {
  constexpr int SMEM = MmaLayout<DKP>::SMEM;
  static bool smem_set = false;   // the attribute, once per instantiation
  const cudaError_t err =
      allow_smem(ssm_chunk_output_mma_kernel<DKP>, SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(nc, heads * ((dv + TILE - 1) / TILE), batch);
  ssm_chunk_output_mma_kernel<DKP><<<grid, MMA_NT, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), log_a, states,
      static_cast<__nv_bfloat16*>(y), t_len, heads, dk, dv, chunk, nc, st);
  return cudaGetLastError();
}

template <typename T, bool VEC>
void launch_state(int dkr, dim3 grid, const void* k, const void* v,
                  const float* log_a, float* states, float* decay, int t_len,
                  int heads, int dk, int dv, int chunk, int nc, int n_dvt,
                  const Strides& st, cudaStream_t stream) {
#define SSM_STATE(DKR_)                                                      \
  ssm_chunk_state_kernel<T, DKR_, VEC><<<grid, NT, 0, stream>>>(             \
      static_cast<const T*>(k), static_cast<const T*>(v), log_a, states,     \
      decay, t_len, heads, dk, dv, chunk, nc, n_dvt, st.kb, st.kt, st.kh)
  if (dkr == 16)
    SSM_STATE(16);
  else if (dkr == 32)
    SSM_STATE(32);
  else
    SSM_STATE(64);
#undef SSM_STATE
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v,
               const float* log_a, const float* h0, void* y, float* h_t,
               float* states, float* decay, int batch, int t_len, int heads,
               int dk, int dv, int chunk, int fast, const Strides& st,
               cudaStream_t stream) {
  const int nc = (t_len + chunk - 1) / chunk;
  const int dkr = dk <= 16 ? 16 : dk <= 32 ? 32 : TILE;
  const int n_dkt = (dk + dkr - 1) / dkr;
  const int n_dvt = (dv + TILE - 1) / TILE;
  if (static_cast<int64_t>(heads) * n_dkt * n_dvt > 65535 || batch > 65535 ||
      (static_cast<int64_t>(dk) * dv + NT - 1) / NT > 0x7fffffffLL)
    return -1;
  const dim3 sgrid(nc, heads * n_dkt * n_dvt, batch);
  // 16-byte loads in phase 1 where phase 3 takes them too (bf16, aligned)
  if constexpr (sizeof(T) == 2) {
    if (fast)
      launch_state<T, true>(dkr, sgrid, k, v, log_a, states, decay, t_len,
                            heads, dk, dv, chunk, nc, n_dvt, st, stream);
    else
      launch_state<T, false>(dkr, sgrid, k, v, log_a, states, decay, t_len,
                             heads, dk, dv, chunk, nc, n_dvt, st, stream);
  } else {
    launch_state<T, false>(dkr, sgrid, k, v, log_a, states, decay, t_len,
                           heads, dk, dv, chunk, nc, n_dvt, st, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = static_cast<int64_t>(dk) * dv;
  const dim3 pgrid(static_cast<unsigned>((entries + NT - 1) / NT), heads,
                   batch);
  ssm_state_pass_kernel<<<pgrid, NT, 0, stream>>>(h0, states, decay, h_t,
                                                  heads, dk, dv, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fast) {
    if constexpr (sizeof(T) == 2) {
      if (dk <= 16)
        err = launch_mma<16>(q, k, v, log_a, states, y, batch, t_len, heads,
                             dk, dv, chunk, nc, st, stream);
      else if (dk <= 32)
        err = launch_mma<32>(q, k, v, log_a, states, y, batch, t_len, heads,
                             dk, dv, chunk, nc, st, stream);
      else
        err = launch_mma<64>(q, k, v, log_a, states, y, batch, t_len, heads,
                             dk, dv, chunk, nc, st, stream);
    } else {
      return -1;
    }
  } else {
    static bool smem_set = false;
    err = allow_smem(ssm_chunk_output_kernel<T>, GEN_SMEM, smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssm_chunk_output_kernel<T><<<dim3(nc, heads * n_dvt, batch), NT,
                                 GEN_SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), log_a, states, static_cast<T*>(y), t_len,
        heads, dk, dv, chunk, nc, st);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point, loaded with ctypes: the three phases on `stream`.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and y; log_a, h0, h_T and the
// scratch are float32).  fast: 1 takes the tensor-core phase 3 (bf16, dk
// <= 64, dk and dv multiples of 8, 16-byte aligned rows of q, k and v; the
// wrapper checks), 0 the CUDA-core one.  states: B * H * nc * dk * dv
// floats, decay: B * H * nc floats, nc = ceil(T / chunk).  Strides are in
// elements.  Returns the CUDA error of the launches (0 on success), or -1
// when a size is out of range (dk and dv from 1, chunk 1..128, the grids'
// rows: H x dk tiles x dv tiles and B at most 65535, phase 2's dk dv / 256
// CTAs below 2^31).  Nothing is allocated and nothing synchronises.
extern "C" int ssm_scan_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* log_a,
                               const void* h0, void* y, void* h_t,
                               void* states, void* decay, int batch,
                               int t_len, int heads, int dk, int dv,
                               int chunk, int fast, long long qsb,
                               long long qst, long long qsh, long long ksb,
                               long long kst, long long ksh, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || dk < 1 || dv < 1 ||
      chunk < 1 || chunk > CMAX ||
      (fast && (dtype != 1 || dk > 64 || dk % 8 != 0 || dv % 8 != 0)))
    return -1;
  const Strides st{qsb, qst, qsh, ksb, kst, ksh};
  const auto* la = static_cast<const float*>(log_a);
  const auto* hi = static_cast<const float*>(h0);
  auto* ho = static_cast<float*>(h_t);
  auto* sp = static_cast<float*>(states);
  auto* dp = static_cast<float*>(decay);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(q, k, v, la, hi, y, ho, sp, dp, batch, t_len,
                             heads, dk, dv, chunk, 0, st, s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(q, k, v, la, hi, y, ho, sp, dp, batch,
                                     t_len, heads, dk, dv, chunk, fast, st, s);
  return -1;
}
