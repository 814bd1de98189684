// Backward of the chunked decayed linear-recurrence scan for NVIDIA Hopper
// (sm_90a).
//
// The reference has no backward kernel: the JAX package trains hymba's
// mamba branch and xLSTM's mLSTM through the jnp chunked scan
// (src/repro/models/ssm.py::chunked_linear_attention) and differentiates it
// with jax.grad.  The port's training scan is the forward kernel of
// ssm_scan.cu (the Hopper counterpart of the Pallas TPU kernel
// src/repro/kernels/ssm_scan.py::ssm_scan), so its gradient is this kernel,
// through the autograd Function of kernels/ssm_scan.py.
//
// What it computes, per (batch b, head h), for the forward
//   H_t = exp(la_t) H_{t-1} + k_t v_t^T,   y_t = q_t . H_t,   H_{-1} = h0
// given dy_t = dL/dy_t and dH_T = dL/dH_T (zero when absent): with the
// reverse state G_t = exp(la_{t+1}) G_{t+1} + q_t dy_t^T (G past T is dH_T)
//   dq_t = H_t dy_t,   dk_t = G_t v_t,   dv_t = G_t^T k_t,
//   dla_t = sum_{s >= t} (q_s . dq_s - k_s . dk_s) + <dH_T, H_T>,
//   dh0 = exp(la_0) G_0.
// (dla: la enters only through the cumulative sums Lambda_s; y_s scales
// with exp(Lambda_s) as a query and with exp(-Lambda_s) as a key.)
// Chunk-parallel, mirroring the forward's three phases: inside chunk c,
// with L the inclusive cumulative sum of la over the chunk, S the state
// entering the chunk (the forward's scratch, kept by the autograd Function)
// and D_c the reverse state entering it from the right,
//   P_ij  = (q_i . k_j) exp(L_i - L_j),  W_ij = (dy_i . v_j) exp(L_i - L_j),
//           for j <= i (masked before the exponential, as in the forward)
//   dq = W K + diag(exp L) dY S^T
//   dk = W^T Q + diag(exp(L_last - L)) V D_c^T
//   dv = P^T dY + diag(exp(L_last - L)) K D_c
//   D_{c-1} = exp(L_last) D_c + U_c,   U_c = Q^T diag(exp L) dY,
// with D_{nc-1} = dH_T and dh0 = D_{-1}.  Rows of a ragged last chunk past T
// act as la = 0 and q = k = v = dy = 0, as in the forward.
//
// Seven launches, every sum in a fixed order and none across CTAs with
// atomics, so two runs give the same bits:
// 1. scan_bwd_pair_kernel: P and W of each chunk (chunk x chunk, f32
//    scratch), one CTA per (b, h, chunk, P or W, 64 columns);
// 2. scan_bwd_u_kernel: U_c (dk x dv tiles of 128 x 64) and exp(L_last);
// 3. scan_bwd_state_pass_kernel: one thread per (b, h, state entry) walks
//    the chunks backwards, writing D_c over U_c and dh0 at the end;
// 4. scan_bwd_dqdk_kernel: dq or dk of a chunk over 64 columns of dk, in
//    f32 scratch (each sums over the whole of dv inside the CTA);
// 5. scan_bwd_dv_kernel: dv of a chunk over 64 columns of dv (summing over
//    the whole of dk inside the CTA);
// 6. scan_bwd_rows_kernel: one warp per (b, t, h) row writes dq and dk in
//    the input type and r_t = q_t . dq_t - k_t . dk_t from the f32 values;
// 7. scan_bwd_dla_kernel: one CTA per (b, h) turns r into its suffix sums
//    over t (plus <dH_T, H_T> when dH_T is given): dla.
// Tiling over dk for dq/dk and over dv for dv keeps every reduction inside
// one CTA: at mLSTM's dk 512 x dv 513 a dq tile sums all 513 columns of dv,
// so no partial sums cross CTAs.  dv 513 (not a multiple of 8) is handled
// by element loads with bounds.
//
// What bounds it: bytes.  q, k, v, dy and la read, the forward's chunk
// states read, dq, dk, dv and dla written.  The operations, about
// chunk * (4 dk + 4 dv) + 6 dk dv per token and head (the pair products,
// the three chunk products and the state terms), are f32 FMAs on the CUDA
// cores here: this first version is simple and right, not yet fast.  Every
// product goes through one shared-memory tile loop (tile_gemm): 128 rows
// (the chunk) by 64 columns per CTA, the reduction staged 32 deep, each
// thread 8 x 4 outputs.  Inputs of either type are widened to f32 on load.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CMAX = 128;        // largest chunk, the rows of every tile
constexpr int NT = 256;          // threads per CTA
constexpr int TILE = 64;         // output columns per CTA
constexpr int KC = 32;           // reduction depth staged at a time
constexpr int UROWS = 128;       // dk rows of a U tile
constexpr int ROWS_WARPS = 8;    // rows (warps) per CTA of the rows kernel
constexpr int MAX_DK = 512;
constexpr int MAX_DV = 1024;

struct Strides {
  int64_t qb, qt, qh, kb, kt, kh;
};

struct Tiles {
  float a[KC][CMAX + 1];         // A staged as [k][row]
  float b[KC][TILE + 4];         // B staged as [k][column]
};

// Ls[i] = log_a summed over rows 0 .. i of the chunk (rows past n as 0),
// as the forward computes it.  Every thread of the CTA calls it.
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

// acc (128 x 64 of this CTA; thread ty = tid / 16 owns rows 8 ty .. 8 ty +
// 7, tx = tid % 16 columns 4 tx .. 4 tx + 3) += A (128 x kdim) B (kdim x
// 64), A(i, kk) = fa(i, kk) and B(kk, n) = fb(kk, n), both returning 0
// outside their operand.  Staged KC deep through shared memory; every
// thread of the CTA calls it.
template <class FA, class FB>
__device__ __forceinline__ void tile_gemm(float (&acc)[8][4], int kdim,
                                          FA fa, FB fb, Tiles& sm) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < kdim; k0 += KC) {
    __syncthreads();              // the previous stage is consumed
    for (int idx = tid; idx < CMAX * KC; idx += NT) {
      const int i = idx / KC, kk = idx % KC;
      sm.a[kk][i] = k0 + kk < kdim ? fa(i, k0 + kk) : 0.f;
    }
    for (int idx = tid; idx < KC * TILE; idx += NT) {
      const int kk = idx / TILE, n = idx % TILE;
      sm.b[kk][n] = k0 + kk < kdim ? fb(k0 + kk, n) : 0.f;
    }
    __syncthreads();
    const int kn = min(KC, kdim - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float av = sm.a[kk][ty * 8 + r];
        acc[r][0] = fmaf(av, bv.x, acc[r][0]);
        acc[r][1] = fmaf(av, bv.y, acc[r][1]);
        acc[r][2] = fmaf(av, bv.z, acc[r][2]);
        acc[r][3] = fmaf(av, bv.w, acc[r][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// Where a chunk's rows live: the first token c0 and the live rows n.
struct Chunk {
  int b, h, c, c0, n;
};

__device__ __forceinline__ Chunk chunk_of(int c, int h, int b, int t_len,
                                          int chunk) {
  const int c0 = c * chunk;
  return Chunk{b, h, c, c0, min(chunk, t_len - c0)};
}

// offset of token row t of the (B, T, H, width) contiguous layout
__device__ __forceinline__ int64_t row_off(int b, int t, int h, int t_len,
                                           int heads, int width) {
  return ((static_cast<int64_t>(b) * t_len + t) * heads + h) * width;
}

// ---------------------------------------------------------------------------
// 1. P_ij = (q_i . k_j) exp(L_i - L_j) and W_ij = (dy_i . v_j) exp(L_i -
//    L_j) for j <= i (0 elsewhere), at pw[b, h, c, which] (chunk x chunk).
//    grid (nc, H * 2 * column tiles, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_pair_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dy,
                     const float* __restrict__ log_a, float* __restrict__ pw,
                     int t_len, int heads, int dk, int dv, int chunk, int nc,
                     int n_ct, Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) Tiles sm;
  const int h = blockIdx.y % heads;
  const int which = blockIdx.y / heads % 2;
  const int j0 = blockIdx.y / heads / 2 * TILE;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, ch.n, Ls, warp_tot);
  float acc[8][4];
  zero(acc);
  const int n = ch.n;
  if (which == 0) {
    const T* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
    const T* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
    tile_gemm(acc, dk,
              [&](int i, int d) {
                return i < n ? load_one(qb + i * st.qt + d) : 0.f;
              },
              [&](int d, int jj) {
                const int j = j0 + jj;
                return j < n ? load_one(kb + j * st.kt + d) : 0.f;
              }, sm);
  } else {
    const T* dyb = dy + row_off(ch.b, ch.c0, h, t_len, heads, dv);
    const T* vb = v + row_off(ch.b, ch.c0, h, t_len, heads, dv);
    const int64_t rs = static_cast<int64_t>(heads) * dv;    // one token
    tile_gemm(acc, dv,
              [&](int i, int e) {
                return i < n ? load_one(dyb + i * rs + e) : 0.f;
              },
              [&](int e, int jj) {
                const int j = j0 + jj;
                return j < n ? load_one(vb + j * rs + e) : 0.f;
              }, sm);
  }
  float* out = pw + ((((static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c)
                      * 2 + which) * chunk) * chunk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty * 8 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (i < chunk && j < chunk)
        out[static_cast<int64_t>(i) * chunk + j] =
            j <= i && i < n ? acc[r][c] * expf(Ls[i] - Ls[j]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. U_c = Q^T diag(exp L) dY (dk x dv), in tiles of 128 x 64, at us[b, h,
//    c]; the CTA of the first tile writes decay[b, h, c] = exp(L_last).
//    grid (nc, H * dk tiles * dv tiles, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_u_kernel(const T* __restrict__ q, const T* __restrict__ dy,
                  const float* __restrict__ log_a, float* __restrict__ us,
                  float* __restrict__ decay, int t_len, int heads, int dk,
                  int dv, int chunk, int nc, int n_dvt, Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) Tiles sm;
  const int h = blockIdx.y % heads;
  const int e0 = blockIdx.y / heads % n_dvt * TILE;
  const int d0 = blockIdx.y / heads / n_dvt * UROWS;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, ch.n, Ls, warp_tot);
  const T* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
  const T* dyb = dy + row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  float acc[8][4];
  zero(acc);
  tile_gemm(acc, ch.n,
            [&](int i, int j) {
              const int d = d0 + i;
              return d < dk ? load_one(qb + j * st.qt + d) * expf(Ls[j])
                            : 0.f;
            },
            [&](int j, int ee) {
              const int e = e0 + ee;
              return e < dv ? load_one(dyb + j * rs + e) : 0.f;
            }, sm);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  float* out = us + bhc * dk * dv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int d = d0 + ty * 8 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = e0 + tx * 4 + c;
      if (d < dk && e < dv) out[static_cast<int64_t>(d) * dv + e] = acc[r][c];
    }
  }
  if (blockIdx.y / heads == 0 && threadIdx.x == 0)
    decay[bhc] = expf(Ls[ch.n - 1]);
}

// ---------------------------------------------------------------------------
// 3. The reverse state pass: one thread per (b, h, entry), D from dH_T (or
//    0) over the chunks backwards; U_c is overwritten by D_c, the reverse
//    state entering chunk c from the right, and dh0 = D_{-1}.
//    grid (entries / NT, H, B).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
scan_bwd_state_pass_kernel(const float* __restrict__ dh_t,
                           float* __restrict__ us,
                           const float* __restrict__ decay,
                           float* __restrict__ dh0, int heads, int dk, int dv,
                           int nc) {
  const int64_t entries = static_cast<int64_t>(dk) * dv;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (idx >= entries) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * heads + blockIdx.y;
  float d = dh_t != nullptr ? dh_t[bh * entries + idx] : 0.f;
  float* u = us + bh * nc * entries + idx;
  const float* a = decay + bh * nc;
  for (int c = nc - 1; c >= 0; --c) {
    const float uc = u[c * entries];
    u[c * entries] = d;
    d = fmaf(a[c], d, uc);
  }
  dh0[bh * entries + idx] = d;
}

// ---------------------------------------------------------------------------
// 4. dq = W K + diag(exp L) dY S^T (which 0) or dk = W^T Q + diag(exp(L_last
//    - L)) V D_c^T (which 1) of a chunk, 64 columns of dk per CTA, in f32 at
//    gq / gk (B, T, H, dk).  grid (nc, H * dk tiles * 2, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_dqdk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dy,
                     const float* __restrict__ log_a,
                     const float* __restrict__ states,
                     const float* __restrict__ us,
                     const float* __restrict__ pw, float* __restrict__ gq,
                     float* __restrict__ gk, int t_len, int heads, int dk,
                     int dv, int chunk, int nc, int n_dkt, Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) Tiles sm;
  const int h = blockIdx.y % heads;
  const int d0 = blockIdx.y / heads % n_dkt * TILE;
  const int which = blockIdx.y / heads / n_dkt;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  const int n = ch.n;
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, n, Ls, warp_tot);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  // the forward's state entering the chunk (dq) or the reverse state D_c
  const float* s = (which == 0 ? states : us) + bhc * dk * dv;
  const float* w = pw + (bhc * 2 + 1) * chunk * chunk;
  const T* rows = which == 0 ? dy : v;        // dY S^T or V D_c^T
  const T* rb = rows + row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  float acc[8][4];
  zero(acc);
  tile_gemm(acc, dv,
            [&](int i, int e) {
              return i < n ? load_one(rb + i * rs + e) : 0.f;
            },
            [&](int e, int dd) {
              const int d = d0 + dd;
              return d < dk ? s[static_cast<int64_t>(d) * dv + e] : 0.f;
            }, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float l_last = Ls[n - 1];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty * 8 + r;
    const float f = which == 0 ? expf(Ls[i]) : expf(l_last - Ls[i]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] *= f;
  }
  if (which == 0) {
    const T* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
    tile_gemm(acc, n,
              [&](int i, int j) {
                return i < n ? w[static_cast<int64_t>(i) * chunk + j] : 0.f;
              },
              [&](int j, int dd) {
                const int d = d0 + dd;
                return d < dk ? load_one(kb + j * st.kt + d) : 0.f;
              }, sm);
  } else {
    const T* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
    tile_gemm(acc, n,
              [&](int i, int j) {
                return i < n ? w[static_cast<int64_t>(j) * chunk + i] : 0.f;
              },
              [&](int j, int dd) {
                const int d = d0 + dd;
                return d < dk ? load_one(qb + j * st.qt + d) : 0.f;
              }, sm);
  }
  float* out = which == 0 ? gq : gk;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty * 8 + r;
    if (i >= n) continue;
    float* o = out + row_off(ch.b, ch.c0 + i, h, t_len, heads, dk);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + tx * 4 + c;
      if (d < dk) o[d] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// 5. dv = P^T dY + diag(exp(L_last - L)) K D_c of a chunk, 64 columns of dv
//    per CTA, in the input type.  grid (nc, H * dv tiles, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_dv_kernel(const T* __restrict__ k, const T* __restrict__ dy,
                   const float* __restrict__ log_a,
                   const float* __restrict__ us, const float* __restrict__ pw,
                   T* __restrict__ dv_out, int t_len, int heads, int dk,
                   int dv, int chunk, int nc, int n_dvt, Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) Tiles sm;
  const int h = blockIdx.y % heads;
  const int e0 = blockIdx.y / heads % n_dvt * TILE;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  const int n = ch.n;
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, n, Ls, warp_tot);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  const float* s = us + bhc * dk * dv;            // D_c
  const float* p = pw + bhc * 2 * chunk * chunk;  // P
  const T* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
  const T* dyb = dy + row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  float acc[8][4];
  zero(acc);
  tile_gemm(acc, dk,
            [&](int i, int d) {
              return i < n ? load_one(kb + i * st.kt + d) : 0.f;
            },
            [&](int d, int ee) {
              const int e = e0 + ee;
              return e < dv ? s[static_cast<int64_t>(d) * dv + e] : 0.f;
            }, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float l_last = Ls[n - 1];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float f = expf(l_last - Ls[ty * 8 + r]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] *= f;
  }
  tile_gemm(acc, n,
            [&](int i, int j) {
              return i < n ? p[static_cast<int64_t>(j) * chunk + i] : 0.f;
            },
            [&](int j, int ee) {
              const int e = e0 + ee;
              return e < dv ? load_one(dyb + j * rs + e) : 0.f;
            }, sm);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty * 8 + r;
    if (i >= n) continue;
    T* o = dv_out + row_off(ch.b, ch.c0 + i, h, t_len, heads, dv);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = e0 + tx * 4 + c;
      if (e < dv) store_one(o + e, acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 6. One warp per (b, t, h) row: dq and dk in the input type from their f32
//    values, and r = q . dq - k . dk at dla[row].  grid (rows / 8).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ROWS_WARPS * 32)
scan_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const float* __restrict__ gq,
                     const float* __restrict__ gk, T* __restrict__ dq,
                     T* __restrict__ dk_out, float* __restrict__ dla,
                     int t_len, int heads, int dk, int64_t rows, Strides st) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS_WARPS
                      + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(row % heads);
  const int t = static_cast<int>(row / heads % t_len);
  const int b = static_cast<int>(row / heads / t_len);
  const T* qr = q + b * st.qb + t * st.qt + h * st.qh;
  const T* kr = k + b * st.kb + t * st.kt + h * st.kh;
  float acc = 0.f;
  for (int d = lane; d < dk; d += 32) {
    const float a = gq[row * dk + d], c = gk[row * dk + d];
    acc = fmaf(load_one(qr + d), a, acc);
    acc = fmaf(-load_one(kr + d), c, acc);
    store_one(dq + row * dk + d, a);
    store_one(dk_out + row * dk + d, c);
  }
  acc = warp_sum(acc);
  if (lane == 0) dla[row] = acc;
}

// ---------------------------------------------------------------------------
// 7. dla_t = sum_{s >= t} r_s (+ <dH_T, H_T>) in place, one CTA per (b, h):
//    each thread sums a segment of t, thread 0 carries the segments' totals
//    from the end, each thread writes its segment's suffix sums.
//    grid (H, B).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
scan_bwd_dla_kernel(float* __restrict__ dla, const float* __restrict__ dh_t,
                    const float* __restrict__ h_t, int t_len, int heads,
                    int dk, int dv) {
  __shared__ float part[NT];
  __shared__ float carry[NT];
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  float ct = 0.f;
  if (dh_t != nullptr) {         // <dH_T, H_T>, a fixed-order tree sum
    const int64_t entries = static_cast<int64_t>(dk) * dv;
    float s = 0.f;
    for (int64_t i = tid; i < entries; i += NT)
      s = fmaf(dh_t[bh * entries + i], h_t[bh * entries + i], s);
    part[tid] = s;
    __syncthreads();
    for (int off = NT / 2; off > 0; off >>= 1) {
      if (tid < off) part[tid] += part[tid + off];
      __syncthreads();
    }
    ct = part[0];
    __syncthreads();
  }
  const int seg = (t_len + NT - 1) / NT;
  const int t0 = min(tid * seg, t_len), t1 = min(t0 + seg, t_len);
  float* col = dla + static_cast<int64_t>(b) * t_len * heads + h;
  float s = 0.f;
  for (int t = t0; t < t1; ++t) s += col[static_cast<int64_t>(t) * heads];
  part[tid] = s;
  __syncthreads();
  if (tid == 0) {
    float run = ct;
    for (int i = NT - 1; i >= 0; --i) {
      carry[i] = run;
      run += part[i];
    }
  }
  __syncthreads();
  float run = carry[tid];
  for (int t = t1 - 1; t >= t0; --t) {
    run += col[static_cast<int64_t>(t) * heads];
    col[static_cast<int64_t>(t) * heads] = run;
  }
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v, const float* la,
               const void* dy, const float* states, const float* dh_t,
               const float* h_t, void* dq, void* dk_out, void* dv_out,
               float* dla, float* dh0, float* pw, float* us, float* decay,
               float* gq, float* gk, int batch, int t_len, int heads, int dk,
               int dv, int chunk, const Strides& st, cudaStream_t stream) {
  const int nc = (t_len + chunk - 1) / chunk;
  const int n_ct = (chunk + TILE - 1) / TILE;
  const int n_dkt = (dk + TILE - 1) / TILE;
  const int n_dvt = (dv + TILE - 1) / TILE;
  const int n_ut = (dk + UROWS - 1) / UROWS;
  const int64_t ys[4] = {static_cast<int64_t>(heads) * 2 * n_ct,
                         static_cast<int64_t>(heads) * n_ut * n_dvt,
                         static_cast<int64_t>(heads) * n_dkt * 2,
                         static_cast<int64_t>(heads) * n_dvt};
  for (int64_t y : ys)
    if (y > 65535) return -1;
  if (batch > 65535) return -1;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* dyt = static_cast<const T*>(dy);
  scan_bwd_pair_kernel<T><<<dim3(nc, ys[0], batch), NT, 0, stream>>>(
      qt, kt, vt, dyt, la, pw, t_len, heads, dk, dv, chunk, nc, n_ct, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_u_kernel<T><<<dim3(nc, ys[1], batch), NT, 0, stream>>>(
      qt, dyt, la, us, decay, t_len, heads, dk, dv, chunk, nc, n_dvt, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = static_cast<int64_t>(dk) * dv;
  scan_bwd_state_pass_kernel<<<dim3(static_cast<unsigned>(
                                        (entries + NT - 1) / NT),
                                    heads, batch),
                               NT, 0, stream>>>(dh_t, us, decay, dh0, heads,
                                                dk, dv, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_dqdk_kernel<T><<<dim3(nc, ys[2], batch), NT, 0, stream>>>(
      qt, kt, vt, dyt, la, states, us, pw, gq, gk, t_len, heads, dk, dv,
      chunk, nc, n_dkt, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_dv_kernel<T><<<dim3(nc, ys[3], batch), NT, 0, stream>>>(
      kt, dyt, la, us, pw, static_cast<T*>(dv_out), t_len, heads, dk, dv,
      chunk, nc, n_dvt, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(batch) * t_len * heads;
  scan_bwd_rows_kernel<T><<<static_cast<unsigned>(
                                (rows + ROWS_WARPS - 1) / ROWS_WARPS),
                            ROWS_WARPS * 32, 0, stream>>>(
      qt, kt, gq, gk, static_cast<T*>(dq), static_cast<T*>(dk_out), dla,
      t_len, heads, dk, rows, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_dla_kernel<<<dim3(heads, batch), NT, 0, stream>>>(
      dla, dh_t, h_t, t_len, heads, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes: the seven launches on `stream`.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dy and dq, dk, dv); log_a,
// states (the forward's B * H * nc * dk * dv chunk-entry states), dh_t and
// h_t (B * H * dk * dv, both null when no gradient reaches h_T), dla (B * T
// * H), dh0 (B * H * dk * dv) and the scratch are float32.  Scratch: pw B *
// H * nc * 2 * chunk^2, us B * H * nc * dk * dv, decay B * H * nc, gq and gk
// B * T * H * dk floats.  q and k take strides (in elements) over (b, t, h)
// and a unit stride over dk; v, dy and the outputs are contiguous.  Returns
// the CUDA error of the launches (0 on success), or -1 when a size is out
// of range (dk 1..512, dv 1..1024, chunk 1..128, grid limits).  Nothing is
// allocated and nothing synchronises.
extern "C" int ssm_scan_bwd_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* log_a, const void* dy, const void* states, const void* dh_t,
    const void* h_t, void* dq, void* dk_out, void* dv_out, void* dla,
    void* dh0, void* pw, void* us, void* decay, void* gq, void* gk,
    int batch, int t_len, int heads, int dk, int dv, int chunk,
    long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || dk < 1 || dk > MAX_DK ||
      dv < 1 || dv > MAX_DV || chunk < 1 || chunk > CMAX)
    return -1;
  if ((dh_t == nullptr) != (h_t == nullptr)) return -1;
  const Strides st{qsb, qst, qsh, ksb, kst, ksh};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* la = static_cast<const float*>(log_a);
  const auto* sp = static_cast<const float*>(states);
  const auto* dht = static_cast<const float*>(dh_t);
  const auto* ht = static_cast<const float*>(h_t);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_all<float>(q, k, v, la, dy, sp, dht, ht, dq, dk_out,
                             dv_out, f(dla), f(dh0), f(pw), f(us), f(decay),
                             f(gq), f(gk), batch, t_len, heads, dk, dv, chunk,
                             st, s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(q, k, v, la, dy, sp, dht, ht, dq,
                                      dk_out, dv_out, f(dla), f(dh0), f(pw),
                                      f(us), f(decay), f(gq), f(gk), batch,
                                      t_len, heads, dk, dv, chunk, st, s);
  return -1;
}
