// Backward of blocked GQA attention for NVIDIA Hopper (sm_90a).
//
// The reference has no backward kernel: the JAX package trains through the
// jnp attention (src/repro/models/blocks.py -> attention.py::attention_full)
// and differentiates it with jax.grad.  The port's training attention is
// the forward kernel of flash_attention.cu (the Hopper counterpart of the
// Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention),
// so its gradient is this kernel, through the autograd Function of
// kernels/flash_attention.py.
//
// What it computes, for the forward of flash_attention.cu (the same
// layouts, masks and scale = 1/sqrt(dh)), given dO = dL/dout and the
// forward's per-row log-sum-exp lse (B, H, S) of the scaled scores:
//   P  = exp(Q K^T * scale - lse)        (0 where the mask drops a key)
//   D  = rowsum(dO * O)                  (f32, one value per query row)
//   dV = P^T dO                          (summed over the G heads of a KV head)
//   dS = P * (dO V^T - D)
//   dQ = dS K * scale,   dK = dS^T Q * scale (summed over the G heads)
// Causal: key j is valid for query i when j <= i (and j > i - window with a
// window); non-causal: every key j < T.  A query row with no valid key has
// P = 0 everywhere and gets dQ = 0.  dq, dk and dv take q's type.
//
// Three launches, no atomics, so the result is the same bit for bit on
// every run (a supervised restart on the card replays it exactly):
// * the D pre-pass: one warp per query row;
// * dK/dV: one CTA per (b, KV head, block of keys).  It walks the G query
//   heads of its group and, for each, the query tiles that can see its
//   keys (from the block's first key on when causal, up to its last key +
//   window - 1 with a window), and keeps dK and dV in registers, so the
//   G-head reduction of GQA happens inside the CTA;
// * dQ: one CTA per (b, query head, 64 query rows), over the key tiles its
//   rows can see (the forward's walk).
//
// What bounds it: operations, 10 * dh per (query row, head, valid key)
// (QK^T and dO V^T recomputed or computed once each pass: 2 products of
// 2 dh in dK/dV, 2 in dQ, plus P^T dO and dS^T Q, 2 dh each, and dS K:
// 5 products of 2 dh), against the tensor cores' bf16 rate; the bytes are
// q, k, v, out, dO, lse and the three gradients, a few MB at a
// 1024-token sequence.  This first version is simple and right, not yet
// fast: single-buffered tiles, every product recomputed per pass.
//
// * bf16: the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//   accumulators; the fragment layouts of hopper.cuh).  In dK/dV each of
//   the 4 warps owns 16 keys: S^T = K_w Q^T and dP^T = V_w dO^T take K and
//   V rows from shared memory as A fragments (ldmatrix) and Q, dO as B
//   fragments; P^T and dS^T are rounded to bf16 in registers and used
//   directly as the A fragments of dV += P^T dO and dK += dS^T Q (the C
//   layout of m16n8 is the A layout of m16n8k16), with dO and Q through
//   ldmatrix.trans.  In dQ each warp owns 16 query rows, with Q and dO as
//   register A fragments loaded once; S = Q K^T and dP = dO V^T read K and
//   V tiles as B fragments, and dQ += dS K reads K through ldmatrix.trans.
//   Query tiles of dK/dV and key tiles of dQ are 32 rows at DH 128 and 64
//   below, to keep the accumulators (dK and dV: 128 f32 registers at DH
//   128) and the score tiles in registers.
// * f32: IEEE FMAs on the CUDA cores, four threads per key (dK/dV) or per
//   query row (dQ), as the forward's f32 body; the f32 band of 2e-5 is
//   beyond TF32.
//
// dh is any multiple of 8 up to 128 on the DH = 32, 64 or 128 wide body,
// with zero columns past dh, as in the forward.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// D = rowsum(dO * O): one warp per row (b, i, h) of the (B, S, H, dh)
// layout, written at (b * H + h) * S + i.
// ---------------------------------------------------------------------------

constexpr int DOT_ROWS = 8;      // rows (warps) per CTA

template <typename T>
__global__ void __launch_bounds__(DOT_ROWS * 32)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dsum, int64_t rows, int s_len,
                     int h_q, int dh) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * DOT_ROWS
                      + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc = fmaf(load_one(o + row * dh + d), load_one(dout + row * dh + d),
               acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(row % h_q);
    const int64_t bi = row / h_q;
    const int i = static_cast<int>(bi % s_len);
    const int64_t b = bi / s_len;
    dsum[(b * h_q + h) * s_len + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TPR = 4;            // threads per key or query row
constexpr int F_BQ = 64;          // dQ: query rows per CTA
constexpr int F_BK = 32;          // dQ: keys per shared-memory tile
constexpr int F_KB = 32;          // dK/dV: keys per CTA
constexpr int F_QT = 32;          // dK/dV: queries per shared-memory tile

// DH/4 of a row, this thread's share c of 4, interleaved by float4 (the
// forward's layout); zeros past dh
template <int DH>
__device__ __forceinline__ void load_share(const float* p, int c, int dh,
                                           float (&r)[DH / 16][4],
                                           float mul) {
#pragma unroll
  for (int f = 0; f < DH / 16; ++f) {
    const int col = (f * TPR + c) * 4;
    if (col < dh) {
      load_row<4>(p + col, r[f]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[f][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) r[f][e] *= mul;
  }
}

// the dot product of this thread's share with row s of a shared tile,
// summed over the row's 4 threads
template <int DH>
__device__ __forceinline__ float share_dot(const float (&r)[DH / 16][4],
                                           const float* srow, int c) {
  float part = 0.f;
#pragma unroll
  for (int f = 0; f < DH / 16; ++f) {
    const float4 x = *reinterpret_cast<const float4*>(&srow[(f * TPR + c)
                                                            * 4]);
    part += r[f][0] * x.x + r[f][1] * x.y + r[f][2] * x.z + r[f][3] * x.w;
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

template <int DH>
__device__ __forceinline__ void share_axpy(float (&acc)[DH / 16][4], float a,
                                           const float* srow, int c) {
#pragma unroll
  for (int f = 0; f < DH / 16; ++f) {
    const float4 x = *reinterpret_cast<const float4*>(&srow[(f * TPR + c)
                                                            * 4]);
    acc[f][0] = fmaf(a, x.x, acc[f][0]);
    acc[f][1] = fmaf(a, x.y, acc[f][1]);
    acc[f][2] = fmaf(a, x.z, acc[f][2]);
    acc[f][3] = fmaf(a, x.w, acc[f][3]);
  }
}

// rows r0 .. r0 + ROWS - 1 of a (rows, stride) f32 matrix into a shared
// tile, zeros past `limit` rows and past dh columns
template <int DH, int ROWS, int NTH>
__device__ __forceinline__ void stage_f32(float (*dst)[DH], const float* src,
                                          int64_t stride, int r0, int limit,
                                          int dh) {
  for (int idx = threadIdx.x * 4; idx < ROWS * DH; idx += NTH * 4) {
    const int j = idx / DH;
    const int d = idx % DH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + j < limit && d < dh) load_row<4>(src + (r0 + j) * stride + d, x);
    *reinterpret_cast<float4*>(&dst[j][d]) = make_float4(x[0], x[1], x[2],
                                                         x[3]);
  }
}

template <int DH>
__global__ void __launch_bounds__(F_BQ * TPR)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dq, int s_len, int t_len, int h_q,
                        int g, int dh, int causal, int window, float scale) {
  constexpr int NF = DH / 16;
  constexpr int NTH = F_BQ * TPR;
  __shared__ __align__(16) float ks[F_BK][DH];
  __shared__ __align__(16) float vs[F_BK][DH];

  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int r = threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  const int qi = q0 + r;
  const bool live = qi < s_len;

  int lo = 0, hi = t_len - 1;            // this row's valid keys
  if (causal) {
    hi = min(qi, t_len - 1);
    if (window > 0) lo = max(qi - window + 1, 0);
  }
  int k_begin = 0, k_end = t_len;        // the CTA's
  if (causal) {
    k_end = min(min(q0 + F_BQ, s_len), t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / F_BK) * F_BK;

  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  const int64_t qoff = (static_cast<int64_t>(b) * s_len + (live ? qi : 0))
                       * qrow + static_cast<int64_t>(h) * dh;
  float qr[NF][4], dor[NF][4], acc[NF][4];
  load_share<DH>(q + qoff, c, dh, qr, scale);
  load_share<DH>(dout + qoff, c, dh, dor, 1.f);
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  const int64_t lrow = (static_cast<int64_t>(b) * h_q + h) * s_len + qi;
  const float lse_i = live ? lse[lrow] : 0.f;
  const float d_i = live ? dsum[lrow] : 0.f;

  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const float* kb = k + static_cast<int64_t>(b) * t_len * krow + kh * dh;
  const float* vb = v + static_cast<int64_t>(b) * t_len * krow + kh * dh;

  for (int t0 = k_begin; t0 < k_end; t0 += F_BK) {
    __syncthreads();
    stage_f32<DH, F_BK, NTH>(ks, kb, krow, t0, t_len, dh);
    stage_f32<DH, F_BK, NTH>(vs, vb, krow, t0, t_len, dh);
    __syncthreads();
    const bool need = live && t0 <= hi && t0 + F_BK - 1 >= lo;
    if (!__any_sync(0xffffffffu, need)) continue;
#pragma unroll 4
    for (int j = 0; j < F_BK; ++j) {
      const float s = share_dot<DH>(qr, ks[j], c);     // scaled score
      const float dp = share_dot<DH>(dor, vs[j], c);
      const int t = t0 + j;
      const bool ok = live && t >= lo && t <= hi;
      const float p = ok ? expf(s - lse_i) : 0.f;
      share_axpy<DH>(acc, p * (dp - d_i), ks[j], c);
    }
  }
  if (!live) return;
  float* op = dq + qoff;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int col = (f * TPR + c) * 4;
    if (col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) op[col + e] = acc[f][e] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(F_KB * TPR)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s_len, int t_len, int h_q, int g, int dh,
                          int causal, int window, float scale) {
  constexpr int NF = DH / 16;
  constexpr int NTH = F_KB * TPR;
  __shared__ __align__(16) float qs[F_QT][DH];
  __shared__ __align__(16) float dos[F_QT][DH];
  __shared__ float ls[F_QT];
  __shared__ float ds[F_QT];

  const int k0 = blockIdx.x * F_KB;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h_q / g;
  const int r = threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  const int kj = k0 + r;
  const bool live = kj < t_len;

  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const int64_t koff = (static_cast<int64_t>(b) * t_len + (live ? kj : 0))
                       * krow + static_cast<int64_t>(kh) * dh;
  float kr[NF][4], vr[NF][4], dka[NF][4], dva[NF][4];
  load_share<DH>(k + koff, c, dh, kr, scale);
  load_share<DH>(v + koff, c, dh, vr, 1.f);
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[f][e] = dva[f][e] = 0.f;

  // the queries that can see the block's keys
  int q_begin = 0, q_end = s_len;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(s_len, min(k0 + F_KB, t_len) - 1 + window);
  }
  q_begin = (q_begin / F_QT) * F_QT;

  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  for (int gi = 0; gi < g; ++gi) {
    const int h = kh * g + gi;
    const float* qb = q + static_cast<int64_t>(b) * s_len * qrow + h * dh;
    const float* db = dout + static_cast<int64_t>(b) * s_len * qrow + h * dh;
    const int64_t lb = (static_cast<int64_t>(b) * h_q + h) * s_len;
    for (int i0 = q_begin; i0 < q_end; i0 += F_QT) {
      __syncthreads();
      stage_f32<DH, F_QT, NTH>(qs, qb, qrow, i0, s_len, dh);
      stage_f32<DH, F_QT, NTH>(dos, db, qrow, i0, s_len, dh);
      if (threadIdx.x < F_QT) {
        const int i = i0 + threadIdx.x;
        ls[threadIdx.x] = i < s_len ? lse[lb + i] : 0.f;
        ds[threadIdx.x] = i < s_len ? dsum[lb + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < F_QT; ++i) {
        const float s = share_dot<DH>(kr, qs[i], c);   // scaled score
        const float dp = share_dot<DH>(vr, dos[i], c);
        const int qi = i0 + i;
        bool ok = live && qi < s_len;
        if (causal) ok = ok && kj <= qi && (window <= 0 || kj > qi - window);
        const float p = ok ? expf(s - ls[i]) : 0.f;
        share_axpy<DH>(dva, p, dos[i], c);
        share_axpy<DH>(dka, p * (dp - ds[i]), qs[i], c);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int col = (f * TPR + c) * 4;
    if (col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[koff + col + e] = dka[f][e] * scale;
      dv[koff + col + e] = dva[f][e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_NT = 128;        // 4 warps
constexpr int TC_KB = 64;         // dK/dV: keys per CTA, 16 per warp
constexpr int TC_BQ = 64;         // dQ: query rows per CTA, 16 per warp

// dK/dV's query tile and dQ's key tile: 32 rows at DH 128, else 64
__host__ __device__ constexpr int tc_tile(int dh) { return dh == 128 ? 32 : 64; }

constexpr int tc_dkdv_smem(int dh) {
  return (2 * TC_KB + 2 * tc_tile(dh)) * (dh + 8) * 2 + 2 * tc_tile(dh) * 4;
}

constexpr int tc_dq_smem(int dh) {  // two stages of (K tile, V tile)
  return 2 * 2 * tc_tile(dh) * (dh + 8) * 2;
}

// rows r0 .. r0 + ROWS - 1 of a (rows, stride) bf16 matrix into a shared
// tile of pitch DH + 8 by cp.async; zeros past `limit` rows and dh columns
template <int DH, int ROWS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int r0, int limit,
                                           int dh) {
  constexpr int P = DH + 8;
  constexpr int CPR = DH / 8;
  for (int ci = threadIdx.x; ci < ROWS * CPR; ci += TC_NT) {
    const int row = ci / CPR;
    const int col = (ci % CPR) * 8;
    const bool ok = r0 + row < limit && col < dh;
    const int64_t off = ok ? (r0 + row) * stride + col : 0;
    cp_async16(dst + row * P + col, src + off, ok);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// acc[N/8][4] (16 rows x N) = A (16 x DH, register fragments a) times
// the rows 0 .. N-1 of a shared tile (N x DH, pitch DH + 8) transposed
template <int DH, int N>
__device__ __forceinline__ void rows_by_tile(float (&acc)[N / 8][4],
                                             const unsigned (&a)[DH / 16][4],
                                             const __nv_bfloat16* tile) {
  constexpr int P = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; kk += 2) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      unsigned f[4];
      hopper::ldmatrix_x4(f, tile + (j * 8 + (lane & 7)) * P + kk * 16
                                 + (lane >> 3) * 8);
      hopper::mma_bf16(acc[j], a[kk], f[0], f[1]);
      hopper::mma_bf16(acc[j], a[kk + 1], f[2], f[3]);
    }
  }
}

// the same with A the 16 rows w16 .. w16 + 15 of a shared tile
template <int DH, int N>
__device__ __forceinline__ void tile_rows_by_tile(float (&acc)[N / 8][4],
                                                  const __nv_bfloat16* arows,
                                                  const __nv_bfloat16* tile) {
  constexpr int P = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned a[4];
    hopper::ldmatrix_x4(a, arows + (lane & 15) * P + kk * 16
                               + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      unsigned f[4];
      // keys (rows) j*8 .. j*8 + 15 of the tile, head dims kk*16 .. +15
      hopper::ldmatrix_x4(f, tile + (j * 8 + (lane & 7)
                                     + ((lane >> 4) << 3)) * P
                                 + kk * 16 + ((lane >> 3) & 1) * 8);
      hopper::mma_bf16(acc[j], a, f[0], f[1]);
      hopper::mma_bf16(acc[j + 1], a, f[2], f[3]);
    }
  }
}

// acc (16 x DH) += A (16 x N, bf16 fragments pa) times rows 0 .. N-1 of a
// shared tile (N x DH), through ldmatrix.trans
template <int DH, int N>
__device__ __forceinline__ void frag_by_tile(float (&acc)[DH / 8][4],
                                             const unsigned (&pa)[N / 16][4],
                                             const __nv_bfloat16* tile) {
  constexpr int P = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      unsigned f[4];
      hopper::ldmatrix_x4_trans(f, tile + (kk * 16 + (lane & 7)
                                           + ((lane >> 3) & 1) * 8) * P
                                       + n * 8 + (lane >> 4) * 8);
      hopper::mma_bf16(acc[n], pa[kk], f[0], f[1]);
      hopper::mma_bf16(acc[n + 1], pa[kk], f[2], f[3]);
    }
  }
}

// C fragments (16 x N, f32) as bf16 A fragments of a product over N
template <int N>
__device__ __forceinline__ void to_frags(const float (&c)[N / 8][4],
                                         unsigned (&pa)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    pa[j / 2][(j & 1) * 2] = hopper::pack_bf16x2(c[j][0], c[j][1]);
    pa[j / 2][(j & 1) * 2 + 1] = hopper::pack_bf16x2(c[j][2], c[j][3]);
  }
}

template <int DH>
__global__ void __launch_bounds__(TC_NT, 1)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int s_len,
                          int t_len, int h_q, int g, int dh, int causal,
                          int window, float scale, float scale_log2) {
  constexpr int P = DH + 8;
  constexpr int QT = tc_tile(DH);        // queries per tile
  constexpr int NQ = QT / 8;             // n-tiles of S^T
  constexpr int ND = DH / 8;             // n-tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + TC_KB * P;
  __nv_bfloat16* sq = sv + TC_KB * P;
  __nv_bfloat16* sdo = sq + QT * P;
  float* sl = reinterpret_cast<float*>(sdo + QT * P);   // lse, log2 units
  float* sd = sl + QT;                                   // D

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * TC_KB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int hkv = h_q / g;
  const int kw = k0 + warp * 16;          // the warp's first key

  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const int64_t kbase = static_cast<int64_t>(b) * t_len * krow + kh * dh;
  stage_bf16<DH, TC_KB>(sk, k + kbase, krow, k0, t_len, dh);
  stage_bf16<DH, TC_KB>(sv, v + kbase, krow, k0, t_len, dh);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  int q_begin = 0, q_end = s_len;       // the queries that see the block
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(s_len, min(k0 + TC_KB, t_len) - 1 + window);
  }
  q_begin = (q_begin / QT) * QT;
  const int kw_last = min(kw + 15, t_len - 1);

  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  for (int gi = 0; gi < g; ++gi) {
    const int h = kh * g + gi;
    const int64_t qbase = static_cast<int64_t>(b) * s_len * qrow + h * dh;
    const int64_t lb = (static_cast<int64_t>(b) * h_q + h) * s_len;
    for (int i0 = q_begin; i0 < q_end; i0 += QT) {
      __syncthreads();                   // the previous tile is consumed
      stage_bf16<DH, QT>(sq, q + qbase, qrow, i0, s_len, dh);
      stage_bf16<DH, QT>(sdo, dout + qbase, qrow, i0, s_len, dh);
      cp_async_commit();
      if (threadIdx.x < QT) {
        const int i = i0 + threadIdx.x;
        sl[threadIdx.x] = i < s_len ? lse[lb + i] * LOG2E : 0.f;
        sd[threadIdx.x] = i < s_len ? dsum[lb + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // warp-uniform: does any (key, query) pair of the warp pass the
      // masks, and do all of them?
      const int i_last = min(i0 + QT, s_len) - 1;
      bool need = kw < t_len && i0 < s_len;
      bool full = kw + 16 <= t_len && i0 + QT <= s_len;
      if (causal) {
        need = need && i_last >= kw;
        full = full && i0 >= kw + 15;
        if (window > 0) {
          need = need && i0 < kw_last + window;
          full = full && i_last < kw + window;
        }
      }
      if (!need) continue;

      // S^T = K_w Q^T (16 keys x QT queries), then P^T in place
      float s[NQ][4];
      tile_rows_by_tile<DH, QT>(s, sk + warp * 16 * P, sq);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + gq + (e >> 1) * 8;
          const int qi = i0 + j * 8 + 2 * tq + (e & 1);
          bool ok = true;
          if (!full) {
            ok = key < t_len && qi < s_len;
            if (causal)
              ok = ok && key <= qi && (window <= 0 || key > qi - window);
          }
          s[j][e] = ok ? ex2(fmaf(s[j][e], scale_log2, -sl[qi - i0])) : 0.f;
        }
      unsigned pa[QT / 16][4];
      to_frags<QT>(s, pa);
      frag_by_tile<DH, QT>(dva, pa, sdo);              // dV += P^T dO

      // dP^T = V_w dO^T, then dS^T = P^T (dP^T - D) in bf16
      float dp[NQ][4];
      tile_rows_by_tile<DH, QT>(dp, sv + warp * 16 * P, sdo);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * tq + (e & 1);
          dp[j][e] = s[j][e] * (dp[j][e] - sd[qi]);
        }
      to_frags<QT>(dp, pa);
      frag_by_tile<DH, QT>(dka, pa, sq);               // dK += dS^T Q
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + gq + 8 * r;
    if (key >= t_len) continue;
    const int64_t off = kbase + key * krow + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
            __floats2bfloat162_rn(dka[n][2 * r] * scale,
                                  dka[n][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
            __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(TC_NT, 1)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int s_len, int t_len,
                        int h_q, int g, int dh, int causal, int window,
                        float scale, float scale_log2) {
  constexpr int P = DH + 8;
  constexpr int KT = tc_tile(DH);         // keys per tile
  constexpr int TILE = KT * P;
  constexpr int KS = DH / 16;
  constexpr int NS = KT / 8;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int w0 = q0 + warp * 16;
  const int w_last = min(w0 + 15, s_len - 1);

  int k_begin = 0, k_end = t_len;
  if (causal) {
    k_end = min(min(q0 + TC_BQ, s_len), t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / KT) * KT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const int64_t kbase = static_cast<int64_t>(b) * t_len * krow + kh * dh;
  if (n_tiles > 0) {
    stage_bf16<DH, KT>(smem, k + kbase, krow, k_begin, t_len, dh);
    stage_bf16<DH, KT>(smem + TILE, v + kbase, krow, k_begin, t_len, dh);
  }
  cp_async_commit();

  // the warp's 16 rows of q and dO as A fragments, once; zeros past S
  // and past dh
  unsigned qa[KS][4], da[KS][4];
  const int r0 = w0 + gq;
  const int r1 = r0 + 8;
  {
    const int64_t o0 = (static_cast<int64_t>(b) * s_len + min(r0, s_len - 1))
                       * h_q * dh + static_cast<int64_t>(h) * dh;
    const int64_t o1 = (static_cast<int64_t>(b) * s_len + min(r1, s_len - 1))
                       * h_q * dh + static_cast<int64_t>(h) * dh;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = kk * 16 + 2 * tq;
      const bool c0 = col < dh, c1 = col + 8 < dh;
      qa[kk][0] = r0 < s_len && c0 ? load_pair(q + o0 + col) : 0u;
      qa[kk][1] = r1 < s_len && c0 ? load_pair(q + o1 + col) : 0u;
      qa[kk][2] = r0 < s_len && c1 ? load_pair(q + o0 + col + 8) : 0u;
      qa[kk][3] = r1 < s_len && c1 ? load_pair(q + o1 + col + 8) : 0u;
      da[kk][0] = r0 < s_len && c0 ? load_pair(dout + o0 + col) : 0u;
      da[kk][1] = r1 < s_len && c0 ? load_pair(dout + o1 + col) : 0u;
      da[kk][2] = r0 < s_len && c1 ? load_pair(dout + o0 + col + 8) : 0u;
      da[kk][3] = r1 < s_len && c1 ? load_pair(dout + o1 + col + 8) : 0u;
    }
  }
  const int64_t lb = (static_cast<int64_t>(b) * h_q + h) * s_len;
  const float l2[2] = {r0 < s_len ? lse[lb + r0] * LOG2E : 0.f,
                       r1 < s_len ? lse[lb + r1] * LOG2E : 0.f};
  const float dd[2] = {r0 < s_len ? dsum[lb + r0] : 0.f,
                       r1 < s_len ? dsum[lb + r1] : 0.f};

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();              // tile `it` landed; tile it - 1 consumed
    if (it + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + ((it + 1) & 1) * 2 * TILE;
      stage_bf16<DH, KT>(nxt, k + kbase, krow, k_begin + (it + 1) * KT,
                         t_len, dh);
      stage_bf16<DH, KT>(nxt + TILE, v + kbase, krow,
                         k_begin + (it + 1) * KT, t_len, dh);
    }
    cp_async_commit();

    const int k0 = k_begin + it * KT;
    bool need = w0 < s_len;
    bool full = k0 + KT <= t_len && w0 + 16 <= s_len;
    if (causal) {
      need = need && k0 <= w_last;
      full = full && k0 + KT - 1 <= w0;
      if (window > 0) {
        need = need && k0 + KT - 1 > w0 - window;
        full = full && k0 > w_last - window;
      }
    }
    if (!need) continue;

    const __nv_bfloat16* sk = smem + (it & 1) * 2 * TILE;
    const __nv_bfloat16* sv = sk + TILE;
    float s[NS][4], dp[NS][4];
    rows_by_tile<DH, KT>(s, qa, sk);                   // S = Q K^T
    rows_by_tile<DH, KT>(dp, da, sv);                  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const int rr = e >> 1;
        const int row = w0 + gq + rr * 8;
        bool ok = true;
        if (!full) {
          ok = key < t_len && row < s_len;
          if (causal)
            ok = ok && key <= row && (window <= 0 || key > row - window);
        }
        const float p = ok ? ex2(fmaf(s[j][e], scale_log2, -l2[rr])) : 0.f;
        dp[j][e] = p * (dp[j][e] - dd[rr]);             // dS
      }
    unsigned pa[KT / 16][4];
    to_frags<KT>(dp, pa);
    frag_by_tile<DH, KT>(acc, pa, sk);                 // dQ += dS K
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = w0 + gq + 8 * rr;
    if (row >= s_len) continue;
    __nv_bfloat16* op = dq + (static_cast<int64_t>(b) * s_len + row) * h_q * dh
                        + static_cast<int64_t>(h) * dh + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * rr] * scale,
                                  acc[n][2 * rr + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
  int batch, s_len, t_len, h_q, g, dh, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_dot(const BwdArgs& a) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.s_len * a.h_q;
  const int64_t blocks = (rows + DOT_ROWS - 1) / DOT_ROWS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), DOT_ROWS * 32, 0,
                            a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.dsum,
      rows, a.s_len, a.h_q, a.dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const BwdArgs& a) {
  cudaError_t err = launch_dot<float>(a);
  if (err != cudaSuccess) return err;
  const int hkv = a.h_q / a.g;
  if (hkv > 65535 || a.batch > 65535 || a.h_q > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 g1((a.t_len + F_KB - 1) / F_KB, hkv, a.batch);
  flash_bwd_dkdv_f32_kernel<DH><<<g1, F_KB * TPR, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.dsum, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s_len, a.t_len, a.h_q, a.g, a.dh, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((a.s_len + F_BQ - 1) / F_BQ, a.h_q, a.batch);
  flash_bwd_dq_f32_kernel<DH><<<g2, F_BQ * TPR, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.dsum, static_cast<float*>(a.dq), a.s_len, a.t_len, a.h_q,
      a.g, a.dh, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_mma(const BwdArgs& a) {
  constexpr int S1 = tc_dkdv_smem(DH);
  constexpr int S2 = tc_dq_smem(DH);
  static bool smem_set = false;   // the attributes, once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S2);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  cudaError_t err = launch_dot<__nv_bfloat16>(a);
  if (err != cudaSuccess) return err;
  const int hkv = a.h_q / a.g;
  const int kblocks = (a.t_len + TC_KB - 1) / TC_KB;
  const int qblocks = (a.s_len + TC_BQ - 1) / TC_BQ;
  if (a.batch > 65535 || kblocks > 65535 || qblocks > 65535)
    return cudaErrorInvalidConfiguration;
  const float scale_log2 = a.scale * LOG2E;
  dim3 g1(hkv, a.batch, kblocks);
  flash_bwd_dkdv_mma_kernel<DH><<<g1, TC_NT, S1, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.dsum,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.s_len, a.t_len, a.h_q, a.g, a.dh, a.causal, a.window, a.scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2(a.h_q, a.batch, qblocks);
  flash_bwd_dq_mma_kernel<DH><<<g2, TC_NT, S2, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.dsum,
      static_cast<__nv_bfloat16*>(a.dq), a.s_len, a.t_len, a.h_q, a.g, a.dh,
      a.causal, a.window, a.scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores).  q, out, dout and dq are (B, S, H,
// dh); k, v, dk and dv (B, T, Hkv, dh); lse is the forward's (B, H, S) f32
// log-sum-exp and dsum a (B, H, S) f32 scratch the caller allocates (D).
// Every tensor is contiguous.  Launches the D pre-pass, dK/dV and dQ, in
// that order, on `stream`; allocates nothing.  Returns the CUDA error of
// the first launch that fails (0 on success), or -1 when the (dtype, dh,
// G) combination is not supported.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int batch, int s_len, int t_len, int h_q, int hkv, int dh,
    int causal, int window, float scale, void* stream) {
  if (hkv <= 0 || h_q % hkv != 0 || s_len <= 0 || t_len <= 0 || batch <= 0)
    return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const BwdArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
                  static_cast<float*>(dsum), dq, dk, dv, batch, s_len, t_len,
                  h_q, h_q / hkv, dh, causal, window, scale,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (head_width(dh)) {
    case 32: err = dtype == 0 ? launch_f32<32>(a) : launch_mma<32>(a); break;
    case 64: err = dtype == 0 ? launch_f32<64>(a) : launch_mma<64>(a); break;
    case 128:
      err = dtype == 0 ? launch_f32<128>(a) : launch_mma<128>(a);
      break;
    default: return -1;
  }
  return static_cast<int>(err);
}
