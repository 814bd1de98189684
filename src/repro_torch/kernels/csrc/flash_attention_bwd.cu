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
// every run (a supervised restart on the card replays it exactly): the D
// pre-pass (one warp per query row), dK/dV, and dQ.
//
// What bounds it: operations, 10 * dh per (query row, head, valid key)
// (QK^T, dO V^T, P^T dO, dS^T Q and dS K, 2 dh each), against the tensor
// cores' bf16 rate; the bytes are q, k, v, out, dO, lse and the three
// gradients, a few MB at a 1024-token sequence.
//
// * bf16: TMA, wgmma and warp specialisation.  Each kernel has three
//   warpgroups: two consumers (setmaxnreg 232) and a producer (40) of
//   which one warp works.  q and dO are read through (dh, H, S, B) tensor
//   maps and k and v through (dh, Hkv, T, B) ones, in boxes of 64 columns
//   of dh (128 bytes, the 128-byte swizzle) by 64 rows, so the body is DH
//   = 64 (one box), 128 (two) or 256 (four); dh 112, 120 and 200 take
//   zeros past dh from outside the dh dimension, never the next head's
//   columns, and rows past S or T arrive as zeros, never the next
//   batch's.
//   - dK/dV: one CTA per (b, KV head, 128 keys), the first key blocks
//     (the heaviest under a causal mask) launched first.  Each consumer
//     warpgroup holds 64 keys' K and V in shared memory (loaded once) and
//     their dK and dV in f32 registers (DH / 2 each a thread).  The
//     producer streams 64-query tiles of Q and dO by TMA through a ring
//     of 4 stages, with their LSE (in log2 units) and D written into the
//     stage by its 32 lanes; it walks the G query heads of the group, for
//     each the tiles that can see the block's keys, so the GQA sum stays
//     inside the CTA in a fixed order.  Per tile: S^T = K Q^T and dP^T =
//     V dO^T (wgmma from shared memory, both operands K-major, 64 x 64);
//     P^T and dS^T = P^T (dP^T - D) rounded to bf16 in the registers that
//     hold them and used as register A operands of dV += P^T dO and dK +=
//     dS^T Q (dO and Q as MN-major B).  A warpgroup skips a tile none of
//     its pairs needs, and masks elements only where a pair may fail the
//     mask.  Shared memory at DH 128: 64 KB of K and V, 32 KB a stage.
//   - dQ: a second pass, one CTA per (b, query head, 128 rows), the last
//     query blocks (the heaviest) first: each consumer warpgroup holds its
//     64 rows of Q and dO in shared memory and dQ in registers, and the
//     producer streams 64-key tiles of K and V through the ring.  S = Q
//     K^T and dP = dO V^T are computed again, and dQ += dS K takes dS from
//     registers and K as an MN-major B.  Seven products per valid pair
//     against the bound's five: at the tensor cores' peak the design
//     reaches at most 5/7 of the bound, the price of no atomics and no
//     f32 workspace.
//   - Grid fill: at B 1 x S 1024 and agent-7b's heads, 128-key blocks
//     give 64 CTAs (8 KV heads x 8 blocks) for 132 SMs, and under a
//     causal mask the first block's CTA walks 4 heads x 16 tiles.  Where
//     the 128-key grid would leave SMs idle and G >= 2, the dK/dV pass
//     takes 64-key blocks instead and splits the group's heads between
//     the two warpgroups (ceil(G / 2) and the rest), warpgroup 1 handing
//     its f32 sums to warpgroup 0 through shared memory at the end: twice
//     the CTAs, half the tiles on the longest, the sum still in one fixed
//     order.  The training shape (B 2 x S 4096) gives 512 CTAs of 128
//     keys.
//   - DH 256 (Gemma 3's heads; Layout's COLS): one warpgroup's 64 rows at
//     the whole dh would hold 2 x 64 x 256 f32 sums, 256 registers a
//     thread, past setmaxnreg's 232, and two resident 64 KB sets would
//     leave one 64 KB stage.  So both passes take one 64-row block a CTA
//     (one resident set, a ring of two stages, 219 KB), and per tile
//     warpgroup 0 computes S (and P), warpgroup 1 dP (and dS), each once;
//     P goes to warpgroup 1 and dS back to warpgroup 0 through shared
//     memory (two named barriers a tile), and each warpgroup adds its
//     half of dh's columns of the sums (N = 128 products): four products
//     a valid pair in dK/dV and three in dQ, as at DH 128.
// * f32: IEEE FMAs on the CUDA cores, four threads per key (dK/dV) or per
//   query row (dQ), as the forward's f32 body; the f32 band of 2e-5 is
//   beyond TF32.  dh is any multiple of 8 up to 256 on the DH = 32, 64,
//   128 or 256 wide body, with zero columns past dh; at DH 256 tiles of
//   16 rows, eight threads a key or row and 32-row dQ blocks.  The wrapper
//   pads any other dh to a multiple of 8 in a zero-filled copy.
// * A dh past 256, in both types: the column-block passes of part 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

// A head past 256: the dK/dV and dQ passes of part 1 (below), after the
// D pre-pass of part 0.
extern "C" int flash_attention_bwd_wide(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, void* dq, void* dk, void* dv,
    int batch, int s_len, int t_len, int h_q, int g, int dh, int causal,
    int window, float scale, cudaStream_t stream);

// The build compiles this file as two parts at once (kernels/build.py
// PARTS): the bodies up to DH 256 with the D pre-pass and the entry
// point, then the column-block passes; without BUILD_PART it is whole.
#if !defined(BUILD_PART) || BUILD_PART == 0
namespace {

// LOG2E: common.cuh

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

constexpr int F_KB = 32;          // dK/dV: keys per CTA

// Threads per key (dK/dV) or query row (dQ), the rows of a shared tile
// (dQ's keys, dK/dV's queries) and dQ's query rows per CTA, by body
// width.  Four threads, 32-row tiles and 64 rows up to DH 128.  At DH
// 256 the f32 tiles take 16 rows (32 of 256 floats would pass the 48 KB
// of static shared memory), and a key or row spreads over 8 threads:
// dK/dV's four DH/TP-wide rows (K, V, dK, dV) at 4 threads would take 256
// registers a thread, dQ's three (q, dO, dQ) 192 and spilled; dQ's CTA
// takes 32 rows, so 256 threads may hold 255 registers each.
template <int DH>
struct F32Shape {
  static constexpr int ROWS = DH > 128 ? 16 : 32;
  static constexpr int TP_DQ = DH > 128 ? 8 : 4;
  static constexpr int TP_KV = DH > 128 ? 8 : 4;
  static constexpr int BQ = DH > 128 ? 32 : 64;
};

// DH/TP of a row, this thread's share c of TP, interleaved by float4 (the
// forward's layout); zeros past dh
template <int DH, int TP>
__device__ __forceinline__ void load_share(const float* p, int c, int dh,
                                           float (&r)[DH / (4 * TP)][4],
                                           float mul) {
#pragma unroll
  for (int f = 0; f < DH / (4 * TP); ++f) {
    const int col = (f * TP + c) * 4;
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
// summed over the row's TP threads
template <int DH, int TP>
__device__ __forceinline__ float share_dot(const float (&r)[DH / (4 * TP)][4],
                                           const float* srow, int c) {
  float part = 0.f;
#pragma unroll
  for (int f = 0; f < DH / (4 * TP); ++f) {
    const float4 x = *reinterpret_cast<const float4*>(&srow[(f * TP + c)
                                                            * 4]);
    part += r[f][0] * x.x + r[f][1] * x.y + r[f][2] * x.z + r[f][3] * x.w;
  }
#pragma unroll
  for (int o = 1; o < TP; o <<= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

template <int DH, int TP>
__device__ __forceinline__ void share_axpy(float (&acc)[DH / (4 * TP)][4],
                                           float a, const float* srow,
                                           int c) {
#pragma unroll
  for (int f = 0; f < DH / (4 * TP); ++f) {
    const float4 x = *reinterpret_cast<const float4*>(&srow[(f * TP + c)
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
__global__ void __launch_bounds__(F32Shape<DH>::BQ * F32Shape<DH>::TP_DQ)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dq, int s_len, int t_len, int h_q,
                        int g, int dh, int causal, int window, float scale) {
  constexpr int TPR = F32Shape<DH>::TP_DQ;
  constexpr int F_BK = F32Shape<DH>::ROWS;   // keys per shared tile
  constexpr int F_BQ = F32Shape<DH>::BQ;     // query rows per CTA
  constexpr int NF = DH / (4 * TPR);
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
  load_share<DH, TPR>(q + qoff, c, dh, qr, scale);
  load_share<DH, TPR>(dout + qoff, c, dh, dor, 1.f);
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
      const float s = share_dot<DH, TPR>(qr, ks[j], c);   // scaled score
      const float dp = share_dot<DH, TPR>(dor, vs[j], c);
      const int t = t0 + j;
      const bool ok = live && t >= lo && t <= hi;
      const float p = ok ? expf(s - lse_i) : 0.f;
      share_axpy<DH, TPR>(acc, p * (dp - d_i), ks[j], c);
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
__global__ void __launch_bounds__(F_KB * F32Shape<DH>::TP_KV)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s_len, int t_len, int h_q, int g, int dh,
                          int causal, int window, float scale) {
  constexpr int TPR = F32Shape<DH>::TP_KV;
  constexpr int F_QT = F32Shape<DH>::ROWS;   // queries per shared tile
  constexpr int NF = DH / (4 * TPR);
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
  load_share<DH, TPR>(k + koff, c, dh, kr, scale);
  load_share<DH, TPR>(v + koff, c, dh, vr, 1.f);
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
        const float s = share_dot<DH, TPR>(kr, qs[i], c);   // scaled score
        const float dp = share_dot<DH, TPR>(vr, dos[i], c);
        const int qi = i0 + i;
        bool ok = live && qi < s_len;
        if (causal) ok = ok && kj <= qi && (window <= 0 || kj > qi - window);
        const float p = ok ? expf(s - ls[i]) : 0.f;
        share_axpy<DH, TPR>(dva, p, dos[i], c);
        share_axpy<DH, TPR>(dka, p * (dp - ds[i]), qs[i], c);
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
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int TILE = 64;          // rows of a tile and of a warpgroup
constexpr int BOX = 64;           // columns of dh in a box (128 bytes)
constexpr int BOX_BYTES = BOX * TILE * 2;
constexpr int NWG = 2;            // consumer warpgroups
constexpr int THREADS = (NWG + 1) * 128;
constexpr int BLOCK = NWG * TILE; // keys of a dK/dV CTA, rows of a dQ CTA
constexpr int MAX_RING = 4;
constexpr int BUDGET = 227 * 1024 - 256;   // dynamic shared memory a CTA

// Shared memory of both kernels at body width DH: the CTA's resident
// block (two tensors x SETS x DH/64 boxes: K and V, or Q and dO), the
// ring of streamed tiles (two tensors x DH/64 boxes a stage), 64 f32 of
// LSE and of D a stage (dK/dV), the barriers, and with COLS the exchange
// of P and dS between the warpgroups.  COLS (DH 256): both warpgroups
// work on one 64-row block, one set resident (64 KB), each holding half
// of dh's columns of the f32 sums: a warpgroup's 64 rows at the whole
// 256 would take 2 x 64 x 256 / 128 = 256 registers a thread (past
// setmaxnreg's 232), and two resident sets of 64 KB each would leave
// room for one 64 KB stage.
template <int DH>
struct Layout {
  static constexpr int NB = DH / BOX;
  static constexpr bool COLS = DH > 128;
  static constexpr int SETS = COLS ? 1 : NWG;
  static constexpr int RES_BYTES = 2 * SETS * NB * BOX_BYTES;
  static constexpr int STAGE = 2 * NB * BOX_BYTES;
  static constexpr int ROW_BYTES = MAX_RING * 2 * TILE * 4;
  static constexpr int BAR_BYTES = (2 * MAX_RING + 1) * 8;
  // P (32 f32 a thread) and dS (16 bf16 pairs a thread) of a tile
  static constexpr int XCHG_BYTES = COLS ? (32 + 16) * 128 * 4 : 0;
  static constexpr int FIXED =
      1024 + RES_BYTES + ROW_BYTES + BAR_BYTES + XCHG_BYTES;
  static constexpr int RING = (BUDGET - FIXED) / STAGE < MAX_RING
                                  ? (BUDGET - FIXED) / STAGE
                                  : MAX_RING;
  static constexpr int SMEM = FIXED + RING * STAGE;
  static_assert(RING >= 2, "the ring needs two stages");
};

// k-step kk (16 columns of dh) of a K-major 64-row operand DH wide: box
// kk / 4, 32 bytes a step inside its swizzled rows
__device__ __forceinline__ uint64_t kmajor(const unsigned char* base,
                                           int kk) {
  return hopper::sw128_desc(base + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16,
                            1024);
}

// k-step kk (16 rows) of an MN-major operand: 64-column boxes BOX_BYTES
// apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* base,
                                            int kk) {
  return hopper::sw128_desc(base + kk * 2048, BOX_BYTES, 1024);
}

// a 64 x 64 f32 tile in the accumulator layout as bf16 register A
// operands of four k-steps (wgmma.cuh)
__device__ __forceinline__ void to_a_frags(const float (&c)[32],
                                           unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = hopper::pack_bf16x2(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = hopper::pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = hopper::pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = hopper::pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = 0.f;
}

// S = A B^T over DH for two K-major 64-row operands (A from the
// warpgroup's resident block, B a streamed tile), one commit group
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32],
                                       const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    hopper::WgmmaSS<64>::mma<0, 0>(s, kmajor(a, kk), kmajor(b, kk), kk > 0);
  hopper::wgmma_commit();
}

// acc (64 x N) += A (64 x 64, register operands a) B, B an MN-major
// 64-row tile N wide (N = DH, or half of it from the box of column N *
// half with COLS)
template <int N>
__device__ __forceinline__ void acc_product(float (&acc)[N / 2],
                                            const unsigned (&a)[4][4],
                                            const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::WgmmaRS<N>::template mma<1>(acc, a[kk], mnmajor(b, kk), 1);
}

// COLS: warpgroup 0 hands P (f32, its accumulator layout) to warpgroup
// 1 through xp, which hands back dS as bf16 A operands through xd; thread
// t of one warpgroup holds the elements thread t of the other needs, and
// warpgroup 1 reads P from xp where it uses it (no register copy).  Named
// barriers 1 and 2 order the two hand-offs within a tile, and the next
// tile's writes come after both reads.
__device__ __forceinline__ void hand_p(int wg, int t, const float (&x)[32],
                                       float* xp) {
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) xp[i * 128 + t] = x[i];
  }
  hopper::named_barrier(1, NWG * 128);
}

// P from xp (thread t's elements) as bf16 A operands of four k-steps,
// as to_a_frags packs a register tile
__device__ __forceinline__ void shared_a_frags(const float* xp, int t,
                                               unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = hopper::pack_bf16x2(xp[(8 * kk + 2 * j) * 128 + t],
                                     xp[(8 * kk + 2 * j + 1) * 128 + t]);
}

__device__ __forceinline__ void hand_ds(int wg, int t, unsigned (&da)[4][4],
                                        unsigned* xd) {
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) xd[i * 128 + t] = da[i >> 2][i & 3];
  }
  hopper::named_barrier(2, NWG * 128);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) da[i >> 2][i & 3] = xd[i * 128 + t];
  }
}

// dK and dV of one (b, KV head, block of keys).  Thread roles:
// warpgroups 0 and 1 the consumers, 2 the producer, whose warp 8 issues
// the loads (lane 0) and writes each stage's LSE and D (all 32 lanes,
// each arriving on the stage's barrier).  Two ways to share the block:
// * HEADS false: 128 keys, 64 a consumer warpgroup, each walking all G
//   query heads;
// * HEADS true (a grid of 128-key blocks would leave SMs idle, G >= 2):
//   64 keys, both warpgroups on them, warpgroup 0 walking the first
//   ceil(G / 2) heads and warpgroup 1 the rest; at the end warpgroup 1
//   hands its f32 sums to warpgroup 0 through shared memory, which adds
//   them to its own (one fixed order) and stores.  Twice the CTAs, half
//   the tiles on the longest one.
template <int DH, bool HEADS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int s_len,
                          int t_len, int h_q, int g, int dh, int causal,
                          int window, float scale, float scale_log2) {
  using L = Layout<DH>;
  constexpr int NB = L::NB;
  constexpr int RING = L::RING;
  constexpr bool COLS = L::COLS;
  constexpr bool ONE = HEADS || COLS;            // one 64-key block
  constexpr int KEYS = ONE ? TILE : BLOCK;       // keys of the CTA
  constexpr int SETS = ONE ? 1 : NWG;            // resident K/V sets
  constexpr int WAYS = HEADS ? NWG : 1;          // stages a (head, tile)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sv = sk + L::SETS * NB * BOX_BYTES;
  unsigned char* ring = sv + L::SETS * NB * BOX_BYTES;
  float* sl = reinterpret_cast<float*>(ring + RING * L::STAGE);  // lse log2
  float* sd = sl + MAX_RING * TILE;                               // D
  uint64_t* full = reinterpret_cast<uint64_t*>(sd + MAX_RING * TILE);
  uint64_t* empty = full + MAX_RING;
  uint64_t* kv_full = empty + MAX_RING;
  float* xp = reinterpret_cast<float*>(kv_full + 1);     // COLS: P
  unsigned* xd = reinterpret_cast<unsigned*>(xp + 32 * 128);  // and dS

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * KEYS;      // the first key blocks first
  const int hkv = h_q / g;
  const int gh = HEADS ? (g + 1) / 2 : g;   // heads of warpgroup 0
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(&full[i], 32);
      hopper::mbar_init(&empty[i], HEADS ? 4 : NWG * 4);
    }
    hopper::mbar_init(kv_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  int q_begin = 0, q_end = s_len;        // the queries that see the block
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(s_len, min(k0 + KEYS, t_len) - 1 + window);
  }
  q_begin = (q_begin / TILE) * TILE;
  const int n_tiles =
      q_end > q_begin ? (q_end - q_begin + TILE - 1) / TILE : 0;

  // The stages, in order: for each head step j and query tile, one stage
  // a way (HEADS: warpgroup 0's head j, then warpgroup 1's head gh + j
  // where it exists).
  if (wg == NWG) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if (warp == NWG * 4) {
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * SETS * NB * BOX_BYTES);
#pragma unroll
        for (int w = 0; w < SETS; ++w)
#pragma unroll
          for (int bx = 0; bx < NB; ++bx) {
            hopper::tma_load_4d(sk + (w * NB + bx) * BOX_BYTES, &kmap,
                                kv_full, bx * BOX, kh, k0 + w * TILE, b);
            hopper::tma_load_4d(sv + (w * NB + bx) * BOX_BYTES, &vmap,
                                kv_full, bx * BOX, kh, k0 + w * TILE, b);
          }
      }
      int it = 0;
      for (int j = 0; j < gh; ++j) {
        for (int tile = 0; tile < n_tiles; ++tile) {
          const int i0 = q_begin + tile * TILE;
          for (int w = 0; w < WAYS; ++w) {
            const int gi = w * gh + j;
            if (gi >= g) continue;
            const int h = kh * g + gi;
            const int64_t lb = (static_cast<int64_t>(b) * h_q + h) * s_len;
            const int st = it % RING;
            hopper::mbar_wait(&empty[st], ((it / RING) & 1) ^ 1);
            for (int r = lane; r < TILE; r += 32) {
              const int i = i0 + r;
              sl[st * TILE + r] = i < s_len ? lse[lb + i] * LOG2E : 0.f;
              sd[st * TILE + r] = i < s_len ? dsum[lb + i] : 0.f;
            }
            if (lane == 0) {
              unsigned char* stage = ring + st * L::STAGE;
              hopper::mbar_arrive_expect_tx(&full[st], L::STAGE);
#pragma unroll
              for (int bx = 0; bx < NB; ++bx) {
                hopper::tma_load_4d(stage + bx * BOX_BYTES, &qmap, &full[st],
                                    bx * BOX, h, i0, b);
                hopper::tma_load_4d(stage + (NB + bx) * BOX_BYTES, &dmap,
                                    &full[st], bx * BOX, h, i0, b);
              }
            } else {
              hopper::mbar_arrive(&full[st]);
            }
            ++it;
          }
        }
      }
    }
  } else if constexpr (COLS) {
    // ---- consumers, COLS: both warpgroups on the CTA's 64 keys.  Per
    // tile warpgroup 0 computes S^T = K Q^T and P^T, warpgroup 1 dP^T =
    // V dO^T and dS^T; each then adds its half of dh's columns of dV +=
    // P^T dO and dK += dS^T Q. ----
    hopper::reg_alloc<232>();
    const int kw_last = min(k0 + TILE - 1, t_len - 1);
    const int key_r = k0 + 16 * (warp & 3) + (lane >> 2);  // and key_r + 8
    const int qc = 2 * (lane & 3);             // query columns 8j + qc, +1
    const int t = tid & 127;
    const int half = wg * (NB / 2) * BOX_BYTES;  // the warpgroup's columns
    float dka[DH / 4], dva[DH / 4], x[32];
    zero(dka);
    zero(dva);
    zero(x);                // the first k-step of the product overwrites
    hopper::mbar_wait(kv_full, 0);
    int it = 0;
    for (int gi = 0; gi < g; ++gi) {
      for (int tile = 0; tile < n_tiles; ++tile, ++it) {
        const int i0 = q_begin + tile * TILE;
        const int st = it % RING;
        hopper::mbar_wait(&full[st], (it / RING) & 1);
        const int i_last = min(i0 + TILE, s_len) - 1;
        bool need = k0 < t_len && i0 < s_len;
        bool whole = k0 + TILE <= t_len && i0 + TILE <= s_len;
        if (causal) {
          need = need && i_last >= k0;
          whole = whole && i0 >= k0 + TILE - 1;
          if (window > 0) {
            need = need && i0 < kw_last + window;
            whole = whole && i_last < k0 + window;
          }
        }
        if (need) {
          const unsigned char* sq = ring + st * L::STAGE;
          const unsigned char* sdo = sq + NB * BOX_BYTES;
          const float* tl = sl + st * TILE;
          const float* td = sd + st * TILE;
          hopper::wgmma_fence();
          scores<DH>(x, wg == 0 ? sk : sv, wg == 0 ? sq : sdo);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(x);
          if (wg == 0) {                           // P^T
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int key = key_r + 8 * (i >> 1);
                const int q = 8 * jj + qc + (i & 1);
                bool ok = true;
                if (!whole) {
                  const int qi = i0 + q;
                  ok = key < t_len && qi < s_len;
                  if (causal)
                    ok = ok && key <= qi && (window <= 0 || key > qi - window);
                }
                x[4 * jj + i] =
                    ok ? ex2(fmaf(x[4 * jj + i], scale_log2, -tl[q])) : 0.f;
              }
          }
          unsigned pa[4][4], da[4][4];
          hand_p(wg, t, x, xp);
          if (wg == 1) {                           // dS^T = P^T (dP^T - D)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                x[4 * jj + i] = xp[(4 * jj + i) * 128 + t]
                                * (x[4 * jj + i] - td[8 * jj + qc + (i & 1)]);
            shared_a_frags(xp, t, pa);
            to_a_frags(x, da);
          } else {
            to_a_frags(x, pa);
          }
          hand_ds(wg, t, da, xd);
          hopper::fence_regs(dva);
          hopper::fence_regs(dka);
          hopper::wgmma_fence();
          acc_product<DH / 2>(dva, pa, sdo + half);     // dV += P^T dO
          acc_product<DH / 2>(dka, da, sq + half);      // dK += dS^T Q
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dva);
          hopper::fence_regs(dka);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_r + 8 * r;
      if (key >= t_len) continue;
      const int64_t off =
          (static_cast<int64_t>(b) * t_len + key) * hkv * dh
          + static_cast<int64_t>(kh) * dh + wg * (DH / 2) + qc;
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj)
        if (wg * (DH / 2) + 8 * jj < dh) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jj) =
              __floats2bfloat162_rn(dka[4 * jj + 2 * r] * scale,
                                    dka[4 * jj + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jj) =
              __floats2bfloat162_rn(dva[4 * jj + 2 * r],
                                    dva[4 * jj + 2 * r + 1]);
        }
    }
  } else {
    // ---- consumers: 64 keys each ----
    hopper::reg_alloc<232>();
    const int kw = HEADS ? k0 : k0 + wg * TILE;  // the warpgroup's keys
    const int kw_last = min(kw + TILE - 1, t_len - 1);
    const int key_r = kw + 16 * (warp & 3) + (lane >> 2);  // and key_r + 8
    const int qc = 2 * (lane & 3);             // query columns 8j + qc, +1
    const unsigned char* my_k = sk + (HEADS ? 0 : wg) * NB * BOX_BYTES;
    const unsigned char* my_v = sv + (HEADS ? 0 : wg) * NB * BOX_BYTES;
    float dka[DH / 2], dva[DH / 2], s[32], dp[32];
    zero(dka);
    zero(dva);
    zero(s);                // the first k-step of each product overwrites
    zero(dp);
    hopper::mbar_wait(kv_full, 0);
    int it = 0;
    for (int j = 0; j < gh; ++j) {
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int i0 = q_begin + tile * TILE;
        for (int w = 0; w < WAYS; ++w) {
          if (w * gh + j >= g) continue;
          if (HEADS && w != wg) {              // the other warpgroup's
            ++it;
            continue;
          }
          const int st = it % RING;
          hopper::mbar_wait(&full[st], (it / RING) & 1);
          ++it;
          // warpgroup-uniform: does any (key, query) pair pass the
          // masks, and do all of them?
          const int i_last = min(i0 + TILE, s_len) - 1;
          bool need = kw < t_len && i0 < s_len;
          bool whole = kw + TILE <= t_len && i0 + TILE <= s_len;
          if (causal) {
            need = need && i_last >= kw;
            whole = whole && i0 >= kw + TILE - 1;
            if (window > 0) {
              need = need && i0 < kw_last + window;
              whole = whole && i_last < kw + window;
            }
          }
          if (need) {
            const unsigned char* sq = ring + st * L::STAGE;
            const unsigned char* sdo = sq + NB * BOX_BYTES;
            const float* tl = sl + st * TILE;
            const float* td = sd + st * TILE;
            hopper::wgmma_fence();
            scores<DH>(s, my_k, sq);               // S^T = K Q^T
            scores<DH>(dp, my_v, sdo);             // dP^T = V dO^T
            hopper::wgmma_wait<1>();
            hopper::fence_regs(s);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int key = key_r + 8 * (i >> 1);
                const int q = 8 * jj + qc + (i & 1);
                bool ok = true;
                if (!whole) {
                  const int qi = i0 + q;
                  ok = key < t_len && qi < s_len;
                  if (causal)
                    ok = ok && key <= qi && (window <= 0 || key > qi - window);
                }
                s[4 * jj + i] =
                    ok ? ex2(fmaf(s[4 * jj + i], scale_log2, -tl[q])) : 0.f;
              }
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dp);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                dp[4 * jj + i] = s[4 * jj + i]
                                 * (dp[4 * jj + i] - td[8 * jj + qc + (i & 1)]);
            unsigned pa[4][4], da[4][4];
            to_a_frags(s, pa);                      // P^T in bf16
            to_a_frags(dp, da);                     // dS^T in bf16
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            hopper::wgmma_fence();
            acc_product<DH>(dva, pa, sdo);          // dV += P^T dO
            acc_product<DH>(dka, da, sq);           // dK += dS^T Q
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[st]);
        }
      }
    }
    if (HEADS) {
      // warpgroup 1's sums into the drained ring, added by warpgroup 0
      // element by element (the same layout: the same keys)
      float* part = reinterpret_cast<float*>(ring);
      const int t = tid & 127;
      hopper::named_barrier(1, NWG * 128);    // every stage is consumed
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) {
          part[i * 128 + t] = dka[i];
          part[(DH / 2 + i) * 128 + t] = dva[i];
        }
      }
      hopper::named_barrier(1, NWG * 128);
      if (wg == 1) return;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) {
        dka[i] += part[i * 128 + t];
        dva[i] += part[(DH / 2 + i) * 128 + t];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_r + 8 * r;
      if (key >= t_len) continue;
      const int64_t off =
          (static_cast<int64_t>(b) * t_len + key) * hkv * dh
          + static_cast<int64_t>(kh) * dh + qc;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj)
        if (8 * jj < dh) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jj) =
              __floats2bfloat162_rn(dka[4 * jj + 2 * r] * scale,
                                    dka[4 * jj + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jj) =
              __floats2bfloat162_rn(dva[4 * jj + 2 * r],
                                    dva[4 * jj + 2 * r + 1]);
        }
    }
  }
}

// dQ of one (b, query head, 128 rows).  Thread roles: warpgroups 0 and 1
// the consumers (64 rows each), 2 the producer, of which one thread
// issues the loads.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int s_len, int t_len,
                        int h_q, int g, int dh, int causal, int window,
                        float scale, float scale_log2) {
  using L = Layout<DH>;
  constexpr int NB = L::NB;
  constexpr int RING = L::RING;
  constexpr bool COLS = L::COLS;
  constexpr int ROWS = COLS ? TILE : BLOCK;      // query rows of the CTA
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sdo = sq + L::SETS * NB * BOX_BYTES;
  unsigned char* ring = sdo + L::SETS * NB * BOX_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * L::STAGE
                                               + L::ROW_BYTES);
  uint64_t* empty = full + MAX_RING;
  uint64_t* qd_full = empty + MAX_RING;
  float* xp = reinterpret_cast<float*>(qd_full + 1);     // COLS: P
  unsigned* xd = reinterpret_cast<unsigned*>(xp + 32 * 128);  // and dS

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;    // heaviest first
  const int kh = h / g;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], NWG * 4);
    }
    hopper::mbar_init(qd_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  int k_begin = 0, k_end = t_len;        // the keys the block's rows see
  if (causal) {
    k_end = min(min(q0 + ROWS, s_len), t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / TILE) * TILE;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + TILE - 1) / TILE : 0;

  if (wg == NWG) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if (tid == NWG * 128) {
      hopper::mbar_arrive_expect_tx(qd_full, L::RES_BYTES);
#pragma unroll
      for (int w = 0; w < L::SETS; ++w)
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          hopper::tma_load_4d(sq + (w * NB + bx) * BOX_BYTES, &qmap, qd_full,
                              bx * BOX, h, q0 + w * TILE, b);
          hopper::tma_load_4d(sdo + (w * NB + bx) * BOX_BYTES, &dmap,
                              qd_full, bx * BOX, h, q0 + w * TILE, b);
        }
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int st = tile % RING;
        hopper::mbar_wait(&empty[st], ((tile / RING) & 1) ^ 1);
        unsigned char* stage = ring + st * L::STAGE;
        hopper::mbar_arrive_expect_tx(&full[st], L::STAGE);
        const int t0 = k_begin + tile * TILE;
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          hopper::tma_load_4d(stage + bx * BOX_BYTES, &kmap, &full[st],
                              bx * BOX, kh, t0, b);
          hopper::tma_load_4d(stage + (NB + bx) * BOX_BYTES, &vmap,
                              &full[st], bx * BOX, kh, t0, b);
        }
      }
    }
  } else if constexpr (COLS) {
    // ---- consumers, COLS: both warpgroups on the CTA's 64 rows.  Per
    // tile warpgroup 0 computes S = Q K^T and P, warpgroup 1 dP = dO V^T
    // and dS; each then adds its half of dh's columns of dQ += dS K. ----
    hopper::reg_alloc<232>();
    const int w_last = min(q0 + TILE - 1, s_len - 1);
    const int row_r = q0 + 16 * (warp & 3) + (lane >> 2);  // and row_r + 8
    const int kc = 2 * (lane & 3);             // key columns 8j + kc, +1
    const int t = tid & 127;
    const int half = wg * (NB / 2) * BOX_BYTES;  // the warpgroup's columns
    const int64_t lb = (static_cast<int64_t>(b) * h_q + h) * s_len;
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_r + 8 * r;
      l2[r] = row < s_len ? lse[lb + row] * LOG2E : 0.f;
      dd[r] = row < s_len ? dsum[lb + row] : 0.f;
    }
    float dqa[DH / 4], x[32];
    zero(dqa);
    zero(x);                // the first k-step of the product overwrites
    hopper::mbar_wait(qd_full, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int t0 = k_begin + tile * TILE;
      const int st = tile % RING;
      hopper::mbar_wait(&full[st], (tile / RING) & 1);
      bool need = q0 < s_len;
      bool whole = t0 + TILE <= t_len && q0 + TILE <= s_len;
      if (causal) {
        need = need && t0 <= w_last;
        whole = whole && t0 + TILE - 1 <= q0;
        if (window > 0) {
          need = need && t0 + TILE - 1 > q0 - window;
          whole = whole && t0 > w_last - window;
        }
      }
      if (need) {
        const unsigned char* skt = ring + st * L::STAGE;
        const unsigned char* svt = skt + NB * BOX_BYTES;
        hopper::wgmma_fence();
        scores<DH>(x, wg == 0 ? sq : sdo, wg == 0 ? skt : svt);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(x);
        if (wg == 0) {                             // P
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = row_r + 8 * (i >> 1);
              const int key = t0 + 8 * j + kc + (i & 1);
              bool ok = true;
              if (!whole) {
                ok = key < t_len && row < s_len;
                if (causal)
                  ok = ok && key <= row && (window <= 0 || key > row - window);
              }
              x[4 * j + i] =
                  ok ? ex2(fmaf(x[4 * j + i], scale_log2, -l2[i >> 1])) : 0.f;
            }
        }
        unsigned da[4][4];
        hand_p(wg, t, x, xp);
        if (wg == 1) {                             // dS = P (dP - D)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            x[i] = xp[i * 128 + t] * (x[i] - dd[(i >> 1) & 1]);
          to_a_frags(x, da);
        }
        hand_ds(wg, t, da, xd);
        hopper::fence_regs(dqa);
        hopper::wgmma_fence();
        acc_product<DH / 2>(dqa, da, skt + half);    // dQ += dS K
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dqa);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_r + 8 * r;
      if (row >= s_len) continue;
      __nv_bfloat16* op = dq + (static_cast<int64_t>(b) * s_len + row)
                                   * h_q * dh
                          + static_cast<int64_t>(h) * dh + wg * (DH / 2) + kc;
#pragma unroll
      for (int j = 0; j < DH / 16; ++j)
        if (wg * (DH / 2) + 8 * j < dh)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale,
                                    dqa[4 * j + 2 * r + 1] * scale);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hopper::reg_alloc<232>();
    const int w0 = q0 + wg * TILE;             // the warpgroup's first row
    const int w_last = min(w0 + TILE - 1, s_len - 1);
    const int row_r = w0 + 16 * (warp & 3) + (lane >> 2);  // and row_r + 8
    const int kc = 2 * (lane & 3);             // key columns 8j + kc, +1
    const unsigned char* my_q = sq + wg * NB * BOX_BYTES;
    const unsigned char* my_do = sdo + wg * NB * BOX_BYTES;
    const int64_t lb = (static_cast<int64_t>(b) * h_q + h) * s_len;
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_r + 8 * r;
      l2[r] = row < s_len ? lse[lb + row] * LOG2E : 0.f;
      dd[r] = row < s_len ? dsum[lb + row] : 0.f;
    }
    float dqa[DH / 2], s[32], dp[32];
    zero(dqa);
    zero(s);                // the first k-step of each product overwrites
    zero(dp);
    hopper::mbar_wait(qd_full, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int t0 = k_begin + tile * TILE;
      const int st = tile % RING;
      hopper::mbar_wait(&full[st], (tile / RING) & 1);
      bool need = w0 < s_len;
      bool whole = t0 + TILE <= t_len && w0 + TILE <= s_len;
      if (causal) {
        need = need && t0 <= w_last;
        whole = whole && t0 + TILE - 1 <= w0;
        if (window > 0) {
          need = need && t0 + TILE - 1 > w0 - window;
          whole = whole && t0 > w_last - window;
        }
      }
      if (need) {
        const unsigned char* skt = ring + st * L::STAGE;
        const unsigned char* svt = skt + NB * BOX_BYTES;
        hopper::wgmma_fence();
        scores<DH>(s, my_q, skt);                // S = Q K^T
        scores<DH>(dp, my_do, svt);              // dP = dO V^T
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row_r + 8 * (i >> 1);
            const int key = t0 + 8 * j + kc + (i & 1);
            bool ok = true;
            if (!whole) {
              ok = key < t_len && row < s_len;
              if (causal)
                ok = ok && key <= row && (window <= 0 || key > row - window);
            }
            s[4 * j + i] =
                ok ? ex2(fmaf(s[4 * j + i], scale_log2, -l2[i >> 1])) : 0.f;
          }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dp[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - dd[i >> 1]);
        unsigned da[4][4];
        to_a_frags(dp, da);                       // dS in bf16
        hopper::fence_regs(dqa);
        hopper::wgmma_fence();
        acc_product<DH>(dqa, da, skt);            // dQ += dS K
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dqa);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_r + 8 * r;
      if (row >= s_len) continue;
      __nv_bfloat16* op = dq + (static_cast<int64_t>(b) * s_len + row)
                                   * h_q * dh
                          + static_cast<int64_t>(h) * dh + kc;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        if (8 * j < dh)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale,
                                    dqa[4 * j + 2 * r + 1] * scale);
    }
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
  flash_bwd_dkdv_f32_kernel<DH>
      <<<g1, F_KB * F32Shape<DH>::TP_KV, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.dsum, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s_len, a.t_len, a.h_q, a.g, a.dh, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int BQ = F32Shape<DH>::BQ;
  dim3 g2((a.s_len + BQ - 1) / BQ, a.h_q, a.batch);
  flash_bwd_dq_f32_kernel<DH><<<g2, BQ * F32Shape<DH>::TP_DQ, 0,
                                 a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.dsum, static_cast<float*>(a.dq), a.s_len, a.t_len, a.h_q,
      a.g, a.dh, a.causal, a.window, a.scale);
  return cudaGetLastError();
}


template <int DH>
int launch_tma(const BwdArgs& a) {
  using L = Layout<DH>;
  static bool smem_set = false;   // the attributes, once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_tma_kernel<DH, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if constexpr (!L::COLS) {
      err = cudaFuncSetAttribute(flash_bwd_dkdv_tma_kernel<DH, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaFuncSetAttribute(flash_bwd_dq_tma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int hkv = a.h_q / a.g;
  // COLS: one 64-row block a CTA in both passes
  constexpr int CTA_ROWS = L::COLS ? TILE : BLOCK;
  int kblocks = (a.t_len + CTA_ROWS - 1) / CTA_ROWS;
  const int qblocks = (a.s_len + CTA_ROWS - 1) / CTA_ROWS;
  // 128-key blocks that would leave SMs idle split the group's heads
  // between the warpgroups instead, over 64-key blocks
  const bool heads = !L::COLS && a.g >= 2
                     && static_cast<int64_t>(hkv) * a.batch * kblocks
                            < hopper::sm_count();
  if (heads) kblocks = (a.t_len + TILE - 1) / TILE;
  if (a.batch > 65535 || kblocks > 65535 || qblocks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap qm, dm, km, vm;
  if (!hopper::head_map(&qm, a.q, a.batch, a.s_len, a.h_q, a.dh, TILE) ||
      !hopper::head_map(&dm, a.dout, a.batch, a.s_len, a.h_q, a.dh, TILE) ||
      !hopper::head_map(&km, a.k, a.batch, a.t_len, hkv, a.dh, TILE) ||
      !hopper::head_map(&vm, a.v, a.batch, a.t_len, hkv, a.dh, TILE))
    return -2;
  cudaError_t err = launch_dot<__nv_bfloat16>(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = a.scale * LOG2E;
  const dim3 grid(hkv, a.batch, kblocks);
  bool launched = false;
  if constexpr (!L::COLS) {
    if (heads) {
      flash_bwd_dkdv_tma_kernel<DH, true>
          <<<grid, THREADS, L::SMEM, a.stream>>>(
              qm, dm, km, vm, a.lse, a.dsum,
              static_cast<__nv_bfloat16*>(a.dk),
              static_cast<__nv_bfloat16*>(a.dv), a.s_len, a.t_len, a.h_q,
              a.g, a.dh, a.causal, a.window, a.scale, scale_log2);
      launched = true;
    }
  }
  if (!launched)
    flash_bwd_dkdv_tma_kernel<DH, false>
        <<<grid, THREADS, L::SMEM, a.stream>>>(
            qm, dm, km, vm, a.lse, a.dsum,
            static_cast<__nv_bfloat16*>(a.dk),
            static_cast<__nv_bfloat16*>(a.dv), a.s_len, a.t_len, a.h_q, a.g,
            a.dh, a.causal, a.window, a.scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_tma_kernel<DH>
      <<<dim3(a.h_q, a.batch, qblocks), THREADS, L::SMEM, a.stream>>>(
          qm, dm, km, vm, a.lse, a.dsum, static_cast<__nv_bfloat16*>(a.dq),
          a.s_len, a.t_len, a.h_q, a.g, a.dh, a.causal, a.window, a.scale,
          scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (TMA + wgmma; row strides H dh and Hkv dh of 16
// bytes, which dh % 8 == 0 gives).  q, out, dout and dq are (B, S, H,
// dh); k, v, dk and dv (B, T, Hkv, dh); lse is the forward's (B, H, S) f32
// log-sum-exp and dsum a (B, H, S) f32 scratch the caller allocates (D).
// Every tensor is contiguous and 16-byte aligned.  dh is any multiple of
// 8 (past 256 in part 1's column blocks).  Launches the D pre-pass,
// dK/dV and dQ, in that order, on `stream`; allocates nothing.
// Returns the CUDA error of the first launch that fails (0 on success),
// -1 when the (dtype, dh, G) combination is not supported, -2 when the
// driver refuses a tensor map.
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
  if (dh % 8) return -1;
  if (head_width(dh) == WIDE) {
    const cudaError_t err = dtype == 0 ? launch_dot<float>(a)
                                       : launch_dot<__nv_bfloat16>(a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return flash_attention_bwd_wide(dtype, q, k, v, dout, a.lse, a.dsum, dq,
                                    dk, dv, batch, s_len, t_len, h_q, a.g,
                                    dh, causal, window, scale, a.stream);
  }
  switch (head_width(dh)) {
    case 32:
      return dtype == 0 ? static_cast<int>(launch_f32<32>(a))
                        : launch_tma<64>(a);
    case 64:
      return dtype == 0 ? static_cast<int>(launch_f32<64>(a))
                        : launch_tma<64>(a);
    case 128:
      return dtype == 0 ? static_cast<int>(launch_f32<128>(a))
                        : launch_tma<128>(a);
    case 256:
      return dtype == 0 ? static_cast<int>(launch_f32<256>(a))
                        : launch_tma<256>(a);
    default:
      return -1;
  }
}
#endif  // part 0

#if !defined(BUILD_PART) || BUILD_PART == 1
// ---------------------------------------------------------------------------
// Part 1: a head past 256, in column blocks.  Each pass owns a block of
// its outputs' columns and computes S and dP again over the whole dh, 64
// columns of it at a time, then adds the block's columns of the products:
// * dK/dV: one CTA per (b, KV head, column block, a block of keys); it
//   walks the G query heads of the group, and for each the query tiles
//   that can see its keys, so the GQA sum stays in the CTA in a fixed
//   order.  Per tile: S^T = K Q^T and dP^T = V dO^T over the chunks, then
//   P^T and dS^T, then dV += P^T dO and dK += dS^T Q over the block.
// * dQ: one CTA per (b, query head, column block, a block of query rows),
//   the last row blocks (the heaviest) first: per key tile S = Q K^T and
//   dP = dO V^T over the chunks, then dQ += dS K over the block.
// bf16 runs on the tensor cores (flash_bwd_wide_mma_kernel: 64 rows a
// CTA, 64-column tiles; dQ blocks of 128 columns, dK/dV of 64); f32 in
// IEEE FMAs on the CUDA cores (four threads a key or row, 16-row tiles,
// blocks of 64).  No atomics: two runs give the same bits.  The price of
// owning a column block is the recompute: at dh 512 in bf16 the four dQ
// and eight dK/dV blocks each compute the whole S and dP, 27 products of
// dh per valid pair and head where the bound counts five.
// ---------------------------------------------------------------------------
namespace {

constexpr int WB_TP = 4;                    // threads a key or query row
constexpr int WB_KC = 64;                   // a chunk and a column block
constexpr int WB_NF = WB_KC / (4 * WB_TP);  // float4s of a chunk a thread
constexpr int WB_KEYS = 32;                 // keys of a dK/dV CTA
constexpr int WB_ROWS = 64;                 // query rows of a dQ CTA
constexpr int WB_T = 16;                    // rows of a staged tile

// this thread's quarter c of columns c0 .. c0 + 63 of the row at p,
// interleaved by float4 (flash_attention.cu's f32 layout); zeros past dh
__device__ __forceinline__ void wb_share(const float* p, int c0, int c,
                                         int dh,
                                         float (&r)[WB_NF][4]) {
#pragma unroll
  for (int f = 0; f < WB_NF; ++f) {
    const int col = c0 + (f * WB_TP + c) * 4;
    if (col < dh) {
      load_row<4>(p + col, r[f]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[f][e] = 0.f;
    }
  }
}

__device__ __forceinline__ float wb_dot(const float (&r)[WB_NF][4],
                                        const float* row, int c) {
  float part = 0.f;
#pragma unroll
  for (int f = 0; f < WB_NF; ++f) {
    const float4 x = *reinterpret_cast<const float4*>(&row[(f * WB_TP + c)
                                                           * 4]);
    part += r[f][0] * x.x + r[f][1] * x.y + r[f][2] * x.z + r[f][3] * x.w;
  }
  return part;
}

__device__ __forceinline__ void wb_axpy(float (&acc)[WB_NF][4], float a,
                                        const float* row, int c) {
#pragma unroll
  for (int f = 0; f < WB_NF; ++f) {
    const float4 x = *reinterpret_cast<const float4*>(&row[(f * WB_TP + c)
                                                           * 4]);
    acc[f][0] = fmaf(a, x.x, acc[f][0]);
    acc[f][1] = fmaf(a, x.y, acc[f][1]);
    acc[f][2] = fmaf(a, x.z, acc[f][2]);
    acc[f][3] = fmaf(a, x.w, acc[f][3]);
  }
}

// rows r0 .. r0 + WB_T - 1 (zeros from n on) and columns c0 .. c0 + 63
// (zeros past dh) of x, rows rs apart, into an f32 tile; NTH threads
template <int NTH>
__device__ __forceinline__ void wb_stage(float (*t)[WB_KC], const float* x,
                                         int64_t rs, int r0, int n, int c0,
                                         int dh) {
  for (int idx = threadIdx.x * 4; idx < WB_T * WB_KC; idx += NTH * 4) {
    const int j = idx / WB_KC, d = idx % WB_KC;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + j < n && c0 + d < dh)
      load_row<4>(x + (r0 + j) * rs + c0 + d, f);
    *reinterpret_cast<float4*>(&t[j][d]) = make_float4(f[0], f[1], f[2],
                                                       f[3]);
  }
}

__global__ void __launch_bounds__(WB_KEYS * WB_TP)
flash_bwd_wide_dkdv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int s_len,
                           int t_len, int h_q, int g, int dh, int causal,
                           int window, float scale) {
  constexpr int NTH = WB_KEYS * WB_TP;
  __shared__ __align__(16) float ta[WB_T][WB_KC];   // Q: a chunk, the block
  __shared__ __align__(16) float tb[WB_T][WB_KC];   // dO: the same
  const int nvb = (dh + WB_KC - 1) / WB_KC;
  const int kh = blockIdx.x / nvb;
  const int col0 = (blockIdx.x % nvb) * WB_KC;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * WB_KEYS;
  const int r = threadIdx.x / WB_TP;
  const int c = threadIdx.x % WB_TP;
  const int kj = k0 + r;
  const bool live = kj < t_len;
  const int hkv = h_q / g;
  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const int64_t koff = (static_cast<int64_t>(b) * t_len + (live ? kj : 0))
                       * krow + static_cast<int64_t>(kh) * dh;

  // the queries that can see the CTA's keys
  int i_begin = 0, i_end = s_len;
  if (causal) {
    i_begin = k0;
    if (window > 0)
      i_end = static_cast<int>(min(static_cast<int64_t>(s_len),
                                   static_cast<int64_t>(k0) + WB_KEYS - 1
                                       + window));
  }

  float dka[WB_NF][4], dva[WB_NF][4];
#pragma unroll
  for (int f = 0; f < WB_NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[f][e] = dva[f][e] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int h = kh * g + gi;
    const int64_t hoff = static_cast<int64_t>(b) * s_len * qrow
                         + static_cast<int64_t>(h) * dh;
    const float* lse_h = lse + (static_cast<int64_t>(b) * h_q + h) * s_len;
    const float* d_h = dsum + (static_cast<int64_t>(b) * h_q + h) * s_len;
    for (int i0 = i_begin; i0 < i_end; i0 += WB_T) {
      bool need = live;
      if (causal) {
        need = need && i0 + WB_T - 1 >= kj;
        if (window > 0) need = need && i0 <= kj + window - 1;
      }
      const bool wneed = __any_sync(0xffffffffu, need);
      float st[WB_T], dpt[WB_T];
#pragma unroll
      for (int j = 0; j < WB_T; ++j) st[j] = dpt[j] = 0.f;
      for (int c0 = 0; c0 < dh; c0 += WB_KC) {
        __syncthreads();            // the previous tiles are consumed
        wb_stage<NTH>(ta, q + hoff, qrow, i0, s_len, c0, dh);
        wb_stage<NTH>(tb, dout + hoff, qrow, i0, s_len, c0, dh);
        __syncthreads();
        if (!wneed) continue;
        float kr[WB_NF][4], vr[WB_NF][4];
        wb_share(k + koff, c0, c, dh, kr);
        wb_share(v + koff, c0, c, dh, vr);
#pragma unroll
        for (int j = 0; j < WB_T; ++j) {
          st[j] += wb_dot(kr, ta[j], c);
          dpt[j] += wb_dot(vr, tb[j], c);
        }
      }
      __syncthreads();              // the last chunk is consumed
      wb_stage<NTH>(ta, q + hoff, qrow, i0, s_len, col0, dh);
      wb_stage<NTH>(tb, dout + hoff, qrow, i0, s_len, col0, dh);
      __syncthreads();
      if (!wneed) continue;
#pragma unroll
      for (int j = 0; j < WB_T; ++j) {
        float sv = st[j], dpv = dpt[j];
#pragma unroll
        for (int o = 1; o < WB_TP; o <<= 1) {
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
          dpv += __shfl_xor_sync(0xffffffffu, dpv, o);
        }
        const int i = i0 + j;
        bool ok = live && i < s_len;
        if (causal) ok = ok && kj <= i && (window <= 0 || kj > i - window);
        const float p = ok ? expf(sv * scale - lse_h[i]) : 0.f;
        const float ds = ok ? p * (dpv - d_h[i]) : 0.f;
        wb_axpy(dva, p, tb[j], c);
        wb_axpy(dka, ds, ta[j], c);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int f = 0; f < WB_NF; ++f) {
    const int col = col0 + (f * WB_TP + c) * 4;
    if (col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store_one(dk + koff + col + e, dka[f][e] * scale);
      store_one(dv + koff + col + e, dva[f][e]);
    }
  }
}

__global__ void __launch_bounds__(WB_ROWS * WB_TP)
flash_bwd_wide_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, float* __restrict__ dq,
                         int s_len, int t_len, int h_q, int g, int dh,
                         int causal, int window, float scale) {
  constexpr int NTH = WB_ROWS * WB_TP;
  __shared__ __align__(16) float ta[WB_T][WB_KC];   // K: a chunk, the block
  __shared__ __align__(16) float tb[WB_T][WB_KC];   // V: a chunk
  const int nvb = (dh + WB_KC - 1) / WB_KC;
  const int h = blockIdx.x / nvb;
  const int col0 = (blockIdx.x % nvb) * WB_KC;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WB_ROWS;  // heaviest first
  const int r = threadIdx.x / WB_TP;
  const int c = threadIdx.x % WB_TP;
  const int qi = q0 + r;
  const bool live = qi < s_len;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const int64_t qoff = (static_cast<int64_t>(b) * s_len + (live ? qi : 0))
                       * qrow + static_cast<int64_t>(h) * dh;
  const int64_t kvoff = static_cast<int64_t>(b) * t_len * krow
                        + static_cast<int64_t>(kh) * dh;
  const int64_t srow = (static_cast<int64_t>(b) * h_q + h) * s_len
                       + (live ? qi : 0);
  const float lse_i = lse[srow];
  const float d_i = dsum[srow];

  int lo = 0, hi = t_len - 1;
  if (causal) {
    hi = min(qi, t_len - 1);
    if (window > 0) lo = max(qi - window + 1, 0);
  }
  int k_begin = 0, k_end = t_len;
  if (causal) {
    k_end = min(min(q0 + WB_ROWS, s_len), t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / WB_T) * WB_T;

  float dqa[WB_NF][4];
#pragma unroll
  for (int f = 0; f < WB_NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[f][e] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += WB_T) {
    const bool need = live && t0 <= hi && t0 + WB_T - 1 >= lo;
    const bool wneed = __any_sync(0xffffffffu, need);
    float st[WB_T], dpt[WB_T];
#pragma unroll
    for (int j = 0; j < WB_T; ++j) st[j] = dpt[j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += WB_KC) {
      __syncthreads();
      wb_stage<NTH>(ta, k + kvoff, krow, t0, t_len, c0, dh);
      wb_stage<NTH>(tb, v + kvoff, krow, t0, t_len, c0, dh);
      __syncthreads();
      if (!wneed) continue;
      float qr[WB_NF][4], dr[WB_NF][4];
      wb_share(q + qoff, c0, c, dh, qr);
      wb_share(dout + qoff, c0, c, dh, dr);
#pragma unroll
      for (int j = 0; j < WB_T; ++j) {
        st[j] += wb_dot(qr, ta[j], c);
        dpt[j] += wb_dot(dr, tb[j], c);
      }
    }
    __syncthreads();
    wb_stage<NTH>(ta, k + kvoff, krow, t0, t_len, col0, dh);
    __syncthreads();
    if (!wneed) continue;
#pragma unroll
    for (int j = 0; j < WB_T; ++j) {
      float sv = st[j], dpv = dpt[j];
#pragma unroll
      for (int o = 1; o < WB_TP; o <<= 1) {
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        dpv += __shfl_xor_sync(0xffffffffu, dpv, o);
      }
      const int t = t0 + j;
      const bool ok = live && t >= lo && t <= hi;
      const float p = ok ? expf(sv * scale - lse_i) : 0.f;
      wb_axpy(dqa, ok ? p * (dpv - d_i) : 0.f, ta[j], c);
    }
  }

  if (!live) return;
#pragma unroll
  for (int f = 0; f < WB_NF; ++f) {
    const int col = col0 + (f * WB_TP + c) * 4;
    if (col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) store_one(dq + qoff + col + e,
                                          dqa[f][e] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators), as the
// forward's column-block body: four warps of 16 rows a CTA (query rows in
// dQ, keys in dK/dV), 64-column tiles of the other side (keys, queries)
// walked in order, and per tile S and dP summed over 64-column chunks of
// dh that arrive (the rows' two operands and the tile's two) through a
// 3-stage cp.async ring, then the tile's columns of the outputs' block.
// P and dS are rounded to bf16 in the registers that hold them and enter
// the output products as A fragments (the C layout of m16n8 is the A
// layout of m16n8k16), with no trip through shared memory.  dQ owns 128
// columns a CTA, dK/dV 64 of each (two sets of sums).
// ---------------------------------------------------------------------------

constexpr int WM_ROWS = 64;            // rows of a CTA
constexpr int WM_T = 64;               // columns of a tile
constexpr int WM_NT = 128;             // one warp per 16 rows
constexpr int WM_P = WB_KC + 8;        // chunk pitch, bf16
constexpr int WM_QB = 128;             // dQ's column block
constexpr int WM_KB = 64;              // dK's and dV's column block
constexpr int WM_ST = 3;               // stages of the ring
// a stage: four chunks, or a tile's column blocks (at most two of 64 or
// one of 128 columns), bf16 elements
constexpr int WM_STAGE = 4 * WM_ROWS * WM_P;
constexpr int WM_SMEM = WM_ST * WM_STAGE * 2;

// 64 rows (r0 .., zeros from n on) and 64 columns (c0 .., zeros past dh)
// of x, rows rs apart, into a tile of pitch pitch by cp.async
__device__ __forceinline__ void wm_rows(__nv_bfloat16* t, int pitch,
                                        const __nv_bfloat16* x, int64_t rs,
                                        int r0, int n, int c0, int cols,
                                        int dh) {
  for (int c = threadIdx.x; c < WM_ROWS * (cols / 8); c += WM_NT) {
    const int row = c / (cols / 8);
    const int col = (c % (cols / 8)) * 8;
    const bool ok = r0 + row < n && c0 + col < dh;
    cp_async16(t + row * pitch + col,
               x + (ok ? (r0 + row) * rs + c0 + col : 0), ok);
  }
}

// The launch's operands.  rows: the CTA's (q and dout in dQ, k and v in
// dK/dV), tile: the walked side's (k and v; q and dout), each with its
// row stride and count.
struct WmOps {
  const __nv_bfloat16 *a1, *a2, *b1, *b2;
  int64_t ars, brs;
  int na, nb;
};

// Item i of a CTA's walk into stage st: for tile it = i / (nch + 1),
// items 0 .. nch - 1 are the 64-column chunks of the rows' two operands
// and of the tile's two, item nch the tile's columns of the outputs'
// block (b1's in dQ; b1's and b2's in dK/dV).
template <bool KV>
__device__ __forceinline__ void wm_issue(__nv_bfloat16* st, int i, int nch,
                                         const WmOps& o, int r0, int t0,
                                         int dh, int col0) {
  const int part = i % (nch + 1);
  const int b0 = t0 + (i / (nch + 1)) * WM_T;
  if (part < nch) {
    const int c0 = part * WB_KC;
    const int tile = WM_ROWS * WM_P;
    wm_rows(st, WM_P, o.a1, o.ars, r0, o.na, c0, WB_KC, dh);
    wm_rows(st + tile, WM_P, o.a2, o.ars, r0, o.na, c0, WB_KC, dh);
    wm_rows(st + 2 * tile, WM_P, o.b1, o.brs, b0, o.nb, c0, WB_KC, dh);
    wm_rows(st + 3 * tile, WM_P, o.b2, o.brs, b0, o.nb, c0, WB_KC, dh);
  } else if constexpr (KV) {
    wm_rows(st, WM_KB + 8, o.b1, o.brs, b0, o.nb, col0, WM_KB, dh);
    wm_rows(st + WM_T * (WM_KB + 8), WM_KB + 8, o.b2, o.brs, b0, o.nb,
            col0, WM_KB, dh);
  } else {
    wm_rows(st, WM_QB + 8, o.b1, o.brs, b0, o.nb, col0, WM_QB, dh);
  }
}

// acc (16 rows x 8 nd columns) += a (16 x 64, four k-steps of A
// fragments) times the tile rows of t (64 x pitch, bf16) as an MN-major B
template <int ND>
__device__ __forceinline__ void wm_cols(float (&acc)[ND][4],
                                        const unsigned (&a)[4][4],
                                        const __nv_bfloat16* t, int pitch) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      unsigned vf[4];
      hopper::ldmatrix_x4_trans(vf, t + (kk * 16 + (lane & 7)
                                         + ((lane >> 3) & 1) * 8) * pitch
                                       + n * 8 + (lane >> 4) * 8);
      hopper::mma_bf16(acc[n], a[kk], vf[0], vf[1]);
      hopper::mma_bf16(acc[n + 1], a[kk], vf[2], vf[3]);
    }
  }
}

// One pass.  dQ (KV false): CTA (query head h x column block, b, 64 query
// rows), the key tiles each row block's mask leaves; dK/dV (KV true): CTA
// (KV head x column block, b, 64 keys), for each of the G query heads the
// query tiles that can see the keys.  Element (e) of a C fragment is row
// w0 + gq + 8 (e >> 1), tile column j * 8 + 2 tq + (e & 1).
template <bool KV>
__global__ void __launch_bounds__(WM_NT, 1)
flash_bwd_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ out1,
                          __nv_bfloat16* __restrict__ out2, int s_len,
                          int t_len, int h_q, int g, int dh, int causal,
                          int window, float scale) {
  constexpr int CB = KV ? WM_KB : WM_QB;
  constexpr int ND = CB / 8;
  constexpr int NS = WM_T / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const float sl2 = scale * LOG2E;

  const int nvb = (dh + CB - 1) / CB;
  const int head = blockIdx.x / nvb;             // KV: a KV head
  const int col0 = (blockIdx.x % nvb) * CB;
  const int b = blockIdx.y;
  const int r0 = (KV ? blockIdx.z : gridDim.z - 1 - blockIdx.z) * WM_ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int hkv = h_q / g;
  const int w0 = r0 + warp * 16;                 // the warp's first row
  const int64_t qrs = static_cast<int64_t>(h_q) * dh;
  const int64_t krs = static_cast<int64_t>(hkv) * dh;
  const int nch = (dh + WB_KC - 1) / WB_KC;
  const int n_rows = KV ? t_len : s_len;
  const int w_last = min(w0 + 15, n_rows - 1);

  float acc1[ND][4], acc2[KV ? ND : 1][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (KV ? ND : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;
  float s[NS][4], dp[NS][4];

  for (int gi = 0; gi < (KV ? g : 1); ++gi) {
    const int h = KV ? head * g + gi : head;     // the query head
    const int kh = KV ? head : h / g;
    const int64_t qoff = static_cast<int64_t>(b) * s_len * qrs
                         + static_cast<int64_t>(h) * dh;
    const int64_t koff = static_cast<int64_t>(b) * t_len * krs
                         + static_cast<int64_t>(kh) * dh;
    const float* lse_h = lse + (static_cast<int64_t>(b) * h_q + h) * s_len;
    const float* d_h = dsum + (static_cast<int64_t>(b) * h_q + h) * s_len;
    const WmOps o = KV ? WmOps{k + koff, v + koff, q + qoff, dout + qoff,
                               krs, qrs, t_len, s_len}
                       : WmOps{q + qoff, dout + qoff, k + koff, v + koff,
                               qrs, krs, s_len, t_len};
    // the tiles to walk: dQ the keys its rows' masks leave, dK/dV the
    // queries that can see its keys
    int t0 = 0, t1 = KV ? s_len : t_len;
    if (causal) {
      if (KV) {
        t0 = r0;
        if (window > 0)
          t1 = static_cast<int>(min(static_cast<int64_t>(s_len),
                                    static_cast<int64_t>(r0) + WM_ROWS - 1
                                        + window));
      } else {
        t1 = min(min(r0 + WM_ROWS, s_len), t_len);
        if (window > 0) t0 = max(r0 - window + 1, 0);
      }
    }
    t0 = (t0 / WM_T) * WM_T;
    const int n_tiles = t1 > t0 ? (t1 - t0 + WM_T - 1) / WM_T : 0;
    const int items = n_tiles * (nch + 1);
    // dQ: the warp's rows' (log2-unit) log-sum-exps and D, once
    float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    if constexpr (!KV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w0 + gq + 8 * r;
        if (row < s_len) {
          lr[r] = lse_h[row] * LOG2E;
          dr[r] = d_h[row];
        }
      }
    }

    __syncthreads();             // the previous head's last stage is read
#pragma unroll
    for (int st = 0; st < WM_ST - 1; ++st) {
      if (st < items)
        wm_issue<KV>(smem + st * WM_STAGE, st, nch, o, r0, t0, dh, col0);
      cp_async_commit();
    }
    for (int i = 0; i < items; ++i) {
      cp_async_wait<WM_ST - 2>();
      __syncthreads();           // item i landed; item i - 1 consumed
      if (i + WM_ST - 1 < items)
        wm_issue<KV>(smem + (i + WM_ST - 1) % WM_ST * WM_STAGE,
                     i + WM_ST - 1, nch, o, r0, t0, dh, col0);
      cp_async_commit();

      const int part = i % (nch + 1);
      const int c0 = t0 + (i / (nch + 1)) * WM_T;   // the tile's first
      // warp-uniform: does any pair of the warp's rows and the tile pass
      // the mask, and do all?
      bool need = w0 < n_rows;
      bool full;
      if (KV) {
        full = w0 + 15 < t_len && c0 + WM_T <= s_len;
        if (causal) {
          need = need && c0 + WM_T - 1 >= w0;
          full = full && c0 >= w0 + 15;
          if (window > 0) {
            need = need && c0 <= w_last + window - 1;
            full = full && c0 + WM_T - 1 <= w0 + window - 1;
          }
        }
      } else {
        full = c0 + WM_T <= t_len;
        if (causal) {
          need = need && c0 <= w_last;
          full = full && c0 + WM_T - 1 <= w0;
          if (window > 0) {
            need = need && c0 + WM_T - 1 > w0 - window;
            full = full && c0 > w_last - window;
          }
        }
      }
      if (!need) continue;
      const __nv_bfloat16* sa = smem + (i % WM_ST) * WM_STAGE;

      if (part < nch) {
        // S += A1 B1^T and dP += A2 B2^T over this chunk
        constexpr int TILE = WM_ROWS * WM_P;
        if (part == 0) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < WB_KC / 16; kk += 2) {
          unsigned a10[4], a11[4], a20[4], a21[4];
          const int ao = (warp * 16 + (lane & 15)) * WM_P + kk * 16
                         + (lane >> 4) * 8;
          hopper::ldmatrix_x4(a10, sa + ao);
          hopper::ldmatrix_x4(a11, sa + ao + 16);
          hopper::ldmatrix_x4(a20, sa + TILE + ao);
          hopper::ldmatrix_x4(a21, sa + TILE + ao + 16);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const int bo = (j * 8 + (lane & 7)) * WM_P + kk * 16
                           + (lane >> 3) * 8;
            unsigned bf[4];
            hopper::ldmatrix_x4(bf, sa + 2 * TILE + bo);
            hopper::mma_bf16(s[j], a10, bf[0], bf[1]);
            hopper::mma_bf16(s[j], a11, bf[2], bf[3]);
            hopper::ldmatrix_x4(bf, sa + 3 * TILE + bo);
            hopper::mma_bf16(dp[j], a20, bf[0], bf[1]);
            hopper::mma_bf16(dp[j], a21, bf[2], bf[3]);
          }
        }
        continue;
      }

      // P and dS of the tile, as bf16 A fragments (tile columns 16 kk ..)
      unsigned pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w0 + gq + (e >> 1) * 8;
          const int col = c0 + j * 8 + 2 * tq + (e & 1);
          const int key = KV ? row : col, qi = KV ? col : row;
          bool ok = true;
          if (!full) {
            ok = key < t_len && qi < s_len;
            if (causal)
              ok = ok && key <= qi && (window <= 0 || key > qi - window);
          }
          float l2, dv;
          if constexpr (KV) {
            l2 = ok ? lse_h[qi] * LOG2E : 0.f;
            dv = ok ? d_h[qi] : 0.f;
          } else {
            l2 = lr[e >> 1];
            dv = dr[e >> 1];
          }
          p[e] = ok ? ex2(fmaf(s[j][e], sl2, -l2)) : 0.f;
          ds[e] = p[e] * (dp[j][e] - dv);
        }
        pa[j / 2][(j & 1) * 2] = hopper::pack_bf16x2(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = hopper::pack_bf16x2(p[2], p[3]);
        da[j / 2][(j & 1) * 2] = hopper::pack_bf16x2(ds[0], ds[1]);
        da[j / 2][(j & 1) * 2 + 1] = hopper::pack_bf16x2(ds[2], ds[3]);
      }
      if constexpr (KV) {
        wm_cols(acc1, da, sa, CB + 8);                    // dK += dS^T Q
        wm_cols(acc2, pa, sa + WM_T * (CB + 8), CB + 8);  // dV += P^T dO
      } else {
        wm_cols(acc1, da, sa, CB + 8);                    // dQ += dS K
      }
    }
    cp_async_wait<0>();
  }

  // rows w0 + gq and + 8: the outputs' block, dK and dQ times the scale
  const int64_t rs = KV ? krs : qrs;
  const int64_t base = static_cast<int64_t>(b) * n_rows * rs
                       + static_cast<int64_t>(head) * dh + col0 + 2 * tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gq + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (col0 + n * 8 >= dh) continue;   // dh % 8 == 0: whole 8-column tiles
      const int64_t at = base + row * rs + n * 8;
      *reinterpret_cast<__nv_bfloat162*>(out1 + at) = __floats2bfloat162_rn(
          acc1[n][2 * r] * scale, acc1[n][2 * r + 1] * scale);
      if constexpr (KV)
        *reinterpret_cast<__nv_bfloat162*>(out2 + at) =
            __floats2bfloat162_rn(acc2[n][2 * r], acc2[n][2 * r + 1]);
    }
  }
}

cudaError_t launch_wide_mma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* dsum, void* dq, void* dk, void* dv,
                            int batch, int s_len, int t_len, int h_q, int g,
                            int dh, int causal, int window, float scale,
                            cudaStream_t stream) {
  static bool smem_set = false;   // the attributes, once
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_wide_mma_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WM_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_wide_mma_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WM_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int hkv = h_q / g;
  const int kblocks = (t_len + WM_ROWS - 1) / WM_ROWS;
  const int qblocks = (s_len + WM_ROWS - 1) / WM_ROWS;
  const int nk = (dh + WM_KB - 1) / WM_KB, nq = (dh + WM_QB - 1) / WM_QB;
  if (batch > 65535 || kblocks > 65535 || qblocks > 65535 ||
      static_cast<int64_t>(h_q) * nk > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  const auto* dt = static_cast<const __nv_bfloat16*>(dout);
  flash_bwd_wide_mma_kernel<true>
      <<<dim3(hkv * nk, batch, kblocks), WM_NT, WM_SMEM, stream>>>(
          qt, kt, vt, dt, lse, dsum, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), s_len, t_len, h_q, g, dh, causal,
          window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_wide_mma_kernel<false>
      <<<dim3(h_q * nq, batch, qblocks), WM_NT, WM_SMEM, stream>>>(
          qt, kt, vt, dt, lse, dsum, static_cast<__nv_bfloat16*>(dq),
          nullptr, s_len, t_len, h_q, g, dh, causal, window, scale);
  return cudaGetLastError();
}

int launch_wide_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dsum,
                    void* dq, void* dk, void* dv, int batch, int s_len,
                    int t_len, int h_q, int g, int dh, int causal,
                    int window, float scale, cudaStream_t stream) {
  const int nvb = (dh + WB_KC - 1) / WB_KC;
  const int hkv = h_q / g;
  const int kblocks = (t_len + WB_KEYS - 1) / WB_KEYS;
  const int qblocks = (s_len + WB_ROWS - 1) / WB_ROWS;
  if (batch > 65535 || kblocks > 65535 || qblocks > 65535 ||
      static_cast<int64_t>(h_q) * nvb > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* dt = static_cast<const float*>(dout);
  flash_bwd_wide_dkdv_kernel
      <<<dim3(hkv * nvb, batch, kblocks), WB_KEYS * WB_TP, 0, stream>>>(
          qt, kt, vt, dt, lse, dsum, static_cast<float*>(dk),
          static_cast<float*>(dv), s_len, t_len, h_q, g, dh, causal, window,
          scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_wide_dq_kernel
      <<<dim3(h_q * nvb, batch, qblocks), WB_ROWS * WB_TP, 0, stream>>>(
          qt, kt, vt, dt, lse, dsum, static_cast<float*>(dq), s_len, t_len,
          h_q, g, dh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_wide(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, void* dq, void* dk, void* dv,
    int batch, int s_len, int t_len, int h_q, int g, int dh, int causal,
    int window, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_wide_f32(q, k, v, dout, lse, dsum, dq, dk, dv, batch,
                           s_len, t_len, h_q, g, dh, causal, window, scale,
                           stream);
  return static_cast<int>(launch_wide_mma(q, k, v, dout, lse, dsum, dq, dk,
                                          dv, batch, s_len, t_len, h_q, g,
                                          dh, causal, window, scale,
                                          stream));
}
#endif  // part 1
