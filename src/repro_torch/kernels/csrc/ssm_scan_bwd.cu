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
// The launches, every sum in a fixed order and none across CTAs with
// atomics, so two runs give the same bits.  Where dk <= 64 and dv <= 64
// (hymba: dk 16, dv 64) and q, k, v and dy rows load 16 bytes at a time,
// the fused route, four launches:
// 1. scan_bwd_u_chunk_kernel<Ops, DKP> (DKP = 16, 32 or 64, the least that
//    holds dk): one CTA per (b, h, chunk) stages q exp(L) and dy in shared
//    memory and sums U_c (Q^T read with ldmatrix.trans) and exp(L_last);
// 2. scan_bwd_state_pass_kernel: one thread per (b, h, state entry) walks
//    the chunks backwards, writing D_c over U_c and dh0 at the end;
// 3. scan_bwd_chunk_kernel<Ops, DKP>: one CTA per (b, h, chunk) loads q, k,
//    v, dy, S_c and D_c into shared memory once (cp.async) and its twelve
//    warps split the 16-row blocks of the chunk.  Warp w < 8, as the query
//    rows of block w, builds W 16 keys at a time (the keys up to its rows)
//    and sums dq = diag(exp L) dY S^T + W K; as the key rows, W^T 16
//    queries at a time (the queries from its rows on) and dk = diag(exp(
//    L_last - L)) V D^T + W^T Q: w + 1 and 8 - w steps.  Warps 8-11 take
//    P^T and dv = diag(exp(L_last - L)) K D + P^T dY for blocks j and 7 -
//    j: nine steps each.  The pair tiles never leave the registers: each is
//    masked and decayed in the C fragment of its product and enters the
//    next product as its A operand.  It writes dq, dk and dv in the input
//    type and r_t = q_t . dq_t - k_t . dk_t from the f32 sums;
// 4. scan_bwd_dla_kernel: one CTA per (b, h) turns r into its suffix sums
//    over t (plus <dH_T, H_T> when dH_T is given): dla.
// Otherwise (mLSTM: dk 512, dv 513) the tiled route, six launches that
// keep every reduction inside one CTA: scan_bwd_u_kernel (U_c in 128 x 64
// tiles), the state pass (D_c in the input type, which its products round
// it to anyway), scan_bwd_pair_kernel (P and W once per chunk in the input
// type: recomputing W for every dk tile would cost each tile eight times
// its own product at dk 512), scan_bwd_dqdk_kernel (dq or dk of 64 columns
// of dk over the whole of dv and the chunk, and its part of r),
// scan_bwd_dv_kernel (dv of 64 columns of dv over the whole of dk and the
// chunk) and the dla pass, which adds each row's parts of r in order.
//
// The products.  bf16 runs every product on the tensor cores (mma.sync
// m16n8k16, f32 accumulators): the fused route through warp products on
// its shared tiles (WarpMma), the tiled one through a CTA tile product of
// 128 x 64 staged 32 deep in shared memory (TileOps), each thread loading
// runs of 8 along the operand's contiguous axis, the next step's while
// this step's products run.  Its operands are bf16: q, k, v and dy as
// given; S_c, D_c, the pair tiles and q exp(L) of U rounded to bf16 where
// they enter a product; sums, decays, U, the recursion of D and r stay
// f32.  f32 stays IEEE f32 on the CUDA cores (no TF32) with the same
// decomposition: the warp products as FMAs in the same fragment layouts
// (WarpFma), the tile product in runs of 4.  dv 513 (not a multiple of 8)
// takes the tiled route, whose loads go an element at a time with bounds
// and zeros past every edge; its own state rows are padded to a multiple
// of 8 (dvp).
//
// What bounds it: bytes.  q, k, v, dy and la read, the forward's chunk
// states read, dq, dk, dv and dla written: about 200 MB at hymba's training
// shape (B 2, T 4096, H 50), 0.06 ms at 3.35 TB/s.  The operations, about
// chunk * (6 dk + 4 dv) + 8 dk dv per token and head, take a tenth of that
// on the tensor cores.  What holds it below: the chunk pass's CTAs load
// their tiles and then compute, two to an SM, so loads and products of a
// chunk do not overlap; the U and state passes move U and D once more; the
// tiled route stages its operands through registers an element at a time
// and moves U, D and the pair scratch through device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

// The strides of q and k: outside the anonymous namespace, so the two
// parts of the build (kernels/build.py PARTS) share the one type.
struct Strides {
  int64_t qb, qt, qh, kb, kt, kh;
};

namespace {

constexpr int CMAX = 128;        // largest chunk, the rows of every tile
constexpr int NT = 256;          // threads per CTA
constexpr int NWARPS = NT / 32;  // the fused pass: one 16-row block each
constexpr int TILE = 64;         // output columns of a tile CTA
constexpr int UROWS = 128;       // dk rows of a U tile
constexpr int FUSED_DV = 64;     // dv the fused pass holds whole
constexpr int FUSED_DK = 64;     // dk the fused pass holds whole
constexpr int PASS_BATCH = 8;    // chunks whose loads the state pass issues
                                 // at once


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

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// The CTA tile product of the tiled pass: acc (128 x 64) += A (128 x kdim)
// B (kdim x 64) with A(i, kk) = fa(i, kk) and B(kk, n) = fb(kk, n), each
// returning 0 outside its operand, staged KC deep through shared memory.
// A_KF / B_KF: the operand's memory has k contiguous (else A's rows / B's
// columns).  Each thread stages runs of R elements along that contiguous
// axis (one row base a run, the loads at fixed offsets) and stores a run
// at once; the next step's runs are loaded while this step's products
// run.  Rows outside [r_lo, r_hi) are known to stay 0; the tensor-core
// version neither stages nor multiplies them.  each() visits every (row,
// column, accumulator); row_dot() writes out[row] = sum over the columns
// of acc g(row, column), in a fixed order.  Every thread of the CTA calls
// them.
// ---------------------------------------------------------------------------

template <int KC, int R, bool A_KF, bool B_KF, bool PACK>
struct Stage {
  static constexpr int A_RUNS = CMAX * KC / R / NT;   // a thread's runs
  static constexpr int B_RUNS = TILE * KC / R / NT;
  static_assert(A_RUNS * R * NT == CMAX * KC && B_RUNS * R * NT == TILE * KC,
                "whole runs per thread");
  // a run as it waits in registers: R floats, or R / 2 bf16 pairs (PACK)
  using V = typename std::conditional<PACK, unsigned, float>::type;
  static constexpr int W = PACK ? R / 2 : R;
  V ra[A_RUNS][W], rb[B_RUNS][W];

  // the first (row, k) of A's run idx, and of B's (column, k)
  static __device__ __forceinline__ void a_run(int idx, int& i, int& kk) {
    i = A_KF ? idx / (KC / R) : idx % (CMAX / R) * R;
    kk = A_KF ? idx % (KC / R) * R : idx / (CMAX / R);
  }
  static __device__ __forceinline__ void b_run(int idx, int& n, int& kk) {
    n = B_KF ? idx / (KC / R) : idx % (TILE / R) * R;
    kk = B_KF ? idx % (KC / R) * R : idx / (TILE / R);
  }

  static __device__ __forceinline__ void keep(const float (&x)[R],
                                              V (&out)[W]) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if constexpr (PACK)
        out[j] = hopper::pack_bf16x2(x[2 * j], x[2 * j + 1]);
      else
        out[j] = x[j];
    }
  }

  template <class FA, class FB>
  __device__ __forceinline__ void fetch(int k0, int kdim, int s_lo, int s_hi,
                                        FA& fa, FB& fb) {
#pragma unroll
    for (int u = 0; u < A_RUNS; ++u) {
      int i, kk;
      a_run(threadIdx.x + u * NT, i, kk);
      const bool ok = i >= s_lo && i < s_hi;
      float x[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ij = A_KF ? i : i + j, kj = k0 + kk + (A_KF ? j : 0);
        x[j] = ok && kj < kdim ? fa(ij, kj) : 0.f;
      }
      keep(x, ra[u]);
    }
#pragma unroll
    for (int u = 0; u < B_RUNS; ++u) {
      int n, kk;
      b_run(threadIdx.x + u * NT, n, kk);
      float x[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int nj = B_KF ? n : n + j, kj = k0 + kk + (B_KF ? j : 0);
        x[j] = kj < kdim ? fb(kj, nj) : 0.f;
      }
      keep(x, rb[u]);
    }
  }

  // pa(i, kk, run) and pb(n, kk, run) store a run where the product reads it
  template <class PA, class PB>
  __device__ __forceinline__ void put(int s_lo, int s_hi, PA pa, PB pb) {
#pragma unroll
    for (int u = 0; u < A_RUNS; ++u) {
      int i, kk;
      a_run(threadIdx.x + u * NT, i, kk);
      if (i >= s_lo && i < s_hi) pa(i, kk, ra[u]);
    }
#pragma unroll
    for (int u = 0; u < B_RUNS; ++u) {
      int n, kk;
      b_run(threadIdx.x + u * NT, n, kk);
      pb(n, kk, rb[u]);
    }
  }
};

template <typename T>
struct TileOps;

// f32 FMAs on the CUDA cores: thread (ty = tid / 16, tx = tid % 16) owns
// rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3; every row staged,
// A as [k][row] and B as [k][column], runs of 4.
template <>
struct TileOps<float> {
  static constexpr int KC = 32;
  static constexpr int R = 4;
  struct Smem {
    float a[KC][CMAX + 4];
    float b[KC][TILE + 4];
  };

  template <bool A_KF, bool B_KF, class FA, class FB>
  static __device__ __forceinline__ void gemm(float (&acc)[8][4], int kdim,
                                              int, int, FA fa, FB fb,
                                              Smem& sm) {
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const auto pa = [&](int i, int kk, const float (&x)[R]) {
      if (A_KF) {
#pragma unroll
        for (int j = 0; j < R; ++j) sm.a[kk + j][i] = x[j];
      } else {
        *reinterpret_cast<float4*>(&sm.a[kk][i]) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    };
    const auto pb = [&](int n, int kk, const float (&x)[R]) {
      if (B_KF) {
#pragma unroll
        for (int j = 0; j < R; ++j) sm.b[kk + j][n] = x[j];
      } else {
        *reinterpret_cast<float4*>(&sm.b[kk][n]) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    };
    Stage<KC, R, A_KF, B_KF, false> stage;
    stage.fetch(0, kdim, 0, CMAX, fa, fb);
    for (int k0 = 0; k0 < kdim; k0 += KC) {
      __syncthreads();            // the previous step is consumed
      stage.put(0, CMAX, pa, pb);
      __syncthreads();
      if (k0 + KC < kdim) stage.fetch(k0 + KC, kdim, 0, CMAX, fa, fb);
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

  template <class F>
  static __device__ __forceinline__ void each(float (&acc)[8][4], F f) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) f(ty * 8 + r, tx * 4 + c, acc[r][c]);
  }

  // f(row, column, x, y): the pairs of columns (column, column + 1),
  // column even
  template <class F>
  static __device__ __forceinline__ void each2(float (&acc)[8][4], F f) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        f(ty * 8 + r, tx * 4 + c, acc[r][c], acc[r][c + 1]);
  }

  template <class G>
  static __device__ __forceinline__ void row_dot(const float (&acc)[8][4],
                                                 G g, float* out) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = ty * 8 + r;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) s = fmaf(acc[r][c], g(row, tx * 4 + c), s);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)       // the 16 lanes of the row
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (tx == 0) out[row] = s;
    }
  }
};

// bf16 on the tensor cores: warp w owns rows 16 w .. 16 w + 15 in the C
// fragment layout of hopper.cuh (acc[nd] holds rows 16 w + gq and + 8,
// columns 8 nd + 2 tq and + 1).  Operands are rounded to bf16 as they are
// fetched, runs of 8 kept as four bf16 pairs and stored 16 bytes at once:
// an operand with k contiguous as [row][k] (ldmatrix), else as [k][row]
// (ldmatrix.trans).
template <>
struct TileOps<__nv_bfloat16> {
  static constexpr int KC = 32;
  static constexpr int R = 8;
  static constexpr int PK = KC + 8;         // pitch of [row][k] tiles
  static constexpr int PA = CMAX + 8;       // pitch of A as [k][row]
  static constexpr int PB = TILE + 8;       // pitch of B as [k][column]
  struct Smem {
    __nv_bfloat16 a[CMAX * PK > KC * PA ? CMAX * PK : KC * PA];
    __nv_bfloat16 b[TILE * PK > KC * PB ? TILE * PK : KC * PB];
  };


  template <bool A_KF, bool B_KF, class FA, class FB>
  static __device__ __forceinline__ void gemm(float (&acc)[8][4], int kdim,
                                              int r_lo, int r_hi, FA fa,
                                              FB fb, Smem& sm) {
    const int lane = threadIdx.x & 31;
    const int w0 = (threadIdx.x >> 5) * 16;
    const bool live = w0 + 16 > r_lo && w0 < r_hi;
    const int s_lo = max(r_lo, 0) & ~15;    // the live warps' rows
    const int s_hi = min(CMAX, (r_hi + 15) & ~15);
    const auto pa = [&](int i, int kk, const unsigned (&x)[R / 2]) {
      *reinterpret_cast<uint4*>(A_KF ? &sm.a[i * PK + kk]
                                     : &sm.a[kk * PA + i]) =
          make_uint4(x[0], x[1], x[2], x[3]);
    };
    const auto pb = [&](int n, int kk, const unsigned (&x)[R / 2]) {
      *reinterpret_cast<uint4*>(B_KF ? &sm.b[n * PK + kk]
                                     : &sm.b[kk * PB + n]) =
          make_uint4(x[0], x[1], x[2], x[3]);
    };
    Stage<KC, R, A_KF, B_KF, true> stage;
    stage.fetch(0, kdim, s_lo, s_hi, fa, fb);
    for (int k0 = 0; k0 < kdim; k0 += KC) {
      __syncthreads();            // the previous step is consumed
      stage.put(s_lo, s_hi, pa, pb);
      __syncthreads();
      if (k0 + KC < kdim) stage.fetch(k0 + KC, kdim, s_lo, s_hi, fa, fb);
      if (!live) continue;
      const int ksteps = (min(KC, kdim - k0) + 15) / 16;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned af[4];
        if (A_KF)
          hopper::ldmatrix_x4(af, &sm.a[(w0 + (lane & 15)) * PK + ks * 16
                                        + (lane >> 4) * 8]);
        else
          hopper::ldmatrix_x4_trans(
              af, &sm.a[(ks * 16 + (lane >> 4) * 8 + (lane & 7)) * PA + w0
                        + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int nd = 0; nd < TILE / 8; nd += 2) {
          unsigned bf[4];
          if (B_KF)
            hopper::ldmatrix_x4(bf, &sm.b[(nd * 8 + (lane >> 4) * 8
                                           + (lane & 7)) * PK + ks * 16
                                          + ((lane >> 3) & 1) * 8]);
          else
            hopper::ldmatrix_x4_trans(
                bf, &sm.b[(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PB
                          + nd * 8 + (lane >> 4) * 8]);
          hopper::mma_bf16(acc[nd], af, bf[0], bf[1]);
          hopper::mma_bf16(acc[nd + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  template <class F>
  static __device__ __forceinline__ void each(float (&acc)[8][4], F f) {
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(r0 + (e >> 1) * 8, nd * 8 + c0 + (e & 1), acc[nd][e]);
  }

  template <class F>
  static __device__ __forceinline__ void each2(float (&acc)[8][4], F f) {
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        f(r0 + half * 8, nd * 8 + c0, acc[nd][2 * half],
          acc[nd][2 * half + 1]);
  }

  template <class G>
  static __device__ __forceinline__ void row_dot(const float (&acc)[8][4],
                                                 G g, float* out) {
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + half * 8;
      float s = 0.f;
#pragma unroll
      for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s = fmaf(acc[nd][2 * half + e], g(row, nd * 8 + c0 + e), s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);    // the quad's columns
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0) out[row] = s;
    }
  }
};

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// ---------------------------------------------------------------------------
// 1. The tiled route's U pass: U_c = Q^T diag(exp L) dY (dk x dv), in tiles
//    of 128 x 64 on the tile product, at us[b, h, c] (rows dvp apart: dv
//    rounded up to 8, so a tile's rows start on 32 bytes and its pairs of
//    columns are stored 8 bytes at once); the CTA of the first tile writes
//    decay[b, h, c] = exp(L_last).
//    grid (nc, H * dk tiles * dv tiles, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_u_kernel(const T* __restrict__ q, const T* __restrict__ dy,
                  const float* __restrict__ log_a, float* __restrict__ us,
                  float* __restrict__ decay, int t_len, int heads, int dk,
                  int dv, int dvp, int chunk, int nc, int n_dvt, Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float eL[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) typename TileOps<T>::Smem sm;
  const int h = blockIdx.y % heads;
  const int e0 = blockIdx.y / heads % n_dvt * TILE;
  const int d0 = blockIdx.y / heads / n_dvt * UROWS;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, ch.n, Ls, warp_tot);
  if (threadIdx.x < CMAX) eL[threadIdx.x] = expf(Ls[threadIdx.x]);
  __syncthreads();
  const T* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
  const T* dyb = dy + row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  float acc[8][4];
  zero(acc);
  TileOps<T>::template gemm<false, false>(
      acc, ch.n, 0, dk - d0,
      [&](int i, int j) {
        const int d = d0 + i;
        return d < dk ? load_one(qb + j * st.qt + d) * eL[j] : 0.f;
      },
      [&](int j, int ee) {
        const int e = e0 + ee;
        return e < dv ? load_one(dyb + j * rs + e) : 0.f;
      }, sm);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  float* out = us + bhc * dk * dvp;
  TileOps<T>::each2(acc, [&](int i, int ee, float x, float y) {
    const int d = d0 + i, e = e0 + ee;
    float* p = out + static_cast<int64_t>(d) * dvp + e;
    if (d < dk && e + 1 < dv)
      store_pair(p, x, y);
    else if (d < dk && e < dv)
      *p = x;
  });
  if (blockIdx.y / heads == 0 && threadIdx.x == 0)
    decay[bhc] = eL[ch.n - 1];
}

// ---------------------------------------------------------------------------
// 2. The reverse state pass: one thread per (b, h, entry), D from dH_T (or
//    0) over the chunks backwards in f32: D_c, the reverse state entering
//    chunk c from the right, goes to ds[b, h, c] in TD (f32 over U_c in the
//    fused route, the input type in the tiled one, whose products round it
//    to that type anyway; rows dvp apart as U's), and dh0 = D_{-1}.
//    grid (entries / NT, H, B).
// ---------------------------------------------------------------------------

template <typename TD>
__global__ void __launch_bounds__(NT)
scan_bwd_state_pass_kernel(const float* __restrict__ dh_t,
                           const float* us, TD* ds,
                           const float* __restrict__ decay,
                           float* __restrict__ dh0, int heads, int dk, int dv,
                           int dvp, int nc) {
  const int64_t entries = static_cast<int64_t>(dk) * dv;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (idx >= entries) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * heads + blockIdx.y;
  float d = dh_t != nullptr ? dh_t[bh * entries + idx] : 0.f;
  const int64_t step = static_cast<int64_t>(dk) * dvp;     // one chunk
  const int64_t at = bh * nc * step + idx / dv * dvp + idx % dv;
  const float* u = us + at;
  TD* out = ds + at;
  const float* a = decay + bh * nc;
  // the loads of a batch of chunks do not wait on d
  for (int c1 = nc - 1; c1 >= 0; c1 -= PASS_BATCH) {
    float uc[PASS_BATCH], ac[PASS_BATCH];
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i) {
      uc[i] = c1 - i >= 0 ? u[(c1 - i) * step] : 0.f;
      ac[i] = c1 - i >= 0 ? a[c1 - i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i) {
      if (c1 - i >= 0) {
        store_one(out + (c1 - i) * step, d);
        d = fmaf(ac[i], d, uc[i]);
      }
    }
  }
  dh0[bh * entries + idx] = d;
}

// ---------------------------------------------------------------------------
// 3a. The fused chunk pass.  Warp products on 16-row blocks held row-major
//     in shared memory; a 16 x 16 pair tile c is kept in the C fragment
//     layout of mma.sync m16n8k16 (hopper.cuh): c[h] holds rows gq and gq +
//     8, columns 8 h + 2 tq and + 1 (lane = 4 gq + tq), and acc[nd] of an N
//     wide sum rows gq and gq + 8, columns 8 nd + 2 tq and + 1.
//       nt:   c = A B^T, A and B 16 rows of K (a multiple of 16)
//       nn:   acc (16 x N) += c B, B 16 rows of N
//       nn_s: acc (16 x N) += A B, A 16 rows of K, B K rows of N
//     WarpMma (bf16) runs them on mma.sync, c entering nn as bf16 A
//     fragments; WarpFma (f32) as FMAs in the same layouts, nn fetching c's
//     rows from the lanes of the quad.  The tiles arrive by cp.async.
// ---------------------------------------------------------------------------

struct WarpMma {
  using E = __nv_bfloat16;
  static constexpr int PAD = 8;   // row pitches stay multiples of 16 bytes

  static __device__ __forceinline__ void nt(float (&c)[2][4], const E* a,
                                            int pa, const E* b, int pb,
                                            int K) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
    for (int ks = 0; ks < K / 16; ++ks) {
      unsigned af[4], bf[4];
      hopper::ldmatrix_x4(af, a + (lane & 15) * pa + ks * 16
                                  + (lane >> 4) * 8);
      hopper::ldmatrix_x4(bf, b + ((lane >> 4) * 8 + (lane & 7)) * pb
                                  + ks * 16 + ((lane >> 3) & 1) * 8);
      hopper::mma_bf16(c[0], af, bf[0], bf[1]);
      hopper::mma_bf16(c[1], af, bf[2], bf[3]);
    }
  }

  // acc += A (the fragments af, 16 x 16) times 16 rows of B at b
  template <int N>
  static __device__ __forceinline__ void mul_b(float (&acc)[N / 8][4],
                                               const unsigned (&af)[4],
                                               const E* b, int pb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int nd = 0; nd < N / 8; nd += 2) {
      unsigned bf[4];
      hopper::ldmatrix_x4_trans(
          bf, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * pb + nd * 8
                  + (lane >> 4) * 8);
      hopper::mma_bf16(acc[nd], af, bf[0], bf[1]);
      hopper::mma_bf16(acc[nd + 1], af, bf[2], bf[3]);
    }
  }

  template <int N>
  static __device__ __forceinline__ void nn(float (&acc)[N / 8][4],
                                            const float (&c)[2][4],
                                            const E* b, int pb) {
    // the C layout of m16n8 is the A layout of m16n8k16
    const unsigned af[4] = {hopper::pack_bf16x2(c[0][0], c[0][1]),
                            hopper::pack_bf16x2(c[0][2], c[0][3]),
                            hopper::pack_bf16x2(c[1][0], c[1][1]),
                            hopper::pack_bf16x2(c[1][2], c[1][3])};
    mul_b<N>(acc, af, b, pb);
  }

  template <int N, int K>
  static __device__ __forceinline__ void nn_s(float (&acc)[N / 8][4],
                                              const E* a, int pa, const E* b,
                                              int pb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      unsigned af[4];
      hopper::ldmatrix_x4(af, a + (lane & 15) * pa + ks * 16
                                  + (lane >> 4) * 8);
      mul_b<N>(acc, af, b + ks * 16 * pb, pb);
    }
  }

  // acc (16 x N) += A^T B: A K rows of 16 columns at a (the output rows
  // run along A's rows in memory: ldmatrix.trans), B K rows of N
  template <int N, int K>
  static __device__ __forceinline__ void tn(float (&acc)[N / 8][4],
                                            const E* a, int pa, const E* b,
                                            int pb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      unsigned af[4];
      hopper::ldmatrix_x4_trans(
          af, a + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * pa
                  + ((lane >> 3) & 1) * 8);
      mul_b<N>(acc, af, b + ks * 16 * pb, pb);
    }
  }

  static __device__ __forceinline__ float get(E x) {
    return __bfloat162float(x);
  }
};

struct WarpFma {
  using E = float;
  static constexpr int PAD = 4;   // 16-byte rows; the 8 (or 4) rows a load
                                  // reads across the warp hit distinct banks

  static __device__ __forceinline__ void nt(float (&c)[2][4], const E* a,
                                            int pa, const E* b, int pb,
                                            int K) {
    const int lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const float* a0 = a + gq * pa;
    const float* a1 = a0 + 8 * pa;
    const float* b0 = b + 2 * tq * pb;
    const float* b1 = b0 + pb;
    const float* b2 = b0 + 8 * pb;
    const float* b3 = b2 + pb;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x0 = a0[k], x1 = a1[k];
      const float y0 = b0[k], y1 = b1[k], y2 = b2[k], y3 = b3[k];
      c[0][0] = fmaf(x0, y0, c[0][0]);
      c[0][1] = fmaf(x0, y1, c[0][1]);
      c[0][2] = fmaf(x1, y0, c[0][2]);
      c[0][3] = fmaf(x1, y1, c[0][3]);
      c[1][0] = fmaf(x0, y2, c[1][0]);
      c[1][1] = fmaf(x0, y3, c[1][1]);
      c[1][2] = fmaf(x1, y2, c[1][2]);
      c[1][3] = fmaf(x1, y3, c[1][3]);
    }
  }

  // acc += A B over k 0 .. K-1, x0[k] = A(gq, k) and x1[k] = A(gq + 8, k)
  template <int N, int K, class XA>
  static __device__ __forceinline__ void mul_b(float (&acc)[N / 8][4],
                                               XA x, const E* b, int pb) {
    const int tq = threadIdx.x & 3;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float x0 = x(k, 0), x1 = x(k, 1);
      const float* br = b + k * pb + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < N / 8; ++nd) {
        const float y0 = br[nd * 8], y1 = br[nd * 8 + 1];
        acc[nd][0] = fmaf(x0, y0, acc[nd][0]);
        acc[nd][1] = fmaf(x0, y1, acc[nd][1]);
        acc[nd][2] = fmaf(x1, y0, acc[nd][2]);
        acc[nd][3] = fmaf(x1, y1, acc[nd][3]);
      }
    }
  }

  template <int N>
  static __device__ __forceinline__ void nn(float (&acc)[N / 8][4],
                                            const float (&c)[2][4],
                                            const E* b, int pb) {
    // rows gq and gq + 8 of c over its 16 columns, from the quad's lanes
    const int base = threadIdx.x & 28;
    float r0[16], r1[16];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int src = base + s;
        r0[h * 8 + 2 * s] = __shfl_sync(0xffffffffu, c[h][0], src);
        r0[h * 8 + 2 * s + 1] = __shfl_sync(0xffffffffu, c[h][1], src);
        r1[h * 8 + 2 * s] = __shfl_sync(0xffffffffu, c[h][2], src);
        r1[h * 8 + 2 * s + 1] = __shfl_sync(0xffffffffu, c[h][3], src);
      }
    mul_b<N, 16>(acc, [&](int k, int half) { return half ? r1[k] : r0[k]; },
                 b, pb);
  }

  template <int N, int K>
  static __device__ __forceinline__ void nn_s(float (&acc)[N / 8][4],
                                              const E* a, int pa, const E* b,
                                              int pb) {
    const float* a0 = a + (threadIdx.x & 31) / 4 * pa;
    mul_b<N, K>(acc, [&](int k, int half) { return a0[half * 8 * pa + k]; },
                b, pb);
  }

  template <int N, int K>
  static __device__ __forceinline__ void tn(float (&acc)[N / 8][4],
                                            const E* a, int pa, const E* b,
                                            int pb) {
    const float* a0 = a + (threadIdx.x & 31) / 4;
    mul_b<N, K>(acc, [&](int k, int half) { return a0[k * pa + half * 8]; },
                b, pb);
  }

  static __device__ __forceinline__ float get(E x) { return x; }
};

// f, the decay of the pair tile of rows row0 .. row0 + 15 and columns
// col0 .. col0 + 15 in the C layout, masked before the exponential:
// exp(L_row - L_col) where col <= row (LOWER: the query rows' W),
// exp(L_col - L_row) where col >= row (the key rows' W^T and P^T, which
// share it), 0 elsewhere.
template <bool LOWER>
__device__ __forceinline__ void tile_decay(float (&f)[2][4], const float* Ls,
                                           int row0, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (lane >> 2) + (e >> 1) * 8;
      const int col = col0 + h * 8 + 2 * (lane & 3) + (e & 1);
      const bool keep = LOWER ? col <= row : col >= row;
      f[h][e] = keep ? expf(LOWER ? Ls[row] - Ls[col] : Ls[col] - Ls[row])
                     : 0.f;
    }
}

__device__ __forceinline__ void times(float (&c)[2][4],
                                      const float (&f)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[h][e] *= f[h][e];
}

template <int NB>
__device__ __forceinline__ void scale_rows(float (&acc)[NB][4], float f0,
                                           float f1) {
#pragma unroll
  for (int nd = 0; nd < NB; ++nd) {
    acc[nd][0] *= f0;
    acc[nd][1] *= f0;
    acc[nd][2] *= f1;
    acc[nd][3] *= f1;
  }
}

template <class Ops, int DKP>
struct FusedLayout {
  using E = typename Ops::E;
  static constexpr int QP = DKP + Ops::PAD;        // q and k rows
  static constexpr int VP = FUSED_DV + Ops::PAD;   // v, dy and state rows
  static constexpr int Q_ELEMS = CMAX * QP;
  static constexpr int V_ELEMS = CMAX * VP;
  static constexpr int S_ELEMS = DKP * VP;
  static constexpr int SMEM =
      (2 * Q_ELEMS + 2 * V_ELEMS + 2 * S_ELEMS) * static_cast<int>(sizeof(E));
};

// rows 0 .. CMAX-1 of W columns into s (pitch sp, 16-byte rows) by
// cp.async, 16 bytes a copy: the first `width` columns of the first n rows
// from g (row stride gs, 16-byte aligned rows, width a multiple of 16
// bytes), zeros elsewhere
template <typename E, int W, int THREADS>
__device__ __forceinline__ void stage_rows(E* s, int sp, const E* g,
                                           int64_t gs, int n, int width) {
  constexpr int VEC = 16 / sizeof(E);
  constexpr int COPIES = CMAX * W / VEC;
#pragma unroll
  for (int it = 0; it < (COPIES + THREADS - 1) / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    if (idx < COPIES) {
      const int r = idx / (W / VEC), col = idx % (W / VEC) * VEC;
      const bool ok = r < n && col < width;
      cp_async16(s + r * sp + col, ok ? g + r * gs + col : g, ok);
    }
  }
}

// the f32 (dk x dv) state at g into DKP x FUSED_DV of s (pitch sp) in E,
// zeros past dk and dv (dv a multiple of 4): f32 by cp.async, bf16 through
// registers, rounded
template <typename E, int DKP, int THREADS>
__device__ __forceinline__ void stage_state(E* s, int sp,
                                            const float* __restrict__ g,
                                            int dk, int dv) {
  constexpr int PER_ROW = FUSED_DV / 4;
  constexpr int COPIES = DKP * PER_ROW;
  constexpr int IT = (COPIES + THREADS - 1) / THREADS;
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / PER_ROW, col = idx % PER_ROW * 4;
      const bool ok = r < dk && col < dv;
      if (idx < COPIES)
        cp_async16(s + r * sp + col,
                   ok ? g + static_cast<int64_t>(r) * dv + col : g, ok);
    }
  } else {
    float4 f[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / PER_ROW, col = idx % PER_ROW * 4;
      f[it] = idx < COPIES && r < dk && col < dv
                  ? *reinterpret_cast<const float4*>(
                        g + static_cast<int64_t>(r) * dv + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / PER_ROW, col = idx % PER_ROW * 4;
      if (idx < COPIES)
        *reinterpret_cast<uint2*>(s + r * sp + col) =
            make_uint2(hopper::pack_bf16x2(f[it].x, f[it].y),
                       hopper::pack_bf16x2(f[it].z, f[it].w));
    }
  }
}

// rows r0 and r0 + 8 of acc (columns 8 nd + 2 tq, + 1) into out (row
// stride rs), the rows below n and the columns below width
template <int N, typename E>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 8][4],
                                           E* __restrict__ out, int64_t rs,
                                           int r0, int n, int width) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
#pragma unroll
    for (int nd = 0; nd < N / 8; ++nd) {
      const int col = nd * 8 + c0;
      if (row < n && col < width)
        store_pair(out + row * rs + col, acc[nd][2 * half],
                   acc[nd][2 * half + 1]);
    }
  }
}

// the dot of rows r0 and r0 + 8 of acc with the same rows and columns of
// x (pitch xp), summed over the quad in a fixed order
template <class Ops, int N>
__device__ __forceinline__ void row_dots(const float (&acc)[N / 8][4],
                                         const typename Ops::E* x, int xp,
                                         int r0, float (&dot)[2]) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    float s = 0.f;
#pragma unroll
    for (int nd = 0; nd < N / 8; ++nd) {
      const int col = nd * 8 + c0;
      s = fmaf(acc[nd][2 * half], Ops::get(x[row * xp + col]), s);
      s = fmaf(acc[nd][2 * half + 1], Ops::get(x[row * xp + col + 1]), s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dot[half] = s;
  }
}

// 1'. The U pass of the fused route (dk, dv <= 64): U_c = Q^T diag(exp L)
//     dY of one (b, h, chunk) per CTA, from q exp(L) rounded to E and dy in
//     shared memory; warp tasks of 16 rows of dk x 16 columns of dv, the
//     chunk's rows the reduction (Q^T read with ldmatrix.trans), and
//     decay[b, h, c] = exp(L_last).  grid (nc, H, B), NT threads, dynamic
//     shared memory ULayout::SMEM.

template <class Ops, int DKP>
struct ULayout {
  using E = typename Ops::E;
  static constexpr int QP = DKP + Ops::PAD;
  static constexpr int VP = FUSED_DV + Ops::PAD;
  static constexpr int SMEM =
      CMAX * (QP + VP) * static_cast<int>(sizeof(E));
};

template <class Ops, int DKP>
__global__ void __launch_bounds__(NT)
scan_bwd_u_chunk_kernel(const typename Ops::E* __restrict__ q,
                        const typename Ops::E* __restrict__ dy,
                        const float* __restrict__ log_a,
                        float* __restrict__ us, float* __restrict__ decay,
                        int t_len, int heads, int dk, int dv, int chunk,
                        int nc, Strides st) {
  using E = typename Ops::E;
  using L = ULayout<Ops, DKP>;
  constexpr int QP = L::QP, VP = L::VP, VEC = 16 / sizeof(E);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);         // q exp(L), rounded
  E* Ys = Qs + CMAX * QP;
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];

  const int h = blockIdx.y;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  const int n = ch.n;
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  stage_rows<E, FUSED_DV, NT>(Ys, VP, dy + row_off(ch.b, ch.c0, h, t_len,
                                                   heads, dv), rs, n, dv);
  cp_async_commit();
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, n, Ls, warp_tot);
  const E* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
  constexpr int RUNS = CMAX * DKP / VEC;
#pragma unroll
  for (int it = 0; it < (RUNS + NT - 1) / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    if (idx < RUNS) {
      const int r = idx / (DKP / VEC), col = idx % (DKP / VEC) * VEC;
      float x[VEC];
      if (r < n && col < dk) {
        to_float(load16(qb + r * st.qt + col), x);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[j] = 0.f;
      }
      const float e = expf(Ls[r]);
      E* p = Qs + r * QP + col;
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(
            hopper::pack_bf16x2(x[0] * e, x[1] * e),
            hopper::pack_bf16x2(x[2] * e, x[3] * e),
            hopper::pack_bf16x2(x[4] * e, x[5] * e),
            hopper::pack_bf16x2(x[6] * e, x[7] * e));
      } else {
        *reinterpret_cast<float4*>(p) =
            make_float4(x[0] * e, x[1] * e, x[2] * e, x[3] * e);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  float* out = us + bhc * dk * dv;
  for (int task = threadIdx.x >> 5; task < DKP / 16 * (FUSED_DV / 16);
       task += NWARPS) {
    const int d0 = task / (FUSED_DV / 16) * 16;
    const int e0 = task % (FUSED_DV / 16) * 16;
    float acc[2][4];
#pragma unroll
    for (int nd = 0; nd < 2; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    Ops::template tn<16, CMAX>(acc, Qs + d0, QP, Ys + e0, VP);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + (lane >> 2) + half * 8;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) {
        const int e = e0 + nd * 8 + 2 * (lane & 3);
        if (d < dk && e < dv)
          store_pair(out + static_cast<int64_t>(d) * dv + e,
                     acc[nd][2 * half], acc[nd][2 * half + 1]);
      }
    }
  }
  if (threadIdx.x == 0) decay[bhc] = expf(Ls[n - 1]);
}

// grid (nc, H, B), CHUNK_NT threads, dynamic shared memory
// FusedLayout::SMEM.  Warps 0-7: block w as the query rows (dq) and as the
// key rows of W^T (dk), w + 1 and 8 - w steps, and r; warps 8-11: blocks j
// and 7 - j as the key rows of P^T (dv), 8 - j and j + 1 steps.
constexpr int CHUNK_NT = NT + NT / 2;

template <class Ops, int DKP>
__global__ void __launch_bounds__(CHUNK_NT,
                                  sizeof(typename Ops::E) == 2 && DKP <= 16
                                      ? 2 : 1)
scan_bwd_chunk_kernel(const typename Ops::E* __restrict__ q,
                      const typename Ops::E* __restrict__ k,
                      const typename Ops::E* __restrict__ v,
                      const typename Ops::E* __restrict__ dy,
                      const float* __restrict__ log_a,
                      const float* __restrict__ states,
                      const float* __restrict__ ds,
                      typename Ops::E* __restrict__ dq,
                      typename Ops::E* __restrict__ dk_out,
                      typename Ops::E* __restrict__ dv_out,
                      float* __restrict__ r_out, int t_len, int heads,
                      int dk, int dv, int chunk, int nc, Strides st) {
  using E = typename Ops::E;
  using L = FusedLayout<Ops, DKP>;
  constexpr int QP = L::QP, VP = L::VP, DV = FUSED_DV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);
  E* Ks = Qs + L::Q_ELEMS;
  E* Vs = Ks + L::Q_ELEMS;
  E* Ys = Vs + L::V_ELEMS;
  E* Ss = Ys + L::V_ELEMS;         // S_c, the forward's state entering
  E* Ds = Ss + L::S_ELEMS;         // D_c, the reverse state entering
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];

  const int h = blockIdx.y;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  const int n = ch.n;
  const E* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
  const E* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
  const int64_t rs = static_cast<int64_t>(heads) * dv;    // one token
  const int64_t voff = row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  stage_rows<E, DKP, CHUNK_NT>(Qs, QP, qb, st.qt, n, dk);
  stage_rows<E, DKP, CHUNK_NT>(Ks, QP, kb, st.kt, n, dk);
  stage_rows<E, DV, CHUNK_NT>(Vs, VP, v + voff, rs, n, dv);
  stage_rows<E, DV, CHUNK_NT>(Ys, VP, dy + voff, rs, n, dv);
  stage_state<E, DKP, CHUNK_NT>(Ss, VP, states + bhc * dk * dv, dk, dv);
  stage_state<E, DKP, CHUNK_NT>(Ds, VP, ds + bhc * dk * dv, dk, dv);
  cp_async_commit();
  cp_async_wait<0>();
  // (its barriers also publish the tiles above)
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, n, Ls, warp_tot);

  const int warp = threadIdx.x >> 5;
  const int quad = (threadIdx.x & 31) >> 2;
  const float l_last = Ls[n - 1];
  if (warp >= NWARPS) {
    // the key rows of P^T: dv = diag(exp(L_last - L)) K D + P^T dY
    const int j = warp - NWARPS;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int blk = pass ? NWARPS - 1 - j : j;
      const int w0 = blk * 16;
      if (w0 >= n) continue;
      const int r0 = w0 + quad, r1 = r0 + 8;
      float av[DV / 8][4];
#pragma unroll
      for (int nd = 0; nd < DV / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) av[nd][e] = 0.f;
      Ops::template nn_s<DV, DKP>(av, Ks + w0 * QP, QP, Ds, VP);
      scale_rows(av, expf(l_last - Ls[r0]), expf(l_last - Ls[r1]));
      for (int qs = blk; qs < NWARPS && qs * 16 < n; ++qs) {
        float c[2][4], f[2][4];
        Ops::nt(c, Ks + w0 * QP, QP, Qs + qs * 16 * QP, QP, DKP);
        tile_decay<false>(f, Ls, w0, qs * 16);
        times(c, f);
        Ops::template nn<DV>(av, c, Ys + qs * 16 * VP, VP);
      }
      store_rows<DV>(av, dv_out + voff, rs, r0, n, dv);
    }
    return;
  }

  const int w0 = warp * 16;
  if (w0 >= n) return;                          // no barrier follows
  const int r0 = w0 + quad, r1 = r0 + 8;
  const int64_t qk_rs = static_cast<int64_t>(heads) * dk;  // dq, dk rows
  const int64_t qkoff = row_off(ch.b, ch.c0, h, t_len, heads, dk);
  float rq[2], rk[2];

  // as the query rows: dq = diag(exp L) dY S^T + W K, keys 0 .. w0 + 15
  {
    float aq[DKP / 8][4];
#pragma unroll
    for (int dp = 0; dp < DKP / 16; ++dp) {
      float c[2][4];
      Ops::nt(c, Ys + w0 * VP, VP, Ss + dp * 16 * VP, VP, DV);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        aq[2 * dp][e] = c[0][e];
        aq[2 * dp + 1][e] = c[1][e];
      }
    }
    scale_rows(aq, expf(Ls[r0]), expf(Ls[r1]));
    for (int ks = 0; ks <= warp; ++ks) {
      float c[2][4], f[2][4];
      Ops::nt(c, Ys + w0 * VP, VP, Vs + ks * 16 * VP, VP, DV);
      tile_decay<true>(f, Ls, w0, ks * 16);
      times(c, f);
      Ops::template nn<DKP>(aq, c, Ks + ks * 16 * QP, QP);
    }
    store_rows<DKP>(aq, dq + qkoff, qk_rs, r0, n, dk);
    row_dots<Ops, DKP>(aq, Qs, QP, r0, rq);
  }

  // as the key rows of W^T: dk = diag(exp(L_last - L)) V D^T + W^T Q,
  // queries w0 .. n - 1
  {
    float ak[DKP / 8][4];
#pragma unroll
    for (int dp = 0; dp < DKP / 16; ++dp) {
      float c[2][4];
      Ops::nt(c, Vs + w0 * VP, VP, Ds + dp * 16 * VP, VP, DV);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ak[2 * dp][e] = c[0][e];
        ak[2 * dp + 1][e] = c[1][e];
      }
    }
    scale_rows(ak, expf(l_last - Ls[r0]), expf(l_last - Ls[r1]));
    for (int qs = warp; qs < NWARPS && qs * 16 < n; ++qs) {
      float c[2][4], f[2][4];
      Ops::nt(c, Vs + w0 * VP, VP, Ys + qs * 16 * VP, VP, DV);
      tile_decay<false>(f, Ls, w0, qs * 16);
      times(c, f);
      Ops::template nn<DKP>(ak, c, Qs + qs * 16 * QP, QP);
    }
    store_rows<DKP>(ak, dk_out + qkoff, qk_rs, r0, n, dk);
    row_dots<Ops, DKP>(ak, Ks, QP, r0, rk);
  }

  // r_t = q_t . dq_t - k_t . dk_t from the f32 sums
  if ((threadIdx.x & 3) == 0) {
    float* rp = r_out + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                + h;
    if (r0 < n) rp[static_cast<int64_t>(r0) * heads] = rq[0] - rk[0];
    if (r1 < n) rp[static_cast<int64_t>(r1) * heads] = rq[1] - rk[1];
  }
}

// ---------------------------------------------------------------------------
// 3b. The tiled pass (dk or dv above what the fused pass holds, or rows
//     that do not load 16 bytes at a time).
//     scan_bwd_pair_kernel: P_ij = (q_i . k_j) exp(L_i - L_j) and W_ij =
//     (dy_i . v_j) exp(L_i - L_j) for j <= i (0 elsewhere), in T at pw[b, h,
//     c, which] (chunk x chunk).  grid (nc, H * 2 * column tiles, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_pair_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dy,
                     const float* __restrict__ log_a, T* __restrict__ pw,
                     int t_len, int heads, int dk, int dv, int chunk, int nc,
                     Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) typename TileOps<T>::Smem sm;
  const int h = blockIdx.y % heads;
  const int which = blockIdx.y / heads % 2;
  const int j0 = blockIdx.y / heads / 2 * TILE;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, ch.n, Ls, warp_tot);
  float acc[8][4];
  zero(acc);
  const int n = ch.n;
  // rows i < j0 see no key of this tile under the mask
  if (which == 0) {
    const T* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
    const T* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
    TileOps<T>::template gemm<true, true>(
        acc, dk, j0, n,
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
    TileOps<T>::template gemm<true, true>(
        acc, dv, j0, n,
        [&](int i, int e) {
          return i < n ? load_one(dyb + i * rs + e) : 0.f;
        },
        [&](int e, int jj) {
          const int j = j0 + jj;
          return j < n ? load_one(vb + j * rs + e) : 0.f;
        }, sm);
  }
  T* out = pw + ((((static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c)
                  * 2 + which) * chunk) * chunk;
  TileOps<T>::each(acc, [&](int i, int jj, float x) {
    const int j = j0 + jj;
    if (i < chunk && j < chunk)
      store_one(out + static_cast<int64_t>(i) * chunk + j,
                j <= i && i < n ? x * expf(Ls[i] - Ls[j]) : 0.f);
  });
}

// ---------------------------------------------------------------------------
//     scan_bwd_dqdk_kernel: dq = W K + diag(exp L) dY S^T (which 0) or dk =
//     W^T Q + diag(exp(L_last - L)) V D_c^T (which 1) of a chunk, 64 columns
//     of dk per CTA, in the input type, and the CTA's part of r from the f32
//     sums, q . dq (which 0) or -k . dk (which 1) over its columns, at
//     parts[b, t, h, 2 tile + which].  grid (nc, H * dk tiles * 2, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_dqdk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dy,
                     const float* __restrict__ log_a,
                     const float* __restrict__ states,
                     const T* __restrict__ ds, const T* __restrict__ pw,
                     T* __restrict__ dq, T* __restrict__ dk_out,
                     float* __restrict__ parts, int t_len, int heads, int dk,
                     int dv, int dvp, int chunk, int nc, int n_dkt,
                     Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ float rsum[CMAX];
  __shared__ __align__(16) typename TileOps<T>::Smem sm;
  const int h = blockIdx.y % heads;
  const int tile = blockIdx.y / heads % n_dkt;
  const int which = blockIdx.y / heads / n_dkt;
  const int d0 = tile * TILE;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  const int n = ch.n;
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, n, Ls, warp_tot);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  const T* w = pw + (bhc * 2 + 1) * chunk * chunk;
  const T* qb = q + ch.b * st.qb + h * st.qh + ch.c0 * st.qt;
  const T* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
  const int64_t voff = row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  const float l_last = Ls[n - 1];
  // the rows of this CTA's operand (q for dq, k for dk) over its columns
  const auto own = [&](int i, int dd) {
    const int d = d0 + dd;
    return i < n && d < dk
               ? load_one(which == 0 ? qb + i * st.qt + d : kb + i * st.kt + d)
               : 0.f;
  };
  float acc[8][4];
  zero(acc);
  if (which == 0) {             // dY S^T, then + W K
    const float* s = states + bhc * dk * dv;
    TileOps<T>::template gemm<true, true>(
        acc, dv, 0, n,
        [&](int i, int e) {
          return i < n ? load_one(dy + voff + i * rs + e) : 0.f;
        },
        [&](int e, int dd) {
          return d0 + dd < dk ? s[static_cast<int64_t>(d0 + dd) * dv + e]
                              : 0.f;
        }, sm);
    TileOps<T>::each(acc, [&](int i, int, float& x) { x *= expf(Ls[i]); });
    TileOps<T>::template gemm<true, false>(
        acc, n, 0, n,
        [&](int i, int j) {
          return i < n ? load_one(w + static_cast<int64_t>(i) * chunk + j)
                       : 0.f;
        },
        [&](int j, int dd) {
          const int d = d0 + dd;
          return j < n && d < dk ? load_one(kb + j * st.kt + d) : 0.f;
        }, sm);
  } else {                      // V D^T, then + W^T Q
    const T* dst = ds + bhc * dk * dvp;
    TileOps<T>::template gemm<true, true>(
        acc, dv, 0, n,
        [&](int i, int e) {
          return i < n ? load_one(v + voff + i * rs + e) : 0.f;
        },
        [&](int e, int dd) {
          return d0 + dd < dk
                     ? load_one(dst + static_cast<int64_t>(d0 + dd) * dvp + e)
                     : 0.f;
        }, sm);
    TileOps<T>::each(acc, [&](int i, int, float& x) {
      x *= expf(l_last - Ls[i]);
    });
    TileOps<T>::template gemm<false, false>(
        acc, n, 0, n,
        [&](int j, int i) {
          return j < n ? load_one(w + static_cast<int64_t>(i) * chunk + j)
                       : 0.f;
        },
        [&](int i, int dd) {
          const int d = d0 + dd;
          return i < n && d < dk ? load_one(qb + i * st.qt + d) : 0.f;
        }, sm);
  }
  T* out = (which == 0 ? dq : dk_out)
           + row_off(ch.b, ch.c0, h, t_len, heads, dk);
  const int64_t qk_rs = static_cast<int64_t>(heads) * dk;
  TileOps<T>::each(acc, [&](int i, int dd, float x) {
    const int d = d0 + dd;
    if (i < n && d < dk) store_one(out + i * qk_rs + d, x);
  });
  TileOps<T>::row_dot(acc, own, rsum);
  __syncthreads();
  const int i = threadIdx.x;
  if (i < n)
    parts[((static_cast<int64_t>(ch.b) * t_len + ch.c0 + i) * heads + h)
          * 2 * n_dkt + 2 * tile + which] = which == 0 ? rsum[i] : -rsum[i];
}

// ---------------------------------------------------------------------------
//     scan_bwd_dv_kernel: dv = P^T dY + diag(exp(L_last - L)) K D_c of a
//     chunk, 64 columns of dv per CTA, in the input type.
//     grid (nc, H * dv tiles, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
scan_bwd_dv_kernel(const T* __restrict__ k, const T* __restrict__ dy,
                   const float* __restrict__ log_a,
                   const T* __restrict__ ds, const T* __restrict__ pw,
                   T* __restrict__ dv_out, int t_len, int heads, int dk,
                   int dv, int dvp, int chunk, int nc, int n_dvt,
                   Strides st) {
  __shared__ float Ls[CMAX];
  __shared__ float warp_tot[CMAX / 32];
  __shared__ __align__(16) typename TileOps<T>::Smem sm;
  const int h = blockIdx.y % heads;
  const int e0 = blockIdx.y / heads % n_dvt * TILE;
  const Chunk ch = chunk_of(blockIdx.x, h, blockIdx.z, t_len, chunk);
  const int n = ch.n;
  chunk_cumsum(log_a + (static_cast<int64_t>(ch.b) * t_len + ch.c0) * heads
                   + h, heads, n, Ls, warp_tot);
  const int64_t bhc = (static_cast<int64_t>(ch.b) * heads + h) * nc + ch.c;
  const T* s = ds + bhc * dk * dvp;               // D_c
  const T* p = pw + bhc * 2 * chunk * chunk;      // P
  const T* kb = k + ch.b * st.kb + h * st.kh + ch.c0 * st.kt;
  const T* dyb = dy + row_off(ch.b, ch.c0, h, t_len, heads, dv);
  const int64_t rs = static_cast<int64_t>(heads) * dv;
  float acc[8][4];
  zero(acc);
  TileOps<T>::template gemm<true, false>(
      acc, dk, 0, n,
      [&](int i, int d) {
        return i < n ? load_one(kb + i * st.kt + d) : 0.f;
      },
      [&](int d, int ee) {
        const int e = e0 + ee;
        return e < dv ? load_one(s + static_cast<int64_t>(d) * dvp + e)
                      : 0.f;
      }, sm);
  const float l_last = Ls[n - 1];
  TileOps<T>::each(acc, [&](int i, int, float& x) {
    x *= expf(l_last - Ls[i]);
  });
  TileOps<T>::template gemm<false, false>(
      acc, n, 0, n,
      [&](int i, int j) {
        return i < n ? load_one(p + static_cast<int64_t>(j) * chunk + i)
                     : 0.f;
      },
      [&](int j, int ee) {
        const int e = e0 + ee;
        return e < dv ? load_one(dyb + j * rs + e) : 0.f;
      }, sm);
  T* out = dv_out + row_off(ch.b, ch.c0, h, t_len, heads, dv);
  TileOps<T>::each(acc, [&](int i, int ee, float x) {
    const int e = e0 + ee;
    if (i < n && e < dv) store_one(out + i * rs + e, x);
  });
}

// ---------------------------------------------------------------------------
// 4. dla_t = sum_{s >= t} r_s (+ <dH_T, H_T>), r_s the sum of row s's
//    n_parts parts in order, one CTA per (b, h): each thread sums a
//    segment of t, thread 0 carries the segments' totals from the end,
//    each thread writes its segment's suffix sums.  grid (H, B).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
scan_bwd_dla_kernel(const float* __restrict__ parts, int n_parts,
                    float* __restrict__ dla, const float* __restrict__ dh_t,
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
  const int64_t row0 = static_cast<int64_t>(b) * t_len * heads + h;
  const auto r_at = [&](int t) {
    const float* p = parts + (row0 + static_cast<int64_t>(t) * heads)
                             * n_parts;
    float s = 0.f;
    for (int i = 0; i < n_parts; ++i) s += p[i];
    return s;
  };
  const int seg = (t_len + NT - 1) / NT;
  const int t0 = min(tid * seg, t_len), t1 = min(t0 + seg, t_len);
  float s = 0.f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) s += r_at(t);
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
#pragma unroll 8
  for (int t = t1 - 1; t >= t0; --t) {
    run += r_at(t);
    dla[row0 + static_cast<int64_t>(t) * heads] = run;
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

template <class Ops, int DKP>
cudaError_t launch_chunk(const void* q, const void* k, const void* v,
                         const void* dy, const float* la, const float* states,
                         const float* ds, void* dq, void* dk_out, void* dv_out,
                         float* r, int batch, int t_len, int heads, int dk,
                         int dv, int chunk, int nc, const Strides& st,
                         cudaStream_t stream) {
  using E = typename Ops::E;
  constexpr int SMEM = FusedLayout<Ops, DKP>::SMEM;
  static bool smem_set = false;   // the attribute, once per instantiation
  const cudaError_t err =
      allow_smem(scan_bwd_chunk_kernel<Ops, DKP>, SMEM, smem_set);
  if (err != cudaSuccess) return err;
  scan_bwd_chunk_kernel<Ops, DKP><<<dim3(nc, heads, batch), CHUNK_NT, SMEM,
                                    stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dy), la, states, ds,
      static_cast<E*>(dq), static_cast<E*>(dk_out), static_cast<E*>(dv_out),
      r, t_len, heads, dk, dv, chunk, nc, st);
  return cudaGetLastError();
}

template <class Ops, int DKP>
cudaError_t launch_u_chunk(const void* q, const void* dy, const float* la,
                           float* us, float* decay, int batch, int t_len,
                           int heads, int dk, int dv, int chunk, int nc,
                           const Strides& st, cudaStream_t stream) {
  using E = typename Ops::E;
  constexpr int SMEM = ULayout<Ops, DKP>::SMEM;
  static bool smem_set = false;
  const cudaError_t err =
      allow_smem(scan_bwd_u_chunk_kernel<Ops, DKP>, SMEM, smem_set);
  if (err != cudaSuccess) return err;
  scan_bwd_u_chunk_kernel<Ops, DKP><<<dim3(nc, heads, batch), NT, SMEM,
                                      stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(dy), la, us, decay,
      t_len, heads, dk, dv, chunk, nc, st);
  return cudaGetLastError();
}

template <class Ops>
cudaError_t launch_u_fused(int dk, const void* q, const void* dy,
                           const float* la, float* us, float* decay,
                           int batch, int t_len, int heads, int dv, int chunk,
                           int nc, const Strides& st, cudaStream_t stream) {
#define SCAN_BWD_U(DKP_)                                                    \
  launch_u_chunk<Ops, DKP_>(q, dy, la, us, decay, batch, t_len, heads, dk, \
                            dv, chunk, nc, st, stream)
  if (dk <= 16) return SCAN_BWD_U(16);
  if (dk <= 32) return SCAN_BWD_U(32);
  return SCAN_BWD_U(64);
#undef SCAN_BWD_U
}

template <class Ops>
cudaError_t launch_fused(int dk, const void* q, const void* k, const void* v,
                         const void* dy, const float* la, const float* states,
                         const float* ds, void* dq, void* dk_out, void* dv_out,
                         float* r, int batch, int t_len, int heads, int dv,
                         int chunk, int nc, const Strides& st,
                         cudaStream_t stream) {
#define SCAN_BWD_CHUNK(DKP_)                                                 \
  launch_chunk<Ops, DKP_>(q, k, v, dy, la, states, ds, dq, dk_out, dv_out, \
                          r, batch, t_len, heads, dk, dv, chunk, nc, st,   \
                          stream)
  if (dk <= 16) return SCAN_BWD_CHUNK(16);
  if (dk <= 32) return SCAN_BWD_CHUNK(32);
  return SCAN_BWD_CHUNK(64);
#undef SCAN_BWD_CHUNK
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v, const float* la,
               const void* dy, const float* states, const float* dh_t,
               const float* h_t, void* dq, void* dk_out, void* dv_out,
               float* dla, float* dh0, float* us, void* ds, float* decay,
               float* parts, void* pw, int batch, int t_len, int heads,
               int dk, int dv, int chunk, bool fused, const Strides& st,
               cudaStream_t stream) {
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
  using Ops = typename std::conditional<sizeof(T) == 2, WarpMma,
                                        WarpFma>::type;
  cudaError_t err;
  int n_parts = 1;
  if (fused) {
    err = launch_u_fused<Ops>(dk, q, dy, la, us, decay, batch, t_len, heads,
                              dv, chunk, nc, st, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t entries = static_cast<int64_t>(dk) * dv;
    scan_bwd_state_pass_kernel<float><<<dim3(static_cast<unsigned>(
                                                 (entries + NT - 1) / NT),
                                             heads, batch),
                                        NT, 0, stream>>>(dh_t, us, us, decay,
                                                         dh0, heads, dk, dv,
                                                         dv, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_fused<Ops>(dk, q, k, v, dy, la, states, us, dq, dk_out,
                            dv_out, parts, batch, t_len, heads, dv, chunk, nc,
                            st, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const int dvp = (dv + 7) / 8 * 8;        // the rows of us and ds
    scan_bwd_u_kernel<T><<<dim3(nc, ys[1], batch), NT, 0, stream>>>(
        qt, dyt, la, us, decay, t_len, heads, dk, dv, dvp, chunk, nc, n_dvt,
        st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* dst = static_cast<T*>(ds);
    const int64_t entries = static_cast<int64_t>(dk) * dv;
    scan_bwd_state_pass_kernel<T><<<dim3(static_cast<unsigned>(
                                             (entries + NT - 1) / NT),
                                         heads, batch),
                                    NT, 0, stream>>>(dh_t, us, dst, decay,
                                                     dh0, heads, dk, dv, dvp,
                                                     nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* pwt = static_cast<T*>(pw);
    scan_bwd_pair_kernel<T><<<dim3(nc, ys[0], batch), NT, 0, stream>>>(
        qt, kt, vt, dyt, la, pwt, t_len, heads, dk, dv, chunk, nc, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_bwd_dqdk_kernel<T><<<dim3(nc, ys[2], batch), NT, 0, stream>>>(
        qt, kt, vt, dyt, la, states, dst, pwt, static_cast<T*>(dq),
        static_cast<T*>(dk_out), parts, t_len, heads, dk, dv, dvp, chunk, nc,
        n_dkt, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_bwd_dv_kernel<T><<<dim3(nc, ys[3], batch), NT, 0, stream>>>(
        kt, dyt, la, dst, pwt, static_cast<T*>(dv_out), t_len, heads, dk, dv,
        dvp, chunk, nc, n_dvt, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    n_parts = 2 * n_dkt;
  }
  scan_bwd_dla_kernel<<<dim3(heads, batch), NT, 0, stream>>>(
      parts, n_parts, dla, dh_t, h_t, t_len, heads, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launches of one dtype (launch_all).  The build compiles this file
// as two parts at once (kernels/build.py PARTS, BUILD_PART 0 and 1: f32
// with the entry point, then bf16), each half of the instantiations, and
// links them into the one library; without BUILD_PART it is whole.
#define SCAN_BWD_PARAMS                                                     \
  const void *q, const void *k, const void *v, const float *la,            \
      const void *dy, const float *states, const float *dh_t,              \
      const float *h_t, void *dq, void *dk_out, void *dv_out, float *dla,  \
      float *dh0, float *us, void *ds, float *decay, float *parts,         \
      void *pw, int batch, int t_len, int heads, int dk, int dv,           \
      int chunk, bool fused, const Strides &st, cudaStream_t stream
#define SCAN_BWD_ARGS                                                       \
  q, k, v, la, dy, states, dh_t, h_t, dq, dk_out, dv_out, dla, dh0, us, ds, \
      decay, parts, pw, batch, t_len, heads, dk, dv, chunk, fused, st,     \
      stream
extern "C" int ssm_scan_bwd_f32(SCAN_BWD_PARAMS);
extern "C" int ssm_scan_bwd_bf16(SCAN_BWD_PARAMS);

#if !defined(BUILD_PART) || BUILD_PART == 0
extern "C" int ssm_scan_bwd_f32(SCAN_BWD_PARAMS) {
  return launch_all<float>(SCAN_BWD_ARGS);
}
#endif

#if !defined(BUILD_PART) || BUILD_PART == 1
extern "C" int ssm_scan_bwd_bf16(SCAN_BWD_PARAMS) {
  return launch_all<__nv_bfloat16>(SCAN_BWD_ARGS);
}
#endif
#undef SCAN_BWD_PARAMS
#undef SCAN_BWD_ARGS

#if !defined(BUILD_PART) || BUILD_PART == 0
// Plain C entry point, loaded with ctypes: four launches on `stream` when
// `fused`, six otherwise.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, dy
// and dq, dk, dv); log_a, states (the forward's B * H * nc * dk * dv
// chunk-entry states), dh_t and h_t (B * H * dk * dv, both null when no
// gradient reaches h_T), dla (B * T * H) and dh0 (B * H * dk * dv) are
// float32.  Scratch: us (B * H * nc * dk * dvp floats: U, and D over it
// when fused), decay (B * H * nc floats), parts (B * T * H * n_parts
// floats: 1 when fused, else 2 ceil(dk / 64)); the tiled pass's ds (D, B *
// H * nc * dk * dvp) and pw (P and W, B * H * nc * 2 * chunk^2), both in
// the input type and null when fused.  dvp, the pitch of the state rows in
// us and ds: dv when fused, else dv rounded up to a multiple of 8.  fused:
// dk <= 64 and dv <= 64, multiples of 16 bytes, with q, k, v and dy rows
// 16-byte aligned (the wrapper checks the alignment).  q and k take
// strides (in elements) over (b, t, h) and a unit stride over dk; v, dy
// and the outputs are contiguous.  Returns the CUDA error of the launches
// (0 on success), or -1 when a size is out of range (dk and dv from 1,
// chunk 1..128, grid limits).  Nothing is allocated and nothing
// synchronises.
extern "C" int ssm_scan_bwd_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* log_a, const void* dy, const void* states, const void* dh_t,
    const void* h_t, void* dq, void* dk_out, void* dv_out, void* dla,
    void* dh0, void* us, void* ds, void* decay, void* parts, void* pw,
    int batch,
    int t_len, int heads, int dk, int dv, int chunk, int fused,
    long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || dk < 1 || dv < 1 ||
      chunk < 1 || chunk > CMAX ||
      (static_cast<int64_t>(dk) * dv + NT - 1) / NT > 0x7fffffffLL)
    return -1;
  if ((dh_t == nullptr) != (h_t == nullptr)) return -1;
  const int vec = dtype == 1 ? 8 : 4;     // elements of 16 bytes
  if (fused && (dk > FUSED_DK || dv > FUSED_DV || dk % vec || dv % vec))
    return -1;
  if (!fused && (ds == nullptr || pw == nullptr)) return -1;
  const Strides st{qsb, qst, qsh, ksb, kst, ksh};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* la = static_cast<const float*>(log_a);
  const auto* sp = static_cast<const float*>(states);
  const auto* dht = static_cast<const float*>(dh_t);
  const auto* ht = static_cast<const float*>(h_t);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return ssm_scan_bwd_f32(q, k, v, la, dy, sp, dht, ht, dq, dk_out,
                            dv_out, f(dla), f(dh0), f(us), ds, f(decay),
                            f(parts), pw, batch, t_len, heads, dk, dv, chunk,
                            fused != 0, st, s);
  if (dtype == 1)
    return ssm_scan_bwd_bf16(q, k, v, la, dy, sp, dht, ht, dq, dk_out,
                             dv_out, f(dla), f(dh0), f(us), ds, f(decay),
                             f(parts), pw, batch, t_len, heads, dk, dv,
                             chunk, fused != 0, st, s);
  return -1;
}
#endif
