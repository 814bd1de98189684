// Backward of the grouped (per-expert) matrix product for NVIDIA Hopper
// (sm_90a).
//
// The reference has no backward kernel: the JAX package trains the MoE FFN
// through its einsums (src/repro/models/moe.py::_moe_tokens) and
// differentiates them with jax.grad.  The port's expert products are the
// forward kernel of grouped_matmul.cu (the Hopper counterpart of the Pallas
// TPU kernel src/repro/kernels/grouped_matmul.py::grouped_matmul), so their
// gradient is this kernel, through the autograd Function of
// kernels/grouped_matmul.py.
//
// What it computes, for out[e] = x[e] @ w[e] with x (E, C, d), w (E, d, f)
// and rows r >= counts[e] of out zero, given dOut (E, C, f):
//   dX[e] = dOut[e] @ w[e]^T   over the live rows r < counts[e]; rows past
//                              them are zeros
//   dW[e] = x[e, :n]^T @ dOut[e, :n],  n = counts[e]; zeros for an expert
//                              no token chose
// (counts clamped to [0, C]), accumulated in f32 and written in x's type.
// Rows of x and dOut past a count may hold anything, NaN included (the
// forward's contract): no such row reaches a live output.
//
// What bounds it: bytes.  dX reads the live experts' weights once and
// dOut; dW writes E * d * f.  At arctic-480b's training shape (E 128, C
// 88, d 7168, f 4864) each is 8.9 GB of bf16, about 2.7 ms at 3.35 TB/s,
// against 0.8 ms of bf16 tensor-core work; at a decode step (C 8) dW's
// write is most of it, dead experts' zeros included.
//
// bf16 with d and f multiples of 8 (16-byte rows for TMA): two persistent,
// warp-specialised kernels on TMA and wgmma, one CTA per SM, deterministic
// with no atomics (each output element is one CTA's sum over its
// reduction in one fixed order), so two runs give the same bits.
//
// * dX, the forward's pipeline transposed (swap-AB): dX[e]^T = w[e]
//   dOut[e]^T, M = 64 rows of d per w box, N = the unit's rows of C (the
//   smallest of 8, 16, 32, 48, 64, 96, 128 that holds C, else blocks of
//   128), K = f, 64 a stage.  A row of w[e] is contiguous in f, so the w
//   box is a K-major A operand read in place (no 8.9 GB transposed copy);
//   dOut's box is a K-major B.  Each CTA builds the live-expert list from
//   counts in shared memory (hopper::live_experts, the forward's) and
//   walks units (live expert, 128 columns of d, row block) in a fixed
//   stride order; one producer thread keeps a ring of up to 8 stages full
//   (w evict-first, dOut evict-last in L2: every column tile of an expert
//   reads its dOut again); two consumer warpgroups own 64 columns each.
//   Rows at or past a count (dead experts whole) are written as zeros
//   first, reading nothing.  The f32 tile goes through a bf16 staging tile
//   (row n, 64 columns) to 16-byte stores of the live rows.  Past 1024
//   experts the list does not fit and every expert is walked, the dead
//   ones skipped.
// * dW, write-streaming: output tiles (expert, 128 rows of d, 256 columns
//   of f) in a fixed stride order over the CTAs.  Per tile the producer
//   brings, 64 live rows a stage, x[e]'s slab (two 64 d x 64 row boxes:
//   an MN-major A, x^T) and dOut[e]'s (four 64 f x 64 row boxes: an
//   MN-major B); K = counts[e] rounded up to 16.  The rows from the count
//   to that multiple of 16 are zeroed in shared memory before the wgmma
//   (TMA zero-fills only past C, and NaN * 0 is NaN).  Each consumer
//   warpgroup (64 rows of d, setmaxnreg 232) keeps its 64 x 256 f32 tile
//   in registers (one m64n256k16 a k-step), rounds it to bf16 into a
//   128-byte-swizzled staging tile and writes it by TMA stores, so the
//   write of one tile overlaps the next tile's loads and products.  An
//   expert no token chose gets its tiles stored from a zero box, reading
//   nothing.  Stores carry evict-first, loads evict-last.
//
// Otherwise (f32, or widths that are not multiples of 8): IEEE f32 FMAs on
// the CUDA cores (no TF32: the f32 band of 2e-5 is beyond it), 64 x 64
// output tiles, the reduction staged 16 deep, 4 x 4 outputs a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ int live_rows(const int* counts, int e, int c) {
  return min(max(counts[e], 0), c);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA + wgmma, persistent
// ---------------------------------------------------------------------------

constexpr int TK = 64;           // reduction per stage: one 128-byte box row
constexpr int BOX = 64;          // a box: 64 contiguous elements x 64 rows
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int NWG = 2;           // consumer warpgroups
constexpr int MAX_E = 1024;      // experts the shared live list holds
constexpr int BUDGET = 227 * 1024 - 256;   // dynamic shared memory a CTA

// dX: units of N rows x 128 columns of d; a ring as deep as fits, at
// most 8 stages
template <int N>
struct DxLayout {
  static constexpr int W_BYTES = NWG * BOX_BYTES;   // two 64 d x 64 f boxes
  static constexpr int G_BYTES = N * TK * 2;        // N rows x 64 f of dOut
  static constexpr int STAGE = W_BYTES + G_BYTES;   // a multiple of 1024
  static constexpr int STG_P = BOX + 8;             // staging pitch, bf16
  static constexpr int STG_BYTES = NWG * N * STG_P * 2;
  static constexpr int LIST_BYTES = MAX_E * 4;
  static constexpr int MAX_RING = 8;
  static constexpr int BAR_BYTES = 2 * MAX_RING * 8;
  static constexpr int FIXED = 1024 + STG_BYTES + LIST_BYTES + BAR_BYTES;
  static constexpr int RING = (BUDGET - FIXED) / STAGE < MAX_RING
                                  ? (BUDGET - FIXED) / STAGE
                                  : MAX_RING;
  static constexpr int SMEM = FIXED + RING * STAGE;
  static constexpr int THREADS = NWG * 128 + 32;
  static_assert(RING >= 3, "the ring needs three stages");
};

// one dX unit: (live expert le, column tile, row block rb), rb fastest
struct Unit {
  int le, tile, rb;
};

__device__ __forceinline__ Unit unit_of(int u, int tiles, int nrb) {
  Unit o;
  o.rb = u % nrb;
  u /= nrb;
  o.tile = u % tiles;
  o.le = u / tiles;
  return o;
}

// Thread roles: warps 0-7 the two consumer warpgroups, warp 8 the
// producer, of which one thread issues the copies.
template <int N>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
gm_bwd_dx_tma_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const int32_t* __restrict__ counts,
                     __nv_bfloat16* __restrict__ dx, int e_len, int c_len,
                     int d_len, int f_len) {
  using L = DxLayout<N>;
  constexpr int RING = L::RING;
  constexpr int BD = NWG * BOX;                 // columns of d a unit
  extern __shared__ unsigned char smem_raw[];
  __shared__ int warp_cnt[L::THREADS / 32];
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* stg =
      reinterpret_cast<__nv_bfloat16*>(ring + RING * L::STAGE);
  int* live = reinterpret_cast<int*>(ring + RING * L::STAGE + L::STG_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + RING * L::STAGE + L::STG_BYTES + L::LIST_BYTES);
  uint64_t* empty = full + L::MAX_RING;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], NWG * 4);
    }
    hopper::fence_barrier_init();
  }
  // the live experts; past MAX_E every expert is walked, dead ones skipped
  const bool listed = e_len <= MAX_E;
  const int n_live = listed ? hopper::live_experts(counts, e_len, c_len,
                                                   live, warp_cnt)
                            : e_len;
  __syncthreads();

  const int tiles = (d_len + BD - 1) / BD;
  const int nrb = (c_len + N - 1) / N;
  const int kblocks = (f_len + TK - 1) / TK;
  const int units = n_live * tiles * nrb;

  if (warp == NWG * 4) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_of(u, tiles, nrb);
        const int e = listed ? live[un.le] : un.le;
        if (un.rb * N >= live_rows(counts, e, c_len)) continue;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int st = it % RING;
          hopper::mbar_wait(&empty[st], ((it / RING) & 1) ^ 1);
          unsigned char* stage = ring + st * L::STAGE;
          hopper::mbar_arrive_expect_tx(&full[st], L::STAGE);
#pragma unroll
          for (int g = 0; g < NWG; ++g)
            hopper::tma_load_3d(stage + g * BOX_BYTES, &wmap, &full[st],
                                kb * TK, un.tile * BD + g * BOX, e,
                                hopper::L2_EVICT_FIRST);
          hopper::tma_load_3d(stage + L::W_BYTES, &gmap, &full[st], kb * TK,
                              un.rb * N, e, hopper::L2_EVICT_LAST);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp >> 2;
  const int t = tid & 127;

  // zeros for every row at or past its count, w never read
  const int64_t n_rows = static_cast<int64_t>(e_len) * c_len;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * NWG * 4 + warp;
       row < n_rows; row += static_cast<int64_t>(gridDim.x) * NWG * 4) {
    const int e = static_cast<int>(row / c_len);
    if (row - static_cast<int64_t>(e) * c_len >= live_rows(counts, e, c_len)) {
      uint4* p = reinterpret_cast<uint4*>(dx + row * d_len);
      for (int ch = lane; ch < d_len / 8; ch += 32)
        p[ch] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __nv_bfloat16* my_stg = stg + wg * N * L::STG_P;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_of(u, tiles, nrb);
    const int e = listed ? live[un.le] : un.le;
    const int count = live_rows(counts, e, c_len);
    if (un.rb * N >= count) continue;

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int st = it % RING;
      hopper::mbar_wait(&full[st], (it / RING) & 1);
      const unsigned char* stage = ring + st * L::STAGE;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        hopper::WgmmaSS<N>::template mma<0, 0>(
            acc, hopper::sw128_desc(stage + wg * BOX_BYTES + kk * 32, 16, 1024),
            hopper::sw128_desc(stage + L::W_BYTES + kk * 32, 16, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    // epilogue: the accumulators (column m of d, row n) through the
    // warpgroup's bf16 staging tile [n][m], then 16-byte stores of the
    // live rows
    hopper::named_barrier(1 + wg, 128);         // the staging tile is free
    {
      const int m = 16 * (warp & 3) + (lane >> 2);
      const int n = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        __nv_bfloat16* sp = my_stg + (8 * j + n) * L::STG_P + m;
        sp[0] = __float2bfloat16_rn(acc[4 * j]);
        sp[L::STG_P] = __float2bfloat16_rn(acc[4 * j + 1]);
        sp[8] = __float2bfloat16_rn(acc[4 * j + 2]);
        sp[L::STG_P + 8] = __float2bfloat16_rn(acc[4 * j + 3]);
      }
    }
    hopper::named_barrier(1 + wg, 128);
    const int rows = min(N, count - un.rb * N);   // live rows, >= 1
    const int col0 = un.tile * BD + wg * BOX;
    for (int idx = t; idx < rows * (BOX / 8); idx += 128) {
      const int r = idx / (BOX / 8);
      const int cl = (idx % (BOX / 8)) * 8;
      if (col0 + cl >= d_len) continue;
      *reinterpret_cast<uint4*>(
          dx + (static_cast<int64_t>(e) * c_len + un.rb * N + r) * d_len
          + col0 + cl) =
          *reinterpret_cast<const uint4*>(&my_stg[r * L::STG_P + cl]);
    }
  }
}

// dW: output tiles of 128 rows of d x 256 columns of f, 64 rows of C a
// stage
struct DwLayout {
  static constexpr int BM = NWG * BOX;              // rows of d a tile
  static constexpr int BN = 4 * BOX;                // columns of f a tile
  static constexpr int X_BYTES = NWG * BOX_BYTES;   // x^T: a box a warpgroup
  static constexpr int G_BYTES = 4 * BOX_BYTES;     // dOut: four boxes
  static constexpr int STAGE = X_BYTES + G_BYTES;
  static constexpr int OUT_BYTES = NWG * 4 * BOX_BYTES;  // the bf16 tile
  static constexpr int MAX_RING = 4;
  static constexpr int BAR_BYTES = 2 * MAX_RING * 8;
  static constexpr int FIXED = 1024 + OUT_BYTES + BOX_BYTES + BAR_BYTES;
  static constexpr int RING = (BUDGET - FIXED) / STAGE < MAX_RING
                                  ? (BUDGET - FIXED) / STAGE
                                  : MAX_RING;
  static constexpr int SMEM = FIXED + RING * STAGE;
  static constexpr int THREADS = (NWG + 1) * 128;
  static_assert(RING >= 2, "the ring needs two stages");
};

// Thread roles: warpgroups 0 and 1 the consumers (setmaxnreg 232), 2 the
// producer (setmaxnreg 40), of which one thread issues the loads.  The
// roles split once and never meet again: the two consumer warpgroups
// synchronise by named barriers only.
__global__ void __launch_bounds__(DwLayout::THREADS, 1)
gm_bwd_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap omap,
                     const int32_t* __restrict__ counts, int e_len,
                     int c_len, int d_len, int f_len) {
  using L = DwLayout;
  constexpr int RING = L::RING;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* out = ring + RING * L::STAGE;
  unsigned char* zero = out + L::OUT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + BOX_BYTES);
  uint64_t* empty = full + L::MAX_RING;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], NWG * 4);
    }
    hopper::fence_barrier_init();
  }
  for (int i = tid; i < BOX_BYTES / 16; i += L::THREADS)
    reinterpret_cast<uint4*>(zero)[i] = make_uint4(0u, 0u, 0u, 0u);
  hopper::fence_proxy_async();    // TMA stores read the zero box
  __syncthreads();

  const int tiles_f = (f_len + L::BN - 1) / L::BN;
  const int tiles_d = (d_len + L::BM - 1) / L::BM;
  const int per_e = tiles_f * tiles_d;
  const int64_t units = static_cast<int64_t>(e_len) * per_e;

  if (wg == NWG) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if (tid == NWG * 128) {
      int it = 0;
      for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
        const int e = static_cast<int>(u / per_e);
        const int r = static_cast<int>(u % per_e);
        const int dt = r / tiles_f;
        const int ft = r % tiles_f;
        const int count = live_rows(counts, e, c_len);
        for (int k0 = 0; k0 < count; k0 += TK, ++it) {
          const int st = it % RING;
          hopper::mbar_wait(&empty[st], ((it / RING) & 1) ^ 1);
          unsigned char* stage = ring + st * L::STAGE;
          hopper::mbar_arrive_expect_tx(&full[st], L::STAGE);
#pragma unroll
          for (int g = 0; g < NWG; ++g)
            hopper::tma_load_3d(stage + g * BOX_BYTES, &xmap, &full[st],
                                dt * L::BM + g * BOX, k0, e,
                                hopper::L2_EVICT_LAST);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hopper::tma_load_3d(stage + L::X_BYTES + j * BOX_BYTES, &gmap,
                                &full[st], ft * L::BN + j * BOX, k0, e,
                                hopper::L2_EVICT_LAST);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::reg_alloc<232>();
    const int t = tid & 127;
    unsigned char* my_out = out + wg * 4 * BOX_BYTES;
    const int m = 16 * (warp & 3) + (lane >> 2);   // this thread's rows
    const int sw = m & 7;                          // (m and m + 8)
    int it = 0;
    for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
      const int e = static_cast<int>(u / per_e);
      const int r = static_cast<int>(u % per_e);
      const int dt = r / tiles_f;
      const int ft = r % tiles_f;
      const int count = live_rows(counts, e, c_len);
      const int row0 = dt * L::BM + wg * BOX;      // this warpgroup's d
      if (count == 0) {                // no token chose e: zeros
        if (t == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hopper::tma_store_3d(&omap, zero, ft * L::BN + j * BOX, row0, e,
                                 hopper::L2_EVICT_FIRST);
          hopper::bulk_commit();
        }
        continue;
      }

      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < count; k0 += TK, ++it) {
        const int st = it % RING;
        hopper::mbar_wait(&full[st], (it / RING) & 1);
        unsigned char* stage = ring + st * L::STAGE;
        const int rows = min(TK, count - k0);
        const int ksteps = (rows + 15) / 16;
        if (rows % 16 != 0) {
          // rows [rows, 16 ksteps) of this warpgroup's x box and of dOut
          // boxes 2 wg and 2 wg + 1 to zeros (whole 128-byte rows, so the
          // swizzle does not matter); both warpgroups read all four dOut
          // boxes, so they meet before the product
          const int zr = 16 * ksteps - rows;
          for (int idx = t; idx < 3 * zr * 8; idx += 128) {
            const int box = idx / (zr * 8);
            const int rr = rows + (idx % (zr * 8)) / 8;
            const int ch = idx % 8;
            unsigned char* bp =
                box == 0 ? stage + wg * BOX_BYTES
                         : stage + L::X_BYTES + (2 * wg + box - 1) * BOX_BYTES;
            *reinterpret_cast<uint4*>(bp + rr * 128 + ch * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          hopper::fence_proxy_async();
          hopper::named_barrier(1, NWG * 128);
        }
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          if (kk < ksteps)
            hopper::WgmmaSS<256>::template mma<1, 1>(
                acc,
                hopper::sw128_desc(stage + wg * BOX_BYTES + kk * 2048,
                                   BOX_BYTES, 1024),
                hopper::sw128_desc(stage + L::X_BYTES + kk * 2048, BOX_BYTES,
                                   1024),
                1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
      }

      // epilogue: bf16 into the 128-byte-swizzled staging boxes (row m,
      // 16-byte chunk c at chunk c ^ (m % 8)), then four TMA stores; the
      // previous tile's stores must have read the staging tile first
      if (t == 0) hopper::bulk_wait_read<0>();
      hopper::named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        unsigned char* bp = my_out + (j >> 3) * BOX_BYTES
                            + (((j & 7) ^ sw) << 4) + (lane & 3) * 4;
        *reinterpret_cast<unsigned*>(bp + m * 128) =
            hopper::pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<unsigned*>(bp + (m + 8) * 128) =
            hopper::pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(2 + wg, 128);
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hopper::tma_store_3d(&omap, my_out + j * BOX_BYTES,
                               ft * L::BN + j * BOX, row0, e,
                               hopper::L2_EVICT_FIRST);
        hopper::bulk_commit();
      }
    }
    if (t == 0) hopper::bulk_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// f32 FMAs on the CUDA cores (f32, and bf16 at widths the tensor-core
// kernels do not take)
// ---------------------------------------------------------------------------

constexpr int NT = 256;
constexpr int GT = 64;           // output tile, rows and columns
constexpr int GK = 16;           // reduction depth staged at a time
constexpr int GP = GT + 4;       // padded stage row (272 bytes)

// dX (E, C, d) = dOut w^T over the live rows.  grid (d / 64, C / 64, E).
template <typename T>
__global__ void __launch_bounds__(NT)
gm_bwd_dx_kernel(const T* __restrict__ dout, const T* __restrict__ w,
                 const int* __restrict__ counts, T* __restrict__ dx, int c,
                 int d, int f) {
  __shared__ __align__(16) float as[GK][GP];     // [f][row of C]
  __shared__ __align__(16) float bs[GK][GP];     // [f][column of d]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  const int live = live_rows(counts, e, c);
  float acc[4][4] = {};
  const T* gsrc = dout + static_cast<int64_t>(e) * c * f;
  const T* wsrc = w + static_cast<int64_t>(e) * d * f;
  if (m0 < live) {               // else: zeros, and w is not read
    for (int k0 = 0; k0 < f; k0 += GK) {
      __syncthreads();
      for (int idx = tid; idx < GT * GK; idx += NT) {
        const int r = idx / GK, kk = idx % GK, col = k0 + kk;
        as[kk][r] = m0 + r < live && col < f
                        ? load_one(gsrc + static_cast<int64_t>(m0 + r) * f
                                   + col)
                        : 0.f;
        bs[kk][r] = n0 + r < d && col < f
                        ? load_one(wsrc + static_cast<int64_t>(n0 + r) * f
                                   + col)
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  T* out = dx + static_cast<int64_t>(e) * c * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (r < c && col < d)
        store_one(out + static_cast<int64_t>(r) * d + col, acc[i][j]);
    }
  }
}

// dW (E, d, f) = x^T dOut over the live rows of C.  grid (f / 64, d / 64,
// E).
template <typename T>
__global__ void __launch_bounds__(NT)
gm_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                 const int* __restrict__ counts, T* __restrict__ dw, int c,
                 int d, int f) {
  __shared__ __align__(16) float as[GK][GP];     // [row of C][row of d]
  __shared__ __align__(16) float bs[GK][GP];     // [row of C][column of f]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  const int live = live_rows(counts, e, c);
  float acc[4][4] = {};
  const T* xsrc = x + static_cast<int64_t>(e) * c * d;
  const T* gsrc = dout + static_cast<int64_t>(e) * c * f;
  for (int k0 = 0; k0 < live; k0 += GK) {
    __syncthreads();
    for (int idx = tid; idx < GK * GT; idx += NT) {
      const int kk = idx / GT, m = idx % GT, r = k0 + kk;
      as[kk][m] = r < live && m0 + m < d
                      ? load_one(xsrc + static_cast<int64_t>(r) * d + m0 + m)
                      : 0.f;
      bs[kk][m] = r < live && n0 + m < f
                      ? load_one(gsrc + static_cast<int64_t>(r) * f + n0 + m)
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  T* out = dw + static_cast<int64_t>(e) * d * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (r < d && col < f)
        store_one(out + static_cast<int64_t>(r) * f + col, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_cores(const void* x, const void* w, const int* counts,
                         const void* dout, void* dx, void* dw, int e, int c,
                         int d, int f, cudaStream_t s) {
  if (dx != nullptr) {
    gm_bwd_dx_kernel<T><<<dim3((d + GT - 1) / GT, (c + GT - 1) / GT, e), NT,
                          0, s>>>(static_cast<const T*>(dout),
                                  static_cast<const T*>(w), counts,
                                  static_cast<T*>(dx), c, d, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr)
    gm_bwd_dw_kernel<T><<<dim3((f + GT - 1) / GT, (d + GT - 1) / GT, e), NT,
                          0, s>>>(static_cast<const T*>(x),
                                  static_cast<const T*>(dout), counts,
                                  static_cast<T*>(dw), c, d, f);
  return cudaGetLastError();
}


// the rows of a dX unit: the smallest of DX_ROWS that holds C, else 128
constexpr int DX_ROWS[] = {8, 16, 32, 48, 64, 96, 128};

int dx_rows(int c) {
  for (const int r : DX_ROWS)
    if (c <= r) return r;
  return 128;
}

template <int N>
int launch_dx(const void* w, const void* dout, const int* counts, void* dx,
              int e, int c, int d, int f, int grid, cudaStream_t s) {
  using L = DxLayout<N>;
  static bool smem_set = false;   // the attribute, once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gm_bwd_dx_tma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  CUtensorMap wmap, gmap;
  // w as {f, d, E} in boxes of 64 f x 64 d; dOut as {f, C, E} in boxes of
  // 64 f x N rows
  if (!hopper::encode_tensor_map(&wmap, w, f, d, e, 2ull * f, 2ull * d * f,
                                 BOX, BOX) ||
      !hopper::encode_tensor_map(&gmap, dout, f, c, e, 2ull * f,
                                 2ull * c * f, TK, N))
    return -2;
  gm_bwd_dx_tma_kernel<N><<<grid, L::THREADS, L::SMEM, s>>>(
      wmap, gmap, counts, static_cast<__nv_bfloat16*>(dx), e, c, d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw(const void* x, const void* dout, const int* counts, void* dw,
              int e, int c, int d, int f, int grid, cudaStream_t s) {
  using L = DwLayout;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gm_bwd_dw_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  CUtensorMap xmap, gmap, omap;
  // x as {d, C, E} and dOut as {f, C, E} in boxes of 64 x 64 rows; dW as
  // {f, d, E} in boxes of 64 f x 64 d (the stores)
  if (!hopper::encode_tensor_map(&xmap, x, d, c, e, 2ull * d, 2ull * c * d,
                                 BOX, TK) ||
      !hopper::encode_tensor_map(&gmap, dout, f, c, e, 2ull * f,
                                 2ull * c * f, BOX, TK) ||
      !hopper::encode_tensor_map(&omap, dw, f, d, e, 2ull * f, 2ull * d * f,
                                 BOX, BOX))
    return -2;
  gm_bwd_dw_tma_kernel<<<grid, L::THREADS, L::SMEM, s>>>(
      xmap, gmap, omap, counts, e, c, d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_tma(const void* x, const void* w, const int* counts,
               const void* dout, void* dx, void* dw, int e, int c, int d,
               int f, cudaStream_t s) {
  const int grid = hopper::sm_count();
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (dx != nullptr) {
    int err;
#define GM_DX(N_)                                                     \
  case N_:                                                            \
    err = launch_dx<N_>(w, dout, counts, dx, e, c, d, f, grid, s); \
    break
    switch (dx_rows(c)) {
      GM_DX(8);
      GM_DX(16);
      GM_DX(32);
      GM_DX(48);
      GM_DX(64);
      GM_DX(96);
      GM_DX(128);
      default:
        return -1;
    }
#undef GM_DX
    if (err != 0) return err;
  }
  if (dw != nullptr) {
    const int64_t tiles = static_cast<int64_t>(e)
                          * ((d + DwLayout::BM - 1) / DwLayout::BM)
                          * ((f + DwLayout::BN - 1) / DwLayout::BN);
    return launch_dw(x, dout, counts, dw, e, c, d, f,
                     static_cast<int>(tiles < grid ? tiles : grid), s);
  }
  return 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes: dX and/or dW (either output
// pointer may be null: that gradient is not computed) on `stream`.
// dtype: 0 = float32, 1 = bfloat16 (x, w, dout, dx, dw); counts (E,) int32
// on the device.  tensor_cores: 1 takes the TMA + wgmma kernels (bf16, d
// and f multiples of 8, 16-byte aligned x, w and dout; the wrapper
// checks), 0 the CUDA-core ones.  Returns the CUDA error of the launches
// (0 on success), -1 for sizes out of range, -2 when the driver refuses a
// tensor map.  Nothing is allocated and nothing synchronises.
extern "C" int grouped_matmul_bwd_launch(int dtype, const void* x,
                                         const void* w, const void* counts,
                                         const void* dout, void* dx, void* dw,
                                         int e, int c, int d, int f,
                                         int tensor_cores, void* stream) {
  if (e <= 0 || e > 65535 || c <= 0 || d <= 0 || f <= 0) return -1;
  if (tensor_cores && (dtype != 1 || d % 8 != 0 || f % 8 != 0)) return -1;
  if ((c + GT - 1) / GT > 65535 || (d + GT - 1) / GT > 65535) return -1;
  const auto* cnt = static_cast<const int*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tensor_cores)
    return launch_tma(x, w, cnt, dout, dx, dw, e, c, d, f, s);
  if (dtype == 0)
    err = launch_cores<float>(x, w, cnt, dout, dx, dw, e, c, d, f, s);
  else if (dtype == 1)
    err = launch_cores<__nv_bfloat16>(x, w, cnt, dout, dx, dw, e, c, d, f,
                                      s);
  else
    return -1;
  return static_cast<int>(err);
}
