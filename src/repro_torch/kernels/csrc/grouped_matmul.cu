// Grouped (per-expert) matrix product of the MoE FFN, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul.py
// (grouped_matmul / _kernel), reached through the wrapper
// src/repro/kernels/ops.py::grouped_matmul.  On the port's path it is each
// of the three expert products of every MoE layer (models/moe.py), at
// prefill and at decode.
//
// What it computes: out[e] = x[e] @ w[e] for the (E, C, d) dispatch buffer
// of the sort-based routing, f32 accumulation, the output in x's type.
// Rows r >= counts[e] (capacity padding) are written as zeros, whatever x
// holds there, and an expert with no row never reads w[e].  counts is
// clamped to [0, C] and is read only on the device.
//
// Layouts, all contiguous, with 64-bit offsets (w of one arctic layer has
// 4.46 G elements):
//   x (E, C, d)    w (E, d, f)    out (E, C, f)    counts (E,) int32
//
// What bounds it: the bytes of the live experts' w, at every C on the
// path.  At decode (C = 8) 13-16 of arctic's 128 experts are live, about
// 0.9 GB of 8.9 GB per product; at a 1024-token prefill (C = 24) all of
// them, and 2 C = 48 operations per weight byte (kimi's C = 32: 64) is far
// below the ~295 at which the tensor cores, not the memory, would bound
// it.  So the design has to keep enough bytes in flight on every SM and
// give every SM the same bytes; the MMA rate does not matter.
//
// bf16 with d and f multiples of 8 (every arctic and kimi product):
// grouped_matmul_tma_kernel, persistent and warp-specialised.
//
// * One CTA per SM, launched once (the grid is the SM count, read once
//   on the host).  Each CTA builds the list of live experts from counts
//   in shared memory (a block scan) and walks work units (live expert,
//   128 output columns at decode or 256 at prefill, a block of up to 64
//   rows; d whole) in a fixed stride order, so every SM streams the same
//   bytes, give or take one unit.  Before that, its consumer warps write
//   the zeros of every row at or past its count (dead experts whole),
//   reading nothing.  At decode 13 live experts give 494 units of 128
//   columns for 132 SMs, 3.74 each: with the ring full on every SM the
//   memory, not the busiest SM, sets the time.  A split of d into ranges
//   merged in a fixed order, and 64-column units on two CTAs an SM, were
//   measured no faster on the path (PERF.md §6) and are not built.
// * One producer thread keeps a ring of up to 8 stages full with TMA
//   (cp.async.bulk.tensor, the 128-byte swizzle): per stage 64 d x 64 f
//   boxes of w (2 or 4, 16 or 32 KB) and a (rows x 64 d) box of x, one
//   mbarrier per slot for "full" and one for "empty": over 100 KB in
//   flight per SM, no thread spends registers or instructions on the
//   copy, and no CTA-wide barrier is taken in the main loop.  Boxes past
//   d, f or C arrive as zeros.  At prefill shapes the w boxes carry an
//   evict-first L2 policy and the x boxes evict-last: the weights pass
//   through L2 once while every column tile of an expert reads its x
//   again, and without the hints the stream can evict x between its
//   readers.  The hints were measured to help at prefill and not at
//   decode, where they are off (PERF.md §6).
// * Swap-AB on wgmma: out[e]^T = w[e]^T x[e]^T.  M is 64 output columns
//   per w box (A = the box, f-contiguous, transposed through its
//   descriptor), two consumer warpgroups of one or two boxes each; N the
//   rows (8 at decode, 24 to 56 at prefill: wgmma takes any multiple of
//   8); K the 64 d of a stage in four m64nNk16 steps; the f32
//   accumulators stay in registers and each output element is the sum of
//   its d in one fixed order, so two calls give the same bits.  Rows past
//   a count may hold anything, NaN included: each feeds only its own
//   output row, which is written as zero.
//
// Otherwise (f32, ragged widths, E > 1024): grouped_matmul_kernel, f32
// FMAs on the CUDA cores.  Each lane holds 4 adjacent columns (one 8- or
// 16-byte load, so a warp reads 256 or 512 contiguous bytes of a w row),
// and the 8 warps split d between them, each keeping U rows of loads in
// flight.  x is staged per d-tile in shared memory as f32, transposed, so
// one float4 read feeds four rows' FMAs.  The warps' partial sums meet in
// shared memory in a fixed order.  Plain IEEE f32 FMAs: no TF32.  A row
// block at or past counts[e] never touches w[e].

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int BF = 128;    // output columns per CTA, 4 per lane
constexpr int XS = 4096;   // f32 elements of the staged x tile

// 4 adjacent columns of row d of w into f32; zeros where out of range.
template <typename T, bool VEC>
__device__ __forceinline__ void load_w4(const T* __restrict__ wb, int d,
                                        int fc, int f_len, bool ok,
                                        float (&o)[4]) {
  const T* p = wb + static_cast<int64_t>(d) * f_len + fc;
  if constexpr (VEC) {
    // f_len % 4 == 0 and w 16-byte aligned: fc < f_len covers all four
    if (ok && fc < f_len) {
      if constexpr (sizeof(T) == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
      } else {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
      }
      return;
    }
  } else {
    if (ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = fc + c < f_len ? load_one(p + c) : 0.f;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = 0.f;
}

template <typename T, int BC, bool VEC>
__global__ void __launch_bounds__(NT)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int32_t* __restrict__ counts, T* __restrict__ out,
                      int c_len, int d_len, int f_len) {
  constexpr int DT = XS / BC;         // d values per staged x tile
  constexpr int U = BC >= 32 ? 4 : 8;  // w rows a warp has in flight
  constexpr int NG = BC / 8;          // 8-row groups of the block
  static_assert(DT % (NWARPS * U) == 0, "x tile must split over the warps");
  __shared__ __align__(16) float xs[DT][BC];
  __shared__ __align__(16) float red[BC][BF];

  const int f0 = blockIdx.x * BF;
  const int r0 = blockIdx.y * BC;
  const int e = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int count = min(max(counts[e], 0), c_len);
  const int live = min(count - r0, BC);     // live rows of this block
  T* ob = out + static_cast<int64_t>(e) * c_len * f_len;

  if (live <= 0) {                          // w[e] is never read
    for (int idx = threadIdx.x; idx < BC * BF; idx += NT) {
      const int row = r0 + idx / BF;
      const int f = f0 + idx % BF;
      if (row < c_len && f < f_len)
        store_one(ob + static_cast<int64_t>(row) * f_len + f, 0.f);
    }
    return;
  }

  const int groups = (live + 7) / 8;
  const int fc = f0 + lane * 4;             // this lane's first column
  const T* wb = w + static_cast<int64_t>(e) * d_len * f_len;
  const T* xb = x + (static_cast<int64_t>(e) * c_len + r0) * d_len;

  float acc[BC][4];
#pragma unroll
  for (int r = 0; r < BC; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int d0 = 0; d0 < d_len; d0 += DT) {
    __syncthreads();                        // the previous tile is consumed
    // x[r0 + r][d0 + j] -> xs[j][r]; rows past `live` and d past d_len
    // as 0 (row-fastest, so the shared-memory writes do not conflict)
    for (int idx = threadIdx.x; idx < BC * DT; idx += NT) {
      const int r = idx % BC;
      const int j = idx / BC;
      float v = 0.f;
      if (r < live && d0 + j < d_len)
        v = load_one(xb + static_cast<int64_t>(r) * d_len + d0 + j);
      xs[j][r] = v;
    }
    __syncthreads();
    const int dn = min(DT, d_len - d0);
    for (int j0 = warp * U; j0 < dn; j0 += NWARPS * U) {
      float wr[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_w4<T, VEC>(wb, d0 + j0 + u, fc, f_len, j0 + u < dn, wr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g < groups) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g * 8 + h * 4;
              const float4 xv =
                  *reinterpret_cast<const float4*>(&xs[j0 + u][r]);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[r][c] = fmaf(xv.x, wr[u][c], acc[r][c]);
                acc[r + 1][c] = fmaf(xv.y, wr[u][c], acc[r + 1][c]);
                acc[r + 2][c] = fmaf(xv.z, wr[u][c], acc[r + 2][c]);
                acc[r + 3][c] = fmaf(xv.w, wr[u][c], acc[r + 3][c]);
              }
            }
          }
        }
      }
    }
  }

  // the warps' partial sums meet in a fixed order: warp 0 stores, the
  // others add in turn
#pragma unroll 1
  for (int ww = 0; ww < NWARPS; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g < groups) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = g * 8 + i;
            float4* p = reinterpret_cast<float4*>(&red[r][lane * 4]);
            float4 s = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                   acc[r][3]);
            if (ww > 0) {
              const float4 o = *p;
              s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
            }
            *p = s;
          }
        }
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < BC * BF; idx += NT) {
    const int r = idx / BF;
    const int col = idx % BF;
    const int row = r0 + r;
    const int f = f0 + col;
    if (row < c_len && f < f_len)
      store_one(ob + static_cast<int64_t>(row) * f_len + f,
                r < live ? red[r][col] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the persistent TMA + wgmma kernel (above).
// ---------------------------------------------------------------------------

constexpr int TK = 64;          // d per stage: one 128-byte swizzled box row
constexpr int TF = 64;          // columns of a w box: one wgmma M
constexpr int NWG = 2;          // consumer warpgroups of a CTA
constexpr int MAX_RING = 8;     // pipeline stages at most
constexpr int MAX_E = 1024;     // experts the shared live list holds

// Shared memory of one CTA: NWG consumer warpgroups of MT w boxes each
// (64 MT columns), N rows; the ring as deep as one CTA an SM allows, at
// most MAX_RING.
template <int N, int MT>
struct TmaLayout {
  static constexpr int W_BOX = TK * TF * 2;          // one w box, bytes
  static constexpr int W_BYTES = NWG * MT * W_BOX;
  static constexpr int X_BYTES = N * TK * 2;         // a multiple of 1024
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STG_P = MT * TF + 4;          // staging pitch, f32
  static constexpr int STG_BYTES = NWG * N * STG_P * 4;
  static constexpr int LIST_BYTES = MAX_E * 4;
  static constexpr int BAR_BYTES = 2 * MAX_RING * 8;
  // 1024 of slack to align the ring to the swizzle atom
  static constexpr int FIXED = 1024 + STG_BYTES + LIST_BYTES + BAR_BYTES;
  static constexpr int BUDGET = 227 * 1024 - 256;
  static constexpr int RING =
      (BUDGET - FIXED) / STAGE < MAX_RING ? (BUDGET - FIXED) / STAGE
                                          : MAX_RING;
  static constexpr int RING_BYTES = RING * STAGE;
  static constexpr int SMEM = FIXED + RING_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int CONSUMER_WARPS = NWG * 4;
  static_assert(RING >= 3, "the ring needs three stages");
};

// One work unit: (live expert le, column tile, row block rb), rb fastest,
// so neighbouring CTAs share a w slice through L2 when C is cut into row
// blocks.
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

__device__ __forceinline__ int clamp_count(const int32_t* counts, int e,
                                           int c_len) {
  return min(max(counts[e], 0), c_len);
}

// Thread roles: warps 0 .. 4 NWG - 1 are the consumer warpgroups (wgmma
// needs aligned groups of four warps), the last warp the producer, of
// which one thread issues the copies.
template <int N, int MT>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
grouped_matmul_tma_kernel(const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap xmap,
                          const int32_t* __restrict__ counts,
                          __nv_bfloat16* __restrict__ out, int e_len,
                          int c_len, int d_len, int f_len, int l2_hints) {
  using L = TmaLayout<N, MT>;
  constexpr int RING = L::RING;
  constexpr int WT = MT * TF;                   // columns of a warpgroup
  constexpr int BN = NWG * WT;                  // columns of a unit
  constexpr int NWARPS = L::THREADS / 32;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int warp_cnt[NWARPS];
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* stg = reinterpret_cast<float*>(ring + L::RING_BYTES);
  int* live = reinterpret_cast<int*>(ring + L::RING_BYTES + L::STG_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + L::RING_BYTES + L::STG_BYTES + L::LIST_BYTES);
  uint64_t* empty = full + MAX_RING;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], L::CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }

  // the live experts in expert order: a block scan of (counts > 0)
  const int n_live = hopper::live_experts(counts, e_len, c_len, live,
                                          warp_cnt);

  const int tiles = (f_len + BN - 1) / BN;
  const int nrb = (c_len + N - 1) / N;
  const int kblocks = (d_len + TK - 1) / TK;
  const int units = n_live * tiles * nrb;

  if (warp == L::CONSUMER_WARPS) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_of(u, tiles, nrb);
        const int e = live[un.le];
        if (un.rb * N >= clamp_count(counts, e, c_len)) continue;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int st = it % RING;
          hopper::mbar_wait(&empty[st], ((it / RING) & 1) ^ 1);
          unsigned char* stage = ring + st * L::STAGE;
          hopper::mbar_arrive_expect_tx(&full[st], L::STAGE);
          if (l2_hints) {       // w streams through L2; x is read again
#pragma unroll
            for (int g = 0; g < NWG * MT; ++g)
              hopper::tma_load_3d(stage + g * L::W_BOX, &wmap, &full[st],
                                  un.tile * BN + g * TF, kb * TK, e,
                                  hopper::L2_EVICT_FIRST);
            hopper::tma_load_3d(stage + L::W_BYTES, &xmap, &full[st],
                                kb * TK, un.rb * N, e, hopper::L2_EVICT_LAST);
          } else {
#pragma unroll
            for (int g = 0; g < NWG * MT; ++g)
              hopper::tma_load_3d(stage + g * L::W_BOX, &wmap, &full[st],
                                  un.tile * BN + g * TF, kb * TK, e);
            hopper::tma_load_3d(stage + L::W_BYTES, &xmap, &full[st],
                                kb * TK, un.rb * N, e);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp >> 2;                   // this warpgroup
  const int t = tid & 127;                    // thread in the warpgroup

  // zeros for every row at or past its count, w never read
  for (int row = blockIdx.x * L::CONSUMER_WARPS + warp; row < e_len * c_len;
       row += gridDim.x * L::CONSUMER_WARPS) {
    const int e = row / c_len;
    if (row - e * c_len >= clamp_count(counts, e, c_len)) {
      uint4* p = reinterpret_cast<uint4*>(out + static_cast<int64_t>(row)
                                                    * f_len);
      for (int ch = lane; ch < f_len / 8; ch += 32)
        p[ch] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float* my_stg = stg + wg * N * L::STG_P;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_of(u, tiles, nrb);
    const int e = live[un.le];
    const int count = clamp_count(counts, e, c_len);
    if (un.rb * N >= count) continue;

    float acc[MT][N / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int st = it % RING;
      hopper::mbar_wait(&full[st], (it / RING) & 1);
      const unsigned char* stage = ring + st * L::STAGE;
      const unsigned char* xt = stage + L::W_BYTES;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) hopper::fence_regs(acc[mt]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t bdesc = hopper::sw128_desc(xt + kk * 32, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hopper::WgmmaSS<N>::template mma<1, 0>(
              acc[mt],
              hopper::sw128_desc(stage + (wg * MT + mt) * L::W_BOX
                                     + kk * 2048, 8192, 1024),
              bdesc, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) hopper::fence_regs(acc[mt]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    // epilogue: the accumulators (column m, row n) through the
    // warpgroup's staging tile, then rows of 16-byte stores
    hopper::named_barrier(1 + wg, 128);         // the staging tile is free
    {
      const int m = 16 * (warp & 3) + (lane >> 2);
      const int n = 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* sp = my_stg + mt * TF + m;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          sp[(8 * j + n) * L::STG_P] = acc[mt][4 * j];
          sp[(8 * j + n + 1) * L::STG_P] = acc[mt][4 * j + 1];
          sp[(8 * j + n) * L::STG_P + 8] = acc[mt][4 * j + 2];
          sp[(8 * j + n + 1) * L::STG_P + 8] = acc[mt][4 * j + 3];
        }
      }
    }
    hopper::named_barrier(1 + wg, 128);
    const int rows = min(N, count - un.rb * N);   // live rows, >= 1
    const int col0 = un.tile * BN + wg * WT;
    for (int idx = t; idx < rows * (WT / 8); idx += 128) {
      const int r = idx / (WT / 8);
      const int cl = (idx % (WT / 8)) * 8;
      if (col0 + cl >= f_len) continue;
      const float4 lo = *reinterpret_cast<const float4*>(
          &my_stg[r * L::STG_P + cl]);
      const float4 hi = *reinterpret_cast<const float4*>(
          &my_stg[r * L::STG_P + cl + 4]);
      uint4 v;
      v.x = hopper::pack_bf16x2(lo.x, lo.y);
      v.y = hopper::pack_bf16x2(lo.z, lo.w);
      v.z = hopper::pack_bf16x2(hi.x, hi.y);
      v.w = hopper::pack_bf16x2(hi.z, hi.w);
      *reinterpret_cast<uint4*>(
          out + (static_cast<int64_t>(e) * c_len + un.rb * N + r) * f_len
          + col0 + cl) = v;
    }
  }
}

template <typename T, int BC>
void launch(const void* x, const void* w, const int32_t* counts, void* out,
            int e, int c, int d, int f, bool vec, cudaStream_t stream) {
  dim3 grid((f + BF - 1) / BF, (c + BC - 1) / BC, e);
  if (vec)
    grouped_matmul_kernel<T, BC, true><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), counts,
        static_cast<T*>(out), c, d, f);
  else
    grouped_matmul_kernel<T, BC, false><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), counts,
        static_cast<T*>(out), c, d, f);
}

// rows per CTA: the smallest of 8, 16, 32 that holds C, else blocks of 32
template <typename T>
void dispatch_bc(const void* x, const void* w, const int32_t* counts,
                 void* out, int e, int c, int d, int f, bool vec,
                 cudaStream_t s) {
  if (c <= 8)
    launch<T, 8>(x, w, counts, out, e, c, d, f, vec, s);
  else if (c <= 16)
    launch<T, 16>(x, w, counts, out, e, c, d, f, vec, s);
  else
    launch<T, 32>(x, w, counts, out, e, c, d, f, vec, s);
}

template <int N, int MT>
int launch_tma(const void* x, const void* w, const int32_t* counts,
               void* out, int e, int c, int d, int f, int grid, int l2_hints,
               cudaStream_t stream) {
  using L = TmaLayout<N, MT>;
  static bool smem_set = false;   // the attribute, once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_matmul_tma_kernel<N, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  CUtensorMap wmap, xmap;
  // w as {f, d, E} in boxes of 64 f x 64 d; x as {d, C, E} in boxes of
  // 64 d x N rows
  if (!hopper::encode_tensor_map(&wmap, w, f, d, e, 2ull * f,
                                 2ull * d * f, TF, TK) ||
      !hopper::encode_tensor_map(&xmap, x, d, c, e, 2ull * d,
                                 2ull * c * d, TK, N))
    return -2;
  grouped_matmul_tma_kernel<N, MT><<<grid, L::THREADS, L::SMEM, stream>>>(
      wmap, xmap, counts, static_cast<__nv_bfloat16*>(out), e, c, d, f,
      l2_hints);
  return static_cast<int>(cudaGetLastError());
}

// the unit's rows N, for warpgroups of MT boxes
template <int MT>
int dispatch_rows(int rows, const void* x, const void* w,
                  const int32_t* counts, void* out, int e, int c, int d,
                  int f, int grid, int l2_hints, cudaStream_t s) {
#define GM_ROWS(N_)                                                          \
  case N_:                                                                   \
    return launch_tma<N_, MT>(x, w, counts, out, e, c, d, f, grid, l2_hints, \
                              s)
  switch (rows) {
    GM_ROWS(8);
    GM_ROWS(16);
    GM_ROWS(24);
    GM_ROWS(32);
    GM_ROWS(40);
    GM_ROWS(48);
    GM_ROWS(56);
    GM_ROWS(64);
    default:
      return -1;
  }
#undef GM_ROWS
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns the CUDA error of
// its launches (0 on success), -1 for an unsupported dtype, path or shape,
// or -2 when the driver refuses a tensor map.  Launches are asynchronous
// on `stream` and allocate nothing.
//
// grouped_matmul_launch: the CUDA-core kernel.  dtype: 0 = float32, 1 =
// bfloat16.  path: 0 = one column at a time; 1 = four columns a load
// (f % 4 == 0, w 16-byte aligned).
extern "C" int grouped_matmul_launch(int dtype, const void* x, const void* w,
                                     const void* counts, void* out, int e,
                                     int c, int d, int f, int path,
                                     void* stream) {
  if (e <= 0 || e > 65535 || c <= 0 || (c + 31) / 32 > 65535 || d <= 0 ||
      f <= 0 || path < 0 || path > 1)
    return -1;
  const auto* cnt = static_cast<const int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch_bc<float>(x, w, cnt, out, e, c, d, f, path == 1, s);
  else if (dtype == 1)
    dispatch_bc<__nv_bfloat16>(x, w, cnt, out, e, c, d, f, path == 1, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// grouped_matmul_tma_launch: bf16 on the tensor cores (d % 8 == 0, f % 8
// == 0, x, w and out 16-byte aligned, E <= 1024).  rows: N, the rows of a
// unit (a multiple of 8 up to 64); m_tiles: 1 or 2 blocks of 64 columns
// per consumer warpgroup; grid: the persistent CTAs; l2_hints: 1 loads w
// as evict-first and x as evict-last in L2.
extern "C" int grouped_matmul_tma_launch(const void* x, const void* w,
                                         const void* counts, void* out,
                                         int e, int c, int d, int f,
                                         int rows, int m_tiles, int grid,
                                         int l2_hints, void* stream) {
  if (e <= 0 || e > MAX_E || c <= 0 || d <= 0 || f <= 0 || d % 8 != 0 ||
      f % 8 != 0 || grid <= 0)
    return -1;
  const auto* cnt = static_cast<const int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (m_tiles == 1)
    return dispatch_rows<1>(rows, x, w, cnt, out, e, c, d, f, grid, l2_hints,
                            s);
  if (m_tiles == 2)
    return dispatch_rows<2>(rows, x, w, cnt, out, e, c, d, f, grid, l2_hints,
                            s);
  return -1;
}
