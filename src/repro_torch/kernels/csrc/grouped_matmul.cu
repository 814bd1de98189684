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
// holds there.  counts is clamped to [0, C].
//
// Layouts, all contiguous, with 64-bit offsets (w of one arctic layer has
// 4.46 G elements):
//   x (E, C, d)    w (E, d, f)    out (E, C, f)    counts (E,) int32
//
// What bounds it: at decode the bytes of the live experts' w (E = 128,
// C = 8, at most 16 experts live: ~1.1 GB of 8.9 GB per product), against
// 3.35 TB/s; at a 1024-token prefill (C = 24, every expert live) the bytes
// too, on the tensor cores (~12 operations per weight byte), but not on the
// f32 CUDA cores.  What the design does about the bytes: a CTA reads
// counts[e] first, and a row block at or past counts[e] never touches
// w[e]; it only writes zeros.  So an empty expert costs a few stores, as
// the TPU kernel's `live` test skips its MXU work.  A live CTA owns
// (expert, BC rows, BF = 128 columns), streams its (d x 128) slice of w[e]
// exactly once and computes only the live 8-row groups of its block.
// Two kernels do that:
//
// * bf16 with f and d multiples of 8 (every arctic product): mma.sync on
//   the tensor cores, w and x tiles fed through a cp.async ring (below).
// * otherwise (f32, ragged widths): f32 FMAs on the CUDA cores.  Each lane
//   holds 4 adjacent columns (one 8- or 16-byte load, so a warp reads 256
//   or 512 contiguous bytes of a w row), and the 8 warps split d between
//   them, each keeping U rows of loads in flight.  x is staged per d-tile
//   in shared memory as f32, transposed, so one float4 read feeds four
//   rows' FMAs.  The warps' partial sums meet in shared memory in a fixed
//   order (the result does not depend on scheduling).  Plain IEEE f32
//   FMAs: no TF32.
//
// wgmma, TMA-fed w tiles and a split of d across CTAs for more parallelism
// at decode are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
// bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulation.
//
// The product is taken transposed, out[e]^T = w[e]^T x[e]^T, so the
// MMA's M is 16 output columns and its N the 8 rows of a row group: C is
// 8 at a decode step and 24 at a prefill, and N = 8 wastes nothing there.
// Each warp owns 16 of the CTA's 128 columns and every live row group,
// over all of d, so no cross-warp sum is needed.  (KT x 128) tiles of
// w[e] and (BC x KT) tiles of x[e] stream through a STAGES-deep ring of
// shared memory with cp.async (16-byte chunks, zero-filled past d and f);
// ldmatrix.trans turns a w tile, stored d-major, into the A operand and
// ldmatrix the x tile into the B operand.  Rows are padded by 16 bytes so
// that neither ldmatrix conflicts on a bank.  Needs f % 8 == 0, d % 8 == 0
// and 16-byte aligned x and w (the wrapper checks; otherwise the CUDA-core
// kernel above runs).
// ---------------------------------------------------------------------------

constexpr int KT = 32;             // d rows per pipeline stage
constexpr int STAGES = 4;
constexpr int WP = BF + 8;         // w tile pitch, bf16
constexpr int XP = KT + 8;         // x tile pitch, bf16
constexpr int RP = BF + 4;         // output staging pitch, f32

template <int BC>
__global__ void __launch_bounds__(NT)
grouped_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const int32_t* __restrict__ counts,
                          __nv_bfloat16* __restrict__ out, int c_len,
                          int d_len, int f_len) {
  constexpr int NG = BC / 8;                      // row groups (MMA N tiles)
  constexpr int W_ELEMS = KT * WP;
  constexpr int X_ELEMS = BC * XP;
  constexpr int STAGE = W_ELEMS + X_ELEMS;        // bf16 per stage
  static_assert(STAGES * STAGE * 2 >= BC * RP * 4,
                "output staging must fit in the pipeline's shared memory");
  __shared__ __align__(16) unsigned char smem_raw[STAGES * STAGE * 2];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int f0 = blockIdx.x * BF;
  const int r0 = blockIdx.y * BC;
  const int e = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int count = min(max(counts[e], 0), c_len);
  const int live = min(count - r0, BC);
  __nv_bfloat16* ob = out + static_cast<int64_t>(e) * c_len * f_len;

  if (live <= 0) {                                // w[e] is never read
    for (int idx = threadIdx.x; idx < BC * BF; idx += NT) {
      const int row = r0 + idx / BF;
      const int f = f0 + idx % BF;
      if (row < c_len && f < f_len)
        ob[static_cast<int64_t>(row) * f_len + f] = __float2bfloat16(0.f);
    }
    return;
  }

  const int groups = (live + 7) / 8;
  const __nv_bfloat16* wb = w + static_cast<int64_t>(e) * d_len * f_len;
  const __nv_bfloat16* xb =
      x + (static_cast<int64_t>(e) * c_len + r0) * d_len;
  const int nk = (d_len + KT - 1) / KT;

  // one stage: KT x BF of w (2 chunks of 16 bytes a thread) and BC x KT
  // of x (one chunk for the first BC * KT / 8 threads)
  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* sw = smem + stage * STAGE;
    __nv_bfloat16* sx = sw + W_ELEMS;
    const int d0 = kt * KT;
#pragma unroll
    for (int i = 0; i < KT * BF / 8 / NT; ++i) {
      const int ch = threadIdx.x + i * NT;
      const int row = ch / (BF / 8);
      const int col = (ch % (BF / 8)) * 8;
      const bool ok = d0 + row < d_len && f0 + col < f_len;
      const __nv_bfloat16* src =
          ok ? wb + static_cast<int64_t>(d0 + row) * f_len + f0 + col : wb;
      cp_async16(sw + row * WP + col, src, ok);
    }
    if (threadIdx.x < BC * KT / 8) {
      const int row = threadIdx.x / (KT / 8);
      const int col = (threadIdx.x % (KT / 8)) * 8;
      const bool ok = row < live && d0 + col < d_len;
      const __nv_bfloat16* src =
          ok ? xb + static_cast<int64_t>(row) * d_len + d0 + col : xb;
      cp_async16(sx + row * XP + col, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  float acc[NG][4];
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int wm = warp * 16;                       // this warp's columns
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // stage kt landed; stage kt - 1 consumed
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const __nv_bfloat16* sw = smem + (kt % STAGES) * STAGE;
    const __nv_bfloat16* sx = sw + W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // A = w^T (16 columns x 16 d): four 8x8 blocks, transposed
      const int q = lane >> 3;
      const int ar = kk * 16 + (q >> 1) * 8 + (lane & 7);
      const int ac = wm + (q & 1) * 8;
      unsigned a0, a1, a2, a3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0,%1,%2,%3}, [%4];\n"
          : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
          : "r"(smem_addr(sw + ar * WP + ac)));
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (j < groups) {
          // B = x^T (16 d x 8 rows): rows of x, two 8-wide d blocks
          const int br = j * 8 + (lane & 7);
          const int bc = kk * 16 + ((lane >> 3) & 1) * 8;
          unsigned b0, b1;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
              : "=r"(b0), "=r"(b1)
              : "r"(smem_addr(sx + br * XP + bc)));
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
              "{%0,%1,%2,%3};\n"
              : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                "+f"(acc[j][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // the pipeline's memory becomes the output's

  // acc[j]: (column wm + g (+8), row j*8 + 2t (+1)), g = lane/4, t = lane%4
  float* red = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    if (j < groups) {
      const int r = j * 8 + 2 * t;
      red[r * RP + wm + g] = acc[j][0];
      red[(r + 1) * RP + wm + g] = acc[j][1];
      red[r * RP + wm + g + 8] = acc[j][2];
      red[(r + 1) * RP + wm + g + 8] = acc[j][3];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BC * BF; idx += NT) {
    const int r = idx / BF;
    const int col = idx % BF;
    const int row = r0 + r;
    const int f = f0 + col;
    if (row < c_len && f < f_len)
      ob[static_cast<int64_t>(row) * f_len + f] =
          __float2bfloat16(r < live ? red[r * RP + col] : 0.f);
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

template <int BC>
void launch_mma(const void* x, const void* w, const int32_t* counts,
                void* out, int e, int c, int d, int f, cudaStream_t stream) {
  dim3 grid((f + BF - 1) / BF, (c + BC - 1) / BC, e);
  grouped_matmul_mma_kernel<BC><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), counts,
      static_cast<__nv_bfloat16*>(out), c, d, f);
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

void dispatch_mma(const void* x, const void* w, const int32_t* counts,
                  void* out, int e, int c, int d, int f, cudaStream_t s) {
  if (c <= 8)
    launch_mma<8>(x, w, counts, out, e, c, d, f, s);
  else if (c <= 16)
    launch_mma<16>(x, w, counts, out, e, c, d, f, s);
  else
    launch_mma<32>(x, w, counts, out, e, c, d, f, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  path: 0 = CUDA cores, one column at a time; 1 = CUDA cores,
// four columns a load (f % 4 == 0, w 16-byte aligned); 2 = bf16 on the
// tensor cores (f % 8 == 0, d % 8 == 0, x and w 16-byte aligned).  The
// wrapper checks what a path needs.  Returns cudaGetLastError() after the
// launch, or -1 for an unsupported dtype, path or shape.  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int grouped_matmul_launch(int dtype, const void* x, const void* w,
                                     const void* counts, void* out, int e,
                                     int c, int d, int f, int path,
                                     void* stream) {
  if (e <= 0 || e > 65535 || c <= 0 || (c + 31) / 32 > 65535 || d <= 0 ||
      f <= 0 || path < 0 || path > 2)
    return -1;
  const auto* cnt = static_cast<const int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (dtype != 1 || f % 8 != 0 || d % 8 != 0) return -1;
    dispatch_mma(x, w, cnt, out, e, c, d, f, s);
  } else if (dtype == 0) {
    dispatch_bc<float>(x, w, cnt, out, e, c, d, f, path == 1, s);
  } else if (dtype == 1) {
    dispatch_bc<__nv_bfloat16>(x, w, cnt, out, e, c, d, f, path == 1, s);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
