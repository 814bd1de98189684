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
//
// What bounds it: bytes.  dX reads the live experts' weights once (a row
// block past counts[e] never reads w[e], as the forward skips it) and dOut;
// dW writes E * d * f.  At arctic-480b's training shape (E 128, C 88, d
// 7168, f 4864) each is 8.9 GB of bf16, about 2.7 ms at 3.35 TB/s, against
// 0.8 ms of bf16 tensor-core work.
//
// Two deterministic kernels a product, no atomics (every sum inside one CTA
// in a fixed order), so two runs give the same bits:
// * bf16 with d and f multiples of 8 and 16-byte aligned rows: mma.sync
//   m16n8k16 (bf16 operands, f32 accumulators; the fragment layouts of
//   hopper.cuh), tiles double-buffered through cp.async.
//   - dX: one CTA (4 warps) per (expert, 64 columns of d, 128 rows of C).
//     w is read in its stored (E, d, f) layout as the transposed operand:
//     a row of w[e] is a K-major column of w[e]^T, so both operands load
//     with plain ldmatrix and no transposed copy of the experts exists (it
//     would be 8.9 GB a product at arctic).  Each warp owns 16 columns and
//     the live 16-row tiles of the block; 128 rows cover C = 88 in one
//     block, so w[e] is read once.
//   - dW: one CTA per (expert, 64 rows of d, 128 columns of f), walking the
//     live rows of C 32 at a time (C = 88 at arctic's B 1 x S 4096, so no
//     split of C is needed); x and dOut tiles are C-major, loaded as
//     fragments through ldmatrix.trans.
// * otherwise (f32, or widths that are not multiples of 8): IEEE f32 FMAs
//   on the CUDA cores (no TF32: the f32 band of 2e-5 is beyond it), 64 x 64
//   output tiles, the reduction staged 16 deep, 4 x 4 outputs a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_NT = 128;       // 4 warps
constexpr int DX_ROWS = 128;     // rows of C a dX CTA covers
constexpr int DX_COLS = 64;      // columns of d a dX CTA covers
constexpr int DW_ROWS = 64;      // rows of d a dW CTA covers
constexpr int DW_COLS = 128;     // columns of f a dW CTA covers
constexpr int KS = 32;           // reduction depth a stage holds
constexpr int PK = KS + 8;       // padded row of a K-major stage (80 bytes)
constexpr int PX = DW_ROWS + 8;  // padded row of a dW x stage (144 bytes)
constexpr int PG = DW_COLS + 8;  // padded row of a dW dOut stage (272 bytes)

__device__ __forceinline__ int live_rows(const int* counts, int e, int c) {
  return min(max(counts[e], 0), c);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<unsigned*>(p) = hopper::pack_bf16x2(a, b);
}

// dX (E, C, d) = dOut (E, C, f) w^T over the live rows.  grid (d / 64, C /
// 128, E).
__global__ void __launch_bounds__(TC_NT)
gm_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ dout,
                     const __nv_bfloat16* __restrict__ w,
                     const int* __restrict__ counts,
                     __nv_bfloat16* __restrict__ dx, int c, int d, int f) {
  __shared__ __align__(16) __nv_bfloat16 as[2][DX_ROWS][PK];
  __shared__ __align__(16) __nv_bfloat16 bs[2][DX_COLS][PK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * DX_ROWS, n0 = blockIdx.x * DX_COLS;
  const int live = min(live_rows(counts, e, c) - m0, DX_ROWS);
  const int gq = lane >> 2, tq = lane & 3;
  __nv_bfloat16* out = dx + static_cast<int64_t>(e) * c * d;
  if (live <= 0) {               // no live row: zeros, and w is not read
    for (int idx = tid; idx < DX_ROWS * DX_COLS / 2; idx += TC_NT) {
      const int r = m0 + idx / (DX_COLS / 2);
      const int col = n0 + idx % (DX_COLS / 2) * 2;
      if (r < c && col < d)
        store_bf16x2(out + static_cast<int64_t>(r) * d + col, 0.f, 0.f);
    }
    return;
  }
  const int live_mt = (live + 15) / 16;
  const __nv_bfloat16* gsrc = dout + (static_cast<int64_t>(e) * c + m0) * f;
  const __nv_bfloat16* wsrc = w + (static_cast<int64_t>(e) * d + n0) * f;
  auto load = [&](int st, int k0) {
    for (int idx = tid; idx < live_mt * 16 * (KS / 8); idx += TC_NT) {
      const int r = idx / (KS / 8), col = k0 + idx % (KS / 8) * 8;
      const bool ok = r < live && col < f;
      cp_async16(&as[st][r][idx % (KS / 8) * 8],
                 ok ? gsrc + static_cast<int64_t>(r) * f + col : gsrc, ok);
    }
    for (int idx = tid; idx < DX_COLS * (KS / 8); idx += TC_NT) {
      const int r = idx / (KS / 8), col = k0 + idx % (KS / 8) * 8;
      const bool ok = n0 + r < d && col < f;
      cp_async16(&bs[st][r][idx % (KS / 8) * 8],
                 ok ? wsrc + static_cast<int64_t>(r) * f + col : wsrc, ok);
    }
  };
  float acc[DX_ROWS / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < DX_ROWS / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  const int nk = (f + KS - 1) / KS;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load((kc + 1) & 1, (kc + 1) * KS);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = kc & 1;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      unsigned fb[4];
      // w rows (columns of dX) 16 warp .. + 15, f kk*16 .. + 15
      hopper::ldmatrix_x4(fb, &bs[st][warp * 16 + (lane & 7)
                                      + ((lane >> 4) << 3)]
                                     [kk * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int mt = 0; mt < DX_ROWS / 16; ++mt) {
        if (mt < live_mt) {      // uniform over the CTA
          unsigned a[4];
          hopper::ldmatrix_x4(a, &as[st][mt * 16 + (lane & 15)]
                                        [kk * 16 + (lane >> 4) * 8]);
          hopper::mma_bf16(acc[mt][0], a, fb[0], fb[1]);
          hopper::mma_bf16(acc[mt][1], a, fb[2], fb[3]);
        }
      }
    }
    __syncthreads();
  }
  // rows past the live ones were loaded as zeros (or not computed): zeros
#pragma unroll
  for (int mt = 0; mt < DX_ROWS / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp * 16 + j * 8 + 2 * tq;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int r = m0 + mt * 16 + gq + 8 * hlf;
        if (r < c && col < d)
          store_bf16x2(out + static_cast<int64_t>(r) * d + col,
                       acc[mt][j][2 * hlf], acc[mt][j][2 * hlf + 1]);
      }
    }
}

// dW (E, d, f) = x^T dOut over the live rows of C.  grid (f / 128, d / 64,
// E).
__global__ void __launch_bounds__(TC_NT)
gm_bwd_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ counts,
                     __nv_bfloat16* __restrict__ dw, int c, int d, int f) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][KS][PX];
  __shared__ __align__(16) __nv_bfloat16 gs[2][KS][PG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * DW_ROWS, n0 = blockIdx.x * DW_COLS;
  const int live = live_rows(counts, e, c);
  const int gq = lane >> 2, tq = lane & 3;
  __nv_bfloat16* out = dw + static_cast<int64_t>(e) * d * f;
  float acc[DW_COLS / 8][4];
#pragma unroll
  for (int j = 0; j < DW_COLS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const __nv_bfloat16* xsrc = x + static_cast<int64_t>(e) * c * d;
  const __nv_bfloat16* gsrc = dout + static_cast<int64_t>(e) * c * f;
  auto load = [&](int st, int k0) {
    for (int idx = tid; idx < KS * (DW_ROWS / 8); idx += TC_NT) {
      const int r = idx / (DW_ROWS / 8), v = idx % (DW_ROWS / 8) * 8;
      const bool ok = k0 + r < live && m0 + v < d;
      cp_async16(&xs[st][r][v], ok ? xsrc + static_cast<int64_t>(k0 + r) * d
                                         + m0 + v
                                   : xsrc, ok);
    }
    for (int idx = tid; idx < KS * (DW_COLS / 8); idx += TC_NT) {
      const int r = idx / (DW_COLS / 8), v = idx % (DW_COLS / 8) * 8;
      const bool ok = k0 + r < live && n0 + v < f;
      cp_async16(&gs[st][r][v], ok ? gsrc + static_cast<int64_t>(k0 + r) * f
                                         + n0 + v
                                   : gsrc, ok);
    }
  };
  const int nk = (live + KS - 1) / KS;   // 0 for an expert no token chose
  if (nk > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load((kc + 1) & 1, (kc + 1) * KS);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = kc & 1;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      unsigned a[4];
      // A = x^T: rows of d 16 warp .. + 15 (contiguous in the stage),
      // C rows kk*16 .. + 15 down the stage
      hopper::ldmatrix_x4_trans(a, &xs[st][kk * 16 + (lane & 7)
                                           + (lane >> 4) * 8]
                                          [warp * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int jp = 0; jp < DW_COLS / 16; ++jp) {
        unsigned fb[4];
        hopper::ldmatrix_x4_trans(fb, &gs[st][kk * 16 + (lane & 7)
                                              + ((lane >> 3) & 1) * 8]
                                             [jp * 16 + (lane >> 4) * 8]);
        hopper::mma_bf16(acc[2 * jp], a, fb[0], fb[1]);
        hopper::mma_bf16(acc[2 * jp + 1], a, fb[2], fb[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < DW_COLS / 8; ++j) {
    const int col = n0 + j * 8 + 2 * tq;
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int r = m0 + warp * 16 + gq + 8 * hlf;
      if (r < d && col < f)
        store_bf16x2(out + static_cast<int64_t>(r) * f + col,
                     acc[j][2 * hlf], acc[j][2 * hlf + 1]);
    }
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

cudaError_t launch_mma(const void* x, const void* w, const int* counts,
                       const void* dout, void* dx, void* dw, int e, int c,
                       int d, int f, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (dx != nullptr) {
    gm_bwd_dx_mma_kernel<<<dim3((d + DX_COLS - 1) / DX_COLS,
                                (c + DX_ROWS - 1) / DX_ROWS, e),
                           TC_NT, 0, s>>>(static_cast<const bf*>(dout),
                                          static_cast<const bf*>(w), counts,
                                          static_cast<bf*>(dx), c, d, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr)
    gm_bwd_dw_mma_kernel<<<dim3((f + DW_COLS - 1) / DW_COLS,
                                (d + DW_ROWS - 1) / DW_ROWS, e),
                           TC_NT, 0, s>>>(static_cast<const bf*>(x),
                                          static_cast<const bf*>(dout),
                                          counts, static_cast<bf*>(dw), c, d,
                                          f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes: dX and/or dW (either output
// pointer may be null: that gradient is not computed) on `stream`.
// dtype: 0 = float32, 1 = bfloat16 (x, w, dout, dx, dw); counts (E,) int32
// on the device.  tensor_cores: 1 takes the mma.sync kernels (bf16, d and f
// multiples of 8, 16-byte aligned x, w and dout; the wrapper checks), 0 the
// CUDA-core ones.  Returns the CUDA error of the launches (0 on success),
// or -1 for sizes out of range.  Nothing is allocated and nothing
// synchronises.
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
    err = launch_mma(x, w, cnt, dout, dx, dw, e, c, d, f, s);
  else if (dtype == 0)
    err = launch_cores<float>(x, w, cnt, dout, dx, dw, e, c, d, f, s);
  else if (dtype == 1)
    err = launch_cores<__nv_bfloat16>(x, w, cnt, dout, dx, dw, e, c, d, f,
                                      s);
  else
    return -1;
  return static_cast<int>(err);
}
