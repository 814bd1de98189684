// The log-sum-exp combine of a sequence-sharded ring's partial attention,
// for NVIDIA Hopper (sm_90a).
//
// Port-side: no Pallas kernel of the reference computes it.  The
// reference shards a ring KV cache's sequence axis over a mesh axis
// (repro/distributed/sharding.py::cache_pspecs: the GQA fallback over
// `model`, and `long_*` over `data`) and GSPMD reduces the softmax across
// the shards; the port's ranks each attend over their own slots with the
// ring decode kernel (decode_attention.cu, with its log-sum-exp) and
// gather the partial results, which this kernel combines: mesh-level
// flash-decoding.
//
// What it computes: R ranks' partial outputs of the same query rows,
// each normalised over its own keys, and their natural log-sum-exps of
// the scaled scores:
//   out[b, h] = sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M),
// M the largest lse_r.  A rank whose range held no valid key (lse =
// NEG_INF) weighs 0, and a row empty on every rank comes out as zeros, as
// the decode kernels write such a row.  The sums are f32; the output
// takes the inputs' dtype.
//
// Layouts: outs (R, B, H, dh), lses (R, B, H) f32, out (B, H, dh), all
// contiguous.  One CTA per (b, h) row, one thread per element of dh: the
// merge of common.cuh (merge_parts) with ranks in place of the split-KV
// decode's splits, each rank a part with m = lse * log2(e), l = 1 and acc
// its normalised output.
//
// What bounds it: the bytes, R * B * H * (dh * sizeof(T) + 4) read and
// B * H * dh * sizeof(T) written, against 3.35 TB/s of HBM; about 4 R dh
// operations a row.  At a decode step it is a few hundred kilobytes, so
// its time is the launch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// a rank's log-sum-exp at or below this held no valid key (NEG_INF)
constexpr float EMPTY_LSE = 0.5f * NEG_INF;

template <typename T>
__global__ void combine_kernel(const T* __restrict__ outs,
                               const float* __restrict__ lses,
                               T* __restrict__ out, int ranks, int64_t rows,
                               int dh) {
  const int64_t row = blockIdx.x;
  merge_parts(
      ranks, dh,
      [=](int r) {
        const float l = lses[r * rows + row];
        return l > EMPTY_LSE ? make_float2(l * LOG2E, 1.f)
                             : make_float2(NEG_INF, 0.f);
      },
      [=](int r, int d) { return load_one(outs + (r * rows + row) * dh + d); },
      out + row * dh, nullptr);
}

template <typename T>
int launch(const void* outs, const float* lses, void* out, int ranks,
           int64_t rows, int dh, cudaStream_t stream) {
  const int threads = dh < 256 ? (dh + 31) / 32 * 32 : 256;
  combine_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(outs), lses, static_cast<T*>(out), ranks, rows,
      dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  rows = B * H.  Returns the CUDA error of the launch (0 on
// success), or -1 for a dtype or shape out of range.  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int attention_combine_launch(int dtype, const void* outs,
                                        const void* lses, void* out,
                                        int ranks, long long rows, int dh,
                                        void* stream) {
  if (ranks <= 0 || rows <= 0 || rows > 0x7fffffffLL || dh <= 0)
    return -1;
  const float* l = static_cast<const float*>(lses);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(outs, l, out, ranks, rows, dh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(outs, l, out, ranks, rows, dh, s);
  return -1;
}
