// Blocked causal (or non-causal) GQA attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::flash_attention.  On the port's path it is the
// ring layout's one-shot causal prefill (self_attention_prefill) and the
// forward of training's whole-sequence attention, where it also writes
// each query row's log-sum-exp for the backward (flash_attention_bwd.cu).
//
// What it computes: out[b, i, h] = softmax(q[b,i,h] . K_b^T / sqrt(dh)) . V_b
// over the keys of KV head h / G.  Causal: key j is valid for query i when
// j <= i, and with a window also j > i - window; non-causal: every key
// j < T.  kv_len is the real T (keys are never padded).  Scores, softmax
// and sums are f32; the output takes q's type.  A query row with no valid
// key (causal with a window and S > T only) is written as zeros.  No
// atomics: two calls give the same bits.
//
// Layouts are the model's, so nothing is transposed or padded:
//   q, out (B, S, H, dh)    element (b, i, h, d) at ((b*S + i)*H + h)*dh + d
//   k, v   (B, T, Hkv, dh)  element (b, j, h, d) at ((b*T + j)*Hkv + h)*dh + d
// G = H / Hkv is a run-time value.  dh is any multiple of 8 (past 256 in
// the column-block bodies of part 1); the scale is the caller's
// (1/sqrt(dh) of the real dh, which the wrapper keeps where it pads a dh
// that is not a multiple of 8 into a zero-filled copy).
//
// What bounds it: operations.  4 * dh per (query row, head, valid key) --
// about 8.6 GFLOP for S = T = 1024, H = 32, dh = 128 causal, 8.7 us at the
// card's 989 TFLOP/s bf16 -- against a few MB of q, k, v and out.  Pallas
// carried (m, l, acc) across a sequential grid axis; here one CTA owns
// (b, q head, a block of query rows) and loops over the key tiles itself,
// only from the first to the last tile that the causal and window masks
// leave live.  Two bodies, both in flash_fwd.cuh (templated on where a
// key row comes from: this file instantiates them on contiguous K/V,
// paged_flash_attention.cu on a page pool through block tables):
//
// * bf16: TMA, wgmma and warp specialisation, the design of the backward
//   (flash_attention_bwd.cu).  The work items are (query head, b, 128
//   query rows), the last query blocks (the heaviest under a causal mask)
//   first; a persistent grid of one CTA an SM walks them in a snake over
//   that order, so a CTA loads its next item's Q and first tiles while it
//   writes the last one's output.  Three warpgroups: two consumers of 64
//   rows each (setmaxnreg 232) and a producer (40) of which one thread
//   issues every load.  q is read through a (dh, H, S, B) tensor map, k
//   and v through (dh, Hkv, T, B) ones, in boxes of 64 columns of dh (128
//   bytes, the 128-byte swizzle), so the body is DH = 64 (one box; dh up
//   to 64), 128 (two; dh 72 to 128) or 256 (four; past 128): columns past
//   dh arrive as zeros from outside the dh dimension, never the next
//   head's, and rows past S or T as zeros, never the next batch's.  An
//   item's Q arrives once; K and V tiles of BN keys (128 up to DH 128, 64
//   at DH 256) stream through a K ring and a V ring of two slots each,
//   with full and empty mbarriers, so a K tile is released as soon as its
//   scores are done.  S = Q K^T is a wgmma from shared memory (both
//   K-major, N = BN); P is rounded to bf16 in the registers that hold S
//   and is the register A operand of O += P V (V an MN-major B, N = DH).
//   Per warpgroup the products of two tiles overlap the softmax: tile i's
//   S and tile i-1's P V are issued together, the softmax of S_i runs
//   while P V does, and O is rescaled once P V is done.  The two
//   warpgroups take turns at issuing their products (named barriers), so
//   one's softmax runs while the other's products do.  The online softmax
//   stays in registers (a row's 4 lanes meet with two shuffles), in exp2
//   (ex2.approx) with the scale folded with log2(e); the running max
//   starts at the finite NEG_INF, masked scores are -inf, and the rescale
//   takes exp2 of (m_old - m_new) * scale, exactly 1 while a row has seen
//   no valid key, so no NaN arises there.  Element masks apply only where
//   a warpgroup's tile is not wholly valid: the diagonal, window edges and
//   the ragged last tile; a warpgroup skips (releases unread) a tile none
//   of its rows needs.  Registers a thread: O takes DH / 2 f32, S BN / 2
//   and P BN / 4, so DH 256 (128 + 32 + 16) fits under 232 with 64-key
//   tiles.
// * f32: IEEE FMAs on the CUDA cores (the first port's body).  The f32
//   sweeps are held to 2e-5, which TF32 on the tensor cores cannot meet,
//   so f32 parity at full width still runs a kernel.  One CTA per (b, q
//   head, 64 query rows) loops over 32-key tiles (16 at DH 256) staged in
//   shared memory as f32; four threads share a query row, each holding
//   DH/4 of q and of the accumulator, interleaved by float4 so the four
//   read one 64-byte span of a shared K/V row.
//
// What still holds the bf16 body back (PERF.md §6): at a 1024-token
// prefill an item is 1 to 8 tiles, and its first product waits for its Q
// and first K tile, which the persistent walk hides only in part (the
// heaviest item alone takes most of such a call: the grid's critical
// path, not the card's throughput, bounds it); the
// first warpgroup computes the diagonal tile's second half of keys only
// to mask it; and at DH 256 the 64-key S reads as many operand bytes from
// shared memory per product as shared memory can deliver, and a
// 1024-token prefill of 16 heads is 128 items for 132 SMs.  The K/V reads
// from L2 are not the limit: clusters of two CTAs of one KV group, each
// loading half of every tile into both by TMA multicast, halved them and
// were slower at every shape they took (the pair's rings move in lock
// step).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_fwd.cuh"   // the bodies, shared with paged_flash_attention.cu

// A head past 256: the column-block bodies of part 1 (below).
extern "C" int flash_attention_wide(int dtype, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int batch, int s_len, int t_len, int h_q,
                                    int g, int dh, int causal, int window,
                                    float scale, cudaStream_t stream);

// The build compiles this file as two parts at once (kernels/build.py
// PARTS): the bodies up to DH 256 with the entry point, then the
// column-block bodies; without BUILD_PART it is whole.  Each part
// instantiates the contiguous (PAGED false) bodies it launches.
#if !defined(BUILD_PART) || BUILD_PART == 0
namespace {
// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int batch, int s_len, int t_len, int h_q,
                       int g, int dh, int causal, int window, float scale,
                       cudaStream_t stream) {
  dim3 grid((s_len + BQ - 1) / BQ, h_q, batch);
  flash_attention_kernel<float, DH, false><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s_len,
      t_len, h_q, g, dh, causal, window, scale, Paged{});
  return cudaGetLastError();
}
template <int DH>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int s_len, int t_len, int h_q, int g,
               int dh, int causal, int window, float scale,
               cudaStream_t stream) {
  using F = Fwd<DH>;
  const auto kernel = flash_fwd_tma_kernel<DH, false>;
  static bool smem_set = false;   // the attribute, once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int64_t items = static_cast<int64_t>(h_q) * batch
                        * ((s_len + CTA_ROWS - 1) / CTA_ROWS);
  if (items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(
      std::min<int64_t>(items, std::max(hopper::sm_count(), 1)));
  CUtensorMap qm, km, vm;
  if (!hopper::head_map(&qm, q, batch, s_len, h_q, dh, WG_ROWS) ||
      !hopper::head_map(&km, k, batch, t_len, h_q / g, dh, F::BN) ||
      !hopper::head_map(&vm, v, batch, t_len, h_q / g, dh, F::BN))
    return -2;
  kernel<<<grid, THREADS, F::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse, batch, s_len,
      t_len, h_q, g, dh, causal, window, scale * LOG2E, Paged{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (TMA + wgmma; row strides H dh and Hkv dh of 16
// bytes, which dh % 8 == 0 gives).  Any G = h_q / hkv (the kernels take
// it at run time) and any dh that is a multiple of 8: up to 256 on a
// fixed body with zero columns past dh (f32: the 32, 64, 128 or 256 wide
// one; bf16: the 64 wide one up to 64, then 128 and 256), past it in
// column blocks (the wrapper pads any other dh up to a multiple of 8,
// and passes the real dh's scale).
// lse, when not null, receives each query row's f32 natural log-sum-exp
// of its scaled scores, (B, H, S) at (b * H + h) * S + i, -inf for a row
// with no valid key: the backward (flash_attention_bwd.cu) recomputes P
// from it.  The serving callers pass null.  Returns the CUDA error of the
// launch (0 on success), -1 when the (dtype, dh, G) combination is not
// supported, -2 when the driver refuses a tensor map.  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch,
                                      int s_len, int t_len, int h_q, int hkv,
                                      int dh, int causal, int window,
                                      float scale, void* stream) {
  if (hkv <= 0 || h_q % hkv != 0 || s_len <= 0 || t_len <= 0) return -1;
  if ((dtype != 0 && dtype != 1) || dh % 8) return -1;
  const int g = h_q / hkv;
  auto st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (head_width(dh) == WIDE)
    return flash_attention_wide(dtype, q, k, v, out, lse_f, batch, s_len,
                                t_len, h_q, g, dh, causal, window, scale, st);
#define FLASH_ARGS q, k, v, out, lse_f, batch, s_len, t_len, h_q, g, dh, \
                   causal, window, scale, st
  if (dtype == 0) {
    switch (head_width(dh)) {
      case 32: return static_cast<int>(launch_f32<32>(FLASH_ARGS));
      case 64: return static_cast<int>(launch_f32<64>(FLASH_ARGS));
      case 128: return static_cast<int>(launch_f32<128>(FLASH_ARGS));
      case 256: return static_cast<int>(launch_f32<256>(FLASH_ARGS));
      default: return -1;
    }
  }
  switch (head_width(dh)) {
    case 32:
    case 64: return launch_tma<64>(FLASH_ARGS);
    case 128: return launch_tma<128>(FLASH_ARGS);
    case 256: return launch_tma<256>(FLASH_ARGS);
    default: return -1;
  }
#undef FLASH_ARGS
}
#endif  // part 0

#if !defined(BUILD_PART) || BUILD_PART == 1
extern "C" int flash_attention_wide(int dtype, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int batch, int s_len, int t_len, int h_q,
                                    int g, int dh, int causal, int window,
                                    float scale, cudaStream_t stream) {
  const int nvb = dtype == 0 ? (dh + WF_DB - 1) / WF_DB
                             : (dh + W_DB - 1) / W_DB;
  const int blocks = (s_len + W_BQ - 1) / W_BQ;
  if (batch > 65535 || blocks > 65535 ||
      static_cast<int64_t>(h_q) * nvb > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(h_q * nvb, batch, blocks);
  if (dtype == 0) {
    flash_wide_f32_kernel<float, false><<<grid, WF_NT, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, s_len,
        t_len, h_q, g, dh, causal, window, scale, Paged{});
  } else {
    static bool smem_set = false;   // the attribute, once
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_wide_mma_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          W_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = true;
    }
    flash_wide_mma_kernel<false><<<grid, W_NT, W_SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, s_len, t_len, h_q, g, dh,
        causal, window, scale * LOG2E, Paged{});
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // part 1
