// Paged flash attention for NVIDIA Hopper (sm_90a): suffix prefill and the
// mixed step's chunk, attending over the shared page pool through block
// tables.
//
// Replaces no Pallas kernel: the reference computes this attention with
// jnp (src/repro/models/attention.py::self_attention_paged, Sq > 1:
// paged_view + attention_cached), a gather of every sequence's whole
// block table into a contiguous view, then masked f32 scores over it.
// Port-side, as attention_combine.cu: the port reads cfg.use_pallas as
// "use the hand-written kernels", and this is the one attention call of
// the paged path that had none.
//
// What it computes: out[b, i, h] = softmax_j(q[b,i,h] . k_j / sqrt(dh)) .
// v_j over keys j in [0, P * page) of KV head h / G, key j read from slot
// j % page of pool page block_tables[b][j / page], valid when that entry
// is mapped (>= 0), j <= q_pos[b][i] and, with a window, j > q_pos[b][i] -
// window.  Scores, softmax and sums are f32; the output takes q's type.
// A row with no valid key (q_pos -1: the mixed chunk's pad tail) is
// written as zeros.  No atomics: two calls give the same bits.
//
// Layouts are the model's, read in place (nothing is gathered, copied or
// padded, whatever dh is):
//   q, out          (B, S, H, dh)
//   k_pages, v_pages (num_pages + 1, page, Hkv, dh), the sink page last
//   block_tables    (B, P) int32; q_pos (B, S) int32
//
// What bounds it: operations, 4 * dh per valid (query row, head, key) --
// agent-7b's mixed chunk, 512 rows at start 1024 over 32 heads of 128,
// is ~10.7 GFLOP, 11 us at 989 TFLOP/s bf16, against ~6 MB of K/V.  The
// bodies are flash_attention.cu's (flash_fwd.cuh), instantiated with the
// keys read through the table (PAGED):
// * bf16, dh a multiple of 8 up to 256, pages a multiple of 8: the TMA +
//   wgmma body, K/V boxes of gcd(page, BN) rows at (column, head, slot,
//   page id) of (dh, Hkv, page, num_pages + 1) tensor maps of the pools;
// * f32, or bf16 that the TMA body cannot take (a dh or a page not a
//   multiple of 8): the CUDA-core body, rows through the table;
// * dh past 256: the column-block bodies (bf16 on mma.sync where dh is a
//   multiple of 8, else the CUDA-core one in T).
// An item's (CTA's) tiles run from its live rows' lowest position, less
// the window, to their highest, read on the device, so the mixed step's
// captured graph replays the launch for any chunk start and fill.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_fwd.cuh"

// The bodies of parts 1 and 2 (below), called by part 0's entry point
// with the table's fields (a Paged of each part's own).
#define PAGED_PARAMS const int *table, const int *q_pos, int p_max, int page, \
                     int sink
extern "C" int paged_flash_cores(int dtype, const void* q, const void* k,
                                 const void* v, void* out, int batch,
                                 int s_len, int t_len, int h_q, int g,
                                 int dh, int window, float scale,
                                 PAGED_PARAMS, cudaStream_t stream);
extern "C" int paged_flash_wide(int dtype, const void* q, const void* k,
                                const void* v, void* out, int batch,
                                int s_len, int t_len, int h_q, int g, int dh,
                                int window, float scale, PAGED_PARAMS,
                                cudaStream_t stream);

// The build compiles this file as three parts at once (kernels/build.py
// PARTS): the TMA bodies with the entry point, the CUDA-core bodies, the
// column-block bodies; without BUILD_PART it is whole.
#if !defined(BUILD_PART) || BUILD_PART == 0
namespace {

template <int DH>
int launch_paged_tma(const void* q, const void* k, const void* v, void* out,
                     int batch, int s_len, int t_len, int h_q, int g,
                     int dh, int n_pool, int window, float scale, Paged pk,
                     cudaStream_t stream) {
  using F = Fwd<DH>;
  const auto kernel = flash_fwd_tma_kernel<DH, true>;
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
  // a box's rows: the largest power of two dividing both page and BN
  const int rows = std::min(pk.page & -pk.page, F::BN);
  pk.box_shift = __builtin_ctz(rows);
  CUtensorMap qm, km, vm;
  if (!hopper::head_map(&qm, q, batch, s_len, h_q, dh, WG_ROWS) ||
      !hopper::head_map(&km, k, n_pool, pk.page, h_q / g, dh, rows) ||
      !hopper::head_map(&vm, v, n_pool, pk.page, h_q / g, dh, rows))
    return -2;
  kernel<<<grid, THREADS, F::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), nullptr, batch, s_len,
      t_len, h_q, g, dh, 1, window, scale * LOG2E, pk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  Any G = h_q / hkv, any dh >= 1, any page >= 1; block_tables
// (B, p_max) and q_pos (B, S) int32 on the device.  Returns the CUDA
// error of the launch (0 on success), -1 for arguments no body takes, -2
// when cuTensorMapEncodeTiled refuses a tensor map.  Asynchronous on
// `stream`; allocates nothing.
extern "C" int paged_flash_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* q_pos, void* out, int batch,
    int s_len, int h_q, int hkv, int dh, int page, int p_max, int n_pool,
    int window, float scale, void* stream) {
  if (hkv <= 0 || h_q % hkv != 0 || s_len <= 0 || batch <= 0 || dh <= 0 ||
      page <= 0 || p_max <= 0 || n_pool <= 0 || (dtype != 0 && dtype != 1))
    return -1;
  if (static_cast<int64_t>(p_max) * page > 0x7fffffffLL) return -1;
  const int g = h_q / hkv;
  const int t_len = p_max * page;
  auto st = static_cast<cudaStream_t>(stream);
  const Paged pk{static_cast<const int*>(block_tables),
                 static_cast<const int*>(q_pos), p_max, page, n_pool - 1, 0};
  if (dh > 256)
    return paged_flash_wide(dtype, q, k_pages, v_pages, out, batch, s_len,
                            t_len, h_q, g, dh, window, scale, pk.table,
                            pk.q_pos, p_max, page, pk.sink, st);
  if (dtype == 0 || dh % 8 || page % 8)
    return paged_flash_cores(dtype, q, k_pages, v_pages, out, batch, s_len,
                             t_len, h_q, g, dh, window, scale, pk.table,
                             pk.q_pos, p_max, page, pk.sink, st);
#define PAGED_ARGS q, k_pages, v_pages, out, batch, s_len, t_len, h_q, g, \
                   dh, n_pool, window, scale, pk, st
  switch (head_width(dh)) {
    case 32:
    case 64: return launch_paged_tma<64>(PAGED_ARGS);
    case 128: return launch_paged_tma<128>(PAGED_ARGS);
    case 256: return launch_paged_tma<256>(PAGED_ARGS);
    default: return -1;
  }
#undef PAGED_ARGS
}
#endif  // part 0

#if !defined(BUILD_PART) || BUILD_PART == 1
namespace {

template <typename T, int DH>
cudaError_t launch_paged_cores(const void* q, const void* k, const void* v,
                               void* out, int batch, int s_len, int t_len,
                               int h_q, int g, int dh, int window,
                               float scale, Paged pk, cudaStream_t stream) {
  if (batch > 65535 || h_q > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((s_len + BQ - 1) / BQ, h_q, batch);
  flash_attention_kernel<T, DH, true><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nullptr, s_len, t_len,
      h_q, g, dh, 1, window, scale, pk);
  return cudaGetLastError();
}

template <typename T>
int cores_at(int dh, const void* q, const void* k, const void* v, void* out,
             int batch, int s_len, int t_len, int h_q, int g, int window,
             float scale, Paged pk, cudaStream_t stream) {
#define CORE_ARGS q, k, v, out, batch, s_len, t_len, h_q, g, dh, window, \
                  scale, pk, stream
  switch (head_width(dh)) {
    case 32: return static_cast<int>(launch_paged_cores<T, 32>(CORE_ARGS));
    case 64: return static_cast<int>(launch_paged_cores<T, 64>(CORE_ARGS));
    case 128: return static_cast<int>(launch_paged_cores<T, 128>(CORE_ARGS));
    case 256: return static_cast<int>(launch_paged_cores<T, 256>(CORE_ARGS));
    default: return -1;
  }
#undef CORE_ARGS
}

}  // namespace

extern "C" int paged_flash_cores(int dtype, const void* q, const void* k,
                                 const void* v, void* out, int batch,
                                 int s_len, int t_len, int h_q, int g,
                                 int dh, int window, float scale,
                                 PAGED_PARAMS, cudaStream_t stream) {
  const Paged pk{table, q_pos, p_max, page, sink, 0};
  return dtype == 0
             ? cores_at<float>(dh, q, k, v, out, batch, s_len, t_len, h_q, g,
                               window, scale, pk, stream)
             : cores_at<__nv_bfloat16>(dh, q, k, v, out, batch, s_len, t_len,
                                       h_q, g, window, scale, pk, stream);
}
#endif  // part 1

#if !defined(BUILD_PART) || BUILD_PART == 2
extern "C" int paged_flash_wide(int dtype, const void* q, const void* k,
                                const void* v, void* out, int batch,
                                int s_len, int t_len, int h_q, int g, int dh,
                                int window, float scale, PAGED_PARAMS,
                                cudaStream_t stream) {
  const Paged pk{table, q_pos, p_max, page, sink, 0};
  // bf16 on mma.sync takes 16-byte rows; f32 and any other bf16 head the
  // CUDA-core column blocks
  const bool mma = dtype == 1 && dh % 8 == 0;
  const int nvb = mma ? (dh + W_DB - 1) / W_DB : (dh + WF_DB - 1) / WF_DB;
  const int blocks = (s_len + W_BQ - 1) / W_BQ;
  if (batch > 65535 || blocks > 65535 ||
      static_cast<int64_t>(h_q) * nvb > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(h_q * nvb, batch, blocks);
  if (mma) {
    static bool smem_set = false;   // the attribute, once
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_wide_mma_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = true;
    }
    flash_wide_mma_kernel<true><<<grid, W_NT, W_SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), nullptr, s_len, t_len, h_q, g, dh,
        1, window, scale * LOG2E, pk);
  } else if (dtype == 0) {
    flash_wide_f32_kernel<float, true><<<grid, WF_NT, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), nullptr,
        s_len, t_len, h_q, g, dh, 1, window, scale, pk);
  } else {
    flash_wide_f32_kernel<__nv_bfloat16, true><<<grid, WF_NT, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), nullptr, s_len, t_len, h_q, g, dh,
        1, window, scale, pk);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // part 2
