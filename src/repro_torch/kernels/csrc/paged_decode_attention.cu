// Paged decode attention for NVIDIA Hopper (sm_90a), split-KV over page
// ranges.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention / _kernel), reached through the model-layout
// wrapper src/repro/kernels/ops.py::paged_decode_attention.
//
// What it computes: one query token per sequence attends over a shared KV
// page pool through a block table.  out[b, h] = softmax(q[b,h] . K_b^T /
// sqrt(dh)) . V_b, where K_b / V_b are the pages bt[b, 0..P) in logical
// order and h runs over the GQA group of KV head h / G.  Valid keys are
// kpos < ctx[b] (and kpos >= ctx[b] - window with a window).  A -1 table
// entry is read as page 0 and masked by position only, as the reference
// does.  f32 arithmetic throughout, NEG_INF = -1e30; a row with no valid
// key (an inactive slot, ctx 0) is written as zeros.
//
// Layouts are the model's, so no transpose of the pool is ever made and
// nothing is padded:
//   q    (B, 1, Hkv*G, dh)           out (B, 1, Hkv*G, dh)
//   pool (Npool, page, Hkv, dh)      element (p, s, h, d) at
//                                    ((p*page + s)*Hkv + h)*dh + d
//   bt   (B, P) int32, ctx (B,) int32
// dh is any from 1 and G any (the split-KV core in common.cuh: a dh that
// is not a multiple of 8 loads element by element; a dh past 256 runs in
// column blocks of 256, one CTA a block, paged_wide_kernel).  A page of
// 128 rows holds 64 KB a KV head at dh 256 in bf16.
//
// What bounds it: the bytes of K and V of the valid keys, 2 * keys * Hkv
// * dh * sizeof(T) per sequence, against 3.35 TB/s of HBM.  The
// arithmetic is 4 * G * dh operations per key and head, far below the
// card's rates, so the kernel has to keep enough loads in flight on every
// SM.  One CTA per (sequence, KV head), the first design, gave 64 CTAs
// for 132 SMs at the serve shapes, each walking its whole context alone
// (0.41 ms where the bytes need 0.023).  This design is the ring decode
// kernel's (decode_attention.cu), over pages:
//
// * Split-KV over page ranges.  The grid is (splits, Hkv x group chunks,
//   B): each CTA takes pages_per_split consecutive entries of its row's
//   table, as the wrapper's planner chooses them from the shapes alone
//   (paged_decode_splits in paged_decode_attention.py: no host sync, and
//   static under a CUDA graph), enough for about four CTAs per SM at the
//   serve shapes.  It reads ctx[b] first: a range wholly at or past
//   ctx[b], or wholly before ctx[b] - window, writes (m, l) = (NEG_INF, 0)
//   and exits.  A live range loads its page ids into shared memory once
//   and walks only its valid keys, a contiguous run, which its warps cut
//   into four contiguous parts.
// * The shared split-KV core (common.cuh) does the rest: 16-byte loads
//   of K and V rows, several rows in flight per lane, each row shared by
//   the whole GQA group (or group chunk: from G = 6 on, CTAs of at most 4
//   heads), shuffles over a row's lanes, an online softmax in exp2
//   units, then the warps' merge in shared memory.  dh below the
//   instantiated width (112 and 120 on the 128 one) leaves tail lanes
//   idle.  The partial states go to an f32 scratch that the wrapper
//   allocates and split_merge_kernel folds into out on the same stream;
//   with one split the CTA writes out itself and no merge is launched.
//
// wgmma and TMA would not pay for 4 * G * dh operations a key.  Later
// work: ranges planned from the live context (most ranges of a short
// context are empty and exit at once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// The launch arguments: outside the anonymous namespace, so the two
// parts of the build (kernels/build.py PARTS) share the one type.
struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* bt;
  const int32_t* ctx;
  void* out;
  float* part_acc;
  float2* part_ml;
  int batch, hkv, g, dh, page, p_max, n_pool, splits, pages_per_split,
      window;
  float scale_log2;
  cudaStream_t stream;
};

namespace {

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int MAX_PAGES = 256;               // most pages a CTA takes


// One CTA: query heads row0 .. row0 + G - 1 (a group chunk of KV head h)
// of sequence b over table entries [p0, p0 + pages_per_split) of its row.
template <typename T, int DH, int G, bool NARROW>
__global__ void __launch_bounds__(NT) paged_split_kernel(PagedArgs a) {
  __shared__ int pids[MAX_PAGES];
  __shared__ DecodeSmem<DH, G, NWARPS> sm;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int split = blockIdx.x;
  const int chunks = (a.g + G - 1) / G;
  const int h = blockIdx.y / chunks;
  const int c0 = (blockIdx.y % chunks) * G;  // the chunk's first head
  const int heads = min(G, a.g - c0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = (static_cast<int64_t>(b) * a.hkv + h) * a.g
                       + c0;

  // this range's valid keys: [s0, s1).  They never pass the table's
  // mapped width, so no row reads beyond its table.
  const int c = a.ctx[b];
  const int hi = min(c, a.p_max * a.page);
  const int lo = a.window > 0 ? max(c - a.window, 0) : 0;
  const int p0 = split * a.pages_per_split;
  const int s0 = max(p0 * a.page, lo);
  const int s1 = min((p0 + a.pages_per_split) * a.page, hi);
  if (s0 >= s1) {                          // uniform across the CTA
    decode_empty(heads, a.dh, out, a.part_ml, nullptr, row0, split,
                 a.splits);
    return;
  }

  // the page ids of the pages holding [s0, s1), once.  -1 reads page 0
  // (masked by position only, as the reference); an id past the pool is
  // clamped rather than read out of bounds.
  const int pa = s0 / a.page;
  const int32_t* bt_b = a.bt + static_cast<int64_t>(b) * a.p_max;
  for (int i = threadIdx.x; i <= (s1 - 1) / a.page - pa; i += NT)
    pids[i] = min(max(bt_b[pa + i], 0), a.n_pool - 1);
  __syncthreads();

  DecodeState<T, DH, G> st;
  decode_begin<T, DH, G, NARROW>(st, q, row0, heads, a.dh, a.scale_log2);
  // the warps take four contiguous parts of the range
  const int per = (s1 - s0 + NWARPS - 1) / NWARPS;
  const int w0 = s0 + warp * per;
  const int n = max(min(per, s1 - w0), 0);
  const int64_t rs = static_cast<int64_t>(a.hkv) * a.dh;  // a slot's stride
  const int64_t head = static_cast<int64_t>(h) * a.dh;
  const int page = a.page;
  const int* pid = pids;
  decode_rows<T, DH, G, NARROW>(
      st, k + head, v + head, n, a.dh, [=](int j) {
        const int t = w0 + j;
        return (static_cast<int64_t>(pid[t / page - pa]) * page + t % page)
               * rs;
      });
  decode_end(st, sm, heads, a.dh, out, a.part_acc, a.part_ml, nullptr, row0,
             split, a.splits);
}

// The wide body (common.cuh, WIDE): one CTA per (split, column block of
// 256, group chunk, sequence), the chunk's q rows in dynamic shared
// memory; otherwise paged_split_kernel.
template <typename T, int G>
__global__ void __launch_bounds__(NT) paged_wide_kernel(PagedArgs a) {
  __shared__ int pids[MAX_PAGES];
  __shared__ DecodeSmem<WIDE_COLS, G, NWARPS> sm;
  extern __shared__ __align__(16) float qs[];
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int split = blockIdx.x;
  const int chunks = (a.g + G - 1) / G;
  const int ncb = (a.dh + WIDE_COLS - 1) / WIDE_COLS;
  const int cb = blockIdx.y % ncb;           // the CTA's column block
  const int hc = blockIdx.y / ncb;
  const int h = hc / chunks;
  const int c0 = (hc % chunks) * G;
  const int heads = min(G, a.g - c0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = (static_cast<int64_t>(b) * a.hkv + h) * a.g + c0;

  const int c = a.ctx[b];
  const int hi = min(c, a.p_max * a.page);
  const int lo = a.window > 0 ? max(c - a.window, 0) : 0;
  const int p0 = split * a.pages_per_split;
  const int s0 = max(p0 * a.page, lo);
  const int s1 = min((p0 + a.pages_per_split) * a.page, hi);
  if (s0 >= s1) {
    decode_empty<true>(heads, a.dh, out, a.part_ml, nullptr, row0, split,
                       a.splits, cb * WIDE_COLS);
    return;
  }

  const int pa = s0 / a.page;
  const int32_t* bt_b = a.bt + static_cast<int64_t>(b) * a.p_max;
  for (int i = threadIdx.x; i <= (s1 - 1) / a.page - pa; i += NT)
    pids[i] = min(max(bt_b[pa + i], 0), a.n_pool - 1);

  WideState<T, G> st;
  const int dhp = ncb * WIDE_COLS;
  // (its barrier also publishes the page ids)
  wide_begin<T, G>(st, qs, q, row0, heads, a.dh, dhp, a.scale_log2);
  const int per = (s1 - s0 + NWARPS - 1) / NWARPS;
  const int w0 = s0 + warp * per;
  const int n = max(min(per, s1 - w0), 0);
  const int64_t rs = static_cast<int64_t>(a.hkv) * a.dh;
  const int64_t head = static_cast<int64_t>(h) * a.dh;
  const int page = a.page;
  const int* pid = pids;
  wide_rows<T, G>(st, qs, k + head, v + head, n, a.dh, dhp, cb,
                  a.dh % 8 != 0, [=](int j) {
                    const int t = w0 + j;
                    return (static_cast<int64_t>(pid[t / page - pa]) * page
                            + t % page) * rs;
                  });
  decode_end<T, WIDE_COLS, G, NWARPS, true>(
      st, sm, heads, a.dh, out, a.part_acc, a.part_ml, nullptr, row0, split,
      a.splits, cb * WIDE_COLS);
}

template <typename T, int DH, int G, bool NARROW>
struct PagedLaunch {
  static int run(const PagedArgs& a) {
    cudaError_t err;
    if constexpr (DH == WIDE) {
      const int ncb = (a.dh + WIDE_COLS - 1) / WIDE_COLS;
      const int64_t smem = wide_q_bytes(a.dh, G);
      if (smem > WIDE_Q_SMEM) return -1;
      static bool smem_set = false;  // the attribute, once per instantiation
      if (!smem_set) {
        err = cudaFuncSetAttribute(paged_wide_kernel<T, G>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   WIDE_Q_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_set = true;
      }
      const dim3 grid(a.splits, a.hkv * ((a.g + G - 1) / G) * ncb, a.batch);
      paged_wide_kernel<T, G><<<grid, NT, smem, a.stream>>>(a);
    } else {
      const dim3 grid(a.splits, a.hkv * ((a.g + G - 1) / G), a.batch);
      paged_split_kernel<T, DH, G, NARROW><<<grid, NT, 0, a.stream>>>(a);
    }
    err = cudaGetLastError();
    if (err == cudaSuccess && a.splits > 1)
      err = launch_split_merge(a.part_acc, a.part_ml, static_cast<T*>(a.out),
                               nullptr, a.batch * a.hkv * a.g, a.splits,
                               a.dh, a.stream);
    return static_cast<int>(err);
  }
};

}  // namespace

// The launches of one dtype, by the arguments and the group chunk.  The
// build compiles this file as two parts at once (kernels/build.py PARTS,
// BUILD_PART 0 and 1: f32 with the entry point, then bf16), each half of
// the instantiations, and links them into the one library; without
// BUILD_PART it is whole.
extern "C" int paged_decode_attention_f32(const void* args, int gc);
extern "C" int paged_decode_attention_bf16(const void* args, int gc);

#if !defined(BUILD_PART) || BUILD_PART == 0
extern "C" int paged_decode_attention_f32(const void* args, int gc) {
  const PagedArgs& a = *static_cast<const PagedArgs*>(args);
  return dispatch_decode<PagedLaunch, float>(a.dh, gc, a);
}
#endif

#if !defined(BUILD_PART) || BUILD_PART == 1
extern "C" int paged_decode_attention_bf16(const void* args, int gc) {
  const PagedArgs& a = *static_cast<const PagedArgs*>(args);
  return dispatch_decode<PagedLaunch, __nv_bfloat16>(a.dh, gc, a);
}
#endif

#if !defined(BUILD_PART) || BUILD_PART == 0
// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  The P table entries of a row are split into ceil(P /
// pages_per_split) ranges (1 <= pages_per_split <= 256); with more than
// one, `scratch` holds B * Hkv * G * splits * (dh + 2) floats: the partial
// accumulators, then the (m, l) pairs.  Each CTA takes gc of a group's G
// query heads (the last chunk what is left).  Returns the CUDA error of
// the launches (0 on success), or -1 when the (dtype, dh, gc)
// combination has no instantiation or the split is out of range.  The
// launches are asynchronous on `stream` and allocate nothing.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, void* out, int batch,
    int hkv, int g, int dh, int page, int p_max, int n_pool, int window,
    float scale, void* stream, void* scratch, int pages_per_split, int gc) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || g <= 0 || gc <= 0 ||
      gc > g || dh <= 0 ||
      static_cast<int64_t>(hkv) * ((g + gc - 1) / gc)
              * (dh > WIDE_COLS ? (dh + WIDE_COLS - 1) / WIDE_COLS : 1)
          > 65535 || page <= 0 ||
      p_max <= 0 || n_pool <= 0 || pages_per_split <= 0 ||
      pages_per_split > MAX_PAGES)
    return -1;
  const int splits = (p_max + pages_per_split - 1) / pages_per_split;
  if (splits > 1 && scratch == nullptr) return -1;
  float* acc = static_cast<float*>(scratch);
  PagedArgs a{q, k_pool, v_pool, static_cast<const int32_t*>(block_tables),
              static_cast<const int32_t*>(ctx_lens), out, acc,
              splits > 1 ? reinterpret_cast<float2*>(
                               acc + static_cast<int64_t>(batch) * hkv * g *
                                         splits * dh)
                         : nullptr,
              batch, hkv, g, dh, page, p_max, n_pool, splits,
              pages_per_split, window, scale * 1.4426950408889634f,
              static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return paged_decode_attention_f32(&a, gc);
  if (dtype == 1) return paged_decode_attention_bf16(&a, gc);
  return -1;
}
#endif
