// Flash-decoding over a slot-contiguous ring KV cache, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::decode_attention.  On the port's path it is
// the ring layout's decode (self_attention_cached with one query token).
//
// What it computes: one query token per sequence attends over its ring.
// out[b, h] = softmax(q[b,h] . K_b^T / sqrt(dh)) . V_b over the slots t
// whose absolute position kpos[b, t] is valid: 0 <= kpos <= q_pos[b], and
// with a window also kpos > q_pos[b] - window.  Ring wraparound, empty
// slots (kpos = -1) and partly filled rings need no special case.  f32
// arithmetic throughout, NEG_INF = -1e30; a row with no valid slot is
// written as zeros (the plain version, like the reference, gives the
// uniform average there; ring decode never has such a live row, since
// each step writes its token before it attends).
//
// With a log-sum-exp output (the wrapper's with_lse) each query row's
// natural log-sum-exp of its scaled scores is written beside out, f32,
// NEG_INF where the row has no valid slot: a sequence-sharded ring's ranks
// attend over their own slots and combine the partial results by it
// (attention_combine.cu).  The one-split CTA writes it, or the merge.
//
// Layouts are the model's, so nothing is transposed or padded:
//   q, out (B, 1, Hkv*G, dh)
//   k, v   (B, T, Hkv, dh)   element (b, t, h, d) at (b*T + t)*R + h*dh + d,
//                            R = Hkv * dh, or a view's larger slot stride
//                            (the KV heads a rank's query heads read, of a
//                            ring that holds them all)
//   kpos   (B, T) int32, q_pos (B,) int32, lse (B, Hkv*G) f32
// dh is any of 1 to 256 and G any (the split-KV core in common.cuh: dh
// runs on the 32, 64, 128 or 256 wide instantiation with idle tail lanes,
// loading element by element where dh is not a multiple of 8; G past 5
// in chunks of at most 4).
//
// What bounds it: the bytes of K and V of the valid slots, 2 * valid *
// Hkv * dh * sizeof(T) per sequence, against 3.35 TB/s of HBM.  The
// arithmetic, 4 * G * dh per valid slot and KV head, is far below the
// card's rates, so the kernel has to keep enough loads in flight on every
// SM.  One CTA per (sequence, KV head) gave 40-64 CTAs for 132 SMs, each
// walking its whole ring alone; this design splits the ring:
//
// * Split-KV.  The grid is (splits, Hkv x group chunks, B): each CTA
//   takes a contiguous range of split_len ring slots, chosen by the
//   wrapper's planner from the shapes alone (decode_splits in
//   decode_attention.py, so no host sync), enough for about four CTAs per
//   SM at the serve shapes.  It writes the partial softmax state (m, l,
//   unnormalised acc) of each of its query heads into an f32 scratch the
//   wrapper allocates, and a second small kernel (split_merge_kernel,
//   common.cuh) folds the splits into out on the same stream.  With one
//   split the CTA writes out itself and the merge is not launched.  A
//   range with no valid slot reads only its kpos and writes m = NEG_INF,
//   l = 0, which the merge weighs as 0.
// * Inside a range, each warp compacts the valid slots of its 32-slot
//   chunks with ballots into a warp-private list (no block barrier), then
//   hands them to the shared core (decode_rows, common.cuh), which loads
//   only their K/V rows, each once for the whole GQA group (or group
//   chunk).  A lane loads 16 bytes of a row (8 bf16 or 4 f32), so DH / 8
//   (bf16) lanes cover a row and a warp reads 2-8 rows per load (at DH
//   256 a row takes the warp, 8 elements a lane, two loads in f32); each
//   lane keeps U = 4 rows of K and V in flight.  The dot product
//   reduces over the lanes of a row with shuffles.  Scores are in log2
//   units (q is scaled by scale * log2(e) once), so the softmax is
//   exp2f.  The lane groups of a warp merge with shuffles, the
//   warps of a CTA in shared memory (decode_end).
//
// Later work: prefetching the next rows while the current ones are
// reduced, and planning the splits from the live context where a host
// sync is acceptable (a ring sized for 4096 slots with 515 live tokens
// leaves most ranges empty, and the few live ones set the time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// The launch arguments: outside the anonymous namespace, so the two
// parts of the build (kernels/build.py PARTS) share the one type.
struct RingArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kpos;
  const int32_t* q_pos;
  void* out;
  float* lse;
  float* part_acc;
  float2* part_ml;
  int64_t slot_stride;
  int batch, t_len, hkv, g, dh, splits, split_len, window;
  float scale_log2;
  cudaStream_t stream;
};

namespace {

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int SPLIT_MAX = 1024;              // most slots a CTA takes
constexpr int IDS = SPLIT_MAX / NWARPS;      // compacted slots a warp holds


// One CTA: query heads row0 .. row0 + G - 1 (a group chunk of KV head h)
// of sequence b over ring slots [s0, s1) of split blockIdx.x.
template <typename T, int DH, int G, bool NARROW>
__global__ void __launch_bounds__(NT) decode_split_kernel(RingArgs a) {
  __shared__ int ids[NWARPS][IDS];
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
  const int lane = threadIdx.x & 31;
  const int s0 = split * a.split_len;
  const int s1 = min(s0 + a.split_len, a.t_len);
  const int64_t row0 = (static_cast<int64_t>(b) * a.hkv + h) * a.g
                       + c0;

  // compact the valid slots of this warp's chunks: 32-slot chunks of the
  // range, dealt round the warps
  const int qp = a.q_pos[b];
  const int lo = a.window > 0 ? qp - a.window + 1 : 0;  // kpos >= 0 always
  const int32_t* kp_b = a.kpos + static_cast<int64_t>(b) * a.t_len;
  int n = 0;
  for (int c0 = s0 + warp * 32; c0 < s1; c0 += NWARPS * 32) {
    const int t = c0 + lane;
    const int kp = t < s1 ? kp_b[t] : -1;
    const bool valid = kp >= 0 && kp >= lo && kp <= qp;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (valid) ids[warp][n + __popc(ballot & ((1u << lane) - 1u))] = t;
    n += __popc(ballot);
  }
  __syncwarp();

  if (!__syncthreads_or(n > 0)) {         // no valid slot in the range
    decode_empty(heads, a.dh, out, a.part_ml, a.lse, row0, split,
                 a.splits);
    return;
  }

  DecodeState<T, DH, G> st;
  decode_begin<T, DH, G, NARROW>(st, q, row0, heads, a.dh, a.scale_log2);
  const int64_t rs = a.slot_stride;          // elements from slot to slot
  const int64_t base = static_cast<int64_t>(b) * a.t_len * rs
                       + static_cast<int64_t>(h) * a.dh;
  const int* wid = ids[warp];
  decode_rows<T, DH, G, NARROW>(st, k + base, v + base, n, a.dh,
                                [=](int j) { return wid[j] * rs; });
  decode_end(st, sm, heads, a.dh, out, a.part_acc, a.part_ml, a.lse, row0,
             split, a.splits);
}

template <typename T, int DH, int G, bool NARROW>
struct RingLaunch {
  static int run(const RingArgs& a) {
    const dim3 grid(a.splits, a.hkv * ((a.g + G - 1) / G), a.batch);
    decode_split_kernel<T, DH, G, NARROW><<<grid, NT, 0, a.stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess && a.splits > 1)
      err = launch_split_merge(a.part_acc, a.part_ml, static_cast<T*>(a.out),
                               a.lse, a.batch * a.hkv * a.g, a.splits, a.dh,
                               a.stream);
    return static_cast<int>(err);
  }
};

}  // namespace

// The launches of one dtype, by the arguments and the group chunk.  The
// build compiles this file as two parts at once (kernels/build.py PARTS,
// BUILD_PART 0 and 1: f32 with the entry point, then bf16), each half of
// the instantiations, and links them into the one library; without
// BUILD_PART it is whole.
extern "C" int decode_attention_f32(const void* args, int gc);
extern "C" int decode_attention_bf16(const void* args, int gc);

#if !defined(BUILD_PART) || BUILD_PART == 0
extern "C" int decode_attention_f32(const void* args, int gc) {
  const RingArgs& a = *static_cast<const RingArgs*>(args);
  return dispatch_decode<RingLaunch, float>(a.dh, gc, a);
}
#endif

#if !defined(BUILD_PART) || BUILD_PART == 1
extern "C" int decode_attention_bf16(const void* args, int gc) {
  const RingArgs& a = *static_cast<const RingArgs*>(args);
  return dispatch_decode<RingLaunch, __nv_bfloat16>(a.dh, gc, a);
}
#endif

#if !defined(BUILD_PART) || BUILD_PART == 0
// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  The ring's T slots are split into ceil(T / split_len) ranges
// (1 <= split_len <= 1024); with more than one, `scratch` holds
// B * Hkv * G * splits * (dh + 2) floats: the partial accumulators, then
// the (m, l) pairs.  Each CTA takes gc of a group's G query heads (the
// last chunk what is left).  `lse`, where it is not null, receives each
// query row's log-sum-exp of its scaled scores (natural log; NEG_INF for
// a row with no valid slot), B * Hkv * G floats.  K and V step
// `slot_stride` elements from slot to slot (Hkv * dh for a whole ring;
// more for a view of some of a ring's KV heads) and slot_stride * T from
// row to row.  Returns the CUDA error of the launches (0 on success), or
// -1 when the (dtype, dh, gc) combination has no instantiation or the
// split or the stride is out of range.  The launches are asynchronous on
// `stream` and allocate nothing.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* kpos, const void* q_pos,
                                       void* out, int batch, int t_len,
                                       int hkv, int g, int dh, int window,
                                       float scale, void* stream,
                                       void* scratch, int split_len,
                                       int gc, void* lse,
                                       long long slot_stride) {
  if (t_len <= 0 || batch <= 0 || batch > 65535 || hkv <= 0 || g <= 0 ||
      gc <= 0 || gc > g ||
      hkv * ((g + gc - 1) / gc) > 65535 || split_len <= 0 ||
      split_len > SPLIT_MAX || slot_stride < static_cast<long long>(hkv) * dh)
    return -1;
  const int splits = (t_len + split_len - 1) / split_len;
  if (splits > 1 && scratch == nullptr) return -1;
  float* acc = static_cast<float*>(scratch);
  RingArgs a{q, k, v, static_cast<const int32_t*>(kpos),
             static_cast<const int32_t*>(q_pos), out,
             static_cast<float*>(lse), acc,
             splits > 1 ? reinterpret_cast<float2*>(
                              acc + static_cast<int64_t>(batch) * hkv * g *
                                        splits * dh)
                        : nullptr,
             static_cast<int64_t>(slot_stride), batch, t_len, hkv, g, dh,
             splits, split_len, window, scale * LOG2E,
             static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return decode_attention_f32(&a, gc);
  if (dtype == 1) return decode_attention_bf16(&a, gc);
  return -1;
}
#endif
