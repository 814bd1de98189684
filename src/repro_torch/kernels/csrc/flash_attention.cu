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
// the column-block bodies of part 1, below); the scale is the caller's
// (1/sqrt(dh) of the real dh, which the wrapper keeps where it pads a dh
// that is not a multiple of 8 into a zero-filled copy).
//
// What bounds it: operations.  4 * dh per (query row, head, valid key) --
// about 8.6 GFLOP for S = T = 1024, H = 32, dh = 128 causal, 8.7 us at the
// card's 989 TFLOP/s bf16 -- against a few MB of q, k, v and out.  Pallas
// carried (m, l, acc) across a sequential grid axis; here one CTA owns
// (b, q head, a block of query rows) and loops over the key tiles itself,
// only from the first to the last tile that the causal and window masks
// leave live.  Two bodies:
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

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

// A head past 256: the column-block bodies of part 1 (below).
extern "C" int flash_attention_wide(int dtype, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int batch, int s_len, int t_len, int h_q,
                                    int g, int dh, int causal, int window,
                                    float scale, cudaStream_t stream);

// The build compiles this file as two parts at once (kernels/build.py
// PARTS): the bodies up to DH 256 with the entry point, then the
// column-block bodies; without BUILD_PART it is whole.
#if !defined(BUILD_PART) || BUILD_PART == 0
namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int TPR = 4;           // threads per query row
constexpr int NT = BQ * TPR;     // threads per CTA

// keys per shared-memory tile: 32, and 16 at DH 256, where the f32 K and
// V tiles would pass the 48 KB of static shared memory
__host__ __device__ constexpr int f32_keys(int dh) {
  return dh > 128 ? 16 : 32;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int s_len, int t_len, int h_q,
                       int g, int dh, int causal, int window, float scale) {
  constexpr int NF = DH / (4 * TPR);  // float4 chunks of a row per thread
  constexpr int BK = f32_keys(DH);
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int r = threadIdx.x / TPR;    // query row within the block
  const int c = threadIdx.x % TPR;    // this thread's share of the row
  const int qi = q0 + r;
  const bool live = qi < s_len;

  // this row's valid keys: [lo, hi]
  int lo = 0, hi = t_len - 1;
  if (causal) {
    hi = min(qi, t_len - 1);
    if (window > 0) lo = max(qi - window + 1, 0);
  }
  // the CTA's live key range: the union of its rows' ranges
  int k_begin = 0, k_end = t_len;
  if (causal) {
    const int last = min(q0 + BQ, s_len) - 1;
    k_end = min(last + 1, t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / BK) * BK;

  float qr[NF][4], acc[NF][4];
  {
    const T* qp = q + ((static_cast<int64_t>(b) * s_len + (live ? qi : 0))
                       * h_q + h) * dh;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int col = (f * TPR + c) * 4;
      if (col < dh) {
        load_row<4>(qp + col, qr[f]);
      } else {                      // past dh: zeros, as in the K/V tiles
#pragma unroll
        for (int e = 0; e < 4; ++e) qr[f][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qr[f][e] *= scale;
        acc[f][e] = 0.f;
      }
    }
  }
  float m = NEG_INF, l = 0.f;

  const int64_t krow = static_cast<int64_t>(hkv) * dh;  // one key's stride
  const T* kb = k + static_cast<int64_t>(b) * t_len * krow + kh * dh;
  const T* vb = v + static_cast<int64_t>(b) * t_len * krow + kh * dh;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x * 4; idx < BK * DH; idx += NT * 4) {
      const int j = idx / DH;
      const int d = idx % DH;
      const int t = t0 + j;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < t_len && d < dh) {
        load_row<4>(kb + t * krow + d, kx);
        load_row<4>(vb + t * krow + d, vx);
      }
      *reinterpret_cast<float4*>(&ks[j][d]) =
          make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(&vs[j][d]) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();
    // a warp skips a tile that none of its eight rows needs; a row of a
    // warp that goes on finds every key masked and changes nothing
    const bool need = live && t0 <= hi && t0 + BK - 1 >= lo;
    if (!__any_sync(0xffffffffu, need)) continue;

    float sc[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float4 kx = *reinterpret_cast<const float4*>(
            &ks[j][(f * TPR + c) * 4]);
        part += qr[f][0] * kx.x + qr[f][1] * kx.y + qr[f][2] * kx.z +
                qr[f][3] * kx.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int t = t0 + j;
      const bool ok = t >= lo && t <= hi;
      sc[j] = ok ? part : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int t = t0 + j;
      const float p = (t >= lo && t <= hi) ? expf(sc[j] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float4 vx = *reinterpret_cast<const float4*>(
            &vs[j][(f * TPR + c) * 4]);
        acc[f][0] += p * vx.x; acc[f][1] += p * vx.y;
        acc[f][2] += p * vx.z; acc[f][3] += p * vx.w;
      }
    }
    m = mx;
  }

  if (!live) return;
  // scores are in scaled units (q was scaled), so the row's log-sum-exp
  // is m + log(l); -inf for a row with no valid key
  if (lse != nullptr && c == 0)
    lse[(static_cast<int64_t>(b) * h_q + h) * s_len + qi] =
        l > 0.f ? m + logf(l) : -INFINITY;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* op = out + ((static_cast<int64_t>(b) * s_len + qi) * h_q + h) * dh;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int col = (f * TPR + c) * 4;
    if (col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) store_one(op + col + e, acc[f][e] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BOX = 64;            // columns of dh in a box (128 bytes)
constexpr int WG_ROWS = 64;        // query rows of a consumer warpgroup
constexpr int NWG = 2;             // consumer warpgroups
constexpr int CTA_ROWS = NWG * WG_ROWS;
constexpr int THREADS = (NWG + 1) * 128;
constexpr int STAGES = 2;          // slots of the K ring and of the V ring
constexpr int BUDGET = 227 * 1024; // dynamic shared memory a CTA may use

// The body at width DH: keys of a tile (BN), and shared memory: the
// CTA's Q (both warpgroups' 64 rows, DH / 64 boxes each), then a ring of
// STAGES K tiles and one of STAGES V tiles (BN rows x DH / 64 boxes
// each), then the barriers.  Every box is 1024-byte aligned (the 128-byte
// swizzle's atoms).  BN is 128 up to DH 128: S = Q K^T reads its A
// operand (Q) from shared memory, and at N = 64 a k-step's 4 KB of
// operands would take as long to read as the product takes to run; at
// DH 256 a 128-key S (64 registers a thread) would not fit beside O's
// 128, so BN is 64 there.  Two stages a ring: deeper rings (3 at DH 128,
// 4 at DH 64, as many as 227 KB hold) were within 0.3% at the timed
// 1024-token shapes and slower at the train shape (PERF.md §6).
template <int DH>
struct Fwd {
  static constexpr int NB = DH / BOX;
  static constexpr int BN = DH > 128 ? 64 : 128;
  static constexpr int Q_BOX = WG_ROWS * 128;     // bytes of a Q box
  static constexpr int KV_BOX = BN * 128;         // bytes of a K or V box
  static constexpr int Q_BYTES = NWG * NB * Q_BOX;
  static constexpr int TILE = NB * KV_BOX;        // bytes of a K or V tile
  static constexpr int BAR_BYTES = (4 * STAGES + 2) * 8;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * TILE + BAR_BYTES;
  static_assert(SMEM <= BUDGET, "Q and the rings fit a CTA");
};

// k-step kk (16 columns of dh) of a K-major operand in boxes box_bytes
// apart: 32 bytes a step inside the swizzled 128-byte rows
__device__ __forceinline__ uint64_t kmajor(const unsigned char* base,
                                           int box_bytes, int kk) {
  return hopper::sw128_desc(base + (kk >> 2) * box_bytes + (kk & 3) * 32, 16,
                            1024);
}

// k-step kk (16 keys) of V as an MN-major B: 64-column boxes box_bytes
// apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* base,
                                            int box_bytes, int kk) {
  return hopper::sw128_desc(base + kk * 2048, box_bytes, 1024);
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = 0.f;
}

// The softmax of a tile's S (64 x BN, the accumulator layout) in place:
// masks where the tile is not whole, the rows' new running max m, P =
// exp2 of the scaled scores less it, and the running sums l; alpha gets
// each row's rescale of O (exactly 1 while a row has seen no valid key:
// m - mx is then 0, both NEG_INF).  Rows row_r and row_r + 8; key column
// 8j + kc (+1) of the tile starting at t0.
template <int BN>
__device__ __forceinline__ void online_softmax(
    float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool whole, int t0, int row_r, int kc, int t_len, int causal,
    int window, float scale_log2) {
  if (!whole) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + kc + (e & 1);
        const int row = row_r + 8 * (e >> 1);
        bool ok = key < t_len;
        if (causal)
          ok = ok && key <= row && (window <= 0 || key > row - window);
        if (!ok) s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] * scale_log2;
    // m - mx first: exactly 0 while both are NEG_INF (an fma of m * c
    // against the rounded mx * c would leave a residual of ~1e22 there)
    alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked score is -inf and ms finite: exp2 gives exactly 0
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -ms[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// P (f32, the accumulator layout) in bf16 as the register A operands of
// O += P V, one k-step of 16 keys each (wgmma.cuh)
template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2],
                                       unsigned (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = hopper::pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// S = Q K^T over DH (the warpgroup's Q, a K tile; both K-major), one
// commit group
template <int DH>
__device__ __forceinline__ void issue_s(float (&s)[Fwd<DH>::BN / 2],
                                        const unsigned char* q,
                                        const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    hopper::WgmmaSS<Fwd<DH>::BN>::template mma<0, 0>(
        s, kmajor(q, Fwd<DH>::Q_BOX, kk), kmajor(k, Fwd<DH>::KV_BOX, kk),
        kk > 0);
  hopper::wgmma_commit();
}

// O += P V (P from registers, V an MN-major tile), one commit group
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const unsigned (&p)[Fwd<DH>::BN /
                                                             16][4],
                                         const unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < Fwd<DH>::BN / 16; ++kk)
    hopper::WgmmaRS<DH>::template mma<1>(o, p[kk],
                                         mnmajor(v, Fwd<DH>::KV_BOX, kk), 1);
  hopper::wgmma_commit();
}

// The warpgroups' turns at the tensor cores: warpgroup w waits at named
// barrier 1 + w for its turn and, once its products are issued, gives
// the turn to the other at 2 - w; so one warpgroup's softmax runs while
// the other's products do (faster than no turns at every timed shape,
// PERF.md §6).  Each warpgroup takes n_tiles + 1 turns an
// item whatever its rows need (a tile it skips is a turn with no
// product), so the two stay in step.
struct Turns {
  int wg;
  __device__ __forceinline__ void start() const {
    if (wg == 1) hopper::named_barrier_arrive(1, NWG * 128);
  }
  __device__ __forceinline__ void take() const {
    hopper::named_barrier(1 + wg, NWG * 128);
  }
  __device__ __forceinline__ void give() const {
    hopper::named_barrier_arrive(2 - wg, NWG * 128);
  }
  // warpgroup 0 takes warpgroup 1's last turn, so no arrival is left
  __device__ __forceinline__ void finish() const {
    if (wg == 0) hopper::named_barrier(1, NWG * 128);
  }
};

// The work items: one per (query head, b, block of 128 query rows), item
// it at head it % h_q, batch row (it / h_q) % B and the block counted
// from the last, so the heaviest under a causal mask come first.  CTA c
// of a grid of n takes items c, 2n - 1 - c, 2n + c, 4n - 1 - c, ... (a
// snake over the heaviest-first order, which evens out the CTAs' work).
// The grid is one CTA an SM (fewer where there are fewer items): a CTA's
// next item's Q and first tiles load while it writes the last one's
// output (faster than one CTA an item at every timed shape up to dh
// 128, the same at 256; PERF.md §6).
struct Item {
  int h, b, q0;
};

__device__ __forceinline__ Item item_of(int it, int h_q, int batch,
                                        int blocks) {
  const int z = it / (h_q * batch);
  return {it % h_q, (it / h_q) % batch, (blocks - 1 - z) * CTA_ROWS};
}

__device__ __forceinline__ int item_at(int round) {
  const int n = static_cast<int>(gridDim.x);
  const int c = static_cast<int>(blockIdx.x);
  return round * n + (round & 1 ? n - 1 - c : c);
}

// Thread roles: warpgroups 0 and 1 the consumers, 64 query rows of an
// item each; warpgroup 2 the producer, of which one thread issues every
// load: an item's Q once both warpgroups are done with the last one's
// (qempty), then its K and V tiles through the rings, whose slots and
// phases run on across items.  Per warpgroup, tile i's S = Q K_i^T is
// issued together with tile i-1's O += P V_{i-1}, and the softmax of S_i
// runs while the second product does; an item's output is written while
// the next item's loads are in flight.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int batch, int s_len,
                     int t_len, int h_q, int g, int dh, int causal,
                     int window, float scale_log2) {
  using F = Fwd<DH>;
  constexpr int NB = F::NB;
  constexpr int BN = F::BN;
  constexpr int ST = STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sk = sq + F::Q_BYTES;
  unsigned char* sv = sk + ST * F::TILE;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sv + ST * F::TILE);
  uint64_t* vfull = kfull + ST;
  uint64_t* kempty = vfull + ST;
  uint64_t* vempty = kempty + ST;
  uint64_t* qfull = vempty + ST;
  uint64_t* qempty = qfull + 1;

  const int blocks = (s_len + CTA_ROWS - 1) / CTA_ROWS;
  const int n_items = h_q * batch * blocks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&kfull[i], 1);
      hopper::mbar_init(&vfull[i], 1);
      hopper::mbar_init(&kempty[i], NWG * 4);
      hopper::mbar_init(&vempty[i], NWG * 4);
    }
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qempty, NWG * 4);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // an item's key tiles: from the first to the last its rows' masks
  // leave live
  const auto tiles_of = [&](int q0, int& k_begin) {
    int k_end = t_len;
    k_begin = 0;
    if (causal) {
      k_end = min(min(q0 + CTA_ROWS, s_len), t_len);
      if (window > 0) k_begin = max(q0 - window + 1, 0);
    }
    k_begin = (k_begin / BN) * BN;
    return k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  };

  if (wg == NWG) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if (tid == NWG * 128) {
      int ring = 0;                      // tiles issued, over all items
      for (int r = 0;; ++r) {
        const int it = item_at(r);
        if (it >= n_items) break;
        const Item w = item_of(it, h_q, batch, blocks);
        const int kh = w.h / g;
        int k_begin;
        const int n_tiles = tiles_of(w.q0, k_begin);
        if (r > 0) hopper::mbar_wait(qempty, (r - 1) & 1);
        hopper::mbar_arrive_expect_tx(qfull, F::Q_BYTES);
        // the loops stay rolled: the producer has 40 registers
#pragma unroll 1
        for (int c = 0; c < NWG; ++c)
#pragma unroll 1
          for (int bx = 0; bx < NB; ++bx)
            hopper::tma_load_4d(sq + (c * NB + bx) * F::Q_BOX, &qmap, qfull,
                                bx * BOX, w.h, w.q0 + c * WG_ROWS, w.b);
        for (int tile = 0; tile < n_tiles; ++tile, ++ring) {
          const int st = ring % ST;
          const uint32_t ph = ((ring / ST) & 1) ^ 1;
          const int t0 = k_begin + tile * BN;
          hopper::mbar_wait(&kempty[st], ph);
          hopper::mbar_arrive_expect_tx(&kfull[st], F::TILE);
#pragma unroll 1
          for (int bx = 0; bx < NB; ++bx)
            hopper::tma_load_4d(sk + st * F::TILE + bx * F::KV_BOX, &kmap,
                                &kfull[st], bx * BOX, kh, t0, w.b);
          hopper::mbar_wait(&vempty[st], ph);
          hopper::mbar_arrive_expect_tx(&vfull[st], F::TILE);
#pragma unroll 1
          for (int bx = 0; bx < NB; ++bx)
            hopper::tma_load_4d(sv + st * F::TILE + bx * F::KV_BOX, &vmap,
                                &vfull[st], bx * BOX, kh, t0, w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows of each item ----
  hopper::reg_alloc<232>();
  const Turns turns{wg};
  turns.start();
  const int kc = 2 * (lane & 3);               // key columns 8j + kc, +1
  const unsigned char* my_q = sq + wg * NB * F::Q_BOX;
  const auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  float o[DH / 2], s[BN / 2];
  unsigned p[BN / 16][4];
  zero(s);                // the first k-step of each S overwrites

  int ring = 0;                                // the item's first tile
  for (int r = 0;; ++r) {
    const int it = item_at(r);
    if (it >= n_items) break;
    const Item w = item_of(it, h_q, batch, blocks);
    int k_begin;
    const int n_tiles = tiles_of(w.q0, k_begin);
    const int w0 = w.q0 + wg * WG_ROWS;        // the warpgroup's first row
    const int w_last = min(w0 + WG_ROWS - 1, s_len - 1);
    const int row_r = w0 + 16 * (warp & 3) + (lane >> 2);  // and row_r + 8

    // does a row of the warpgroup need tile i, and is every (row, key)
    // pair of it valid?  The tiles needed are one run [first, last).
    const auto need = [&](int i) {
      const int t0 = k_begin + i * BN;
      bool ok = w0 < s_len;
      if (causal) {
        ok = ok && t0 <= w_last;
        if (window > 0) ok = ok && t0 + BN - 1 > w0 - window;
      }
      return ok;
    };
    const auto whole = [&](int i) {
      const int t0 = k_begin + i * BN;
      bool ok = t0 + BN <= t_len;
      if (causal) {
        ok = ok && t0 + BN - 1 <= w0;
        if (window > 0) ok = ok && t0 > w_last - window;
      }
      return ok;
    };
    int first = n_tiles, last = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (need(i)) {
        first = min(first, i);
        last = i + 1;
      }
    if (first >= last) first = last = n_tiles;
    // a tile the warpgroup does not need: waits until it has landed (so
    // its arrivals count towards this round of the ring), releases it,
    // and takes its turn
    const auto pass = [&](int i) {
      const int st = (ring + i) % ST;
      const uint32_t ph = ((ring + i) / ST) & 1;
      hopper::mbar_wait(&kfull[st], ph);
      hopper::mbar_wait(&vfull[st], ph);
      turns.take();
      turns.give();
      release(&kempty[st]);
      release(&vempty[st]);
    };

    zero(o);
    // rows row_r and row_r + 8: running max (raw score units) and this
    // thread's part of the running sum (the row's 4 lanes add up at the
    // end)
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    hopper::mbar_wait(qfull, r & 1);
    for (int i = 0; i < first; ++i) pass(i);
    if (first < last) {
      float alpha[2];
      {                     // the first tile: S alone
        const int st = (ring + first) % ST;
        hopper::mbar_wait(&kfull[st], ((ring + first) / ST) & 1);
        turns.take();
        hopper::fence_regs(s);
        hopper::wgmma_fence();
        issue_s<DH>(s, my_q, sk + st * F::TILE);
        turns.give();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        release(&kempty[st]);
        // O is 0: nothing to rescale
        online_softmax<BN>(s, m, l, alpha, whole(first),
                           k_begin + first * BN, row_r, kc, t_len, causal,
                           window, scale_log2);
        pack_p<BN>(s, p);
      }
      for (int i = first + 1; i < last; ++i) {
        const int st = (ring + i) % ST;
        const int pst = (ring + i - 1) % ST;
        hopper::mbar_wait(&kfull[st], ((ring + i) / ST) & 1);
        turns.take();
        hopper::fence_regs(s);
        hopper::fence_regs(o);
        hopper::fence_regs(p);
        hopper::wgmma_fence();
        issue_s<DH>(s, my_q, sk + st * F::TILE);    // S_i = Q K_i^T
        hopper::mbar_wait(&vfull[pst], ((ring + i - 1) / ST) & 1);
        issue_pv<DH>(o, p, sv + pst * F::TILE);     // O += P_{i-1} V_{i-1}
        turns.give();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        release(&kempty[st]);
        online_softmax<BN>(s, m, l, alpha, whole(i), k_begin + i * BN,
                           row_r, kc, t_len, causal, window, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::fence_regs(p);
        release(&vempty[pst]);
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        pack_p<BN>(s, p);
      }
      release(qempty);      // every S of the item is done: Q is free
      {                     // the last tile's P V
        const int pst = (ring + last - 1) % ST;
        hopper::mbar_wait(&vfull[pst], ((ring + last - 1) / ST) & 1);
        turns.take();
        hopper::fence_regs(o);
        hopper::fence_regs(p);
        hopper::wgmma_fence();
        issue_pv<DH>(o, p, sv + pst * F::TILE);
        turns.give();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(&vempty[pst]);
      }
    } else {
      release(qempty);
      turns.take();         // the turn of the absent first product
      turns.give();
    }
    for (int i = last; i < n_tiles; ++i) pass(i);
    ring += n_tiles;

    float inv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 1);
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 2);
      inv[q] = l[q] > 0.f ? 1.f / l[q] : 0.f;   // no valid key: zeros
    }
    if (lse != nullptr && (lane & 3) == 0) {
      // natural log-sum-exp of the scaled scores: (m * scale_log2 +
      // log2(l)) * ln 2; -inf for a row with no valid key
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = row_r + 8 * q;
        if (row < s_len)
          lse[(static_cast<int64_t>(w.b) * h_q + w.h) * s_len + row] =
              l[q] > 0.f ? (m[q] * scale_log2 + __log2f(l[q])) * LN2
                         : -INFINITY;
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = row_r + 8 * q;
      if (row >= s_len) continue;
      __nv_bfloat16* op = out + (static_cast<int64_t>(w.b) * s_len + row)
                                    * h_q * dh
                          + static_cast<int64_t>(w.h) * dh + kc;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        if (8 * j < dh)                // dh % 8 == 0: whole 8-column tiles
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * q] * inv[q],
                                    o[4 * j + 2 * q + 1] * inv[q]);
    }
  }
  turns.finish();
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int batch, int s_len, int t_len, int h_q,
                       int g, int dh, int causal, int window, float scale,
                       cudaStream_t stream) {
  dim3 grid((s_len + BQ - 1) / BQ, h_q, batch);
  flash_attention_kernel<float, DH><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s_len,
      t_len, h_q, g, dh, causal, window, scale);
  return cudaGetLastError();
}
template <int DH>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int s_len, int t_len, int h_q, int g,
               int dh, int causal, int window, float scale,
               cudaStream_t stream) {
  using F = Fwd<DH>;
  const auto kernel = flash_fwd_tma_kernel<DH>;
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
      t_len, h_q, g, dh, causal, window, scale * LOG2E);
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
// ---------------------------------------------------------------------------
// Part 1: a head past 256, in column blocks.  One CTA per (b, query head,
// 64 query rows, block of the output's columns): every CTA computes the
// whole scores S = Q K^T, summed over 64-column chunks of dh, and
// accumulates only its own block of O += P V.  The CTAs of a row block
// compute the same S in the same order, so they agree on the softmax bit
// for bit, and the first block's CTA writes the log-sum-exp.  The S of a
// tile is computed once per column block: at dh 512 the bf16 body's two
// 256-column blocks do 1.5 times the products of one pass, the f32 body's
// eight 64-column blocks 4.5 times.  Any number of blocks; the wrapper
// pads a dh that is not a multiple of 8, as below 256.
// ---------------------------------------------------------------------------
namespace {

constexpr int W_BQ = 64;         // query rows per CTA
constexpr int W_BK = 64;         // keys per tile (bf16)
constexpr int W_NT = 128;        // one warp per 16 query rows (bf16)
constexpr int W_KC = 64;         // columns of dh a Q or K chunk holds
constexpr int W_CP = W_KC + 8;   // chunk pitch, bf16 (16 bytes of pad)
constexpr int W_ST = 3;          // stages of the cp.async ring
// columns of O a bf16 CTA owns: the fewest recomputes of S the registers
// allow (255 a thread, 120 bytes of spill); at agent-7b's width with heads
// of 512, blocks of 128 were 19% slower (PERF.md §6)
constexpr int W_DB = 256;

// one stage: a Q chunk and a K chunk, or a V block; bf16 elements
__host__ __device__ constexpr int w_stage_elems() {
  return 2 * W_BQ * W_CP > W_BK * (W_DB + 8) ? 2 * W_BQ * W_CP
                                               : W_BK * (W_DB + 8);
}
constexpr int W_SMEM = W_ST * w_stage_elems() * 2;

// Item i of a CTA's walk into stage st: for tile it = i / (nch + 1),
// items 0 .. nch - 1 are the Q and K chunks of columns 64 c .., item nch
// the V block of the CTA's columns; rows past S or T and columns past dh
// as zeros.
__device__ __forceinline__ void wide_issue(
    __nv_bfloat16* st, int i, int nch, const __nv_bfloat16* qb,
    int64_t qrow, const __nv_bfloat16* kb, const __nv_bfloat16* vb,
    int64_t krow, int q0, int s_len, int k_begin, int t_len, int dh,
    int col0) {
  const int it = i / (nch + 1), part = i % (nch + 1);
  const int k0 = k_begin + it * W_BK;
  if (part < nch) {
    const int c0 = part * W_KC;
    __nv_bfloat16* sk = st + W_BQ * W_CP;
#pragma unroll
    for (int j = 0; j < W_BQ * (W_KC / 8) / W_NT; ++j) {
      const int c = threadIdx.x + j * W_NT;
      const int row = c / (W_KC / 8);
      const int col = (c % (W_KC / 8)) * 8;
      const bool qok = q0 + row < s_len && c0 + col < dh;
      cp_async16(st + row * W_CP + col,
                 qb + (qok ? (q0 + row) * qrow + c0 + col : 0), qok);
      const bool kok = k0 + row < t_len && c0 + col < dh;
      cp_async16(sk + row * W_CP + col,
                 kb + (kok ? (k0 + row) * krow + c0 + col : 0), kok);
    }
  } else {
    constexpr int VP = W_DB + 8;
#pragma unroll
    for (int j = 0; j < W_BK * (W_DB / 8) / W_NT; ++j) {
      const int c = threadIdx.x + j * W_NT;
      const int row = c / (W_DB / 8);
      const int col = (c % (W_DB / 8)) * 8;
      const bool ok = k0 + row < t_len && col0 + col < dh;
      cp_async16(st + row * VP + col,
                 vb + (ok ? (k0 + row) * krow + col0 + col : 0), ok);
    }
  }
}

// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators): four
// warps of 16 query rows, P rounded to
// bf16 in registers as the A fragments of P V, the online softmax in exp2
// units.  Q and K arrive in 64-column chunks through a 3-stage cp.async
// ring, so shared memory does not grow with dh; each tile's S sums its
// chunks, then the V block of the CTA's W_DB columns arrives.
__global__ void __launch_bounds__(W_NT, 1)
flash_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int s_len, int t_len, int h_q,
                      int g, int dh, int causal, int window,
                      float scale_log2) {
  constexpr int NS = W_BK / 8;          // n-tiles of S (8 keys each)
  constexpr int ND = W_DB / 8;          // n-tiles of O (8 columns each)
  constexpr int VP = W_DB + 8;
  constexpr int STAGE = w_stage_elems();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int nvb = (dh + W_DB - 1) / W_DB;
  const int h = blockIdx.x / nvb;
  const int col0 = (blockIdx.x % nvb) * W_DB;   // the CTA's columns of O
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * W_BQ;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int w0 = q0 + warp * 16;
  const int w_last = min(w0 + 15, s_len - 1);

  int k_begin = 0, k_end = t_len;
  if (causal) {
    k_end = min(min(q0 + W_BQ, s_len), t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / W_BK) * W_BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + W_BK - 1) / W_BK
                                      : 0;
  const int nch = (dh + W_KC - 1) / W_KC;
  const int items = n_tiles * (nch + 1);

  const int64_t qrow = static_cast<int64_t>(h_q) * dh;  // one row's stride
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * s_len * qrow
                            + static_cast<int64_t>(h) * dh;
  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * t_len * krow
                            + static_cast<int64_t>(kh) * dh;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * t_len * krow
                            + static_cast<int64_t>(kh) * dh;

#pragma unroll
  for (int st = 0; st < W_ST - 1; ++st) {
    if (st < items)
      wide_issue(smem + st * STAGE, st, nch, qb, qrow, kb, vb, krow, q0,
                 s_len, k_begin, t_len, dh, col0);
    cp_async_commit();
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[NS][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < items; ++i) {
    cp_async_wait<W_ST - 2>();
    __syncthreads();             // item i landed; item i - 1 consumed
    if (i + W_ST - 1 < items)
      wide_issue(smem + (i + W_ST - 1) % W_ST * STAGE, i + W_ST - 1, nch, qb,
                 qrow, kb, vb, krow, q0, s_len, k_begin, t_len, dh, col0);
    cp_async_commit();

    const int part = i % (nch + 1);
    const int k0 = k_begin + (i / (nch + 1)) * W_BK;
    bool need = w0 < s_len;
    bool full = k0 + W_BK <= t_len;
    if (causal) {
      need = need && k0 <= w_last;
      full = full && k0 + W_BK - 1 <= w0;
      if (window > 0) {
        need = need && k0 + W_BK - 1 > w0 - window;
        full = full && k0 > w_last - window;
      }
    }
    if (!need) continue;
    const __nv_bfloat16* sq = smem + (i % W_ST) * STAGE;

    if (part < nch) {
      // S += Q K^T over this chunk's 64 columns
      const __nv_bfloat16* sk = sq + W_BQ * W_CP;
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < W_KC / 16; kk += 2) {
        unsigned qs0[4], qs1[4];
        const __nv_bfloat16* qp =
            sq + (warp * 16 + (lane & 15)) * W_CP + kk * 16 + (lane >> 4) * 8;
        hopper::ldmatrix_x4(qs0, qp);
        hopper::ldmatrix_x4(qs1, qp + 16);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          unsigned kf[4];
          hopper::ldmatrix_x4(kf, sk + (j * 8 + (lane & 7)) * W_CP + kk * 16
                                      + (lane >> 3) * 8);
          hopper::mma_bf16(s[j], qs0, kf[0], kf[1]);
          hopper::mma_bf16(s[j], qs1, kf[2], kf[3]);
        }
      }
      continue;
    }

    // the V block: the softmax of the tile's S, then O += P V
    const __nv_bfloat16* sv = sq;
    if (!full) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * tq + (e & 1);
          const int row = w0 + gq + (e >> 1) * 8;
          bool ok = key < t_len;
          if (causal)
            ok = ok && key <= row && (window <= 0 || key > row - window);
          if (!ok) s[j][e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ms[r] = mx[r] * scale_log2;
      const float alpha = ex2((m[r] - mx[r]) * scale_log2);
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
    }
    unsigned pa[W_BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = ex2(fmaf(s[j][0], scale_log2, -ms[0]));
      const float p1 = ex2(fmaf(s[j][1], scale_log2, -ms[0]));
      const float p2 = ex2(fmaf(s[j][2], scale_log2, -ms[1]));
      const float p3 = ex2(fmaf(s[j][3], scale_log2, -ms[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = hopper::pack_bf16x2(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = hopper::pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < W_BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        unsigned vf[4];
        hopper::ldmatrix_x4_trans(vf, sv + (kk * 16 + (lane & 7)
                                            + ((lane >> 3) & 1) * 8) * VP
                                          + n * 8 + (lane >> 4) * 8);
        hopper::mma_bf16(acc[n], pa[kk], vf[0], vf[1]);
        hopper::mma_bf16(acc[n + 1], pa[kk], vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  if (lse != nullptr && col0 == 0 && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + gq + 8 * r;
      if (row < s_len)
        lse[(static_cast<int64_t>(b) * h_q + h) * s_len + row] =
            l[r] > 0.f ? (m[r] * scale_log2 + __log2f(l[r])) * LN2
                       : -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gq + 8 * r;
    if (row >= s_len) continue;
    __nv_bfloat16* op = out + (static_cast<int64_t>(b) * s_len + row) * qrow
                        + static_cast<int64_t>(h) * dh + col0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (col0 + n * 8 < dh)           // dh % 8 == 0: whole 8-column tiles
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                  acc[n][2 * r + 1] * inv[r]);
  }
}

// f32: IEEE FMAs on the CUDA cores, as flash_attention_kernel: four
// threads a query row, 64 rows a CTA, 32-key tiles staged in shared
// memory 64 columns at a time (the K chunks, then the V block of the
// CTA's 64 columns); a thread's share of q is read again for every chunk.
constexpr int WF_TPR = 4;                 // threads per query row
constexpr int WF_NT = W_BQ * WF_TPR;
constexpr int WF_BK = 32;                 // keys per tile
constexpr int WF_DB = 64;                 // columns of O a CTA owns
constexpr int WF_NF = W_KC / (4 * WF_TPR);  // float4s of a chunk a thread

__global__ void __launch_bounds__(WF_NT)
flash_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int s_len, int t_len, int h_q,
                      int g, int dh, int causal, int window, float scale) {
  __shared__ __align__(16) float ts[WF_BK][W_KC];   // a K chunk or V block
  const int nvb = (dh + WF_DB - 1) / WF_DB;
  const int h = blockIdx.x / nvb;
  const int col0 = (blockIdx.x % nvb) * WF_DB;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * W_BQ;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int r = threadIdx.x / WF_TPR;
  const int c = threadIdx.x % WF_TPR;
  const int qi = q0 + r;
  const bool live = qi < s_len;

  int lo = 0, hi = t_len - 1;
  if (causal) {
    hi = min(qi, t_len - 1);
    if (window > 0) lo = max(qi - window + 1, 0);
  }
  int k_begin = 0, k_end = t_len;
  if (causal) {
    const int last = min(q0 + W_BQ, s_len) - 1;
    k_end = min(last + 1, t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / WF_BK) * WF_BK;

  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  const float* qp = q + (static_cast<int64_t>(b) * s_len + (live ? qi : 0))
                        * qrow + static_cast<int64_t>(h) * dh;
  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const float* kb = k + static_cast<int64_t>(b) * t_len * krow
                    + static_cast<int64_t>(kh) * dh;
  const float* vb = v + static_cast<int64_t>(b) * t_len * krow
                    + static_cast<int64_t>(kh) * dh;
  // stage rows t0 .. t0 + WF_BK - 1, columns c0 .. c0 + 63 of x into ts
  // (zeros past T and past dh)
  const auto stage = [&](const float* x, int t0, int c0) {
    for (int idx = threadIdx.x * 4; idx < WF_BK * W_KC; idx += WF_NT * 4) {
      const int j = idx / W_KC, d = idx % W_KC;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (t0 + j < t_len && c0 + d < dh)
        load_row<4>(x + (t0 + j) * krow + c0 + d, f);
      *reinterpret_cast<float4*>(&ts[j][d]) = make_float4(f[0], f[1], f[2],
                                                          f[3]);
    }
  };

  float acc[WF_NF][4];
#pragma unroll
  for (int f = 0; f < WF_NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += WF_BK) {
    const bool need = live && t0 <= hi && t0 + WF_BK - 1 >= lo;
    const bool wneed = __any_sync(0xffffffffu, need);
    float sc[WF_BK];
#pragma unroll
    for (int j = 0; j < WF_BK; ++j) sc[j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += W_KC) {
      __syncthreads();              // the previous tile or chunk is consumed
      stage(kb, t0, c0);
      __syncthreads();
      if (!wneed) continue;
      float qr[WF_NF][4];
#pragma unroll
      for (int f = 0; f < WF_NF; ++f) {
        const int col = c0 + (f * WF_TPR + c) * 4;
        if (col < dh) {
          load_row<4>(qp + col, qr[f]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qr[f][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) qr[f][e] *= scale;
      }
#pragma unroll
      for (int j = 0; j < WF_BK; ++j) {
        float part = 0.f;
#pragma unroll
        for (int f = 0; f < WF_NF; ++f) {
          const float4 kx = *reinterpret_cast<const float4*>(
              &ts[j][(f * WF_TPR + c) * 4]);
          part += qr[f][0] * kx.x + qr[f][1] * kx.y + qr[f][2] * kx.z +
                  qr[f][3] * kx.w;
        }
        sc[j] += part;
      }
    }
    __syncthreads();                // the last chunk is consumed
    stage(vb, t0, col0);            // the CTA's columns of V
    __syncthreads();
    if (!wneed) continue;
    float mx = m;
#pragma unroll
    for (int j = 0; j < WF_BK; ++j) {
      sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 1);
      sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 2);
      const int t = t0 + j;
      sc[j] = t >= lo && t <= hi ? sc[j] : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int f = 0; f < WF_NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] *= alpha;
#pragma unroll
    for (int j = 0; j < WF_BK; ++j) {
      const int t = t0 + j;
      const float p = (t >= lo && t <= hi) ? expf(sc[j] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int f = 0; f < WF_NF; ++f) {
        const float4 vx = *reinterpret_cast<const float4*>(
            &ts[j][(f * WF_TPR + c) * 4]);
        acc[f][0] += p * vx.x; acc[f][1] += p * vx.y;
        acc[f][2] += p * vx.z; acc[f][3] += p * vx.w;
      }
    }
    m = mx;
  }

  if (!live) return;
  if (lse != nullptr && col0 == 0 && c == 0)
    lse[(static_cast<int64_t>(b) * h_q + h) * s_len + qi] =
        l > 0.f ? m + logf(l) : -INFINITY;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  float* op = out + (static_cast<int64_t>(b) * s_len + qi) * qrow
              + static_cast<int64_t>(h) * dh + col0;
#pragma unroll
  for (int f = 0; f < WF_NF; ++f) {
    const int col = (f * WF_TPR + c) * 4;
    if (col0 + col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) op[col + e] = acc[f][e] * inv;
  }
}

}  // namespace

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
    flash_wide_f32_kernel<<<grid, WF_NT, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, s_len,
        t_len, h_q, g, dh, causal, window, scale);
  } else {
    static bool smem_set = false;   // the attribute, once
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_wide_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          W_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = true;
    }
    flash_wide_mma_kernel<<<grid, W_NT, W_SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, s_len, t_len, h_q, g, dh,
        causal, window, scale * LOG2E);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // part 1
