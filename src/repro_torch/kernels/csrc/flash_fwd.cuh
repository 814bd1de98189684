// The forward bodies of flash attention for NVIDIA Hopper (sm_90a), shared
// by flash_attention.cu and paged_flash_attention.cu, and templated on
// where a key's K and V rows come from (the bool PAGED):
//
// * contiguous (flash_attention.cu): key j of batch row b is row j of
//   k[b] and v[b], (B, T, Hkv, dh); query row i sits at position i, and
//   a causal mask compares i with j.
// * paged (paged_flash_attention.cu): key j of batch row b is slot
//   j % page of pool page table[b][j / page] of a (num_pages + 1, page,
//   Hkv, dh) pool; query row i sits at position q_pos[b][i] (-1: a pad
//   row, which sees no key).  Key j is valid for the row when its table
//   entry is mapped (>= 0), j <= q_pos and, with a window, j > q_pos -
//   window: the mask the gather path builds over a paged_view
//   (models/attention.py), without the gather.  T is the table's width,
//   P * page; a tile's unmapped keys, and those past T, load the pool's
//   last (sink) page, so every load stays inside the pool, and are
//   masked.  An item's (or a CTA's) key range runs from its live rows'
//   lowest position (less the window) to their highest, read on the
//   device, so a CUDA graph that captures the launch replays it for any
//   start and fill.
//
// The bodies (see flash_attention.cu for what each is for and what
// bounds it): the f32 one on the CUDA cores (any T: the paged one reads
// f32 and, where the bf16 body cannot take a shape, bf16 rows through
// the table, element by element where dh is not a multiple of 4); the
// bf16 TMA + wgmma one up to dh 256 (paged: boxes of gcd(page, BN) rows,
// a multiple of 8, each a page's slots, at the page id the producer warp
// reads from the table, with the tile's mapped boxes as a bit mask beside
// the ring slot); and part 1's column-block bodies past 256.  Every
// paged-only line sits under `if constexpr (PAGED)`, so the contiguous
// instantiations compile to what they were.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

// What a paged body reads beside the pool; zeros for the contiguous ones.
struct Paged {
  const int* table;     // (B, p_max) int32, -1 = unmapped
  const int* q_pos;     // (B, S) int32, -1 = a pad row
  int p_max;
  int page;             // slots a page
  int sink;             // the pool's last page, loaded for unmapped keys
  int box_shift;        // bf16 TMA body: log2 of a box's rows
};

// the pool page of key j (< t_len = p_max * page) of batch row b; -1
// where the entry is unmapped or j is past the table
__device__ __forceinline__ int page_of(const Paged& pk, int b, int j,
                                       int t_len) {
  return j < t_len
             ? __ldg(pk.table + static_cast<int64_t>(b) * pk.p_max
                     + j / pk.page)
             : -1;
}

// the element offset of key j's row of KV head kh in pool page pid
__device__ __forceinline__ int64_t pool_row(const Paged& pk, int pid, int j,
                                            int hkv, int kh, int dh) {
  return ((static_cast<int64_t>(pid) * pk.page + j % pk.page) * hkv + kh)
         * dh;
}

// query row i's position: q_pos[b][i] inside the sequence, else -1
__device__ __forceinline__ int row_pos(const Paged& pk, int b, int s_len,
                                       int i) {
  return i < s_len ? __ldg(pk.q_pos + static_cast<int64_t>(b) * s_len + i)
                   : -1;
}

// The keys [k_begin, k_end) that rows of live positions lo .. hi may
// see (none where hi < 0: no live row).
__device__ __forceinline__ void pos_keys(int lo, int hi, int t_len,
                                         int window, int& k_begin,
                                         int& k_end) {
  k_begin = 0;
  k_end = 0;
  if (hi < 0) return;
  k_end = min(hi + 1, t_len);
  if (window > 0) k_begin = max(lo - window + 1, 0);
}

// The lowest and highest position of the live rows among r0 .. r0 + n - 1
// of batch row b, over the CTA (every thread calls it once; .y < 0 where
// none is live).
__device__ __forceinline__ int2 block_pos_range(const Paged& pk, int b,
                                                int s_len, int r0, int n) {
  __shared__ int lo, hi;
  if (threadIdx.x == 0) {
    lo = INT_MAX;
    hi = -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = row_pos(pk, b, s_len, r0 + i);
    if (p >= 0) {
      atomicMin(&lo, p);
      atomicMax(&hi, p);
    }
  }
  __syncthreads();
  return make_int2(lo, hi);
}

// The same over the warp's lanes (every lane calls it): the live rows'
// lowest and highest position, and the lowest position of any row
// inside the sequence, pad rows' -1 included.
struct PosRange {
  int lo, hi, lo_all;
};

__device__ __forceinline__ PosRange warp_pos_range(const Paged& pk, int b,
                                                   int s_len, int r0, int n,
                                                   int lane) {
  PosRange r{INT_MAX, -1, INT_MAX};
  for (int i = lane; i < n && r0 + i < s_len; i += 32) {
    const int p = __ldg(pk.q_pos + static_cast<int64_t>(b) * s_len + r0 + i);
    r.lo_all = min(r.lo_all, p);
    if (p >= 0) {
      r.lo = min(r.lo, p);
      r.hi = max(r.hi, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r.lo = min(r.lo, __shfl_xor_sync(0xffffffffu, r.lo, off));
    r.hi = max(r.hi, __shfl_xor_sync(0xffffffffu, r.hi, off));
    r.lo_all = min(r.lo_all, __shfl_xor_sync(0xffffffffu, r.lo_all, off));
  }
  return r;
}

// up to 4 elements of a row at p into f32 (n of them inside dh, zeros
// after): one load_row where vec (dh a multiple of 4) and all 4 are
// inside, else element by element
template <typename T>
__device__ __forceinline__ void load_upto4(const T* p, int n, bool vec,
                                           float (&o)[4]) {
  if (vec && n >= 4) {
    load_row<4>(p, o);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = e < n ? load_one(p + e) : 0.f;
}


constexpr int BQ = 64;           // query rows per CTA
constexpr int TPR = 4;           // threads per query row
constexpr int NT = BQ * TPR;     // threads per CTA

// keys per shared-memory tile: 32, and 16 at DH 256, where the f32 K and
// V tiles would pass the 48 KB of static shared memory
__host__ __device__ constexpr int f32_keys(int dh) {
  return dh > 128 ? 16 : 32;
}

// Paged: k and v are the pools, t_len = p_max * page, causal is 1; a
// tile's key rows come through the table (unmapped ones as zeros,
// flagged in kmapped and masked), and any dh runs (element by element where
// it is not a multiple of 4).
template <typename T, int DH, bool PAGED>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int s_len, int t_len, int h_q,
                       int g, int dh, int causal, int window, float scale,
                       const Paged pk) {
  constexpr int NF = DH / (4 * TPR);  // float4 chunks of a row per thread
  constexpr int BK = f32_keys(DH);
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH];
  __shared__ bool kmapped[PAGED ? BK : 1];   // paged: the tile's mapped keys

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int r = threadIdx.x / TPR;    // query row within the block
  const int c = threadIdx.x % TPR;    // this thread's share of the row
  const int qi = q0 + r;
  const bool live = qi < s_len;
  // the row's position: its index, or (paged) its q_pos
  const int rp = PAGED ? row_pos(pk, b, s_len, qi) : qi;
  const bool vec = (dh & 3) == 0;

  // this row's valid keys: [lo, hi]
  int lo = 0, hi = t_len - 1;
  if (causal) {
    hi = min(rp, t_len - 1);
    if (window > 0) lo = max(rp - window + 1, 0);
  }
  // the CTA's live key range: the union of its rows' ranges
  int k_begin = 0, k_end = t_len;
  if constexpr (PAGED) {
    const int2 pr = block_pos_range(pk, b, s_len, q0, BQ);
    pos_keys(pr.x, pr.y, t_len, window, k_begin, k_end);
  } else if (causal) {
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
      if (PAGED && col < dh) {
        load_upto4(qp + col, dh - col, vec, qr[f]);
      } else if (col < dh) {
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
      if constexpr (PAGED) {
        const int pid = page_of(pk, b, t, t_len);
        if (pid >= 0 && d < dh) {
          const int64_t off = pool_row(pk, pid, t, hkv, kh, dh) + d;
          load_upto4(k + off, dh - d, vec, kx);
          load_upto4(v + off, dh - d, vec, vx);
        }
        if (d == 0) kmapped[j] = pid >= 0;
      } else if (t < t_len && d < dh) {
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
      const bool ok = t >= lo && t <= hi && (!PAGED || kmapped[j]);
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
      const float p = (t >= lo && t <= hi && (!PAGED || kmapped[j]))
                          ? expf(sc[j] - mx) : 0.f;
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
    for (int e = 0; e < 4; ++e)
      if (!PAGED || col + e < dh) store_one(op + col + e, acc[f][e] * inv);
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
  // the barriers, then (paged) each K slot's mask of mapped boxes
  static constexpr int BAR_BYTES = (4 * STAGES + 2) * 8 + 4 * STAGES;
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

// A paged tile's mask beside the thread's two rows: their positions (-1
// for a pad row or one past S), and the tile's mapped boxes (bit x: keys
// x << box_shift ..), as the producer read them from the table.
struct RowMask {
  int pos[2];
  uint32_t boxes;
  int box_shift;
};

// The softmax of a tile's S (64 x BN, the accumulator layout) in place:
// masks where the tile is not whole, the rows' new running max m, P =
// exp2 of the scaled scores less it, and the running sums l; alpha gets
// each row's rescale of O (exactly 1 while a row has seen no valid key:
// m - mx is then 0, both NEG_INF).  Rows row_r and row_r + 8 (paged: at
// positions rm.pos); key column 8j + kc (+1) of the tile starting at t0.
template <int BN, bool PAGED = false>
__device__ __forceinline__ void online_softmax(
    float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool whole, int t0, int row_r, int kc, int t_len, int causal,
    int window, float scale_log2, const RowMask rm = RowMask{}) {
  if (!whole) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (PAGED) {
          const int col = 8 * j + kc + (e & 1);
          const int key = t0 + col;
          const int p = rm.pos[e >> 1];
          const bool ok = key < t_len && ((rm.boxes >> (col >> rm.box_shift))
                                          & 1u)
                          && key <= p && (window <= 0 || key > p - window);
          if (!ok) s[4 * j + e] = -INFINITY;
        } else {
          const int key = t0 + 8 * j + kc + (e & 1);
          const int row = row_r + 8 * (e >> 1);
          bool ok = key < t_len;
          if (causal)
            ok = ok && key <= row && (window <= 0 || key > row - window);
          if (!ok) s[4 * j + e] = -INFINITY;
        }
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
//
// Paged: the K and V maps are (dh, Hkv, page, num_pages + 1) maps of the
// pools in boxes of 1 << box_shift rows (gcd(page, BN), at least 8, so
// each box starts on a 1024-byte swizzle atom and lies in one page), and
// the whole producer warp runs the walk: its lanes read the item's rows'
// positions (the item's tiles: from the lowest live position, less the
// window, to the highest) and each tile's page ids, one box a lane,
// before the slot is free; lane 0 writes the tile's mapped boxes beside
// the slot, then issues the boxes (an unmapped one from the sink page:
// every box arrives, so the tx count is the tile's bytes).  Each
// consumer reads that mask when the tile has landed, before it releases
// the slot, and its rows' positions once an item.  An item with no live
// row has no tile: it loads its Q alone and writes zeros.
template <int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int batch, int s_len,
                     int t_len, int h_q, int g, int dh, int causal,
                     int window, float scale_log2, const Paged pk) {
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
  uint32_t* kmask = reinterpret_cast<uint32_t*>(qempty + 1);   // paged

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
  // paged: the same from the item's rows' positions (every lane of the
  // calling warp)
  const auto paged_tiles = [&](const Item& w, int& k_begin) {
    const PosRange pr =
        warp_pos_range(pk, w.b, s_len, w.q0, CTA_ROWS, lane);
    int k_end;
    pos_keys(pr.lo, pr.hi, t_len, window, k_begin, k_end);
    k_begin = (k_begin / BN) * BN;
    return k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  };

  if (wg == NWG) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if constexpr (PAGED) {
      if (warp != NWG * 4) return;
      const int nbox = BN >> pk.box_shift;
      const int rows = 1 << pk.box_shift;
      int ring = 0;                      // tiles issued, over all items
      for (int r = 0;; ++r) {
        const int it = item_at(r);
        if (it >= n_items) break;
        const Item w = item_of(it, h_q, batch, blocks);
        const int kh = w.h / g;
        int k_begin;
        const int n_tiles = paged_tiles(w, k_begin);
        if (r > 0) hopper::mbar_wait(qempty, (r - 1) & 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(qfull, F::Q_BYTES);
#pragma unroll 1
          for (int c = 0; c < NWG; ++c)
#pragma unroll 1
            for (int bx = 0; bx < NB; ++bx)
              hopper::tma_load_4d(sq + (c * NB + bx) * F::Q_BOX, &qmap,
                                  qfull, bx * BOX, w.h, w.q0 + c * WG_ROWS,
                                  w.b);
        }
        for (int tile = 0; tile < n_tiles; ++tile, ++ring) {
          const int st = ring % ST;
          const uint32_t ph = ((ring / ST) & 1) ^ 1;
          // lane x: box x's page (the sink where unmapped) and slot
          const int key = k_begin + tile * BN + lane * rows;
          const int pid = lane < nbox ? page_of(pk, w.b, key, t_len) : -1;
          const uint32_t mapped = __ballot_sync(0xffffffffu, pid >= 0);
          const int src = pid >= 0 ? pid : pk.sink;
          const int slot = key % pk.page;
          hopper::mbar_wait(&kempty[st], ph);
          if (lane == 0) {
            kmask[st] = mapped;
            hopper::mbar_arrive_expect_tx(&kfull[st], F::TILE);
          }
#pragma unroll 1
          for (int x = 0; x < nbox; ++x) {
            const int px = __shfl_sync(0xffffffffu, src, x);
            const int sx = __shfl_sync(0xffffffffu, slot, x);
            if (lane == 0)
#pragma unroll 1
              for (int bx = 0; bx < NB; ++bx)
                hopper::tma_load_4d(sk + st * F::TILE + bx * F::KV_BOX
                                        + x * rows * 128,
                                    &kmap, &kfull[st], bx * BOX, kh, sx, px);
          }
          hopper::mbar_wait(&vempty[st], ph);
          if (lane == 0) hopper::mbar_arrive_expect_tx(&vfull[st], F::TILE);
#pragma unroll 1
          for (int x = 0; x < nbox; ++x) {
            const int px = __shfl_sync(0xffffffffu, src, x);
            const int sx = __shfl_sync(0xffffffffu, slot, x);
            if (lane == 0)
#pragma unroll 1
              for (int bx = 0; bx < NB; ++bx)
                hopper::tma_load_4d(sv + st * F::TILE + bx * F::KV_BOX
                                        + x * rows * 128,
                                    &vmap, &vfull[st], bx * BOX, kh, sx, px);
          }
        }
      }
    } else if (tid == NWG * 128) {
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
    const int n_tiles = PAGED ? paged_tiles(w, k_begin)
                              : tiles_of(w.q0, k_begin);
    const int w0 = w.q0 + wg * WG_ROWS;        // the warpgroup's first row
    const int w_last = min(w0 + WG_ROWS - 1, s_len - 1);
    const int row_r = w0 + 16 * (warp & 3) + (lane >> 2);  // and row_r + 8
    // paged: the warpgroup's rows' positions, and this thread's two
    PosRange wr{};
    RowMask rm{};
    if constexpr (PAGED) {
      wr = warp_pos_range(pk, w.b, s_len, w0, WG_ROWS, lane);
      rm.pos[0] = row_pos(pk, w.b, s_len, row_r);
      rm.pos[1] = row_pos(pk, w.b, s_len, row_r + 8);
      rm.box_shift = pk.box_shift;
    }

    // does a row of the warpgroup need tile i, and is every (row, key)
    // pair of it valid?  The tiles needed are one run [first, last).
    const auto need = [&](int i) {
      const int t0 = k_begin + i * BN;
      if constexpr (PAGED)
        return wr.hi >= 0 && t0 <= wr.hi
               && (window <= 0 || t0 + BN - 1 > wr.lo - window);
      bool ok = w0 < s_len;
      if (causal) {
        ok = ok && t0 <= w_last;
        if (window > 0) ok = ok && t0 + BN - 1 > w0 - window;
      }
      return ok;
    };
    // (paged: and every box of the tile mapped, and no pad row)
    const auto whole = [&](int i) {
      const int t0 = k_begin + i * BN;
      if constexpr (PAGED)
        return t0 + BN <= t_len
               && rm.boxes == (1u << (BN >> pk.box_shift)) - 1u
               && t0 + BN - 1 <= wr.lo_all
               && (window <= 0 || t0 > wr.hi - window);
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
        if constexpr (PAGED) rm.boxes = kmask[st];   // before the release
        turns.take();
        hopper::fence_regs(s);
        hopper::wgmma_fence();
        issue_s<DH>(s, my_q, sk + st * F::TILE);
        turns.give();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        release(&kempty[st]);
        // O is 0: nothing to rescale
        online_softmax<BN, PAGED>(s, m, l, alpha, whole(first),
                                  k_begin + first * BN, row_r, kc, t_len,
                                  causal, window, scale_log2, rm);
        pack_p<BN>(s, p);
      }
      for (int i = first + 1; i < last; ++i) {
        const int st = (ring + i) % ST;
        const int pst = (ring + i - 1) % ST;
        hopper::mbar_wait(&kfull[st], ((ring + i) / ST) & 1);
        if constexpr (PAGED) rm.boxes = kmask[st];
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
        online_softmax<BN, PAGED>(s, m, l, alpha, whole(i),
                                  k_begin + i * BN, row_r, kc, t_len,
                                  causal, window, scale_log2, rm);
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
// the V block of the CTA's columns; rows past S, keys that key_row(j)
// finds absent (-1: past T, or an unmapped page) and columns past dh as
// zeros.  key_row(j) is the element offset of key j's row from kb and vb.
template <typename KeyRow>
__device__ __forceinline__ void wide_issue(
    __nv_bfloat16* st, int i, int nch, const __nv_bfloat16* qb,
    int64_t qrow, const __nv_bfloat16* kb, const __nv_bfloat16* vb,
    KeyRow key_row, int q0, int s_len, int k_begin, int dh, int col0) {
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
      const int64_t off = key_row(k0 + row);
      const bool kok = off >= 0 && c0 + col < dh;
      cp_async16(sk + row * W_CP + col, kb + (kok ? off + c0 + col : 0),
                 kok);
    }
  } else {
    constexpr int VP = W_DB + 8;
#pragma unroll
    for (int j = 0; j < W_BK * (W_DB / 8) / W_NT; ++j) {
      const int c = threadIdx.x + j * W_NT;
      const int row = c / (W_DB / 8);
      const int col = (c % (W_DB / 8)) * 8;
      const int64_t off = key_row(k0 + row);
      const bool ok = off >= 0 && col0 + col < dh;
      cp_async16(st + row * VP + col, vb + (ok ? off + col0 + col : 0), ok);
    }
  }
}

// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators): four
// warps of 16 query rows, P rounded to
// bf16 in registers as the A fragments of P V, the online softmax in exp2
// units.  Q and K arrive in 64-column chunks through a 3-stage cp.async
// ring, so shared memory does not grow with dh; each tile's S sums its
// chunks, then the V block of the CTA's W_DB columns arrives.  Paged:
// key rows through the table (unmapped ones as zeros), every tile masked
// element by element (the mask reads the table again).
template <bool PAGED>
__global__ void __launch_bounds__(W_NT, 1)
flash_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int s_len, int t_len, int h_q,
                      int g, int dh, int causal, int window,
                      float scale_log2, const Paged pk) {
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
  // paged: the positions of the thread's rows w0 + gq (+ 8), and the
  // warp's live rows' range
  int rp[2] = {0, 0};
  PosRange wr{};
  if constexpr (PAGED) {
    const int2 pr = block_pos_range(pk, b, s_len, q0, W_BQ);
    pos_keys(pr.x, pr.y, t_len, window, k_begin, k_end);
    wr = warp_pos_range(pk, b, s_len, w0, 16, lane);
    rp[0] = row_pos(pk, b, s_len, w0 + gq);
    rp[1] = row_pos(pk, b, s_len, w0 + gq + 8);
  } else if (causal) {
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
  if constexpr (PAGED) {        // rows are addressed from the pools' start
    kb = k;
    vb = v;
  }
  const auto key_row = [&](int j) -> int64_t {
    if constexpr (PAGED) {
      const int pid = page_of(pk, b, j, t_len);
      return pid >= 0 ? pool_row(pk, pid, j, hkv, kh, dh) : -1;
    }
    return j < t_len ? j * krow : -1;
  };

#pragma unroll
  for (int st = 0; st < W_ST - 1; ++st) {
    if (st < items)
      wide_issue(smem + st * STAGE, st, nch, qb, qrow, kb, vb, key_row, q0,
                 s_len, k_begin, dh, col0);
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
                 qrow, kb, vb, key_row, q0, s_len, k_begin, dh, col0);
    cp_async_commit();

    const int part = i % (nch + 1);
    const int k0 = k_begin + (i / (nch + 1)) * W_BK;
    bool need = w0 < s_len;
    bool full = k0 + W_BK <= t_len;
    if constexpr (PAGED) {
      need = wr.hi >= 0 && k0 <= wr.hi
             && (window <= 0 || k0 + W_BK - 1 > wr.lo - window);
      full = false;
    } else if (causal) {
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
          if constexpr (PAGED) {
            const int p = rp[e >> 1];
            ok = key <= p && (window <= 0 || key > p - window)
                 && page_of(pk, b, key, t_len) >= 0;
          } else if (causal) {
            ok = ok && key <= row && (window <= 0 || key > row - window);
          }
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

//
// Paged, for f32 and for a bf16 head that is not a multiple of 8: rows
// through the table, element by element where dh is not a multiple of 4;
// the tile's mapped keys flagged in kmapped.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(WF_NT)
flash_wide_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int s_len, int t_len, int h_q,
                      int g, int dh, int causal, int window, float scale,
                      const Paged pk) {
  __shared__ __align__(16) float ts[WF_BK][W_KC];   // a K chunk or V block
  __shared__ bool kmapped[PAGED ? WF_BK : 1];
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
  const int rp = PAGED ? row_pos(pk, b, s_len, qi) : qi;
  const bool vec = (dh & 3) == 0;

  int lo = 0, hi = t_len - 1;
  if (causal) {
    hi = min(rp, t_len - 1);
    if (window > 0) lo = max(rp - window + 1, 0);
  }
  int k_begin = 0, k_end = t_len;
  if constexpr (PAGED) {
    const int2 pr = block_pos_range(pk, b, s_len, q0, W_BQ);
    pos_keys(pr.x, pr.y, t_len, window, k_begin, k_end);
  } else if (causal) {
    const int last = min(q0 + W_BQ, s_len) - 1;
    k_end = min(last + 1, t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / WF_BK) * WF_BK;

  const int64_t qrow = static_cast<int64_t>(h_q) * dh;
  const T* qp = q + (static_cast<int64_t>(b) * s_len + (live ? qi : 0))
                    * qrow + static_cast<int64_t>(h) * dh;
  const int64_t krow = static_cast<int64_t>(hkv) * dh;
  const T* kb = k + static_cast<int64_t>(b) * t_len * krow
                + static_cast<int64_t>(kh) * dh;
  const T* vb = v + static_cast<int64_t>(b) * t_len * krow
                + static_cast<int64_t>(kh) * dh;
  if constexpr (PAGED) {        // rows are addressed from the pools' start
    kb = k;
    vb = v;
  }
  // stage rows t0 .. t0 + WF_BK - 1, columns c0 .. c0 + 63 of x into ts
  // (zeros past T and past dh)
  const auto stage = [&](const T* x, int t0, int c0) {
    for (int idx = threadIdx.x * 4; idx < WF_BK * W_KC; idx += WF_NT * 4) {
      const int j = idx / W_KC, d = idx % W_KC;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (PAGED) {
        const int pid = page_of(pk, b, t0 + j, t_len);
        if (pid >= 0 && c0 + d < dh)
          load_upto4(x + pool_row(pk, pid, t0 + j, hkv, kh, dh) + c0 + d,
                     dh - c0 - d, vec, f);
        if (d == 0) kmapped[j] = pid >= 0;
      } else if (t0 + j < t_len && c0 + d < dh) {
        load_row<4>(x + (t0 + j) * krow + c0 + d, f);
      }
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
        if (PAGED && col < dh) {
          load_upto4(qp + col, dh - col, vec, qr[f]);
        } else if (col < dh) {
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
      sc[j] = t >= lo && t <= hi && (!PAGED || kmapped[j]) ? sc[j] : NEG_INF;
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
      const float p = (t >= lo && t <= hi && (!PAGED || kmapped[j]))
                          ? expf(sc[j] - mx) : 0.f;
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
  T* op = out + (static_cast<int64_t>(b) * s_len + qi) * qrow
          + static_cast<int64_t>(h) * dh + col0;
#pragma unroll
  for (int f = 0; f < WF_NF; ++f) {
    const int col = (f * WF_TPR + c) * 4;
    if (col0 + col >= dh) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (PAGED) {
        if (col0 + col + e < dh) store_one(op + col + e, acc[f][e] * inv);
      } else {
        op[col + e] = acc[f][e] * inv;
      }
    }
  }
}


}  // namespace
