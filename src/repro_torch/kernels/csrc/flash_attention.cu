// Blocked causal (or non-causal) GQA attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel), reached through the model-layout wrapper
// src/repro/kernels/ops.py::flash_attention.  On the port's path it is the
// ring layout's one-shot causal prefill (self_attention_prefill).
//
// What it computes: out[b, i, h] = softmax(q[b,i,h] . K_b^T / sqrt(dh)) . V_b
// over the keys of KV head h / G.  Causal: key j is valid for query i when
// j <= i, and with a window also j > i - window; non-causal: every key
// j < T.  kv_len is the real T (keys are never padded).  Scores, softmax
// and sums are f32; the output takes q's type.  A query row with no valid
// key (causal with a window and S > T only) is written as zeros.
//
// Layouts are the model's, so nothing is transposed or padded:
//   q, out (B, S, H, dh)    element (b, i, h, d) at ((b*S + i)*H + h)*dh + d
//   k, v   (B, T, Hkv, dh)  element (b, j, h, d) at ((b*T + j)*Hkv + h)*dh + d
// G = H / Hkv is a run-time value.  dh is any multiple of 8 up to 128: the
// body is instantiated at DH = 32, 64 and 128, and a dh below DH (112 and
// 120 on the 128 one) loads zeros into the columns past dh of q and of
// the K/V tiles (cp.async's src-size 0) and stores only dh columns, so
// the DH-wide products compute the dh-wide attention; the scale is
// 1/sqrt(dh) of the real dh.  Every row start stays 16-byte aligned.
//
// What bounds it: operations.  4 * DH per (query row, head, valid key) --
// about 8.6 GFLOP for S = T = 1024, H = 32, DH = 128 causal, 8.7 us at the
// card's 989 TFLOP/s bf16 -- against a few MB of q, k, v and out.  Pallas
// carried (m, l, acc) across a sequential grid axis; here one CTA owns
// (b, q head, a block of query rows) and loops over the key tiles itself,
// only from the first to the last tile that the causal and window masks
// leave live.  Two bodies:
//
// * bf16: the tensor cores.  One CTA per (b, q head, 64 query rows), four
//   warps of 16 rows each.  S = Q K^T and O += P V run as mma.sync
//   m16n8k16 (bf16 operands, f32 accumulators).  A warp's Q fragments are
//   loaded once into registers.  K and V tiles of 64 keys arrive through a
//   2-stage (DH 128) or 3-stage (DH 32, 64) cp.async ring in dynamic shared
//   memory (up to 68 KB, past the 48 KB static limit, so the launcher sets
//   cudaFuncAttributeMaxDynamicSharedMemorySize once per instantiation);
//   rows of a ragged last tile are zero-filled by the src-size-0 form and
//   masked.  Tile rows are padded by 16 bytes, so the 8 rows an ldmatrix
//   reads fall on 8 different bank groups.  K is the B operand of QK^T
//   through plain ldmatrix, V that of PV through ldmatrix.trans.  The
//   online softmax stays in registers (a row's 4 lanes meet with two
//   shuffles), in exp2 (ex2.approx) with the scale folded with log2(e);
//   the running max starts at the finite NEG_INF, masked scores are -inf,
//   and the rescale takes exp2 of (m_old - m_new) * scale, exactly 1 while
//   a row has seen no valid key, so no NaN arises there.  P is rounded
//   to bf16 in registers and used directly as the A fragment of PV (the
//   C layout of m16n8 is the A layout of m16n8k16), with no trip through
//   shared memory.  Element masks apply only where a warp's tile is not
//   wholly valid: the diagonal, window edges and the ragged last tile; a
//   warp skips a tile none of its rows needs.  The grid launches the last
//   query blocks, the heaviest under a causal mask, first.
// * f32: IEEE FMAs on the CUDA cores (the first port's body).  The f32
//   sweeps are held to 2e-5, which TF32 on the tensor cores cannot meet,
//   so f32 parity at full width still runs a kernel.  One CTA per (b, q
//   head, 64 query rows) loops over 32-key tiles staged in shared memory
//   as f32; four threads share a query row, each holding DH/4 of q and of
//   the accumulator, interleaved by float4 so the four read one 64-byte
//   span of a shared K/V row.
//
// What holds the bf16 body back: at DH 128 a thread needs 243 registers,
// so two CTAs (8 warps) share an SM, and each warp's tile loop -- the
// dependent chain of QK^T, the softmax shuffles and exp2, then PV -- has
// few other warps to hide behind.  A trial of 128-row CTAs of 8 warps,
// which halve the K/V tile reads from L2, was no faster, so L2 traffic
// is not what bounds it.  Later work: wgmma with TMA-fed K/V tiles and
// warp-specialised producers (asynchronous products leave the warp
// schedulers free for the softmax), and one CTA per KV head sharing each
// K/V tile across its G query heads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 32;           // keys per shared-memory tile
constexpr int TPR = 4;           // threads per query row
constexpr int NT = BQ * TPR;     // threads per CTA

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int t_len, int h_q, int g, int dh, int causal,
                       int window, float scale) {
  constexpr int NF = DH / (4 * TPR);  // float4 chunks of a row per thread
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
// bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulation.
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;            // query rows per CTA
constexpr int TC_BK = 64;            // keys per tile
constexpr int TC_NT = TC_BQ * 2;     // one warp per 16 query rows

__host__ __device__ constexpr int tc_stages(int dh) {
  return dh == 128 ? 2 : 3;
}

// dynamic shared memory of one CTA: stages x (K tile, V tile), rows padded
constexpr int tc_smem_bytes(int dh) {
  return tc_stages(dh) * 2 * TC_BK * (dh + 8) * 2;
}

// 2^x in one MUFU op (flush to zero; 2^-inf = 0).  P is rounded to bf16
// next, far coarser than its ~2^-22 relative error.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// K and V rows k0 .. k0 + TC_BK - 1 of one KV head into a stage (the K
// tile, then the V tile, rows DH + 8 apart); rows past T and columns past
// dh as zeros
template <int DH>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* sk,
                                             const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb,
                                             int64_t krow, int k0,
                                             int t_len, int dh) {
  constexpr int P = DH + 8;
  constexpr int CPR = DH / 8;            // 16-byte chunks of a row
  static_assert((TC_BK * CPR) % TC_NT == 0, "a tile splits over the CTA");
  __nv_bfloat16* sv = sk + TC_BK * P;
#pragma unroll
  for (int i = 0; i < TC_BK * CPR / TC_NT; ++i) {
    const int c = threadIdx.x + i * TC_NT;
    const int row = c / CPR;
    const int col = (c % CPR) * 8;
    const bool ok = k0 + row < t_len && col < dh;
    const int64_t off = ok ? (k0 + row) * krow + col : 0;
    cp_async16(sk + row * P + col, kb + off, ok);
    cp_async16(sv + row * P + col, vb + off, ok);
  }
}

// Fragment layouts of m16n8k16 (lane = 4 * gq + tq):
//   A: a[0] (row gq, cols 2tq, 2tq+1), a[1] (row gq+8, same cols),
//      a[2] (row gq, cols 2tq+8, +9), a[3] (row gq+8, cols 2tq+8, +9)
//   B: b0 (k 2tq, 2tq+1; n gq), b1 (k 2tq+8, +9; n gq)
//   C: c[0], c[1] (row gq, cols 2tq, 2tq+1), c[2], c[3] (row gq+8, same)
template <int DH>
__global__ void __launch_bounds__(TC_NT, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int s_len,
                           int t_len, int h_q, int g, int dh, int causal,
                           int window, float scale_log2) {
  constexpr int P = DH + 8;             // tile pitch, bf16 (16 bytes of pad)
  constexpr int TILE = TC_BK * P;       // one K or V tile, bf16
  constexpr int ST = tc_stages(DH);
  constexpr int KS = DH / 16;           // k-steps of Q K^T
  constexpr int NS = TC_BK / 8;         // n-tiles of S (8 keys each)
  constexpr int ND = DH / 8;            // n-tiles of O (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int hkv = h_q / g;
  const int kh = h / g;
  const int w0 = q0 + warp * 16;              // the warp's first row
  const int w_last = min(w0 + 15, s_len - 1);  // its last live row

  // the CTA's live key range: the union of its rows' ranges, whole tiles
  int k_begin = 0, k_end = t_len;
  if (causal) {
    k_end = min(min(q0 + TC_BQ, s_len), t_len);
    if (window > 0) k_begin = max(q0 - window + 1, 0);
  }
  k_begin = (k_begin / TC_BK) * TC_BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + TC_BK - 1) / TC_BK
                                      : 0;

  const int64_t krow = static_cast<int64_t>(hkv) * dh;  // one key's stride
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * t_len * krow
                            + kh * dh;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * t_len * krow
                            + kh * dh;

#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < n_tiles)
      load_kv_tile<DH>(smem + st * 2 * TILE, kb, vb, krow,
                       k_begin + st * TC_BK, t_len, dh);
    cp_async_commit();
  }

  // the warp's 16 query rows as A fragments, once; rows past S and
  // columns past dh as zeros (with the zero K/V columns of the tiles, the
  // DH-wide loops compute a dh-wide attention)
  unsigned qa[KS][4];
  {
    const int r0 = w0 + gq;
    const int r1 = r0 + 8;
    const __nv_bfloat16* p0 =
        q + ((static_cast<int64_t>(b) * s_len + min(r0, s_len - 1)) * h_q
             + h) * dh;
    const __nv_bfloat16* p1 =
        q + ((static_cast<int64_t>(b) * s_len + min(r1, s_len - 1)) * h_q
             + h) * dh;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = kk * 16 + 2 * tq;
      const bool c0 = col < dh, c1 = col + 8 < dh;
      qa[kk][0] = r0 < s_len && c0 ? load_pair(p0 + col) : 0u;
      qa[kk][1] = r1 < s_len && c0 ? load_pair(p1 + col) : 0u;
      qa[kk][2] = r0 < s_len && c1 ? load_pair(p0 + col + 8) : 0u;
      qa[kk][3] = r1 < s_len && c1 ? load_pair(p1 + col + 8) : 0u;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows gq and gq + 8: running max (raw score units) and this lane's
  // part of the running sum (the row's 4 lanes add up at the end)
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();             // tile `it` landed; tile it - 1 consumed
    if (it + ST - 1 < n_tiles)
      load_kv_tile<DH>(smem + (it + ST - 1) % ST * 2 * TILE, kb, vb,
                       krow, k_begin + (it + ST - 1) * TC_BK, t_len, dh);
    cp_async_commit();

    const int k0 = k_begin + it * TC_BK;
    // warp-uniform: does any of the warp's live rows need this tile, and
    // is every (row, key) pair of it valid?
    bool need = w0 < s_len;
    bool full = k0 + TC_BK <= t_len;
    if (causal) {
      need = need && k0 <= w_last;
      full = full && k0 + TC_BK - 1 <= w0;
      if (window > 0) {
        need = need && k0 + TC_BK - 1 > w0 - window;
        full = full && k0 > w_last - window;
      }
    }
    if (!need) continue;

    const __nv_bfloat16* sk = smem + (it % ST) * 2 * TILE;
    const __nv_bfloat16* sv = sk + TILE;

    // S = Q K^T: 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        // keys j*8 .. j*8+7, head dims kk*16 .. kk*16+31: four 8x8 blocks
        unsigned kf[4];
        hopper::ldmatrix_x4(kf, sk + (j * 8 + (lane & 7)) * P + kk * 16
                                    + (lane >> 3) * 8);
        hopper::mma_bf16(s[j], qa[kk], kf[0], kf[1]);
        hopper::mma_bf16(s[j], qa[kk + 1], kf[2], kf[3]);
      }
    }

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

    // online softmax.  Masked scores are -inf and m starts at the finite
    // NEG_INF, so exp2 of a masked score is exactly 0 and never NaN.
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
      // m - mx first: exactly 0 while both are NEG_INF (an fma of m * c
      // against the rounded mx * c would leave a residual of ~1e22 there)
      const float alpha = ex2((m[r] - mx[r]) * scale_log2);
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
    }

    // P in bf16 as the A fragments of P V: key tiles 2kk and 2kk + 1 of S
    // make k-step kk
    unsigned pa[TC_BK / 16][4];
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

    // O += P V: keys kk*16 .. +15, head dims n*8 .. n*8+15
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        unsigned vf[4];
        hopper::ldmatrix_x4_trans(vf, sv + (kk * 16 + (lane & 7)
                                            + ((lane >> 3) & 1) * 8) * P
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
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;   // no valid key: zeros
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gq + 8 * r;
    if (row >= s_len) continue;
    __nv_bfloat16* op =
        out + ((static_cast<int64_t>(b) * s_len + row) * h_q + h) * dh
        + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh)                  // dh % 8 == 0: whole 8-column tiles
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                  acc[n][2 * r + 1] * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int batch, int s_len, int t_len, int h_q, int g,
                       int dh, int causal, int window, float scale,
                       cudaStream_t stream) {
  dim3 grid((s_len + BQ - 1) / BQ, h_q, batch);
  flash_attention_kernel<float, DH><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s_len, t_len,
      h_q, g, dh, causal, window, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int batch, int s_len, int t_len, int h_q,
                       int g, int dh, int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr int SMEM = tc_smem_bytes(DH);
  static bool smem_set = false;   // the attribute, once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int blocks = (s_len + TC_BQ - 1) / TC_BQ;
  if (batch > 65535 || blocks > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(h_q, batch, blocks);
  flash_attention_mma_kernel<DH><<<grid, TC_NT, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), s_len, t_len, h_q, g, dh, causal,
      window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores).  Any G = h_q / hkv (the kernels
// take it at run time) and any dh that is a multiple of 8 up to 128, on
// the 32, 64 or 128 wide instantiation with zero columns past dh.
// Returns the CUDA error of the launch (0 on success), or -1 when the
// (dtype, dh, G) combination is not supported.  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int s_len, int t_len, int h_q, int hkv,
                                      int dh, int causal, int window,
                                      float scale, void* stream) {
  if (hkv <= 0 || h_q % hkv != 0 || s_len <= 0 || t_len <= 0) return -1;
  const int g = h_q / hkv;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define FLASH_DH(DH_)                                                        \
  case DH_:                                                                  \
    err = dtype == 0 ? launch_f32<DH_>(q, k, v, out, batch, s_len, t_len,    \
                                       h_q, g, dh, causal, window, scale, st) \
                     : launch_mma<DH_>(q, k, v, out, batch, s_len, t_len,    \
                                       h_q, g, dh, causal, window, scale, st);\
    break
  if (dtype != 0 && dtype != 1) return -1;
  switch (head_width(dh)) {
    FLASH_DH(32);
    FLASH_DH(64);
    FLASH_DH(128);
    default: return -1;
  }
#undef FLASH_DH
  return static_cast<int>(err);
}
