// Paged decode attention for NVIDIA Hopper (sm_90a).
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
// does.  f32 arithmetic throughout, NEG_INF = -1e30, and l == 0 gives 0.
//
// Layouts are the model's, so no transpose of the pool is ever made:
//   q    (B, 1, Hkv*G, DH)           out (B, 1, Hkv*G, DH)
//   pool (Npool, page, Hkv, DH)      element (p, s, h, d) at
//                                    ((p*page + s)*Hkv + h)*DH + d
//   bt   (B, P) int32, ctx (B,) int32
//
// What bounds it: the bytes of K and V it must read, 2 * keys * Hkv * DH
// * sizeof(T) per sequence, against 3.35 TB/s of HBM.  The arithmetic is
// 4 * G * DH operations per key and head, far below the card's rates.
// The design keeps those reads to one pass: one CTA per (sequence, KV
// head) streams only the row's valid keys [lo, hi) once, and the whole
// GQA group of G query heads shares each K/V row it loads.  Each warp owns
// UNROLL consecutive keys at a time; a lane holds DH/32 contiguous
// elements, so a warp reads one K row as one coalesced transaction and the
// UNROLL rows' loads are in flight together.  Warp shuffles reduce q.k
// over DH.  The running (m, l, acc) of the G heads stay in registers and
// the NWARPS partial states merge once, in shared memory, at the end.
// Split-KV across CTAs, TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int UNROLL = 4;

template <typename T, int DH, int G>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int32_t* __restrict__ bt,
                    const int32_t* __restrict__ ctx, T* __restrict__ out,
                    int hkv, int page, int p_max, int n_pool, int window,
                    float scale) {
  constexpr int N = DH / 32;  // elements of a row each lane holds
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // valid keys of this row: [lo, hi).  hi never passes the table's
  // mapped width, so no row reads beyond its table.
  const int c = ctx[b];
  const int hi = min(c, p_max * page);
  const int lo = window > 0 ? max(c - window, 0) : 0;

  const int64_t row = static_cast<int64_t>(hkv) * DH;  // one slot's stride
  const int32_t* bt_b = bt + static_cast<int64_t>(b) * p_max;

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((static_cast<int64_t>(b) * hkv + h) * G + g) * DH
                  + lane * N;
    load_row<N>(qp, qr[g]);
#pragma unroll
    for (int i = 0; i < N; ++i) qr[g][i] *= scale;
  }

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  for (int k0 = lo + warp * UNROLL; k0 < hi; k0 += NWARPS * UNROLL) {
    float kr[UNROLL][N], vr[UNROLL][N];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = k0 + u;
      ok[u] = t < hi;
      const int tt = ok[u] ? t : k0;  // a valid key: its load is harmless
      int phys = bt_b[tt / page];
      // -1 reads page 0 (masked by position only, as the reference);
      // an id past the pool is clamped rather than read out of bounds
      phys = min(max(phys, 0), n_pool - 1);
      const int64_t off =
          (static_cast<int64_t>(phys) * page + tt % page) * row +
          static_cast<int64_t>(h) * DH + lane * N;
      load_row<N>(kpool + off, kr[u]);
      load_row<N>(vpool + off, vr[u]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[UNROLL];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part += qr[g][i] * kr[u][i];
        s[u] = ok[u] ? warp_sum(part) : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = ok[u] ? expf(s[u] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[g][i] += p * vr[u][i];
      }
      m[g] = mx;
    }
  }

  // cross-warp merge of the NWARPS partial softmax states
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][DH];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][g][lane * N + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += NWARPS * 32) {
    const int g = idx / DH;
    const int d = idx % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      a += sm_acc[w][g][d] * f;
    }
    const float o = a / (lsum == 0.f ? 1.f : lsum);
    store_one(out + ((static_cast<int64_t>(b) * hkv + h) * G + g) * DH + d,
              o);
  }
}

template <typename T, int DH, int G>
void launch(const void* q, const void* k, const void* v, const int32_t* bt,
            const int32_t* ctx, void* out, int batch, int hkv, int page,
            int p_max, int n_pool, int window, float scale,
            cudaStream_t stream) {
  dim3 grid(hkv, batch);
  paged_decode_kernel<T, DH, G><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, ctx, static_cast<T*>(out), hkv, page,
      p_max, n_pool, window, scale);
}

template <typename T, int DH>
bool dispatch_g(int g, const void* q, const void* k, const void* v,
                const int32_t* bt, const int32_t* ctx, void* out, int batch,
                int hkv, int page, int p_max, int n_pool, int window,
                float scale, cudaStream_t s) {
  switch (g) {
    case 1: launch<T, DH, 1>(q, k, v, bt, ctx, out, batch, hkv, page, p_max,
                             n_pool, window, scale, s); return true;
    case 2: launch<T, DH, 2>(q, k, v, bt, ctx, out, batch, hkv, page, p_max,
                             n_pool, window, scale, s); return true;
    case 4: launch<T, DH, 4>(q, k, v, bt, ctx, out, batch, hkv, page, p_max,
                             n_pool, window, scale, s); return true;
    case 7: launch<T, DH, 7>(q, k, v, bt, ctx, out, batch, hkv, page, p_max,
                             n_pool, window, scale, s); return true;
    case 8: launch<T, DH, 8>(q, k, v, bt, ctx, out, batch, hkv, page, p_max,
                             n_pool, window, scale, s); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch_dh(int dh, int g, const void* q, const void* k, const void* v,
                 const int32_t* bt, const int32_t* ctx, void* out, int batch,
                 int hkv, int page, int p_max, int n_pool, int window,
                 float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return dispatch_g<T, 32>(g, q, k, v, bt, ctx, out, batch, hkv,
                                      page, p_max, n_pool, window, scale, s);
    case 64: return dispatch_g<T, 64>(g, q, k, v, bt, ctx, out, batch, hkv,
                                      page, p_max, n_pool, window, scale, s);
    case 128: return dispatch_g<T, 128>(g, q, k, v, bt, ctx, out, batch, hkv,
                                        page, p_max, n_pool, window, scale,
                                        s);
    default: return false;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launch, or -1 when the
// (dtype, dh, G) combination has no instantiation.  The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, void* out, int batch,
    int hkv, int g, int dh, int page, int p_max, int n_pool, int window,
    float scale, void* stream) {
  const auto* bt = static_cast<const int32_t*>(block_tables);
  const auto* ctx = static_cast<const int32_t*>(ctx_lens);
  auto s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_dh<float>(dh, g, q, k_pool, v_pool, bt, ctx, out, batch,
                            hkv, page, p_max, n_pool, window, scale, s);
  else if (dtype == 1)
    ok = dispatch_dh<__nv_bfloat16>(dh, g, q, k_pool, v_pool, bt, ctx, out,
                                    batch, hkv, page, p_max, n_pool, window,
                                    scale, s);
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
