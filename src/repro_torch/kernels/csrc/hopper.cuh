// Hopper (sm_90a) building blocks of the port's redesigned kernels:
// mbarriers, TMA tensor loads and stores, the proxy fence, setmaxnreg,
// wgmma shared-memory descriptors, fences and waits (the m64nNk16
// products themselves are in wgmma.cuh), mma.sync m16n8k16 with its
// ldmatrix feeds, the block's list of live experts, and the host's
// lookup of the CUDA driver's tensor-map encoder.  Sources that include
// this header compile alone, like every source of csrc.
//
// The libraries are built by nvcc and loaded with ctypes, without
// PyTorch's headers and without -lcuda: cuTensorMapEncodeTiled is a CUDA
// driver function, so encode_tensor_map() fetches it once through the
// runtime's cudaGetDriverEntryPoint, from the driver the process already
// has loaded.  That keeps the build a plain `nvcc -shared` (no link-time
// dependency on the driver's stub library, whose path differs between
// installations) and the encoder the one of the running driver.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA); a
// __syncthreads() after it makes them visible to the other threads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed.  A fresh
// barrier counts its (never run) phase of parity 1 as complete, so a
// producer's first wait on an empty slot, with parity 1, passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread asks for a whole box; the hardware reports its bytes to
// the barrier.  Elements of the box outside the tensor arrive as zeros
// and still count towards the bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The same with an L2 eviction policy for the box's lines.  The 64-bit
// policies are the fractional createpolicy encodings (CUTLASS's
// CacheHintSm90 values).
constexpr uint64_t L2_EVICT_FIRST = 0x12F0000000000000ull;
constexpr uint64_t L2_EVICT_LAST = 0x14F0000000000000ull;

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// A 4-D box, e.g. {64 columns of dh, 1 head, 64 rows, 1 batch} of a
// (B, S, H, dh) tensor: rows past S arrive as zeros, never the next
// batch's.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 3-D box from shared memory to the tensor, with an L2 policy; the
// part of the box outside the tensor is not written.  The store joins
// the thread's current bulk group (bulk_commit closes it).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of the thread's bulk groups still read shared
// memory (their sources may then be overwritten)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// waits until at most N of the thread's bulk groups are not complete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's ordinary shared-memory writes before later reads
// of the async proxy (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// setmaxnreg: a warpgroup gives registers back (a producer) or takes
// them (the consumers); every thread of the warpgroup executes it
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup (4 aligned warps) multiplies a 64-row A tile by an
// N-column B tile, both read from shared memory through descriptors, into
// f32 registers.
//
// Descriptor of a tile stored with the 128-byte swizzle that TMA writes
// (box rows of 64 bf16 = 128 bytes, 8-row atoms of 1024 bytes, atoms
// 1024-byte aligned so the base offset is 0):
//   bits  0-13  start address >> 4
//   bits 16-29  leading byte offset >> 4
//   bits 32-45  stride byte offset >> 4
//   bits 62-63  layout: 1 = 128-byte swizzle
// K-major operand (K contiguous in 128-byte rows): the stride byte offset
// is the step between 8-row groups (1024 bytes); the leading one is not
// used; a k-step of 16 elements moves the start by 32 bytes inside the
// swizzled row.  MN-major operand (M or N contiguous in 128-byte rows of
// 64 elements, K down the rows): the stride byte offset is the step
// between groups of 8 K rows (1024 bytes), the leading one the step
// between 64-wide blocks of M or N (one box each; unused for a single
// block); a k-step of 16 rows moves the start by 2048 bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(const void* smem,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// the same for register A operands (bf16 pairs), which an asynchronous
// product still reads after its issue
template <int R, int C>
__device__ __forceinline__ void fence_regs(unsigned (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// a barrier of the `threads` threads that name `id` (1-15; 0 is
// __syncthreads), e.g. one warpgroup
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrives at barrier `id` without waiting: the other threads of its count
// wait in named_barrier until these have arrived
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// two f32 values as a bf16x2 word, round to nearest even
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The experts whose count (clamped to [0, C]) is above 0, in expert
// order, written to live[] by a block scan of the flags; returns how
// many.  Every thread of the block calls it (it takes __syncthreads);
// warp_cnt holds one int per warp of the block.
__device__ __forceinline__ int live_experts(const int32_t* counts, int e_len,
                                            int c_len, int* live,
                                            int* warp_cnt) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  int n_live = 0;
  for (int e0 = 0; e0 < e_len; e0 += blockDim.x) {
    const int e = e0 + tid;
    const bool is_live = e < e_len && min(max(counts[e], 0), c_len) > 0;
    const unsigned m = __ballot_sync(0xffffffffu, is_live);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int before = n_live, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      total += warp_cnt[w];
    }
    if (is_live) live[before + __popc(m & ((1u << lane) - 1u))] = e;
    n_live += total;
    __syncthreads();            // the list is whole; warp_cnt is reused
  }
  return n_live;
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 operands, f32 accumulators) and its ldmatrix
// feeds, for the products too small for a warpgroup.  Fragment layouts
// (lane = 4 gq + tq):
//   A: a[0] (row gq, cols 2tq, 2tq+1), a[1] (row gq+8, same cols),
//      a[2] (row gq, cols 2tq+8, +9), a[3] (row gq+8, cols 2tq+8, +9)
//   B: b0 (k 2tq, 2tq+1; n gq), b1 (k 2tq+8, +9; n gq)
//   C: c[0], c[1] (row gq, cols 2tq, 2tq+1), c[2], c[3] (row gq+8, same)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16) b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, looked up once; null if the
// CUDA driver does not offer it
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
    looked = true;
  }
  return fn;
}

// A bf16 tensor map of `rank` (2-5) dims {dims[0] (contiguous), ...}
// with byte strides strides[0 .. rank-2] between the outer dims' steps,
// boxes of box[0 .. rank-1], the 128-byte swizzle (box[0] * 2 must be
// 128), out-of-range elements as zeros.  Returns false if the driver
// refuses it.
inline bool encode_tensor_map_nd(CUtensorMap* map, const void* base, int rank,
                                 const uint64_t* dims,
                                 const uint64_t* strides,
                                 const uint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || rank < 2 || rank > 5) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), d, s, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D bf16 tensor map of dims {d0 (contiguous), d1, d2} with byte
// strides s1, s2 between rows and planes, boxes of {b0, b1, 1}.
inline bool encode_tensor_map(CUtensorMap* map, const void* base, uint64_t d0,
                              uint64_t d1, uint64_t d2, uint64_t s1,
                              uint64_t s2, uint32_t b0, uint32_t b1) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint64_t strides[2] = {s1, s2};
  const uint32_t box[3] = {b0, b1, 1};
  return encode_tensor_map_nd(map, base, 3, dims, strides, box);
}

// The (dh, heads, rows, B) tensor map of a (B, rows, heads, dh) bf16
// tensor, in boxes of 64 columns of dh x 1 head x box_rows rows: rows
// past `rows` arrive as zeros, never the next batch's, and columns past
// dh as zeros, never the next head's (the flash kernels' Q, K, V, dO)
inline bool head_map(CUtensorMap* map, const void* p, int batch, int rows,
                     int heads, int dh, int box_rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(dh),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {2ull * dh, 2ull * heads * dh,
                               2ull * rows * heads * dh};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(box_rows), 1};
  return encode_tensor_map_nd(map, p, 4, dims, strides, box);
}

// The device's SM count, read once per device (the persistent grids)
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

}  // namespace hopper
