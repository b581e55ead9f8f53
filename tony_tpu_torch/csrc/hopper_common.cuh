// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels: TMA
// tile loads tracked by mbarriers, wgmma shared-memory descriptors for
// 128-byte-swizzled bf16 tiles, and the wgmma.mma_async m64nNk16 products
// (f32 accumulators in registers, A from shared memory or from registers).
//
// Tile layout. A bf16 tile of R rows by D columns (D = 64 or 128) lives in
// shared memory as D / 64 boxes, each R rows of 128 bytes in the 128-byte
// swizzle that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes (16-byte
// chunk c of row r sits at chunk c ^ (r % 8)). Box b starts at b * R * 128
// bytes; every box is 1024-byte aligned, which the swizzle needs. Nothing
// in the kernels addresses such a tile element by element except through
// a wgmma descriptor, or in an elementwise pass that does not care where
// an element sits.
//
// Register layouts (PTX ISA, wgmma m64nNk16, 128 threads of a warpgroup):
// thread t = 32w + l holds accumulator rows 16w + l/4 and 16w + l/4 + 8 and
// columns 8j + 2(l%4) + {0, 1}: d[4j + 2i + c] is row 16w + l/4 + 8i, column
// 8j + 2(l%4) + c. The A operand from registers (m64k16) is the same map
// over 16 columns, packed two bf16 per register: a[0] = (row, 2q..2q+1),
// a[1] = (row+8, 2q..), a[2] = (row, 2q+8..), a[3] = (row+8, 2q+8..). So an
// accumulator rounded to bf16 is the A operand of the next product with no
// data movement (acc_to_a below).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace tt {
namespace hop {

constexpr int BOX = 64;          // bf16 columns per 128-byte swizzled row
constexpr int SWZ_ATOM = 1024;   // bytes of one 8-row swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory (an elementwise pass over a tile)
// made visible to the async proxy (wgmma, TMA) that reads it next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- TMA
// One box of a 4-d tensor map ([B, S, H, D] viewed innermost first as
// {D, H, S, B}) into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// Load a [ROWS, D] bf16 tile (rows s0.. of head h, batch b) as D / 64 boxes.
// Rows past the sequence come in as zeros (the map's out-of-bounds fill).
template <int ROWS, int D>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int s0, int b) {
#pragma unroll
  for (int c = 0; c < D / BOX; ++c) tma_load_4d(dst + c * ROWS * BOX, map, bar, c * BOX, h, s0, b);
}

// ------------------------------------------------------- wgmma descriptors
__device__ __forceinline__ uint64_t desc_field(uint32_t x) { return (x & 0x3FFFF) >> 4; }
// 128-byte swizzle (layout type 1), 8-row groups SWZ_ATOM bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return desc_field(addr) | (desc_field(lbo) << 16) | (desc_field(SWZ_ATOM) << 32) | (1ull << 62);
}
// K-major operand: a [ROWS, D] tile whose D columns are the contraction.
// Step kk covers columns 16kk..16kk+15: box kk/4, 32 bytes per step inside
// the 128-byte row (the hardware applies the swizzle to the address).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile, int kk) {
  return make_desc(smem_u32(tile) + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16);
}
// MN-major operand: a [ROWS, D] tile whose ROWS are the contraction and whose
// D columns are the product's N. Step kk covers rows 16kk..16kk+15; the
// next 64 columns (the next box) are the leading byte offset away.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile, int kk) {
  return make_desc(smem_u32(tile) + kk * 16 * 128, ROWS * 128);
}

// ------------------------------------------------------ wgmma ordering
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers at this point of the program: the compiler may neither move
// a read of an accumulator above the wait that completes it nor reuse an
// A-operand register while a product that reads it is in flight.
template <int n>
__device__ __forceinline__ void pin(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int m, int n>
__device__ __forceinline__ void pin(uint32_t (&r)[m][n]) {
#pragma unroll
  for (int i = 0; i < m; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ------------------------------------------------------------ wgmma products
// d (64 x N, f32) = A (64 x 16) . B (16 x N) + (acc ? d : 0), bf16 inputs.
// ss: A and B both K-major in shared memory (B stored [N][16], so
//     d = A . B^T in row-major terms); d is overwritten when acc is 0.
// rs: A from registers, B MN-major in shared memory (stored [16][N], the
//     transpose bit set); always accumulates.
#define TT_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TT_D32 TT_D8(0), TT_D8(8), TT_D8(16), TT_D8(24)
#define TT_D64 TT_D32, TT_D8(32), TT_D8(40), TT_D8(48), TT_D8(56)
#define TT_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TT_R64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63}"

template <int N> struct Wg;

template <> struct Wg<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : TT_D32
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : TT_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wg<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TT_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : TT_D64
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TT_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : TT_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef TT_D8
#undef TT_D32
#undef TT_D64
#undef TT_R32
#undef TT_R64

// d (64 x N) = A . B^T over a contraction of 16 * KSTEPS: A is a K-major
// [64, 16 KSTEPS] tile and B a K-major [N, 16 KSTEPS] tile in shared
// memory. Issued, not waited for.
template <int KSTEPS, int N = 64>
__device__ __forceinline__ void mma_ss_kk(float (&d)[N / 2], const __nv_bfloat16* a,
                                          const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) Wg<N>::ss(d, desc_k<64>(a, kk), desc_k<N>(b, kk), kk > 0);
}

// d (64 x N) += A . B with A from registers (a[kk] covers contraction rows
// 16kk..16kk+15) and B an MN-major [16 KSTEPS, N] tile of ROWS rows.
template <int N, int KSTEPS, int ROWS>
__device__ __forceinline__ void mma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[KSTEPS][4],
                                          const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) Wg<N>::rs(d, a[kk], desc_mn<ROWS>(b, kk));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 16K accumulator rounded to bf16 as the A operand of K k-steps.
template <int K>
__device__ __forceinline__ void acc_to_a(const float (&c)[8 * K], uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// The two bf16 of a packed register, exactly, as f32.
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Multiply every bf16 of a shared tile by `scale` and round back to bf16:
// the reference's `x * scale` in the input dtype, in place. The layout does
// not matter to an elementwise pass. The caller fences and synchronises.
template <int ELEMS, int NT>
__device__ __forceinline__ void scale_tile(__nv_bfloat16* t, float scale, int tid) {
  constexpr int VEC = 8;
#pragma unroll 4
  for (int i = tid; i < ELEMS / VEC; i += NT) {
    uint4 v = reinterpret_cast<uint4*>(t)[i];
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    reinterpret_cast<uint4*>(t)[i] = v;
  }
}

// Write a 64 x N f32 accumulator as bf16 rows of global memory (row stride
// `stride` elements), rows at or past `nvalid` skipped.
template <int N>
__device__ __forceinline__ void store_acc(const float (&c)[N / 2], __nv_bfloat16* g, long stride,
                                          int nvalid, int tid) {
  const int w = tid >> 5, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), c0 = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nvalid) continue;
    __nv_bfloat16* row = g + (long)r * stride + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(c[4 * j + 2 * i], c[4 * j + 2 * i + 1]);
  }
}
// The same rows written as f32, unrounded.
template <int N>
__device__ __forceinline__ void store_acc(const float (&c)[N / 2], float* g, long stride,
                                          int nvalid, int tid) {
  const int w = tid >> 5, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), c0 = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nvalid) continue;
    float* row = g + (long)r * stride + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(c[4 * j + 2 * i], c[4 * j + 2 * i + 1]);
  }
}

// --------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A contiguous bf16 [B, S, Hx, D] tensor as a 4-d map with [ROWS, 64] boxes
// in the 128-byte swizzle; out-of-bounds rows read as zeros.
inline bool map_bshd(CUtensorMap* m, const void* p, int B, int S, int Hx, int D, int rows) {
  auto enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hx * D * 2,
                                 (cuuint64_t)S * Hx * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous f32 vector of n elements as a 1-d map with boxes of `box`
// elements; coordinates may start anywhere, past the end reads zeros.
inline bool map_vec(CUtensorMap* m, const void* p, long n, int box) {
  auto enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t bx[1] = {(cuuint32_t)box};
  const cuuint32_t estr[1] = {1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(p), dims, strides, bx, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
}  // namespace tt
