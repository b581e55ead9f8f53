// Shared pieces of the FMA flash-attention kernels (flash_fwd_kernel,
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel in flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu): tile sizes, tile loads from device
// memory into shared memory, and one block-level FMA matrix product on
// shared-memory tiles. They take f32 at every head_dim up to 256, and bf16
// at the head_dims the wgmma kernels of hopper_common.cuh do not take (not
// a multiple of 8; for the forward also past 128); those take the layouts,
// NEG_INF and cdiv from here.
//
// Layouts. q/o/do are [B, Sq, H, d] and k/v/dk/dv are [B, Sk, Hkv, d], all
// contiguous, so one sequence row of one head is d contiguous elements and
// consecutive rows are H*d (or Hkv*d) apart. lse and delta are [B, H, Sq]
// f32. Query head h reads kv head h / (H / Hkv): GQA costs no copy.
//
// Widths. A kernel is compiled for a tile width W (32, 64, 128 or 256) and
// takes the true head_dim d <= W at run time: columns d..W-1 of every tile
// are loaded as zeros, which add nothing to a product over the head dim and
// give zero columns in a product onto it, and are never stored.
//
// Every FMA kernel runs 128 threads (four warps) and keeps its tiles and its
// accumulators in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int NTHREADS = 128;

// Tile rows: 32, which keeps the f32 dk/dv kernel's shared memory at width
// 256 (213 KB) under the 227 KB a block has.
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int B = 32; };
template <> struct Tile<bf16> { static constexpr int B = 32; };

// Row stride of a [rows, W] tile of T in shared memory: 16 bytes of padding
// keeps 16-byte stores aligned.
template <typename T, int W> constexpr int ld() { return W + 16 / (int)sizeof(T); }
template <int W> constexpr int ldf() { return W + 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// Round to nearest even, as torch's and XLA's casts do.
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// The elements of one 32-bit word (one f32, two bf16) times `scale`,
// rounded back to T, in registers.
template <typename T> __device__ __forceinline__ uint32_t scale_word(uint32_t w, float scale);
template <> __device__ __forceinline__ uint32_t scale_word<float>(uint32_t w, float scale) {
  return __float_as_uint(__uint_as_float(w) * scale);
}
template <> __device__ __forceinline__ uint32_t scale_word<bf16>(uint32_t w, float scale) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo * scale, hi * scale);  // .x low, .y high
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `rows` rows of d elements (row stride `gstride` elements) into a
// shared tile of W columns with row stride `lds`. Rows at or past `nvalid`
// and columns at or past d are zero: a zero row or column is inert in every
// product below. With `scaled`, each element is multiplied by `scale` and
// rounded back to T, the reference's `x * scale` in the input dtype. Rows
// of a d that is a whole number of 16-byte vectors load by vector (every
// row then starts 16-byte aligned), others element by element.
template <typename T, int ROWS, int W>
__device__ __forceinline__ void load_rows(T* s, int lds, const T* g, long gstride, int nvalid,
                                          int d, bool scaled, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (d % VEC == 0) {
    constexpr int VPR = W / VEC;
    for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * VEC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < nvalid && c < d) val = *reinterpret_cast<const uint4*>(g + (long)r * gstride + c);
      if (scaled) {
        val.x = scale_word<T>(val.x, scale);
        val.y = scale_word<T>(val.y, scale);
        val.z = scale_word<T>(val.z, scale);
        val.w = scale_word<T>(val.w, scale);
      }
      *reinterpret_cast<uint4*>(s + r * lds + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += NTHREADS) {
      const int r = i / W, c = i % W;
      float x = 0.f;
      if (r < nvalid && c < d) x = to_f(g[(long)r * gstride + c]);
      s[r * lds + c] = scaled ? from_f<T>(x * scale) : from_f<T>(x);
    }
  }
}

// Per-row f32 statistic (lse, delta) of one q tile; zero past `nvalid`.
template <int ROWS>
__device__ __forceinline__ void load_stat(float* s, const float* g, int nvalid) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) s[r] = r < nvalid ? g[r] : 0.f;
}

template <int ROWS, int W>
__device__ __forceinline__ void zero_f(float* s, int lds) {
  for (int i = threadIdx.x; i < ROWS * W; i += NTHREADS) s[(i / W) * lds + i % W] = 0.f;
}

// Operand layouts of C = op(A) . op(B):
//   NT: A[M][K], B[N][K]  (C = A . B^T)
//   NN: A[M][K], B[K][N]  (C = A . B)
//   TN: A[K][M], B[K][N]  (C = A^T . B)
enum Lay { NT, NN, TN };

template <Lay L, typename T>
__device__ __forceinline__ float a_at(const T* A, int lda, int m, int k) {
  return to_f(L == TN ? A[k * lda + m] : A[m * lda + k]);
}
template <Lay L, typename T>
__device__ __forceinline__ float b_at(const T* B, int ldb, int k, int n) {
  return to_f(L == NT ? B[n * ldb + k] : B[k * ldb + n]);
}

// C[M][N] (f32, shared, row stride ldc) = (acc ? C * rowscale : 0) + op(A) . op(B),
// A and B f32 or bf16, every product and sum in f32.
// `rowscale` (may be null) multiplies row m of the old C: the online
// softmax's rescale of its accumulator rides the product. The caller
// synchronises the block before and after.
template <Lay L, int M, int N, int K, typename TA, typename TB>
__device__ __forceinline__ void mm(const TA* A, int lda, const TB* B, int ldb, float* C, int ldc,
                                   bool acc, const float* rowscale) {
  for (int i = threadIdx.x; i < M * N; i += NTHREADS) {
    const int m = i / N, n = i % N;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a_at<L>(A, lda, m, k), b_at<L>(B, ldb, k, n), s);
    float c0 = 0.f;
    if (acc) c0 = C[m * ldc + n] * (rowscale ? rowscale[m] : 1.f);
    C[m * ldc + n] = c0 + s;
  }
}

// Largest of `x` over the `TPR` consecutive lanes that share a row.
template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace tt
