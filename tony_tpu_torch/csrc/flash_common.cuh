// Shared pieces of the f32 flash-attention kernels (flash_fwd_kernel,
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel in flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu): tile sizes, tile loads from device
// memory into shared memory, and one block-level FMA matrix product on
// shared-memory tiles, so that a small f32 case can be held tightly against
// the plain version. The bf16 kernels run on hopper_common.cuh; they take
// the layouts, NEG_INF and cdiv from here.
//
// Layouts. q/o/do are [B, Sq, H, D] and k/v/dk/dv are [B, Sk, Hkv, D], all
// contiguous, so one sequence row of one head is D contiguous elements and
// consecutive rows are H*D (or Hkv*D) apart. lse and delta are [B, H, Sq]
// f32. Query head h reads kv head h / (H / Hkv): GQA costs no copy.
//
// Every f32 kernel runs 128 threads (four warps) and keeps its tiles and its
// accumulators in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int NTHREADS = 128;

// Tile rows: 32, which keeps the f32 dk/dv kernel's shared memory under the
// 227 KB a block has.
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int B = 32; };

// Row stride of a [rows, W] tile of T in shared memory: 16 bytes of padding
// keeps 16-byte stores aligned.
template <typename T, int W> constexpr int ld() { return W + 16 / (int)sizeof(T); }
template <int W> constexpr int ldf() { return W + 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Copy `rows` rows of D elements (row stride `gstride` elements) into a
// shared tile with row stride `lds`. Rows at or past `nvalid` are zero: a
// zero row is inert in every product below. With `scaled`, each element is
// multiplied by `scale` and rounded back to T, the reference's `x * scale`
// in the input dtype.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(T* s, int lds, const T* g, long gstride,
                                          int nvalid, bool scaled, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = *reinterpret_cast<const uint4*>(g + (long)r * gstride + c);
    if (scaled) {
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(to_f(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(s + r * lds + c) = val;
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

// C[M][N] (f32, shared, row stride ldc) = (acc ? C * rowscale : 0) + op(A) . op(B).
// `rowscale` (may be null) multiplies row m of the old C: the online
// softmax's rescale of its accumulator rides the product. The caller
// synchronises the block before and after.
template <Lay L, int M, int N, int K>
__device__ __forceinline__ void mm(const float* A, int lda, const float* B, int ldb, float* C,
                                   int ldc, bool acc, const float* rowscale) {
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
