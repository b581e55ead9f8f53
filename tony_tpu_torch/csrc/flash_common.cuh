// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): element types and tile sizes, tile
// loads from device memory into shared memory, and one block-level matrix
// product on shared-memory tiles.
//
// Layouts. q/o/do are [B, Sq, H, D] and k/v/dk/dv are [B, Sk, Hkv, D], all
// contiguous, so one sequence row of one head is D contiguous elements and
// consecutive rows are H*D (or Hkv*D) apart. lse and delta are [B, H, Sq]
// f32. Query head h reads kv head h / (H / Hkv): GQA costs no copy.
//
// Every kernel runs 128 threads (four warps) and keeps its tiles and its f32
// accumulators in shared memory. For bf16 a product goes through the tensor
// cores with mma.sync.m16n8k16 (f32 accumulation); for f32 it is a plain FMA
// loop, so a small f32 case can be held tightly against the plain version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int NTHREADS = 128;

// Tile rows: 64 for bf16 (one 16-row mma strip per warp); 32 for f32, which
// keeps the f32 dk/dv kernel's shared memory under the 227 KB a block has.
template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int B = 64; };
template <> struct Tile<float> { static constexpr int B = 32; };

// Row stride of a [rows, W] tile of T in shared memory: 16 bytes of padding
// keeps 16-byte stores aligned and spreads the mma fragment loads over all
// 32 banks.
template <typename T, int W> constexpr int ld() { return W + 16 / (int)sizeof(T); }
template <int W> constexpr int ldf() { return W + 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA round
}

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

__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) | ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// Two bf16 of A at (m, k) and (m, k + 1), as one mma operand register.
template <Lay L>
__device__ __forceinline__ uint32_t a_reg(const bf16* A, int lda, int m, int k) {
  if (L == TN) return pack2(A + k * lda + m, A + (k + 1) * lda + m);
  return *reinterpret_cast<const uint32_t*>(A + m * lda + k);
}
// Two bf16 of B at (k, n) and (k + 1, n).
template <Lay L>
__device__ __forceinline__ uint32_t b_reg(const bf16* B, int ldb, int k, int n) {
  if (L == NT) return *reinterpret_cast<const uint32_t*>(B + n * ldb + k);
  return pack2(B + k * ldb + n, B + (k + 1) * ldb + n);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// The bf16 product on the tensor cores. Warp w owns rows [16w, 16w + 16) of
// C and keeps their N/8 accumulator fragments in registers across K.
// Fragment layout of m16n8k16 (PTX ISA): with g = lane / 4, t = lane % 4,
// A registers hold (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
// B registers hold k = 2t..2t+1 and 2t+8..2t+9 of column g; C holds
// (g, 2t..2t+1) and (g+8, 2t..2t+1).
template <Lay L, int M, int N, int K>
__device__ __forceinline__ void mm(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                                   int ldc, bool acc, const float* rowscale) {
  static_assert(M == 16 * (NTHREADS / 32), "one 16-row strip per warp");
  static_assert(N % 8 == 0 && K % 16 == 0, "mma tile multiples");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g, r1 = r0 + 8;
  float c[N / 8][4];
  const float s0 = acc ? (rowscale ? rowscale[r0] : 1.f) : 0.f;
  const float s1 = acc ? (rowscale ? rowscale[r1] : 1.f) : 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + 2 * t;
    c[j][0] = acc ? C[r0 * ldc + col] * s0 : 0.f;
    c[j][1] = acc ? C[r0 * ldc + col + 1] * s0 : 0.f;
    c[j][2] = acc ? C[r1 * ldc + col] * s1 : 0.f;
    c[j][3] = acc ? C[r1 * ldc + col + 1] * s1 : 0.f;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = a_reg<L>(A, lda, r0, k0 + 2 * t);
    const uint32_t a1 = a_reg<L>(A, lda, r1, k0 + 2 * t);
    const uint32_t a2 = a_reg<L>(A, lda, r0, k0 + 2 * t + 8);
    const uint32_t a3 = a_reg<L>(A, lda, r1, k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint32_t b0 = b_reg<L>(B, ldb, k0 + 2 * t, j * 8 + g);
      const uint32_t b1 = b_reg<L>(B, ldb, k0 + 2 * t + 8, j * 8 + g);
      mma_bf16(c[j], a0, a1, a2, a3, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + 2 * t;
    C[r0 * ldc + col] = c[j][0];
    C[r0 * ldc + col + 1] = c[j][1];
    C[r1 * ldc + col] = c[j][2];
    C[r1 * ldc + col + 1] = c[j][3];
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
