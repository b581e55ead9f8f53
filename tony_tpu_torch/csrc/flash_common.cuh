// Shared pieces of the FMA flash-attention kernels: f32 at every head_dim
// up to 256, and bf16 at the head_dims the wgmma kernels of hopper_common.cuh
// do not take (not a multiple of 8); those take the layouts, NEG_INF and
// cdiv from here.
//
// Which kernel uses which:
//   - flash_fwd_kernel (flash_fwd.cu): Tile, ld / ldf, load_rows, zero_f,
//     mm, row_max and row_sum: one element of a product a thread, operands
//     and accumulators in shared memory, synchronous loads, 128 threads.
//   - flash_bwd_dq_kernel and flash_bwd_dkv_kernel (flash_bwd_dq.cu,
//     flash_bwd_dkv.cu): the second half of this file. Their tiles are f32
//     in shared memory (bf16 widened on its way in) with row stride
//     ldw<W>(); copy_tile brings them in by cp.async (cp_commit,
//     cp_wait_all), zero-filled past the sequence, and zero_tail clears the
//     columns past d once; dot_rows and acc_rows are the two products on
//     register micro-tiles, over a thread layout from Cells.
//
// Layouts. q/o/do are [B, Sq, H, d] and k/v/dk/dv are [B, Sk, Hkv, d], all
// contiguous, so one sequence row of one head is d contiguous elements and
// consecutive rows are H*d (or Hkv*d) apart. lse and delta are [B, H, Sq]
// f32. Query head h reads kv head h / (H / Hkv): GQA costs no copy.
//
// Widths. A kernel is compiled for a tile width W (16, 32, 64, 128 or 256;
// the forward from 32) and takes the true head_dim d <= W at run time:
// columns d..W-1 of every tile are zeros, which add nothing to a product
// over the head dim and give zero columns in a product onto it, and are
// never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tt {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int NTHREADS = 128;  // the forward's threads

// The forward's tile rows.
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

template <int ROWS, int W>
__device__ __forceinline__ void zero_f(float* s, int lds) {
  for (int i = threadIdx.x; i < ROWS * W; i += NTHREADS) s[(i / W) * lds + i % W] = 0.f;
}

// Operand layouts of C = op(A) . op(B):
//   NT: A[M][K], B[N][K]  (C = A . B^T)
//   NN: A[M][K], B[K][N]  (C = A . B)
enum Lay { NT, NN };

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
    for (int k = 0; k < K; ++k) s = fmaf(to_f(A[m * lda + k]), b_at<L>(B, ldb, k, n), s);
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

// ------------------------------------------------ the FMA backward pair
// Row stride (floats) of an f32 tile of width W in shared memory. W + 4
// keeps every row 16-byte aligned, and with W a multiple of 8 eight
// consecutive rows start in eight different 16-byte bank groups, so eight
// lanes reading a float4 each from eight rows meet no bank conflict.
template <int W> __host__ __device__ constexpr int ldw() { return W + 4; }

// x rounded to T and back: what a product over T operands reads.
template <typename T> __device__ __forceinline__ float rounded(float x) { return to_f(from_f<T>(x)); }

// One asynchronous copy of BYTES (4 or 16) from global to shared memory;
// with `valid` false nothing is read and the BYTES are zeros (the copy's
// source size 0). `g` must be a valid address either way.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* s, const void* g, bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(g), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(g), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// This thread's copies have landed (and are visible to it; to the block
// after a barrier).
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Rows [0, ROWS) of a tile of T (row r at g + r * gstride, d elements) into
// f32 shared rows of stride ldw<W>(), NTH threads: rows at or past `nvalid`
// as zeros, columns d..W-1 untouched (zero_tail clears them once). f32 rows
// of whole 16-byte vectors (d % 4 == 0: every row then starts 16-byte
// aligned) go by 16-byte cp.async, other f32 rows by 4-byte cp.async;
// both land at cp_wait_all, and `scaled` is left to scale_own. bf16 is
// widened synchronously, and with `scaled` multiplied by `scale` and
// rounded back to bf16 on the way: the reference's k * scale in k's dtype.
template <typename T, int ROWS, int W, int NTH>
__device__ __forceinline__ void copy_tile(float* s, const T* g, long gstride, int nvalid, int d,
                                          bool scaled, float scale) {
  constexpr int LD = ldw<W>();
  if constexpr (std::is_same<T, float>::value) {
    if (d % 4 == 0) {
      constexpr int CPR = W / 4;
      for (int i = threadIdx.x; i < ROWS * CPR; i += NTH) {
        const int r = i / CPR, c = i % CPR * 4;
        const bool ok = r < nvalid;
        if (c < d) cp_async<16>(s + r * LD + c, ok ? g + r * gstride + c : g, ok);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * W; i += NTH) {
        const int r = i / W, c = i % W;
        const bool ok = r < nvalid;
        if (c < d) cp_async<4>(s + r * LD + c, ok ? g + r * gstride + c : g, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += NTH) {
      const int r = i / W, c = i % W;
      if (c >= d) continue;
      const float x = r < nvalid ? to_f(g[r * gstride + c]) : 0.f;
      s[r * LD + c] = scaled ? rounded<T>(x * scale) : x;
    }
  }
}

// f32 only: multiply by `scale` the elements of a tile that this thread
// copied with copy_tile (the same loop), after cp_wait_all and before the
// barrier that shows the tile to the block: the in-place scaling costs no
// barrier of its own. bf16 tiles were scaled by copy_tile.
template <typename T, int ROWS, int W, int NTH>
__device__ __forceinline__ void scale_own(float* s, int d, float scale) {
  constexpr int LD = ldw<W>();
  if constexpr (std::is_same<T, float>::value) {
    if (d % 4 == 0) {
      constexpr int CPR = W / 4;
      for (int i = threadIdx.x; i < ROWS * CPR; i += NTH) {
        const int r = i / CPR, c = i % CPR * 4;
        if (c < d) {
          float4* p = reinterpret_cast<float4*>(s + r * LD + c);
          float4 x = *p;
          x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
          *p = x;
        }
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * W; i += NTH) {
        const int r = i / W, c = i % W;
        if (c < d) s[r * LD + c] *= scale;
      }
    }
  }
}

// ROWS f32 statistics (lse or delta of a q tile) by 4-byte cp.async, zeros
// at or past `nvalid`.
template <int ROWS, int NTH>
__device__ __forceinline__ void copy_stat(float* s, const float* g, int nvalid) {
  for (int r = threadIdx.x; r < ROWS; r += NTH) cp_async<4>(s + r, r < nvalid ? g + r : g, r < nvalid);
}

// Zero columns d..W-1 of `rows` consecutive rows of stride ldw<W>(): once
// per block, for every tile buffer, since copy_tile never writes them.
template <int W, int NTH>
__device__ __forceinline__ void zero_tail(float* s, int rows, int d) {
  const int n = W - d;
  if (n == 0) return;
  for (int i = threadIdx.x; i < rows * n; i += NTH) s[i / n * ldw<W>() + d + i % n] = 0.f;
}

// NTH threads over a GX x GY grid of micro-tiles ("cells"), a warp on LX x
// LY of them (LX = 8 where it can): the warp's float4 reads then touch at
// most eight rows of each operand, which one shared-memory wavefront
// serves (see ldw), and the rows it shares are broadcast.
template <int GX, int GY>
struct Cells {
  static constexpr int LX = GX < 8 ? GX : 8, LY = 32 / LX, WX = GX / LX;
  static_assert(GX % LX == 0 && GY % LY == 0, "a warp must cover whole cells");
  __device__ static int x(int t) { return (t >> 5) % WX * LX + (t & 31) % LX; }
  __device__ static int y(int t) { return (t >> 5) / WX * LY + (t & 31) / LX; }
};

// acc[i][j] += A[i * SA] . B[j * SB] over K columns: A and B point at this
// thread's first rows (f32, shared, row stride LD), its rows SA (SB) rows
// apart. Each step of 4 columns reads TM + TN float4 for 4 * TM * TN FMAs;
// U steps are unrolled (all K / 4 unless a register budget says less).
template <int TM, int TN, int K, int LD, int SA, int SB, int U>
__device__ __forceinline__ void dot_rows(float (&acc)[TM][TN], const float* A, const float* B) {
  static_assert(K % (4 * U) == 0, "whole groups of U steps");
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 4 * U)
#pragma unroll
  for (int k = k0; k < k0 + 4 * U; k += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(A + i * SA * LD + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(B + j * SB * LD + k);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][4c + e] += sum over k < K of A[i * SA][k] . B[k][c * SC + e]:
// A points at this thread's first row and first k (row stride LDA, rows SA
// apart), B at row k = 0 and this thread's first column (row stride LDB,
// its TC float4 columns SC floats apart). Each step of 4 k reads TM + 4 TC
// float4 for 16 * TM * TC FMAs; U steps are unrolled.
template <int TM, int TC, int K, int LDA, int LDB, int SA, int SC, int U>
__device__ __forceinline__ void acc_rows(float (&acc)[TM][4 * TC], const float* A, const float* B) {
  static_assert(K % (4 * U) == 0, "whole groups of U steps");
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 4 * U)
#pragma unroll
  for (int k = k0; k < k0 + 4 * U; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(A + i * SA * LDA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + c * SC);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = lane4(a[i], kk);
          acc[i][4 * c + 0] = fmaf(x, b.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(x, b.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(x, b.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(x, b.w, acc[i][4 * c + 3]);
        }
      }
  }
}

// A thread's [TM][4 TC] accumulator cells (rows SA apart, float4 columns SC
// floats apart) into a [rows][W] f32 array (no padding) at its first cell.
template <int TM, int TC, int W, int SA, int SC>
__device__ __forceinline__ void put_cells(float* dst, const float (&acc)[TM][4 * TC]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c)
      *reinterpret_cast<float4*>(dst + i * SA * W + c * SC) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace tt
