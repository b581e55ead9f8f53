// Shared pieces of the FMA flash-attention kernels: f32 at every head_dim
// up to 256, bf16 at the head_dims the wgmma kernels of hopper_common.cuh
// do not take (not a multiple of 8), and both past 256 (the split kernels,
// below); the wgmma kernels take NEG_INF and cdiv from here.
//
// All three FMA kernels (flash_fwd_kernel, flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel in flash_fwd.cu, flash_bwd_dq.cu and
// flash_bwd_dkv.cu) are built from the same pieces. Their tiles are f32 in
// shared memory (bf16 widened on its way in) with row stride ldw<W>();
// copy_tile brings them in by cp.async (cp_commit, cp_wait_all),
// zero-filled past the sequence, scale_own scales in place what a thread
// copied, and zero_tail clears the columns past d once; dot_rows and
// acc_rows are the two products on register micro-tiles, over a thread
// layout from Cells.
//
// Layouts. q/o/do are [B, Sq, H, d] and k/v/dk/dv are [B, Sk, Hkv, d], all
// contiguous, so one sequence row of one head is d contiguous elements and
// consecutive rows are H*d (or Hkv*d) apart. lse and delta are [B, H, Sq]
// f32. Query head h reads kv head h / (H / Hkv): GQA costs no copy.
//
// Widths. A kernel is compiled for a tile width W (16, 32, 64, 128 or 256)
// and takes the true head_dim d <= W at run time: columns d..W-1 of every
// tile are zeros, which add nothing to a product over the head dim and
// give zero columns in a product onto it, and are never stored. Past 256
// the split kernels take the head dim in chunks of the 256-wide tiles
// (SPLIT, copy_chunk, scale_chunk).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tt {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// Round to nearest even, as torch's and XLA's casts do.
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// ------------------------------------------------ tiles and products
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

// ------------------------------------------------ head dims past 256
// The split kernels (flash_fwd_split_kernel, flash_bwd_dq_split_kernel and
// flash_bwd_dkv_split_kernel) take every head_dim d > SPLIT on the width-256
// tiles: the head dim is nc = ceil(d / SPLIT) column chunks, chunk x being
// columns [SPLIT x, SPLIT x + dx), dx = min(SPLIT, d - SPLIT x). Each block
// owns one output chunk (the grid is nc times the unsplit one); the products
// over the head dim (S, dP) sum over every chunk, streamed through the same
// shared tiles, and the products onto it touch the block's own chunk only.
constexpr int SPLIT = 256;

__host__ __device__ __forceinline__ int nchunks(int d) { return (d + SPLIT - 1) / SPLIT; }
__host__ __device__ __forceinline__ int chunk_cols(int d, int x) {
  return d - SPLIT * x < SPLIT ? d - SPLIT * x : SPLIT;
}

// Rows [0, ROWS) of one column chunk of a tile of T (row r at g + r * gstride,
// dx <= SPLIT elements) into f32 shared rows of stride ldw<SPLIT>(), NTH
// threads, every column written: rows at or past `nvalid` and columns
// dx..SPLIT-1 as zeros (a stage holds chunks of other widths in turn).
// `vec`: d is a whole number of 16-byte vectors (d % 4 == 0 in f32, d % 8
// == 0 in bf16), so every row and chunk starts 16-byte aligned. f32 goes by
// cp.async (16-byte copies with `vec`, else 4-byte), landing at cp_wait_all
// and leaving `scaled` to scale_chunk; bf16 is widened synchronously (16-byte
// loads of 8 elements with `vec`, else element by element; each round's
// loads issued before its stores) and with `scaled` multiplied by `scale`
// and rounded back to bf16 on the way: the reference's x * scale in x's
// dtype.
template <typename T, int ROWS, int NTH>
__device__ __forceinline__ void copy_chunk(float* s, const T* g, long gstride, int nvalid, int dx,
                                           bool vec, bool scaled, float scale) {
  constexpr int W = SPLIT, LD = ldw<W>();
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec) {
      constexpr int GPR = W / 8, N = ROWS * GPR / NTH, R = 4;
      static_assert(N % R == 0, "whole rounds of the block");
#pragma unroll 1
      for (int u0 = 0; u0 < N; u0 += R) {
        uint4 x[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int i = threadIdx.x + (u0 + u) * NTH, r = i / GPR, c = i % GPR * 8;
          x[u] = r < nvalid && c < dx ? *reinterpret_cast<const uint4*>(g + r * gstride + c)
                                      : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int i = threadIdx.x + (u0 + u) * NTH, r = i / GPR, c = i % GPR * 8;
          const uint32_t w[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
          float f[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // element 2e in the low half of word e
            f[2 * e] = __uint_as_float(w[e] << 16);
            f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
          }
          if (scaled) {
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = rounded<T>(f[e] * scale);
          }
          float4* dst = reinterpret_cast<float4*>(s + r * LD + c);
          dst[0] = make_float4(f[0], f[1], f[2], f[3]);
          dst[1] = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
      return;
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int CPR = W / 4;
      for (int i = threadIdx.x; i < ROWS * CPR; i += NTH) {
        const int r = i / CPR, c = i % CPR * 4;
        const bool ok = r < nvalid && c < dx;
        cp_async<16>(s + r * LD + c, ok ? g + r * gstride + c : g, ok);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * W; i += NTH) {
        const int r = i / W, c = i % W;
        const bool ok = r < nvalid && c < dx;
        cp_async<4>(s + r * LD + c, ok ? g + r * gstride + c : g, ok);
      }
    }
  } else {
    constexpr int N = ROWS * W / NTH, R = 16;
    static_assert(N % R == 0, "whole rounds of the block");
#pragma unroll 1
    for (int u0 = 0; u0 < N; u0 += R) {
      float x[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = threadIdx.x + (u0 + u) * NTH, r = i / W, c = i % W;
        x[u] = r < nvalid && c < dx ? to_f(g[r * gstride + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = threadIdx.x + (u0 + u) * NTH, r = i / W, c = i % W;
        s[r * LD + c] = scaled ? rounded<T>(x[u] * scale) : x[u];
      }
    }
  }
}

// f32 only: multiply by `scale` what this thread copied into a chunk with
// copy_chunk (the same loop; the zeros stay zeros), after cp_wait_all and
// before the barrier that shows the chunk to the block.
template <int ROWS, int NTH>
__device__ __forceinline__ void scale_chunk(float* s, bool vec, float scale) {
  constexpr int W = SPLIT, LD = ldw<W>();
  if (vec) {
    constexpr int CPR = W / 4;
    for (int i = threadIdx.x; i < ROWS * CPR; i += NTH) {
      float4* p = reinterpret_cast<float4*>(s + i / CPR * LD + i % CPR * 4);
      float4 x = *p;
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
      *p = x;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += NTH) s[i / W * LD + i % W] *= scale;
  }
}

}  // namespace tt
