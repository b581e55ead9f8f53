// Fused GroupNorm apply: y = max(x . a + b, 0) (or without the max), over the
// flattened [B, R = H.W, C] view of a contiguous NHWC activation, with the
// per-(batch, channel) folded affine a, b [B, C] in f32. The product and the
// sum are f32; y comes out in x's dtype (bf16 or f32).
//
// Replaces: tony_tpu/ops/convfuse.py:90, _apply_kernel (Pallas), called by
// _apply_pallas at :106.
//
// Bound on the H100: HBM bytes. It reads x once and writes y once,
// 2 . B . R . C . itemsize bytes over 3.35 TB/s (a and b are B . C floats,
// L2-resident); it does 2-3 flops per element, far below the card's
// operations-per-byte line.
//
// Design. The grid is (tiles of (row, channel-chunk) pairs, B). A chunk is
// 16 bytes of one row: 8 bf16 or 4 f32 channels. Each of the block's 256
// threads takes ITEMS chunks, strided by the block size so that neighbouring
// threads touch neighbouring 16-byte words; it issues all its 16-byte loads
// (uint4) before it computes, to keep ITEMS . 16 bytes in flight. Chunks
// past the batch's last row are masked, so any R works (R = 49 at 7x7).
// a and b are read through the read-only cache as float4s: they are the same
// for every row of a batch. When C is a multiple of the chunk width, a
// chunk's flat offset is its index times the width and every load is a
// 16-byte vector; otherwise each thread walks its chunk's channels as
// scalars (the min(norm_groups, C) edge and the tiny test configs).
// x . a and + b are rounded separately (__fmul_rn, __fadd_rn) so that nvcc
// does not contract them into one FMA: the result is the plain PyTorch
// version's, x.float() * a + b, bit for bit.
//
// Left on the table by this simple design: the stats pass (group_stats)
// reads x once more before this kernel; fusing the stats into the producing
// convolution's epilogue, or the apply into the consuming convolution's
// prologue, would save one of the three passes. No streaming cache hints
// (ld.global.cs / st.global.cs) and no persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt_cf {

constexpr int NTHREADS = 256;
constexpr int ITEMS = 4;  // 16-byte chunks per thread

using bf16 = __nv_bfloat16;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Pack<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  __device__ static float to_f(bf16 v) { return __bfloat162float(v); }
  __device__ static bf16 from_f(float v) { return __float2bfloat16_rn(v); }
};

template <bool RELU>
__device__ __forceinline__ float apply1(float x, float a, float b) {
  const float y = __fadd_rn(__fmul_rn(x, a), b);
  // y < 0 is false for NaN, so a NaN passes through as torch.relu passes it.
  return (RELU && y < 0.f) ? 0.f : y;
}

template <typename T, bool RELU, bool VECTOR>
__global__ void __launch_bounds__(NTHREADS)
    convfuse_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ b, T* __restrict__ y, int R, int C) {
  constexpr int V = Pack<T>::N;
  const int chunks = (C + V - 1) / V;
  const int n = R * chunks;  // (row, chunk) pairs of this batch; the wrapper keeps R . C < 2^31
  const long base = (long)blockIdx.y * R * C;
  const float* ab = a + (long)blockIdx.y * C;
  const float* bb = b + (long)blockIdx.y * C;
  const int first = blockIdx.x * NTHREADS * ITEMS + threadIdx.x;

  if constexpr (VECTOR) {
    // C % V == 0: chunk p of the batch starts at element p . V, 16-byte aligned.
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    uint4* yv = reinterpret_cast<uint4*>(y + base);
    uint4 in[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = first + i * NTHREADS;
      if (p < n) in[i] = xv[p];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = first + i * NTHREADS;
      if (p >= n) continue;
      const int c0 = (p % chunks) * V;
      float f[V];
      Pack<T>::unpack(in[i], f);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 av = __ldg(reinterpret_cast<const float4*>(ab + c0 + j));
        const float4 bv = __ldg(reinterpret_cast<const float4*>(bb + c0 + j));
        f[j] = apply1<RELU>(f[j], av.x, bv.x);
        f[j + 1] = apply1<RELU>(f[j + 1], av.y, bv.y);
        f[j + 2] = apply1<RELU>(f[j + 2], av.z, bv.z);
        f[j + 3] = apply1<RELU>(f[j + 3], av.w, bv.w);
      }
      yv[p] = Pack<T>::pack(f);
    }
  } else {
    // C % V != 0: the same (row, chunk) walk with scalar loads and stores.
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = first + i * NTHREADS;
      if (p >= n) continue;
      const int row = p / chunks, c0 = (p % chunks) * V;
      const int nc = min(V, C - c0);
      const long off = base + (long)row * C + c0;
      for (int j = 0; j < nc; ++j) {
        const float v = Pack<T>::to_f(x[off + j]);
        y[off + j] = Pack<T>::from_f(apply1<RELU>(v, __ldg(ab + c0 + j), __ldg(bb + c0 + j)));
      }
    }
  }
}

template <typename T, bool RELU>
cudaError_t launch(const void* x, const void* a, const void* b, void* y, int B, int R, int C,
                   cudaStream_t st) {
  constexpr int V = Pack<T>::N;
  const int chunks = (C + V - 1) / V;
  const int per_block = NTHREADS * ITEMS;
  dim3 grid((unsigned)((R * chunks + per_block - 1) / per_block), (unsigned)B);
  const T* xp = static_cast<const T*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  T* yp = static_cast<T*>(y);
  if (C % V == 0)
    convfuse_apply_kernel<T, RELU, true><<<grid, NTHREADS, 0, st>>>(xp, ap, bp, yp, R, C);
  else
    convfuse_apply_kernel<T, RELU, false><<<grid, NTHREADS, 0, st>>>(xp, ap, bp, yp, R, C);
  return cudaGetLastError();
}

}  // namespace tt_cf

// x, y: [B, R, C] contiguous, dtype 0 = bf16, 1 = f32; a, b: [B, C] f32, all
// 16-byte aligned; B <= 65535, R . C < 2^31, every count > 0 (the wrapper
// checks). relu: 1 for max(., 0). Returns a cudaError_t;
// cudaErrorInvalidValue for a dtype not built.
extern "C" int tt_convfuse_apply(const void* x, const void* a, const void* b, void* y, int B, int R,
                                 int C, int dtype, int relu, void* stream) {
  using namespace tt_cf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && relu) return (int)launch<bf16, true>(x, a, b, y, B, R, C, st);
  if (dtype == 0 && !relu) return (int)launch<bf16, false>(x, a, b, y, B, R, C, st);
  if (dtype == 1 && relu) return (int)launch<float, true>(x, a, b, y, B, R, C, st);
  if (dtype == 1 && !relu) return (int)launch<float, false>(x, a, b, y, B, R, C, st);
  return (int)cudaErrorInvalidValue;
}
