// Flash-attention backward, dk and dv: dv = sum p^T . do and
// dk = sum ds^T . (q * scale), over the g query heads of a kv head's group
// and over all q tiles.
//
// Replaces: tony_tpu/ops/attention.py, _bwd_impl -> _bwd_dkv_kernel (Pallas).
//
// Design. One block of 128 threads per (k tile of 64 keys, kv head, batch).
// The block keeps its K and V tiles and its dk/dv f32 accumulators in shared
// memory and loops over the group's query heads and, for each, over the q
// tiles from the first one the causal mask lets see this k tile (the
// reference's _first_valid_qi). Each block owns its dk/dv rows outright, so
// there are no atomics and the result is deterministic, as in the
// reference. q is scaled in the input dtype as it is loaded; p is rounded
// to do's dtype for dv and ds to q's dtype for dk.
//
// Bound on the H100: at S = 2048, D = 128 the work is matmul FLOPs
// (8 . B . H . D per unmasked score: s, dp, dv and dk) on the tensor cores.
//
// Left on the table: the same as flash_fwd.cu (mma.sync instead of wgmma,
// shared-memory accumulators, no load pipeline, transposed operands gathered
// element by element instead of with ldmatrix.trans); with 64-key tiles at
// S = 2048 the grid is B . Hkv . 32 blocks, about four waves over 132 SMs,
// and causal tiles near the end of the sequence do less work than those at
// its start.
#include "flash_common.cuh"

namespace tt {

template <typename T, int D>
struct DkvSmem {
  static constexpr int BM = Tile<T>::B, BN = BM;
  static constexpr int LDT = ld<T, D>(), LDP = ld<T, BN>(), LDS = ldf<BN>(), LDO = ldf<D>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(2 * BN * LDT + 2 * BM * LDT + 2 * BM * LDP) +
      sizeof(float) * (size_t)(2 * BM * LDS + 2 * BN * LDO + 2 * BM);
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int H, int Hkv, int Sq, int Sk, float scale, int causal) {
  using L = DkvSmem<T, D>;
  constexpr int BM = L::BM, BN = L::BN, LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDO = L::LDO;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BN * LDT;
  T* sQ = sV + BN * LDT;
  T* sDO = sQ + BM * LDT;
  T* sP = sDO + BM * LDT;
  T* sDS = sP + BM * LDP;
  float* sS = reinterpret_cast<float*>(sDS + BM * LDP);
  float* sDP = sS + BM * LDS;
  float* sDK = sDP + BM * LDS;
  float* sDV = sDK + BN * LDO;
  float* sLse = sDV + BN * LDO;
  float* sDelta = sLse + BM;

  const int kj = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int k0 = kj * BN;
  const int nk_valid = min(BN, Sk - k0);
  const long qstride = (long)H * D, kstride = (long)Hkv * D;
  const long koff = ((long)b * Sk + k0) * kstride + (long)hk * D;

  const float scale_t = to_f(from_f<T>(scale));
  load_rows<T, BN, D>(sK, LDT, k + koff, kstride, nk_valid, false, 1.f);
  load_rows<T, BN, D>(sV, LDT, v + koff, kstride, nk_valid, false, 1.f);
  zero_f<BN, D>(sDK, LDO);
  zero_f<BN, D>(sDV, LDO);
  const int nq = (Sq + BM - 1) / BM;
  const int i0 = causal ? k0 / BM : 0;

  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BM;
      const int nq_valid = min(BM, Sq - q0);
      const long qoff = ((long)b * Sq + q0) * qstride + (long)h * D;
      const long soff = ((long)b * H + h) * Sq + q0;
      __syncthreads();  // the previous tile's products are done with sQ/sDO/sP/sDS
      load_rows<T, BM, D>(sQ, LDT, q + qoff, qstride, nq_valid, true, scale_t);
      load_rows<T, BM, D>(sDO, LDT, dout + qoff, qstride, nq_valid, false, 1.f);
      load_stat<BM>(sLse, lse + soff, nq_valid);
      load_stat<BM>(sDelta, delta + soff, nq_valid);
      __syncthreads();
      mm<NT, BM, BN, D>(sQ, LDT, sK, LDT, sS, LDS, false, nullptr);
      mm<NT, BM, BN, D>(sDO, LDT, sV, LDT, sDP, LDS, false, nullptr);
      __syncthreads();
      for (int e = threadIdx.x; e < BM * BN; e += NTHREADS) {
        const int r = e / BN, c = e % BN;
        const int row = q0 + r, col = k0 + c;
        const bool valid = row < Sq && col < Sk && !(causal && col > row);
        const float p = valid ? expf(sS[r * LDS + c] - sLse[r]) : 0.f;
        sP[r * LDP + c] = from_f<T>(p);
        sDS[r * LDP + c] = from_f<T>(p * (sDP[r * LDS + c] - sDelta[r]));
      }
      __syncthreads();
      mm<TN, BN, D, BM>(sP, LDP, sDO, LDT, sDV, LDO, true, nullptr);
      mm<TN, BN, D, BM>(sDS, LDP, sQ, LDT, sDK, LDO, true, nullptr);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < BN * D; e += NTHREADS) {
    const int r = e / D, c = e % D;
    if (r < nk_valid) {
      dk[koff + (long)r * kstride + c] = from_f<T>(sDK[r * LDO + c]);
      dv[koff + (long)r * kstride + c] = from_f<T>(sDV[r * LDO + c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t st) {
  using L = DkvSmem<T, D>;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(Sk, L::BN), Hkv, B);
  kern<<<grid, NTHREADS, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace tt

// dtype: 0 = bf16, 1 = f32 (q, k, v, do, dk, dv). Returns a cudaError_t.
extern "C" int tt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int H, int Hkv, int Sq, int Sk, int D, int dtype, float scale,
                                int causal, void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_DKV(T, DD) return (int)launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, st)
  if (dtype == 0 && D == 64) TT_DKV(bf16, 64);
  if (dtype == 0 && D == 128) TT_DKV(bf16, 128);
  if (dtype == 1 && D == 64) TT_DKV(float, 64);
  if (dtype == 1 && D == 128) TT_DKV(float, 128);
#undef TT_DKV
  return (int)cudaErrorInvalidValue;
}
