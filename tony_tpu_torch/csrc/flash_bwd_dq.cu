// Flash-attention backward, dq: dq = sum over k tiles of ds . (k * scale),
// with p = exp(s - lse), dp = do . v^T and ds = p * (dp - delta).
//
// Replaces: tony_tpu/ops/attention.py, _bwd_impl -> _bwd_dq_kernel (Pallas).
//
// Design. One block of 128 threads per (q tile of 64 rows, head, batch),
// looping over the k tiles up to the causal diagonal. k is scaled in the
// input dtype as it is loaded, so one scaled tile serves both s = q . ks^T
// and dq += ds . ks, as in the reference. delta = rowsum(o * do) - dlse is
// computed by the caller in plain torch, as the reference computes it in XLA
// outside its kernels. ds is rounded to k's dtype before the product; dq
// accumulates in f32 in shared memory and is written once, in q's dtype.
// Rows past Sq and keys past Sk contribute nothing (p = 0 there).
//
// Bound on the H100: at S = 2048, D = 128 the work is matmul FLOPs
// (6 . B . H . D per unmasked score: s, dp and dq) on the tensor cores.
//
// Left on the table: the same as flash_fwd.cu (mma.sync instead of wgmma,
// shared-memory accumulators, no load pipeline), and s is recomputed here
// and again in the dk/dv kernel, where a fused backward with atomic dq would
// compute it once but give up determinism.
#include "flash_common.cuh"

namespace tt {

template <typename T, int D>
struct DqSmem {
  static constexpr int BM = Tile<T>::B, BN = BM;
  static constexpr int LDT = ld<T, D>(), LDP = ld<T, BN>(), LDS = ldf<BN>(), LDO = ldf<D>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(2 * BM * LDT + 2 * BN * LDT + BM * LDP) +
      sizeof(float) * (size_t)(2 * BM * LDS + BM * LDO + 2 * BM);
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv, int Sq,
                        int Sk, float scale, int causal) {
  using L = DqSmem<T, D>;
  constexpr int BM = L::BM, BN = L::BN, LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDO = L::LDO;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + BM * LDT;
  T* sK = sDO + BM * LDT;
  T* sV = sK + BN * LDT;
  T* sDS = sV + BN * LDT;
  float* sS = reinterpret_cast<float*>(sDS + BM * LDP);
  float* sDP = sS + BM * LDS;
  float* sDQ = sDP + BM * LDS;
  float* sLse = sDQ + BM * LDO;
  float* sDelta = sLse + BM;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qi * BM;
  const int nq_valid = min(BM, Sq - q0);
  const long qstride = (long)H * D, kstride = (long)Hkv * D;
  const long qoff = ((long)b * Sq + q0) * qstride + (long)h * D;
  const T* kb = k + (long)b * Sk * kstride + (long)hk * D;
  const T* vb = v + (long)b * Sk * kstride + (long)hk * D;
  const long soff = ((long)b * H + h) * Sq + q0;

  const float scale_t = to_f(from_f<T>(scale));
  load_rows<T, BM, D>(sQ, LDT, q + qoff, qstride, nq_valid, false, 1.f);
  load_rows<T, BM, D>(sDO, LDT, dout + qoff, qstride, nq_valid, false, 1.f);
  load_stat<BM>(sLse, lse + soff, nq_valid);
  load_stat<BM>(sDelta, delta + soff, nq_valid);
  zero_f<BM, D>(sDQ, LDO);
  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BN;
    const int nk_valid = min(BN, Sk - k0);
    __syncthreads();
    load_rows<T, BN, D>(sK, LDT, kb + (long)k0 * kstride, kstride, nk_valid, true, scale_t);
    load_rows<T, BN, D>(sV, LDT, vb + (long)k0 * kstride, kstride, nk_valid, false, 1.f);
    __syncthreads();
    mm<NT, BM, BN, D>(sQ, LDT, sK, LDT, sS, LDS, false, nullptr);
    mm<NT, BM, BN, D>(sDO, LDT, sV, LDT, sDP, LDS, false, nullptr);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int row = q0 + r, col = k0 + c;
      const bool valid = row < Sq && col < Sk && !(causal && col > row);
      const float p = valid ? expf(sS[r * LDS + c] - sLse[r]) : 0.f;
      sDS[r * LDP + c] = from_f<T>(p * (sDP[r * LDS + c] - sDelta[r]));
    }
    __syncthreads();
    mm<NN, BM, D, BN>(sDS, LDP, sK, LDT, sDQ, LDO, true, nullptr);
  }
  __syncthreads();

  T* db = dq + qoff;
  for (int i = threadIdx.x; i < BM * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (r < nq_valid) db[(long)r * qstride + c] = from_f<T>(sDQ[r * LDO + c]);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int Hkv, int Sq,
                      int Sk, float scale, int causal, cudaStream_t st) {
  using L = DqSmem<T, D>;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(Sq, L::BM), H, B);
  kern<<<grid, NTHREADS, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace tt

// dtype: 0 = bf16, 1 = f32 (q, k, v, do, dq). Returns a cudaError_t.
extern "C" int tt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                               int Sq, int Sk, int D, int dtype, float scale, int causal,
                               void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_DQ(T, DD) return (int)launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, scale, causal, st)
  if (dtype == 0 && D == 64) TT_DQ(bf16, 64);
  if (dtype == 0 && D == 128) TT_DQ(bf16, 128);
  if (dtype == 1 && D == 64) TT_DQ(float, 64);
  if (dtype == 1 && D == 128) TT_DQ(float, 128);
#undef TT_DQ
  return (int)cudaErrorInvalidValue;
}
