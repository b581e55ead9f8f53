// Flash-attention forward: o = softmax(q . k^T * scale) . v and the row
// logsumexp lse = m + log(l), causal or full, GQA by index.
//
// Replaces: tony_tpu/ops/attention.py, _fwd_impl -> _fwd_kernel (Pallas).
//
// Design. One block of 128 threads per (q tile of 64 rows, head, batch); the
// block walks the k tiles up to the last one the causal mask touches (the
// reference's _last_valid_kj) and keeps the online-softmax state (row max m,
// row sum l, f32 accumulator) in shared memory. q is scaled in the input
// dtype as it is loaded. P is rounded to the input dtype before P . V, and
// l sums the unrounded f32 P, as the reference does. Rows past Sq are never
// written; keys past Sk are masked to NEG_INF and their K/V rows are zero.
//
// Bound on the H100: at S = 2048, D = 128 the work is matmul FLOPs
// (4 . B . H . D per unmasked score) on the tensor cores.
//
// Left on the table by this simple design: mma.sync reaches about half of
// Hopper's dense rate, which wgmma with TMA loads and warp specialisation
// would reach; the accumulators round-trip through shared memory on every
// k tile instead of living in registers; K/V loads are not overlapped with
// compute (no cp.async pipeline); V's fragments are gathered element by
// element instead of with ldmatrix.trans.
#include "flash_common.cuh"

namespace tt {

template <typename T, typename OT, int D>
struct FwdSmem {
  static constexpr int BM = Tile<T>::B, BN = BM;
  static constexpr int LDT = ld<T, D>(), LDP = ld<T, BN>(), LDS = ldf<BN>(), LDO = ldf<D>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(3 * BM * LDT + BM * LDP) + sizeof(float) * (size_t)(BM * LDS + BM * LDO + 3 * BM);
};

template <typename T, typename OT, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     OT* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal) {
  using L = FwdSmem<T, OT, D>;
  constexpr int BM = L::BM, BN = L::BN, LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDO = L::LDO;
  constexpr int TPR = NTHREADS / BM, CPT = BN / TPR;  // threads per row, columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * LDT;
  T* sV = sK + BN * LDT;
  T* sP = sV + BN * LDT;
  float* sS = reinterpret_cast<float*>(sP + BM * LDP);
  float* sO = sS + BM * LDS;
  float* sM = sO + BM * LDO;
  float* sL = sM + BM;
  float* sA = sL + BM;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qi * BM;
  const int nq_valid = min(BM, Sq - q0);
  const long qstride = (long)H * D, kstride = (long)Hkv * D;
  const T* qb = q + ((long)b * Sq + q0) * qstride + (long)h * D;
  const T* kb = k + (long)b * Sk * kstride + (long)hk * D;
  const T* vb = v + (long)b * Sk * kstride + (long)hk * D;

  const float scale_t = to_f(from_f<T>(scale));  // the scale in the input dtype
  load_rows<T, BM, D>(sQ, LDT, qb, qstride, nq_valid, true, scale_t);
  zero_f<BM, D>(sO, LDO);
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + BM - 1) / BN + 1);

  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int row = q0 + r;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BN;
    const int nk_valid = min(BN, Sk - k0);
    __syncthreads();  // the previous tile's products are done with sK/sV/sP
    load_rows<T, BN, D>(sK, LDT, kb + (long)k0 * kstride, kstride, nk_valid, false, 1.f);
    load_rows<T, BN, D>(sV, LDT, vb + (long)k0 * kstride, kstride, nk_valid, false, 1.f);
    __syncthreads();
    mm<NT, BM, BN, D>(sQ, LDT, sK, LDT, sS, LDS, false, nullptr);
    __syncthreads();

    float* srow = sS + r * LDS;
    float mx = NEG_INF;
#pragma unroll 4
    for (int c = part * CPT; c < (part + 1) * CPT; ++c) {
      const int col = k0 + c;
      float s = srow[c];
      if (col >= Sk || (causal && col > row)) s = NEG_INF;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = row_max<TPR>(mx);
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll 4
    for (int c = part * CPT; c < (part + 1) * CPT; ++c) {
      const float p = expf(srow[c] - m_new);
      sum += p;
      sP[r * LDP + c] = from_f<T>(p);
    }
    sum = row_sum<TPR>(sum);
    __syncwarp();
    if (part == 0) {
      const float alpha = expf(m_old - m_new);
      sA[r] = alpha;
      sL[r] = sL[r] * alpha + sum;
      sM[r] = m_new;
    }
    __syncthreads();
    mm<NN, BM, D, BN>(sP, LDP, sV, LDT, sO, LDO, true, sA);
  }
  __syncthreads();

  OT* ob = o + ((long)b * Sq + q0) * qstride + (long)h * D;
  for (int i = threadIdx.x; i < BM * D; i += NTHREADS) {
    const int rr = i / D, c = i % D;
    if (rr < nq_valid) ob[(long)rr * qstride + c] = from_f<OT>(sO[rr * LDO + c] / fmaxf(sL[rr], 1e-30f));
  }
  float* lb = lse + ((long)b * H + h) * Sq + q0;
  for (int rr = threadIdx.x; rr < nq_valid; rr += NTHREADS) lb[rr] = sM[rr] + logf(fmaxf(sL[rr], 1e-30f));
}

template <typename T, typename OT, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t st) {
  using L = FwdSmem<T, OT, D>;
  auto kern = flash_fwd_kernel<T, OT, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(Sq, L::BM), H, B);
  kern<<<grid, NTHREADS, L::bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<OT*>(o),
                                         static_cast<float*>(lse), H, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace tt

// dtype: 0 = bf16, 1 = f32 (q, k, v); out_f32: o is f32 instead of q's dtype.
// Returns a cudaError_t; cudaErrorInvalidValue for a combination not built.
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                            int H, int Hkv, int Sq, int Sk, int D, int dtype, int out_f32,
                            float scale, int causal, void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_FWD(T, OT, DD) return (int)launch_fwd<T, OT, DD>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, causal, st)
  if (dtype == 0 && !out_f32 && D == 64) TT_FWD(bf16, bf16, 64);
  if (dtype == 0 && !out_f32 && D == 128) TT_FWD(bf16, bf16, 128);
  if (dtype == 0 && out_f32 && D == 64) TT_FWD(bf16, float, 64);
  if (dtype == 0 && out_f32 && D == 128) TT_FWD(bf16, float, 128);
  if (dtype == 1 && D == 64) TT_FWD(float, float, 64);
  if (dtype == 1 && D == 128) TT_FWD(float, float, 128);
#undef TT_FWD
  return (int)cudaErrorInvalidValue;
}
