// Flash-attention backward, dq: dq = sum over k tiles of ds . (k * scale),
// with p = exp(s - lse), dp = do . v^T and ds = p * (dp - delta).
//
// Replaces: tony_tpu/ops/attention.py:258, _bwd_impl -> _bwd_dq_kernel
// (Pallas).
//
// Bound on the H100: operations. Three products of D-deep dots per unmasked
// score (s, dp, dq), 6 . D FLOP each, on the bf16 tensor cores at 989
// TFLOP/s; the bytes are two orders of magnitude below that at S = 2048.
//
// bf16 design (flash_bwd_dq_wgmma_kernel, sm_90a). One warpgroup (128
// threads) per (q tile of 64 rows, head, batch); about 98 KB of shared
// memory at D = 128, so two blocks share an SM. The block loads its Q and
// dO tiles once (TMA) and streams the K and V tiles up to the causal
// diagonal through a two-stage ring (TMA, "full" and "empty" mbarriers per
// stage): the next tile is in flight while the current one's products run.
// Per k tile: k is scaled in bf16 in place (one scaled tile feeds both
// products, as the reference's attention.py:283 does); S = Q . Ks^T and
// dP = dO . V^T are wgmma products with both operands in shared memory;
// dS = P * (dP - delta) is formed in registers and rounded to bf16, and
// dQ += dS . Ks takes it as the register A operand with Ks as an MN-major
// operand (the descriptor's transpose bit). dQ stays in registers and is
// written once. delta = rowsum(o * do) - dlse is computed by the caller in
// plain torch, as the reference computes it in XLA outside its kernels.
// What it does about the five causes of the first (shared-memory) version's speed:
//   1. wgmma from 128-byte-swizzled tiles through descriptors, no
//      fragment-by-fragment loads;
//   2. S, P, dP and dS live in registers only; dQ never leaves registers
//      until the end;
//   3. TMA loads through the mbarrier ring replace synchronous loads; one
//      block barrier per tile remains (after the in-place k scaling);
//   4. ~98 KB of shared memory: two blocks (eight warps) per SM;
//   5. blockIdx runs over q tiles slowest, last q tile first: the causal
//      blocks with the most k tiles start first; tiles wholly below the
//      diagonal skip the mask arithmetic.
// Numerics: p = exp(s - lse) in f32, 0 where masked or past Sq/Sk; dS
// rounded to bf16; f32 accumulation; no atomics (each block owns its rows,
// so the result is deterministic).
//
// f32 (flash_bwd_dq_kernel<float>): the simple shared-memory FMA kernel of
// flash_common.cuh, for the small f32 checks; wgmma takes no f32 input.
//
// Left for later: a fused backward (s and dp are recomputed here and in the
// dk/dv kernel; fusing them with an atomic dq would give up determinism, a
// deterministic fusion needs a second pass), a producer warp with
// setmaxnreg and two consumer warpgroups, a persistent grid. Measured and
// dropped: two consumer warpgroups per block sharing one K/V stream, each
// skipping the k tiles past its rows with a branch around its products,
// ran slower than this one-warpgroup block (the products under a branch).
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace tt {

// ----------------------------------------------------------------- f32 path
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

// ------------------------------------------------------- bf16 path (wgmma)
// Shared memory (bytes from a 1024-aligned base): Q and dO tiles, then two
// ring stages of [K tile | V tile], then barriers.
template <int D>
struct DqHop {
  static constexpr int BM = 64, BN = 64, STAGES = 2;
  static constexpr int TILE_B = 64 * D * 2;  // one [64, D] bf16 tile
  static constexpr int Q_OFF = 0, DO_OFF = TILE_B, RING_OFF = 2 * TILE_B;
  static constexpr uint32_t STAGE_TX = 2 * TILE_B;
  static constexpr int STAGE_STRIDE = STAGE_TX;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_STRIDE;
  static constexpr size_t bytes = BAR_OFF + 8 * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mdo,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sk,
                              float scale, int causal) {
  using L = DqHop<D>;
  using namespace hop;
  constexpr int KD = D / 16;  // k-steps over the head dim

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* qbar = empty + L::STAGES;

  const int tid = threadIdx.x;
  // Block -> (q tile, head, batch), q tile slowest and last q tile first:
  // under the causal mask the heaviest tiles start first.
  const int per = H * B;
  const int nq = (Sq + L::BM - 1) / L::BM;
  const int tile = blockIdx.x / per, h = blockIdx.x % per % H, b = blockIdx.x % per / H;
  const int qi = causal ? nq - 1 - tile : tile;
  const int hk = h / (H / Hkv);
  const int q0 = qi * L::BM;
  int nk = (Sk + L::BN - 1) / L::BN;
  if (causal) nk = min(nk, qi + 1);

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto stage = [&](int j) { return smem + L::RING_OFF + (j % L::STAGES) * L::STAGE_STRIDE; };
  auto issue = [&](int j) {
    unsigned char* st = stage(j);
    uint64_t* bar = &full[j % L::STAGES];
    mbar_expect_tx(bar, L::STAGE_TX);
    tma_tile<64, D>(reinterpret_cast<bf16*>(st), &mk, bar, hk, j * L::BN, b);
    tma_tile<64, D>(reinterpret_cast<bf16*>(st + L::TILE_B), &mv, bar, hk, j * L::BN, b);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * L::TILE_B);
    tma_tile<64, D>(sQ, &mq, qbar, h, q0, b);
    tma_tile<64, D>(sDO, &mdo, qbar, h, q0, b);
    issue(0);
  }

  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  const int w = tid >> 5, l = tid & 31;
  const int row0 = q0 + 16 * w + (l >> 2);  // this thread's query rows: row0, row0 + 8
  const int ck = 2 * (l & 3);               // and key columns 8j + ck + {0, 1}
  float lse_r[2], delta_r[2];
  const long soff = ((long)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse_r[i] = r < Sq ? lse[soff + r] : 0.f;
    delta_r[i] = r < Sq ? delta[soff + r] : 0.f;
  }

  float dQ[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dQ[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < nk; ++j) {
    if (tid == 0 && j + 1 < nk) {
      // Stage (j + 1) % 2 last held tile j - 1: wait until every thread is done with it.
      if (j >= 1) mbar_wait(&empty[(j + 1) % L::STAGES], ((j - 1) >> 1) & 1);
      issue(j + 1);
    }
    __syncwarp();
    unsigned char* st = stage(j);
    bf16* sK = reinterpret_cast<bf16*>(st);
    bf16* sV = reinterpret_cast<bf16*>(st + L::TILE_B);
    const int k0 = j * L::BN;

    mbar_wait(&full[j % L::STAGES], (j >> 1) & 1);
    scale_tile<64 * D, 128>(sK, scale_t, tid);  // Ks = k * scale in bf16, in place
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
    wg_fence();
    mma_ss_kk<KD>(s, sQ, sK);  // S = Q . Ks^T
    wg_commit();
    mma_ss_kk<KD>(dp, sDO, sV);  // dP = dO . V^T
    wg_commit();
    wg_wait<1>();
    pin(s);

    // P = exp(S - lse), 0 where masked; tiles wholly below the diagonal and
    // inside both sequences skip the mask.
    const bool inside = q0 + L::BM <= Sq && k0 + L::BN <= Sk && (!causal || k0 < q0);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      const int row = row0 + 8 * i, key = k0 + 8 * (x >> 2) + ck + (x & 1);
      float p = expf(s[x] - lse_r[i]);
      if (!inside && (row >= Sq || key >= Sk || (causal && key > row))) p = 0.f;
      s[x] = p;
    }
    wg_wait<0>();
    pin(dp);
    // dS = P * (dP - delta), rounded to bf16 as the A operand of dQ += dS . Ks.
#pragma unroll
    for (int x = 0; x < 32; ++x) dp[x] = s[x] * (dp[x] - delta_r[(x >> 1) & 1]);
    uint32_t dsa[4][4];
    acc_to_a<4>(dp, dsa);
    wg_fence();
    mma_rs_mn<D, 4, 64>(dQ, dsa, sK);
    wg_commit();
    wg_wait<0>();
    pin(dQ);
    pin(dsa);
    mbar_arrive(&empty[j % L::STAGES]);
  }

  const long qstride = (long)H * D;
  store_acc<D>(dQ, dq + ((long)b * Sq + q0) * qstride + (long)h * D, qstride, Sq - q0, tid);
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                            int Sq, int Sk, float scale, int causal, cudaStream_t st) {
  using L = DqHop<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::map_bshd(&mq, q, B, Sq, H, D, 64) || !hop::map_bshd(&mdo, dout, B, Sq, H, D, 64) ||
      !hop::map_bshd(&mk, k, B, Sk, Hkv, D, 64) || !hop::map_bshd(&mv, v, B, Sk, Hkv, D, 64))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B;
  kern<<<grid, 128, L::bytes, st>>>(mq, mk, mv, mdo, static_cast<const float*>(lse),
                                    static_cast<const float*>(delta), static_cast<bf16*>(dq), B,
                                    H, Hkv, Sq, Sk, scale, causal);
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
#define TT_DQ_WG(DD) return (int)launch_dq_wgmma<DD>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, scale, causal, st)
  if (dtype == 0 && D == 64) TT_DQ_WG(64);
  if (dtype == 0 && D == 128) TT_DQ_WG(128);
  if (dtype == 1 && D == 64) TT_DQ(float, 64);
  if (dtype == 1 && D == 128) TT_DQ(float, 128);
#undef TT_DQ
#undef TT_DQ_WG
  return (int)cudaErrorInvalidValue;
}
