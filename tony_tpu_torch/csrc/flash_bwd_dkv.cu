// Flash-attention backward, dk and dv: dv = sum p^T . do and
// dk = sum ds^T . (q * scale), over the g query heads of a kv head's group
// and over all q tiles.
//
// Replaces: tony_tpu/ops/attention.py:303, _bwd_impl -> _bwd_dkv_kernel
// (Pallas).
//
// Bound on the H100: operations. Four products of D-deep dots per unmasked
// score (s, dp, dv, dk), 8 . D FLOP each, on the bf16 tensor cores at 989
// TFLOP/s; the bytes (q, k, v, do, lse, delta in, dk, dv out) are two
// orders of magnitude below that at S = 2048.
//
// bf16 design (flash_bwd_dkv_wgmma_kernel, sm_90a). One warpgroup (128
// threads) per (k tile of 64 keys, kv head, batch); about 98 KB of shared
// memory at D = 128, so two blocks share an SM. The block holds its K and
// V tiles in shared memory and streams the group's (query head, q tile)
// pairs, from the first q tile the causal mask lets see its keys, through
// a two-stage ring: Q, dO, lse and delta of the next pair are in flight
// (TMA, one mbarrier per stage for "full" and one for "empty") while the
// current pair's products run. It computes transposed, so that the
// accumulators of every product are the rows this block owns:
//   S^T = K . Qs^T, P^T = exp(S^T - lse) (0 where masked), in registers;
//   dV += P^T . dO, P^T rounded to bf16 as the register A operand;
//   dP^T = V . dO^T, dS^T = P^T * (dP^T - delta), in registers;
//   dK += dS^T . Qs, dS^T rounded to bf16 as the register A operand.
// dK and dV stay in registers across the whole loop and are written once.
// What it does about the five causes of the first (shared-memory) version's speed:
//   1. products are wgmma (m64n64k16 and m64nDk16) from 128-byte-swizzled
//      tiles through descriptors; the transposed operands are MN-major
//      descriptors (the transpose bit), so the TN element gather is gone;
//   2. every accumulator is in registers: S, P, dP and dS never touch
//      shared memory, dK and dV never leave registers until the end;
//   3. TMA loads through the two-stage mbarrier ring replace synchronous
//      loads; one block barrier per tile remains (after the in-place q
//      scaling pass, before the products read Qs);
//   4. ~98 KB of shared memory and <= 255 registers a thread: two blocks
//      (eight warps) per SM instead of one block of four warps;
//   5. blockIdx runs over k tiles slowest, first k tile first: the causal
//      blocks with the most q tiles start first and the light ones fill
//      the tail; tiles wholly below the diagonal skip the mask arithmetic.
// Numerics are those of the reference and of the f32 path: q is scaled in
// bf16 (one scaled tile feeds both S^T and dK, as the reference's
// attention.py:332 does), p = exp(s - lse) in f32, P rounded to bf16 for
// dV and dS for dK, f32 accumulation, no atomics: each block owns its rows,
// so the result is deterministic.
//
// Head dims: the wgmma kernel is compiled at tile widths D = 64, 128 and
// 256 and takes the true head_dim d (a multiple of 8, d <= D) at run time;
// the tensor maps read columns d..D-1 as zeros (a box wholly past d too),
// which leave every product over the head dim unchanged and give zero
// columns in the products onto it, and the epilogue stores columns < d only.
//
// Width 256 (flash_bwd_dkv_wgmma256_kernel, Gemma's heads). dK and dV at
// 64 x 256 f32 are 256 registers a thread: no warpgroup holds both. So two
// consumer warpgroups share the block's 64 keys, each owning a 128-column
// half of dK and of dV (64 + 64 registers). S^T and dP^T are split by
// query columns (m64n32 each, 32 of a tile's 64 queries per warpgroup);
// each rounds its P^T and dS^T to bf16 into two shared 64 x 64 boxes,
// written in the TMA's 128-byte swizzle so that a descriptor reads them;
// after a block barrier both add P^T . dO and dS^T . Qs over all 64 queries
// into their halves (m64n128, A from shared memory, B MN-major). K and V
// resident (64 KB), two Q | dO stages (128 KB), P^T and dS^T (16 KB), lse
// and delta: 210 KB, one block per SM; 190 registers, 0 spills. The GQA
// loop over the group's query heads stays in the block. Measured in
// one-call A/Bs at B4 S2048 H16/16 d = 256 bf16 causal on an H100 SXM 80
// GB at 700 W (medians of 20, four turns; SDPA's backward 1.096-1.107 ms):
// this design 0.887-0.904 ms (3.2x its bound); two P^T / dS^T buffers with
// tile t's dV and dK products left in flight under tile t + 1's scaling and
// scores (226 KB of shared memory, the next load issued after the scores)
// 0.868-0.883, about 2 %, not kept for that; the loads and barriers alone
// (no products) 0.710-0.714, 80 % of the whole: the Q | dO stream (each
// block reads every q tile its keys see, 64.5 KB a tile) is the first
// suspect, and more keys per block, which would halve it, need more
// registers than dK and dV leave.
//
// FMA family (flash_bwd_dkv_kernel<T, W>): the simple shared-memory kernel of
// flash_common.cuh over 32-row tiles, for f32 at every head_dim and for
// bf16 where the wgmma kernel does not go (d not a multiple of 8), at widths
// W = 32, 64, 128 and 256 with the true d at run time; wgmma takes no f32
// input. Same numerics as the wgmma kernel; slow (its products read both
// operands from shared memory): at d = 256 bf16 it took 94.2 ms at the
// shape above, see PERF.md.
//
// Left for later: one fused kernel for dq and dk/dv (s and dp are computed
// here and again in flash_bwd_dq.cu), a producer warp with setmaxnreg and
// two consumer warpgroups ping-ponging (one's exp pass under the other's
// products), a persistent grid, a deeper ring. Measured and dropped: two
// consumer warpgroups per block (128 keys) sharing one Q/dO stream, each
// skipping the q tiles before its keys with a branch around its products,
// ran slower than this one-warpgroup block (the products under a branch).
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace tt {

// ----------------------------------------------------------- FMA path
template <typename T, int W>
struct DkvSmem {
  static constexpr int BM = Tile<T>::B, BN = BM;
  static constexpr int LDT = ld<T, W>(), LDP = ld<T, BN>(), LDS = ldf<BN>(), LDO = ldf<W>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(2 * BN * LDT + 2 * BM * LDT + 2 * BM * LDP) +
      sizeof(float) * (size_t)(2 * BM * LDS + 2 * BN * LDO + 2 * BM);
};

template <typename T, int W>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int H, int Hkv, int Sq, int Sk, int d, float scale, int causal) {
  using L = DkvSmem<T, W>;
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
  const long qstride = (long)H * d, kstride = (long)Hkv * d;
  const long koff = ((long)b * Sk + k0) * kstride + (long)hk * d;

  const float scale_t = to_f(from_f<T>(scale));
  load_rows<T, BN, W>(sK, LDT, k + koff, kstride, nk_valid, d, false, 1.f);
  load_rows<T, BN, W>(sV, LDT, v + koff, kstride, nk_valid, d, false, 1.f);
  zero_f<BN, W>(sDK, LDO);
  zero_f<BN, W>(sDV, LDO);
  const int nq = (Sq + BM - 1) / BM;
  const int i0 = causal ? k0 / BM : 0;

  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BM;
      const int nq_valid = min(BM, Sq - q0);
      const long qoff = ((long)b * Sq + q0) * qstride + (long)h * d;
      const long soff = ((long)b * H + h) * Sq + q0;
      __syncthreads();  // the previous tile's products are done with sQ/sDO/sP/sDS
      load_rows<T, BM, W>(sQ, LDT, q + qoff, qstride, nq_valid, d, true, scale_t);
      load_rows<T, BM, W>(sDO, LDT, dout + qoff, qstride, nq_valid, d, false, 1.f);
      load_stat<BM>(sLse, lse + soff, nq_valid);
      load_stat<BM>(sDelta, delta + soff, nq_valid);
      __syncthreads();
      mm<NT, BM, BN, W>(sQ, LDT, sK, LDT, sS, LDS, false, nullptr);
      mm<NT, BM, BN, W>(sDO, LDT, sV, LDT, sDP, LDS, false, nullptr);
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
      mm<TN, BN, W, BM>(sP, LDP, sDO, LDT, sDV, LDO, true, nullptr);
      mm<TN, BN, W, BM>(sDS, LDP, sQ, LDT, sDK, LDO, true, nullptr);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < BN * W; e += NTHREADS) {
    const int r = e / W, c = e % W;
    if (r < nk_valid && c < d) {
      dk[koff + (long)r * kstride + c] = from_f<T>(sDK[r * LDO + c]);
      dv[koff + (long)r * kstride + c] = from_f<T>(sDV[r * LDO + c]);
    }
  }
}

template <typename T, int W>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, int d, float scale, int causal, cudaStream_t st) {
  using L = DkvSmem<T, W>;
  auto kern = flash_bwd_dkv_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(Sk, L::BN), Hkv, B);
  kern<<<grid, NTHREADS, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16 path (wgmma)
// Shared memory (bytes from a 1024-aligned base): K and V tiles, then two
// ring stages of [Q tile | dO tile | lse[64] | delta[64]], then barriers.
template <int D>
struct DkvHop {
  static constexpr int BN = 64, BM = 64, STAGES = 2;
  static constexpr int TILE_B = 64 * D * 2;  // one [64, D] bf16 tile
  static constexpr int K_OFF = 0, V_OFF = TILE_B, RING_OFF = 2 * TILE_B;
  static constexpr int LSE_OFF = 2 * TILE_B, DELTA_OFF = LSE_OFF + BM * 4;
  static constexpr uint32_t STAGE_TX = 2 * TILE_B + 2 * BM * 4;
  static constexpr int STAGE_STRIDE = (STAGE_TX + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_STRIDE;
  static constexpr size_t bytes = BAR_OFF + 8 * 8 + 1024;  // + alignment slack
};

// D is the tile width (64 or 128) and d <= D the true head_dim, a multiple
// of 8: the tensor maps read columns d..D-1 as zeros and dk, dv are stored
// for columns < d only. FULL (d == D): the strides and the epilogue take
// the constant D, so that the column bound costs the exact width nothing.
template <int D, bool FULL>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mdo,
                               const __grid_constant__ CUtensorMap mlse,
                               const __grid_constant__ CUtensorMap mdelta, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int B, int H, int Hkv, int Sq, int Sk,
                               int d, float scale, int causal) {
  using L = DkvHop<D>;
  using namespace hop;
  constexpr int KD = D / 16;  // k-steps over the head dim

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* kvbar = empty + L::STAGES;

  const int tid = threadIdx.x;
  // Block -> (k tile, kv head, batch), k tile slowest: heaviest tiles first.
  const int per = Hkv * B;
  const int kj = blockIdx.x / per, hk = blockIdx.x % per % Hkv, b = blockIdx.x % per / Hkv;
  const int g = H / Hkv;
  const int k0 = kj * L::BN;
  const int nq = (Sq + L::BM - 1) / L::BM;
  const int i0 = causal ? k0 / L::BM : 0;
  const int nqt = nq - i0, ntiles = g * nqt;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto stage = [&](int t) { return smem + L::RING_OFF + (t % L::STAGES) * L::STAGE_STRIDE; };
  // Tile t of the stream: query head hk * g + t / nqt, q tile i0 + t % nqt.
  auto issue = [&](int t) {
    unsigned char* st = stage(t);
    uint64_t* bar = &full[t % L::STAGES];
    const int h = hk * g + t / nqt, q0 = (i0 + t % nqt) * L::BM;
    const int soff = (b * H + h) * Sq + q0;
    mbar_expect_tx(bar, L::STAGE_TX);
    tma_tile<64, D>(reinterpret_cast<bf16*>(st), &mq, bar, h, q0, b);
    tma_tile<64, D>(reinterpret_cast<bf16*>(st + L::TILE_B), &mdo, bar, h, q0, b);
    tma_load_1d(st + L::LSE_OFF, &mlse, bar, soff);
    tma_load_1d(st + L::DELTA_OFF, &mdelta, bar, soff);
  };
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * L::TILE_B);
    tma_tile<64, D>(sK, &mk, kvbar, hk, k0, b);
    tma_tile<64, D>(sV, &mv, kvbar, hk, k0, b);
    issue(0);
  }

  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  const int w = tid >> 5, l = tid & 31;
  const int key0 = k0 + 16 * w + (l >> 2);  // this thread's key rows: key0, key0 + 8
  const int cq = 2 * (l & 3);               // and query columns 8j + cq + {0, 1}

  float dK[D / 2], dV[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    if (tid == 0 && t + 1 < ntiles) {
      // Stage (t + 1) % 2 last held tile t - 1: wait until every thread is done with it.
      if (t >= 1) mbar_wait(&empty[(t + 1) % L::STAGES], ((t - 1) >> 1) & 1);
      issue(t + 1);
    }
    __syncwarp();
    unsigned char* st = stage(t);
    bf16* sQ = reinterpret_cast<bf16*>(st);
    bf16* sDO = reinterpret_cast<bf16*>(st + L::TILE_B);
    const float2* sLse = reinterpret_cast<const float2*>(st + L::LSE_OFF);
    const float2* sDelta = reinterpret_cast<const float2*>(st + L::DELTA_OFF);
    const int q0 = (i0 + t % nqt) * L::BM;

    mbar_wait(&full[t % L::STAGES], (t >> 1) & 1);
    scale_tile<64 * D, 128>(sQ, scale_t, tid);  // Qs = q * scale in bf16, in place
    fence_proxy_async();
    __syncthreads();

    float sT[32], dpT[32];
    wg_fence();
    mma_ss_kk<KD>(sT, sK, sQ);  // S^T = K . Qs^T
    wg_commit();
    mma_ss_kk<KD>(dpT, sV, sDO);  // dP^T = V . dO^T
    wg_commit();
    wg_wait<1>();
    pin(sT);

    // P^T = exp(S^T - lse), 0 where masked; tiles wholly below the
    // diagonal and inside both sequences skip the mask.
    const bool inside = q0 + L::BM <= Sq && k0 + L::BN <= Sk && (!causal || q0 > k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = sLse[4 * j + (l & 3)];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const int key = key0 + 8 * (e >> 1), query = q0 + 8 * j + cq + (e & 1);
        float p = expf(sT[x] - ((e & 1) ? ls.y : ls.x));
        if (!inside && (query >= Sq || key >= Sk || (causal && key > query))) p = 0.f;
        sT[x] = p;
      }
    }
    uint32_t pa[4][4];
    acc_to_a<4>(sT, pa);
    wg_fence();
    mma_rs_mn<D, 4, 64>(dV, pa, sDO);  // dV += P^T . dO
    wg_commit();
    wg_wait<1>();
    pin(dpT);

    // dS^T = P^T * (dP^T - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = sDelta[4 * j + (l & 3)];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        dpT[x] = sT[x] * (dpT[x] - ((e & 1) ? dl.y : dl.x));
      }
    }
    wg_wait<0>();
    pin(dV);
    pin(pa);
    uint32_t dsa[4][4];
    acc_to_a<4>(dpT, dsa);
    wg_fence();
    mma_rs_mn<D, 4, 64>(dK, dsa, sQ);  // dK += dS^T . Qs
    wg_commit();
    wg_wait<0>();
    pin(dK);
    pin(dsa);
    mbar_arrive(&empty[t % L::STAGES]);
  }

  const int hd = FULL ? D : d;
  const long kstride = (long)Hkv * hd;
  const long koff = ((long)b * Sk + k0) * kstride + (long)hk * hd;
  store_acc<D>(dK, dk + koff, kstride, Sk - k0, hd, tid);
  store_acc<D>(dV, dv + koff, kstride, Sk - k0, hd, tid);
}

// ------------------------------------------------ bf16 path, width 256 (wgmma)
// Shared memory (bytes from a 1024-aligned base): K and V, two ring stages
// of [Q tile | dO tile], P^T and dS^T (bf16, 64 keys x 64 queries, one
// swizzled box each), each stage's lse[64] and delta[64], barriers.
template <>
struct DkvHop<256> {
  static constexpr int D = 256, BN = 64, BM = 64, STAGES = 2;
  static constexpr int TILE_B = 64 * D * 2;  // one [64, D] bf16 tile
  static constexpr int K_OFF = 0, V_OFF = TILE_B, RING_OFF = 2 * TILE_B;
  static constexpr int STAGE_STRIDE = 2 * TILE_B;
  static constexpr int P_OFF = RING_OFF + STAGES * STAGE_STRIDE, DS_OFF = P_OFF + BN * BM * 2;
  static constexpr int STAT_OFF = DS_OFF + BN * BM * 2, STAT_STRIDE = 2 * BM * 4;
  static constexpr uint32_t STAGE_TX = 2 * TILE_B + STAT_STRIDE;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * STAT_STRIDE;
  static constexpr size_t bytes = BAR_OFF + 8 * 8 + 1024;  // + alignment slack
};

// Two consumer warpgroups over one block's 64 keys. Warpgroup w forms S^T
// and dP^T on queries 32w..32w+31 of each tile (m64n32), P^T and dS^T in
// registers, and rounds them to bf16 into the shared P^T and dS^T boxes;
// after a block barrier it adds P^T . dO and dS^T . Qs over all 64 queries
// into its 128-column halves of dV and dK (m64n128, A from shared memory,
// B MN-major): 64 + 64 accumulator registers a thread.
template <bool FULL>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_wgmma256_kernel(const __grid_constant__ CUtensorMap mq,
                                  const __grid_constant__ CUtensorMap mk,
                                  const __grid_constant__ CUtensorMap mv,
                                  const __grid_constant__ CUtensorMap mdo,
                                  const __grid_constant__ CUtensorMap mlse,
                                  const __grid_constant__ CUtensorMap mdelta,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H,
                                  int Hkv, int Sq, int Sk, int d, float scale, int causal) {
  using namespace hop;
  constexpr int D = 256, KD = D / 16, BOXE = 64 * BOX;  // bf16 elements of one 64-column box
  using L = DkvHop<D>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::DS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* kvbar = empty + L::STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  // Block -> (k tile, kv head, batch), k tile slowest: heaviest tiles first.
  const int per = Hkv * B;
  const int kj = blockIdx.x / per, hk = blockIdx.x % per % Hkv, b = blockIdx.x % per / Hkv;
  const int g = H / Hkv;
  const int k0 = kj * L::BN;
  const int nq = (Sq + L::BM - 1) / L::BM;
  const int i0 = causal ? k0 / L::BM : 0;
  const int nqt = nq - i0, ntiles = g * nqt;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto stage = [&](int t) { return smem + L::RING_OFF + (t % L::STAGES) * L::STAGE_STRIDE; };
  auto stat = [&](int t) { return smem + L::STAT_OFF + (t % L::STAGES) * L::STAT_STRIDE; };
  // Tile t of the stream: query head hk * g + t / nqt, q tile i0 + t % nqt.
  auto issue = [&](int t) {
    unsigned char* st = stage(t);
    uint64_t* bar = &full[t % L::STAGES];
    const int h = hk * g + t / nqt, q0 = (i0 + t % nqt) * L::BM;
    const int soff = (b * H + h) * Sq + q0;
    mbar_expect_tx(bar, L::STAGE_TX);
    tma_tile<64, D>(reinterpret_cast<bf16*>(st), &mq, bar, h, q0, b);
    tma_tile<64, D>(reinterpret_cast<bf16*>(st + L::TILE_B), &mdo, bar, h, q0, b);
    tma_load_1d(stat(t), &mlse, bar, soff);
    tma_load_1d(stat(t) + L::BM * 4, &mdelta, bar, soff);
  };
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * L::TILE_B);
    tma_tile<64, D>(sK, &mk, kvbar, hk, k0, b);
    tma_tile<64, D>(sV, &mv, kvbar, hk, k0, b);
    issue(0);
  }

  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  const int w = wt >> 5, l = tid & 31;
  const int kr = 16 * w + (l >> 2);  // this thread's key rows in the tile: kr, kr + 8
  const int key0 = k0 + kr;
  const int qw = 32 * wg;            // this warpgroup's first query of a tile
  const int cq = 2 * (l & 3);        // and its query columns qw + 8j + cq + {0, 1}

  float dK[D / 4], dV[D / 4];  // this warpgroup's 128 columns
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dK[i] = dV[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    if (tid == 0 && t + 1 < ntiles) {
      // Stage (t + 1) % 2 last held tile t - 1: wait until every thread is done with it.
      if (t >= 1) mbar_wait(&empty[(t + 1) % L::STAGES], ((t - 1) >> 1) & 1);
      issue(t + 1);
    }
    __syncwarp();
    unsigned char* st = stage(t);
    bf16* sQ = reinterpret_cast<bf16*>(st);
    bf16* sDO = reinterpret_cast<bf16*>(st + L::TILE_B);
    const float2* sLse = reinterpret_cast<const float2*>(stat(t));
    const float2* sDelta = reinterpret_cast<const float2*>(stat(t) + L::BM * 4);
    const int q0 = (i0 + t % nqt) * L::BM;

    mbar_wait(&full[t % L::STAGES], (t >> 1) & 1);
    scale_tile<64 * D, 256>(sQ, scale_t, tid);  // Qs = q * scale in bf16, in place
    fence_proxy_async();
    // Also orders both warpgroups' products of tile t - 1 (done: waited for)
    // before this tile's writes of P^T and dS^T.
    __syncthreads();

    float sT[16], dpT[16];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)  // S^T = K . Qs^T on this warpgroup's queries
      Wg<32>::ss(sT, desc_k<64>(sK, kk), desc_k<64>(sQ + qw * BOX, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)  // dP^T = V . dO^T
      Wg<32>::ss(dpT, desc_k<64>(sV, kk), desc_k<64>(sDO + qw * BOX, kk), kk > 0);
    wg_commit();
    wg_wait<1>();
    pin(sT);

    // P^T = exp(S^T - lse), 0 where masked; tiles wholly below the
    // diagonal and inside both sequences skip the mask.
    const bool inside = q0 + L::BM <= Sq && k0 + L::BN <= Sk && (!causal || q0 > k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 ls = sLse[qw / 2 + 4 * j + (l & 3)];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const int key = key0 + 8 * (e >> 1), query = q0 + qw + 8 * j + cq + (e & 1);
        float p = expf(sT[x] - ((e & 1) ? ls.y : ls.x));
        if (!inside && (query >= Sq || key >= Sk || (causal && key > query))) p = 0.f;
        sT[x] = p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)  // P^T rounded to bf16, the A operand of dV += P^T . dO
        st_swz(sP, kr + 8 * i, qw + 8 * j + cq, pack_bf16(sT[4 * j + 2 * i], sT[4 * j + 2 * i + 1]));
    }
    wg_wait<0>();
    pin(dpT);

    // dS^T = P^T * (dP^T - delta), rounded to bf16: the A operand of dK += dS^T . Qs.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 dl = sDelta[qw / 2 + 4 * j + (l & 3)];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        dpT[x] = sT[x] * (dpT[x] - ((e & 1) ? dl.y : dl.x));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        st_swz(sDS, kr + 8 * i, qw + 8 * j + cq,
               pack_bf16(dpT[4 * j + 2 * i], dpT[4 * j + 2 * i + 1]));
    }
    fence_proxy_async();
    __syncthreads();

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dV[:, half] += P^T . dO[:, half]
      Wg<128>::ss<1>(dV, desc_k<64>(sP, kk), desc_mn<64>(sDO + 2 * wg * BOXE, kk), 1);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dK[:, half] += dS^T . Qs[:, half]
      Wg<128>::ss<1>(dK, desc_k<64>(sDS, kk), desc_mn<64>(sQ + 2 * wg * BOXE, kk), 1);
    wg_commit();
    wg_wait<0>();
    pin(dV);
    pin(dK);
    mbar_arrive(&empty[t % L::STAGES]);
  }

  const int hd = FULL ? D : d;
  const long kstride = (long)Hkv * hd;
  const long koff = ((long)b * Sk + k0) * kstride + (long)hk * hd + 128 * wg;
  store_acc<128>(dK, dk + koff, kstride, Sk - k0, hd - 128 * wg, wt);
  store_acc<128>(dV, dv + koff, kstride, Sk - k0, hd - 128 * wg, wt);
}

template <int D, bool FULL>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                             int Hkv, int Sq, int Sk, int d, float scale, int causal,
                             cudaStream_t st) {
  using L = DkvHop<D>;
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
  if (!hop::map_bshd(&mq, q, B, Sq, H, d, 64) || !hop::map_bshd(&mdo, dout, B, Sq, H, d, 64) ||
      !hop::map_bshd(&mk, k, B, Sk, Hkv, d, 64) || !hop::map_bshd(&mv, v, B, Sk, Hkv, d, 64) ||
      !hop::map_vec(&mlse, lse, (long)B * H * Sq, L::BM) ||
      !hop::map_vec(&mdelta, delta, (long)B * H * Sq, L::BM))
    return cudaErrorInvalidValue;
  // The width-256 kernel takes the same arguments with two warpgroups.
  auto kern = flash_bwd_dkv_wgmma256_kernel<FULL>;
  if constexpr (D != 256) kern = flash_bwd_dkv_wgmma_kernel<D, FULL>;
  const int threads = D == 256 ? 256 : 128;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sk, L::BN) * Hkv * B;
  kern<<<grid, threads, L::bytes, st>>>(mq, mk, mv, mdo, mlse, mdelta, static_cast<bf16*>(dk),
                                        static_cast<bf16*>(dv), B, H, Hkv, Sq, Sk, d, scale,
                                        causal);
  return cudaGetLastError();
}

}  // namespace tt

// family: 0 = wgmma (bf16, width 64, 128 or 256, d a multiple of 8), 1 = FMA
// (width 32, 64, 128 or 256); d <= width is the true head_dim. dtype: 0 =
// bf16, 1 = f32 (q, k, v, do, dk, dv). Returns a cudaError_t.
extern "C" int tt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int H, int Hkv, int Sq, int Sk, int d, int width, int family,
                                int dtype, float scale, int causal, void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return (int)cudaErrorInvalidValue;
#define TT_WG(W, FULL)                                                                  \
  return (int)launch_dkv_wgmma<W, FULL>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, d, \
                                        scale, causal, st)
#define TT_FMA(T, W) \
  return (int)launch_dkv<T, W>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_FMA_W(T)           \
  switch (width) {            \
    case 32: TT_FMA(T, 32);   \
    case 64: TT_FMA(T, 64);   \
    case 128: TT_FMA(T, 128); \
    case 256: TT_FMA(T, 256); \
  }                           \
  break
  if (family == 0 && dtype == 0 && d % 8 == 0) {
    const bool full = d == width;
    if (width == 64 && full) TT_WG(64, true);
    if (width == 64 && !full) TT_WG(64, false);
    if (width == 128 && full) TT_WG(128, true);
    if (width == 128 && !full) TT_WG(128, false);
    if (width == 256 && full) TT_WG(256, true);
    if (width == 256 && !full) TT_WG(256, false);
  } else if (family == 1) {
    switch (dtype) {
      case 0: TT_FMA_W(bf16);
      case 1: TT_FMA_W(float);
    }
  }
#undef TT_WG
#undef TT_FMA
#undef TT_FMA_W
  return (int)cudaErrorInvalidValue;
}
