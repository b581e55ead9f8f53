// Flash-attention forward: o = softmax(q . k^T * scale) . v and the row
// logsumexp lse = m + log(l), causal or full, GQA by index.
//
// Replaces: tony_tpu/ops/attention.py:165, _fwd_impl -> _fwd_kernel
// (Pallas).
//
// Bound on the H100: operations. Two products of D-deep dots per unmasked
// score (S = Qs . K^T and O += P . V), 4 . D FLOP, on the bf16 tensor cores
// at 989 TFLOP/s; the bytes (q, k, v in, o and lse out) are two orders of
// magnitude below that at S = 2048.
//
// bf16 design (flash_fwd_wgmma_kernel, sm_90a). Two consumer warpgroups
// (256 threads) per (q tile of 128 rows, head, batch), 64 rows each, over
// 128-key tiles; 160 KB of shared memory at D = 128 (Q 32 KB, two ring
// stages each of K and V at 32 KB a tile), one block per SM. Blocks run
// q tile slowest, last q tile first: under the causal mask the heaviest
// start first. The block loads its Q tile once by TMA (a 4-d map, so rows
// past Sq read as zeros) and scales it in place once, in bf16, as the
// reference's qs = q * scale. Thread 0 streams the K and V tiles up to the
// causal diagonal through two two-stage rings (TMA, a "full" and an "empty"
// mbarrier per stage), K two tiles ahead of its use and V one. Both
// warpgroups walk the same k tiles and share every K and V tile. Per k tile
// j, each warpgroup issues S_{j+1} = Qs . K_{j+1}^T (both operands in shared
// memory) and O += P_j . V_j (P_j from registers, V MN-major through the
// descriptor's transpose bit) together, runs the online softmax of S_{j+1}
// under the P . V product (the mask on the diagonal and ragged tiles only;
// the row max over the quad of lanes that share a row; alpha; P), then
// rescales O by alpha in registers and rounds P to bf16 as the next A
// operand (hop::acc_to_a). O (64 f32 a thread at D = 128), S/P and the P
// operand live in registers: 186 a thread at D = 128, no spill. The
// epilogue divides by l and writes o (bf16 or f32) and lse from registers.
// What it does about the first (shared-memory) version's shortcomings:
//   1. wgmma (m64n128k16 for S, m64nDk16 for P . V) from 128-byte-swizzled
//      TMA tiles through descriptors, no fragment-by-fragment loads;
//   2. O, S and P never touch shared memory;
//   3. TMA loads through mbarrier rings replace synchronous loads: one
//      block barrier in all (after the Q scaling), not four per tile;
//   4. V is read MN-major by its descriptor, not gathered element by
//      element.
// Numerics are the reference's: q scaled in bf16; S in f32; keys past Sk
// and, under the causal mask, after the row are NEG_INF (a zero-filled K
// row would score 0, not -inf); P rounded to bf16 for P . V; l sums that
// bf16 P below head_dim 128 and the f32 P from 128 up (the reference's
// fused_rowsum = d < 128), in f32; o = O / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)). The exponentials are exp2 of the score
// times log2(e) less m times log2(e) (ex2.approx, ~2 ulp), not exp:
// chip_smoke.py holds lse within 1e-3 and o within 2e-2 of the plain
// version. No atomics: each block owns its rows, so the result is
// deterministic.
//
// Chosen by measurement: an A/B build of compile-time variants of this
// source (k tile, warpgroups, overlap, exp2), each checked against the plain
// version and timed in turns with SDPA's forward in one chip call; the
// settings that lost were then removed. Best turns at the flagship shape
// (B4 S2048 H8/4 D128 bf16 causal) on an H100 SXM 80 GB at 700 W, with
// SDPA's forward at 0.0839 ms in the same run: one warpgroup over 64-key
// tiles, two blocks per SM (the first skeleton), 0.1171 ms; 128-key tiles
// with one warpgroup, one block per SM, 0.1509; two warpgroups 0.1029;
// + S issued a tile ahead 0.1034; + exp2 without that overlap 0.0886; both
// 0.0862 (this design); one warpgroup over 64-key tiles with both 0.1009.
// Measured against this design in later runs and dropped (this design's
// time in the same run in brackets): the two warpgroups issuing their
// products in turn on named barriers (ping-pong) 0.0884 (0.0844); a
// persistent grid (one block per SM on a snake order of items, the next
// item's Q and K/V loaded under the last P . V) 0.1065 against 0.0930 for
// its per-item loop with one item per block, a loop that alone cost ~10 %
// (0.0933 (0.0845)); O rescaled between the issues of S and of P . V
// 0.0868 (0.0859); a producer warpgroup (setmaxnreg 24 / 240) 0.0856 with
// that rescale, 0.0866 (0.0840) without; three warpgroups over 192 rows
// and 64-key tiles 0.0966, with a producer 0.0884 (0.0840).
//
// Left for later: an epilogue through shared memory and a TMA store; two
// blocks per SM (160 KB of shared memory and 186 registers allow one).
//
// f32 (flash_fwd_kernel<float>): the simple shared-memory FMA kernel of
// flash_common.cuh, for the small f32 checks; wgmma takes no f32 input.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace tt {

// ----------------------------------------------------------------- f32 path
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

// ------------------------------------------------------- bf16 path (wgmma)
// Shared memory (bytes from a 1024-aligned base): one [64, D] Q tile per
// warpgroup, two ring stages of [BN, D] K tiles, two of V tiles, then
// barriers.
template <int D>
struct FwdHop {
  static constexpr int NWG = 2, BM = 64 * NWG, BN = 128, STAGES = 2;
  static constexpr int Q_B = 64 * D * 2;   // one warpgroup's [64, D] bf16 q tile
  static constexpr int KV_B = BN * D * 2;  // one [BN, D] bf16 k or v tile
  static constexpr int K_OFF = NWG * Q_B, V_OFF = K_OFF + STAGES * KV_B;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_B;
  static constexpr size_t bytes = BAR_OFF + (4 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64 x BN score tile in registers (the thread's
// two rows, see hopper_common.cuh): masks keys past Sk and, under `causal`,
// keys after the row to NEG_INF (unless `inside`); takes the row max over
// the quad of lanes that share a row; rescales the row sums by
// alpha = exp(m_old - m_new), returned for O; leaves P = exp(S - m_new) in
// s and, with SUM_F32, adds the f32 P to the row sums. Both exponentials
// are exp2 with log2(e) folded in.
template <int BN, bool SUM_F32>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m)[2], float (&lsum)[2],
                                               float (&alpha)[2], bool inside, int k0, int row0,
                                               int ck, int Sk, int causal) {
  if (!inside) {
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) {
      const int row = row0 + 8 * ((x >> 1) & 1), key = k0 + 8 * (x >> 2) + ck + (x & 1);
      if (key >= Sk || (causal && key > row)) s[x] = NEG_INF;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * LOG2E);
    m[i] = mx[i];
    lsum[i] *= alpha[i];
  }
  const float ms[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) {
    const int i = (x >> 1) & 1;
    s[x] = ex2(fmaf(s[x], LOG2E, -ms[i]));
    if (SUM_F32) lsum[i] += s[x];
  }
}

// P (in s) rounded to bf16 as the register A operand of O += P . V; without
// SUM_F32 the row sums add the rounded values, as the reference's
// ones-column product does below head_dim 128.
template <int KN, bool SUM_F32>
__device__ __forceinline__ void p_to_a(const float (&s)[8 * KN], uint32_t (&pa)[KN][4],
                                       float (&lsum)[2]) {
  hop::acc_to_a<KN>(s, pa);
  if (!SUM_F32) {
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) lsum[r & 1] += hop::bf16_lo(pa[kk][r]) + hop::bf16_hi(pa[kk][r]);
  }
}

template <int D, typename OT>
__global__ void __launch_bounds__(128 * FwdHop<D>::NWG, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, OT* __restrict__ o,
                           float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk,
                           float scale, int causal) {
  using L = FwdHop<D>;
  using namespace hop;
  constexpr int NWG = L::NWG, BN = L::BN, KD = D / 16, KN = BN / 16, ST = L::STAGES;
  constexpr bool SUM_F32 = D >= 128;  // the reference's fused_rowsum = d < 128

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kempty = kfull + ST;
  uint64_t* vfull = kempty + ST;
  uint64_t* vempty = vfull + ST;
  uint64_t* qbar = vempty + ST;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  // Block -> (q tile, head, batch), q tile slowest and last q tile first:
  // under the causal mask the heaviest tiles start first.
  const int per = H * B;
  const int nq = (Sq + L::BM - 1) / L::BM;
  const int tile = blockIdx.x / per, h = blockIdx.x % per % H, b = blockIdx.x % per / H;
  const int qi = causal ? nq - 1 - tile : tile;
  const int hk = h / (H / Hkv);
  const int q0 = qi * L::BM;
  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + L::BM - 1) / BN + 1);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 128 * NWG);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 128 * NWG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto ktile = [&](int t) { return reinterpret_cast<bf16*>(smem + L::K_OFF + (t % ST) * L::KV_B); };
  auto vtile = [&](int t) { return reinterpret_cast<bf16*>(smem + L::V_OFF + (t % ST) * L::KV_B); };
  // Tile t of K or V into its ring stage, once every thread is done with
  // tile t - STAGES there (thread 0 only).
  auto issue = [&](const CUtensorMap* map, uint64_t* full, uint64_t* empty, bf16* dst, int t) {
    if (t >= nk) return;
    if (t >= ST) mbar_wait(&empty[t % ST], ((t / ST) - 1) & 1);
    mbar_expect_tx(&full[t % ST], L::KV_B);
    tma_tile<BN, D>(dst, map, &full[t % ST], hk, t * BN, b);
  };
  bf16* sQall = reinterpret_cast<bf16*>(smem);
  if (tid == 0) {
    mbar_expect_tx(qbar, NWG * L::Q_B);
    for (int g = 0; g < NWG; ++g) tma_tile<64, D>(sQall + g * 64 * D, &mq, qbar, h, q0 + 64 * g, b);
    issue(&mk, kfull, kempty, ktile(0), 0);
    issue(&mk, kfull, kempty, ktile(1), 1);
    issue(&mv, vfull, vempty, vtile(0), 0);
  }

  const int w = wt >> 5, l = tid & 31;
  const int qw = q0 + 64 * wg;              // this warpgroup's first query row
  const int row0 = qw + 16 * w + (l >> 2);  // this thread's rows: row0, row0 + 8
  const int ck = 2 * (l & 3);               // and key columns 8j + ck + {0, 1}
  bf16* sQ = sQall + wg * 64 * D;

  mbar_wait(qbar, 0);
  scale_tile<64 * D, 128>(sQ, __bfloat162float(__float2bfloat16(scale)), wt);  // Qs, in place
  fence_proxy_async();
  __syncthreads();

  float O[D / 2], s[BN / 2], alpha[2];
  float m[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.f, 0.f};
  uint32_t pa[KN][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) O[i] = 0.f;
  // Tiles wholly inside Sk and below this warpgroup's diagonal skip the mask.
  auto inside = [&](int j) { return (j + 1) * BN <= Sk && (!causal || (j + 1) * BN - 1 <= qw); };

  // S of tile 0; then per step j, S of tile j + 1 and O += P_j . V_j in
  // flight together, the softmax of tile j + 1 under the P . V product;
  // then the last P . V.
  mbar_wait(&kfull[0], 0);
  wg_fence();
  mma_ss_kk<KD, BN>(s, sQ, ktile(0));  // S = Qs . K^T
  wg_commit();
  wg_wait<0>();
  pin(s);
  mbar_arrive(&kempty[0]);
  online_softmax<BN, SUM_F32>(s, m, lsum, alpha, inside(0), 0, row0, ck, Sk, causal);
  p_to_a<KN, SUM_F32>(s, pa, lsum);
  for (int j = 0; j + 1 < nk; ++j) {
    // Thread 0 issues K two tiles ahead of its use and V one.
    if (tid == 0) {
      issue(&mk, kfull, kempty, ktile(j + 2), j + 2);
      issue(&mv, vfull, vempty, vtile(j + 1), j + 1);
    }
    __syncwarp();
    mbar_wait(&kfull[(j + 1) % ST], ((j + 1) / ST) & 1);
    mbar_wait(&vfull[j % ST], (j / ST) & 1);
    wg_fence();
    mma_ss_kk<KD, BN>(s, sQ, ktile(j + 1));
    wg_commit();
    mma_rs_mn<D, KN, BN>(O, pa, vtile(j));  // O += P . V
    wg_commit();
    wg_wait<1>();
    pin(s);
    mbar_arrive(&kempty[(j + 1) % ST]);
    online_softmax<BN, SUM_F32>(s, m, lsum, alpha, inside(j + 1), (j + 1) * BN, row0, ck, Sk,
                                causal);
    wg_wait<0>();
    pin(O);
    pin(pa);
    mbar_arrive(&vempty[j % ST]);
#pragma unroll
    for (int x = 0; x < D / 2; ++x) O[x] *= alpha[(x >> 1) & 1];
    p_to_a<KN, SUM_F32>(s, pa, lsum);
  }
  mbar_wait(&vfull[(nk - 1) % ST], ((nk - 1) / ST) & 1);
  wg_fence();
  mma_rs_mn<D, KN, BN>(O, pa, vtile(nk - 1));
  wg_commit();
  wg_wait<0>();
  pin(O);
  pin(pa);

  // Row sums over the quad, o = O / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    lsum[i] = fmaxf(lsum[i], 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < D / 2; ++x) O[x] = O[x] / lsum[(x >> 1) & 1];
  const long qstride = (long)H * D;
  store_acc<D>(O, o + ((long)b * Sq + qw) * qstride + (long)h * D, qstride, Sq - qw, wt);
  if ((l & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Sq) lse[((long)b * H + h) * Sq + row] = m[i] + logf(lsum[i]);
    }
  }
}

template <int D, typename OT>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                             cudaStream_t st) {
  using L = FwdHop<D>;
  CUtensorMap mq, mk, mv;
  if (!hop::map_bshd(&mq, q, B, Sq, H, D, 64) || !hop::map_bshd(&mk, k, B, Sk, Hkv, D, L::BN) ||
      !hop::map_bshd(&mv, v, B, Sk, Hkv, D, L::BN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D, OT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B;
  kern<<<grid, 128 * L::NWG, L::bytes, st>>>(mq, mk, mv, static_cast<OT*>(o), static_cast<float*>(lse),
                                             B, H, Hkv, Sq, Sk, scale, causal);
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
#define TT_FWD_WGMMA(DD, OT) return (int)launch_fwd_wgmma<DD, OT>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, causal, st)
  if (dtype == 0 && !out_f32 && D == 64) TT_FWD_WGMMA(64, bf16);
  if (dtype == 0 && !out_f32 && D == 128) TT_FWD_WGMMA(128, bf16);
  if (dtype == 0 && out_f32 && D == 64) TT_FWD_WGMMA(64, float);
  if (dtype == 0 && out_f32 && D == 128) TT_FWD_WGMMA(128, float);
  if (dtype == 1 && D == 64) TT_FWD(float, float, 64);
  if (dtype == 1 && D == 128) TT_FWD(float, float, 128);
#undef TT_FWD
#undef TT_FWD_WGMMA
  return (int)cudaErrorInvalidValue;
}
