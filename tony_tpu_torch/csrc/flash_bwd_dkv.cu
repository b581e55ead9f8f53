// Flash-attention backward, dk and dv: dv = sum p^T . do and
// dk = sum ds^T . (q * scale), over the g query heads of a kv head's group
// and over all q tiles.
//
// Replaces: tony_tpu/ops/attention.py:303, _bwd_impl -> _bwd_dkv_kernel
// (Pallas).
//
// Bound on the H100: operations. Four products of D-deep dots per unmasked
// score (s, dp, dv, dk), 8 . D FLOP each, on the bf16 tensor cores at 989
// TFLOP/s (f32: on the CUDA cores at 67); the bytes (q, k, v, do, lse, delta in, dk, dv out) are two
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
// FMA family (flash_bwd_dkv_kernel<T, W>), for f32 at every head_dim and
// bf16 where the wgmma kernel does not go (d not a multiple of 8), at tile
// widths W = 16, 32, 64, 128 and 256 with the true d at run time; wgmma
// takes no f32 input, so f32 stays exact: fmaf on the CUDA cores, no TF32,
// bound at the f32 peak of 67 TFLOP/s. Same numerics as above (q scaled in
// T in place, P rounded to T for dV and dS for dK, f32 sums, no atomics).
// Tiles are f32 in shared memory (bf16 widened on the way in), row stride
// W + 4. Per block (DkvFma): BN keys, K and V resident; the group's (query
// head, q tile) pairs stream through a two-stage cp.async ring of [Q | dO
// | lse | delta] (16-byte copies where a row is whole 16-byte vectors,
// 4-byte ones else, zero-fill past Sq; bf16 copies synchronously), the
// next pair in flight while this one's products run. Each thread scales
// the Q elements it copied itself once they land: two block barriers a
// pair. S^T and dP^T (keys as rows) are register micro-tiles (4 x 4 cells
// at width 16-64, 4 x 2 at 128, 2 x 2 at 256); P^T and dS^T are formed in
// registers and go through shared memory once each, as the A operands of
// dV += P^T . dO and dK += dS^T . Qs. dK and dV stay in registers across
// the whole loop (4 x 4 or 4 x 8 cells each; at width 16 and 32 over 4
// and 2 splits of a pair's queries, summed once at the end in a fixed
// order) and are stored once.
//   width   BN x BM   threads  f32 regs  shared KiB  blocks an SM
//    16     64 x 64     256       128        65.0        2
//    32     64 x 64     256       128        89.0        2
//    64     64 x 32     128       216        86.5        2
//   128     64 x 32     256       204       150.5        1
//   256     32 x 32     256       212       204.5        1
// (bf16, under no block count: 168-208 registers; no spills.)
// Measured at B4 S2048 causal f32 (H8/4, Gemma-7B's H16/16 at 256) on an
// NVIDIA H100 80GB HBM3 at 700 W, medians of 20 CUDA-event timings, in
// one-call A/Bs (SDPA's f32 backward, all three gradients, beside it):
// d = 16 0.3265 ms (2.5x its bound 0.1283; SDPA 2.135), d = 64 1.159
// (2.3x; 2.874), d = 128 2.427 (2.4x; 4.189), d = 256 12.565 (3.1x;
// 10.88); the kernel it replaced (one element a thread over shared memory,
// 32-row tiles, synchronous loads, width 32 at d = 16) took 2.96699 at
// d = 16. Variants timed: loops over the head dim unrolled 4 steps instead
// of all 2.61 at d = 128 (unrolled 2: 2.77); one block of 256 threads an SM
// at width 16 0.409; __expf instead of expf 0.321 at d = 16, not kept; at
// width 128 32 x 32 tiles of 128 threads 2.556; at width 256 two blocks an
// SM (128 registers) 14.59 with spills, 128 threads with 4 x 2 S^T cells
// 12.90; at width 64 64 x 64 tiles of 256 threads 1.186. What still holds
// it from the bound (no profiler there; from the instruction mix): at d =
// 16 each score costs 64 FMAs and about a dozen more instructions (expf,
// the mask, P^T and dS^T and their two stores), besides a float4 shared
// load per 4-16 FMAs and two barriers a pair; at width 256 the 2 x 2 S^T
// cells read a float4 per 4 FMAs, all the shared memory the SM serves.
//
// Left for later: one fused kernel for dq and dk/dv (s and dp are computed
// here and again in flash_bwd_dq.cu), a producer warp with setmaxnreg and
// two consumer warpgroups ping-ponging (one's exp pass under the other's
// products), a persistent grid, a deeper ring. Measured and dropped: two
// consumer warpgroups per block (128 keys) sharing one Q/dO stream, each
// skipping the q tiles before its keys with a branch around its products,
// ran slower than this one-warpgroup block (the products under a branch).
//
// Split family past width 256 (flash_bwd_dkv_split_kernel<T>, DkvSplit), for
// every head_dim d > 256 in bf16 and f32. DkvFma<256>'s resident K and V (32
// keys) and its Q | dO ring take 204.5 KiB; at 512 they would take ~418.
// The head dim goes in nc = ceil(d / 256) chunks, and each block owns the dK
// and dV columns of one chunk c of its 32 keys, on DkvFma<256>'s tiles and
// cells. Per (query head, q tile) pair a three-stage cp.async ring carries,
// for each chunk x in the order c + 1, ..., nc - 1, 0, ..., c, a unit
// [V_x | dO_x] and a unit [K_x | Qs_x] (204.5 KiB in all). A stage is
// refilled two units after it was read, so the pair's last two units, dO_c
// and Qs_c, are both still in shared memory for dV_c += P^T . dO_c and
// dK_c += dS^T . Qs_c (a two-stage ring would have overwritten dO_c). lse and
// delta come with a pair's first unit, two pairs' worth kept. K and V are
// re-read every pair; S^T and dP^T are computed nc times (1.5x dk/dv's FLOPs
// at d = 512). 230 registers (f32), 254 (bf16), 0 spills. Measured at B4
// S2048 causal H8/8 on an NVIDIA H100 80GB HBM3 at 700 W (medians of 20, one
// call, turns A B B A): f32 d = 512 23.23-23.41 ms (5.7x its bound without
// the recomputation, 4.10); bf16 23.54-23.71 with 16-byte loads, 52.32
// widened element by element.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace tt {

// ----------------------------------------------------------- FMA path
// Tiles of one block, per width W: BN keys (K and V resident), BM query rows
// a streamed (query head, q tile) pair, NTH threads. S^T and dP^T are TM x
// TN cells a thread (keys GY apart, queries GX apart); dK and dV are TMO x
// 4 TCO cells each a thread (rows QY apart, float4 columns 4 QX apart),
// over KS splits of a pair's queries whose partials are summed once at the
// end. Shared memory (f32, row stride W + 4): K, V, two stages of [Q | dO |
// lse | delta], P^T and dS^T [BN, BM + 4].
// MINB f32 blocks an SM (bf16: 1) bound the registers (2 x 256 threads:
// 128 a thread); U float4 steps of a product are unrolled (0: all).
template <int W> struct DkvFma;
template <> struct DkvFma<16> { static constexpr int BN = 64, BM = 64, NTH = 256, TM = 4, TN = 4, TMO = 4, TCO = 1, KS = 4, MINB = 2, U = 0; };
template <> struct DkvFma<32> { static constexpr int BN = 64, BM = 64, NTH = 256, TM = 4, TN = 4, TMO = 4, TCO = 1, KS = 2, MINB = 2, U = 0; };
template <> struct DkvFma<64> { static constexpr int BN = 64, BM = 32, NTH = 128, TM = 4, TN = 4, TMO = 4, TCO = 2, KS = 1, MINB = 2, U = 0; };
template <> struct DkvFma<128> { static constexpr int BN = 64, BM = 32, NTH = 256, TM = 4, TN = 2, TMO = 4, TCO = 2, KS = 1, MINB = 1, U = 0; };
template <> struct DkvFma<256> { static constexpr int BN = 32, BM = 32, NTH = 256, TM = 2, TN = 2, TMO = 4, TCO = 2, KS = 1, MINB = 1, U = 4; };

template <int W>
struct DkvLay : DkvFma<W> {
  using C = DkvFma<W>;
  static constexpr int LD = ldw<W>(), LDP = C::BM + 4;
  static constexpr int GX = C::BM / C::TN, GY = C::BN / C::TM;   // score cells
  static constexpr int QX = W / 4 / C::TCO, QY = C::BN / C::TMO;  // dK / dV cells of one split
  static constexpr int STAGE = 2 * C::BM * LD + 2 * C::BM;       // Q, dO, lse, delta
  static constexpr int P_OFF = 2 * C::BN * LD + 2 * STAGE;
  static constexpr size_t bytes = sizeof(float) * (size_t)(P_OFF + 2 * C::BN * LDP);
  static_assert(GX * GY == C::NTH && QX * QY * C::KS == C::NTH, "one cell of each a thread");
  static_assert(2 * C::KS * C::BN * W <= P_OFF + 2 * C::BN * LDP, "the partials fit");
};

template <typename T, int W>
__global__ void __launch_bounds__(DkvFma<W>::NTH, std::is_same<T, float>::value ? DkvFma<W>::MINB : 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int B, int H, int Hkv, int Sq, int Sk, int d, float scale, int causal) {
  using L = DkvLay<W>;
  constexpr int BM = L::BM, BN = L::BN, NTH = L::NTH, TM = L::TM, TN = L::TN, TMO = L::TMO,
                TCO = L::TCO, KS = L::KS, LD = L::LD, LDP = L::LDP, GX = L::GX, GY = L::GY,
                QX = L::QX, QY = L::QY, QSPAN = BM / KS, STAGE = L::STAGE;
  constexpr int US = L::U ? L::U : W / 4, UA = L::U && L::U < QSPAN / 4 ? L::U : QSPAN / 4;

  extern __shared__ __align__(16) float sm[];
  float* sK = sm;
  float* sV = sK + BN * LD;
  float* sRing = sV + BN * LD;  // stage s at sRing + s STAGE
  float* sP = sm + L::P_OFF;
  float* sDS = sP + BN * LDP;

  // Block -> (k tile, kv head, batch), k tile slowest and first k tile
  // first: under the causal mask the tiles with the most q tiles start first.
  const int tid = threadIdx.x;
  const int per = Hkv * B, g = H / Hkv;
  const int kj = blockIdx.x / per, hk = blockIdx.x % per % Hkv, b = blockIdx.x % per / Hkv;
  const int k0 = kj * BN, nk_valid = min(BN, Sk - k0);
  const long qstride = (long)H * d, kstride = (long)Hkv * d;
  const long koff = ((long)b * Sk + k0) * kstride + (long)hk * d;
  // The pairs: the group's query heads, each from the first q tile whose
  // rows reach key k0 under the causal mask.
  const int nq = (Sq + BM - 1) / BM, i0 = causal ? k0 / BM : 0;
  const int nqi = nq - i0, np = g * nqi;
  const float scale_t = to_f(from_f<T>(scale));

  zero_tail<W, NTH>(sK, 2 * BN, d);
  zero_tail<W, NTH>(sRing, 2 * BM, d);
  zero_tail<W, NTH>(sRing + STAGE, 2 * BM, d);
  copy_tile<T, BN, W, NTH>(sK, k + koff, kstride, nk_valid, d, false, 1.f);
  copy_tile<T, BN, W, NTH>(sV, v + koff, kstride, nk_valid, d, false, 1.f);
  auto issue = [&](int p) {  // Q, dO, lse and delta of pair p into stage p % 2, one commit group
    float* st = sRing + (p & 1) * STAGE;
    const int h = hk * g + p / nqi, q0 = (i0 + p % nqi) * BM, n = min(BM, Sq - q0);
    const long qoff = ((long)b * Sq + q0) * qstride + (long)h * d;
    const long soff = ((long)b * H + h) * Sq + q0;
    copy_tile<T, BM, W, NTH>(st, q + qoff, qstride, n, d, true, scale_t);
    copy_tile<T, BM, W, NTH>(st + BM * LD, dout + qoff, qstride, n, d, false, 1.f);
    copy_stat<BM, NTH>(st + 2 * BM * LD, lse + soff, n);
    copy_stat<BM, NTH>(st + 2 * BM * LD + BM, delta + soff, n);
    cp_commit();
  };
  issue(0);

  // This thread's score cells (keys ty + i GY, queries tx + j GX) and its
  // dK / dV cells (rows oy + i QY, columns 4 (ox + c QX)) over queries ks
  // QSPAN ... of each pair.
  const int tx = Cells<GX, GY>::x(tid), ty = Cells<GX, GY>::y(tid);
  const int ks = tid / (NTH / KS), u = tid % (NTH / KS);
  const int ox = Cells<QX, QY>::x(u), oy = Cells<QX, QY>::y(u);
  float dK[TMO][4 * TCO], dV[TMO][4 * TCO];
#pragma unroll
  for (int i = 0; i < TMO; ++i)
#pragma unroll
    for (int c = 0; c < 4 * TCO; ++c) dK[i][c] = dV[i][c] = 0.f;

  for (int p = 0; p < np; ++p) {
    float* sQ = sRing + (p & 1) * STAGE;
    const float* sDO = sQ + BM * LD;
    const float* sLse = sDO + BM * LD;
    const float* sDelta = sLse + BM;
    const int q0 = (i0 + p % nqi) * BM;
    cp_wait_all();
    scale_own<T, BM, W, NTH>(sQ, d, scale_t);  // Qs = q * scale, in place (f32)
    __syncthreads();  // pair p visible; every thread done with pair p - 1, P^T and dS^T
    if (p + 1 < np) issue(p + 1);

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[i][c] = dp[i][c] = 0.f;
    dot_rows<TM, TN, W, LD, GY, GX, US>(s, sK + ty * LD, sQ + tx * LD);    // S^T = K . Qs^T
    dot_rows<TM, TN, W, LD, GY, GX, US>(dp, sV + ty * LD, sDO + tx * LD);  // dP^T = V . dO^T

    // P^T = exp(S^T - lse), 0 where masked, rounded to T for dV += P^T . dO;
    // dS^T = P^T * (dP^T - delta), rounded to T for dK += dS^T . Qs. Tiles
    // wholly below the diagonal and inside both sequences skip the mask.
    const bool inside = q0 + BM <= Sq && k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = tx + c * GX;
      const float lse_c = sLse[n], delta_c = sDelta[n];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = ty + i * GY;
        float pv = expf(s[i][c] - lse_c);
        if (!inside && (q0 + n >= Sq || k0 + m >= Sk || (causal && k0 + m > q0 + n))) pv = 0.f;
        sP[m * LDP + n] = rounded<T>(pv);
        sDS[m * LDP + n] = rounded<T>(pv * (dp[i][c] - delta_c));
      }
    }
    __syncthreads();
    acc_rows<TMO, TCO, QSPAN, LDP, LD, QY, 4 * QX, UA>(dV, sP + oy * LDP + ks * QSPAN,
                                                  sDO + ks * QSPAN * LD + 4 * ox);
    acc_rows<TMO, TCO, QSPAN, LDP, LD, QY, 4 * QX, UA>(dK, sDS + oy * LDP + ks * QSPAN,
                                                  sQ + ks * QSPAN * LD + 4 * ox);
  }

  // dK and dV = the sums of the KS partials, in a fixed order, through
  // shared memory: dV's partials, then dK's.
  __syncthreads();
  float* rv = sm;
  float* rk = sm + KS * BN * W;
  put_cells<TMO, TCO, W, QY, 4 * QX>(rv + (ks * BN + oy) * W + 4 * ox, dV);
  put_cells<TMO, TCO, W, QY, 4 * QX>(rk + (ks * BN + oy) * W + 4 * ox, dK);
  __syncthreads();
  for (int e = tid; e < BN * W; e += NTH) {
    const int r = e / W, c = e % W;
    if (r >= nk_valid || c >= d) continue;
    float xv = rv[e], xk = rk[e];
#pragma unroll
    for (int s = 1; s < KS; ++s) xv += rv[s * BN * W + e], xk += rk[s * BN * W + e];
    dv[koff + (long)r * kstride + c] = from_f<T>(xv);
    dk[koff + (long)r * kstride + c] = from_f<T>(xk);
  }
}

template <typename T, int W>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, int d, float scale, int causal, cudaStream_t st) {
  using L = DkvLay<W>;
  auto kern = flash_bwd_dkv_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sk, L::BN) * Hkv * B;
  kern<<<grid, L::NTH, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), B, H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------ FMA path past width 256
// DkvFma<256>'s tiles and cells with the head dim in chunks (flash_common.cuh,
// SPLIT); each block owns the dK and dV columns of one chunk c of its BN
// keys. Shared memory (f32, row stride SPLIT + 4): three ring stages of
// BN + BM rows, each holding one unit, then P^T and dS^T [BN, BM + 4] and
// two pairs' lse and delta. Per (query head, q tile) pair the ring carries,
// for each chunk x in the order c + 1, ..., nc - 1, 0, ..., c, a unit
// [V_x | dO_x] and a unit [K_x | Qs_x]; a unit's stage is refilled two units
// later, so dO_c and Qs_c, the pair's last two units, are both still there
// for dV_c += P^T . dO_c and dK_c += dS^T . Qs_c.
struct DkvSplit : DkvLay<SPLIT> {
  static constexpr int STAGE = (BN + BM) * LD, STAGES = 3;
  static constexpr int P_OFF = STAGES * STAGE;
  static constexpr size_t bytes = sizeof(float) * (size_t)(P_OFF + 2 * BN * LDP + 4 * BM);
};

template <typename T>
__global__ void __launch_bounds__(DkvSplit::NTH, 1)
    flash_bwd_dkv_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int B, int H, int Hkv,
                               int Sq, int Sk, int d, float scale, int causal) {
  using L = DkvSplit;
  constexpr int BM = L::BM, BN = L::BN, NTH = L::NTH, TM = L::TM, TN = L::TN, TMO = L::TMO,
                TCO = L::TCO, LD = L::LD, LDP = L::LDP, GX = L::GX, GY = L::GY, QX = L::QX,
                QY = L::QY, STAGE = L::STAGE, ST = L::STAGES;
  static_assert(L::KS == 1, "one split of a pair's queries");

  extern __shared__ __align__(16) float sm[];
  float* sP = sm + L::P_OFF;
  float* sDS = sP + BN * LDP;
  float* sStat = sDS + BN * LDP;  // pair p's lse at sStat + 2 BM (p % 2), its delta after it

  // Block -> (chunk, k tile, kv head, batch): the chunk fastest, k tile
  // slowest and first k tile first, as in flash_bwd_dkv_kernel.
  const int tid = threadIdx.x;
  const int nc = nchunks(d), ch = blockIdx.x % nc, bx = blockIdx.x / nc;
  const int per = Hkv * B, g = H / Hkv;
  const int kj = bx / per, hk = bx % per % Hkv, b = bx % per / Hkv;
  const int k0 = kj * BN, nk_valid = min(BN, Sk - k0);
  const long qstride = (long)H * d, kstride = (long)Hkv * d;
  const long koff = ((long)b * Sk + k0) * kstride + (long)hk * d;
  const int nq = (Sq + BM - 1) / BM, i0 = causal ? k0 / BM : 0;
  const int nqi = nq - i0, np = g * nqi;
  const float scale_t = to_f(from_f<T>(scale));
  const bool vec = d % (16 / (int)sizeof(T)) == 0;  // rows of whole 16-byte vectors
  const int c0 = ch * SPLIT, dc = chunk_cols(d, ch);
  const int per_pair = 2 * nc, nu = np * per_pair;

  // Unit u: pair u / per_pair; chunk (c + 1 + i) % nc with i = u % per_pair / 2;
  // [V | dO] when u is even, [K | Qs] when odd; the pair's lse and delta
  // with its first unit.
  auto issue = [&](int u) {  // unit u into stage u % 3, one commit group
    float* st = sm + u % ST * STAGE;
    const int p = u / per_pair, i = u % per_pair, x = (ch + 1 + i / 2) % nc;
    const int h = hk * g + p / nqi, q0 = (i0 + p % nqi) * BM, n = min(BM, Sq - q0);
    const int x0 = x * SPLIT, dx = chunk_cols(d, x);
    const long qoff = ((long)b * Sq + q0) * qstride + (long)h * d;
    const bool kq = i & 1;
    copy_chunk<T, BN, NTH>(st, (kq ? k : v) + koff + x0, kstride, nk_valid, dx, vec, false, 1.f);
    copy_chunk<T, BM, NTH>(st + BN * LD, (kq ? q : dout) + qoff + x0, qstride, n, dx, vec, kq,
                           scale_t);
    if (i == 0) {
      const long soff = ((long)b * H + h) * Sq + q0;
      float* ss = sStat + (p & 1) * 2 * BM;
      copy_stat<BM, NTH>(ss, lse + soff, n);
      copy_stat<BM, NTH>(ss + BM, delta + soff, n);
    }
    cp_commit();
  };
  issue(0);

  const int tx = Cells<GX, GY>::x(tid), ty = Cells<GX, GY>::y(tid);
  const int ox = Cells<QX, QY>::x(tid), oy = Cells<QX, QY>::y(tid);
  float dK[TMO][4 * TCO], dV[TMO][4 * TCO], s[TM][TN], dp[TM][TN];
#pragma unroll
  for (int i = 0; i < TMO; ++i)
#pragma unroll
    for (int c = 0; c < 4 * TCO; ++c) dK[i][c] = dV[i][c] = 0.f;

  for (int u = 0; u < nu; ++u) {
    float* st = sm + u % ST * STAGE;
    const int p = u / per_pair, i = u % per_pair;
    cp_wait_all();
    if constexpr (std::is_same<T, float>::value)
      if (i & 1) scale_chunk<BM, NTH>(st + BN * LD, vec, scale_t);  // Qs = q * scale, in place (f32)
    __syncthreads();  // unit u visible; every thread done with unit u - 2, P^T and dS^T
    if (u + 1 < nu) issue(u + 1);

    if (i == 0) {
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) s[a][c] = dp[a][c] = 0.f;
    }
    if (i & 1)
      dot_rows<TM, TN, SPLIT, LD, GY, GX, L::U>(s, st + ty * LD, st + (BN + tx) * LD);  // S^T += K_x . Qs_x^T
    else
      dot_rows<TM, TN, SPLIT, LD, GY, GX, L::U>(dp, st + ty * LD, st + (BN + tx) * LD);  // dP^T += V_x . dO_x^T
    if (i + 1 < per_pair) continue;

    // P^T = exp(S^T - lse), 0 where masked, rounded to T for dV_c += P^T . dO_c;
    // dS^T = P^T * (dP^T - delta), rounded to T for dK_c += dS^T . Qs_c.
    const float* sLse = sStat + (p & 1) * 2 * BM;
    const float* sDelta = sLse + BM;
    const int q0 = (i0 + p % nqi) * BM;
    const bool inside = q0 + BM <= Sq && k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = tx + c * GX;
      const float lse_c = sLse[n], delta_c = sDelta[n];
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int m = ty + a * GY;
        float pv = expf(s[a][c] - lse_c);
        if (!inside && (q0 + n >= Sq || k0 + m >= Sk || (causal && k0 + m > q0 + n))) pv = 0.f;
        sP[m * LDP + n] = rounded<T>(pv);
        sDS[m * LDP + n] = rounded<T>(pv * (dp[a][c] - delta_c));
      }
    }
    __syncthreads();
    const float* sDO = sm + (u + ST - 1) % ST * STAGE + BN * LD;  // unit u - 1: [V_c | dO_c]
    acc_rows<TMO, TCO, BM, LDP, LD, QY, 4 * QX, L::U>(dV, sP + oy * LDP, sDO + 4 * ox);
    acc_rows<TMO, TCO, BM, LDP, LD, QY, 4 * QX, L::U>(dK, sDS + oy * LDP, st + BN * LD + 4 * ox);
  }

  T* gk = dk + koff + c0;
  T* gv = dv + koff + c0;
#pragma unroll
  for (int i = 0; i < TMO; ++i) {
    const int r = oy + i * QY;
    if (r >= nk_valid) continue;
#pragma unroll
    for (int c = 0; c < TCO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * ox + 4 * QX * c + e;
        if (col >= dc) continue;
        gk[(long)r * kstride + col] = from_f<T>(dK[i][4 * c + e]);
        gv[(long)r * kstride + col] = from_f<T>(dV[i][4 * c + e]);
      }
  }
}

template <typename T>
cudaError_t launch_dkv_split(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                             int Hkv, int Sq, int Sk, int d, float scale, int causal,
                             cudaStream_t st) {
  using L = DkvSplit;
  auto kern = flash_bwd_dkv_split_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sk, L::BN) * Hkv * B * nchunks(d);
  kern<<<grid, L::NTH, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), B, H, Hkv, Sq, Sk, d, scale, causal);
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
// (width 16, 32, 64, 128 or 256); d <= width is the true head_dim; 2 = FMA
// split (width 256, every d > width in chunks of it). dtype: 0 =
// bf16, 1 = f32 (q, k, v, do, dk, dv). Returns a cudaError_t.
extern "C" int tt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int H, int Hkv, int Sq, int Sk, int d, int width, int family,
                                int dtype, float scale, int causal, void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || (family == 2 ? d <= width : d > width)) return (int)cudaErrorInvalidValue;
#define TT_SPLIT(T) return (int)launch_dkv_split<T>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_WG(W, FULL)                                                                  \
  return (int)launch_dkv_wgmma<W, FULL>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, d, \
                                        scale, causal, st)
#define TT_FMA(T, W) \
  return (int)launch_dkv<T, W>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_FMA_W(T)           \
  switch (width) {            \
    case 16: TT_FMA(T, 16);   \
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
  } else if (family == 2 && width == SPLIT) {
    switch (dtype) {
      case 0: TT_SPLIT(bf16);
      case 1: TT_SPLIT(float);
    }
  }
#undef TT_WG
#undef TT_SPLIT
#undef TT_FMA
#undef TT_FMA_W
  return (int)cudaErrorInvalidValue;
}
