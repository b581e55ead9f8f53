// Flash-attention backward, dq: dq = sum over k tiles of ds . (k * scale),
// with p = exp(s - lse), dp = do . v^T and ds = p * (dp - delta).
//
// Replaces: tony_tpu/ops/attention.py:258, _bwd_impl -> _bwd_dq_kernel
// (Pallas).
//
// Bound on the H100: operations. Three products of D-deep dots per unmasked
// score (s, dp, dq), 6 . D FLOP each, on the bf16 tensor cores at 989
// TFLOP/s (f32: on the CUDA cores at 67); the bytes are two orders of
// magnitude below that at S = 2048.
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
// Head dims: the wgmma kernel is compiled at tile widths D = 64, 128 and
// 256 and takes the true head_dim d (a multiple of 8, d <= D) at run time;
// the tensor maps read columns d..D-1 as zeros (a box wholly past d too),
// which leave every product over the head dim unchanged and give zero
// columns in the products onto it, and the epilogue stores columns < d only.
//
// Width 256 (flash_bwd_dq_wgmma256_kernel, Gemma's heads). One warpgroup
// cannot hold dQ (64 x 256 f32 is 128 registers a thread) beside S, dP and
// dS, and the Q, dO and two K | V stages take 192 KB: one block per SM. So
// two consumer warpgroups share the block's 64 query rows and its K / V
// stream, each on 32 of every tile's 64 keys: it scales its own K rows in
// place (its own named barrier, so the two never wait for each other
// within a tile), forms S and dP on its keys (m64n32), P and dS in
// registers, and adds dS . Ks over those keys into a whole-width partial
// dQ (m64n256 with dS as the register A operand). After the loop the
// partials are summed in a fixed order through shared memory, each
// warpgroup storing one 128-column half: 212 registers, 0 spills. Measured
// in one-call A/Bs at B4 S2048 H16/16 d = 256 bf16 causal on an H100 SXM
// 80 GB at 700 W (medians of 20, four turns; SDPA's backward 1.096-1.107
// ms): this design 0.584-0.593 ms (2.8x its bound); the next tile's load
// issued after S instead of before it, so that dQ of tile j runs under the
// scores of tile j + 1, 0.695-0.701 (the two-stage ring then exposes the
// load); dS through shared memory and a 128-column half of dQ in each
// warpgroup (64 registers fewer, a block barrier per tile) 0.629-0.640;
// 128 query rows per block (each warpgroup its own 64 rows and whole dQ)
// over a three-stage ring of 32-key tiles, which halves the K / V bytes
// streamed but needs a block barrier after each tile's scaling, 0.646-0.654;
// the loads and barriers alone (no products) 0.654-0.660, no less than
// the whole kernel. With half the bytes streamed no faster either, what
// holds it at 2.8x is not settled: no instruction-level profiler runs on
// that machine.
//
// FMA family (flash_bwd_dq_kernel<T, W>), for f32 at every head_dim and
// bf16 where the wgmma kernel does not go (d not a multiple of 8), at tile
// widths W = 16, 32, 64, 128 and 256 with the true d at run time; wgmma
// takes no f32 input, so f32 stays exact: fmaf on the CUDA cores, no TF32,
// bound at the f32 peak of 67 TFLOP/s. Same numerics as above (k scaled in
// T in place, p = expf(s - lse), dS rounded to T, f32 sums, no atomics).
// Tiles are f32 in shared memory (bf16 widened on the way in), row stride
// W + 4. Per block (DqFma): BM query rows, their Q, dO, lse and delta
// loaded once; K and V stream through a two-stage cp.async ring (16-byte
// copies where a row is whole 16-byte vectors, 4-byte ones else, zero-fill
// past Sk; bf16 copies synchronously), the next tile in flight while this
// one's products run. Each thread scales the K elements it copied itself
// once they land, so the scaling needs no barrier of its own: two block
// barriers a tile. S and dP are register micro-tiles (4 x 4 cells at
// width 16-64, 4 x 2 at 128, 2 x 2 at 256), each float4 of an operand
// read from shared memory once for 4-16 FMAs; P and dS are formed in
// registers by the thread that computed them, and dS goes through shared
// memory once as the A operand of dQ += dS . Ks. dQ stays in registers (4
// x 4 or 4 x 8 cells; at width 16 and 32 over 4 and 2 splits of a tile's
// keys, summed once at the end in a fixed order) and is stored once.
//   width   BM x BN   threads  f32 regs  shared KiB  blocks an SM
//    16     64 x 64     256       128        47.5        2
//    32     64 x 64     256       128        71.5        2
//    64     64 x 32     128       168        77.5        2
//   128     64 x 32     256       180       141.5        1
//   256     32 x 32     256       128       199.75       1
// (bf16, under no block count: 144-168 registers; no spills.)
// Measured at B4 S2048 causal f32 (H8/4, Gemma-7B's H16/16 at 256) on an
// NVIDIA H100 80GB HBM3 at 700 W, medians of 20 CUDA-event timings, in
// one-call A/Bs (SDPA's f32 backward, all three gradients, beside it):
// d = 16 0.2545 ms (2.6x its bound 0.0962; SDPA 2.135), d = 64 0.914 (2.4x;
// 2.874), d = 128 1.958 (2.5x; 4.189), d = 256 10.04-10.49 (3.3x; 10.88);
// the kernel it replaced (one element a thread over shared memory, 32-row
// tiles, synchronous loads, width 32 at d = 16) took 1.69307 at d = 16.
// Variants timed: loops over the head dim unrolled 4 steps instead of all
// 2.19 at d = 128 (unrolled 2: 2.33); one block of 256 threads an SM (no
// 128-register bound) 0.330 at d = 16; __expf instead of expf 0.2475 at d
// = 16, not kept (the reference's exp); at width 128 32 x 32 tiles of 128
// threads 2.107; at width 256 128 threads with 4 x 2 S cells and 4 x 16 dQ
// cells 10.62; at width 64 64 x 64 tiles of 256 threads 0.907, within noise.
// What still holds it from the bound (no profiler runs on that machine, so
// from the instruction mix): at d = 16 each score costs 48 FMAs and about
// ten more instructions (expf, the mask, dS, its store), besides a float4
// shared load per 4-16 FMAs and two barriers a tile; at width 256 the 2 x
// 2 S cells read a float4 per 4 FMAs, as much shared memory as the SM
// serves, since 32 x 32 tiles are all that fit beside Q, dO and the ring.
//
// Left for later: a fused backward (s and dp are recomputed here and in the
// dk/dv kernel; fusing them with an atomic dq would give up determinism, a
// deterministic fusion needs a second pass), a producer warp with
// setmaxnreg and two consumer warpgroups, a persistent grid. Measured and
// dropped: two consumer warpgroups per block sharing one K/V stream, each
// skipping the k tiles past its rows with a branch around its products,
// ran slower than this one-warpgroup block (the products under a branch).
//
// Split family past width 256 (flash_bwd_dq_split_kernel<T>, DqSplit), for
// every head_dim d > 256 in bf16 and f32. DqFma<256> keeps Q and dO (32
// rows) resident beside a two-stage K | V ring in 200 KiB; at 512 neither
// fits. The head dim goes in nc = ceil(d / 256) chunks of the 256-wide f32
// tiles, and each block owns the dQ columns of one chunk c of 64 query rows
// (64 x 32 tiles of 256 threads: S and dP 4 x 2 cells, dQ_c 4 x 16 cells, 64
// registers). Per k tile a two-stage cp.async ring carries, for each chunk x
// in the order c + 1, ..., nc - 1, 0, ..., c, a unit [dO_x | V_x] and a unit
// [Q_x | Ks_x] (204.5 KiB in all): S and dP sum over the chunks, and the
// tile's last unit holds Ks_c, which dQ_c += dS . Ks_c reads where it
// landed. Each block sums the chunks in its own fixed order (no block shares
// S with another: lse is an input), so the result is deterministic. Q and dO
// are re-read every k tile; S and dP are computed nc times (1.67x dq's FLOPs
// at d = 512). 248 registers (f32), 254 (bf16), 0 spills. Measured at B4
// S2048 causal H8/8 on an NVIDIA H100 80GB HBM3 at 700 W (medians of 20,
// one call, turns A B B A): f32 d = 512 14.96-15.07 ms (4.9x its bound
// without the recomputation, 3.08); bf16 15.35-15.46 with 16-byte loads,
// 36.85-36.86 widened element by element.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace tt {

// ----------------------------------------------------------- FMA path
// Tiles of one block, per width W: BM query rows, BN keys a K / V tile,
// NTH threads. S and dP are TM x TN cells a thread (queries GY apart, keys
// GX apart); dQ is TMO x 4 TCO cells a thread (rows QY apart, float4
// columns 4 QX apart), over KS splits of a tile's keys whose partial dQs
// are summed once at the end. Shared memory (f32, row stride W + 4): Q,
// dO, two stages of [K | V], dS [BM, BN + 4], lse and delta.
// MINB f32 blocks an SM (bf16: 1) bound the registers (2 x 256 threads:
// 128 a thread); U float4 steps of a product are unrolled (0: all).
template <int W> struct DqFma;
template <> struct DqFma<16> { static constexpr int BM = 64, BN = 64, NTH = 256, TM = 4, TN = 4, TMO = 4, TCO = 1, KS = 4, MINB = 2, U = 0; };
template <> struct DqFma<32> { static constexpr int BM = 64, BN = 64, NTH = 256, TM = 4, TN = 4, TMO = 4, TCO = 1, KS = 2, MINB = 2, U = 0; };
template <> struct DqFma<64> { static constexpr int BM = 64, BN = 32, NTH = 128, TM = 4, TN = 4, TMO = 4, TCO = 2, KS = 1, MINB = 2, U = 0; };
template <> struct DqFma<128> { static constexpr int BM = 64, BN = 32, NTH = 256, TM = 4, TN = 2, TMO = 4, TCO = 2, KS = 1, MINB = 1, U = 0; };
template <> struct DqFma<256> { static constexpr int BM = 32, BN = 32, NTH = 256, TM = 2, TN = 2, TMO = 4, TCO = 2, KS = 1, MINB = 2, U = 4; };

template <int W>
struct DqLay : DqFma<W> {
  using C = DqFma<W>;
  static constexpr int LD = ldw<W>(), LDS = C::BN + 4;
  static constexpr int GX = C::BN / C::TN, GY = C::BM / C::TM;   // score cells
  static constexpr int QX = W / 4 / C::TCO, QY = C::BM / C::TMO;  // dQ cells of one key split
  static constexpr int TILES = 2 * C::BM * LD + 4 * C::BN * LD;  // Q, dO, the ring
  static constexpr size_t bytes = sizeof(float) * (size_t)(TILES + C::BM * LDS + 2 * C::BM);
  static_assert(GX * GY == C::NTH && QX * QY * C::KS == C::NTH, "one cell of each a thread");
  static_assert(C::KS * C::BM * W <= TILES, "the dQ partials fit where the tiles were");
};

template <typename T, int W>
__global__ void __launch_bounds__(DqFma<W>::NTH, std::is_same<T, float>::value ? DqFma<W>::MINB : 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int B, int H, int Hkv,
                        int Sq, int Sk, int d, float scale, int causal) {
  using L = DqLay<W>;
  constexpr int BM = L::BM, BN = L::BN, NTH = L::NTH, TM = L::TM, TN = L::TN, TMO = L::TMO,
                TCO = L::TCO, KS = L::KS, LD = L::LD, LDS = L::LDS, GX = L::GX, GY = L::GY,
                QX = L::QX, QY = L::QY, KSPAN = BN / KS;
  constexpr int US = L::U ? L::U : W / 4, UA = L::U && L::U < KSPAN / 4 ? L::U : KSPAN / 4;

  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sDO = sQ + BM * LD;
  float* sRing = sDO + BM * LD;  // stage s: K at sRing + 2 s BN LD, V after it
  float* sDS = sm + L::TILES;
  float* sLse = sDS + BM * LDS;  // lse and delta of the block's rows
  float* sDelta = sLse + BM;

  // Block -> (q tile, head, batch), q tile slowest and last q tile first:
  // under the causal mask the heaviest tiles start first.
  const int tid = threadIdx.x;
  const int per = H * B, nq = (Sq + BM - 1) / BM;
  const int tile = blockIdx.x / per, h = blockIdx.x % per % H, b = blockIdx.x % per / H;
  const int qi = causal ? nq - 1 - tile : tile;
  const int hk = h / (H / Hkv);
  const int q0 = qi * BM, nq_valid = min(BM, Sq - q0);
  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + BM - 1) / BN + 1);
  const long qstride = (long)H * d, kstride = (long)Hkv * d;
  const long qoff = ((long)b * Sq + q0) * qstride + (long)h * d;
  const T* kb = k + (long)b * Sk * kstride + (long)hk * d;
  const T* vb = v + (long)b * Sk * kstride + (long)hk * d;
  const float scale_t = to_f(from_f<T>(scale));

  zero_tail<W, NTH>(sm, 2 * BM + 4 * BN, d);
  copy_tile<T, BM, W, NTH>(sQ, q + qoff, qstride, nq_valid, d, false, 1.f);
  copy_tile<T, BM, W, NTH>(sDO, dout + qoff, qstride, nq_valid, d, false, 1.f);
  const long soff = ((long)b * H + h) * Sq + q0;
  copy_stat<BM, NTH>(sLse, lse + soff, nq_valid);
  copy_stat<BM, NTH>(sDelta, delta + soff, nq_valid);
  auto issue = [&](int j) {  // K and V of tile j into stage j % 2, one commit group
    float* st = sRing + (j & 1) * 2 * BN * LD;
    const int k0 = j * BN, n = min(BN, Sk - k0);
    copy_tile<T, BN, W, NTH>(st, kb + (long)k0 * kstride, kstride, n, d, true, scale_t);
    copy_tile<T, BN, W, NTH>(st + BN * LD, vb + (long)k0 * kstride, kstride, n, d, false, 1.f);
    cp_commit();
  };
  issue(0);

  // This thread's score cells (queries ty + i GY, keys tx + j GX) and its
  // dQ cells (rows oy + i QY, columns 4 (ox + c QX)) over keys ks KSPAN ...
  // of each tile.
  const int tx = Cells<GX, GY>::x(tid), ty = Cells<GX, GY>::y(tid);
  const int ks = tid / (NTH / KS), u = tid % (NTH / KS);
  const int ox = Cells<QX, QY>::x(u), oy = Cells<QX, QY>::y(u);
  float acc[TMO][4 * TCO];
#pragma unroll
  for (int i = 0; i < TMO; ++i)
#pragma unroll
    for (int c = 0; c < 4 * TCO; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < nk; ++j) {
    float* sK = sRing + (j & 1) * 2 * BN * LD;
    const float* sV = sK + BN * LD;
    const int k0 = j * BN;
    cp_wait_all();
    scale_own<T, BN, W, NTH>(sK, d, scale_t);  // Ks = k * scale, in place (f32)
    __syncthreads();  // tile j visible; every thread done with tile j - 1 and dS
    if (j + 1 < nk) issue(j + 1);

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[i][c] = dp[i][c] = 0.f;
    dot_rows<TM, TN, W, LD, GY, GX, US>(s, sQ + ty * LD, sK + tx * LD);    // S = Q . Ks^T
    dot_rows<TM, TN, W, LD, GY, GX, US>(dp, sDO + ty * LD, sV + tx * LD);  // dP = dO . V^T

    // P = exp(S - lse), 0 where masked; dS = P * (dP - delta), rounded to
    // T as the A operand of dQ += dS . Ks. Tiles wholly below the diagonal
    // and inside both sequences skip the mask.
    const bool inside = q0 + BM <= Sq && k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * GY;
      const float lse_m = sLse[m], delta_m = sDelta[m];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int n = tx + c * GX;
        float p = expf(s[i][c] - lse_m);
        if (!inside && (q0 + m >= Sq || k0 + n >= Sk || (causal && k0 + n > q0 + m))) p = 0.f;
        sDS[m * LDS + n] = rounded<T>(p * (dp[i][c] - delta_m));
      }
    }
    __syncthreads();
    acc_rows<TMO, TCO, KSPAN, LDS, LD, QY, 4 * QX, UA>(acc, sDS + oy * LDS + ks * KSPAN,
                                                  sK + ks * KSPAN * LD + 4 * ox);
  }

  // dQ = the sum of the KS partials, in a fixed order, through shared memory.
  __syncthreads();
  put_cells<TMO, TCO, W, QY, 4 * QX>(sm + (ks * BM + oy) * W + 4 * ox, acc);
  __syncthreads();
  T* g = dq + qoff;
  for (int e = tid; e < BM * W; e += NTH) {
    const int r = e / W, c = e % W;
    if (r >= nq_valid || c >= d) continue;
    float x = sm[e];
#pragma unroll
    for (int p = 1; p < KS; ++p) x += sm[p * BM * W + e];
    g[(long)r * qstride + c] = from_f<T>(x);
  }
}

template <typename T, int W>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int Hkv, int Sq,
                      int Sk, int d, float scale, int causal, cudaStream_t st) {
  using L = DqLay<W>;
  auto kern = flash_bwd_dq_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B;
  kern<<<grid, L::NTH, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), B, H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------ FMA path past width 256
// The head dim in chunks (flash_common.cuh, SPLIT); each block owns the
// dQ columns of one chunk c of BM query rows. S and dP are TM x TN cells a
// thread (queries GY apart, keys GX apart), dQ_c TMO x 4 TCO cells (rows QY
// apart, float4 columns 4 QX apart). Shared memory (f32, row stride SPLIT
// + 4): two ring stages of BM + BN rows, each holding one unit, then dS
// [BM, BN + 4], lse and delta. Per k tile the ring carries, for each chunk
// x in the order c + 1, ..., nc - 1, 0, ..., c, a unit [dO_x | V_x] and a
// unit [Q_x | Ks_x]: the tile's last unit holds Ks_c, which dQ_c += dS . Ks_c
// reads from it.
struct DqSplit {
  static constexpr int BM = 64, BN = 32, NTH = 256, TM = 4, TN = 2, TMO = 4, TCO = 4, U = 4;
  static constexpr int LD = ldw<SPLIT>(), LDS = BN + 4;
  static constexpr int GX = BN / TN, GY = BM / TM;          // score cells
  static constexpr int QX = SPLIT / 4 / TCO, QY = BM / TMO;  // dQ cells
  static constexpr int STAGE = (BM + BN) * LD;
  static constexpr size_t bytes = sizeof(float) * (size_t)(2 * STAGE + BM * LDS + 2 * BM);
  static_assert(GX * GY == NTH && QX * QY == NTH, "one cell of each a thread");
};

template <typename T>
__global__ void __launch_bounds__(DqSplit::NTH, 1)
    flash_bwd_dq_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sk, int d,
                              float scale, int causal) {
  using L = DqSplit;
  constexpr int BM = L::BM, BN = L::BN, NTH = L::NTH, TM = L::TM, TN = L::TN, TMO = L::TMO,
                TCO = L::TCO, LD = L::LD, LDS = L::LDS, GX = L::GX, GY = L::GY, QX = L::QX,
                QY = L::QY, STAGE = L::STAGE;

  extern __shared__ __align__(16) float sm[];
  float* sDS = sm + 2 * STAGE;
  float* sLse = sDS + BM * LDS;  // lse and delta of the block's rows
  float* sDelta = sLse + BM;

  // Block -> (chunk, q tile, head, batch): the chunk fastest, q tile
  // slowest and last q tile first, as in flash_bwd_dq_kernel.
  const int tid = threadIdx.x;
  const int nc = nchunks(d), ch = blockIdx.x % nc, bx = blockIdx.x / nc;
  const int per = H * B, nq = (Sq + BM - 1) / BM;
  const int tile = bx / per, h = bx % per % H, b = bx % per / H;
  const int qi = causal ? nq - 1 - tile : tile;
  const int hk = h / (H / Hkv);
  const int q0 = qi * BM, nq_valid = min(BM, Sq - q0);
  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + BM - 1) / BN + 1);
  const long qstride = (long)H * d, kstride = (long)Hkv * d;
  const long qoff = ((long)b * Sq + q0) * qstride + (long)h * d;
  const T* kb = k + (long)b * Sk * kstride + (long)hk * d;
  const T* vb = v + (long)b * Sk * kstride + (long)hk * d;
  const float scale_t = to_f(from_f<T>(scale));
  const bool vec = d % (16 / (int)sizeof(T)) == 0;  // rows of whole 16-byte vectors
  const int c0 = ch * SPLIT, dc = chunk_cols(d, ch);
  const int per_tile = 2 * nc, nu = nk * per_tile;

  const long soff = ((long)b * H + h) * Sq + q0;
  copy_stat<BM, NTH>(sLse, lse + soff, nq_valid);
  copy_stat<BM, NTH>(sDelta, delta + soff, nq_valid);
  // Unit u: k tile u / per_tile; chunk (c + 1 + i) % nc with i = u % per_tile / 2;
  // [dO | V] when u is even, [Q | Ks] when odd.
  auto issue = [&](int u) {  // unit u into stage u % 2, one commit group
    float* st = sm + (u & 1) * STAGE;
    const int j = u / per_tile, i = u % per_tile, x = (ch + 1 + i / 2) % nc;
    const int k0 = j * BN, n = min(BN, Sk - k0), x0 = x * SPLIT, dx = chunk_cols(d, x);
    const bool kq = i & 1;
    copy_chunk<T, BM, NTH>(st, (kq ? q : dout) + qoff + x0, qstride, nq_valid, dx, vec, false, 1.f);
    copy_chunk<T, BN, NTH>(st + BM * LD, (kq ? kb : vb) + (long)k0 * kstride + x0, kstride, n, dx,
                           vec, kq, scale_t);
    cp_commit();
  };
  issue(0);

  const int tx = Cells<GX, GY>::x(tid), ty = Cells<GX, GY>::y(tid);
  const int ox = Cells<QX, QY>::x(tid), oy = Cells<QX, QY>::y(tid);
  float acc[TMO][4 * TCO], s[TM][TN], dp[TM][TN];
#pragma unroll
  for (int i = 0; i < TMO; ++i)
#pragma unroll
    for (int c = 0; c < 4 * TCO; ++c) acc[i][c] = 0.f;

  for (int u = 0; u < nu; ++u) {
    float* st = sm + (u & 1) * STAGE;
    const int j = u / per_tile, i = u % per_tile;
    cp_wait_all();
    if constexpr (std::is_same<T, float>::value)
      if (i & 1) scale_chunk<BN, NTH>(st + BM * LD, vec, scale_t);  // Ks = k * scale, in place (f32)
    __syncthreads();  // unit u visible; every thread done with unit u - 1 and dS
    if (u + 1 < nu) issue(u + 1);

    if (i == 0) {
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) s[a][c] = dp[a][c] = 0.f;
    }
    if (i & 1)
      dot_rows<TM, TN, SPLIT, LD, GY, GX, L::U>(s, st + ty * LD, st + (BM + tx) * LD);  // S += Q_x . Ks_x^T
    else
      dot_rows<TM, TN, SPLIT, LD, GY, GX, L::U>(dp, st + ty * LD, st + (BM + tx) * LD);  // dP += dO_x . V_x^T
    if (i + 1 < per_tile) continue;

    // P = exp(S - lse), 0 where masked; dS = P * (dP - delta), rounded to
    // T as the A operand of dQ_c += dS . Ks_c (Ks_c is this unit's).
    const int k0 = j * BN;
    const bool inside = q0 + BM <= Sq && k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0);
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int m = ty + a * GY;
      const float lse_m = sLse[m], delta_m = sDelta[m];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int n = tx + c * GX;
        float p = expf(s[a][c] - lse_m);
        if (!inside && (q0 + m >= Sq || k0 + n >= Sk || (causal && k0 + n > q0 + m))) p = 0.f;
        sDS[m * LDS + n] = rounded<T>(p * (dp[a][c] - delta_m));
      }
    }
    __syncthreads();
    acc_rows<TMO, TCO, BN, LDS, LD, QY, 4 * QX, L::U>(acc, sDS + oy * LDS, st + BM * LD + 4 * ox);
  }

  T* g = dq + qoff + c0;
#pragma unroll
  for (int i = 0; i < TMO; ++i) {
    const int r = oy + i * QY;
    if (r >= nq_valid) continue;
#pragma unroll
    for (int c = 0; c < TCO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * ox + 4 * QX * c + e;
        if (col < dc) g[(long)r * qstride + col] = from_f<T>(acc[i][4 * c + e]);
      }
  }
}

template <typename T>
cudaError_t launch_dq_split(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                            int Sq, int Sk, int d, float scale, int causal, cudaStream_t st) {
  using L = DqSplit;
  auto kern = flash_bwd_dq_split_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B * nchunks(d);
  kern<<<grid, L::NTH, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), B, H, Hkv, Sq, Sk, d, scale, causal);
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

// D is the tile width (64 or 128) and d <= D the true head_dim, a multiple
// of 8: the tensor maps read columns d..D-1 as zeros and dq is stored for
// columns < d only. FULL (d == D): the strides and the epilogue take the
// constant D, so that the column bound costs the exact width nothing.
template <int D, bool FULL>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mdo,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sk,
                              int d, float scale, int causal) {
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

  const int hd = FULL ? D : d;
  const long qstride = (long)H * hd;
  store_acc<D>(dQ, dq + ((long)b * Sq + q0) * qstride + (long)h * hd, qstride, Sq - q0, hd, tid);
}

// ------------------------------------------------ bf16 path, width 256 (wgmma)
// Two consumer warpgroups over one block's 64 query rows, each owning 32 of
// every K / V tile's 64 keys: warpgroup w scales its K rows in place (a
// barrier of its own 128 threads), forms S and dP on its keys (m64n32),
// P and dS in registers, and adds dS . Ks over its keys into a whole-width
// partial dQ (64 x 256 f32, m64n256, 128 registers a thread). The two
// partials are summed once, through shared memory, after the loop. The
// same shared memory as DqHop<256>: Q, dO and two K | V ring stages.
template <bool FULL>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 const __grid_constant__ CUtensorMap mdo,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sk,
                                 int d, float scale, int causal) {
  using namespace hop;
  constexpr int D = 256, KD = D / 16, BOXE = 64 * BOX;  // bf16 elements of one 64-column box
  using L = DqHop<D>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* qbar = empty + L::STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
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
      mbar_init(&empty[s], 256);
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
  const int w = wt >> 5, l = tid & 31;
  const int row0 = q0 + 16 * w + (l >> 2);  // this thread's query rows: row0, row0 + 8
  const int kw = 32 * wg;                   // this warpgroup's first key of a tile
  const int ck = 2 * (l & 3);               // and its key columns kw + 8j + ck + {0, 1}
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
    // Ks = k * scale in bf16, in place, on this warpgroup's 32 rows of each box.
#pragma unroll
    for (int c = 0; c < D / BOX; ++c) scale_tile<32 * BOX, 128>(sK + c * BOXE + kw * BOX, scale_t, wt);
    fence_proxy_async();
    named_sync(1 + wg, 128);

    float s[16], dp[16];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)  // S = Q . Ks^T on this warpgroup's keys
      Wg<32>::ss(s, desc_k<64>(sQ, kk), desc_k<64>(sK + kw * BOX, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)  // dP = dO . V^T
      Wg<32>::ss(dp, desc_k<64>(sDO, kk), desc_k<64>(sV + kw * BOX, kk), kk > 0);
    wg_commit();
    wg_wait<1>();
    pin(s);

    // P = exp(S - lse), 0 where masked; tiles wholly below the diagonal and
    // inside both sequences skip the mask.
    const bool inside = q0 + L::BM <= Sq && k0 + L::BN <= Sk && (!causal || k0 < q0);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int i = (x >> 1) & 1;
      const int row = row0 + 8 * i, key = k0 + kw + 8 * (x >> 2) + ck + (x & 1);
      float p = expf(s[x] - lse_r[i]);
      if (!inside && (row >= Sq || key >= Sk || (causal && key > row))) p = 0.f;
      s[x] = p;
    }
    wg_wait<0>();
    pin(dp);
    // dS = P * (dP - delta), rounded to bf16 as the A operand of dQ += dS . Ks.
#pragma unroll
    for (int x = 0; x < 16; ++x) dp[x] = s[x] * (dp[x] - delta_r[(x >> 1) & 1]);
    uint32_t dsa[2][4];
    acc_to_a<2>(dp, dsa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wg<D>::rs(dQ, dsa[kk], desc_mn<64>(sK, 2 * wg + kk));
    wg_commit();
    wg_wait<0>();
    pin(dQ);
    pin(dsa);
    mbar_arrive(&empty[j % L::STAGES]);
  }

  // dQ = the two partials: warpgroup w keeps columns 128w..128w+127 and
  // hands the other half to its partner through the Q | dO area (two
  // 64 x 128 f32 halves, 64 KB), each word at [register][thread].
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* give = red + (1 - wg) * 64 * 128;
  const float* take = red + wg * 64 * 128;
  const int hd = FULL ? D : d;
  const long qstride = (long)H * hd;
  bf16* g = dq + ((long)b * Sq + q0) * qstride + (long)h * hd;
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < 64; ++x) give[x * 128 + wt] = dQ[64 + x];
  } else {
#pragma unroll
    for (int x = 0; x < 64; ++x) give[x * 128 + wt] = dQ[x];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < 64; ++x) dQ[x] += take[x * 128 + wt];
    store_acc<128>(reinterpret_cast<const float(&)[64]>(dQ[0]), g, qstride, Sq - q0, hd, wt);
  } else {
#pragma unroll
    for (int x = 0; x < 64; ++x) dQ[64 + x] += take[x * 128 + wt];
    store_acc<128>(reinterpret_cast<const float(&)[64]>(dQ[64]), g + 128, qstride, Sq - q0,
                   hd - 128, wt);
  }
}

template <int D, bool FULL>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                            int Sq, int Sk, int d, float scale, int causal, cudaStream_t st) {
  using L = DqHop<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::map_bshd(&mq, q, B, Sq, H, d, 64) || !hop::map_bshd(&mdo, dout, B, Sq, H, d, 64) ||
      !hop::map_bshd(&mk, k, B, Sk, Hkv, d, 64) || !hop::map_bshd(&mv, v, B, Sk, Hkv, d, 64))
    return cudaErrorInvalidValue;
  // The width-256 kernel takes the same arguments with two warpgroups.
  auto kern = flash_bwd_dq_wgmma256_kernel<FULL>;
  if constexpr (D != 256) kern = flash_bwd_dq_wgmma_kernel<D, FULL>;
  const int threads = D == 256 ? 256 : 128;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B;
  kern<<<grid, threads, L::bytes, st>>>(mq, mk, mv, mdo, static_cast<const float*>(lse),
                                        static_cast<const float*>(delta), static_cast<bf16*>(dq),
                                        B, H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace tt

// family: 0 = wgmma (bf16, width 64, 128 or 256, d a multiple of 8), 1 = FMA
// (width 16, 32, 64, 128 or 256); d <= width is the true head_dim; 2 = FMA
// split (width 256, every d > width in chunks of it). dtype: 0 =
// bf16, 1 = f32 (q, k, v, do, dq). Returns a cudaError_t.
extern "C" int tt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                               int Sq, int Sk, int d, int width, int family, int dtype, float scale,
                               int causal, void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || (family == 2 ? d <= width : d > width)) return (int)cudaErrorInvalidValue;
#define TT_SPLIT(T) return (int)launch_dq_split<T>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_WG(W, FULL) \
  return (int)launch_dq_wgmma<W, FULL>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_FMA(T, W) \
  return (int)launch_dq<T, W>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, d, scale, causal, st)
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
