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
// 128-key tiles (80 at width 256, see below); 160 KB of shared memory at
// D = 128 (Q 32 KB, two ring stages each of K and V at 32 KB a tile), one
// block per SM. Blocks run q tile slowest, last q tile first: under the
// causal mask the heaviest start first. The block loads its Q tile once by TMA (a 4-d map, so rows
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
// Head dims. The wgmma kernel is compiled at tile widths D = 64, 128 and
// 256 and takes the true head_dim d (a multiple of 8, d <= D) at run time:
// its tensor maps read columns d..D-1 as zeros (a box wholly past d too),
// which add nothing to Qs . K^T and give zero columns of O, and its
// epilogue stores columns < d. The row-sum rule is the true d's: d = 96 on
// the 128-wide tile sums the rounded P, d = 136-248 on the 256-wide tile
// the f32 P. Each width has an exact-width instantiation (d == D) whose
// strides and epilogue are compile-time, and one for narrower heads. At
// d = 16 the 64-wide tile does four times the products the head needs.
//
// Width 256 (Gemma's heads). The same kernel over 80-key tiles: O (64 x
// 256 f32) is 128 registers a thread, S 40 and the P operand 20; 214
// registers a thread, no spill; Q (64 KB) and two ring stages each of K and
// V (40 KB a tile) take 225 KB of shared memory. S_{j+1} (m64n80) is issued
// with O += P_j . V_j (m64n256, V MN-major) as at D = 128; the last key tile
// is ragged (2048 = 25 x 80 + 48) and masked. Measured in one call at B4
// S2048 H16/16 d = 256 bf16 causal on an H100 80GB HBM3 at 700 W (medians
// of 20, four turns; SDPA's forward 0.2561-0.2565 ms; the variant builds
// carried a watchdog in mbar_wait that cost ~3 %, the committed 64-key
// build without it took 0.3325-0.3336): 64-key tiles (202 registers)
// 0.3418-0.3437 ms; 64-key tiles without the overlap (S, then P . V; 188
// registers) 0.3557-0.3590; a producer warpgroup with setmaxnreg 24 / 240
// over 64-key tiles, which ptxas held at 168 registers with 428-436 bytes
// of spill, 0.6777-0.6785; 80-key tiles (this design) 0.3369-0.3392;
// 80-key tiles without the overlap 0.3476-0.3512. Each was held to the
// plain forward over its own key tiles and was bitwise deterministic. The
// 80-key tile's m64n80 score product reads less shared memory per FLOP
// than m64n64 (4.5 KB per 40 cycles of tensor core, not 4 KB per 32).
//
// FMA family (flash_fwd_kernel<T, OT, W>), for f32 at every head_dim and
// bf16 where the wgmma kernel does not go (d not a multiple of 8), at tile
// widths W = 16, 32, 64, 128 and 256 with the true d at run time; wgmma
// takes no f32 input, so f32 stays exact: fmaf on the CUDA cores, no TF32,
// bound at the f32 peak of 67 TFLOP/s. Same numerics as above but for the
// exponent, expf as the plain version's exp: q scaled in T, S in f32,
// NEG_INF masks, P rounded to T for P . V, l summing that rounded P below
// head_dim 128, the 1e-30 clamp; no atomics. Tiles are f32 in shared
// memory (bf16 widened on the way in), row stride W + 4. Per block
// (FwdFma): BM query rows, whose Q is copied once and scaled in place by
// the thread that copied it; K and V stream through a two-stage cp.async
// ring of 32-key tiles (16-byte copies where a row is whole 16-byte
// vectors, 4-byte ones else; bf16 by widen_tile), the next tile in flight
// while this one's products run: two block barriers a tile. S = Qs . K^T
// is a register micro-tile (TM x TN cells; a row's 32 keys on GX = 4 or 8
// lanes of one warp). The thread that holds a row's scores masks them,
// takes the row max by shuffles over those lanes, forms alpha and
// P = exp(S - m) in registers, and holds the row's O cells (TM x W / GX)
// too: O is rescaled by alpha in registers, and P, rounded to T, goes
// through shared memory once as the A operand of O += P . V. l stays a
// per-lane partial, summed over the row's lanes once at the end; the
// epilogue divides O by max(l, 1e-30) in registers.
//   width   BM x BN   threads  regs f32 / bf16  shared KiB  f32 blocks an SM
//    16     64 x 32     128       128 / 144         24.0          4
//    32     64 x 32     128       128 / 168         37.0          4
//    64    128 x 32     256       128 / 196         88.0          2
//   128    128 x 32     256       254 / 254        152.0          1
//   256     64 x 32     256       194 / 255        205.0          1
// (no spills; bf16 under no block count.) Measured at B4 S2048 causal
// (H8/4, H16/16 at 256) on an NVIDIA H100 80GB HBM3 at 700 W, medians of
// 20 CUDA-event timings, by flash_variants_ab.py in one call (SDPA's f32
// forward beside it): f32 d = 16 0.2217 ms (3.5x its bound 0.0641; SDPA
// 2.275), d = 32 0.3087 (2.4x), d = 64 0.5736 (2.2x; 2.723), d = 128
// 1.1597 (2.3x; 3.509), d = 256 6.004-6.213 (2.9-3.0x; 3.644); bf16 d = 12
// 0.2645, d = 20 0.4143, d = 100 1.5980 (4.0x its f32 bound 0.4009; SDPA's
// bf16 forward 0.2438). The kernel it replaced (one element a thread over
// shared memory, 32-row tiles of 128 threads, synchronous loads, width 32
// at d = 16) took 1.347 at f32 d = 16 and 10.47 at bf16 d = 100.
// Variants in the same call, their time over this design's: width 16 on
// 128-row tiles (TM 4) 1.045 at d = 16; width 32 on 128-row tiles of 256
// threads 1.060 at d = 32 (1.098 at bf16 d = 20); 64-key tiles at width 32
// and 64 (TN 8) 1.054 at d = 32, 1.000 at d = 64; width 64 on 64-row tiles
// of 128 threads 1.066; width 128 on 64-row tiles (TM 2, two blocks an SM)
// 1.223 (1.353 at bf16 d = 100); width 256 on 128 threads (TM 4) 0.983
// in f32, but its bf16 instantiations spill 1188 bytes; width 256 unrolled
// fully 1.004 (bf16 spills); __expf 0.953 at d = 16, 0.974 at 32, 0.983 at
// 64, 0.993 at 128 and 1.014-1.031 in bf16, not kept (the plain version's
// exp); bf16 through copy_tile's element loop 1.123 at d = 12, 1.173 at 20,
// 1.316 at 100; bf16 with f32's block counts 0.860 at d = 12 and 0.868 at
// 20, but 16 bytes of spill at width 32 and 64. What still holds it from
// the bound, counted from the source (no profiler runs on that machine):
// S reads TM + TN float4 from shared memory for 4 TM TN FMAs and P . V
// TM + 4 TC for 16 TM TC: one float4 a lane for 5-6 FMAs at width 16 and
// 256, 8-13 at 32-128; at d = 16 the softmax (expf, the mask, the max, the
// sum, the P store) adds about twelve instructions a score beside 32 FMAs.
//
// Split family past width 256 (flash_fwd_split_kernel<T, OT>, FwdSplit), for
// every head_dim d > 256 in bf16 and f32. No FMA tile past 256 fits:
// FwdFma<256> already takes 205 KiB of shared memory (Q over 64 rows, two
// stages of 32-key K and V, row stride 260) and 194 / 255 registers (O is 64
// floats a thread); at 512 it would need ~396 KiB and twice the O
// registers. So the head dim goes in nc = ceil(d / 256) chunks through
// FwdFma<256>'s tiles and cells (its 32-key tile, which fwd_key_tile
// reports), and each block owns one chunk c of its 64 rows' O: the grid is
// nc times the unsplit one, the chunk fastest, so that a q tile's nc blocks
// read its Q and K from L2 at about the same time. Per key tile a two-stage
// cp.async ring carries nc units [Qs chunk x | K chunk x] and one unit
// [V chunk c] (205 KiB in all, with P). S sums over the chunks in the order
// x = 0 .. nc - 1 in every block, so a q tile's blocks compute the same S,
// m and l bit for bit and chunk 0 alone writes lse; then the online softmax
// of the unsplit kernel (l over the f32 P: d > 128) and O_c += P . V_c. Qs
// no longer fits beside the ring, so it is re-read and re-scaled every key
// tile. A narrower last chunk (d = 264, 384) is zero-filled to 256 on its
// way in (copy_chunk writes every column: a stage holds chunks of both
// widths in turn) and stored at its own width. The cost is S computed nc
// times for each row block, 1.5x the forward's FLOPs at d = 512. 186
// registers (f32), 220 (bf16), 0 spills. Measured at B4 S2048 causal H8/8
// on an NVIDIA H100 80GB HBM3 at 700 W (medians of 20 CUDA-event timings,
// one call, turns A B B A): f32 d = 512 10.85 ms (5.3x its bound without the
// recomputation, 2.05), d = 384 10.76 (the half chunk costs a whole one);
// bf16 d = 512 10.73-10.80 with 16-byte loads of 8 elements (d % 8 == 0),
// 17.01-17.11 widened element by element, the first build.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace tt {

// ----------------------------------------------------------- FMA path
// Tiles of one block, per width W: BM query rows and NTH threads over
// BN = GX TN keys a K / V tile. A row's scores lie on GX consecutive lanes
// of one warp, TN keys each (GX apart), so its max and its sum are
// shuffles over those lanes; the same thread holds that row's O cells (TM
// rows GY apart; W / GX columns, TC float4s 4 GX apart), so alpha, m and
// l never leave registers. Shared memory (f32, row stride W + 4): Q, two
// stages of [K | V], and P [BM, BN + GX] (a row stride of GX mod 32 banks:
// the P stores of a warp's rows meet no bank conflict). MINB f32 blocks an
// SM (bf16: 1) bound the registers; U float4 steps of S = Qs . K^T are
// unrolled (0: all).
template <int W> struct FwdFma;
template <> struct FwdFma<16> { static constexpr int BM = 64, NTH = 128, GX = 4, TM = 2, TN = 8, MINB = 4, U = 0; };
template <> struct FwdFma<32> { static constexpr int BM = 64, NTH = 128, GX = 8, TM = 4, TN = 4, MINB = 4, U = 0; };
template <> struct FwdFma<64> { static constexpr int BM = 128, NTH = 256, GX = 8, TM = 4, TN = 4, MINB = 2, U = 0; };
template <> struct FwdFma<128> { static constexpr int BM = 128, NTH = 256, GX = 8, TM = 4, TN = 4, MINB = 1, U = 0; };
template <> struct FwdFma<256> { static constexpr int BM = 64, NTH = 256, GX = 8, TM = 2, TN = 4, MINB = 1, U = 4; };

template <int W>
struct FwdLay : FwdFma<W> {
  using C = FwdFma<W>;
  static constexpr int LD = ldw<W>(), BN = C::GX * C::TN, LDP = BN + C::GX;
  static constexpr int GY = C::NTH / C::GX, TC = W / 4 / C::GX;
  static constexpr size_t bytes = sizeof(float) * (size_t)(C::BM * LD + 4 * BN * LD + C::BM * LDP);
  static_assert(GY * C::TM == C::BM && TC >= 1 && TC * 4 * C::GX == W, "one row's cells on GX lanes");
  static_assert(BN % 32 == 0 && LDP % 32 == C::GX, "P's rows GX banks apart");
};

// ROWS bf16 rows (row r at g + r * gstride, d elements) widened into f32
// shared rows of stride ldw<W>(), columns < d, rows at or past `nvalid` as
// zeros: each thread issues all its loads before its first store, so their
// latencies overlap.
template <int ROWS, int W, int NTH>
__device__ __forceinline__ void widen_tile(float* s, const bf16* g, long gstride, int nvalid, int d) {
  static_assert(ROWS * W % NTH == 0, "whole rounds of the block");
  constexpr int N = ROWS * W / NTH;
  float x[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = threadIdx.x + u * NTH, r = i / W, c = i % W;
    x[u] = r < nvalid && c < d ? to_f(g[r * gstride + c]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = threadIdx.x + u * NTH, r = i / W, c = i % W;
    if (c < d) s[r * ldw<W>() + c] = x[u];
  }
}

template <typename T, typename OT, int W>
__global__ void __launch_bounds__(FwdFma<W>::NTH, std::is_same<T, float>::value ? FwdFma<W>::MINB : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     OT* __restrict__ o, float* __restrict__ lse, int B, int H, int Hkv, int Sq,
                     int Sk, int d, float scale, int causal) {
  using L = FwdLay<W>;
  constexpr int BM = L::BM, BN = L::BN, NTH = L::NTH, GX = L::GX, GY = L::GY, TM = L::TM,
                TN = L::TN, TC = L::TC, LD = L::LD, LDP = L::LDP;
  constexpr int US = L::U ? L::U : W / 4;

  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sRing = sQ + BM * LD;  // stage s: K at sRing + 2 s BN LD, V after it
  float* sP = sRing + 4 * BN * LD;

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
  const float scale_t = to_f(from_f<T>(scale));  // the scale in the input dtype
  // The reference's fused_rowsum = d < 128: below 128 l sums P rounded to
  // v's dtype, from 128 up the f32 P (the same for f32 inputs).
  const bool sum_rounded = d < 128;

  zero_tail<W, NTH>(sm, BM + 4 * BN, d);
  copy_tile<T, BM, W, NTH>(sQ, q + qoff, qstride, nq_valid, d, true, scale_t);
  auto issue = [&](int j) {  // K and V of tile j into stage j % 2, one commit group
    float* st = sRing + (j & 1) * 2 * BN * LD;
    const int k0 = j * BN, n = min(BN, Sk - k0);
    if constexpr (std::is_same<T, float>::value) {
      copy_tile<T, BN, W, NTH>(st, kb + (long)k0 * kstride, kstride, n, d, false, 1.f);
      copy_tile<T, BN, W, NTH>(st + BN * LD, vb + (long)k0 * kstride, kstride, n, d, false, 1.f);
    } else {
      widen_tile<BN, W, NTH>(st, kb + (long)k0 * kstride, kstride, n, d);
      widen_tile<BN, W, NTH>(st + BN * LD, vb + (long)k0 * kstride, kstride, n, d);
    }
    cp_commit();
  };
  issue(0);  // with Q in its group

  // This thread's cells: queries ty + i GY, keys tx + c GX of S; the same
  // rows of O, columns 4 tx + 4 GX c + e.
  const int tx = Cells<GX, GY>::x(tid), ty = Cells<GX, GY>::y(tid);
  float acc[TM][4 * TC], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;  // this lane's part of the row sum
#pragma unroll
    for (int c = 0; c < 4 * TC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    const float* sK = sRing + (j & 1) * 2 * BN * LD;
    const float* sV = sK + BN * LD;
    const int k0 = j * BN;
    cp_wait_all();
    if (j == 0) scale_own<T, BM, W, NTH>(sQ, d, scale_t);  // Qs = q * scale, in place (f32)
    __syncthreads();  // tile j visible; every thread done with tile j - 1 and P
    if (j + 1 < nk) issue(j + 1);

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[i][c] = 0.f;
    dot_rows<TM, TN, W, LD, GY, GX, US>(s, sQ + ty * LD, sK + tx * LD);  // S = Qs . K^T

    // The online softmax of the thread's rows: keys past Sk and, under the
    // causal mask, after the row are NEG_INF (tiles wholly inside Sk and
    // below the block's first row skip the mask); m_new = max(m, row max);
    // O and l scaled by alpha = exp(m - m_new); P = exp(S - m_new) rounded
    // to T into shared memory as the A operand of O += P . V.
    const bool inside = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + i * GY;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int key = k0 + tx + c * GX;
        if (!inside && (key >= Sk || (causal && key > row))) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int x = GX / 2; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float p = expf(s[i][c] - mx);
        const float pr = rounded<T>(p);  // P rounded to v's dtype for P . V
        sum += sum_rounded ? pr : p;
        sP[(ty + i * GY) * LDP + tx + c * GX] = pr;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * TC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P visible
    acc_rows<TM, TC, BN, LDP, LD, GY, 4 * GX, BN / 4>(acc, sP + ty * LDP, sV + 4 * tx);  // O += P . V
  }

  // l over the row's GX lanes; o = O / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
  OT* ob = o + qoff;
  float* lb = lse + ((long)b * H + h) * Sq + q0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int x = GX / 2; x > 0; x >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * GY;
    if (r >= nq_valid) continue;
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 4 * GX * c + e;
        if (col < d) ob[(long)r * qstride + col] = from_f<OT>(acc[i][4 * c + e] / l[i]);
      }
    if (tx == 0) lb[r] = m[i] + logf(l[i]);
  }
}

template <typename T, typename OT, int W>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int Hkv, int Sq, int Sk, int d, float scale, int causal,
                       cudaStream_t st) {
  using L = FwdLay<W>;
  auto kern = flash_fwd_kernel<T, OT, W>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B;
  kern<<<grid, L::NTH, L::bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<OT*>(o),
                                       static_cast<float*>(lse), B, H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------ FMA path past width 256
// FwdFma<256>'s tiles and cells (so its 32-key tile, which fwd_key_tile
// reports), with the head dim in chunks (flash_common.cuh, SPLIT). Shared
// memory: two ring stages of BM + BN rows, each holding one unit, then P.
// Per key tile the ring carries nc units [Qs chunk x | K chunk x], x = 0 ..
// nc - 1, then one unit [V chunk c] (the block's own, in the stage's first
// BN rows).
struct FwdSplit : FwdLay<SPLIT> {
  static constexpr int STAGE = (BM + BN) * LD;
  static constexpr size_t bytes = sizeof(float) * (size_t)(2 * STAGE + BM * LDP);
};

template <typename T, typename OT>
__global__ void __launch_bounds__(FwdSplit::NTH, 1)
    flash_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, OT* __restrict__ o, float* __restrict__ lse,
                           int B, int H, int Hkv, int Sq, int Sk, int d, float scale, int causal) {
  using L = FwdSplit;
  constexpr int BM = L::BM, BN = L::BN, NTH = L::NTH, GX = L::GX, GY = L::GY, TM = L::TM,
                TN = L::TN, TC = L::TC, LD = L::LD, LDP = L::LDP, STAGE = L::STAGE;

  extern __shared__ __align__(16) float sm[];
  float* sP = sm + 2 * STAGE;

  // Block -> (chunk, q tile, head, batch): the chunk fastest, so that the nc
  // blocks of a q tile read its Q and K at about the same time; q tile
  // slowest and last q tile first, as in flash_fwd_kernel.
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
  const int per_tile = nc + 1, nu = nk * per_tile;

  auto issue = [&](int u) {  // unit u into stage u % 2, one commit group
    float* st = sm + (u & 1) * STAGE;
    const int j = u / per_tile, x = u % per_tile, k0 = j * BN, n = min(BN, Sk - k0);
    if (x < nc) {
      const int x0 = x * SPLIT, dx = chunk_cols(d, x);
      copy_chunk<T, BM, NTH>(st, q + qoff + x0, qstride, nq_valid, dx, vec, true, scale_t);
      copy_chunk<T, BN, NTH>(st + BM * LD, kb + (long)k0 * kstride + x0, kstride, n, dx, vec, false,
                             1.f);
    } else {
      copy_chunk<T, BN, NTH>(st, vb + (long)k0 * kstride + c0, kstride, n, dc, vec, false, 1.f);
    }
    cp_commit();
  };
  issue(0);

  const int tx = Cells<GX, GY>::x(tid), ty = Cells<GX, GY>::y(tid);
  float acc[TM][4 * TC], m[TM], l[TM], s[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * TC; ++c) acc[i][c] = 0.f;
  }

  for (int u = 0; u < nu; ++u) {
    float* st = sm + (u & 1) * STAGE;
    const int j = u / per_tile, x = u % per_tile;
    cp_wait_all();
    if constexpr (std::is_same<T, float>::value)
      if (x < nc) scale_chunk<BM, NTH>(st, vec, scale_t);  // Qs = q * scale, in place (f32)
    __syncthreads();  // unit u visible; every thread done with unit u - 1 and P
    if (u + 1 < nu) issue(u + 1);

    if (x < nc) {  // S += Qs_x . K_x^T, in the same chunk order in every block
      if (x == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TN; ++c) s[i][c] = 0.f;
      }
      dot_rows<TM, TN, SPLIT, LD, GY, GX, L::U>(s, st + ty * LD, st + BM * LD + tx * LD);
      continue;
    }

    // The online softmax of flash_fwd_kernel on the whole S; l sums the f32
    // P (d > 128: the reference's fused_rowsum is off). Every block of a q
    // tile computes the same S, m and l bit for bit.
    const int k0 = j * BN;
    const bool inside = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + i * GY;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int key = k0 + tx + c * GX;
        if (!inside && (key >= Sk || (causal && key > row))) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int xx = GX / 2; xx > 0; xx >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, xx));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float p = expf(s[i][c] - mx);
        sum += p;
        sP[(ty + i * GY) * LDP + tx + c * GX] = rounded<T>(p);  // P rounded to v's dtype
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * TC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P visible
    acc_rows<TM, TC, BN, LDP, LD, GY, 4 * GX, BN / 4>(acc, sP + ty * LDP, st + 4 * tx);  // O_c += P . V_c
  }

  // o's chunk c = O / max(l, 1e-30); lse = m + log(max(l, 1e-30)) from chunk 0.
  OT* ob = o + qoff + c0;
  float* lb = lse + ((long)b * H + h) * Sq + q0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int xx = GX / 2; xx > 0; xx >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], xx);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * GY;
    if (r >= nq_valid) continue;
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 4 * GX * c + e;
        if (col < dc) ob[(long)r * qstride + col] = from_f<OT>(acc[i][4 * c + e] / l[i]);
      }
    if (ch == 0 && tx == 0) lb[r] = m[i] + logf(l[i]);
  }
}

template <typename T, typename OT>
cudaError_t launch_fwd_split(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Hkv, int Sq, int Sk, int d, float scale, int causal,
                             cudaStream_t st) {
  using L = FwdSplit;
  auto kern = flash_fwd_split_kernel<T, OT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B * nchunks(d);
  kern<<<grid, L::NTH, L::bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<OT*>(o),
                                       static_cast<float*>(lse), B, H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16 path (wgmma)
// Shared memory (bytes from a 1024-aligned base): one [64, D] Q tile per
// warpgroup, two ring stages of [BN, D] K tiles, two of V tiles, then
// barriers.
// Keys per tile: 128 at width 64 and 128; 80 at width 256, where O alone
// is 128 registers a thread and a 128-key S (64) and P (32) would not fit
// beside it under 255, and where two ring stages of 80-key K and V tiles
// fill 225 KB of shared memory with Q.
template <int D>
struct FwdHop {
  static constexpr int NWG = 2, BM = 64 * NWG, BN = D == 256 ? 80 : 128, STAGES = 2;
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

// D is the tile width (64, 128 or 256) and d <= D the true head_dim, a multiple
// of 8: the tensor maps read columns d..D-1 as zeros and the epilogue
// stores columns < d only. FULL (d == D) is the exact-width instantiation:
// its strides and its epilogue take the constant D, so that the column
// bound costs the exact widths nothing (a run-time bound there cost the
// D = 128 forward 2-3 % in an A/B on the card).
template <int D, typename OT, bool FULL>
__global__ void __launch_bounds__(128 * FwdHop<D>::NWG, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, OT* __restrict__ o,
                           float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk,
                           int d, float scale, int causal) {
  using L = FwdHop<D>;
  using namespace hop;
  constexpr int NWG = L::NWG, BN = L::BN, KD = D / 16, KN = BN / 16, ST = L::STAGES;
  // The reference's fused_rowsum = d < 128: a narrower head at width 128 has
  // d < 128, and one at width 256 d > 128 (tt_flash_fwd refuses d <= 128
  // there), so d >= 128 on the exact width 128 and at every d of width 256.
  constexpr bool SUM_F32 = FULL ? D >= 128 : D > 128;
  const int hd = FULL ? D : d;

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
  const long qstride = (long)H * hd;
  store_acc<D>(O, o + ((long)b * Sq + qw) * qstride + (long)h * hd, qstride, Sq - qw, hd, wt);
  if ((l & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Sq) lse[((long)b * H + h) * Sq + row] = m[i] + logf(lsum[i]);
    }
  }
}

template <int D, typename OT, bool FULL>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Hkv, int Sq, int Sk, int d, float scale, int causal,
                             cudaStream_t st) {
  using L = FwdHop<D>;
  CUtensorMap mq, mk, mv;
  if (!hop::map_bshd(&mq, q, B, Sq, H, d, 64) || !hop::map_bshd(&mk, k, B, Sk, Hkv, d, L::BN) ||
      !hop::map_bshd(&mv, v, B, Sk, Hkv, d, L::BN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D, OT, FULL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(Sq, L::BM) * H * B;
  kern<<<grid, 128 * L::NWG, L::bytes, st>>>(mq, mk, mv, static_cast<OT*>(o), static_cast<float*>(lse),
                                             B, H, Hkv, Sq, Sk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace tt

// family: 0 = wgmma (bf16, width 64, 128 or 256, d a multiple of 8, past
// 128 at width 256), 1 = FMA
// (width 16, 32, 64, 128 or 256); d <= width is the true head_dim; 2 = FMA
// split (width 256, every d > width in chunks of it). dtype: 0 =
// bf16, 1 = f32 (q, k, v); out_f32: o is f32 instead of q's dtype. Returns
// a cudaError_t; cudaErrorInvalidValue for a combination not built.
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                            int H, int Hkv, int Sq, int Sk, int d, int width, int family,
                            int dtype, int out_f32, float scale, int causal, void* stream) {
  using namespace tt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || (family == 2 ? d <= width : d > width)) return (int)cudaErrorInvalidValue;
#define TT_WG(W, OT, FULL) \
  return (int)launch_fwd_wgmma<W, OT, FULL>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_SPLIT(T, OT) \
  return (int)launch_fwd_split<T, OT>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_FMA(T, OT, W) \
  return (int)launch_fwd<T, OT, W>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, d, scale, causal, st)
#define TT_FMA_W(T, OT)             \
  switch (width) {                  \
    case 16: TT_FMA(T, OT, 16);     \
    case 32: TT_FMA(T, OT, 32);     \
    case 64: TT_FMA(T, OT, 64);     \
    case 128: TT_FMA(T, OT, 128);   \
    case 256: TT_FMA(T, OT, 256);   \
  }                                 \
  break
  if (family == 0 && dtype == 0 && d % 8 == 0) {
    const bool full = d == width;
    if (width == 64 && !out_f32 && full) TT_WG(64, bf16, true);
    if (width == 64 && !out_f32 && !full) TT_WG(64, bf16, false);
    if (width == 64 && out_f32 && full) TT_WG(64, float, true);
    if (width == 64 && out_f32 && !full) TT_WG(64, float, false);
    if (width == 128 && !out_f32 && full) TT_WG(128, bf16, true);
    if (width == 128 && !out_f32 && !full) TT_WG(128, bf16, false);
    if (width == 128 && out_f32 && full) TT_WG(128, float, true);
    if (width == 128 && out_f32 && !full) TT_WG(128, float, false);
    if (width == 256 && d <= 128) return (int)cudaErrorInvalidValue;  // the row-sum rule
    if (width == 256 && !out_f32 && full) TT_WG(256, bf16, true);
    if (width == 256 && !out_f32 && !full) TT_WG(256, bf16, false);
    if (width == 256 && out_f32 && full) TT_WG(256, float, true);
    if (width == 256 && out_f32 && !full) TT_WG(256, float, false);
  } else if (family == 1) {
    switch (dtype * 2 + out_f32) {
      case 0: TT_FMA_W(bf16, bf16);
      case 1: TT_FMA_W(bf16, float);
      case 2:
      case 3: TT_FMA_W(float, float);
    }
  } else if (family == 2 && width == SPLIT) {
    switch (dtype * 2 + out_f32) {
      case 0: TT_SPLIT(bf16, bf16);
      case 1: TT_SPLIT(bf16, float);
      case 2:
      case 3: TT_SPLIT(float, float);
    }
  }
#undef TT_WG
#undef TT_SPLIT
#undef TT_FMA
#undef TT_FMA_W
  return (int)cudaErrorInvalidValue;
}
