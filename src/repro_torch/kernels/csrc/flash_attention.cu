// Flash attention for prefill on Hopper: causal / windowed / full, GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel).
//
// Bound on an H100: operations.  At Sq = Skv = 512 and hd = 64 a head does
// about 2 * 2 * 512 * 512 / 2 * 64 causal flops against 4 * 512 * 64 * 4
// bytes of q, k, v and out: ~64 flops per byte, so the products belong on
// the tensor cores.  Four designs share the file: flash_kernel (f32 at hd
// <= 64), flash_wgmma_kernel (bf16 at hd <= 64, (128, 128) and (192, 128)),
// the span kernel (f32 at hd >= 128) and flash_wgspan_kernel (bf16 at
// (256, 256): the span plan's items on wgmma), each below.
// flash_kernel:
//   * one CTA of 8 warps per (b*h, tile of 64 query rows): each m16 row
//     tile has two warps, one per half of every kv tile's keys, each with
//     its own online-softmax state; the pair merges once, at the end, in
//     a fixed order.  At Sq=512 and 16 heads the grid has only 128 CTAs,
//     one per SM, so two warps per scheduler are what hides the mma.sync
//     and shared-memory latencies that one warp alone leaves exposed (on
//     an H100, 4 warps per CTA ran 1.10x behind SDPA there).  blockIdx.y
//     is reversed,
//     so the tiles with the most causal kv tiles start first and the
//     triangle's long rows do not finish last;
//   * K and V tiles of 64 positions pass through a 2-stage ring in dynamic
//     shared memory, filled by 16-byte cp.async.cg copies (commit_group /
//     wait_group): tile t+1 loads while tile t computes.  Rows are padded
//     so that every fragment load hits 32 distinct banks;
//   * S = Q.K^T and O += P.V run on the tensor cores with mma.sync:
//       - f32: m16n8k8 TF32 in 3xTF32 form, x = big + small with big =
//         cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and each
//         product as small.big + big.small + big.big summed in f32, which
//         keeps f32 accuracy (1xTF32 keeps about three decimal digits);
//       - bf16 (the span kernel's fragment code): m16n8k16 with f32
//         accumulation, V read by ldmatrix.trans; P (f32) enters P.V as a
//         bf16 pair hi + lo, two products, so the output keeps f32
//         accuracy up to its final rounding to bf16;
//   * the online softmax runs on the accumulator fragments, in the log2
//     domain; a row's max and sum are taken across the 4 lanes that share
//     it by two xor-shuffles in a fixed order.  P's accumulator layout
//     (columns 2t, 2t+1) is not TF32's A-operand layout (columns t, t+4):
//     instead of moving P, the P.V product takes the keys of a k-step in
//     the order 0, 2, 4, 6, 1, 3, 5, 7, so P's registers are its A operand
//     as they stand and V's B operand reads rows 2t and 2t+1;
//   * the CTA visits only kv tiles the causal bound and the window can
//     reach; the mask (finite -1e30, causal, window) is applied only on
//     tiles the bound or the ragged kv edge cut;
//   * q_offset, Sq and Skv are runtime ints, so one build serves every
//     prompt length and chunk offset; ragged q and kv edges are masked
//     here (cp.async zero-fills rows past Skv), with no padded copies;
//   * every sum has a fixed order and there are no atomics: the same inputs
//     give the same bits.
// Up to hd = hdv = 64 in f32 flash_kernel runs as above: tiles of 64 keys,
// the two warps of a row tile splitting them.
//
// bf16 at (16, 16), (32, 32), (64, 64), (128, 128) and (192, 128) runs
// flash_wgmma_kernel, on Hopper's warpgroup products (wgmma.cuh).  At
// qwen1.5-0.5b's training call (B 4, Sq = Skv 512, 16 heads of 64, causal)
// the bound is bytes:
// q, k, v and out are 16.8 MB, 5.0 us on an H100, against 3.3 us for the
// three products of hd a visible pair (S, and P.V as P's hi and lo) on the
// bf16 tensor cores.  flash_kernel's bf16 instantiation took 6.8x that
// bytes bound, 2.06x SDPA's bf16 forward: mma.sync products fed by 32-bit
// loads, Q reloaded from shared memory every tile, two barriers a tile
// across 8 warps and a pair merge.  The design:
//   * one CTA of one warpgroup (4 warps, 128 threads) per (b*h, tile of 64
//     query rows), longest rows first; warp w owns rows 16w..16w+15 for the
//     whole walk, so a row's max and sum stay in the 4 lanes that share it
//     (two xor-shuffles, a fixed order) and nothing is merged;
//   * Q (with the first tile) and 64-key K and V tiles of ABSOLUTE keys
//     (tile0 = kv_lo / 64 * 64) arrive by 16-byte cp.async into a 3-stage
//     ring (wg_stages), each chunk XORed into the swizzled layout of its
//     row width (128, 64 or 32 bytes, wgmma.cuh), rows past Sq and Skv
//     zero-filled; a thread's chunks lie whole swizzle patterns apart
//     (WgCopy), so its swizzled offsets and source strides are fixed and a
//     tile costs it a compare and an add a copy; fence.proxy.async, then
//     one barrier a tile, hands the copies to the tensor cores;
//   * S = Q.K^T: wgmma m64n64k16, both operands K-major from shared memory
//     (Q stays in place for the whole walk); the 64x64 f32 S lands in
//     registers in the accumulator layout;
//   * the online softmax on those registers, in the log2 domain with the
//     finite kNegInf: the mask only on tiles the causal bound, the window
//     or the ragged kv edge cut; row maxima on the raw scores (scale > 0
//     rounds monotonically), P = 2^(fma(s, scale', -m)) by one ex2.approx
//     .ftz each; each lane sums its 16 values of a row in order;
//   * O += P_lo.V + P_hi.V: P, split into bf16 hi and lo, is already the
//     register A operand of the k16 chunks (no shuffles); two RS wgmma
//     m64n{hdv}k16 a chunk, lo first, with V MN-major in shared memory
//     through the transpose bit.  So P keeps f32 accuracy up to the
//     output's rounding, as the plain version and the Pallas kernel;
//   * tile it's S is issued, then tile it - 1's P.V behind it; the warp
//     waits for S alone and runs the softmax while that P.V runs on the
//     tensor cores, then waits for it, rescales O and splits the new P:
//     the same operations in the same order as without the overlap, so
//     the same bits; the ring's third stage holds tile it - 1's V while
//     tile it + 1 loads;
//   * O leaves through Q's tile (swizzled) as 16-byte pieces of whole rows.
//   * fully masked tiles add exact zeros at an exact scale of 1, tiles are
//     absolute and rows independent, every sum has a fixed order and there
//     are no atomics: the same inputs give the same bits, and chunked calls
//     give one call's rows bit for bit.
// At hd 64 it holds 123 registers (3 CTAs an SM, by the ring's 58,368 B).
// Its timeline (tools/kernel_stages.py bf16fwd, an H100) is set by the
// longest CTAs' serial walk: a prologue of loads shared by the whole first
// wave, then per tile the softmax's issue (about half a tile), S's latency
// and the barrier.  Tried and left out: a 2-stage ring at 4 CTAs an SM,
// and a fourth stage to load two tiles ahead (no faster).  Replaced, as
// the timelines showed each as a large share of a tile: exp2f with its
// subnormal fix-up, a scale multiply and a masked-value compare per
// score, and per-copy address arithmetic.
// TMA is not used: cp.async with fixed per-thread offsets keeps the
// ring's copies to a few instructions a tile.
// At (128, 128) (deepseek-moe-16b's and qwen1.5-110b's heads; the span
// kernel took 5.2x SDPA's bf16 forward at the template B 4, Sq = Skv 512,
// 16 heads, where the bound is 33.5 MB of bytes, 10.0 us) the same walk
// runs with rows of 256 bytes, two swizzle atoms:
//   * Q, K and V tiles are stored as two 64-column blocks, each a 64-row
//     tile of 128-byte swizzled rows (rt::Swz<128, 64>); S's k-step kk
//     reads block kk / 4, 32 (kk % 4) bytes in, by the same descriptor
//     as at hd 64; a thread's copies lie 8 rows (1,024 bytes) apart in
//     one block, so their XOR is still fixed;
//   * P.V is one RS wgmma m64n128k16 per chunk and half of P: its MN-major
//     V descriptor spans both column blocks through LBO, the 8,192 bytes
//     between them (PTX's canonical MN-major layout, as CUTLASS builds
//     it), rather than two m64n64 products a chunk on the halves of V and
//     O (LBO unused): half the instructions for the same work, and 0.0231
//     against 0.0238 ms at the template, the same bits (an H100); the
//     descriptors of hd <= 64 keep their fields;
//   * 115,712 B of shared memory (Q 16,384 and a 3-stage ring of 98,304)
//     and __launch_bounds__(128, 2): two CTAs fill an SM's 233,472 B with
//     their 1 KB reserves, so the launcher asks for the largest shared
//     carveout; a thread holds O (64 f32), S (32) and P hi + lo (32).
// At (128, 128) it holds 156 registers (2 CTAs an SM) and takes 0.023 ms
// at the template against the span kernel's 0.110 and SDPA's 0.021 (an
// H100, tools/kernel_stages.py bf16fwd): 512 CTAs in two waves, a tile
// about 600 cycles of copies and barrier, 650 S, 920 softmax and 300 the
// previous P.V's tail, so a CTA costs 2.7 us + 1.6 per tile.
// At (192, 128) (MLA prefill: deepseek-v2-236b's 128 heads; the bf16 span
// kernel took 0.231 ms at the 512 bucket, 5.2x SDPA's bf16 forward and
// 9.2x its 25.0 us bytes bound: f32 partials of every row past its first
// span, about 150 MB of traffic beside the 84 MB of q, k, v and out) the
// walk runs with Q and K rows of 384 bytes, three swizzle atoms:
//   * Q and K tiles are three 64-column blocks (rt::Swz<192, R>), S's
//     k-step kk (12 of them) reads block kk / 4, 32 (kk % 4) bytes in, by
//     the same descriptor as at (128, 128); a thread copies chunk i % 8 of
//     rows i / 8 + 16 j in each block (128 threads do not divide a row's
//     24 chunks);
//   * V and O stay at 128 columns: P.V and its descriptor are (128,
//     128)'s, and O leaves through the first two blocks of Q's tile;
//   * S stays 64 x 64, so a thread holds what it holds at (128, 128): 162
//     registers, no spills;
//   * a 3-stage ring would take 1,024 + 24,576 + 3 x 40,960 = 148,480 B,
//     one CTA (4 warps) an SM; 2 stages take 107,520 B, two CTAs an SM.
//     With 2 stages V lags K by a tile: the pass of tile it loads K of
//     tile it + 1 (over tile it - 1's, whose S is done) and V of tile it
//     (over tile it - 2's, whose P.V is done), and the last tile's P.V
//     waits for its V behind one more barrier: the same products in the
//     same order, so the same bits as 3 stages.  On an H100 2 stages took
//     0.054 ms at the 512 bucket and 0.163 at 1024, 3 stages 0.078 and
//     0.273 (tools/kernel_stages.py bf16fwd, in turns): wg_stages keeps 2.
//     A CTA costs 3.0 us + 2.2 per tile; copies awaited and the barrier
//     take 900-1,700 cycles of a tile against S's 700 and the softmax's
//     850: each of the 8 query tiles of a head streams its K and V (40 KB
//     a tile) again.  Tried and left out: 128 query rows a CTA (two
//     warpgroups on one ring, 173,056 B, one CTA an SM: the same bits),
//     which halved that stream and the copies' wait, but the two
//     warpgroups' S products then queued behind each other (1,000-1,400
//     cycles a tile): 0.059 and 0.169 ms, 0.058 and 0.167 with 2 stages.
//
// f32 at (128, 128), (192, 128) and (256, 256) runs flash_span_kernel and
// flash_combine_kernel (bf16 ran it at those pairs before
// flash_wgmma_kernel and flash_wgspan_kernel took them; its bf16 branches,
// scores and accumulate on m16n8k16, stay only for chip_smoke.py, which
// builds that earlier design from a copy of this file to time the new
// ones beside it).  The f32
// one-pass layout lost there: at hd 256 f32 tiles of 64 keys do not fit
// and a warp's O would be 128 registers
// (53x its bound, behind SDPA); at hd 128 and (192, 128) (168,960 and
// 218,112 B, one CTA an SM) the grid was one wave of B x H x Sq/64 CTAs
// (128 at deepseek-moe-16b's 512-token prefill, 32 at its 128-row chunk)
// whose time was the causal triangle's longest CTA: 8 serial tiles of
// about 14,700 cycles each behind a 19,000-cycle prologue
// (tools/kernel_stages.py on an H100: 1.57x behind SDPA, 12x its bound).
// The span design:
//   * the key range is cut into fixed spans of kSpan = 128 ABSOLUTE key
//     positions, and one CTA runs per work item, a (span, tile of 64 query
//     rows, b*h) that some row of the tile sees: 320 CTAs of at most 2
//     tiles at that prefill instead of 128 of up to 8, and 128 instead of
//     32 at the chunk.  The launcher counts the items; the grid has no
//     other CTA.  CTAs start in blockIdx order as SMs free up, so items are
//     numbered longest first (spans of kSpan / BK tiles, then the shorter
//     first and last spans of a query tile: a greedy schedule's order).
//     Each CTA finds its item by a block-wide scan over the query tiles'
//     item counts (find_item), one step per 256 tiles;
//   * each CTA writes every row's partial (m, l, acc[hdv]), log2 domain,
//     into an f32 scratch tensor the wrapper allocates (B x H x Sq x
//     n_spans x (hdv + 2) floats), except a row whose keys all lie in this
//     one span: that row's output is written here, as the combine would
//     write it (one span's merge scales by exactly 1);
//   * flash_combine_kernel merges each other row's spans in span order.
//     Which spans a row reads depends only on its absolute position, Skv
//     and the window, and span boundaries depend neither on Sq nor on
//     q_offset, so a row's partials, and its output, are the same bits in
//     one call and chunk by chunk.  Split and combine are two launches that
//     count as one in build.launches;
//   * S is computed once per row tile: the pair's two warps each take half
//     of a tile's keys for S = Q.K^T and the row maxima, exchange the
//     maxima through shared memory (both take max(half 0, half 1), so they
//     keep one softmax state), write their halves of P to shared memory,
//     and each then accumulates its half of the output columns of P.V over
//     all of the tile's keys (hdv / 4 accumulator registers).  The row sums
//     stay per lane and meet once, at the end, half 0 + half 1;
//   * S accumulates its k-steps round-robin in independent chains (8
//     accumulators a warp), added in order at the end;
//   * Q comes by cp.async with the first K/V tile, and K and V tiles pass
//     through a 2-stage cp.async ring: tile t+1 loads while tile t
//     computes.  Tiles of 64 keys, or 32 for f32 rows wider than 128.
//     Shared memory, f32: (128, 128) Q 33,792 + ring 135,168 + P 18,432 +
//     maxima and sums 1,024 = 188,416 B; (192, 128) 50,176 + 83,968 + 10,240
//     + 1,024 = 145,408 B; (256, 256) 66,560 + 133,120 + 10,240 + 1,024 =
//     210,944 B, of the 232,448 a CTA may have;
//   * the products stay on mma.sync (3xTF32 in f32, m16n8k16 bf16 with P as
//     a hi + lo pair), with the same fragment code as flash_kernel.
//     wgmma is left out: in f32 it needs both operands K-major, so V
//     transposed in shared memory, and each operand as big and small TF32
//     copies, twice Q's and the ring's 200 KB, which do not fit (bf16 has
//     its own paths, flash_wgmma_kernel and flash_wgspan_kernel);
//   * fully masked tiles still add exact zeros and exact scales of 1, and
//     every sum has a fixed order, with no atomics: the same inputs give the
//     same bits.
// On an H100 (tools/kernel_stages.py) a CTA of the 512-token prefill at
// (128, 128) spends about 6,800 cycles on its prologue (Q and two K/V tiles
// issued, the first awaited), 11,300 a tile (S 5,400, softmax and P 1,000,
// P.V 4,900) and 3,000 writing its rows: the 3xTF32 splits and fragment
// loads, not the tensor cores, set the tile's pace.  Tried on the card and
// left out (PERF.md): persistent CTAs taking items from a queue, a ninth
// warp issuing the copies on mbarriers, row-by-row bulk copies, Q split
// into its TF32 halves once per CTA, 32-key tiles at two CTAs an SM, and
// the combine folded into the span kernel (the CTA that takes its query
// tile's last ticket merges the tile: the same bits, but 1.3x slower at
// Sq 512, as one CTA's merge of 64 rows waits on L2 round trips that the
// combine kernel spreads over the card), none faster; S loading Q and K
// by float4, 1-4 % faster, for a second S path.
// TMA is not used: its descriptors would come from cuTensorMapEncodeTiled
// in libcuda, and cp.async keeps the ring full at these tile sizes.
//
// bf16 at (256, 256) (gemma3-1b's heads: 4 on 1 kv head, a 571-token
// prompt, window 512 on the local layers) runs flash_wgspan_kernel.  The
// bytes bound of that call is 2.9 MB, 0.9 us; what sets its time is
// parallelism: flash_wgmma_kernel's one-pass walk would have B x H x
// Sq/64 = 36 CTAs on 132 SMs, the longest walking 9 tiles of 16 S k-steps
// each.  The span kernel's bf16 instantiation (its m16n8k16 fragment code,
// two warps a row tile exchanging maxima and P through shared memory,
// 188,416 B, f32 partials for every row past its first span) took 0.0218
// ms against SDPA's 0.0211.  The design keeps the span plan and puts each
// item on wgmma:
//   * one CTA of one warpgroup per item of the span plan (find_item on 128
//     threads, longest items first): 100 CTAs of one or two 64-key tiles
//     at the 571 call, fewer than the card's SMs; the partials and the
//     combine are the span kernel's, so a row's spans and their merge
//     order depend only on its absolute position, and chunked calls equal
//     one call bit for bit;
//   * Q (64 rows) and both tiles of the span's K and V, each a 64-row tile
//     of four 64-column swizzled blocks (rt::Swz<256, R>), arrive by
//     cp.async in four commit groups, Q and K0, V0, K1, V1 (a thread
//     copies chunk i % 8 of rows i / 8 + 16 j in each block): S of tile 0
//     starts when K0 lands; 164,864 B, one CTA an SM, nothing refilled;
//   * S = Q.K^T in 16 SS wgmma m64n64k16 k-steps; the softmax on S's
//     registers (wg_softmax, flash_wgmma_kernel's: raw-score maxima, one
//     fma and ex2 a score, the finite -1e30 mask only on cut tiles);
//   * O (64 x 256 f32) as two m64n128 accumulators, 128 registers a
//     thread; O += P_lo.V + P_hi.V as two RS m64n128k16 products a chunk
//     and half of P, one on V's blocks 0-1 and one on 2-3, each reaching
//     its second block through LBO (flash_wgmma_kernel's (128, 128)
//     descriptor); tile 0's P.V is issued behind tile 1's S and runs
//     under tile 1's softmax, the same products in the same order;
//   * each row's partial (m, l, acc) is written as the span kernel writes
//     it, and a row whose keys lie in this one span writes its output,
//     both staged through shared memory (the free K and V tiles) and
//     stored by whole rows, 256 contiguous bytes a warp's store; the
//     combine merges the others, launched as a programmatic dependent
//     (griddepcontrol): the items let it start once their tiles are done,
//     and it waits for their end before it reads;
//   * the combine issues the loads of 8 spans' partials before it uses
//     any (kCombineGroup), so a row of up to 8 spans waits on one round of
//     loads; its sums keep span order.
// It holds 218 registers, no spills.  On an H100 (tools/kernel_stages.py
// bf16fwd) the 571 call takes 0.0157-0.0159 ms against the span
// kernel's 0.0212-0.0217 and SDPA's 0.0205-0.0209: a 2-tile CTA spends
// about 1,500 cycles finding its item, 2,700 issuing its copies, 2,600 a
// tile and 1,250 on the last P.V, then issues its rows' stores for
// 6,800-7,100: the
// partials, 6 MB at this call and read back by the combine, set the
// epilogue's pace.  In turns (the same bits), the dependent launch and
// the staging together took the call from 0.0173 to 0.0156-0.0158 ms, the
// staging alone from 0.0162 to 0.0158.  Left out, by what they would cost
// at this call: the one-pass walk (36 CTAs, the longest 9 tiles of about
// 2,600 cycles, no partials, slower than 100 CTAs of at most 2); 16
// positions x the 4 heads of a kv head as the 64-row M tile (K and V
// loaded once for the group, but 100 items all the same, each loading its
// span); two warpgroups splitting O's columns (S computed twice, or P
// through shared memory: needed only if O, S and P spilled, which they do
// not); spans of 256 keys (half the partials' bytes, but 60 CTAs of up to
// 4 tiles through a refilled ring).
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::mma_3xtf32;
using rt::mma_bf16;
using rt::smem_addr;
using rt::split;
using rt::split_bf16;

constexpr int kRowWarps = 4;       // m16 row tiles per CTA
constexpr int kPairs = 2;          // warps per row tile (key or column halves)
constexpr int kThreads = 32 * kRowWarps * kPairs;
constexpr int kBQ = 16 * kRowWarps;   // query rows per CTA
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory per CTA
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileKeys = 64;      // kv positions per tile of flash_kernel

// shared-memory row stride in elements of a D-wide Q, K or V row.  f32:
// padded by 4, so lane (g, t) reading row g, column t of Q or K hits bank
// 4g + t, and rows 2t and 2t+1 of V at column g hit banks 8t + g.  bf16:
// padded by 8, so 32-bit fragment loads of Q and K and ldmatrix rows of V
// do not conflict.
template <typename T, int D>
__host__ __device__ constexpr int stride() {
  return D + (sizeof(T) == 4 ? 4 : 8);
}

// Q tile plus a 2-stage ring of K and V tiles of bk keys
template <typename T, int HD, int HDV>
__host__ __device__ constexpr size_t smem_bytes(int bk) {
  return sizeof(T) * (kBQ * stride<T, HD>() +
                      2 * bk * (stride<T, HD>() + stride<T, HDV>()));
}

// S (16 x 8 NT per warp) = Q_warp . K_warp^T, raw (unscaled) scores, with
// k-step ks accumulated into chain ks % CH and the CH chains added in order
// at the end.  CH = 1 is one chain, as the tiles of 64 keys have; at hd 256
// a warp's two n8 tiles would otherwise each chain HD / 8 dependent
// mma.sync groups (96 products in 3xTF32), and the warp would wait on
// their latency
template <int HD, int NT, int CH>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                              const float* qs,
                                              const float* ks, int g, int t) {
  constexpr int QS = stride<float, HD>(), KS = QS;
  float c[CH][NT][4];
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      c[h][j][0] = c[h][j][1] = c[h][j][2] = c[h][j][3] = 0.f;
#pragma unroll
  for (int ks8 = 0; ks8 < HD / 8; ++ks8) {
    const int col = ks8 * 8 + t;
    uint32_t ab[4], as[4];
    split(qs[g * QS + col], ab[0], as[0]);
    split(qs[(g + 8) * QS + col], ab[1], as[1]);
    split(qs[g * QS + col + 4], ab[2], as[2]);
    split(qs[(g + 8) * QS + col + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* kr = ks + (8 * j + g) * KS + col;
      mma_3xtf32(c[ks8 % CH][j], ab, as, kr[0], kr[4]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = c[0][j][e];
#pragma unroll
      for (int h = 1; h < CH; ++h) x += c[h][j][e];
      s[j][e] = x;
    }
}
template <int HD, int NT, int CH>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                              const __nv_bfloat16* qs,
                                              const __nv_bfloat16* ks, int g,
                                              int t) {
  constexpr int QS = stride<__nv_bfloat16, HD>(), KS = QS;
  float c[CH][NT][4];
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      c[h][j][0] = c[h][j][1] = c[h][j][2] = c[h][j][3] = 0.f;
#pragma unroll
  for (int k16 = 0; k16 < HD / 16; ++k16) {
    const int col = k16 * 16 + 2 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(qs + g * QS + col);
    a[1] = *reinterpret_cast<const uint32_t*>(qs + (g + 8) * QS + col);
    a[2] = *reinterpret_cast<const uint32_t*>(qs + g * QS + col + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(qs + (g + 8) * QS + col + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* kr = ks + (8 * j + g) * KS + col;
      mma_bf16(c[k16 % CH][j], a, *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = c[0][j][e];
#pragma unroll
      for (int h = 1; h < CH; ++h) x += c[h][j][e];
      s[j][e] = x;
    }
}

// O (16 x 8 NO per warp) += P . V_tile, vs pointing at the warp's first
// key and column.  f32: the k-step over keys 8j..8j+7 takes them in the
// order 0,2,4,6,1,3,5,7, so P's accumulator registers (columns 2t, 2t+1)
// are the A operand's (k = t, t+4) as they stand.
template <int HDV, int NT, int NO>
__device__ __forceinline__ void accumulate(float (&o)[NO][4],
                                           const float (&p)[NT][4],
                                           const float* vs, int g, int t) {
  constexpr int VS = stride<float, HDV>();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ab[4], as[4];
    split(p[j][0], ab[0], as[0]);   // (g,   key 2t)
    split(p[j][2], ab[1], as[1]);   // (g+8, key 2t)
    split(p[j][1], ab[2], as[2]);   // (g,   key 2t+1)
    split(p[j][3], ab[3], as[3]);   // (g+8, key 2t+1)
    const float* v0 = vs + (8 * j + 2 * t) * VS + g;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      mma_3xtf32(o[n], ab, as, v0[8 * n], v0[VS + 8 * n]);
  }
}
template <int HDV, int NT, int NO>
__device__ __forceinline__ void accumulate(float (&o)[NO][4],
                                           const float (&p)[NT][4],
                                           const __nv_bfloat16* vs, int g,
                                           int t) {
  constexpr int VS = stride<__nv_bfloat16, HDV>();
  const int lane = 4 * g + t;
#pragma unroll
  for (int k16 = 0; k16 < NT / 2; ++k16) {
    uint32_t ah[4], al[4];
    split_bf16(p[2 * k16][0], p[2 * k16][1], ah[0], al[0]);
    split_bf16(p[2 * k16][2], p[2 * k16][3], ah[1], al[1]);
    split_bf16(p[2 * k16 + 1][0], p[2 * k16 + 1][1], ah[2], al[2]);
    split_bf16(p[2 * k16 + 1][2], p[2 * k16 + 1][3], ah[3], al[3]);
    // lanes 0-15 address rows 16 k16 + 0..15; .trans gives each lane the
    // pair (keys 2t, 2t+1; column g) of both 8x8 matrices
    const __nv_bfloat16* row = vs + (16 * k16 + (lane & 15)) * VS;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t b0, b1;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(b0), "=r"(b1)
          : "r"(smem_addr(row + 8 * n)));
      mma_bf16(o[n], al, b0, b1);
      mma_bf16(o[n], ah, b0, b1);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// f32 only: bf16 at hd <= 64 runs flash_wgmma_kernel
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int Sq,
             int Skv, int H, int Kh, int q_offset, int causal, int window,
             float scale) {
  using T = float;
  constexpr int BK = kTileKeys;               // kv positions per tile
  constexpr int WK = BK / kPairs;             // keys per warp
  constexpr int NT = WK / 8;                  // n8 tiles of S per warp
  constexpr int NO = HDV / 8;                 // n8 tiles of O per warp
  constexpr int QS = stride<T, HD>(), KS = QS, VS = stride<T, HDV>();
  constexpr int KCH = HD * sizeof(T) / 16;    // 16-byte pieces per K row
  constexpr int VCH = HDV * sizeof(T) / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);     // kBQ x QS
  T* kring = qs + kBQ * QS;                   // 2 x BK x KS
  T* vring = kring + 2 * BK * KS;             // 2 x BK x VS

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / Kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int warp = threadIdx.x / 32;
  const int rw = warp % kRowWarps;            // row tile of this warp
  const int kg = warp / kRowWarps;            // its key half
  const int key0 = kg * WK;                   // its first key of a tile
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // fragment row group
  const int t = lane % 4;                     // thread in the group

  // kv span any row of this tile can see
  const int last_q = min(q0 + kBQ, Sq) - 1;
  int kv_hi = Skv;
  int kv_lo = 0;
  if (causal) {
    kv_hi = min(Skv, q_offset + last_q + 1);
    if (window) kv_lo = max(0, q_offset + q0 - window + 1);
  }
  const int tile0 = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > tile0 ? (kv_hi - tile0 + BK - 1) / BK : 0;

  const int64_t krow0 = (int64_t)b * Skv * Kh + kh;   // row p at + p * Kh
  auto load_tile = [&](int it) {
    const int base = tile0 + it * BK;
    T* kd = kring + (it & 1) * BK * KS;
    T* vd = vring + (it & 1) * BK * VS;
    for (int i = threadIdx.x; i < BK * KCH; i += blockDim.x) {
      const int r = i / KCH, c = i % KCH, p = base + r;
      const bool ok = p < Skv;
      const T* src = k + ((krow0 + (int64_t)(ok ? p : 0) * Kh) * HD) +
                     c * (16 / sizeof(T));
      cp_async16(kd + r * KS + c * (16 / sizeof(T)), src, ok);
    }
    for (int i = threadIdx.x; i < BK * VCH; i += blockDim.x) {
      const int r = i / VCH, c = i % VCH, p = base + r;
      const bool ok = p < Skv;
      const T* src = v + ((krow0 + (int64_t)(ok ? p : 0) * Kh) * HDV) +
                     c * (16 / sizeof(T));
      cp_async16(vd + r * VS + c * (16 / sizeof(T)), src, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);

  // q (B, Sq, H, HD): raw rows, zeros past Sq; the scale goes on S
  for (int i = threadIdx.x; i < kBQ * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    qs[r * QS + d] = qi < Sq ? q[(((int64_t)b * Sq + qi) * H + h) * HD + d]
                             : rt::from_f32<T>(0.f);
  }

  const float qk_scale = scale * kLog2e;
  const int row0 = q0 + 16 * rw + g;          // query rows g and g + 8
  const int qp0 = q_offset + row0, qp1 = qp0 + 8;   // absolute positions
  const T* qw = qs + 16 * rw * QS;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf;   // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;                   // this lane's partial sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and q) visible to every warp
    const T* kt = kring + ((it & 1) * BK + key0) * KS;
    const T* vt = vring + ((it & 1) * BK + key0) * VS;
    const int t0 = tile0 + it * BK;             // the CTA's tile
    const int w0 = t0 + key0;                   // this warp's keys

    float s[NT][4];
    scores<HD, NT, 1>(s, qw, kt, g, t);

    // the mask matters only where the causal bound, the window or the
    // ragged kv edge cuts this tile for some row of the CTA
    const bool full =
        t0 + BK <= Skv &&
        (!causal || (t0 + BK - 1 <= q_offset + q0 &&
                     (!window || t0 > q_offset + q0 + kBQ - 1 - window)));
    float mx0 = rt::kNegInf, mx1 = rt::kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * qk_scale;
        if (!full) {
          const int key = w0 + 8 * j + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = key < Skv;
          if (causal) {
            ok = ok && key <= qp;
            if (window) ok = ok && key > qp - window;
          }
          x = ok ? x : rt::kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(rt::kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(rt::kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(rt::kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(rt::kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        s[j][e] = s[j][e] > rt::kNegInf ? exp2f(s[j][e] - mn) : 0.f;
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    accumulate<HDV, NT, NO>(o, s, vt, g, t);
    __syncthreads();   // every warp is done with this stage before refill
  }

  // row sums across the quad, in a fixed order
  l0 += __shfl_xor_sync(rt::kFull, l0, 1);
  l0 += __shfl_xor_sync(rt::kFull, l0, 2);
  l1 += __shfl_xor_sync(rt::kFull, l1, 1);
  l1 += __shfl_xor_sync(rt::kFull, l1, 2);

  {
    // the second key half hands its state to the first through the (now
    // idle) ring, lane-major so neither side conflicts on banks; the first
    // merges them in that order
    constexpr int NV = 4 * NO + 4;            // o fragment, m0, m1, l0, l1
    static_assert(kRowWarps * NV * 32 * sizeof(float) <=
                      sizeof(T) * 2 * BK * (KS + VS), "merge buffer");
    float* xb = reinterpret_cast<float*>(kring) + rw * NV * 32 + lane;
    __syncthreads();                          // the ring is free
    if (kg == 1) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xb[(4 * n + e) * 32] = o[n][e];
      xb[(4 * NO) * 32] = m0;
      xb[(4 * NO + 1) * 32] = m1;
      xb[(4 * NO + 2) * 32] = l0;
      xb[(4 * NO + 3) * 32] = l1;
    }
    __syncthreads();
    if (kg == 1) return;
    const float pm0 = xb[(4 * NO) * 32], pm1 = xb[(4 * NO + 1) * 32];
    const float mn0 = fmaxf(m0, pm0), mn1 = fmaxf(m1, pm1);
    const float a0 = exp2f(m0 - mn0), b0 = exp2f(pm0 - mn0);
    const float a1 = exp2f(m1 - mn1), b1 = exp2f(pm1 - mn1);
    l0 = l0 * a0 + xb[(4 * NO + 2) * 32] * b0;
    l1 = l1 * a1 + xb[(4 * NO + 3) * 32] * b1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] = o[n][0] * a0 + xb[(4 * n) * 32] * b0;
      o[n][1] = o[n][1] * a0 + xb[(4 * n + 1) * 32] * b0;
      o[n][2] = o[n][2] * a1 + xb[(4 * n + 2) * 32] * b1;
      o[n][3] = o[n][3] * a1 + xb[(4 * n + 3) * 32] * b1;
    }
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 8 * n + 2 * t;
    if (row0 < Sq)
      store2<T>(out + (((int64_t)b * Sq + row0) * H + h) * HDV + d,
                o[n][0] * inv0, o[n][1] * inv0);
    if (row0 + 8 < Sq)
      store2<T>(out + (((int64_t)b * Sq + row0 + 8) * H + h) * HDV + d,
                o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bf16 at (16, 16), (32, 32), (64, 64), (128, 128) and (192, 128): one
// warpgroup per 64 query rows, its products on wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;    // one warpgroup: warp w owns rows 16w..
constexpr int kWgAlign = 1024;     // where a swizzle pattern starts

// depth of the K/V ring: 3 up to hd 128; kWgStages192 = 2 at (192, 128),
// whose 3-stage ring (148,480 B with Q) would leave one CTA an SM, where
// 2 stages (107,520 B) let two share it
constexpr int kWgStages192 = 2;
template <int HD>
__host__ __device__ constexpr int wg_stages() {
  return HD == 192 ? kWgStages192 : 3;
}

// CTAs an SM the registers must allow: 3 up to hd 64; 2 at hd 128 and
// 192, whose tiles admit no third, and whose thread holds O (64 f32), S
// (32) and the overlapped tile's P hi + lo (32)
template <int HD>
__host__ __device__ constexpr int wg_min_ctas() {
  return HD > 64 ? 2 : 3;
}

// the tiles' start rounded up to kWgAlign, Q's tile, then the ring's K
// tiles, then its V tiles, each in the swizzled layout of its row width
template <int HD, int HDV>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return kWgAlign +
         2 * (kBQ * HD + wg_stages<HD>() * kTileKeys * (HD + HDV));
}

// the 16-byte cp.async copies of a tile of rows of D bf16 by the 128
// threads: thread i takes chunk i % CW of rows i / CW + j RJ in each of
// the row's NG groups of CW chunks.  Up to hd 128 a group is the whole row
// (CW = D / 8); at hd 192 it is one 64-column block (CW = 8: 128 threads
// do not divide a row of 24 chunks).  A thread's rows lie RJ rows apart,
// whole swizzle patterns (RJ * row bytes is a multiple of 1,024), so its
// swizzled offsets differ by a constant
template <int D>
struct WgCopy {
  static constexpr int CW = D / 8 <= 16 ? D / 8 : 8;   // chunks a group
  static constexpr int NG = D / 8 / CW;                // groups a row
  static constexpr int RJ = kWgThreads / CW;           // rows a pass
};

// 2^x in one MUFU.EX2, results below 2^-126 flushed to zero (exp2f adds
// a range fix-up around it for subnormal results, which P does not need)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64-key tile on S's registers (the raw scores
// of rows g and g + 8 of the warp; s[4 j + e] is key t0 + 8 j + 2 t + (e &
// 1)), in the log2 domain with the finite kNegInf: the mask only where
// `full` is false (the causal bound, the window or the ragged kv edge cuts
// the tile for some row of the CTA), where a masked raw score becomes
// kNegInf, whose 2^(fma) below is 0; the row maxima on the raw scores
// (scale > 0 rounds monotonically, so max(s) * scale' is the max of the
// scaled scores); s turned into P = 2^(s scale' - m) in place, one fma a
// score; the running max m and this lane's sums l updated, each lane
// summing its 16 values of a row in order.  c0 and c1: O's rescale.
__device__ __forceinline__ void wg_softmax(float (&s)[32], bool full, int t0,
                                           int Skv, int causal, int window,
                                           int qp0, int qp1, int t,
                                           float qk_scale, float& m0,
                                           float& m1, float& l0, float& l1,
                                           float& c0, float& c1) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + 2 * t + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        bool ok = key < Skv;
        if (causal) {
          ok = ok && key <= qp;
          if (window) ok = ok && key > qp - window;
        }
        if (!ok) s[4 * j + e] = rt::kNegInf;
      }
  }
  float mx0 = rt::kNegInf, mx1 = rt::kNegInf;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(rt::kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(rt::kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(rt::kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(rt::kFull, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 > rt::kNegInf ? mx0 * qk_scale : mx0);
  const float mn1 = fmaxf(m1, mx1 > rt::kNegInf ? mx1 * qk_scale : mx1);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  // a row that has seen no key yet subtracts 0, so its masked scores give
  // 0, not 2^0
  const float b0 = mn0 > rt::kNegInf ? mn0 : 0.f;
  const float b1 = mn1 > rt::kNegInf ? mn1 : 0.f;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], qk_scale, -b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], qk_scale, -b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], qk_scale, -b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], qk_scale, -b1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * c0 + sum0;
  l1 = l1 * c1 + sum1;
}

// P as bf16 pairs hi + lo, already in the A layout of the k16 chunk of
// keys 16 c .. 16 c + 15 (S's n8 blocks 2c and 2c + 1)
__device__ __forceinline__ void wg_split(const float (&s)[32],
                                         uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1], ph[c][r], pl[c][r]);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kWgThreads, wg_min_ctas<HD>())
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                   int Kh, int q_offset, int causal, int window,
                   float scale) {
  constexpr int BK = kTileKeys;               // keys a tile
  constexpr int NS = wg_stages<HD>();         // ring stages
  // at 2 stages V lags K by a tile (below): tile it + 1's V would land on
  // tile it - 1's, which that tile's P.V still reads
  constexpr bool kLagV = NS == 2;
  using QTile = rt::Swz<HD, kBQ>;             // Q's tile, then O's
  using KTile = rt::Swz<HD, BK>;
  using VTile = rt::Swz<HDV, BK>;
  constexpr int QT = QTile::kBytes;           // bytes of Q's tile
  constexpr int KT = KTile::kBytes;           // of a K tile
  constexpr int VT = VTile::kBytes;           // of a V tile
  constexpr int QC = HD / 8;                  // 16-byte chunks a Q or K row
  constexpr int VC = HDV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qa = (raw + kWgAlign - 1) & ~uint32_t(kWgAlign - 1);
  const uint32_t ka = qa + QT, va = ka + NS * KT;
  unsigned char* qs = smem_raw + (qa - raw);
  unsigned char* ks = qs + QT;
  unsigned char* vs = ks + NS * KT;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / Kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // fragment row group
  const int t = lane % 4;                     // thread in the group

  // kv span any row of this tile can see; tiles keep absolute alignment
  const int last_q = min(q0 + kBQ, Sq) - 1;
  int kv_hi = Skv;
  int kv_lo = 0;
  if (causal) {
    kv_hi = min(Skv, q_offset + last_q + 1);
    if (window) kv_lo = max(0, q_offset + q0 - window + 1);
  }
  const int tile0 = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > tile0 ? (kv_hi - tile0 + BK - 1) / BK : 0;

  // 16-byte cp.async copies by all 128 threads, each to its swizzled
  // place (WgCopy), so the swizzle's XOR of a thread's copies is the same
  // for every row it copies; rows past Skv (Sq) are zero-filled
  const int64_t krow0 = (int64_t)b * Skv * Kh + kh;   // row p at + p * Kh
  // tile it of rows of D from src (K or V) into stage it % NS of dst
  auto load = [&](auto tile, int it, const __nv_bfloat16* src,
                  unsigned char* dst) {
    using Tile = decltype(tile);
    using Cp = WgCopy<Tile::kD>;
    constexpr int D = Tile::kD;
    static_assert(Cp::RJ * Tile::kRow % kWgAlign == 0,
                  "a thread's copies lie whole swizzle patterns apart");
    static_assert(Cp::NG == 1 || 16 * Cp::CW == Tile::kRow,
                  "a group of chunks is one column block");
    const int cr = threadIdx.x / Cp::CW, cc = threadIdx.x % Cp::CW;
    const int p0 = tile0 + it * BK + cr;
    const int64_t off = (krow0 + (int64_t)p0 * Kh) * D + 8 * cc;
    unsigned char* d =
        dst + (it % NS) * Tile::kBytes + Tile::at(cr, cc);
#pragma unroll
    for (int j = 0; j < BK / Cp::RJ; ++j) {
      const bool ok = p0 + j * Cp::RJ < Skv;
#pragma unroll
      for (int gi = 0; gi < Cp::NG; ++gi)
        cp_async16(d + gi * Tile::kBlock + j * Cp::RJ * Tile::kRow,
                   src + (ok ? off + (int64_t)j * Cp::RJ * Kh * D +
                                   8 * Cp::CW * gi
                             : 0),
                   ok);
    }
  };
  auto load_k = [&](int it) { load(KTile{}, it, k, ks); };
  auto load_v = [&](int it) { load(VTile{}, it, v, vs); };
  if (n_tiles > 0) {
    // q (B, Sq, H, HD): raw rows, zeros past Sq, with the first tile
    for (int i = threadIdx.x; i < kBQ * QC; i += kWgThreads) {
      const int r = i / QC, c = i % QC, qi = q0 + r;
      const bool ok = qi < Sq;
      cp_async16(qs + QTile::at(r, c),
                 q + (((int64_t)b * Sq + (ok ? qi : 0)) * H + h) * HD + 8 * c,
                 ok);
    }
    load_k(0);
    if (!kLagV) load_v(0);
  }
  cp_async_commit();

  const float qk_scale = scale * kLog2e;
  const int row0 = q0 + 16 * warp + g;        // query rows g and g + 8
  const int qp0 = q_offset + row0, qp1 = qp0 + 8;   // absolute positions

  float o[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf;   // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;                   // this lane's partial sums

  // P of a tile as bf16 pairs hi + lo; O += P_lo . V + P_hi . V of the
  // tile in stage st, k16 chunk by chunk, lo first, issued (not awaited);
  // at hdv 128 each product spans both of V's column blocks (LBO)
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint64_t dv =
          rt::desc_mn<VTile>(va + st * VT + 16 * c * VTile::kRow);
      rt::wgmma_rs<HDV>(o, pl[c], dv);
      rt::wgmma_rs<HDV>(o, ph[c], dv);
    }
    rt::wg_commit();
  };

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();   // this thread's copies of tile it (at 2 stages:
                          // K of tile it, V of tile it - 1)
    rt::fence_proxy_async();
    __syncthreads();   // every thread's copies landed, and the products
                       // that read the stages refilled next are done:
                       // tile it - 2's (3 stages); at 2 stages tile it -
                       // 1's S and tile it - 2's P.V
    if (it + 1 < n_tiles) load_k(it + 1);
    if (kLagV)
      load_v(it);   // read by tile it's P.V, issued in the next pass
    else if (it + 1 < n_tiles)
      load_v(it + 1);
    cp_async_commit();
    const int st = it % NS;

    // S = Q . K^T, raw scores; then tile it - 1's P.V, which runs on the
    // tensor cores while this tile's softmax runs
    float s[32];
    rt::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      rt::wgmma_ss_n64(s, rt::desc_k<QTile>(qa + QTile::kstep(kk)),
                       rt::desc_k<KTile>(ka + st * KT + KTile::kstep(kk)),
                       kk > 0);
    rt::wg_commit();
    if (it > 0) {
      issue_pv((it - 1) % NS);
      rt::wg_wait<1>();
    } else {
      rt::wg_wait<0>();
    }
    rt::reg_fence(s);

    const int t0 = tile0 + it * BK;
    const bool full =
        t0 + BK <= Skv &&
        (!causal || (t0 + BK - 1 <= q_offset + q0 &&
                     (!window || t0 > q_offset + q0 + kBQ - 1 - window)));
    float c0, c1;
    wg_softmax(s, full, t0, Skv, causal, window, qp0, qp1, t, qk_scale, m0,
               m1, l0, l1, c0, c1);
    // tile it - 1's P.V is done: O and P's registers are free
    rt::wg_wait<0>();
    rt::reg_fence(o);
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      rt::reg_fence(ph[c]);
      rt::reg_fence(pl[c]);
    }
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      o[4 * n] *= c0;
      o[4 * n + 1] *= c0;
      o[4 * n + 2] *= c1;
      o[4 * n + 3] *= c1;
    }
    wg_split(s, ph, pl);
  }
  if (n_tiles > 0) {   // the last tile's P.V
    if (kLagV) {          // its V, issued in the last pass, landed
      cp_async_wait<0>();
      rt::fence_proxy_async();
      __syncthreads();
    }
    rt::wg_fence();
    issue_pv((n_tiles - 1) % NS);
    rt::wg_wait<0>();
    rt::reg_fence(o);
  }
  cp_async_wait<0>();

  // row sums across the quad, in a fixed order
  l0 += __shfl_xor_sync(rt::kFull, l0, 1);
  l0 += __shfl_xor_sync(rt::kFull, l0, 2);
  l1 += __shfl_xor_sync(rt::kFull, l1, 1);
  l1 += __shfl_xor_sync(rt::kFull, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // O through Q's tile (no S reads it any more), each warp its own 16
  // rows in the swizzled layout of Q's width (at (192, 128) O fills the
  // first two of its three column blocks), then back as 16-byte pieces of
  // whole rows
  static_assert(HD >= HDV, "O's rows fit in Q's");
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(qs + QTile::at(r0, n) + 4 * t) =
        __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(qs + QTile::at(r0 + 8, n) + 4 * t) =
        __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * VC; i += 32) {
    const int r = i / VC, c = i % VC, row = q0 + 16 * warp + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + row) * H + h) *
                                          HDV + 8 * c) =
          *reinterpret_cast<const uint4*>(qs + QTile::at(16 * warp + r,
                                                            c));
  }
}

// ---------------------------------------------------------------------------
// (128, 128), (192, 128) and (256, 256): the key range split into spans,
// one CTA per (span, query tile, b*h) item, longest items first
// ---------------------------------------------------------------------------

constexpr int kSpan = 128;         // absolute key positions per span

// kv positions per ring tile of the span kernel: 64, or 32 for f32 rows
// wider than 128 (a 64-key f32 ring at hd 192 or 256 does not fit)
template <typename T, int HD>
__host__ __device__ constexpr int span_tile() {
  return sizeof(T) == 4 && HD > 128 ? 32 : 64;
}
// independent accumulator chains of S: 8 accumulators per warp (a warp's
// BK / 16 n8 tiles of S times the chains), 4 chains at hd 256 in both types
template <typename T, int HD>
__host__ __device__ constexpr int s_chains() {
  return HD == 256 ? 4 : 8 / (span_tile<T, HD>() / kPairs / 8);
}
// P's row stride in floats: lanes (g, t) storing or loading the float2 at
// row g, column 2t hit banks 8g + 2t, distinct within each half warp
template <typename T, int HD>
__host__ __device__ constexpr int p_stride() {
  return span_tile<T, HD>() + 8;
}
// Q tile and the K/V ring, then P (16 rows x p_stride per row tile), then
// each warp's row maxima and sums (2 x 16 floats per warp)
template <typename T, int HD, int HDV>
__host__ __device__ constexpr size_t span_smem() {
  return smem_bytes<T, HD, HDV>(span_tile<T, HD>()) +
         sizeof(float) * (kRowWarps * 16 * p_stride<T, HD>() +
                          kRowWarps * kPairs * 2 * 16);
}

// the two warps (64 threads) of row tile rw; named barrier 0 is
// __syncthreads
__device__ __forceinline__ void pair_sync(int rw) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(rw + 1), "r"(kPairs * 32)
               : "memory");
}

// The spans [first, last] holding a key that the query at absolute position
// qp may see (last < first: none).  They depend only on qp, Skv and the
// window, so a row reads the same spans in one call and chunk by chunk.
__device__ __forceinline__ int2 row_spans(int qp, int Skv, int causal,
                                          int window) {
  int klo = 0, khi = Skv - 1;
  if (causal) {
    khi = min(khi, qp);
    if (window) klo = max(0, qp - window + 1);
  }
  const int first = klo / kSpan;
  return make_int2(first, khi >= klo ? khi / kSpan : first - 1);
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The keys [lo, hi) that some row of the query tile starting at q0 may see
struct TileKeys {
  int lo, hi;
};
__host__ __device__ inline TileKeys tile_keys(int q0, int Sq, int Skv,
                                              int q_offset, int causal,
                                              int window) {
  const int last_q = imin(q0 + kBQ, Sq) - 1;
  TileKeys r{0, Skv};
  if (causal) {
    r.hi = imin(Skv, q_offset + last_q + 1);
    if (window) r.lo = imax(0, q_offset + q0 - window + 1);
  }
  return r;
}
// The tiles of BK keys that span s of a query tile with keys tk covers
template <int BK>
__host__ __device__ inline int span_tiles(TileKeys tk, int s) {
  const int lo = imax(tk.lo, s * kSpan), hi = imin(tk.hi, s * kSpan + kSpan);
  return (hi - (lo / BK) * BK + BK - 1) / BK;
}
// The spans of a query tile that some row of it sees, [first, first + n),
// and the long ones among them, [lf, lf + nl): those of kSpan / BK tiles.
// Only the first and the last span can be short.
struct TileSpans {
  int first, n, lf, nl;
};
template <int BK>
__host__ __device__ TileSpans tile_spans(int q0, int Sq, int Skv,
                                         int q_offset, int causal,
                                         int window) {
  const TileKeys tk = tile_keys(q0, Sq, Skv, q_offset, causal, window);
  if (tk.hi <= tk.lo) return TileSpans{0, 0, 0, 0};
  const int first = tk.lo / kSpan, last = (tk.hi - 1) / kSpan;
  int lf = first, ll = last;
  if (span_tiles<BK>(tk, first) < kSpan / BK) ++lf;
  if (ll >= lf && span_tiles<BK>(tk, last) < kSpan / BK) --ll;
  return TileSpans{first, last - first + 1, lf, imax(0, ll - lf + 1)};
}

// A work item: one (span, tile of 64 query rows, b*h) whose keys some row of
// the tile sees; the grid has one CTA per item and no other.  CTAs start in
// blockIdx order as SMs free up, so the items are numbered longest first:
// the long ones (kSpan / BK tiles), then the short ones, each query tile by
// query tile from the last, then b*h, then span.
struct Item {
  int span, q0, bh;
};
// The item of CTA idx, found by the CTA's threads together: each takes one
// query tile, a block-wide scan of the tiles' item counts gives every tile
// its first index, and the thread whose tile holds idx publishes the item
// in sh (NTH / 32 + 3 ints).  One step per NTH query tiles (NTH: the CTA's
// threads).
template <int BK, int NTH>
__device__ Item find_item(int idx, int Sq, int Skv, int q_offset,
                          int causal, int window, int BH, int* sh) {
  constexpr int NW = NTH / 32;
  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int base = 0;                               // items of the earlier steps
  for (int pass = 0; pass < 2; ++pass)
    for (int r0 = 0; r0 < n_q; r0 += NTH) {
      const int r = r0 + threadIdx.x;
      const int q0 = (n_q - 1 - r) * kBQ;
      TileSpans ts{0, 0, 0, 0};
      if (r < n_q) ts = tile_spans<BK>(q0, Sq, Skv, q_offset, causal, window);
      const int n = pass == 0 ? ts.nl : ts.n - ts.nl;
      int incl = n * BH;                      // inclusive scan in the warp
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(rt::kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) sh[warp] = incl;
      __syncthreads();
      int start = base + incl - n * BH, total = base;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        start += w < warp ? sh[w] : 0;
        total += sh[w];
      }
      if (n > 0 && idx >= start && idx < start + n * BH) {
        const int j = (idx - start) % n;
        sh[NW] = pass == 0 ? ts.lf + j
                 : j == 0 && ts.lf > ts.first ? ts.first
                                              : ts.first + ts.n - 1;
        sh[NW + 1] = q0;
        sh[NW + 2] = (idx - start) / n;
      }
      __syncthreads();                        // sh[] read before rewritten
      if (idx < total) return Item{sh[NW], sh[NW + 1], sh[NW + 2]};
      base = total;
    }
  return Item{-1, 0, 0};
}
template <int BK>
__host__ __device__ int count_items(int Sq, int Skv, int q_offset,
                                    int causal, int window, int BH) {
  const int n_q = (Sq + kBQ - 1) / kBQ;
  int n = 0;
  for (int r = 0; r < n_q; ++r)
    n += tile_spans<BK>(r * kBQ, Sq, Skv, q_offset, causal, window).n * BH;
  return n;
}

// One CTA per work item: the partial softmax state (m, l, acc[HDV]) of
// every query row of the tile over the keys of the span it may see, in the
// log2 domain, into part[b*h][row][span].  A row whose keys all lie in this
// one span is finished here, its output written directly as the combine
// would write it (one span's merge scales by exactly 1), and the combine
// skips it.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_span_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ part,
                  T* __restrict__ out, int Sq, int Skv, int H, int Kh,
                  int q_offset, int causal, int window, float scale,
                  int n_spans, int BH) {
  constexpr int BK = span_tile<T, HD>();      // kv positions per tile
  constexpr int WK = BK / kPairs;             // keys of S per warp
  constexpr int NT = WK / 8;                  // n8 tiles of S per warp
  constexpr int NP = BK / 8;                  // n8 tiles of P per row tile
  constexpr int CV = HDV / kPairs;            // O columns per warp
  constexpr int NO = CV / 8;                  // n8 tiles of O per warp
  constexpr int QS = stride<T, HD>(), KS = QS, VS = stride<T, HDV>();
  constexpr int PS = p_stride<T, HD>();
  constexpr int KCH = HD * sizeof(T) / 16;    // 16-byte pieces per K row
  constexpr int VCH = HDV * sizeof(T) / 16;
  static_assert(kSpan % BK == 0 && NP % 2 == 0, "tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);     // kBQ x QS
  T* kring = qs + kBQ * QS;                   // 2 x BK x KS
  T* vring = kring + 2 * BK * KS;             // 2 x BK x VS
  float* pbuf = reinterpret_cast<float*>(vring + 2 * BK * VS);
  float* xbuf = pbuf + kRowWarps * 16 * PS;   // [rw][kg][max, sum][16]

  const Item item = find_item<BK, kThreads>(blockIdx.x, Sq, Skv, q_offset,
                                            causal, window, BH,
                                            reinterpret_cast<int*>(xbuf));
  const int span = item.span, q0 = item.q0;
  const int b = item.bh / H;
  const int h = item.bh % H;
  const int kh = h / (H / Kh);
  const int warp = threadIdx.x / 32;
  const int rw = warp % kRowWarps;            // row tile of this warp
  const int kg = warp / kRowWarps;            // its key half of S, and its
                                              // column half of O
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const TileKeys tk = tile_keys(q0, Sq, Skv, q_offset, causal, window);
  const int tile0 = (imax(tk.lo, span * kSpan) / BK) * BK;
  const int n_tiles = span_tiles<BK>(tk, span);

  const int64_t krow0 = (int64_t)b * Skv * Kh + kh;   // row p at + p * Kh
  auto load_tile = [&](int it) {
    const int base = tile0 + it * BK;
    T* kd = kring + (it & 1) * BK * KS;
    T* vd = vring + (it & 1) * BK * VS;
    for (int i = threadIdx.x; i < BK * KCH; i += blockDim.x) {
      const int r = i / KCH, c = i % KCH, p = base + r;
      const bool ok = p < Skv;
      const int64_t off = (krow0 + (int64_t)(ok ? p : 0) * Kh) * HD +
                          c * (16 / sizeof(T));
      cp_async16(kd + r * KS + c * (16 / sizeof(T)), k + off, ok);
      if (HD == HDV)
        cp_async16(vd + r * VS + c * (16 / sizeof(T)), v + off, ok);
    }
    if (HD != HDV)
      for (int i = threadIdx.x; i < BK * VCH; i += blockDim.x) {
        const int r = i / VCH, c = i % VCH, p = base + r;
        const bool ok = p < Skv;
        const int64_t off = (krow0 + (int64_t)(ok ? p : 0) * Kh) * HDV +
                            c * (16 / sizeof(T));
        cp_async16(vd + r * VS + c * (16 / sizeof(T)), v + off, ok);
      }
    cp_async_commit();
  };
  // q (B, Sq, H, HD): raw rows, zeros past Sq, copied with tile 0 (the
  // scale goes on S)
  for (int i = threadIdx.x; i < kBQ * KCH; i += blockDim.x) {
    const int r = i / KCH, c = i % KCH, qi = q0 + r;
    const bool ok = qi < Sq;
    const int64_t off =
        ok ? (((int64_t)b * Sq + qi) * H + h) * HD + c * (16 / sizeof(T)) : 0;
    cp_async16(qs + r * QS + c * (16 / sizeof(T)), q + off, ok);
  }
  load_tile(0);

  const float qk_scale = scale * kLog2e;
  const int row0 = q0 + 16 * rw + g;          // query rows g and g + 8
  const int qp0 = q_offset + row0, qp1 = qp0 + 8;   // absolute positions
  const T* qw = qs + 16 * rw * QS;
  float* pw = pbuf + rw * 16 * PS;            // this row tile's P
  float* xw = xbuf + rw * kPairs * 2 * 16;    // its pair's maxima and sums

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf;   // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;                   // this lane's partial sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and q) visible to every warp
    const T* kt = kring + ((it & 1) * BK + kg * WK) * KS;
    const T* vt = vring + (it & 1) * BK * VS + kg * CV;
    const int t0 = tile0 + it * BK;             // the item's tile
    const int w0 = t0 + kg * WK;                // this warp's keys of S

    // S for this warp's half of the tile's keys, computed once
    float s[NT][4];
    scores<HD, NT, s_chains<T, HD>()>(s, qw, kt, g, t);

    const bool full =
        t0 + BK <= Skv &&
        (!causal || (t0 + BK - 1 <= q_offset + q0 &&
                     (!window || t0 > q_offset + q0 + kBQ - 1 - window)));
    float mx0 = rt::kNegInf, mx1 = rt::kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * qk_scale;
        if (!full) {
          const int key = w0 + 8 * j + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = key < Skv;
          if (causal) {
            ok = ok && key <= qp;
            if (window) ok = ok && key > qp - window;
          }
          x = ok ? x : rt::kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(rt::kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(rt::kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(rt::kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(rt::kFull, mx1, 2));
    if (t == 0) {
      xw[kg * 32 + g] = mx0;
      xw[kg * 32 + g + 8] = mx1;
    }
    pair_sync(rw);
    // the tile's row maxima, key halves in order: the pair's two warps
    // take the same values, so they keep one softmax state
    const float mn0 = fmaxf(m0, fmaxf(xw[g], xw[32 + g]));
    const float mn1 = fmaxf(m1, fmaxf(xw[g + 8], xw[32 + g + 8]));
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        s[j][e] = s[j][e] > rt::kNegInf ? exp2f(s[j][e] - mn) : 0.f;
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
      const int col = kg * WK + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(pw + g * PS + col) =
          make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * PS + col) =
          make_float2(s[j][2], s[j][3]);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    pair_sync(rw);     // the tile's whole P is in shared memory
    float p[NP][4];    // P (16 x BK) in the accumulator layout of S
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float2 x =
          *reinterpret_cast<const float2*>(pw + g * PS + 8 * j + 2 * t);
      const float2 y = *reinterpret_cast<const float2*>(
          pw + (g + 8) * PS + 8 * j + 2 * t);
      p[j][0] = x.x;
      p[j][1] = x.y;
      p[j][2] = y.x;
      p[j][3] = y.y;
    }
    // this warp's half of the columns, over all of the tile's keys
    accumulate<HDV, NP, NO>(o, p, vt, g, t);
    __syncthreads();   // every warp is done with this stage before refill
  }

  // row sums: across the quad, then the pair's key halves in order
  l0 += __shfl_xor_sync(rt::kFull, l0, 1);
  l0 += __shfl_xor_sync(rt::kFull, l0, 2);
  l1 += __shfl_xor_sync(rt::kFull, l1, 1);
  l1 += __shfl_xor_sync(rt::kFull, l1, 2);
  if (t == 0) {
    xw[kg * 32 + 16 + g] = l0;
    xw[kg * 32 + 16 + g + 8] = l1;
  }
  pair_sync(rw);
  const float L0 = xw[16 + g] + xw[48 + g];
  const float L1 = xw[16 + g + 8] + xw[48 + g + 8];

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const int2 rs = row_spans(q_offset + row, Skv, causal, window);
    if (span < rs.x || span > rs.y) continue;   // never read
    if (rs.x == rs.y) {                         // the row's only span
      const float inv = 1.f / fmaxf(r ? L1 : L0, 1e-30f);
      T* po = out + (((int64_t)b * Sq + row) * H + h) * HDV + kg * CV;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2<T>(po + 8 * n + 2 * t, o[n][2 * r] * inv,
                  o[n][2 * r + 1] * inv);
      continue;
    }
    float* pp = part + (((int64_t)item.bh * Sq + row) * n_spans + span) *
                           (HDV + 2);
    if (kg == 0 && t == 0) {
      pp[0] = r ? m1 : m0;
      pp[1] = r ? L1 : L0;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(pp + 2 + kg * CV + 8 * n + 2 * t) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// kCombineThreads / (HDV / 2) query rows per CTA of the combine
constexpr int kCombineThreads = 256;
// spans of a row whose partials the combine loads at once
constexpr int kCombineGroup = 8;

// Two output columns per thread, one row per HDV / 2 threads: the spans
// the row can see, merged in span order (a span it cannot see is never
// read).  A row with one span was written by the span kernel; a row that
// sees no key gets zeros, as an empty merge gives them.  The partials of
// kCombineGroup spans are loaded together before any is used (loads past
// the row's last span reread it and are ignored), so a row of up to that
// many spans waits on one round of loads, not one a span; the sums keep
// span order, as one span at a time would add them.
template <typename T, int HDV>
__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int Sq, int Skv, int H, int q_offset, int causal,
                     int window, int n_spans) {
  // launched as a programmatic dependent of the span kernel, which lets it
  // start early: every partial is read after that grid's end
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int R = kCombineThreads / (HDV / 2);
  const int row = blockIdx.x * R + threadIdx.x / (HDV / 2);
  if (row >= Sq) return;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int2 rs = row_spans(q_offset + row, Skv, causal, window);
  if (rs.x == rs.y) return;
  const int d = 2 * (threadIdx.x % (HDV / 2));
  T* po = out + (((int64_t)b * Sq + row) * H + h) * HDV + d;
  if (rs.y < rs.x) {   // a row that sees no key: exact zeros
    store2<T>(po, 0.f, 0.f);
    return;
  }
  const float* pr =
      part + ((int64_t)blockIdx.y * Sq + row) * n_spans * (HDV + 2);
  constexpr int G = kCombineGroup;
  float m[G], l[G];
  float2 a[G];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float* ps = pr + imin(s0 + i, rs.y) * (HDV + 2);
      m[i] = ps[0];
      l[i] = ps[1];
      a[i] = *reinterpret_cast<const float2*>(ps + 2 + d);
    }
  };
  fetch(rs.x);
  float mx = rt::kNegInf;
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (rs.x + i <= rs.y) mx = fmaxf(mx, m[i]);
  for (int s0 = rs.x + G; s0 <= rs.y; s0 += G) {
    float mg[G];
#pragma unroll
    for (int i = 0; i < G; ++i) mg[i] = pr[imin(s0 + i, rs.y) * (HDV + 2)];
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (s0 + i <= rs.y) mx = fmaxf(mx, mg[i]);
  }
  float L = 0.f, O0 = 0.f, O1 = 0.f;
  for (int s0 = rs.x; s0 <= rs.y; s0 += G) {
    if (s0 > rs.x) fetch(s0);
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (s0 + i <= rs.y) {
        const float c = exp2f(m[i] - mx);
        L += l[i] * c;
        O0 += a[i].x * c;
        O1 += a[i].y * c;
      }
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  store2<T>(po, O0 * inv, O1 * inv);
}

// ---------------------------------------------------------------------------
// bf16 at (256, 256): the span plan's items on wgmma
// ---------------------------------------------------------------------------

// Q's tile and both tiles of a span's K and V, each swizzled (wgmma.cuh),
// after the kWgAlign rounding: a span's tiles are all in shared memory at
// once, so nothing is refilled
template <int HD, int HDV>
__host__ __device__ constexpr size_t wgspan_smem_bytes() {
  return kWgAlign + 2 * (kBQ * HD + kSpan * (HD + HDV));
}

// One CTA of one warpgroup per work item of the span plan (find_item: a
// span of kSpan absolute keys, a tile of 64 query rows and b*h, longest
// items first), as flash_span_kernel, with flash_wgmma_kernel's products:
// S = Q.K^T by wgmma m64n64k16 from shared memory, the online softmax on
// S's registers, O += P_lo.V + P_hi.V by register-A wgmma.  Q, K and V of
// the item's one or two 64-key tiles arrive by cp.async in four commit
// groups (Q and K0, V0, K1, V1), so S of tile 0 starts when its K lands
// and tile 0's P.V runs behind tile 1's S.  O (64 x 256 f32) is two
// m64n128 accumulators, 128 registers a thread.  Each row's partial (m, l,
// acc) goes to part, or, for a row whose keys all lie in this span, its
// output to out, as flash_span_kernel writes them.
template <int HD, int HDV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgspan_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                    int Sq, int Skv, int H, int Kh, int q_offset, int causal,
                    int window, float scale, int n_spans, int BH) {
  constexpr int BK = kTileKeys;               // keys a tile
  constexpr int NT = kSpan / BK;              // tiles a span
  constexpr int NH = HDV / 128;               // m64n128 products of P.V
  static_assert(HDV % 128 == 0 && HD >= HDV, "O in 128-column halves");
  using QTile = rt::Swz<HD, kBQ>;
  using KTile = rt::Swz<HD, BK>;
  using VTile = rt::Swz<HDV, BK>;
  constexpr int QT = QTile::kBytes, KT = KTile::kBytes, VT = VTile::kBytes;
  constexpr int QC = HD / 8;                  // 16-byte chunks a Q row
  __shared__ int sh[kWgThreads / 32 + 3];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qa = (raw + kWgAlign - 1) & ~uint32_t(kWgAlign - 1);
  const uint32_t ka = qa + QT, va = ka + NT * KT;
  unsigned char* qs = smem_raw + (qa - raw);
  unsigned char* ks = qs + QT;
  unsigned char* vs = ks + NT * KT;

  const Item item = find_item<BK, kWgThreads>(blockIdx.x, Sq, Skv, q_offset,
                                              causal, window, BH, sh);
  const int span = item.span, q0 = item.q0;
  const int b = item.bh / H;
  const int h = item.bh % H;
  const int kh = h / (H / Kh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // fragment row group
  const int t = lane % 4;                     // thread in the group

  const TileKeys tk = tile_keys(q0, Sq, Skv, q_offset, causal, window);
  const int tile0 = (imax(tk.lo, span * kSpan) / BK) * BK;
  const int n_tiles = span_tiles<BK>(tk, span);   // 1 or 2

  // 16-byte cp.async copies by all 128 threads to their swizzled places
  // (WgCopy: at 256 columns chunk i % 8 of rows i / 8 + 16 j in each of
  // the four column blocks); rows past Skv are zero-filled
  const int64_t krow0 = (int64_t)b * Skv * Kh + kh;   // row p at + p * Kh
  auto load = [&](auto tile, int it, const __nv_bfloat16* src,
                  unsigned char* dst) {
    using Tile = decltype(tile);
    using Cp = WgCopy<Tile::kD>;
    constexpr int D = Tile::kD;
    static_assert(Cp::RJ * Tile::kRow % kWgAlign == 0 &&
                      16 * Cp::CW == Tile::kRow,
                  "a thread's copies lie whole swizzle patterns apart, and "
                  "a group of chunks is one column block");
    const int cr = threadIdx.x / Cp::CW, cc = threadIdx.x % Cp::CW;
    const int p0 = tile0 + it * BK + cr;
    const int64_t off = (krow0 + (int64_t)p0 * Kh) * D + 8 * cc;
    unsigned char* d = dst + it * Tile::kBytes + Tile::at(cr, cc);
#pragma unroll
    for (int j = 0; j < BK / Cp::RJ; ++j) {
      const bool ok = p0 + j * Cp::RJ < Skv;
#pragma unroll
      for (int gi = 0; gi < Cp::NG; ++gi)
        cp_async16(d + gi * Tile::kBlock + j * Cp::RJ * Tile::kRow,
                   src + (ok ? off + (int64_t)j * Cp::RJ * Kh * D +
                                   8 * Cp::CW * gi
                             : 0),
                   ok);
    }
  };
  // q (B, Sq, H, HD): raw rows, zeros past Sq, in the group of K0
  for (int i = threadIdx.x; i < kBQ * QC; i += kWgThreads) {
    const int r = i / QC, c = i % QC, qi = q0 + r;
    const bool ok = qi < Sq;
    cp_async16(qs + QTile::at(r, c),
               q + (((int64_t)b * Sq + (ok ? qi : 0)) * H + h) * HD + 8 * c,
               ok);
  }
  static_assert(NT == 2, "four commit groups: (Q, K0), V0, K1, V1");
  load(KTile{}, 0, k, ks);
  cp_async_commit();
  load(VTile{}, 0, v, vs);
  cp_async_commit();
  if (n_tiles > 1) load(KTile{}, 1, k, ks);
  cp_async_commit();
  if (n_tiles > 1) load(VTile{}, 1, v, vs);
  cp_async_commit();

  const float qk_scale = scale * kLog2e;
  const int row0 = q0 + 16 * warp + g;        // query rows g and g + 8
  const int qp0 = q_offset + row0, qp1 = qp0 + 8;   // absolute positions

  float o[NH][64];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[hf][i] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf;   // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;                   // this lane's partial sums

  // O += P_lo . V + P_hi . V of tile it, k16 chunk by chunk, lo first, as
  // two m64n128 products a chunk and half of P (V's column blocks 0-1 and
  // 2-3, LBO to the second block of each), issued (not awaited)
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  auto issue_pv = [&](int it) {
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        const uint64_t dv = rt::desc_mn<VTile>(
            va + it * VT + 2 * hf * VTile::kBlock + 16 * c * VTile::kRow);
        rt::wgmma_rs<128>(o[hf], pl[c], dv);
        rt::wgmma_rs<128>(o[hf], ph[c], dv);
      }
    rt::wg_commit();
  };

  for (int it = 0; it < n_tiles; ++it) {
    // tile 0: Q and K0 landed; tile 1: V0 and K1 too
    if (it == 0)
      cp_async_wait<3>();
    else
      cp_async_wait<1>();
    rt::fence_proxy_async();
    __syncthreads();   // every thread's copies of them landed

    // S = Q . K^T, raw scores; then tile 0's P.V behind it
    float s[32];
    rt::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      rt::wgmma_ss_n64(s, rt::desc_k<QTile>(qa + QTile::kstep(kk)),
                       rt::desc_k<KTile>(ka + it * KT + KTile::kstep(kk)),
                       kk > 0);
    rt::wg_commit();
    if (it > 0) {
      issue_pv(it - 1);
      rt::wg_wait<1>();
    } else {
      rt::wg_wait<0>();
    }
    rt::reg_fence(s);   // S of tile it is in registers

    const int t0 = tile0 + it * BK;
    const bool full =
        t0 + BK <= Skv &&
        (!causal || (t0 + BK - 1 <= q_offset + q0 &&
                     (!window || t0 > q_offset + q0 + kBQ - 1 - window)));
    float c0, c1;
    wg_softmax(s, full, t0, Skv, causal, window, qp0, qp1, t, qk_scale, m0,
               m1, l0, l1, c0, c1);
    // tile 0's P.V is done: O and P's registers are free
    rt::wg_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      rt::reg_fence(o[hf]);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[hf][4 * n] *= c0;
        o[hf][4 * n + 1] *= c0;
        o[hf][4 * n + 2] *= c1;
        o[hf][4 * n + 3] *= c1;
      }
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      rt::reg_fence(ph[c]);
      rt::reg_fence(pl[c]);
    }
    wg_split(s, ph, pl);
  }
  // the last tile's P.V, once its V landed
  cp_async_wait<0>();
  rt::fence_proxy_async();
  __syncthreads();
  if (n_tiles > 0) {
    rt::wg_fence();
    issue_pv(n_tiles - 1);
    rt::wg_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) rt::reg_fence(o[hf]);
  }

  // the combine's CTAs may start now: they wait for this grid's end
  // (griddepcontrol.wait) before they read a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // row sums across the quad, in a fixed order
  l0 += __shfl_xor_sync(rt::kFull, l0, 1);
  l0 += __shfl_xor_sync(rt::kFull, l0, 2);
  l1 += __shfl_xor_sync(rt::kFull, l1, 1);
  l1 += __shfl_xor_sync(rt::kFull, l1, 2);
  // each row's (m, l, acc) through shared memory (the K and V tiles, free
  // once every warp's last P.V is done), in its global layout, then out by
  // whole rows: a warp's store covers 256 contiguous bytes of one row,
  // where a store from the accumulator layout covers 32 bytes of 8 rows
  constexpr int RS = HDV + 8;   // floats a staged row: lanes (g, t) of a
                                // half warp hit distinct banks
  static_assert(kBQ * RS * 4 <= NT * (KT + VT) && HDV == 8 * 32,
                "rows fit in the tiles; a lane writes 8 output columns");
  float* st = reinterpret_cast<float*>(ks);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* sr = st + (16 * warp + g + 8 * r) * RS;
    if (t == 0) {
      sr[0] = r ? m1 : m0;
      sr[1] = r ? l1 : l0;
    }
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<float2*>(sr + 2 + 128 * hf + 8 * n + 2 * t) =
            make_float2(o[hf][4 * n + 2 * r], o[hf][4 * n + 2 * r + 1]);
  }
  __syncthreads();
  for (int rr = warp; rr < kBQ; rr += kWgThreads / 32) {
    const int row = q0 + rr;
    if (row >= Sq) break;
    const int2 rs = row_spans(q_offset + row, Skv, causal, window);
    if (span < rs.x || span > rs.y) continue;   // never read
    const float* sr = st + rr * RS;
    if (rs.x == rs.y) {        // the row's only span: its output, 8 columns
      const float inv = 1.f / fmaxf(sr[1], 1e-30f);   // a lane
      const float* a = sr + 2 + 8 * lane;
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 y =
            __floats2bfloat162_rn(a[2 * j] * inv, a[2 * j + 1] * inv);
        wp[j] = *reinterpret_cast<const uint32_t*>(&y);
      }
      *reinterpret_cast<uint4*>(
          out + (((int64_t)b * Sq + row) * H + h) * HDV + 8 * lane) = w;
      continue;
    }
    float2* pp = reinterpret_cast<float2*>(
        part + (((int64_t)item.bh * Sq + row) * n_spans + span) * (HDV + 2));
    const float2* s2 = reinterpret_cast<const float2*>(sr);
    for (int i = lane; i < (HDV + 2) / 2; i += 32) pp[i] = s2[i];
  }
}

// the combine of the span design's partials: rows of R = kCombineThreads
// / (HDV / 2) a CTA, one grid row per b*h; launched with programmatic
// stream serialization, so its launch overlaps the span kernel's tail (it
// waits for that grid's end before it reads anything)
template <typename T, int HDV>
int launch_combine(const void* scratch, void* out, int B, int Sq, int Skv,
                   int H, int q_offset, int causal, int window, int n_spans,
                   cudaStream_t stream) {
  constexpr int R = kCombineThreads / (HDV / 2);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + R - 1) / R, B * H);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_combine_kernel<T, HDV>, static_cast<const float*>(scratch),
      static_cast<T*>(out), Sq, Skv, H, q_offset, causal, window, n_spans));
}

template <typename T, int HD, int HDV>
int launch_span(const void* q, const void* k, const void* v, void* out,
                void* scratch, int B, int Sq, int Skv, int H, int Kh,
                int q_offset, int causal, int window, float scale, int span,
                int smem, cudaStream_t stream) {
  constexpr size_t bytes = span_smem<T, HD, HDV>();
  static_assert(bytes <= kMaxSmem, "tiles do not fit in shared memory");
  if (span != kSpan || smem != static_cast<int>(bytes) || !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      flash_span_kernel<T, HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_spans = Skv > kSpan ? (Skv + kSpan - 1) / kSpan : 1;
  const int n_items = count_items<span_tile<T, HD>()>(
      Sq, Skv, q_offset, causal, window, B * H);
  if (n_items > 0) {
    flash_span_kernel<T, HD, HDV><<<n_items, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<float*>(scratch),
        static_cast<T*>(out), Sq, Skv, H, Kh, q_offset, causal, window,
        scale, n_spans, B * H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return launch_combine<T, HDV>(scratch, out, B, Sq, Skv, H, q_offset,
                                causal, window, n_spans, stream);
}

// the span design's item kernel on bf16 (256, 256): flash_wgspan_kernel,
// then the same combine
template <int HD, int HDV>
cudaError_t wgspan_attributes() {
  constexpr size_t bytes = wgspan_smem_bytes<HD, HDV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgspan_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(flash_wgspan_kernel<HD, HDV>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD, int HDV>
int launch_wgspan(const void* q, const void* k, const void* v, void* out,
                  void* scratch, int B, int Sq, int Skv, int H, int Kh,
                  int q_offset, int causal, int window, float scale,
                  int span, int smem, cudaStream_t stream) {
  constexpr size_t bytes = wgspan_smem_bytes<HD, HDV>();
  static_assert(bytes <= kMaxSmem, "tiles do not fit in shared memory");
  // the row maxima are taken on the unscaled scores
  if (span != kSpan || smem != static_cast<int>(bytes) || !scratch ||
      !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = wgspan_attributes<HD, HDV>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_spans = Skv > kSpan ? (Skv + kSpan - 1) / kSpan : 1;
  const int n_items = count_items<kTileKeys>(Sq, Skv, q_offset, causal,
                                             window, B * H);
  if (n_items > 0) {
    flash_wgspan_kernel<HD, HDV><<<n_items, kWgThreads, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(scratch),
        static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Kh, q_offset, causal,
        window, scale, n_spans, B * H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return launch_combine<__nv_bfloat16, HDV>(scratch, out, B, Sq, Skv, H,
                                            q_offset, causal, window,
                                            n_spans, stream);
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Kh, int q_offset, int causal,
           int window, float scale, int smem, cudaStream_t stream) {
  using T = float;
  constexpr size_t bytes = smem_bytes<T, HD, HDV>(kTileKeys);
  static_assert(bytes <= kMaxSmem, "tile does not fit in shared memory");
  if (smem != static_cast<int>(bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_kernel<HD, HDV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Kh,
      q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// the dynamic shared memory flash_wgmma_kernel takes, and the carveout
// that lets wg_min_ctas of it share an SM (at hd 128 two CTAs fill the
// SM's 233,472 B, each with its 1 KB reserve; at (192, 128) two take
// 217,088 B)
template <int HD, int HDV>
cudaError_t wg_attributes() {
  constexpr size_t bytes = wg_smem_bytes<HD, HDV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(flash_wgmma_kernel<HD, HDV>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Skv, int H, int Kh, int q_offset,
                 int causal, int window, float scale, int smem,
                 cudaStream_t stream) {
  constexpr size_t bytes = wg_smem_bytes<HD, HDV>();
  static_assert(bytes <= kMaxSmem, "tiles do not fit in shared memory");
  // the row maxima are taken on the unscaled scores
  if (smem != static_cast<int>(bytes) || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = wg_attributes<HD, HDV>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<HD, HDV><<<grid, kWgThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Kh, q_offset, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (hd, hdv) pairs built: hd == hdv in {16, 32, 64, 128, 256}, and (192,
// 128); kernels/flash_attention.py's HEAD_DIM_PAIRS lists the same.  span
// and smem are the geometry the wrapper computed (kernels/
// flash_attention.py::_geometry): span 0 and smem_bytes for flash_kernel
// (f32, hd <= 64), span 0 and wg_smem_bytes for flash_wgmma_kernel (bf16,
// hd <= 128 and (192, 128), scale > 0), kSpan and span_smem for the span
// kernel (f32 at (128, 128), (192, 128) and (256, 256), bf16 at (256,
// 256), which also take the f32 scratch of B x H x Sq x n_spans partials);
// any other is refused.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* scratch,
                                      int B, int Sq, int Skv, int H, int Kh,
                                      int hd, int hdv, int q_offset,
                                      int causal, int window, float scale,
                                      int dtype, int span, int smem,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_SPAN(T, D, DV)                                                  \
  if (hd == D && hdv == DV)                                                \
    return launch_span<T, D, DV>(q, k, v, out, scratch, B, Sq, Skv, H, Kh, \
                                 q_offset, causal, window, scale, span,    \
                                 smem, s);
#define RT_CASE(D, DV)                                                     \
  if (hd == D && hdv == DV)                                                \
    return span != 0 ? static_cast<int>(cudaErrorInvalidValue)            \
                     : launch<D, DV>(q, k, v, out, B, Sq, Skv, H, Kh,      \
                                     q_offset, causal, window, scale,      \
                                     smem, s);
#define RT_WG(D, DV)                                                       \
  if (hd == D && hdv == DV)                                                \
    return span != 0 ? static_cast<int>(cudaErrorInvalidValue)            \
                     : launch_wgmma<D, DV>(q, k, v, out, B, Sq, Skv, H,    \
                                           Kh, q_offset, causal, window,  \
                                           scale, smem, s);
#define RT_WGS(D, DV)                                                      \
  if (hd == D && hdv == DV)                                                \
    return launch_wgspan<D, DV>(q, k, v, out, scratch, B, Sq, Skv, H, Kh,  \
                                q_offset, causal, window, scale, span,     \
                                smem, s);
  if (dtype == rt::kDtypeF32) {
    RT_CASE(16, 16) RT_CASE(32, 32) RT_CASE(64, 64)
    RT_SPAN(float, 128, 128) RT_SPAN(float, 192, 128)
    RT_SPAN(float, 256, 256)
  } else if (dtype == rt::kDtypeBF16) {
    RT_WG(16, 16) RT_WG(32, 32) RT_WG(64, 64) RT_WG(128, 128)
    RT_WG(192, 128) RT_WGS(256, 256)
  }
#undef RT_WGS
#undef RT_WG
#undef RT_CASE
#undef RT_SPAN
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of flash_wgmma_kernel<hd, hdv> (at (256, 256) flash_wgspan_kernel)
// an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after
// the attributes its launcher sets), or -1 for a pair neither takes
extern "C" int flash_wgmma_occupancy(int hd, int hdv) {
  int n = -1;
#define RT_OCC(D, DV)                                                     \
  if (hd == D && hdv == DV) {                                             \
    if (wg_attributes<D, DV>() != cudaSuccess ||                          \
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
            &n, flash_wgmma_kernel<D, DV>, kWgThreads,                    \
            wg_smem_bytes<D, DV>()) != cudaSuccess)                       \
      return -1;                                                          \
  }
  RT_OCC(16, 16) RT_OCC(32, 32) RT_OCC(64, 64) RT_OCC(128, 128)
  RT_OCC(192, 128)
#undef RT_OCC
  if (hd == 256 && hdv == 256 &&
      (wgspan_attributes<256, 256>() != cudaSuccess ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &n, flash_wgspan_kernel<256, 256>, kWgThreads,
           wgspan_smem_bytes<256, 256>()) != cudaSuccess))
    return -1;
  return n;
}
