// Flash-decode on Hopper: one query token per slot against its KV cache.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/decode_attention.py:
//   decode_attention        (_decode_kernel)        dense (B, Kh, Smax, hd)
//   paged_decode_attention  (_paged_decode_kernel)  pools + block tables
//
// Bound on an H100: bytes.  Each (slot, kv head) reads its cache_len live
// K and V rows once and does 2*G*(hd+hdv) flops per row, far below the
// ~20 flops per byte at which f32 CUDA cores would limit it.  Both designs
// below cut the logical positions into fixed chunks of kChunk (= CHUNK in
// kernels/decode_attention.py), write one partial softmax state (m, l,
// acc[hdv]) per (slot, kv head, live chunk, query row) into an f32 scratch
// tensor the wrapper allocates, and merge the live chunks (those below
// ceil(cache_len / kChunk)) in chunk order into the output, in q's dtype.
// Every sum has a fixed order, so the same inputs give the same bits.
// Positions at or past cache_len are never read, so garbage rows (bucket
// padding, the null block) add exactly zero.  Dense and paged share each
// core and differ only in how a logical position maps to a cache row; the
// chunk boundaries are logical positions that depend neither on Smax nor
// on the block size, so dense, the gather path (a dense call on the
// gathered view) and the paged kernel sum the same rows in the same order
// and their outputs are bit-identical for equal live rows (the engine's
// paged == dense invariant).  A paged CTA reads block_tables[b, p / bs]
// itself.  A wrapper call counts as one launch in build.launches.
//
// The cache may be narrower than the query, as the Pallas kernels allow
// (they widen every q, k and v block to f32 on read): q is f32 or bf16, the
// cache (dense rows or pools) f32, bf16 or float8_e4m3fn, a plain cast with
// no scale, as the reference's kv_dtype="fp8" writes it.  Each core is
// templated on the cache's element type only: K and V are read narrow and
// widened in registers (fp8 through cuda_fp8.h's e4m3x2 -> f16x2, exact, then
// f32), q is read once per CTA into f32 whatever its dtype, and the output
// is written in q's dtype, so the instantiations grow with the cache types
// (three), not with the pairs (six).  Everything after the widening is f32,
// so an f32/f32 or bf16/bf16 call computes what it did before the cache
// type was split from q's.
//
// hd <= 128: one CTA of 4 warps per (b*Kh + kh, chunk), so a slot with a
// long cache spreads over many SMs (a CTA whose chunk starts at or past
// cache_len[b] exits at once); inside a chunk warp w takes the tile of
// kTile = 32 positions [32w, 32w + 32), runs one softmax update a tile and
// query row, and the live tiles merge in tile order into the chunk's
// partial (merge_tiles; decode_mma_plain in kernels/decode_attention.py is
// this order of sums); the combine is folded into the same launch on
// tickets.  Two tile cores, one launch each:
//
// G = H/Kh <= 2 (decode_lane_kernel<KG 1, 2>: qwen1.5-0.5b, deepseek-moe-16b,
// whisper-tiny).  The core it replaced walked each row group's keys one at a
// time (a 3-step shuffle chain a key for q.k at bf16 hd 64, two expf and a
// rescale of acc a key), held 128 bytes of K and V a lane in flight, and
// merged the chunks in a second launch; at qwen1.5-0.5b's bf16 shape it took
// 0.0115 ms for a 0.0044 bound, the q.k chain and the per-key softmax 53 %
// of a CTA's cycles and the combine 0.29 of the device time
// (tools/kernel_stages.py decode), and from f32 to fp8 its time fell by a
// fifth while the bytes fell 4x.  The lane core:
//   * each warp stages its tile's live rows of K and V by bulk asynchronous
//     copies (cp.async.bulk), one a run of rows contiguous in memory (the
//     tile of a dense cache, its part in one block of a paged one),
//     completing on an mbarrier each for K and V, so the chunk's bytes are
//     all in flight at once (2 x CHUNK rows up to 32 KB a CTA, six CTAs an
//     SM; past that, f32 at hd 64 and 128 and bf16 at hd 128, V goes into
//     K's rows once S has read them: lane_smem).  Rows at or past cache_len
//     are neither copied nor read (NaN there changes no bit).  Lane r looks
//     the row at position p0 + r up once (a paged block table read once a
//     row); q's loads go out before the copies;
//   * S with one key a lane on the CUDA cores: lane j reads key row j's
//     16-byte chunks from chunk j on (mod the row's chunks), so the 8 lanes
//     of a shared-memory phase read 8 bank quads, against q's elements of
//     the same chunk, scaled, in shared memory by chunk planes (16-byte
//     steps across the lanes);
//   * the tile's softmax: its max and its sum by xor butterflies over the
//     lanes, one expf a (key, query row), P to shared memory;
//   * P.V by output columns: lane (kq, c) reads its EPL elements of the
//     tile's V rows kq, kq + KS, ... (the warp reads whole rows, conflict
//     free) with their P, 8 rows' loads at a time; below hd 64 the KS key
//     groups add by an xor butterfly;
//   * the combine folded in as on the mma core (merge_fold): after the
//     partial a ticket of its (b, kh); the CTA that takes the last merges
//     the chunks in chunk order with decode_combine_plain's sums, its acc
//     loaded 8 chunks deep (fold_deep: two outputs a thread at most), every
//     chunk's m and l gathered once;
//   * everything after the widening is f32, and the output is rounded once:
//     an f32 query holds 3e-5 against the plain version over every cache, a
//     bf16 one a bf16 ulp (or 5e-3).
//   Every (hd, cache type) runs it: timed against the split core in turns
//   at each instantiation (hd 16, 32, 64 and 128 at G 1 and 2 over each
//   cache type), none lost: 0.0064-0.0287 ms against 0.0089-0.0329, the
//   closest qwen1.5-0.5b's f32 dense call, 0.0134 against 0.0136.
//   Measured on an H100 at qwen1.5-0.5b's shape (B 8, 16 heads of 64, 3551
//   live rows; tools/kernel_stages.py decode, the designs in turns with the
//   split core): 16-byte cp.async copies, K and V of a warp's tile together,
//   0.0127 ms against the split core's 0.0112 at bf16 (the copies' issue,
//   16 a lane, took 4,533 cycles); the mma core run at G <= 2 (the group
//   as N = 8, 7 of 8 rows wasted at G = 1) 0.0141-0.0153; one bulk copy a
//   run of rows 0.0106 (f32 0.0150 against 0.0134: 64 KB CTAs in two
//   waves); V into K's rows past 32 KB a CTA and the fold's loads 8 deep
//   0.0108 against 0.0118, and at f32 0.0133 against 0.0137; P.V's loop
//   bounded by the tile's live keys and q's loads ahead of the copies
//   0.0090 against 0.0116, paged 0.0090 against 0.0138 (kept); the ticket
//   taken at a CTA's start and the partials published by flags, the fold
//   waiting for them, 0.0093 against 0.0090 (thread 0 waited ~700 cycles
//   for the atomic's return; left out).  The bound is 0.0044 (bytes): what
//   holds it now is a CTA's serial chain (the copies' issue and K's wait,
//   about 2,800 of 8,700 cycles; the merge, the ticket and the fold about
//   2,600), not the bytes (f32 q over fp8 0.0087 for a 0.0022 bound).
//
// G >= 3 (decode_mma_kernel, one launch: the KG 4 and 8 instantiations,
// qwen1.5-110b's G = 8, jamba's and llama-3.2-vision's G = 4).  On the core
// the lane core replaced, each key cost every query row a 5-step shuffle
// chain (hd 128 f32), two expf and a rescale of acc, on all 32 lanes: at G
// = 8 40 dependent shuffles and 16 expf a key and warp, 86 % of a CTA's
// cycles (tools/kernel_stages.py decode), so its time followed G, not the
// bytes (0.0555 ms at f32, 0.0363 over bf16 and 0.0360 over fp8 for bounds
// of 0.0057, 0.0029 and 0.0015).  The mma core computes a kv head's group
// as one tensor-core product per 16 keys, as the Pallas kernel's q @ k.T:
//   * each warp stages its 32-key tile in two slots of 16 rows by 16-byte
//     cp.async: K's rows first, then each slot's V once S^T has read its K
//     (CHUNK rows a CTA: 64 KB at f32 hd 128, three CTAs an SM; mma_smem).
//     A row at or past cache_len is zero-filled, never read (P = 0 alone
//     would not do: 0 * NaN is NaN).  Lane r looks the row at position p0 +
//     r up once (a paged block table read once a row) and the copies take
//     it by a shuffle.  The 16-byte chunks are XOR-swizzled by row bits 0
//     and 1 (swz), one layout for both reads below, free of bank conflicts;
//   * S^T = K_tile Q^T on m16n8k8 TF32 mma.sync: 16 keys as M, the group
//     as N = 8 (G = 8 fills it, G = 4 half; rows past G are q = 0, never
//     written), hd as K.  Lane (g, t) reads 16-byte vectors of key rows g
//     and g + 8 at element (4j + t) EK; each vector's pairs of elements are
//     the columns t and t + 4 of a k-step, and q's row g the same elements,
//     so every element of hd meets its own once (the product's order of hd
//     is a permutation, its sum the same).  The big.big terms and the small
//     ones run in two accumulator chains;
//   * one softmax update a tile and query row: the row's max over its 32
//     keys from the accumulators (4 a lane, then a 3-step xor butterfly),
//     one expf a (key, row), the sum likewise; no online rescale inside a
//     warp, whose tile is one update;
//   * P leaves the accumulators' layout (key, row) for the B fragments'
//     (row, key) through 1 KB of shared memory a warp; O^T += V^T P^T on the
//     same products, 16 output columns as M (lane (g, t) reads key rows t
//     and t + 4, vector j at element (8j + g) EV), the group as N, 8 keys
//     as K;
//   * f32 accuracy: q (scaled) and P enter as TF32 big + small halves.  A
//     bf16 or fp8 value is exact in TF32 (10 mantissa bits), so over a
//     narrow cache K and V need no split: 2 products where an f32 cache
//     takes 3 (3xTF32), small terms first.  Every product sums in f32; an
//     f32 query holds 3e-5 against the plain version over every cache, a
//     bf16 one a bf16 ulp (or 5e-3): the output is rounded once, at the
//     end;
//   * the warps' O^T fragments go to shared memory over their slots, and
//     the live tiles merge in tile order into the chunk's partial, as on
//     the lane core (decode_mma_plain in kernels/decode_attention.py is
//     this order of sums);
//   * the combine is folded in, as at hd 256: after writing its partial a
//     CTA takes a ticket of its (b, kh) (B x Kh int32 counters, zeroed once
//     by the wrapper); the one that takes the last merges the slot's live
//     chunks in chunk order with decode_combine_plain's sums (so the bits
//     a separate combine would give on these partials), every live chunk's
//     m and l gathered into shared memory at once, and sets the counter back
//     to 0.  The atomic decides only who merges, never an order of summation;
//     calls must be ordered on one stream.  An empty slot's zeros come from
//     its chunk-0 CTA.
//   Measured on an H100 at G = 8, f32 (0.0057 ms bound; tools/kernel_stages
//   .py decode, the designs in turns): the split core 0.0555; both of a
//   warp's tiles resident (128 KB a CTA, one an SM), the separate combine
//   0.0318; one bulk copy (cp.async.bulk) a row into rows padded in place
//   of the swizzle 0.0370 (their issue, one 512-byte request at a time,
//   took 3,828 cycles against 1,736); 16-key tiles, 8 warps a CTA, on that
//   design 0.0335 (slower over bf16); the two-slot ring 0.0270; the combine
//   folded in 0.0231; q read by vectors and the fold's gathers in parallel
//   0.0226 (kept); the fold's acc loads eight chunks deep 0.0235 against
//   0.0224 in turns (144 registers against 128; left out).  What bounds it
//   now is a CTA's serial chain (the copies' issue under three CTAs an SM,
//   S^T, V's wait, the merge, the ticket and the fold), not the bytes.
//
// hd = 256 (gemma3; decode_cluster_kernel, one CUDA launch).  There a
// 128-position chunk is 256 KB of f32 K and V, and one CTA per chunk left
// 18-31 CTAs streaming on 132 SMs with 8 KB in flight each (17-27x the
// bound on an H100), and a combine of one CTA per (b, kh).  So:
//   * each chunk is split across a thread-block cluster of kCluster = 4
//     CTAs (cudaLaunchKernelEx with a cluster dimension); CTA rank r takes
//     the fixed slice of kSlice = 32 positions [c0 + 32r, c0 + 32r + 32).
//     The chunk boundaries do not move, so paged == dense holds as above; a
//     CTA whose slice starts at or past cache_len loads and computes nothing
//     but still takes its part of the merge;
//   * a slice's live K rows, then its V rows, are staged in shared memory
//     by bulk asynchronous copies (cp.async.bulk, completing on one
//     mbarrier for K and one for V, each used for one phase, so a ragged
//     slice only changes the byte count the barrier expects): one copy per
//     run of rows contiguous in memory, the whole live slice in a dense
//     cache or its part in one block of a paged one, issued by the lane
//     that starts the run (a copy per row made the copies' issue the
//     largest stage of the kernel).  Every live slice has all its bytes in
//     flight at once: 64 KB (f32) per CTA, the whole live cache across the
//     card;
//   * S for the slice is computed once: warp w takes columns [64w, 64w+64)
//     of q.k for key `lane`, lane j reading its 16-byte vectors from (j mod
//     the vectors' count) on, so the 8 lanes of a shared-memory phase hit
//     different bank quads of the unpadded rows; the four column sums are
//     added in warp order, warp g then takes query row g's softmax over
//     the slice (max and sum by xor butterflies, identical on every lane),
//     and each thread accumulates P.V for two output columns over the
//     slice's live keys in key order;
//   * the cluster merges its slices through distributed shared memory
//     (cluster.map_shared_rank; each rank's m and l gathered once, the four
//     accumulators loaded together), live slices in rank order: CTA r
//     merges output columns [64r, 64r + 64) of every query row into the
//     chunk's one partial (m, l, acc), which means what it means at hd <=
//     128 (every CTA writes the chunk's m and l, the same bits);
//   * the combine is folded in: after writing its columns of the partial,
//     each CTA takes a ticket from a counter of its (b, kh, rank) (one
//     atom.add.acq_rel.gpu after a CTA barrier, so the partial is published
//     before the ticket); the CTA that takes the last one merges its 64
//     columns over every live chunk in chunk order, with the sums of
//     decode_combine_plain, and sets the counter back to 0 for the next
//     call.  The atomic decides only who merges, never an order of
//     summation, so the bits stay fixed.  The counters (B x Kh x 4 int32,
//     zeroed once by the wrapper) are why calls must be ordered on one
//     stream.  An empty slot's output (0) is written by its chunk-0 cluster.
//     A split cluster barrier (arrive after the merge's remote reads, wait
//     before exit) keeps every CTA's shared memory alive while the others
//     read it;
// Shared memory of decode_cluster_kernel (wide_smem, dynamic): two 8-byte
// mbarriers in 16 bytes; K and V 32 x HD each; in f32: q (KG x 256), the
// warps' partial scores (4 x KG x 32), P (KG x 32), the CTA's acc (KG x
// 256), m and l (2 x KG).  f32 KG = 4: 16 + 65,536 + 10,784 = 76,336 B;
// bf16: 43,568 B; fp8: 27,184 B.  The bound stays bytes: gemma3-1b's
// phase-3 shapes read 4.2 MB (ring) and 7.3 MB (global) of f32 K and V,
// 1.3 and 2.2 us at 3.35 TB/s.  On an H100 the kernel's time is a chain
// of latencies, not bandwidth (tools/kernel_stages.py times each stage):
// the copies are issued, the slice lands, then S and the softmax, P.V,
// the cluster barrier and merge, and the ticket and folded combine each
// take 500-2,500 cycles.
#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kChunk = 128;                 // positions per chunk
constexpr int kPerWarp = kChunk / kWarps;   // positions per warp (hd <= 128)
constexpr int kMaxG = 8;                    // query rows per kv head
constexpr int kWideHD = 256;                // head size of the cluster core
constexpr int kCluster = 4;                 // CTAs per chunk at hd 256
constexpr int kSlice = kChunk / kCluster;   // positions per CTA at hd 256

using fp8 = __nv_fp8_e4m3;

// two e4m3 values (the low byte first) to f32, exactly: e4m3 -> f16 holds
// every value, and f16 -> f32 too
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t x) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(x),
                                 __NV_E4M3);
  return __half22float2(__half2(h));
}

// the 32-bit words of a loaded vector
__device__ __forceinline__ void words(const uint4& u, uint32_t* w) {
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}
__device__ __forceinline__ void words(const uint2& u, uint32_t* w) {
  w[0] = u.x;
  w[1] = u.y;
}

__device__ __forceinline__ void words(const uint32_t& u, uint32_t* w) {
  w[0] = u;
}

// a vector of sizeof(V) bytes of T, widened to f32 into f[0, sizeof(V) /
// sizeof(T))
template <typename T, typename V>
__device__ __forceinline__ void widen(const V& u, float* f) {
  constexpr int NW = sizeof(V) / 4;
  uint32_t w[NW];
  words(u, w);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(T) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);         // bf16 -> f32 exactly
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      const float2 a = fp8x2_to_float2(w[i] & 0xffffu);
      const float2 b = fp8x2_to_float2(w[i] >> 16);
      f[4 * i] = a.x;
      f[4 * i + 1] = a.y;
      f[4 * i + 2] = b.x;
      f[4 * i + 3] = b.y;
    }
  }
}

// element i of q, f32 or bf16 by the call's query dtype
__device__ __forceinline__ float load_q(const void* q, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}
// N elements of q (a multiple of 4) from element i, to f32: by 16- or
// 8-byte vectors where q is 16-byte aligned (i a multiple of 4)
template <int N>
__device__ __forceinline__ void load_q_vec(const void* q, int64_t i,
                                           bool bf16, float* f) {
  const bool vec = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    if (vec && bf16) {
      widen<__nv_bfloat16>(
          *reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(q) + i + e),
          f + e);
    } else if (vec) {
      const float4 x =
          *reinterpret_cast<const float4*>(static_cast<const float*>(q) + i +
                                           e);
      f[e] = x.x;
      f[e + 1] = x.y;
      f[e + 2] = x.z;
      f[e + 3] = x.w;
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) f[e + x] = load_q(q, i + e + x, bf16);
    }
  }
}
// element i of the output, in q's dtype
__device__ __forceinline__ void store_out(void* out, int64_t i, float x,
                                          bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

// the cache row of logical position p of (b, kh)
template <bool PAGED>
__device__ __forceinline__ int64_t cache_row(const int* tables, int b, int kh,
                                             int Kh, int rows, int M, int p) {
  if (PAGED) {
    const int64_t pid = tables[(int64_t)b * M + p / rows];
    return (pid * Kh + kh) * rows + p % rows;
  }
  return ((int64_t)b * Kh + kh) * rows + p;
}

// the ticket counters that fold the combine into every core
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// mbarriers and bulk copies (the cluster core)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait for the barrier's phase 0 to complete (each barrier is used once)
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}
// bytes (a multiple of 16) from global src to this CTA's shared dst,
// completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// hd <= 128 at G >= 3: a kv head's query rows as one tensor-core product
// ---------------------------------------------------------------------------

constexpr int kTile = 32;                  // keys of a warp: one tile
constexpr int kTileWarps = kChunk / kTile;  // warps of a CTA
constexpr int kMI = kTile / 16;            // a tile's M tiles (slots)
constexpr int kN = kMaxG;                     // query rows of a product
constexpr int kFold = 32;     // chunks whose scales the folded combine holds

// byte offset of (row, byte) in a slot of rows of RB bytes; where a row
// holds 8 or more 16-byte chunks they are XOR-swizzled by bits 0 and 1 of
// the row (bit 2 of the chunk by row bit 0, bit 1 by row bit 1), so that
// the K fragment reads (rows g and g + 1, four chunks each, a phase) and
// the V reads (rows t = 0-3, two chunks each) both hit 8 bank quads
template <int RB>
__device__ __forceinline__ int swz(int row, int byte) {
  if constexpr (RB >= 128)
    return row * RB +
           (((byte >> 4) ^ (((row & 1) << 2) | (row & 2))) << 4) +
           (byte & 15);
  else
    return row * RB + byte;
}

// VB bytes of T in shared memory, widened to f32 into f[0, VB / sizeof(T))
template <typename T, int VB>
__device__ __forceinline__ void load_wide(const unsigned char* p, float* f) {
  if constexpr (VB == 16) {
    widen<T>(*reinterpret_cast<const uint4*>(p), f);
  } else if constexpr (VB == 8) {
    widen<T>(*reinterpret_cast<const uint2*>(p), f);
  } else if constexpr (VB == 4) {
    widen<T>(*reinterpret_cast<const uint32_t*>(p), f);
  } else {
    static_assert(VB == 2 && sizeof(T) == 1, "two fp8 values");
    const float2 x = fp8x2_to_float2(*reinterpret_cast<const uint16_t*>(p));
    f[0] = x.x;
    f[1] = x.y;
  }
}

// a b on m16n8k8 TF32 products, b given as big + small halves, added to d
// (its big.big terms) and e (its small terms): a in TF32 exactly (a bf16 or
// fp8 cache) as 2 products, else (f32) split too, as 3 (3xTF32).  With
// e == d the terms sum in one chain, small terms first
template <bool EXACT>
__device__ __forceinline__ void mma_x(float (&d)[4], float (&e)[4],
                                      const float (&a)[4], uint32_t bb0,
                                      uint32_t bb1, uint32_t bs0,
                                      uint32_t bs1) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (EXACT)
      ab[i] = __float_as_uint(a[i]);
    else
      rt::split(a[i], ab[i], as[i]);
  }
  if constexpr (!EXACT) rt::mma_tf32(e, as, bb0, bb1);
  rt::mma_tf32(e, ab, bs0, bs1);
  rt::mma_tf32(d, ab, bb0, bb1);
}

// The live tiles of a chunk's CTA on a tile core (decode_lane_kernel,
// decode_mma_kernel: warps w < nlive, each with its state wm[w], wl[w] and
// its O, NR x HD f32 at wo + w * wstride bytes) merged in tile order into
// the chunk's partial (m, l, acc[HD]) per query row g < G at pc, as
// decode_partials_plain writes it: thread g takes row g's max, the tiles'
// scales and l first
template <int HD, int NR>
__device__ __forceinline__ void merge_tiles(
    float (&wm)[kTileWarps][NR], const float (&wl)[kTileWarps][NR],
    const unsigned char* wo, int wstride, int nlive, int G,
    float* __restrict__ pc) {
  if ((int)threadIdx.x < G) {
    const int gg = threadIdx.x;
    float mx = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w)
      if (w < nlive) mx = fmaxf(mx, wm[w][gg]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      if (w < nlive) {
        const float cw = expf(wm[w][gg] - mx);
        wm[w][gg] = cw;
        L += wl[w][gg] * cw;
      }
    }
    pc[gg * (HD + 2)] = mx;
    pc[gg * (HD + 2) + 1] = L;
  }
  __syncthreads();
  constexpr int NT = kTileWarps * 32;
#pragma unroll
  for (int e = 0; e < (NR * HD + NT - 1) / NT; ++e) {
    const int i = threadIdx.x + e * NT;
    if (i < G * HD) {
      const int gg = i / HD, d = i % HD;
      float O = 0.f;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w)
        if (w < nlive)
          O += reinterpret_cast<const float*>(wo + w * wstride)[gg * HD + d] *
               wm[w][gg];
      pc[gg * (HD + 2) + 2 + d] = O;
    }
  }
}

// The combine, folded in: the CTA of a (b, kh) that takes its last ticket
// merges the partials of its live chunks (pb, one chunk stride floats
// apart) in chunk order, with the sums of decode_combine_plain, into the
// output (out from element o0, q's dtype).  kFold chunks at a time, every thread loads one
// chunk's m (then m and l) of one query row; thread g takes row g's max
// over the chunks and its l sum, every thread its outputs' acc sums.  Loads
// bypass L1: other SMs wrote the partials
template <int HD, int NR>
__device__ __forceinline__ void fold_chunks(const float* __restrict__ pb,
                                            int live, int G,
                                            void* __restrict__ out,
                                            int64_t o0, bool q_bf16) {
  __shared__ float sc[kFold][NR];   // the folded combine's m, scales
  __shared__ float sl[kFold][NR];   // and l, kFold chunks at a time
  __shared__ float sM[NR];
  __shared__ float sL[NR];
  constexpr int NT = kTileWarps * 32;
  const int64_t stride = (int64_t)G * (HD + 2);    // one chunk to the next
  constexpr int PER = (NR * HD + NT - 1) / NT;
  float mx = rt::kNegInf, L = 0.f, Oc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) Oc[e] = 0.f;
  for (int f0 = 0; f0 < live; f0 += kFold) {
    const int nc = min(kFold, live - f0);
    for (int x = threadIdx.x; x < nc * G; x += NT)
      sc[x / G][x % G] =
          __ldcg(pb + (f0 + x / G) * stride + (x % G) * (HD + 2));
    __syncthreads();
    if ((int)threadIdx.x < G)
      for (int c = 0; c < nc; ++c) mx = fmaxf(mx, sc[c][threadIdx.x]);
    __syncthreads();
  }
  if ((int)threadIdx.x < G) sM[threadIdx.x] = mx;
  __syncthreads();
  for (int f0 = 0; f0 < live; f0 += kFold) {
    const int nc = min(kFold, live - f0);
    for (int x = threadIdx.x; x < nc * G; x += NT) {
      const float* pp = pb + (f0 + x / G) * stride + (x % G) * (HD + 2);
      sc[x / G][x % G] = expf(__ldcg(pp) - sM[x % G]);
      sl[x / G][x % G] = __ldcg(pp + 1);
    }
    __syncthreads();
    if ((int)threadIdx.x < G)
      for (int c = 0; c < nc; ++c)
        L += sl[c][threadIdx.x] * sc[c][threadIdx.x];
#pragma unroll 2
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = threadIdx.x + e * NT;
        if (i < G * HD)
          Oc[e] += __ldcg(pb + (f0 + c) * stride + (i / HD) * (HD + 2) + 2 +
                          i % HD) *
                   sc[c][i / HD];
      }
    }
    __syncthreads();                          // sc, sl read before the next
  }
  if ((int)threadIdx.x < G) sL[threadIdx.x] = L;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * NT;
    if (i < G * HD)
      store_out(out, o0 + i, Oc[e] / fmaxf(sL[i / HD], 1e-30f), q_bf16);
  }
}

// The fold where the live chunks fit in kFold and each thread holds few
// outputs (PER <= 2): each thread loads its acc kDeep chunks at a time,
// the first group before every chunk's m and l (gathered once): one round
// trip to L2 up to kDeep chunks.  The same sums, in the same order, as
// fold_chunks
template <int HD, int NR>
__device__ __forceinline__ void fold_deep(const float* __restrict__ pb,
                                          int live, int G,
                                          void* __restrict__ out, int64_t o0,
                                          bool q_bf16) {
  __shared__ float sc[kFold][NR];   // m, then the scales
  __shared__ float sl[kFold][NR];   // l
  __shared__ float sL[NR];
  constexpr int NT = kTileWarps * 32;
  const int64_t stride = (int64_t)G * (HD + 2);    // one chunk to the next
  constexpr int PER = (NR * HD + NT - 1) / NT;
  constexpr int kDeep = 8;
  float a[kDeep][PER];
  auto load = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kDeep; ++u)
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = threadIdx.x + e * NT;
        a[u][e] = c0 + u < live && i < G * HD
                      ? __ldcg(pb + (c0 + u) * stride +
                               (i / HD) * (HD + 2) + 2 + i % HD)
                      : 0.f;
      }
  };
  load(0);
  for (int x = threadIdx.x; x < live * G; x += NT) {
    const float* pp = pb + (x / G) * stride + (x % G) * (HD + 2);
    sc[x / G][x % G] = __ldcg(pp);
    sl[x / G][x % G] = __ldcg(pp + 1);
  }
  __syncthreads();
  if ((int)threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = rt::kNegInf, L = 0.f;
    for (int c = 0; c < live; ++c) mx = fmaxf(mx, sc[c][g]);
    for (int c = 0; c < live; ++c) {
      const float cs = expf(sc[c][g] - mx);
      sc[c][g] = cs;
      L += sl[c][g] * cs;
    }
    sL[g] = L;
  }
  __syncthreads();
  float Oc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) Oc[e] = 0.f;
  for (int c0 = 0;;) {
#pragma unroll
    for (int u = 0; u < kDeep; ++u)
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = threadIdx.x + e * NT;
        if (c0 + u < live && i < G * HD)
          Oc[e] += a[u][e] * sc[c0 + u][i / HD];
      }
    c0 += kDeep;
    if (c0 >= live) break;
    load(c0);
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * NT;
    if (i < G * HD)
      store_out(out, o0 + i, Oc[e] / fmaxf(sL[i / HD], 1e-30f), q_bf16);
  }
}

// The end of a CTA of a tile core (decode_lane_kernel, decode_mma_kernel):
// its tiles merged into the chunk's partial, then a ticket of its (b, kh)
// (B x Kh int32 counters, zeroed once by the wrapper): the CTA that takes
// the last one folds the combine in and sets the counter back to 0 for the
// next call.  The atomic decides only who merges, never an order of
// summation.  Where a thread holds at most two outputs (the lane core's KG
// <= 2 rows, the mma core's below hd 64) the fold loads its acc kDeep
// chunks deep (fold_deep), else a chunk at a time (fold_chunks: at G = 8
// hd 128 the deep loads took 144 registers and ran slower).  fold_deep
// against fold_chunks alone, in turns on an H100 (tools/kernel_stages.py
// decode, the chunks variant; the same bits): qwen1.5-0.5b bf16 0.0095 ms
// against 0.0107, paged 0.0099 against 0.0111; deepseek-moe-16b's hd 128
// 0.0274 against 0.0289; whisper's cross 0.0127 against 0.0140; the mma
// core at hd 32, G = 8 0.0105 against 0.0110
template <int HD, int NR>
__device__ __forceinline__ void merge_fold(
    float (&wm)[kTileWarps][NR], const float (&wl)[kTileWarps][NR],
    const unsigned char* wo, int wstride, int nlive, int len, int G,
    float* __restrict__ part, int* __restrict__ tickets,
    void* __restrict__ out, int bkh, int b, int kh, int H, int nch,
    int chunk, bool q_bf16) {
  __shared__ int last;
  merge_tiles<HD, NR>(wm, wl, wo, wstride, nlive, G,
                      part + ((int64_t)bkh * nch + chunk) * G * (HD + 2));
  const int live = (len + kChunk - 1) / kChunk;
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomic_add_acq_rel(tickets + bkh, 1) == live - 1;
    if (last) tickets[bkh] = 0;
  }
  __syncthreads();
  if (!last) return;
  const float* pb = part + (int64_t)bkh * nch * G * (HD + 2);
  const int64_t o0 = ((int64_t)b * H + kh * G) * HD;
  constexpr int PER = (NR * HD + kTileWarps * 32 - 1) / (kTileWarps * 32);
  if (PER <= 2 && live <= kFold)
    fold_deep<HD, NR>(pb, live, G, out, o0, q_bf16);
  else
    fold_chunks<HD, NR>(pb, live, G, out, o0, q_bf16);
}

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kTileWarps * 32)
decode_mma_kernel(const void* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ cache_len,
                  const int* __restrict__ tables, float* __restrict__ part,
                  int* __restrict__ tickets, void* __restrict__ out, int H,
                  int Kh, int rows, int M, int nch, float scale,
                  bool q_bf16) {
  constexpr int RB = HD * sizeof(T);          // bytes of a cache row
  constexpr int CH = RB / 16;                 // its 16-byte chunks
  constexpr int SLOT = 16 * RB;               // 16 rows: an M tile of keys
  constexpr bool kExact = sizeof(T) < 4;      // bf16, fp8: exact in TF32
  // S^T: lane (g, t) reads vectors of VK bytes of key rows g and g + 8,
  // vector j at element (4 j + t) EK; k-step (j, h) takes its elements 2h
  // and 2h + 1 as the columns t and t + 4 of the product, and q's row g the
  // same elements, so every element of hd meets its own in q once
  constexpr int VK = RB / 4 < 16 ? RB / 4 : 16;
  constexpr int EK = VK / sizeof(T);
  constexpr int NK = HD / (4 * EK);
  // O^T: lane (g, t) reads vectors of VV bytes of key rows t and t + 4,
  // vector j at element (8 j + g) EV; M tile (j, h) takes its elements 2h
  // and 2h + 1 as the rows g and g + 8 of V^T
  constexpr int VV = RB / 8 < 16 ? RB / 8 : 16;
  constexpr int EV = VV / sizeof(T);
  constexpr int NV = HD / (8 * EV);
  constexpr int MT = HD / 16;                 // M tiles of O^T
  static_assert(RB % 16 == 0 && EK >= 4 && EV >= 2 && NK * 4 * EK == HD &&
                    NV * 8 * EV == HD && kN == 8 && kMI == 2 &&
                    kN * HD * 4 <= kMI * SLOT,
                "layout");
  extern __shared__ __align__(16) unsigned char smem[];  // per warp: slots
  __shared__ float wm[kTileWarps][kN];
  __shared__ float wl[kTileWarps][kN];
  // P of each warp's tile (read and written as float2: 8-byte aligned)
  __shared__ __align__(8) float ps[kTileWarps][kTile][kN];

  const int bkh = blockIdx.x;
  const int b = bkh / Kh;
  const int kh = bkh % Kh;
  const int chunk = blockIdx.y;
  const int G = H / Kh;
  const int cap = PAGED ? M * rows : rows;
  const int len = min(cache_len[b], cap);
  const int c0 = chunk * kChunk;
  if (c0 >= len) {                            // dead chunk: the whole CTA
    if (len <= 0 && chunk == 0)               // an empty slot's output is 0
      for (int i = threadIdx.x; i < G * HD; i += blockDim.x)
        store_out(out, ((int64_t)b * H + kh * G) * HD + i, 0.f, q_bf16);
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int p0 = c0 + warp * kTile;        // the warp's first position
  const int n = max(0, min(kTile, len - p0));   // its live rows
  const int nlive = min(kTileWarps, (len - c0 + kTile - 1) / kTile);
  unsigned char* tile = smem + warp * kMI * SLOT;

  // q's row g first (rows past G are 0), so that its loads do not queue
  // behind the tile's; and lane r's cache row (position p0 + r), looked up
  // once
  float qv[NK * EK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (g < G)
      load_q_vec<EK>(q, ((int64_t)b * H + kh * G + g) * HD + (4 * j + t) * EK,
                     q_bf16, qv + j * EK);
    else
#pragma unroll
      for (int e = 0; e < EK; ++e) qv[j * EK + e] = 0.f;
  }
  const int64_t my_row =
      lane < n ? cache_row<PAGED>(tables, b, kh, Kh, rows, M, p0 + lane) : 0;
  // the 16 rows 16 mi.. of src into slot mi, 16-byte copies; a row at or
  // past len is zero-filled, never read (P = 0 alone would not do: 0 * NaN
  // is NaN)
  auto stage = [&](const T* src, int mi) {
    unsigned char* dst = tile + mi * SLOT;
#pragma unroll 4
    for (int i0 = 0; i0 < 16 * CH; i0 += 32) {
      const int i = i0 + lane, r = (i / CH) & 15, c = i % CH;
      const int64_t row = __shfl_sync(rt::kFull, my_row, 16 * mi + r);
      if (i < 16 * CH)
        rt::cp_async16(dst + swz<RB>(r, 16 * c),
                       reinterpret_cast<const unsigned char*>(src + row * HD) +
                           16 * c,
                       16 * mi + r < n);
    }
    rt::cp_async_commit();
  };
  // K's M tiles, then each tile's V into its slot once S^T has read it
  if (n > 0) {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) stage(k, mi);
  }
  // q, scaled, as the B fragments' big and small halves
  uint32_t qb[NK * EK], qs[NK * EK];
#pragma unroll
  for (int i = 0; i < NK * EK; ++i) rt::split(qv[i] * scale, qb[i], qs[i]);

  if (n > 0) {
    // S^T (keys x query rows) for the tile's M tiles mi: keys 16 mi + g and
    // 16 mi + g + 8, query rows 2t and 2t + 1; the big.big terms and the
    // small ones in two chains
    float s[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      rt::cp_async_wait<kMI - 1>();           // this M tile's K
      __syncwarp();
      const unsigned char* ks = tile + mi * SLOT;
      float sl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[mi][i] = sl[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float ka[EK], kb[EK];
        load_wide<T, VK>(ks + swz<RB>(g, (4 * j + t) * VK), ka);
        load_wide<T, VK>(ks + swz<RB>(g + 8, (4 * j + t) * VK), kb);
#pragma unroll
        for (int h = 0; h < EK / 2; ++h) {
          const float a[4] = {ka[2 * h], kb[2 * h], ka[2 * h + 1],
                              kb[2 * h + 1]};
          const int e = j * EK + 2 * h;
          mma_x<kExact>(s[mi], sl, a, qb[e], qb[e + 1], qs[e], qs[e + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[mi][i] += sl[i];
      __syncwarp();                           // every lane read the slot
      stage(v, mi);
    }
    // one softmax update a tile and query row: positions at or past len
    // take the finite mask; the row's max over the tile's keys and its sum
    // by xor butterflies over g (the same bits on every lane)
    float m[2], l[2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (16 * mi + g + 8 * hh >= n)
          s[mi][2 * hh] = s[mi][2 * hh + 1] = rt::kNegInf;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = rt::kNegInf;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        x = fmaxf(x, fmaxf(s[mi][r], s[mi][2 + r]));
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        x = fmaxf(x, __shfl_xor_sync(rt::kFull, x, o));
      m[r] = x;
      float y = 0.f;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p = expf(s[mi][2 * hh + r] - x);
          s[mi][2 * hh + r] = p;
          y += p;
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) y += __shfl_xor_sync(rt::kFull, y, o);
      l[r] = y;
    }
    // P from the accumulators' layout (key, row) into the B fragments'
    // (row g, key t), through shared memory
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(&ps[warp][16 * mi + g + 8 * hh][2 * t]) =
            make_float2(s[mi][2 * hh], s[mi][2 * hh + 1]);
    // O^T (columns x query rows) += V^T P^T over the tile's 8-key k-steps,
    // two to a slot
    float o[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      if (kk % 2 == 0) {
        if (kk / 2 + 1 < kMI)
          rt::cp_async_wait<1>();             // this slot's V
        else
          rt::cp_async_wait<0>();
        __syncwarp();                         // and every lane's P
      }
      const unsigned char* vs = tile + (kk / 2) * SLOT;
      const int r0 = 8 * (kk % 2) + t;        // key rows r0, r0 + 4
      uint32_t pb0, pb1, ps0, ps1;
      rt::split(ps[warp][8 * kk + t][g], pb0, ps0);
      rt::split(ps[warp][8 * kk + t + 4][g], pb1, ps1);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float va[EV], vb[EV];
        load_wide<T, VV>(vs + swz<RB>(r0, (8 * j + g) * VV), va);
        load_wide<T, VV>(vs + swz<RB>(r0 + 4, (8 * j + g) * VV), vb);
#pragma unroll
        for (int h = 0; h < EV / 2; ++h) {
          const float a[4] = {va[2 * h], va[2 * h + 1], vb[2 * h],
                              vb[2 * h + 1]};
          float(&acc)[4] = o[j * (EV / 2) + h];
          mma_x<kExact>(acc, acc, a, pb0, pb1, ps0, ps1);
        }
      }
    }
    // the warp's state: m and l of rows 2t and 2t + 1, and O (kN x HD)
    // over its slots, which no lane reads any more
    __syncwarp();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wm[warp][2 * t + r] = m[r];
        wl[warp][2 * t + r] = l[r];
      }
    }
    float* wo = reinterpret_cast<float*>(tile);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int h = 0; h < EV / 2; ++h) {
        const int mt = j * (EV / 2) + h, d = (8 * j + g) * EV + 2 * h;
        *reinterpret_cast<float2*>(wo + 2 * t * HD + d) =
            make_float2(o[mt][0], o[mt][2]);
        *reinterpret_cast<float2*>(wo + (2 * t + 1) * HD + d) =
            make_float2(o[mt][1], o[mt][3]);
      }
  }
  __syncthreads();

  merge_fold<HD, kN>(wm, wl, smem, kMI * SLOT, nlive, len, G, part, tickets,
                     out, bkh, b, kh, H, nch, chunk, q_bf16);
}

// dynamic shared memory of decode_mma_kernel<T, HD, *>: each warp's two
// slots of 16 rows, K's then V's; the wrapper's _geometry computes the same
// and the launcher refuses any other
template <typename T, int HD>
__host__ __device__ constexpr int mma_smem() {
  return kChunk * HD * (int)sizeof(T);
}

// ---------------------------------------------------------------------------
// hd <= 128 at G <= 2: one key a lane on the CUDA cores
// ---------------------------------------------------------------------------

// whether a chunk's K and V rows fit in shared memory together at 32 KB a
// CTA (six CTAs an SM: qwen1.5-0.5b's 496 live CTAs in one wave); else V
// takes K's rows once S has read them
template <typename T, int HD>
__host__ __device__ constexpr bool lane_kv_together() {
  return 2 * kChunk * HD * (int)sizeof(T) <= 32 * 1024;
}
// dynamic shared memory of decode_lane_kernel<T, HD, *, *>: each warp's
// kTile rows of K and of V; the wrapper's _geometry computes the same and
// the launcher refuses any other
template <typename T, int HD>
__host__ __device__ constexpr int lane_smem() {
  return (lane_kv_together<T, HD>() ? 2 : 1) * kChunk * HD * (int)sizeof(T);
}

template <typename T, int HD, int KG, bool PAGED>
__global__ void __launch_bounds__(kTileWarps * 32)
decode_lane_kernel(const void* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ cache_len,
                   const int* __restrict__ tables, float* __restrict__ part,
                   int* __restrict__ tickets, void* __restrict__ out, int H,
                   int Kh, int rows, int M, int nch, float scale,
                   bool q_bf16) {
  constexpr int RB = HD * sizeof(T);          // bytes of a cache row
  constexpr int CH = RB / 16;                 // its 16-byte chunks
  constexpr int VEC = 16 / sizeof(T);         // elements of a chunk
  constexpr int QV = VEC / 4;                 // q's float4s a chunk
  constexpr int TB = kTile * RB;              // a warp's tile of K or V
  constexpr bool kTogether = lane_kv_together<T, HD>();
  // P.V: lane (kq, c) reads elements [EPL c, EPL c + EPL) of the keys kq,
  // kq + KS, ... of the tile; the KS key groups' sums are added by an xor
  // butterfly (KS = 1 from hd 64 up)
  constexpr int EPL = HD / 32 >= 2 ? HD / 32 : 2;
  constexpr int LPR = HD / EPL;               // lanes a row
  constexpr int KS = 32 / LPR;                // key groups
  constexpr int VB = EPL * sizeof(T);         // bytes a lane reads of a row
  constexpr int NT = kTileWarps * 32;
  constexpr int QPT = (KG * HD + NT - 1) / NT;   // q elements a thread
  static_assert(KG <= 2 && (CH & (CH - 1)) == 0 && LPR * KS == 32 &&
                    kTile == 32,
                "layout");
  extern __shared__ __align__(16) unsigned char smem[];  // per warp: K, V
  // q, scaled: element 4h + e of chunk c (VEC elements) at qs[g][h][c].e,
  // so lanes reading chunks c, c + 1, ... read 16-byte steps
  __shared__ __align__(16) float4 qs[KG][QV][CH];
  __shared__ float ps[kTileWarps][KG][kTile];  // P of each warp's tile
  __shared__ float wm[kTileWarps][KG];
  __shared__ float wl[kTileWarps][KG];
  __shared__ __align__(8) uint64_t bars[kTileWarps][2];  // a tile's K, V

  const int bkh = blockIdx.x;
  const int b = bkh / Kh;
  const int kh = bkh % Kh;
  const int chunk = blockIdx.y;
  const int cap = PAGED ? M * rows : rows;
  const int len = min(cache_len[b], cap);
  const int c0 = chunk * kChunk;
  if (c0 >= len) {                            // dead chunk: the whole CTA
    if (len <= 0 && chunk == 0)               // an empty slot's output is 0
      for (int i = threadIdx.x; i < KG * HD; i += NT)
        store_out(out, ((int64_t)b * H + kh * KG) * HD + i, 0.f, q_bf16);
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = c0 + warp * kTile;           // the warp's first position
  const int n = max(0, min(kTile, len - p0));   // its live rows
  const int nlive = min(kTileWarps, (len - c0 + kTile - 1) / kTile);
  unsigned char* kt = smem + warp * (kTogether ? 2 : 1) * TB;
  unsigned char* vt = kTogether ? kt + TB : kt;
  const uint32_t kbar = smem_addr(&bars[warp][0]);
  const uint32_t vbar = smem_addr(&bars[warp][1]);

  // the barriers first (their fence waits for no load yet); then q's
  // loads, ahead of the tile's in the memory system; then lane r's cache
  // row (position p0 + r), looked up once
  if (n > 0 && lane == 0) {
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float qr[QPT];
#pragma unroll
  for (int e = 0; e < QPT; ++e) {
    const int i = threadIdx.x + e * NT;
    qr[e] = i < KG * HD
                ? load_q(q, ((int64_t)b * H + kh * KG) * HD + i, q_bf16)
                : 0.f;
  }
  const int64_t my_row =
      lane < n ? cache_row<PAGED>(tables, b, kh, Kh, rows, M, p0 + lane) : 0;
  // the tile's n live rows of src into dst, completing on bar: one bulk
  // copy a run of rows contiguous in memory (the tile in a dense cache, its
  // part in one block of a paged one), issued by the lane that starts it;
  // rows at or past len are neither copied nor read
  auto stage = [&](const T* src, unsigned char* dst, uint32_t bar) {
    if (lane == 0) mbar_expect_tx(bar, n * RB);
    const int p = p0 + lane;
    if (lane < n && (lane == 0 || (PAGED && p % rows == 0)))
      bulk_copy(dst + lane * RB, src + my_row * HD,
                (PAGED ? min(n - lane, rows - p % rows) : n - lane) * RB,
                bar);
  };
  if (n > 0) {
    __syncwarp();
    stage(k, kt, kbar);
    if (kTogether) stage(v, vt, vbar);        // all the chunk's bytes in flight
  }
  // q, scaled, into shared memory while the tile lands
#pragma unroll
  for (int e = 0; e < QPT; ++e) {
    const int i = threadIdx.x + e * NT;
    if (i < KG * HD) {
      const int c = (i % HD) / VEC, h = (i % VEC) / 4;
      reinterpret_cast<float*>(&qs[i / HD][h][c])[i % 4] = qr[e] * scale;
    }
  }
  __syncthreads();

  if (n > 0) {
    mbar_wait0(kbar);
    // S: lane j takes key j; its row's chunks from chunk j on (mod CH), so
    // the 8 lanes of a shared-memory phase read 8 bank quads, against q's
    // elements of the same chunk
    float s[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) s[g] = 0.f;
    if (lane < n) {
      const unsigned char* kr = kt + lane * RB;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int cc = (c + lane) & (CH - 1);
        float kf[VEC];
        widen<T>(*reinterpret_cast<const uint4*>(kr + 16 * cc), kf);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          float x = 0.f;
#pragma unroll
          for (int h = 0; h < QV; ++h) {
            const float4 qv = qs[g][h][cc];
            x += qv.x * kf[4 * h] + qv.y * kf[4 * h + 1] +
                 qv.z * kf[4 * h + 2] + qv.w * kf[4 * h + 3];
          }
          s[g] += x;
        }
      }
    }
    // one softmax update a tile and query row: the row's max over the
    // tile's live keys, one expf a key, the sum (xor butterflies: the same
    // bits on every lane); P to shared memory for P.V
    float m[KG], l[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      m[g] = rt::warp_max(lane < n ? s[g] : rt::kNegInf);
      const float p = lane < n ? expf(s[g] - m[g]) : 0.f;
      l[g] = rt::warp_sum(p);
      ps[warp][g][lane] = p;
    }
    if (!kTogether) {
      // V into K's rows: every lane has read its K row (generic proxy)
      // before the bulk copy (async proxy) writes there
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      stage(v, vt, vbar);
    }
    mbar_wait0(vbar);
    __syncwarp();                             // every lane's P
    // P.V over the tile's live keys, in key order within a key group (a
    // loop bounded by n, unrolled by 8, so that 8 rows' loads issue
    // together; a full unroll with a guard a key ran them one by one)
    const int kq = lane / LPR, cl = lane % LPR;
    float acc[KG][EPL];
#pragma unroll
    for (int g = 0; g < KG; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
#pragma unroll 8
    for (int j = kq; j < n; j += KS) {
      float vf[EPL];
      load_wide<T, VB>(vt + j * RB + cl * VB, vf);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float p = ps[warp][g][j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vf[e];
      }
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] += __shfl_xor_sync(rt::kFull, acc[g][e], o);
    // the warp's state: m, l, and O (KG x HD f32) over its K rows, which
    // no lane reads any more
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
    }
    float* wo = reinterpret_cast<float*>(kt);
    if (kq == 0) {
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) wo[g * HD + cl * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();

  merge_fold<HD, KG>(wm, wl, smem, (kTogether ? 2 : 1) * TB, nlive, len, KG,
                     part, tickets, out, bkh, b, kh, H, nch, chunk, q_bf16);
}

// ---------------------------------------------------------------------------
// hd = 256: a chunk split across a cluster, slices staged by bulk copies
// ---------------------------------------------------------------------------

// dynamic shared memory of decode_cluster_kernel<T, KG, *>; the wrapper's
// _geometry computes the same and the launcher refuses any other
template <typename T, int KG>
__host__ __device__ constexpr int wide_smem() {
  return 16 + 2 * kSlice * kWideHD * (int)sizeof(T) +
         (int)sizeof(float) * (KG * kWideHD + kWarps * KG * kSlice +
                               KG * kSlice + KG * kWideHD + 2 * KG);
}
// chunks per slot whose m and l the folded combine can hold in the K/V
// staging memory
template <typename T, int KG>
__host__ __device__ constexpr int wide_capacity() {
  return 2 * kSlice * kWideHD * (int)sizeof(T) / (2 * (int)sizeof(float) * KG);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int KG, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
decode_cluster_kernel(const void* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ cache_len,
                      const int* __restrict__ tables,
                      float* __restrict__ part, int* __restrict__ tickets,
                      void* __restrict__ out, int H, int Kh, int rows, int M,
                      int nch, float scale, bool q_bf16) {
  constexpr int HD = kWideHD;
  constexpr int NT = kWarps * 32;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DW = HD / kWarps;             // q.k columns per warp
  constexpr int NVEC = DW / VEC;              // 16-byte vectors of them
  constexpr int CW = HD / kCluster;           // merged columns per CTA
  constexpr int PER = (KG * CW + NT - 1) / NT;   // of them per thread
  static_assert(kSlice == 32 && HD == 2 * NT && (NVEC & (NVEC - 1)) == 0,
                "layout");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // K, V
  T* ks = reinterpret_cast<T*>(smem + 16);              // kSlice x HD
  T* vs = ks + kSlice * HD;                             // kSlice x HD
  float* qs = reinterpret_cast<float*>(vs + kSlice * HD);   // KG x HD
  float* sp = qs + KG * HD;               // kWarps x KG x kSlice
  float* ps = sp + kWarps * KG * kSlice;  // KG x kSlice
  float* sacc = ps + KG * kSlice;         // KG x HD
  float* sm = sacc + KG * HD;             // KG
  float* sl = sm + KG;                    // KG
  __shared__ float gm[kCluster][KG], gl[kCluster][KG];
  __shared__ int last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bkh = blockIdx.z;
  const int b = bkh / Kh;
  const int kh = bkh % Kh;
  const int chunk = blockIdx.y;
  const int G = H / Kh;
  const int cap = PAGED ? M * rows : rows;
  const int len = min(cache_len[b], cap);
  const int c0 = chunk * kChunk;
  if (c0 >= len) {                        // dead chunk: the whole cluster
    if (len <= 0 && chunk == 0)           // an empty slot's output is 0
      for (int i = threadIdx.x; i < G * CW; i += NT)
        store_out(out,
                  ((int64_t)b * H + kh * G + i / CW) * HD + rank * CW + i % CW,
                  0.f, q_bf16);
    return;
  }
  const int s0 = c0 + rank * kSlice;
  const int n = max(0, min(kSlice, len - s0));          // live rows here
  const int nlive = min(kCluster, (len - c0 + kSlice - 1) / kSlice);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t kbar = smem_addr(bars), vbar = smem_addr(bars + 1);

  if (n > 0 && warp == 0) {
    // one bulk copy per run of rows contiguous in memory: the whole slice
    // (dense), or its part in one block (paged)
    constexpr uint32_t row_bytes = HD * sizeof(T);
    if (lane == 0) {
      mbar_init(kbar, 1);
      mbar_init(vbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(kbar, n * row_bytes);
      mbar_expect_tx(vbar, n * row_bytes);
    }
    __syncwarp();
    const int p = s0 + lane;
    const bool start = lane < n && (lane == 0 || (PAGED && p % rows == 0));
    if (start) {
      const int run = PAGED ? min(n - lane, rows - p % rows) : n;
      const int64_t row = cache_row<PAGED>(tables, b, kh, Kh, rows, M, p);
      bulk_copy(ks + lane * HD, k + row * HD, run * row_bytes, kbar);
      bulk_copy(vs + lane * HD, v + row * HD, run * row_bytes, vbar);
    }
  }
  // q, scaled, in f32 (rows past G are never read)
  for (int i = tid; i < G * HD; i += NT)
    qs[i] = load_q(q, ((int64_t)b * H + kh * G) * HD + i, q_bf16) * scale;
  __syncthreads();   // q, and the barriers' initialisation

  if (n > 0) {
    // partial scores: warp w, columns [DW w, DW w + DW) of key `lane`; the
    // lane takes its 16-byte vectors from (lane mod NVEC) on, so the 8
    // lanes of a shared-memory phase read 8 different bank quads
    mbar_wait0(kbar);
    float s[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) s[g] = 0.f;
    const T* kr = ks + lane * HD + warp * DW;
    const float* qw = qs + warp * DW;
#pragma unroll 4
    for (int c = 0; c < NVEC; ++c) {
      const int x0 = ((c + lane) & (NVEC - 1)) * VEC;
      float kf[VEC];
      widen<T>(*reinterpret_cast<const uint4*>(kr + x0), kf);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(qw + g * HD + x0 + e);
            s[g] += x.x * kf[e];
            s[g] += x.y * kf[e + 1];
            s[g] += x.z * kf[e + 2];
            s[g] += x.w * kf[e + 3];
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < G) sp[(warp * KG + g) * kSlice + lane] = s[g];
    __syncthreads();
    // query row g's softmax over the slice: warp g, lane = key
    for (int g = warp; g < G; g += kWarps) {
      float x = rt::kNegInf;
      if (lane < n) {
        x = sp[g * kSlice + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) x += sp[(w * KG + g) * kSlice + lane];
      }
      const float mx = rt::warp_max(x);
      const float p = lane < n ? expf(x - mx) : 0.f;
      const float l = rt::warp_sum(p);
      ps[g * kSlice + lane] = p;
      if (lane == 0) {
        sm[g] = mx;
        sl[g] = l;
      }
    }
    mbar_wait0(vbar);
    __syncthreads();
    // P.V: thread tid holds output columns 2 tid and 2 tid + 1
    float acc[KG][2];
#pragma unroll
    for (int g = 0; g < KG; ++g) acc[g][0] = acc[g][1] = 0.f;
    for (int j = 0; j < n; ++j) {
      float v0, v1;
      if constexpr (sizeof(T) == 4) {
        const float2 x =
            *reinterpret_cast<const float2*>(vs + j * HD + 2 * tid);
        v0 = x.x;
        v1 = x.y;
      } else if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(vs + j * HD + 2 * tid);
        v0 = __low2float(x);
        v1 = __high2float(x);
      } else {
        const float2 x = fp8x2_to_float2(
            *reinterpret_cast<const uint16_t*>(vs + j * HD + 2 * tid));
        v0 = x.x;
        v1 = x.y;
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float p = ps[g * kSlice + j];
        acc[g][0] += p * v0;
        acc[g][1] += p * v1;
      }
    }
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g < G) {
        sacc[g * HD + 2 * tid] = acc[g][0];
        sacc[g * HD + 2 * tid + 1] = acc[g][1];
      }
    }
  }

  cluster.sync();   // every slice's (m, l, acc) visible to the cluster
  // every live rank's m and l, gathered once through distributed shared
  // memory
  if (tid < nlive * G) {
    const int r = tid / G, g = tid % G;
    gm[r][g] = cluster.map_shared_rank(sm, r)[g];
    gl[r][g] = cluster.map_shared_rank(sl, r)[g];
  }
  __syncthreads();
  // CTA `rank` merges columns [CW rank, CW rank + CW) of every query row,
  // the live slices in rank order, into the chunk's partial; every rank
  // writes the chunk's m and l (the same bits in each)
  float* pc = part + ((int64_t)bkh * nch + chunk) * G * (HD + 2);
  {
    float a[PER][kCluster];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * NT, g = i / CW, d = rank * CW + i % CW;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        a[e][r] = i < G * CW && r < nlive
                      ? cluster.map_shared_rank(sacc, r)[g * HD + d]
                      : 0.f;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * NT, g = i / CW, d = rank * CW + i % CW;
      if (i >= G * CW) continue;
      float mx = rt::kNegInf;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        if (r < nlive) mx = fmaxf(mx, gm[r][g]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        if (r < nlive) {
          const float cr = expf(gm[r][g] - mx);
          L += gl[r][g] * cr;
          O += a[e][r] * cr;
        }
      }
      float* pp = pc + g * (HD + 2);
      if (i % CW == 0) {
        pp[0] = mx;
        pp[1] = L;
      }
      pp[2 + d] = O;
    }
  }
  cluster_arrive();   // done with the cluster's shared memory
  // this CTA's columns of the chunk's partial are written; the CTA of this
  // rank that takes the last ticket of its (b, kh) merges those columns
  // over every live chunk (the combine, folded in)
  const int live = (len + kChunk - 1) / kChunk;
  __syncthreads();
  if (tid == 0) {
    int* tk = tickets + bkh * kCluster + rank;
    last = atomic_add_acq_rel(tk, 1) == live - 1;
    if (last) *tk = 0;                    // ready for the next call
  }
  __syncthreads();
  if (last) {
    // columns [CW rank, CW rank + CW) of each query row over the live
    // chunks in chunk order, the sums of decode_combine_plain; each
    // chunk's m and l are gathered once into the free K/V staging memory
    // (live x G each, which wide_capacity bounds) and row g's max, scales
    // and sum taken by thread g.  Loads bypass L1: other SMs wrote them.
    const float* pb = part + (int64_t)bkh * nch * G * (HD + 2);
    float* cs = reinterpret_cast<float*>(ks);   // live x G: m, then scales
    float* ls = cs + live * G;                  // live x G: l
    for (int i = tid; i < live * G; i += NT) {
      cs[i] = __ldcg(pb + (int64_t)i * (HD + 2));
      ls[i] = __ldcg(pb + (int64_t)i * (HD + 2) + 1);
    }
    __syncthreads();
    if (tid < G) {
      float mx = rt::kNegInf;
      for (int c = 0; c < live; ++c) mx = fmaxf(mx, cs[c * G + tid]);
      float L = 0.f;
      for (int c = 0; c < live; ++c) {
        const float sc = expf(cs[c * G + tid] - mx);
        cs[c * G + tid] = sc;
        L += ls[c * G + tid] * sc;
      }
      gl[0][tid] = L;
    }
    __syncthreads();
    float O[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) O[e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = tid + e * NT, g = i / CW, d = rank * CW + i % CW;
        if (i < G * CW)
          O[e] += __ldcg(pb + ((int64_t)c * G + g) * (HD + 2) + 2 + d) *
                  cs[c * G + g];
      }
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * NT, g = i / CW, d = rank * CW + i % CW;
      if (i < G * CW)
        store_out(out, ((int64_t)b * H + kh * G + g) * HD + d,
                  O[e] / fmaxf(gl[0][g], 1e-30f), q_bf16);
    }
  }
  cluster_wait();   // no CTA leaves while another may read its memory
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// decode_lane_kernel<T, HD, KG> (KG 1 and 2, lane_smem bytes) or, with KG
// = 0, decode_mma_kernel<T, HD> (mma_smem bytes); both fold the combine in
// through the tickets
template <typename T, int HD, int KG, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* cache_len, void* scratch, void* tickets, void* out,
           int B, int H, int Kh, int rows, int M, float scale, bool q_bf16,
           int smem, cudaStream_t stream) {
  const int cap = PAGED ? M * rows : rows;
  const int nch = cap > 0 ? (cap + kChunk - 1) / kChunk : 1;
  constexpr int bytes = KG ? lane_smem<T, HD>() : mma_smem<T, HD>();
  static_assert(bytes <= 227 * 1024 - 8192, "tiles do not fit");
  if (smem != bytes || !tickets) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = [] {
    if constexpr (KG == 0)
      return decode_mma_kernel<T, HD, PAGED>;
    else
      return decode_lane_kernel<T, HD, KG, PAGED>;
  }();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(B * Kh, nch), kTileWarps * 32, bytes, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(cache_len), static_cast<const int*>(tables),
      static_cast<float*>(scratch), static_cast<int*>(tickets), out, H, Kh,
      rows, M, nch, scale, q_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KG, bool PAGED>
int launch_wide(const void* q, const void* k, const void* v,
                const void* tables, const void* cache_len, void* scratch,
                void* tickets, void* out, int B, int H, int Kh, int rows,
                int M, float scale, bool q_bf16, int smem,
                cudaStream_t stream) {
  constexpr int bytes = wide_smem<T, KG>();
  static_assert(bytes <= 227 * 1024, "slice does not fit in shared memory");
  const int cap = PAGED ? M * rows : rows;
  const int nch = cap > 0 ? (cap + kChunk - 1) / kChunk : 1;
  if (smem != bytes || !tickets || nch > wide_capacity<T, KG>())
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_cluster_kernel<T, KG, PAGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, nch, B * Kh);
  cfg.blockDim = dim3(kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, static_cast<const T*>(k),
                         static_cast<const T*>(v),
                         static_cast<const int*>(cache_len),
                         static_cast<const int*>(tables),
                         static_cast<float*>(scratch),
                         static_cast<int*>(tickets), out, H, Kh, rows, M, nch,
                         scale, q_bf16);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// qdtype: q's and the output's (f32 or bf16); cdtype: the cache's (f32,
// bf16 or fp8).  cluster and smem: the geometry kernels/decode_attention.py
// computed (1 and lane_smem for hd <= 128 at G <= 2; 1 and mma_smem at G >=
// 3; kCluster and wide_smem at hd 256); any other is refused
template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* cache_len, void* scratch, void* tickets, void* out,
             int B, int H, int Kh, int rows, int M, int hd, int hdv,
             float scale, int qdtype, int cdtype, int cluster, int smem,
             void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > kMaxG || rows < 0 ||
      M < 0 || (qdtype != rt::kDtypeF32 && qdtype != rt::kDtypeBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Kh;
  const bool q_bf16 = qdtype == rt::kDtypeBF16;
  if (hd == kWideHD && hdv == kWideHD) {
    if (cluster != kCluster) return static_cast<int>(cudaErrorInvalidValue);
#define RT_W(T, KG)                                                        \
  return launch_wide<T, KG, PAGED>(q, k, v, tables, cache_len, scratch,    \
                                   tickets, out, B, H, Kh, rows, M, scale, \
                                   q_bf16, smem, s);
#define RT_WIDE(T)                                                         \
  {                                                                        \
    if (G == 1) RT_W(T, 1)                                                 \
    if (G == 2) RT_W(T, 2)                                                 \
    if (G <= 4) RT_W(T, 4)                                                 \
    RT_W(T, 8)                                                             \
  }
    if (cdtype == rt::kDtypeF32) RT_WIDE(float)
    if (cdtype == rt::kDtypeBF16) RT_WIDE(__nv_bfloat16)
    if (cdtype == rt::kDtypeFP8) RT_WIDE(fp8)
#undef RT_WIDE
#undef RT_W
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
#define RT_G(T, D, KG)                                                     \
  return launch<T, D, KG, PAGED>(q, k, v, tables, cache_len, scratch,      \
                                 tickets, out, B, H, Kh, rows, M, scale,   \
                                 q_bf16, smem, s);
  // G 1 and 2 on the lane core; 3 to 8 on the mma core
#define RT_LANE(T, D)                                                      \
  {                                                                        \
    if (G == 1) RT_G(T, D, 1)                                              \
    RT_G(T, D, 2)                                                          \
  }
#define RT_CASE(T, D)                                                      \
  if (hd == D && hdv == D) {                                               \
    if (G <= 2) RT_LANE(T, D)                                              \
    RT_G(T, D, 0)                                                          \
  }
  if (cdtype == rt::kDtypeF32) {
    RT_CASE(float, 16) RT_CASE(float, 32) RT_CASE(float, 64)
    RT_CASE(float, 128)
  } else if (cdtype == rt::kDtypeBF16) {
    RT_CASE(__nv_bfloat16, 16) RT_CASE(__nv_bfloat16, 32)
    RT_CASE(__nv_bfloat16, 64) RT_CASE(__nv_bfloat16, 128)
  } else if (cdtype == rt::kDtypeFP8) {
    RT_CASE(fp8, 16) RT_CASE(fp8, 32) RT_CASE(fp8, 64) RT_CASE(fp8, 128)
  }
#undef RT_CASE
#undef RT_LANE
#undef RT_G
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cache_len,
                                       void* scratch, void* tickets,
                                       void* out, int B, int H, int Kh,
                                       int Smax, int hd, int hdv, float scale,
                                       int qdtype, int cdtype, int cluster,
                                       int smem, void* stream) {
  return dispatch<false>(q, k, v, nullptr, cache_len, scratch, tickets, out,
                         B, H, Kh, Smax, 0, hd, hdv, scale, qdtype, cdtype,
                         cluster, smem, stream);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* cache_len, void* scratch, void* tickets, void* out, int B,
    int H, int Kh, int block_size, int M, int hd, int hdv, float scale,
    int qdtype, int cdtype, int cluster, int smem, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, tables, cache_len, scratch,
                        tickets, out, B, H, Kh, block_size, M, hd, hdv, scale,
                        qdtype, cdtype, cluster, smem, stream);
}
