// Flash attention for prefill on Hopper: causal / windowed / full, GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel).
//
// Bound on an H100: operations.  At Sq = Skv = 512 and hd = 64 a head does
// about 2 * 2 * 512 * 512 / 2 * 64 causal flops against 4 * 512 * 64 * 4
// bytes of q, k, v and out: ~64 flops per byte, so the products belong on
// the tensor cores.  The design:
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
//       - bf16: m16n8k16 with f32 accumulation, V read by ldmatrix.trans;
//         P (f32) enters P.V as a bf16 pair hi + lo, two products, so the
//         output keeps f32 accuracy up to its final rounding to bf16;
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
// Up to hd = hdv = 64 flash_kernel runs as above: tiles of 64 keys, the two
// warps of a row tile splitting them.
//
// (128, 128), (192, 128) and (256, 256) run flash_span_kernel and
// flash_combine_kernel.  The one-pass layout above lost there: at hd 256
// f32 tiles of 64 keys do not fit and a warp's O would be 128 registers
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
//     copies, twice Q's and the ring's 200 KB, which do not fit; in bf16 it
//     would need a second code path for one dtype;
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
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::mma_3xtf32;
using rt::smem_addr;
using rt::split;

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x, y) as a bf16 pair hi plus the pair of what it rounded off, lo
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
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

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int Kh, int q_offset, int causal, int window,
             float scale) {
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
// in sh (kThreads / 32 + 3 ints).  One step per kThreads query tiles.
template <int BK>
__device__ Item find_item(int idx, int Sq, int Skv, int q_offset,
                          int causal, int window, int BH, int* sh) {
  constexpr int NW = kThreads / 32;
  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int base = 0;                               // items of the earlier steps
  for (int pass = 0; pass < 2; ++pass)
    for (int r0 = 0; r0 < n_q; r0 += kThreads) {
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

  const Item item = find_item<BK>(blockIdx.x, Sq, Skv, q_offset, causal,
                                  window, BH, reinterpret_cast<int*>(xbuf));
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

// Two output columns per thread, one row per HDV / 2 threads: the spans
// the row can see, merged in span order (a span it cannot see is never
// read).  A row with one span was written by the span kernel.
template <typename T, int HDV>
__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int Sq, int Skv, int H, int q_offset, int causal,
                     int window, int n_spans) {
  constexpr int R = kCombineThreads / (HDV / 2);
  const int row = blockIdx.x * R + threadIdx.x / (HDV / 2);
  if (row >= Sq) return;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int2 rs = row_spans(q_offset + row, Skv, causal, window);
  if (rs.x == rs.y) return;
  const float* pr =
      part + ((int64_t)blockIdx.y * Sq + row) * n_spans * (HDV + 2);
  const int d = 2 * (threadIdx.x % (HDV / 2));
  float mx = rt::kNegInf;
  for (int s = rs.x; s <= rs.y; ++s) mx = fmaxf(mx, pr[s * (HDV + 2)]);
  float L = 0.f, O0 = 0.f, O1 = 0.f;
  for (int s = rs.x; s <= rs.y; ++s) {
    const float* ps = pr + s * (HDV + 2);
    const float c = exp2f(ps[0] - mx);
    const float2 a = *reinterpret_cast<const float2*>(ps + 2 + d);
    L += ps[1] * c;
    O0 += a.x * c;
    O1 += a.y * c;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  store2<T>(out + (((int64_t)b * Sq + row) * H + h) * HDV + d, O0 * inv,
            O1 * inv);
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
  constexpr int R = kCombineThreads / (HDV / 2);
  flash_combine_kernel<T, HDV>
      <<<dim3((Sq + R - 1) / R, B * H), kCombineThreads, 0, stream>>>(
          static_cast<const float*>(scratch), static_cast<T*>(out), Sq, Skv,
          H, q_offset, causal, window, n_spans);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Kh, int q_offset, int causal,
           int window, float scale, int smem, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, HD, HDV>(kTileKeys);
  static_assert(bytes <= kMaxSmem, "tile does not fit in shared memory");
  if (smem != static_cast<int>(bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, HD, HDV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Kh,
      q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (hd, hdv) pairs built: hd == hdv in {16, 32, 64, 128, 256}, and (192,
// 128); kernels/flash_attention.py's HEAD_DIM_PAIRS lists the same.  span
// and smem are the geometry the wrapper computed (kernels/
// flash_attention.py::_geometry): span 0 and smem_bytes for flash_kernel
// (hd <= 64), kSpan and span_smem for the span kernel ((128, 128), (192,
// 128) and (256, 256), which also take the f32 scratch of B x H x Sq x
// n_spans partials); any other is refused.
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
#define RT_CASE(T, D, DV)                                                  \
  if (hd == D && hdv == DV)                                                \
    return span != 0 ? static_cast<int>(cudaErrorInvalidValue)            \
                     : launch<T, D, DV>(q, k, v, out, B, Sq, Skv, H, Kh,   \
                                        q_offset, causal, window, scale,   \
                                        smem, s);
#define RT_ALL(T)                                                          \
  RT_CASE(T, 16, 16) RT_CASE(T, 32, 32) RT_CASE(T, 64, 64)                 \
  RT_SPAN(T, 128, 128) RT_SPAN(T, 192, 128) RT_SPAN(T, 256, 256)
  if (dtype == rt::kDtypeF32) {
    RT_ALL(float)
  } else if (dtype == rt::kDtypeBF16) {
    RT_ALL(__nv_bfloat16)
  }
#undef RT_ALL
#undef RT_CASE
#undef RT_SPAN
  return static_cast<int>(cudaErrorInvalidValue);
}
