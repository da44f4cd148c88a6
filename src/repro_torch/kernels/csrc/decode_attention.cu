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
// hd <= 128 (decode_split_kernel, then decode_combine_kernel: two CUDA
// launches on one stream, no atomics):
//   * one CTA of 4 warps per (b*Kh + kh, chunk), so a slot with a long
//     cache spreads over many SMs; a CTA whose chunk starts at or past
//     cache_len[b] exits at once;
//   * inside a chunk warp w takes positions [32w, 32w + 32); each K or V row
//     is read as 16-byte vectors (float4, 8 bf16 or 16 fp8; 8-byte vectors
//     of 8 fp8 at G > 4) by the lanes of one row group, so one load
//     instruction of the warp covers 32 / (lanes per row) whole rows (2 at
//     hd=64 f32, 8 at hd=64 fp8), and up to four of them are issued before
//     any is used;
//   * a row's q.k is reduced by a fixed-order xor-shuffle across its lanes;
//     each row group keeps an online-softmax state per query row (the G =
//     H/Kh rows of a kv head share every K/V row read), the groups merge by
//     an xor butterfly, then the warps merge in warp order through shared
//     memory;
//   * decode_combine_kernel runs one CTA per (b, kh).
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
//     decode_combine_kernel, and sets the counter back to 0 for the next
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

// a vector of VB bytes (16 or 8) of the cache
template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };

// a vector of VB bytes of T, widened to f32 into f[0, VB / sizeof(T))
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

// ---------------------------------------------------------------------------
// hd <= 128: one CTA per chunk
// ---------------------------------------------------------------------------

template <typename T, int HD, int KG, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const void* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cache_len,
                    const int* __restrict__ tables, float* __restrict__ part,
                    int H, int Kh, int rows, int M, int nch, float scale,
                    bool q_bf16) {
  // rows: Smax (dense) or block_size (paged); M: table width (paged).
  // A lane loads 16-byte vectors of the cache, or 8-byte ones for fp8 at
  // KG 8, where 16 elements of q and acc per query row would not fit in
  // registers; the lanes then hold what they hold at bf16.
  constexpr int VB = (sizeof(T) == 1 && KG > 4) ? 8 : 16;
  using V = typename Vec<VB>::type;
  constexpr int VEC = VB / sizeof(T);         // elements per vector load
  constexpr int LPR = HD / VEC;               // lanes per cache row
  constexpr int RPI = 32 / LPR;               // rows per warp-wide load
  constexpr int STEPS = kPerWarp / RPI;
  constexpr int U = STEPS < 4 ? STEPS : 4;    // rows before use
  static_assert(HD % VEC == 0 && LPR <= 32 && 32 % LPR == 0 &&
                    kPerWarp % RPI == 0, "");
  __shared__ float wm[kWarps][KG];
  __shared__ float wl[kWarps][KG];
  __shared__ float wacc[kWarps][KG][HD];

  const int bkh = blockIdx.x;
  const int b = bkh / Kh;
  const int kh = bkh % Kh;
  const int chunk = blockIdx.y;
  const int G = H / Kh;
  const int cap = PAGED ? M * rows : rows;
  const int len = min(cache_len[b], cap);
  const int c0 = chunk * kChunk;
  if (c0 >= len) return;                      // dead chunk: the whole CTA

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / LPR;                   // row within a warp-wide load
  const int c = lane % LPR;                   // 16-byte column of the row

  // element e of a lane is column c * VEC + e
  float qv[KG][VEC];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qv[g][e] = g < G ? load_q(q,
                                ((int64_t)b * H + kh * G + g) * HD + c * VEC +
                                    e,
                                q_bf16) *
                             scale
                       : 0.f;
  }
  float m[KG], l[KG], acc[KG][VEC];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int w0 = c0 + warp * kPerWarp;
#pragma unroll 1
  for (int i0 = 0; i0 < STEPS && w0 + i0 * RPI < len; i0 += U) {
    V kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = w0 + (i0 + u) * RPI + r;
      ok[u] = p < len;
      kr[u] = V{};
      vr[u] = kr[u];
      if (ok[u]) {
        const int64_t row = cache_row<PAGED>(tables, b, kh, Kh, rows, M, p);
        kr[u] = __ldg(reinterpret_cast<const V*>(k + row * HD) + c);
        vr[u] = __ldg(reinterpret_cast<const V*>(v + row * HD) + c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC], vf[VEC];
      widen<T>(kr[u], kf);
      widen<T>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += qv[g][e] * kf[e];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(rt::kFull, s, o);
        if (ok[u] && g < G) {
          const float mn = fmaxf(m[g], s);
          const float corr = expf(m[g] - mn);
          const float p = expf(s - mn);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = acc[g][e] * corr + p * vf[e];
          m[g] = mn;
        }
      }
    }
  }

  // merge the row groups of the warp (lanes c, c + LPR, ...): xor butterfly
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      const float mo = __shfl_xor_sync(rt::kFull, m[g], o);
      const float lo = __shfl_xor_sync(rt::kFull, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float ca = expf(m[g] - mn);
      const float cb = expf(mo - mn);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(rt::kFull, acc[g][e], o);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mn;
    }
  }
  // once a multiply-add is contracted the butterfly's lanes need not agree
  // bit for bit, so one fixed row group writes the warp's state
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (c == 0) {
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) wacc[warp][g][c * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();

  // the warps merge in warp order; one partial (m, l, acc[HD]) per query row
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float mx = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = expf(wm[w][g] - mx);
      L += wl[w][g] * cw;
      O += wacc[w][g][d] * cw;
    }
    float* pp = part + (((int64_t)bkh * nch + chunk) * G + g) * (HD + 2);
    if (d == 0) {
      pp[0] = mx;
      pp[1] = L;
    }
    pp[2 + d] = O;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ cache_len, void* __restrict__ out,
                      int H, int Kh, int cap, int nch, bool out_bf16) {
  const int bkh = blockIdx.x;
  const int b = bkh / Kh;
  const int kh = bkh % Kh;
  const int G = H / Kh;
  const int len = min(cache_len[b], cap);
  const int live = len > 0 ? (len + kChunk - 1) / kChunk : 0;
  const int64_t stride = (int64_t)G * (HD + 2);   // from one chunk to the next
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    const float* pp = part + ((int64_t)bkh * nch * G + g) * (HD + 2);
    float mx = rt::kNegInf;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, pp[s * stride]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < live; ++s) {
      const float* ps = pp + s * stride;
      const float cs = expf(ps[0] - mx);
      L += ps[1] * cs;
      O += ps[2 + d] * cs;
    }
    store_out(out, ((int64_t)b * H + kh * G + g) * HD + d,
              O / fmaxf(L, 1e-30f), out_bf16);
  }
}

// ---------------------------------------------------------------------------
// hd = 256: a chunk split across a cluster, slices staged by bulk copies
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
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
    // chunks in chunk order, the sums of decode_combine_kernel; each
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

template <typename T, int HD, int KG, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* cache_len, void* scratch, void* out, int B, int H,
           int Kh, int rows, int M, float scale, bool q_bf16,
           cudaStream_t stream) {
  const int cap = PAGED ? M * rows : rows;
  const int nch = cap > 0 ? (cap + kChunk - 1) / kChunk : 1;
  decode_split_kernel<T, HD, KG, PAGED>
      <<<dim3(B * Kh, nch), kWarps * 32, 0, stream>>>(
          q, static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(cache_len), static_cast<const int*>(tables),
          static_cast<float*>(scratch), H, Kh, rows, M, nch, scale, q_bf16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<HD><<<B * Kh, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(cache_len),
      out, H, Kh, cap, nch, q_bf16);
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
// computed (1 and 0 for hd <= 128; kCluster and wide_smem at hd 256); any
// other is refused
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
  if (cluster != 1 || smem != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define RT_G(T, D, KG)                                                     \
  return launch<T, D, KG, PAGED>(q, k, v, tables, cache_len, scratch, out, \
                                 B, H, Kh, rows, M, scale, q_bf16, s);
#define RT_CASE(T, D)                                                      \
  if (hd == D && hdv == D) {                                               \
    if (G == 1) RT_G(T, D, 1)                                              \
    if (G == 2) RT_G(T, D, 2)                                              \
    if (G <= 4) RT_G(T, D, 4)                                              \
    RT_G(T, D, 8)                                                          \
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
