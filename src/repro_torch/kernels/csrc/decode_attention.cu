// Flash-decode on Hopper: one query token per slot against its KV cache.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/decode_attention.py:
//   decode_attention        (_decode_kernel)        dense (B, Kh, Smax, hd)
//   paged_decode_attention  (_paged_decode_kernel)  pools + block tables
//
// Bound on an H100: bytes.  Each (slot, kv head) reads its cache_len live
// K and V rows once and does 2*G*(hd+hdv) flops per row, far below the
// ~20 flops per byte at which f32 CUDA cores would limit it.  The design
// keeps as many 16-byte loads in flight as the live rows allow:
//   * split-KV: the logical positions are cut into fixed chunks of kChunk
//     (= CHUNK in kernels/decode_attention.py) and decode_split_kernel runs
//     one CTA of 4 warps per (b*Kh + kh, chunk), so a slot with a long
//     cache spreads over many SMs; a CTA whose chunk starts at or past
//     cache_len[b] exits at once;
//   * inside a chunk warp w takes positions [32w, 32w + 32); each K or V row
//     is read as 16-byte vectors (float4 or 8 bf16) by the lanes of one row
//     group, so one load instruction of the warp covers 32 / (lanes per
//     row) whole rows (2 at hd=64 f32), and up to four of them are issued
//     before any is used.  A row wider than a warp's 32 vectors (hd=256 in
//     f32, 64 vectors) spans all 32 lanes with NV = 2 vectors per lane: lane
//     c holds vectors c and c + 32, so each of the warp's loads still reads
//     512 contiguous bytes, and half as many rows are in flight, to keep the
//     loads per lane at four;
//   * a row's q.k is reduced by a fixed-order xor-shuffle across its lanes;
//     each row group keeps an online-softmax state per query row (the G =
//     H/Kh rows of a kv head share every K/V row read), the groups merge by
//     an xor butterfly, then the warps merge in warp order through shared
//     memory; the CTA writes its partial (m, l, acc[hdv]) per query row to
//     an f32 scratch tensor the wrapper allocates;
//   * decode_combine_kernel, one CTA per (b, kh), merges the live chunks
//     (those below ceil(cache_len / kChunk)) in chunk order and writes the
//     output in q's dtype.
// A wrapper call therefore makes two CUDA launches (split, then combine) on
// one stream and counts as one launch in build.launches.  No atomics: every
// sum has a fixed order, so the same inputs give the same bits.
// Positions at or past cache_len are never read, so garbage rows (bucket
// padding, the null block) add exactly zero.  Dense and paged share this
// core and differ only in how a logical position maps to a cache row; the
// chunk boundaries are logical positions that depend neither on Smax nor on
// the block size, so dense, the gather path (a dense call on the gathered
// view) and the paged kernel sum the same rows in the same order and their
// outputs are bit-identical for equal live rows (the engine's paged ==
// dense invariant).  The paged CTA reads block_tables[b, p / bs] itself.
// TMA loads of the chunk are left to a later change.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kChunk = 128;                 // positions per split CTA
constexpr int kPerWarp = kChunk / kWarps;   // positions per warp
constexpr int kMaxG = 8;                    // query rows per kv head

// a 16-byte vector of T, widened to f32 into f[0, 16 / sizeof(T))
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float* f);
template <>
__device__ __forceinline__ void widen<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u,
                                                     float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);           // bf16 -> f32 exactly
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int HD, int KG, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cache_len,
                    const int* __restrict__ tables, float* __restrict__ part,
                    int H, int Kh, int rows, int M, int nch, float scale) {
  // rows: Smax (dense) or block_size (paged); M: table width (paged)
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte load
  constexpr int LPR = HD / VEC < 32 ? HD / VEC : 32;  // lanes per cache row
  constexpr int NV = HD / (VEC * LPR);        // 16-byte vectors per lane
  constexpr int EL = NV * VEC;                // row elements per lane
  constexpr int RPI = 32 / LPR;               // rows per warp-wide load
  constexpr int STEPS = kPerWarp / RPI;
  constexpr int U = STEPS < 4 / NV ? STEPS : 4 / NV;  // rows before use
  static_assert(HD % (VEC * LPR) == 0 && 32 % LPR == 0 &&
                    kPerWarp % RPI == 0 && 4 % NV == 0, "");
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

  // element j * VEC + e of a lane is column (j * LPR + c) * VEC + e
  float qv[KG][EL];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qv[g][j * VEC + e] =
            g < G ? rt::to_f32(q[((int64_t)b * H + kh * G + g) * HD +
                                 (j * LPR + c) * VEC + e]) *
                        scale
                  : 0.f;
  }
  float m[KG], l[KG], acc[KG][EL];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[g][e] = 0.f;
  }

  const int w0 = c0 + warp * kPerWarp;
#pragma unroll 1
  for (int i0 = 0; i0 < STEPS && w0 + i0 * RPI < len; i0 += U) {
    uint4 kr[U][NV], vr[U][NV];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = w0 + (i0 + u) * RPI + r;
      ok[u] = p < len;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        vr[u][j] = kr[u][j];
      }
      if (ok[u]) {
        int64_t row;
        if (PAGED) {
          const int64_t pid = tables[(int64_t)b * M + p / rows];
          row = (pid * Kh + kh) * rows + p % rows;
        } else {
          row = ((int64_t)b * Kh + kh) * rows + p;
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(k + row * HD) +
                           j * LPR + c);
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(v + row * HD) +
                           j * LPR + c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EL], vf[EL];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        widen<T>(kr[u][j], kf + j * VEC);
        widen<T>(vr[u][j], vf + j * VEC);
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) s += qv[g][e] * kf[e];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(rt::kFull, s, o);
        if (ok[u] && g < G) {
          const float mn = fmaxf(m[g], s);
          const float corr = expf(m[g] - mn);
          const float p = expf(s - mn);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < EL; ++e)
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
      for (int e = 0; e < EL; ++e) {
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
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wacc[warp][g][(j * LPR + c) * VEC + e] = acc[g][j * VEC + e];
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

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ cache_len, T* __restrict__ out,
                      int H, int Kh, int cap, int nch) {
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
    out[((int64_t)b * H + kh * G + g) * HD + d] =
        rt::from_f32<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, int KG, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* cache_len, void* scratch, void* out, int B, int H,
           int Kh, int rows, int M, float scale, cudaStream_t stream) {
  const int cap = PAGED ? M * rows : rows;
  const int nch = cap > 0 ? (cap + kChunk - 1) / kChunk : 1;
  decode_split_kernel<T, HD, KG, PAGED>
      <<<dim3(B * Kh, nch), kWarps * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(cache_len),
          static_cast<const int*>(tables), static_cast<float*>(scratch), H,
          Kh, rows, M, nch, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<T, HD><<<B * Kh, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(cache_len),
      static_cast<T*>(out), H, Kh, cap, nch);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* cache_len, void* scratch, void* out, int B, int H,
             int Kh, int rows, int M, int hd, int hdv, float scale, int dtype,
             void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > kMaxG || rows < 0 ||
      M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Kh;
#define RT_G(T, D, KG)                                                     \
  return launch<T, D, KG, PAGED>(q, k, v, tables, cache_len, scratch, out, \
                                 B, H, Kh, rows, M, scale, s);
#define RT_CASE(T, D)                                                      \
  if (hd == D && hdv == D) {                                               \
    if (G == 1) RT_G(T, D, 1)                                              \
    if (G == 2) RT_G(T, D, 2)                                              \
    if (G <= 4) RT_G(T, D, 4)                                              \
    RT_G(T, D, 8)                                                          \
  }
  if (dtype == rt::kDtypeF32) {
    RT_CASE(float, 16) RT_CASE(float, 32) RT_CASE(float, 64)
    RT_CASE(float, 128) RT_CASE(float, 256)
  } else if (dtype == rt::kDtypeBF16) {
    RT_CASE(__nv_bfloat16, 16) RT_CASE(__nv_bfloat16, 32)
    RT_CASE(__nv_bfloat16, 64) RT_CASE(__nv_bfloat16, 128)
    RT_CASE(__nv_bfloat16, 256)
  }
#undef RT_CASE
#undef RT_G
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cache_len,
                                       void* scratch, void* out, int B, int H,
                                       int Kh, int Smax, int hd, int hdv,
                                       float scale, int dtype, void* stream) {
  return dispatch<false>(q, k, v, nullptr, cache_len, scratch, out, B, H, Kh,
                         Smax, 0, hd, hdv, scale, dtype, stream);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* cache_len, void* scratch, void* out, int B, int H, int Kh,
    int block_size, int M, int hd, int hdv, float scale, int dtype,
    void* stream) {
  return dispatch<true>(q, k_pool, v_pool, tables, cache_len, scratch, out, B,
                        H, Kh, block_size, M, hd, hdv, scale, dtype, stream);
}
