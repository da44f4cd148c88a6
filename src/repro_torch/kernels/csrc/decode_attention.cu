// Flash-decode on Hopper: one query token per slot against its KV cache.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/decode_attention.py:
//   decode_attention        (_decode_kernel)        dense (B, Kh, Smax, hd)
//   paged_decode_attention  (_paged_decode_kernel)  pools + block tables
//
// Bound on an H100: bytes.  Each (slot, kv head) reads its cache_len live
// K and V rows once and does 2*G*(hd+hdv) flops per row, far below the
// ~20 flops per byte at which f32 CUDA cores, let alone tensor cores, would
// limit it.  The design therefore only has to read each live row once and
// nothing else:
//   * one CTA of 4 warps per (b, kv head); its G = H/Kh query rows share
//     every K/V row read (GQA), with q * scale kept in shared memory;
//   * the CTA walks tiles of 32 positions only up to cache_len[b] (the
//     Pallas grid walks every Smax block), warp w taking tiles w, w+4, ...;
//     lane j scores position 32t+j, then the warp adds p_j * v_j over the
//     tile with the lanes spread across hdv, so V reads are coalesced;
//   * positions >= cache_len are never read, so garbage rows (bucket
//     padding, the null block) add exactly zero;
//   * the four warps' online-softmax states merge in warp order through
//     shared memory: no atomics, the same inputs give the same bits.
// Dense and paged share this core and differ only in how a position maps
// to a cache row, so for equal live rows their outputs are bit-identical
// (the engine's paged == dense invariant).  The paged CTA reads
// block_tables[b, p / bs] itself instead of relying on scalar prefetch and
// stops at the last live block.  Split-KV across CTAs, TMA and tensor
// cores are left to a later, performance-focused change.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;   // positions per warp step: one per lane
constexpr int kMaxG = 8;    // query rows per kv head held in registers

template <typename T, int HD, int HDV, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ cache_len,
              const int* __restrict__ tables, T* __restrict__ out, int H,
              int Kh, int rows, int M, float scale) {
  // rows: Smax (dense) or block_size (paged); M: table width (paged)
  constexpr int DPL = (HDV + 31) / 32;   // hdv elements per lane
  __shared__ float qs[kMaxG][HD];
  __shared__ float wm[kWarps][kMaxG];
  __shared__ float wl[kWarps][kMaxG];
  __shared__ float wacc[kWarps][kMaxG][HDV];

  const int b = blockIdx.x / Kh;
  const int kh = blockIdx.x % Kh;
  const int G = H / Kh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    qs[g][d] = rt::to_f32(q[((int64_t)b * H + kh * G + g) * HD + d]) * scale;
  }
  __syncthreads();

  const int cap = PAGED ? M * rows : rows;
  const int len = min(cache_len[b], cap);

  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int t = warp; t * kTile < len; t += kWarps) {
    const int p = t * kTile + lane;
    const bool valid = p < len;
    int64_t row = 0;
    if (valid) {
      if (PAGED) {
        const int64_t pid = tables[(int64_t)b * M + p / rows];
        row = (pid * Kh + kh) * rows + p % rows;
      } else {
        row = ((int64_t)b * Kh + kh) * rows + p;
      }
    }
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = k + row * HD;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float kd = rt::to_f32(kr[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s[g] += qs[g][d] * kd;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] : rt::kNegInf;
        const float mn = fmaxf(m[g], rt::warp_max(sg));
        const float pg = valid ? expf(sg - mn) : 0.f;
        const float corr = expf(m[g] - mn);
        l[g] = l[g] * corr + rt::warp_sum(pg);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= corr;
        m[g] = mn;
        s[g] = pg;                       // s now holds this lane's p
      }
    }
    const int n = min(kTile, len - t * kTile);
    for (int j = 0; j < n; ++j) {
      const int64_t rj = __shfl_sync(rt::kFull, row, j);
      const T* vr = v + rj * HDV;
      float vd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vd[i] = d < HDV ? rt::to_f32(vr[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(rt::kFull, s[g], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vd[i];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HDV) wacc[warp][g][d] = acc[g][i];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HDV; i += blockDim.x) {
    const int g = i / HDV, d = i % HDV;
    float mx = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w][g] - mx);
      L += wl[w][g] * c;
      O += wacc[w][g][d] * c;
    }
    out[((int64_t)b * H + kh * G + g) * HDV + d] =
        rt::from_f32<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, int HDV, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* cache_len, void* out, int B, int H, int Kh, int rows,
           int M, float scale, cudaStream_t stream) {
  decode_kernel<T, HD, HDV, PAGED><<<B * Kh, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<const int*>(tables), static_cast<T*>(out), H, Kh, rows, M,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* cache_len, void* out, int B, int H, int Kh, int rows,
             int M, int hd, int hdv, float scale, int dtype, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_CASE(T, D)                                                      \
  if (hd == D && hdv == D)                                                 \
    return launch<T, D, D, PAGED>(q, k, v, tables, cache_len, out, B, H,   \
                                  Kh, rows, M, scale, s);
  if (dtype == rt::kDtypeF32) {
    RT_CASE(float, 16) RT_CASE(float, 32) RT_CASE(float, 64)
    RT_CASE(float, 128)
  } else if (dtype == rt::kDtypeBF16) {
    RT_CASE(__nv_bfloat16, 16) RT_CASE(__nv_bfloat16, 32)
    RT_CASE(__nv_bfloat16, 64) RT_CASE(__nv_bfloat16, 128)
  }
#undef RT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cache_len,
                                       void* out, int B, int H, int Kh,
                                       int Smax, int hd, int hdv, float scale,
                                       int dtype, void* stream) {
  return dispatch<false>(q, k, v, nullptr, cache_len, out, B, H, Kh, Smax, 0,
                         hd, hdv, scale, dtype, stream);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* cache_len, void* out, int B, int H, int Kh, int block_size,
    int M, int hd, int hdv, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, tables, cache_len, out, B, H, Kh,
                        block_size, M, hd, hdv, scale, dtype, stream);
}
