// Flash attention for prefill on Hopper: causal / windowed / full, GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel).
//
// Bound on an H100: operations.  At Sq = Skv = 512 and hd = 64 a head does
// about 2 * 2 * 512 * 512 / 2 * 64 causal flops against 4 * 512 * 64 * 4
// bytes of q, k, v and out: ~64 flops per byte, above the f32 CUDA-core
// ridge of ~20.  This first version runs on CUDA cores in f32 (no wgmma or
// TMA yet), so its design aims at doing only the work the mask allows and
// reading shared memory without bank conflicts:
//   * one CTA of 4 warps per (b*h, tile of 16 query rows); each warp owns 4
//     rows; q * scale for the tile sits in shared memory;
//   * K and V tiles of 32 positions are staged in shared memory (K rows
//     padded by one float so lane j reading row j hits 32 distinct banks);
//   * the CTA visits only kv tiles the causal bound and the window can
//     reach (the Pallas kernel visits every tile and masks);
//   * q_offset, Sq and Skv are runtime ints, so one build serves every
//     prompt length and chunk offset; ragged q and kv edges are masked
//     here, with no padded copies of the inputs;
//   * f32 online softmax with the finite -1e30 mask; every sum runs in a
//     fixed order with no atomics, so the same inputs give the same bits.
// Shared memory above 48 KB (large head dims) is requested through the
// dynamic-shared-memory attribute.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;   // query rows per CTA
constexpr int kBK = 32;                      // kv positions per tile

template <int HD, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HDV);
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int Kh, int q_offset, int causal, int window,
             float scale) {
  constexpr int DPL = (HDV + 31) / 32;
  constexpr int KS = HD + 1;                  // padded K row stride
  extern __shared__ float smem[];
  float* qs = smem;                           // kBQ x HD
  float* ks = qs + kBQ * HD;                  // kBK x KS
  float* vs = ks + kBK * KS;                  // kBK x HDV

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / Kh);
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // q: (B, Sq, H, HD); k: (B, Skv, Kh, HD); v: (B, Skv, Kh, HDV)
  for (int i = threadIdx.x; i < kBQ * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    qs[i] = qi < Sq
        ? rt::to_f32(q[(((int64_t)b * Sq + qi) * H + h) * HD + d]) * scale
        : 0.f;
  }

  // kv span any row of this tile can see
  const int last_q = min(q0 + kBQ, Sq) - 1;
  int kv_hi = Skv;
  int kv_lo = 0;
  if (causal) {
    kv_hi = min(Skv, q_offset + last_q + 1);
    if (window) kv_lo = max(0, q_offset + q0 - window + 1);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = (kv_lo / kBK) * kBK; t0 < kv_hi; t0 += kBK) {
    __syncthreads();   // q tile written / previous kv tile consumed
    for (int i = threadIdx.x; i < kBK * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD, kp = t0 + j;
      ks[j * KS + d] = kp < Skv
          ? rt::to_f32(k[(((int64_t)b * Skv + kp) * Kh + kh) * HD + d])
          : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * HDV; i += blockDim.x) {
      const int j = i / HDV, d = i % HDV, kp = t0 + j;
      vs[i] = kp < Skv
          ? rt::to_f32(v[(((int64_t)b * Skv + kp) * Kh + kh) * HDV + d])
          : 0.f;
    }
    __syncthreads();

    const int kp = t0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qp = q_offset + q0 + row;      // absolute query position
      bool valid = kp < Skv;
      if (causal) {
        valid = valid && kp <= qp;
        if (window) valid = valid && kp > qp - window;
      }
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qs[row * HD + d] * ks[lane * KS + d];
      s = valid ? s : rt::kNegInf;
      const float mn = fmaxf(m[r], rt::warp_max(s));
      p[r] = valid ? expf(s - mn) : 0.f;
      const float corr = expf(m[r] - mn);
      l[r] = l[r] * corr + rt::warp_sum(p[r]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      m[r] = mn;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vd[i] = d < HDV ? vs[j * HDV + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(rt::kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vd[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HDV)
        out[(((int64_t)b * Sq + qi) * H + h) * HDV + d] =
            rt::from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Kh, int q_offset, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD, HDV>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, HD, HDV><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Kh,
      q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int Kh, int hd, int hdv,
                                      int q_offset, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_CASE(T, D)                                                      \
  if (hd == D && hdv == D)                                                 \
    return launch<T, D, D>(q, k, v, out, B, Sq, Skv, H, Kh, q_offset,      \
                           causal, window, scale, s);
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
