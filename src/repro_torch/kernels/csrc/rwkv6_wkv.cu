// RWKV-6 WKV recurrence on Hopper, from a given initial state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py
// (wkv6 -> _wkv_kernel) and adds the state0 input that kernel lacks (it
// always starts from zero), so the model's prefill and every decode tick,
// which resume from a cached state, run here.  Per (b, h), with the hd x hd
// f32 state S:
//   y_t[j]  = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Bound on an H100: bytes.  Each call reads r, k, v, w once, writes y once,
// and reads and writes the state once: at the serving shapes (hd = 64,
// H = 32) about 22 MB for a 512-token prefill (6.6 us at 3.35 TB/s) and
// 8.7 MB for a decode tick at batch 8 (2.6 us), against about 5 flops per
// state element and step (4.9 us for that prefill at 67 TFLOP/s f32).
// Beside the bytes, the S steps are dependent through S: no schedule
// finishes before S multiply-adds in a row, one per step (S * 4 cycles).
// The design keeps the state out of memory for the
// whole sequence and hides each step's loads behind the step before:
//   * one CTA of hd threads per (b, h); thread j holds column j of S in
//     registers from the initial read to the final write, so the state
//     crosses device memory once each way per call, whatever S is;
//   * the state buffer holds the initial state on entry and the final one
//     on exit (the cache, updated in place): each thread reads its own
//     column before the loop and writes it after, and no other thread
//     touches it;
//   * the time loop runs inside the CTA (the Pallas grid's sequential time
//     axis); r_t, k_t and w_t are staged in double-buffered shared memory,
//     and each thread loads step t + 2's inputs into registers while step t
//     computes, so one barrier per step is the only synchronisation;
//   * loads and stores of r, k, v, w, y and the state are coalesced: thread
//     j reads element j of a row;
//   * y_t[j] needs only column j, so there is no reduction across threads
//     and no atomics: each sum runs in a fixed order (four interleaved
//     partial sums over i, added pairwise) and the same inputs give the
//     same bits on every run.
// The kernel loops over exactly S steps, so time needs no padding (the
// Pallas wrapper pads with w = 1).  Splitting i across threads to shorten
// a step, and more CTAs per (b, h) at batch 1, are left to a later,
// performance-focused change.
#include <stdint.h>

#include "common.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            T* __restrict__ y, int S, int H) {
  __shared__ __align__(16) float sr[2][HD];
  __shared__ __align__(16) float sk[2][HD];
  __shared__ __align__(16) float sw[2][HD];
  __shared__ __align__(16) float su[HD];

  const int bh = blockIdx.x;   // b * H + h
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;   // the state column this thread owns
  // element (b, t, h, j) of a (B, S, H, HD) tensor is at row0 + t * stride
  const int64_t stride = (int64_t)H * HD;
  const int64_t row0 = ((int64_t)b * S * H + h) * HD + j;
  const int64_t st0 = (int64_t)bh * HD * HD + j;

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = state[st0 + (int64_t)i * HD];
  su[j] = u[h * HD + j];

  float vj = 0.f;                            // v_t[j] of the current step
  float nr = 0.f, nk = 0.f, nw = 0.f, nv = 0.f;  // step t + 1's inputs
  if (S > 0) {
    sr[0][j] = rt::to_f32(r[row0]);
    sk[0][j] = rt::to_f32(k[row0]);
    sw[0][j] = rt::to_f32(w[row0]);
    vj = rt::to_f32(v[row0]);
  }
  if (S > 1) {
    nr = rt::to_f32(r[row0 + stride]);
    nk = rt::to_f32(k[row0 + stride]);
    nw = rt::to_f32(w[row0 + stride]);
    nv = rt::to_f32(v[row0 + stride]);
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
    for (int i = 0; i < HD; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(&sr[cur][i]);
      const float4 k4 = *reinterpret_cast<const float4*>(&sk[cur][i]);
      const float4 w4 = *reinterpret_cast<const float4*>(&sw[cur][i]);
      const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
      float a;
      a = k4.x * vj;
      y0 = fmaf(r4.x, fmaf(u4.x, a, s[i]), y0);
      s[i] = fmaf(w4.x, s[i], a);
      a = k4.y * vj;
      y1 = fmaf(r4.y, fmaf(u4.y, a, s[i + 1]), y1);
      s[i + 1] = fmaf(w4.y, s[i + 1], a);
      a = k4.z * vj;
      y2 = fmaf(r4.z, fmaf(u4.z, a, s[i + 2]), y2);
      s[i + 2] = fmaf(w4.z, s[i + 2], a);
      a = k4.w * vj;
      y3 = fmaf(r4.w, fmaf(u4.w, a, s[i + 3]), y3);
      s[i + 3] = fmaf(w4.w, s[i + 3], a);
    }
    y[row0 + t * stride] = rt::from_f32<T>((y0 + y1) + (y2 + y3));
    // the other buffer was last read in step t - 1, before its barrier
    if (t + 1 < S) {
      sr[cur ^ 1][j] = nr;
      sk[cur ^ 1][j] = nk;
      sw[cur ^ 1][j] = nw;
    }
    __syncthreads();
    vj = nv;
    if (t + 2 < S) {
      const int64_t o = row0 + (int64_t)(t + 2) * stride;
      nr = rt::to_f32(r[o]);
      nk = rt::to_f32(k[o]);
      nw = rt::to_f32(w[o]);
      nv = rt::to_f32(v[o]);
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) state[st0 + (int64_t)i * HD] = s[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, void* y, int B, int S, int H,
           cudaStream_t stream) {
  wkv6_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(state),
      static_cast<T*>(y), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, y: (B, S, H, hd) in dtype; u: (H, hd) f32; state: (B, H,
// hd, hd) f32, read as the initial state and overwritten with the final one.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* state, void* y,
                           int B, int S, int H, int hd, int dtype,
                           void* stream) {
  if (B <= 0 || H <= 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_CASE(T, D)                                                     \
  if (hd == D)                                                            \
    return launch<T, D>(r, k, v, w, u, state, y, B, S, H, st);
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
