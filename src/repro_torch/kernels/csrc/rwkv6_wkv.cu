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
// Bound on an H100.  Bytes: each call reads r, k, v, w once, writes y once,
// and reads and writes the state once: at the serving shapes (hd = 64,
// H = 32) about 22 MB for a 512-token prefill (6.6 us at 3.35 TB/s) and
// 8.7 MB for a decode tick at batch 8 (2.6 us).  Operations: about 5 flops
// per state element and step, 4.9 us for that prefill at 67 TFLOP/s f32.
// Dependent steps: S[i][j] passes through one fused multiply-add per step,
// so no schedule finishes before S of them in a row (512 x 4 cycles, about
// 1 us).  A step's work is tiny and the columns j are independent, so the
// design spreads each (b, h) over many threads and keeps the state in
// registers for the whole call:
//   * a lane owns R consecutive rows of one column j (R = 4, or 16 for a
//     call of at most FEW_STEPS steps, see the wrapper); G = hd / R lanes
//     share a column, and a CTA takes JC columns (JC x G <= 256 threads,
//     thread = g JC + j), so a (b, h) is split over hd / JC CTAs.  At the
//     serving shapes, hd = 64:
//       - prefill (B = 1, H = 32, R = 4): G = 16, JC = 16, 256 threads, 4
//         CTAs per head, 128 CTAs: one per SM, 8 warps (2 per scheduler);
//       - decode (B = 8, S = 1, R = 16): G = 4, JC = 64, 256 threads, one
//         CTA per head, 256 CTAs: a single wave (2 per SM) that moves the
//         state, which is the whole of a decode call's bytes;
//   * time runs in tiles of TT steps (32; 16 at hd = 128) through a ring of
//     kStages tiles in dynamic shared memory, filled by cp.async: r, k and
//     w whole (hd per step: every CTA of a head reads them, from L2 after
//     the first) and the CTA's JC columns of v.  One barrier per tile;
//     tile n + 2 loads while tile n computes;
//   * each lane writes, per step and per group of 4 rows, one partial sum
//     of y into shared memory; at the next tile's barrier the CTA adds the
//     hd / 4 partials of each (step, column) in row order and stores the
//     tile's y coalesced (JC contiguous values per step);
//   * the state crosses device memory once each way: the lanes of a warp
//     hold consecutive columns (JC >= 8), so each of a lane's R loads and
//     stores is part of whole 32-byte sectors of a state row; the final
//     state overwrites state0 in place.
// What holds a prefill above its bound is the step itself, not device
// memory: every lane reads its rows' r, k and w (48 B in f32) and its v
// from shared memory each step, about 13 KB per SM and step at 8 warps
// against 128 B per cycle, beside about 25 instructions per warp and step.
// A lane that held two columns would halve those bytes per state element,
// at half the warps.
// Exact composition.  Every state element keeps one chain,
// S = fmaf(w, S, a) with a = k v computed once; every partial of y is the
// same 4-term chain of fused multiply-adds over its rows; and y sums the
// hd / 4 partials in row order.  None of this depends on R, the tile's
// position, S or the call, so the same inputs give the same bits on every
// run, and a sequence split anywhere (a prefill followed by single-step
// decode calls, say) gives the same y and state bits as one whole call.
// The kernel loops over exactly S steps, so time needs no padding (the
// Pallas wrapper pads with w = 1).  Every launch parameter derives from
// (hd, R, S, dtype); the Python wrapper computes the same geometry
// (rwkv6_wkv.py, _geometry) and passes its shared-memory size, which the
// launcher checks against its own.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kUnit = 4;          // rows in one partial sum of y
constexpr int kStages = 3;        // time tiles in the ring
constexpr int kMaxThreads = 256;  // threads per CTA

template <int HD, int R>
struct Geo {
  static constexpr int G = HD / R;                   // lanes per column
  static constexpr int JC = HD < kMaxThreads / G ? HD : kMaxThreads / G;
  static constexpr int NT = G * JC;                  // threads per CTA
  static constexpr int TT = HD <= 64 ? 32 : 16;      // steps per tile
  static constexpr int U = HD / kUnit;               // partials per y
  static_assert(R % kUnit == 0 && HD % R == 0 && 32 % G == 0, "geometry");
  static_assert(NT % 32 == 0 && HD % JC == 0, "geometry");
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared memory of one CTA for a call of S steps, in bytes from
// the base: min(kStages, tiles) ring stages of tts = min(TT, S) steps of
// r, k, w (hd each) and v (JC), in T; then two buffers of U x ps f32
// partials (ps = tts JC rounded up to 32, plus JC % 32, so a warp's
// partial stores hit 32 banks).
struct Smem {
  int tts, stage_bytes, ps, part_off, bytes;
};

template <typename T, int HD, int R>
__host__ __device__ constexpr Smem smem_layout(int S) {
  using Gm = Geo<HD, R>;
  const int tts = S < Gm::TT ? S : Gm::TT;
  const int tiles = (S + Gm::TT - 1) / Gm::TT;
  const int stages = tiles < kStages ? tiles : kStages;
  const int stage_bytes =
      round_up(tts * (3 * HD + Gm::JC) * static_cast<int>(sizeof(T)), 16);
  const int ps = round_up(tts * Gm::JC, 32) + Gm::JC % 32;
  const int part_off = stages * stage_bytes;
  return Smem{tts, stage_bytes, ps, part_off, part_off + 2 * Gm::U * ps * 4};
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive elements of shared memory, as f32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
template <typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, float (&o)[R]) {
#pragma unroll
  for (int c = 0; c < R; c += 4) {
    float x[4];
    load4(p + c, x);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[c + q] = x[q];
  }
}

// One step for a lane's R rows of one column: y's partial per 4 rows into
// pp[0], pp[ps], ..., and the state update.
template <int R>
__device__ __forceinline__ void wkv_step(
    const float (&rr)[R], const float (&kk)[R], const float (&ww)[R],
    float vj, const float (&uu)[R], float (&s)[R], float* pp, int ps) {
#pragma unroll
  for (int p = 0; p < R / kUnit; ++p) {
    const int i0 = kUnit * p;
    float a[kUnit];
#pragma unroll
    for (int q = 0; q < kUnit; ++q) a[q] = kk[i0 + q] * vj;
    float yp = rr[i0] * fmaf(uu[i0], a[0], s[i0]);
#pragma unroll
    for (int q = 1; q < kUnit; ++q)
      yp = fmaf(rr[i0 + q], fmaf(uu[i0 + q], a[q], s[i0 + q]), yp);
#pragma unroll
    for (int q = 0; q < kUnit; ++q)
      s[i0 + q] = fmaf(ww[i0 + q], s[i0 + q], a[q]);
    pp[p * ps] = yp;
  }
}

// Start the async copies of tile n (steps n TT ..) into its ring stage.
template <typename T, int HD, int R>
__device__ __forceinline__ void load_tile(
    unsigned char* smem, const Smem& L, int n, const T* r, const T* k,
    const T* v, const T* w, int64_t row0, int S, int H, int j0) {
  using Gm = Geo<HD, R>;
  constexpr int E = 16 / sizeof(T);                  // elements per copy
  constexpr int CPR = HD / E;                        // copies per row
  constexpr int VB = Gm::JC * sizeof(T) < 16 ? Gm::JC * sizeof(T) : 16;
  constexpr int VE = VB / sizeof(T);
  constexpr int VCPR = Gm::JC / VE;
  const int t0 = n * Gm::TT;
  const int len = min(Gm::TT, S - t0);
  T* sr = reinterpret_cast<T*>(smem + (n % kStages) * L.stage_bytes);
  T* sk = sr + L.tts * HD;
  T* sw = sk + L.tts * HD;
  T* sv = sw + L.tts * HD;
  for (int i = threadIdx.x; i < len * CPR; i += Gm::NT) {
    const int tt = i / CPR, c = i % CPR;
    const int64_t off = (row0 + (int64_t)(t0 + tt) * H) * HD + c * E;
    const int d = tt * HD + c * E;
    cp_async<16>(sr + d, r + off);
    cp_async<16>(sk + d, k + off);
    cp_async<16>(sw + d, w + off);
  }
  for (int i = threadIdx.x; i < len * VCPR; i += Gm::NT) {
    const int tt = i / VCPR, c = i % VCPR;
    cp_async<VB>(sv + tt * Gm::JC + c * VE,
                 v + (row0 + (int64_t)(t0 + tt) * H) * HD + j0 + c * VE);
  }
}

// y of tile n: each (step, column) sums its U partials in row order.
template <typename T, int HD, int R>
__device__ __forceinline__ void store_y(const float* part, const Smem& L,
                                        int n, T* y, int64_t row0, int S,
                                        int H, int j0) {
  using Gm = Geo<HD, R>;
  const int t0 = n * Gm::TT;
  const int len = min(Gm::TT, S - t0);
  const float* pb = part + (n & 1) * Gm::U * L.ps;
  for (int o = threadIdx.x; o < len * Gm::JC; o += Gm::NT) {
    float acc = pb[o];
#pragma unroll
    for (int m = 1; m < Gm::U; ++m) acc += pb[m * L.ps + o];
    const int tt = o / Gm::JC, jj = o % Gm::JC;
    y[(row0 + (int64_t)(t0 + tt) * H) * HD + j0 + jj] = rt::from_f32<T>(acc);
  }
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(Geo<HD, R>::NT, 512 / Geo<HD, R>::NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            T* __restrict__ y, int S, int H) {
  using Gm = Geo<HD, R>;
  constexpr int JC = Gm::JC, TT = Gm::TT;
  constexpr int P = R / kUnit;                       // partials per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout<T, HD, R>(S);
  float* part = reinterpret_cast<float*>(smem + L.part_off);

  const int bh = blockIdx.x / (HD / JC);             // b * H + h
  const int b = bh / H, h = bh % H;
  const int j0 = (blockIdx.x % (HD / JC)) * JC;
  const int g = threadIdx.x / JC;   // the lane's rows: g R .. g R + R - 1
  const int jl = threadIdx.x % JC;  // its column: j0 + jl
  const int64_t row0 = (int64_t)b * S * H + h;  // (b, t, h) is row row0 + t H
  float* st = state + ((int64_t)bh * HD + g * R) * HD + j0 + jl;
  const int tiles = (S + TT - 1) / TT;

#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < tiles) load_tile<T, HD, R>(smem, L, n, r, k, v, w, row0, S, H, j0);
    cp_async_commit();
  }
  float uu[R], s[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    uu[q] = u[h * HD + g * R + q];
    s[q] = st[q * HD];
  }

  for (int n = 0; n < tiles; ++n) {
    cp_async_wait<kStages - 2>();     // tile n has landed (this thread's part)
    __syncthreads();                  // ... everyone's; stage n - 1 is free
    if (n + kStages - 1 < tiles)
      load_tile<T, HD, R>(smem, L, n + kStages - 1, r, k, v, w, row0, S, H,
                          j0);
    cp_async_commit();
    if (n > 0) store_y<T, HD, R>(part, L, n - 1, y, row0, S, H, j0);

    const int len = min(TT, S - n * TT);
    const T* sr = reinterpret_cast<const T*>(smem + (n % kStages) *
                                             L.stage_bytes) + g * R;
    const T* sk = sr + L.tts * HD;
    const T* sw = sk + L.tts * HD;
    const T* sv = reinterpret_cast<const T*>(smem + (n % kStages) *
                                             L.stage_bytes) +
                  3 * L.tts * HD + jl;
    float* pp = part + (n & 1) * Gm::U * L.ps + g * P * L.ps + jl;
#pragma unroll (16 / R)            // 4 steps at R = 4; 1 at R = 16
    for (int tt = 0; tt < len; ++tt) {
      float rr[R], kk[R], ww[R];
      load_rows(sr + tt * HD, rr);
      load_rows(sk + tt * HD, kk);
      load_rows(sw + tt * HD, ww);
      wkv_step(rr, kk, ww, rt::to_f32(sv[tt * JC]), uu, s, pp + tt * JC,
               L.ps);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) st[q * HD] = s[q];
  __syncthreads();
  if (tiles > 0) store_y<T, HD, R>(part, L, tiles - 1, y, row0, S, H, j0);
}

template <typename T, int HD, int R>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, void* y, int B, int S, int H,
           int smem, cudaStream_t stream) {
  using Gm = Geo<HD, R>;
  const Smem L = smem_layout<T, HD, R>(S);
  if (smem != L.bytes || L.bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, HD, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv6_kernel<T, HD, R><<<B * H * (HD / Gm::JC), Gm::NT, L.bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(state),
      static_cast<T*>(y), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, y: (B, S, H, hd) in dtype, 16-byte aligned; u: (H, hd) f32;
// state: (B, H, hd, hd) f32, read as the initial state and overwritten with
// the final one.  rows (R, 4 or 16) and smem (bytes) are the wrapper's
// geometry; a size other than this launcher's own is refused.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* state, void* y,
                           int B, int S, int H, int hd, int rows, int dtype,
                           int smem, void* stream) {
  if (B <= 0 || H <= 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_CASE(T, D, R)                                                  \
  if (hd == D && rows == R)                                               \
    return launch<T, D, R>(r, k, v, w, u, state, y, B, S, H, smem, st);
#define RT_DTYPE(T)                                                       \
  RT_CASE(T, 16, 4) RT_CASE(T, 32, 4) RT_CASE(T, 64, 4) RT_CASE(T, 128, 4)  \
  RT_CASE(T, 32, 16) RT_CASE(T, 64, 16) RT_CASE(T, 128, 16)
  if (dtype == rt::kDtypeF32) {
    RT_DTYPE(float)
  } else if (dtype == rt::kDtypeBF16) {
    RT_DTYPE(__nv_bfloat16)
  }
#undef RT_DTYPE
#undef RT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
