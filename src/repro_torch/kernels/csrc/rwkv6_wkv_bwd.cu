// The backward of the RWKV-6 WKV recurrence on Hopper, f32.
//
// The Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py (wkv6 ->
// _wkv_kernel) has no backward kernel: the JAX package trains through
// _wkv_scan (src/repro/models/ssm.py), and XLA differentiates the scan.
// This computes the gradients of csrc/rwkv6_wkv.cu's recurrence.  Per
// (b, h), with S the state before step t and dS the gradient of the state
// after it (at the last step, the gradient of the final state):
//   dr_t[i] = sum_j dy_t[j] S[i][j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j dS[i][j] v_t[j] + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i dS[i][j] k_t[i] + dy_t[j] (sum_i r_t[i] u[i] k_t[i])
//   dw_t[i] = sum_j dS[i][j] S[i][j]
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)        (summed over b and t)
//   dS     <- w_t[i] dS[i][j] + r_t[i] dy_t[j]   (the gradient of S)
// and after step 0, dS is the gradient of state0.
//
// Bound on an H100: operations.  Recomputing each step's state (a product
// and a fused multiply-add per state element) and the backward step (five
// fused multiply-adds and a product) are about 14 flops per state element
// and step: at rwkv6-1.6b's training shape (B 4, S 512, 32 heads of 64)
// 3.8 GFLOP, 0.056 ms at 67 TFLOP/s f32; its bytes (r, k, v, w and dy read,
// dr, dk, dv and dw written: 151 MB) take 0.045 ms.  The backward needs
// each step's state S, which the forward kernel does not keep (it is left
// as it was, so serving keeps its bits).  The design, simple and right:
//   * one CTA per (b, h), 4 hd threads; a thread owns hd / 16 rows by 4
//     columns of the hd x hd state and of dS, in registers (16 of each at
//     hd 64);
//   * a first pass runs the recurrence from state0 over the whole sequence
//     and writes the state at the start of every chunk of TC steps into an
//     f32 scratch tensor (TC = 32768 / hd^2, at most 64: 8 at hd 64);
//   * then, chunk by chunk from the last, the CTA reloads the chunk's first
//     state, recomputes the chunk's states into shared memory (128 KB, in
//     each thread's own layout), and walks the chunk's steps backwards,
//     carrying dS;
//   * the sums over a row's columns (dr, dk, dw) go through xor shuffles
//     within the hd / 4 lanes that share the row; the sums over a column's
//     rows (dv) through xor shuffles within a warp, then the warps'
//     partials in shared memory, added in warp order at the chunk's end;
//   * du's per-(b, h) sums land in a scratch tensor that a second kernel
//     adds over b in order;
//   * no atomics and every sum in a fixed order: the same inputs give the
//     same bits.
#include <stdint.h>

#include "common.cuh"

namespace {

template <int HD>
struct Geo {
  static constexpr int NT = 4 * HD;               // threads per CTA
  static constexpr int RI = HD / 16;              // rows per thread
  static constexpr int CG = HD / 4;               // lanes sharing a row
  static constexpr int E = 4 * RI;                // state elements a thread
  static constexpr int NW = NT / 32;              // warps
  static constexpr int TC = (32768 / (HD * HD)) < 64 ? 32768 / (HD * HD) : 64;
  static_assert(HD % 16 == 0 && CG <= 32, "geometry");
  // floats of shared memory: chunk states, the chunk's r, k, v, w and dy,
  // u, the per-step dots, dv's warp partials, and dr, dk, dw
  static constexpr int kStates = TC * E * NT;
  static constexpr int kFloats = kStates + 5 * TC * HD + HD + 2 * TC +
                                 TC * NW * HD + 3 * TC * HD;
};

template <int HD>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int b, int h, int t0, int n, int S,
                                           int H) {
  for (int idx = threadIdx.x; idx < n * HD; idx += Geo<HD>::NT) {
    const int t = idx / HD, i = idx - t * HD;
    dst[idx] = src[((size_t(b) * S + t0 + t) * H + h) * HD + i];
  }
}

template <int HD>
__global__ void __launch_bounds__(Geo<HD>::NT)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ state0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dstate, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ du_part,
                    float* __restrict__ dstate0, float* __restrict__ ckpt,
                    int S, int H) {
  using G = Geo<HD>;
  constexpr int TC = G::TC, E = G::E, RI = G::RI, CG = G::CG, NT = G::NT;
  extern __shared__ float smem[];
  float* sst = smem;                        // [TC][E][NT]
  float* sr = sst + G::kStates;             // [TC][HD] each
  float* sk = sr + TC * HD;
  float* sv = sk + TC * HD;
  float* sw = sv + TC * HD;
  float* sdy = sw + TC * HD;
  float* su = sdy + TC * HD;                // [HD]
  float* vdy = su + HD;                     // [TC]: v_t . dy_t
  float* rku = vdy + TC;                    // [TC]: sum_i r u k
  float* pdv = rku + TC;                    // [TC][NW][HD]
  float* odr = pdv + TC * G::NW * HD;       // [TC][HD] each
  float* odk = odr + TC * HD;
  float* odw = odk + TC * HD;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid / CG, cg = tid - rg * CG;
  const int i0 = rg * RI, j0 = cg * 4;
  const int nc = (S + TC - 1) / TC;
  float* my_ckpt = ckpt + size_t(bh) * nc * E * NT;
  const size_t sbase = size_t(bh) * HD * HD;
  for (int i = tid; i < HD; i += NT) su[i] = u[h * HD + i];

  // pass 1: the state at the start of each chunk
  float st[E];
#pragma unroll
  for (int a = 0; a < RI; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st[a * 4 + c] = state0 != nullptr
                          ? state0[sbase + (i0 + a) * HD + j0 + c] : 0.f;
  for (int ch = 0; ch < nc; ++ch) {
    const int t0 = ch * TC, n = min(TC, S - t0);
#pragma unroll
    for (int e = 0; e < E; ++e) my_ckpt[(size_t(ch) * E + e) * NT + tid] = st[e];
    __syncthreads();
    load_chunk<HD>(sk, k, b, h, t0, n, S, H);
    load_chunk<HD>(sv, v, b, h, t0, n, S, H);
    load_chunk<HD>(sw, w, b, h, t0, n, S, H);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const float kk = sk[t * HD + i0 + a], ww = sw[t * HD + i0 + a];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st[a * 4 + c] = fmaf(ww, st[a * 4 + c], kk * sv[t * HD + j0 + c]);
      }
    }
  }

  // pass 2: chunks in reverse, each recomputed, then walked backwards
  float ds[E];
#pragma unroll
  for (int a = 0; a < RI; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ds[a * 4 + c] = dstate != nullptr
                          ? dstate[sbase + (i0 + a) * HD + j0 + c] : 0.f;
  float du[RI];
#pragma unroll
  for (int a = 0; a < RI; ++a) du[a] = 0.f;
  for (int ch = nc - 1; ch >= 0; --ch) {
    const int t0 = ch * TC, n = min(TC, S - t0);
    __syncthreads();
    load_chunk<HD>(sr, r, b, h, t0, n, S, H);
    load_chunk<HD>(sk, k, b, h, t0, n, S, H);
    load_chunk<HD>(sv, v, b, h, t0, n, S, H);
    load_chunk<HD>(sw, w, b, h, t0, n, S, H);
    load_chunk<HD>(sdy, dy, b, h, t0, n, S, H);
    __syncthreads();
    // the per-step dots, one warp per step, lanes over the head dim
    for (int t = warp; t < n; t += G::NW) {
      float a1 = 0.f, a2 = 0.f;
      for (int i = lane; i < HD; i += 32) {
        a1 = fmaf(sv[t * HD + i], sdy[t * HD + i], a1);
        a2 = fmaf(sr[t * HD + i] * su[i], sk[t * HD + i], a2);
      }
      a1 = rt::warp_sum(a1);
      a2 = rt::warp_sum(a2);
      if (lane == 0) {
        vdy[t] = a1;
        rku[t] = a2;
      }
    }
    // the chunk's states, before each of its steps
#pragma unroll
    for (int e = 0; e < E; ++e) st[e] = my_ckpt[(size_t(ch) * E + e) * NT + tid];
    for (int t = 0; t < n; ++t) {
#pragma unroll
      for (int e = 0; e < E; ++e) sst[(t * E + e) * NT + tid] = st[e];
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const float kk = sk[t * HD + i0 + a], ww = sw[t * HD + i0 + a];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st[a * 4 + c] = fmaf(ww, st[a * 4 + c], kk * sv[t * HD + j0 + c]);
      }
    }
    __syncthreads();                 // vdy and rku
    for (int t = n - 1; t >= 0; --t) {
      float vv[4], yy[4], dvp[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        vv[c] = sv[t * HD + j0 + c];
        yy[c] = sdy[t * HD + j0 + c];
        dvp[c] = 0.f;
      }
      const float vd = vdy[t];
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int i = i0 + a;
        const float rr = sr[t * HD + i], kk = sk[t * HD + i],
                    ww = sw[t * HD + i];
        float drp = 0.f, dwp = 0.f, dkp = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = a * 4 + c;
          const float sp = sst[(t * E + e) * NT + tid];
          drp = fmaf(yy[c], sp, drp);
          dwp = fmaf(ds[e], sp, dwp);
          dkp = fmaf(ds[e], vv[c], dkp);
          dvp[c] = fmaf(ds[e], kk, dvp[c]);
          ds[e] = fmaf(ww, ds[e], rr * yy[c]);
        }
#pragma unroll
        for (int o = CG / 2; o > 0; o >>= 1) {
          drp += __shfl_xor_sync(rt::kFull, drp, o);
          dwp += __shfl_xor_sync(rt::kFull, dwp, o);
          dkp += __shfl_xor_sync(rt::kFull, dkp, o);
        }
        if (cg == 0) {
          const float uu = su[i];
          odr[t * HD + i] = fmaf(uu * kk, vd, drp);
          odk[t * HD + i] = fmaf(rr * uu, vd, dkp);
          odw[t * HD + i] = dwp;
          du[a] = fmaf(rr * kk, vd, du[a]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int o = CG; o < 32; o <<= 1)
          dvp[c] += __shfl_xor_sync(rt::kFull, dvp[c], o);
      }
      if (lane < CG) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pdv[(t * G::NW + warp) * HD + j0 + c] = dvp[c];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int t = idx / HD, i = idx - t * HD;
      float s = 0.f;
      for (int wp = 0; wp < G::NW; ++wp) s += pdv[(t * G::NW + wp) * HD + i];
      const size_t o = ((size_t(b) * S + t0 + t) * H + h) * HD + i;
      dv[o] = fmaf(sdy[idx], rku[t], s);
      dr[o] = odr[idx];
      dk[o] = odk[idx];
      dw[o] = odw[idx];
    }
  }
#pragma unroll
  for (int a = 0; a < RI; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dstate0[sbase + (i0 + a) * HD + j0 + c] = ds[a * 4 + c];
  if (cg == 0) {
#pragma unroll
    for (int a = 0; a < RI; ++a) du_part[size_t(bh) * HD + i0 + a] = du[a];
  }
}

// du[h][i] = sum_b du_part[b][h][i], b in order
__global__ void du_sum_kernel(const float* __restrict__ du_part,
                              float* __restrict__ du, int B, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[size_t(b) * n + x];
  du[x] = s;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* state0, const float* dy,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, float* scratch, int B, int S, int H,
           int chunk, cudaStream_t s) {
  using G = Geo<HD>;
  if (chunk != G::TC) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 4 * G::kFloats;
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // scratch: du's per-(b, h) partials, then the chunk states
  float* du_part = scratch;
  float* ckpt = scratch + size_t(B) * H * HD;
  wkv6_bwd_kernel<HD><<<B * H, G::NT, bytes, s>>>(
      r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du_part, dstate0,
      ckpt, S, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n = H * HD;
  du_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(du_part, du, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, dy, dr, dk, dv, dw: (B, S, H, hd) f32; u, du: (H, hd);
// state0 (may be null: zero), dstate (the final state's gradient; may be
// null: zero) and dstate0: (B, H, hd, hd); scratch: B H hd floats, then
// B H ceil(S / chunk) hd^2.  chunk is the wrapper's steps per chunk, refused
// if it is not this launcher's own.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* state0, const void* dy,
                               const void* dstate, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* dstate0,
                               void* scratch, int B, int S, int H, int hd,
                               int chunk, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_CASE(D)                                                          \
  if (hd == D)                                                              \
    return launch<D>(                                                       \
        static_cast<const float*>(r), static_cast<const float*>(k),         \
        static_cast<const float*>(v), static_cast<const float*>(w),         \
        static_cast<const float*>(u), static_cast<const float*>(state0),    \
        static_cast<const float*>(dy), static_cast<const float*>(dstate),   \
        static_cast<float*>(dr), static_cast<float*>(dk),                   \
        static_cast<float*>(dv), static_cast<float*>(dw),                   \
        static_cast<float*>(du), static_cast<float*>(dstate0),              \
        static_cast<float*>(scratch), B, S, H, chunk, s);
  RT_CASE(16) RT_CASE(32) RT_CASE(64) RT_CASE(128)
#undef RT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
