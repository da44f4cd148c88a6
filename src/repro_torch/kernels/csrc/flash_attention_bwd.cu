// The backward of flash attention on Hopper: dQ, dK and dV, over f32 or
// bf16 inputs.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) has no backward kernel: the JAX
// package trains through flash_attention_jnp (src/repro/models/layers.py),
// and XLA differentiates it.  This computes the gradients of the forward
// kernel of csrc/flash_attention.cu, for every (hd, hdv) it takes, causal,
// windowed or full, GQA, at any q_offset, in f32 or bf16.  With x = scale *
// q.k over
// the keys a row may see, p = softmax(x), o = p.v and the incoming dO:
//   D_i  = sum_c dO_ic o_ic
//   dV_j = sum_i p_ij dO_i
//   dS_ij = p_ij (dO_i . v_j - D_i)
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
// (dK and dV summed over the G query heads of a kv head).
//
// Bound on an H100: operations.  The least work is 5 products of hd per
// visible (row, key) pair: S = Q.K^T, dP = dO.V^T, dV, dK and dQ; at the
// training shape of qwen1.5-0.5b (B 4, Sq = Skv = 512, 16 heads of 64,
// causal) 5.4 GFLOP, 0.033 ms as three TF32 products each at 495 TFLOP/s.
// The forward keeps no log-sum-exp (its bits stay as they are), so a row
// pass recomputes it: 6 products of hd a pair.  The design:
//   * row_kernel, one CTA per (query tile of BQ rows, b, h), tiles with the
//     most keys first: S on the tensor cores over the key tiles the rows
//     see (a 2-stage cp.async ring of K tiles), an online max and sum per
//     row, and D = dO . o; each row's LSE (log2 domain) and D go to an f32
//     scratch tensor, rows padded to a multiple of 64;
//   * dkdv_kernel, one CTA per (key tile of BK keys, b, kv head), key tile
//     0 first (under a causal mask it sees the most query tiles): K and V
//     stay in shared memory while the CTA walks the G heads of the group
//     and the query tiles that see its keys.  Q, dO, LSE and D of the next
//     tile arrive by 16-byte cp.async into a 2-stage ring while the current
//     tile's products run.  Per tile, S and dP (8 warps as RA row tiles x
//     CA key groups), P = exp2(S scale log2e - LSE) where visible and dS =
//     P (dP - D), written to shared memory as P^T and dS^T (rows: keys) and
//     dS (rows: queries); then dV += P^T.dO and dK += dS^T.Q in registers
//     (RB key row tiles x CB column groups), and the tile's part of dQ, dS.K
//     (RQ row tiles x CQ column groups), written as this key tile's f32
//     partial into a scratch tensor (B x H x key tiles x Sq x hd);
//   * dq_combine_kernel sums each row's partials over the key tiles the row
//     sees, in key-tile order, times scale: the same rule as
//     flash_combine_kernel's spans in the forward;
//   * every product is m16n8k8 TF32 mma.sync in 3xTF32 (csrc/mma.cuh).
//     Operands loaded from global rows sit at a stride of D + 4 floats:
//     read with k along a row (S, dP) lanes (g, t) hit banks 4g + t; read
//     with k down the rows (dV's dO, dK's Q, dQ's K) each k-step takes its
//     keys or rows in the order 0, 2, 4, 6, 1, 3, 5, 7, so rows 2t and 2t+1
//     at column g hit banks 8t + g.  P^T, dS^T and dS, written here, are
//     padded by 8 so that their A operands load as float2 pairs (k = 2t,
//     2t + 1) without conflicts;
//   * geometry (Geo, mirrored by kernels/flash_attention.py::_bwd_geometry
//     and checked by the launcher): BQ 64 at hd <= 64, else 32; BK 64, or
//     32 at hd 256.  Shared memory of dkdv_kernel: 160,768 B at (64, 64),
//     165,376 B at (128, 128), 198,144 B at (192, 128), 215,552 B at (256,
//     256): every pair runs this design;
//   * masks as the forward: keys at or past Skv, past the row's position
//     when causal, and outside the window; a row that sees no key has
//     P = 0 and zero gradients, as the plain version's;
//   * no atomics, and every sum has a fixed order (k-steps in order,
//     independent accumulator chains added in order, row maxima and sums by
//     xor shuffles, the row pass's key groups and the combine's key tiles
//     in order): two calls give the same bits.
//   * bf16 (the reference's default training dtype): q, k, v, o and dO are
//     widened exactly to f32 on their way into the f32 tiles (16-byte
//     loads of 8 elements into registers, then st.shared; cp.async cannot
//     widen), and everything after is the f32 path above: the same tiles,
//     shared memory, products and summation order.  dK and dV are summed
//     over the group's heads in f32 and dQ's partials stay f32; each
//     gradient is rounded once, to nearest even, as it is stored.  So the
//     bf16 backward equals the f32 backward of the widened inputs rounded
//     to bf16, bit for bit (chip_smoke.py phase 21 holds it).  A bf16 tile
//     would halve the loads, but the f32 tiles already fill shared memory
//     at (256, 256) and the products stay 3xTF32: bf16 tensor-core
//     products (m16n8k16, wgmma) are later work.
// On an H100 at qwen1.5-0.5b's training call (tools/kernel_stages.py bwd)
// the main kernel takes 0.73 of a call, the row pass 0.20 and the combine
// 0.06: the row pass's sixth product and the 3xTF32 splits and fragment
// loads, as in the forward, set the pace.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::mma_3xtf32;
using rt::split;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStatsRows = 64;     // LSE and D rows padded to a multiple
constexpr int kCombineThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int HDV>
struct Geo {
  static constexpr int BK = HD > 192 ? 32 : 64;                 // keys
  static constexpr int BQ = (HD > 64 || HDV > 64) ? 32 : 64;    // rows
  static constexpr int QS = HD + 4;    // shared-memory row stride of Q, K
  static constexpr int VS = HDV + 4;   // of dO, V
  static constexpr int TS = BQ + 8;    // of P^T, dS^T (rows: keys)
  static constexpr int NS = BK + 8;    // of dS (rows: queries)
  // S and dP (BQ x BK): RA row tiles x CA key groups of KA keys
  static constexpr int RA = BQ / 16, CA = kWarps / RA, KA = BK / CA;
  static constexpr int NA = KA / 8;
  // dV and dK (BK x HDV, BK x HD): RB row tiles x CB column groups
  static constexpr int RB = BK / 16, CB = kWarps / RB;
  static constexpr int NV = HDV / CB / 8, ND = HD / CB / 8;
  // dQ's partial (BQ x HD): RQ row tiles x CQ column groups
  static constexpr int RQ = BQ / 16, CQ = kWarps / RQ, NQ = HD / CQ / 8;
  static_assert(NA >= 1 && NV >= 1 && ND >= 1 && NQ >= 1, "geometry");
  static_assert(HDV % (8 * CB) == 0 && HD % (8 * CB) == 0 &&
                HD % (8 * CQ) == 0, "column groups");
  // floats of shared memory: K, V; 2 stages of Q, dO, LSE and D; P^T,
  // dS^T, dS.  The row pass: Q, 2 stages of K, each warp's row maxima and
  // sums
  static constexpr int kMain = BK * (QS + VS) + 2 * BQ * (QS + VS) + 4 * BQ +
                               2 * BK * TS + BQ * NS;
  static constexpr int kRow = BQ * QS + 2 * BK * QS + 2 * kWarps * 16;
};

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;   // float or __nv_bfloat16
  T *dq, *dk, *dv;
  float *lse, *dd, *part;   // scratch: (B H Sqp) each, then the partials
  int B, Sq, Skv, H, Kh, q_offset, causal, window, Sqp, nkt;
  float scale;
};

__device__ __forceinline__ bool visible(int qp, int key, int Skv, int causal,
                                        int window) {
  if (key >= Skv) return false;
  if (!causal) return true;
  return key <= qp && (window == 0 || key > qp - window);
}

// rows [r0, r0 + R) of a (B, S, Hx, D) tensor at (b, head) into shared
// f32 rows of stride D + 4; rows past S as zeros.  f32 by 16-byte
// cp.async; bf16 by 16-byte loads of 8 elements into registers (all of a
// thread's pieces in flight at once), each widened exactly to f32 and
// stored, so the tile holds the same floats as the f32 path's would
template <int D, int R, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b,
                                          int head, int r0, int S, int Hx) {
  if constexpr (std::is_same_v<T, float>) {
    constexpr int C4 = D / 4;
    for (int idx = threadIdx.x; idx < R * C4; idx += kThreads) {
      const int r = idx / C4, c = idx - r * C4;
      const int row = r0 + r;
      const bool ok = row < S;
      cp_async16(dst + r * (D + 4) + 4 * c,
                 src + ((size_t(b) * S + (ok ? row : 0)) * Hx + head) * D +
                     4 * c,
                 ok);
    }
  } else {
    constexpr int C8 = D / 8, N = (R * C8 + kThreads - 1) / kThreads;
    uint4 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / C8, c = idx - r * C8;
      x[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < R * C8 && r0 + r < S)
        x[i] = *reinterpret_cast<const uint4*>(
            src + ((size_t(b) * S + r0 + r) * Hx + head) * D + 8 * c);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx >= R * C8) continue;
      const int r = idx / C8, c = idx - r * C8;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x[i]);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      float* d = dst + r * (D + 4) + 8 * c;
      *reinterpret_cast<float4*>(d) = make_float4(f0.x, f0.y, f1.x, f1.y);
      *reinterpret_cast<float4*>(d + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
}

// 4 consecutive elements at p (16-byte aligned for f32, 8 for bf16), each
// widened exactly to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// (x, y) at p, each rounded once to T (to nearest even for bf16)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// acc (16 rows x 8 N) = A . B^T over KD: A(m, k) = a[m AS + k] (k along a
// row), B rows n = 8 j + g at b (stride BS).  Chains of k-steps accumulate
// apart (CH of them where N is small) and are added in order at the end.
// The k-steps are unrolled by pairs of chain blocks, not in full: a full
// unroll hoists every k-step's operands and spills.
template <int KD, int N, int AS, int BS>
__device__ __forceinline__ void rows_dot(float (&acc)[N][4], const float* a,
                                         const float* b, int g, int t) {
  constexpr int CH = N >= 4 ? 1 : 4 / N;
  static_assert((KD / 8) % CH == 0, "k-steps per chain");
  float c[CH][N][4];
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int j = 0; j < N; ++j)
      c[h][j][0] = c[h][j][1] = c[h][j][2] = c[h][j][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < KD / 8; k0 += CH) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      const int col = 8 * (k0 + h) + t;
      uint32_t ab[4], as[4];
      split(a[g * AS + col], ab[0], as[0]);
      split(a[(g + 8) * AS + col], ab[1], as[1]);
      split(a[g * AS + col + 4], ab[2], as[2]);
      split(a[(g + 8) * AS + col + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float* br = b + (8 * j + g) * BS + col;
        mma_3xtf32(c[h][j], ab, as, br[0], br[4]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = c[0][j][e];
#pragma unroll
      for (int h = 1; h < CH; ++h) x += c[h][j][e];
      acc[j][e] = x;
    }
}

// acc (16 rows x 8 N) += A . B over K = 8 KS: A(m, k) = at[m ATS + k], read
// as float2 pairs (k = 2t, 2t + 1 as the fragment's k = t, t + 4); B(k, n)
// = b[k BS + n], rows 2t and 2t + 1 at columns 8 n + g.  Unrolled by 2.
template <int KS, int N, int ATS, int BS>
__device__ __forceinline__ void cols_acc(float (&acc)[N][4], const float* at,
                                         const float* b, int g, int t) {
#pragma unroll 2
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 8 * ks + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(at + g * ATS + k0);
    const float2 x1 =
        *reinterpret_cast<const float2*>(at + (g + 8) * ATS + k0);
    uint32_t ab[4], as[4];
    split(x0.x, ab[0], as[0]);
    split(x1.x, ab[1], as[1]);
    split(x0.y, ab[2], as[2]);
    split(x1.y, ab[3], as[3]);
    const float* b0 = b + k0 * BS + g;
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_3xtf32(acc[n], ab, as, b0[8 * n], b0[BS + 8 * n]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// the key range [lo, hi) the rows [q0, q0 + R) of a query tile may see
template <typename T>
__device__ __forceinline__ void key_range(const Args<T>& a, int q0, int R,
                                          int& lo, int& hi) {
  const int last = min(q0 + R, a.Sq) - 1;
  lo = 0;
  hi = a.Skv;
  if (a.causal) {
    hi = max(0, min(a.Skv, a.q_offset + last + 1));
    if (a.window) lo = max(0, a.q_offset + q0 - a.window + 1);
  }
}

// ---------------------------------------------------------------------------
// row pass: LSE (log2 domain) and D per query row
// ---------------------------------------------------------------------------
template <int HD, int HDV, typename T>
__global__ void __launch_bounds__(kThreads, 1) row_kernel(const Args<T> a) {
  using G = Geo<HD, HDV>;
  constexpr int BQ = G::BQ, BK = G::BK, QS = G::QS, NA = G::NA;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * QS;              // 2 stages of BK * QS
  float* red = ks + 2 * BK * QS;         // [warp][16 rows][m, l]
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.Kh);
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp % G::RA, ca = warp / G::RA;
  const float c2 = a.scale * kLog2e;
  int lo, hi;
  key_range(a, q0, BQ, lo, hi);
  const int kt0 = lo / BK;
  const int nk = hi > lo ? (hi - 1) / BK - kt0 + 1 : 0;
  load_rows<HD, BQ>(qs, a.q, b, h, q0, a.Sq, a.H);
  if (nk > 0) load_rows<HD, BK>(ks, a.k, b, kvh, kt0 * BK, a.Skv, a.Kh);
  cp_async_commit();
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk)
      load_rows<HD, BK>(ks + ((it + 1) & 1) * BK * QS, a.k, b, kvh,
                        (kt0 + it + 1) * BK, a.Skv, a.Kh);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (kt0 + it) * BK + ca * G::KA;
    float s[NA][4];
    rows_dot<HD, NA, QS, QS>(s, qs + 16 * ra * QS,
                             ks + (it & 1) * BK * QS + ca * G::KA * QS, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = a.q_offset + q0 + 16 * ra + g + 8 * r;
      float x[NA][2], mx = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = visible(qp, k0 + 8 * j + 2 * t + e, a.Skv,
                                   a.causal, a.window);
          x[j][e] = vis ? s[j][2 * r + e] * c2 : rt::kNegInf;
          mx = fmaxf(mx, x[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 2));
      const float mn = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += x[j][e] > 0.5f * rt::kNegInf ? exp2f(x[j][e] - mn) : 0.f;
      l[r] = l[r] * exp2f(m[r] - mn) + sum;
      m[r] = mn;
    }
    __syncthreads();               // this stage read before it is refilled
  }
  cp_async_wait<0>();              // no copy outlives the CTA (nk = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(rt::kFull, l[r], 1);
    l[r] += __shfl_xor_sync(rt::kFull, l[r], 2);
    if (t == 0) {
      red[(warp * 16 + g + 8 * r) * 2] = m[r];
      red[(warp * 16 + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  // D = dO . o, the row's columns split over TPR neighbouring lanes
  constexpr int TPR = kThreads / BQ, CW = HDV / TPR;
  const int dr = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int drow = q0 + dr;
  float d = 0.f;
  if (drow < a.Sq) {
    const size_t base =
        ((size_t(b) * a.Sq + drow) * a.H + h) * HDV + part * CW;
#pragma unroll
    for (int c = 0; c < CW; c += 4) {
      const float4 x = load4(a.dout + base + c);
      const float4 y = load4(a.o + base + c);
      d = fmaf(x.x, y.x, d);
      d = fmaf(x.y, y.y, d);
      d = fmaf(x.z, y.z, d);
      d = fmaf(x.w, y.w, d);
    }
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) d += __shfl_xor_sync(rt::kFull, d, o);
  __syncthreads();
  if (part == 0) {
    // the CA key groups' (m, l) of this row, merged in group order
    const int ra_ = dr / 16, rr = dr % 16;
    float M = rt::kNegInf;
#pragma unroll
    for (int c = 0; c < G::CA; ++c)
      M = fmaxf(M, red[((c * G::RA + ra_) * 16 + rr) * 2]);
    float L = 0.f;
#pragma unroll
    for (int c = 0; c < G::CA; ++c) {
      const float* mc = red + ((c * G::RA + ra_) * 16 + rr) * 2;
      L += mc[1] * exp2f(mc[0] - M);
    }
    const size_t i = size_t(bh) * a.Sqp + drow;
    const bool live = drow < a.Sq;
    a.lse[i] = live && L > 0.f ? M + log2f(L) : 0.f;
    a.dd[i] = live ? d : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dK, dV and dQ's key-tile partials: one CTA per (key tile, b, kv head)
// ---------------------------------------------------------------------------
template <int HD, int HDV, typename T>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(const Args<T> a) {
  using G = Geo<HD, HDV>;
  constexpr int BQ = G::BQ, BK = G::BK, QS = G::QS, VS = G::VS;
  constexpr int TS = G::TS, NS = G::NS, NA = G::NA;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BK * QS;
  float* qs = vs + BK * VS;             // 2 stages of BQ * QS
  float* os = qs + 2 * BQ * QS;         // dO: 2 stages of BQ * VS
  float* st = os + 2 * BQ * VS;         // 2 stages of LSE[BQ], D[BQ]
  float* pt = st + 4 * BQ;              // P^T [BK][TS]
  float* dt = pt + BK * TS;             // dS^T [BK][TS]
  float* dn = dt + BK * TS;             // dS [BQ][NS]
  const int bk = blockIdx.x, b = bk / a.Kh, kvh = bk - b * a.Kh;
  const int kt = blockIdx.y, k0 = kt * BK;
  const int Gq = a.H / a.Kh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c2 = a.scale * kLog2e;
  // the query tiles with a row that may see a key of [k0, k0 + BK)
  int rlo = 0, rhi = a.Sq;
  if (a.causal) {
    rlo = max(0, k0 - a.q_offset);
    if (a.window) rhi = min(a.Sq, k0 + BK - 1 + a.window - a.q_offset);
  }
  const int qt0 = rlo / BQ;
  const int nq = rhi > rlo ? (rhi - 1) / BQ - qt0 + 1 : 0;
  const int n_it = Gq * nq;
  // item it: head kvh G + it / nq, query tile qt0 + it % nq
  auto load_item = [&](int it) {
    const int s = it & 1, h = kvh * Gq + it / nq;
    const int q0 = (qt0 + it % nq) * BQ;
    load_rows<HD, BQ>(qs + s * BQ * QS, a.q, b, h, q0, a.Sq, a.H);
    load_rows<HDV, BQ>(os + s * BQ * VS, a.dout, b, h, q0, a.Sq, a.H);
    const size_t r0 = size_t(b * a.H + h) * a.Sqp + q0;
    for (int idx = threadIdx.x; idx < BQ / 2; idx += kThreads) {
      const int which = idx / (BQ / 4), c = idx % (BQ / 4);
      cp_async16(st + s * 2 * BQ + which * BQ + 4 * c,
                 (which ? a.dd : a.lse) + r0 + 4 * c, true);
    }
  };
  load_rows<HD, BK>(ks, a.k, b, kvh, k0, a.Skv, a.Kh);
  load_rows<HDV, BK>(vs, a.v, b, kvh, k0, a.Skv, a.Kh);
  if (n_it > 0) load_item(0);
  cp_async_commit();
  float dk[G::ND][4], dv[G::NV][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_item(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = it & 1, h = kvh * Gq + it / nq;
    const int q0 = (qt0 + it % nq) * BQ;
    const float* qst = qs + s * BQ * QS;
    const float* ost = os + s * BQ * VS;
    {
      // S and dP, then P and dS, into shared memory
      const int ra = warp % G::RA, ca = warp / G::RA;
      const float* lse = st + s * 2 * BQ;
      const float* dd = lse + BQ;
      float p[NA][4], ds[NA][4];
      rows_dot<HD, NA, QS, QS>(p, qst + 16 * ra * QS,
                               ks + ca * G::KA * QS, g, t);
      rows_dot<HDV, NA, VS, VS>(ds, ost + 16 * ra * VS,
                                vs + ca * G::KA * VS, g, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 16 * ra + g + 8 * r, row = q0 + rl;
        const int qp = a.q_offset + row;
        const float L = lse[rl], D = dd[rl];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = ca * G::KA + 8 * j + 2 * t + e;
            const bool vis = row < a.Sq &&
                             visible(qp, k0 + cl, a.Skv, a.causal, a.window);
            const float pv =
                vis ? exp2f(fmaf(p[j][2 * r + e], c2, -L)) : 0.f;
            const float dsv = vis ? pv * (ds[j][2 * r + e] - D) : 0.f;
            pt[cl * TS + rl] = pv;
            dt[cl * TS + rl] = dsv;
            ds[j][2 * r + e] = dsv;
          }
          *reinterpret_cast<float2*>(dn + rl * NS + ca * G::KA + 8 * j +
                                     2 * t) =
              make_float2(ds[j][2 * r], ds[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();
    {
      // dV += P^T.dO and dK += dS^T.Q; this key tile's part of dQ, dS.K
      const int rb = warp % G::RB, cb = warp / G::RB;
      cols_acc<BQ / 8, G::NV, TS, VS>(dv, pt + 16 * rb * TS,
                                      ost + cb * (HDV / G::CB), g, t);
      cols_acc<BQ / 8, G::ND, TS, QS>(dk, dt + 16 * rb * TS,
                                      qst + cb * (HD / G::CB), g, t);
      const int rq = warp % G::RQ, cq = warp / G::RQ;
      float dq[G::NQ][4];
      zero(dq);
      cols_acc<BK / 8, G::NQ, NS, QS>(dq, dn + 16 * rq * NS,
                                      ks + cq * (HD / G::CQ), g, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * rq + g + 8 * r;
        if (row >= a.Sq) continue;
        float* pp = a.part +
                    ((size_t(b * a.H + h) * a.nkt + kt) * a.Sq + row) * HD +
                    cq * (HD / G::CQ) + 2 * t;
#pragma unroll
        for (int n = 0; n < G::NQ; ++n)
          *reinterpret_cast<float2*>(pp + 8 * n) =
              make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
      }
    }
    __syncthreads();                 // this stage and P, dS read
  }
  cp_async_wait<0>();                // no copy outlives the CTA (n_it = 0)
  const int rb = warp % G::RB, cb = warp / G::RB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * rb + g + 8 * r;
    if (key >= a.Skv) continue;
    const size_t row = (size_t(b) * a.Skv + key) * a.Kh + kvh;
    T* pk = a.dk + row * HD + cb * (HD / G::CB) + 2 * t;
    T* pv = a.dv + row * HDV + cb * (HDV / G::CB) + 2 * t;
#pragma unroll
    for (int n = 0; n < G::ND; ++n)
      store2(pk + 8 * n, dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
#pragma unroll
    for (int n = 0; n < G::NV; ++n)
      store2(pv + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dQ: each row's key-tile partials summed in key-tile order, times scale
// ---------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(kCombineThreads)
    dq_combine_kernel(const Args<T> a, int BK) {
  constexpr int C4 = HD / 4;
  const int idx = blockIdx.x * kCombineThreads + threadIdx.x;
  const int row = idx / C4, c = idx - row * C4;
  if (row >= a.Sq) return;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int qp = a.q_offset + row;
  int klo = 0, khi = a.Skv - 1;
  if (a.causal) {
    khi = min(khi, qp);
    if (a.window) klo = max(0, qp - a.window + 1);
  }
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (khi >= klo) {
    const float* pp = a.part + (size_t(bh) * a.nkt * a.Sq + row) * HD + 4 * c;
    for (int kt = klo / BK; kt <= khi / BK; ++kt) {
      const float4 x =
          *reinterpret_cast<const float4*>(pp + size_t(kt) * a.Sq * HD);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
  }
  T* pq = a.dq + ((size_t(b) * a.Sq + row) * a.H + h) * HD + 4 * c;
  store2(pq, s.x * a.scale, s.y * a.scale);
  store2(pq + 2, s.z * a.scale, s.w * a.scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD, int HDV, typename T>
int launch(const Args<T>& a, int keys, int rows, int smem, int row_smem,
           cudaStream_t s) {
  using G = Geo<HD, HDV>;
  constexpr int main_bytes = 4 * G::kMain, row_bytes = 4 * G::kRow;
  static_assert(main_bytes <= kMaxSmem && row_bytes <= kMaxSmem,
                "tiles do not fit in shared memory");
  if (keys != G::BK || rows != G::BQ || smem != main_bytes ||
      row_smem != row_bytes || a.Sqp % kStatsRows != 0 ||
      a.nkt != (a.Skv + G::BK - 1) / G::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if ((e = allow_smem(row_kernel<HD, HDV, T>, row_bytes)) != cudaSuccess ||
      (e = allow_smem(dkdv_kernel<HD, HDV, T>, main_bytes)) != cudaSuccess)
    return static_cast<int>(e);
  const int nq = (a.Sq + G::BQ - 1) / G::BQ;
  row_kernel<HD, HDV, T><<<dim3(a.B * a.H, nq), kThreads, row_bytes, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<HD, HDV, T>
      <<<dim3(a.B * a.Kh, a.nkt), kThreads, main_bytes, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n = a.Sq * (HD / 4);
  dq_combine_kernel<HD, T>
      <<<dim3((n + kCombineThreads - 1) / kCombineThreads, a.B * a.H),
         kCombineThreads, 0, s>>>(a, G::BK);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv,
                 void* scratch, int B, int Sq, int Skv, int H, int Kh, int hd,
                 int hdv, int q_offset, int causal, int window, float scale,
                 int keys, int rows, int smem, int row_smem, cudaStream_t s) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dout = static_cast<const T*>(dout);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Kh = Kh;
  a.q_offset = q_offset;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.Sqp = (Sq + kStatsRows - 1) / kStatsRows * kStatsRows;
  a.nkt = (Skv + keys - 1) / keys;
  a.lse = static_cast<float*>(scratch);
  a.dd = a.lse + size_t(B) * H * a.Sqp;
  a.part = a.dd + size_t(B) * H * a.Sqp;
#define RT_CASE(D, DV)    \
  if (hd == D && hdv == DV) \
    return launch<D, DV, T>(a, keys, rows, smem, row_smem, s);
  RT_CASE(16, 16) RT_CASE(32, 32) RT_CASE(64, 64) RT_CASE(128, 128)
  RT_CASE(192, 128) RT_CASE(256, 256)
#undef RT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Sq, H, hd), k (B, Skv, Kh, hd), v (B, Skv, Kh, hdv), o and dout
// (B, Sq, H, hdv), all of one dtype (0 f32, 1 bf16), contiguous and
// 16-byte aligned; writes dq, dk, dv (shaped as q, k, v, in that dtype).
// scratch (f32): each row's LSE and D (2 B H Sqp floats, Sqp = Sq rounded
// up to 64), then dQ's partials (B H ceil(Skv / keys) Sq hd floats).
// keys, rows, smem and row_smem are the wrapper's geometry
// (kernels/flash_attention.py::_bwd_geometry), refused if they are not
// this launcher's own.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int B,
    int Sq, int Skv, int H, int Kh, int hd, int hdv, int q_offset,
    int causal, int window, float scale, int dtype, int keys, int rows,
    int smem, int row_smem, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || H % Kh != 0 || keys <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kDtypeF32)
    return launch_dtype<float>(q, k, v, o, dout, dq, dk, dv, scratch, B, Sq,
                               Skv, H, Kh, hd, hdv, q_offset, causal, window,
                               scale, keys, rows, smem, row_smem, s);
  if (dtype == rt::kDtypeBF16)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, scratch,
                                       B, Sq, Skv, H, Kh, hd, hdv, q_offset,
                                       causal, window, scale, keys, rows,
                                       smem, row_smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
