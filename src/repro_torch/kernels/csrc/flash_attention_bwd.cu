// The backward of flash attention on Hopper: dQ, dK and dV, f32.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) has no backward kernel: the JAX
// package trains through flash_attention_jnp (src/repro/models/layers.py),
// and XLA differentiates it.  This computes the gradients of the forward
// kernel of csrc/flash_attention.cu, for every (hd, hdv) it takes, causal,
// windowed or full, GQA, at any q_offset, in f32.  With x = scale * q.k over
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
// The design is the simple one, right first:
//   * three kernels, no atomics, so two calls give the same bits:
//       - a row pass, one CTA per (query tile, b, h), recomputes each row's
//         log-sum-exp (log2 domain, online over the key tiles) and writes
//         it with D_i into an f32 scratch tensor;
//       - a dK/dV kernel, one CTA per (key tile, b, kv head), holds its K
//         and V tiles and loops over the group's G heads and the query
//         tiles that see the key tile, recomputing P from the row pass's
//         LSE, then dS, and accumulating dK and dV in registers;
//       - a dQ kernel, one CTA per (query tile, b, h), loops over the key
//         tiles its rows see and accumulates dQ in registers;
//     which is 8 products of hd per pair (the row pass's S, S and dP in
//     both of the others, dV, dK, dQ) against the least 5;
//   * the products run on the CUDA cores in f32 (no tensor cores): 256
//     threads as 16 x 16, each owning a T x T block of a 16T x 16T tile
//     (T = 4 up to hd 64, 2 above, where tiles of 32 keep the operands in
//     shared memory), reading T values of each operand per k-step from
//     shared memory, rows padded to an odd stride so that neither operand's
//     loads conflict;
//   * every tile lives in dynamic shared memory (the dK/dV kernel at
//     (256, 256): K, V, Q and dO tiles of 32 rows, P and dS, 140,288 B);
//   * masks as the forward: keys at or past Skv, past the row's position
//     when causal, and outside the window; a row that sees no key has
//     P = 0 and so zero gradients, as the plain version's;
//   * every sum has a fixed order: row maxima and sums by xor shuffles
//     within a half warp, accumulators over k-steps in order.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // 16 x 16: (ty, tx)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int HDV>
struct Geo {
  static constexpr int BT = (HD > 64 || HDV > 64) ? 32 : 64;  // tile rows
  static constexpr int T = BT / 16;        // rows (keys) per thread
  static constexpr int LQ = HD + 1;        // smem stride of Q and K rows
  static constexpr int LV = HDV + 1;       // of V and dO rows
  static constexpr int LP = BT + 1;        // of P and dS rows
  static constexpr int ND = HD / 16;       // d columns per thread
  static constexpr int NV = HDV / 16;      // c columns per thread
  static_assert(HD % 16 == 0 && HDV % 16 == 0, "head dims");
  // floats of shared memory of each kernel
  static constexpr int kRowSmem = 2 * BT * LQ;
  static constexpr int kKVSmem = 2 * BT * LQ + 2 * BT * LV + 2 * BT * LP +
                                 2 * BT;
  static constexpr int kQSmem = kKVSmem;
};

__device__ __forceinline__ bool visible(int qp, int key, int Skv, int causal,
                                        int window) {
  if (key >= Skv) return false;
  if (!causal) return true;
  return key <= qp && (window == 0 || key > qp - window);
}

// rows [r0, r0 + BT) of a (B, S, Hx, D) tensor at (b, head) into smem rows
// of stride D + 1; rows past S as zeros
template <int D, int BT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int b,
                                          int head, int r0, int S, int Hx) {
  for (int idx = threadIdx.x; idx < BT * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] =
        row < S ? src[((size_t(b) * S + row) * Hx + head) * D + c] : 0.f;
  }
}

// acc[i][j] += sum_k A(m_i, k) B(n_j, k), m_i = ty + 16 i, n_j = tx + 16 j,
// with A(m, k) = A[m am + k ak] and B(n, k) = B[n bn + k bk]
template <int TM, int TN, int K>
__device__ __forceinline__ void product(float (&acc)[TM][TN], const float* A,
                                        int am, int ak, const float* Bm,
                                        int bn, int bk, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bm[(tx + 16 * j) * bn + k * bk];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// the 16 lanes of a half warp share ty: xor offsets 8, 4, 2, 1 stay inside
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(rt::kFull, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(rt::kFull, v, o);
  return v;
}

struct Args {
  const float *q, *k, *v, *o, *dout;
  float *dq, *dk, *dv, *lse, *dd;   // lse, dd: (B, H, Sq) scratch
  int B, Sq, Skv, H, Kh, q_offset, causal, window;
  float scale;
};

// the key range [lo, hi) the rows [q0, q0 + BT) of a query tile may see
__device__ __forceinline__ void key_range(const Args& a, int q0, int BT,
                                          int& lo, int& hi) {
  const int last = min(q0 + BT, a.Sq) - 1;
  lo = 0;
  hi = a.Skv;
  if (a.causal) {
    hi = min(a.Skv, a.q_offset + last + 1);
    if (a.window) lo = max(0, a.q_offset + q0 - a.window + 1);
  }
}

// ---------------------------------------------------------------------------
// row pass: LSE (log2 domain) and D per query row
// ---------------------------------------------------------------------------
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
    row_kernel(const Args a) {
  using G = Geo<HD, HDV>;
  constexpr int BT = G::BT, T = G::T;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BT * G::LQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.Kh);
  const int q0 = blockIdx.x * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float c2 = a.scale * kLog2e;
  load_rows<HD, BT>(qs, a.q, b, h, q0, a.Sq, a.H);
  float m[T], l[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
  }
  int lo, hi;
  key_range(a, q0, BT, lo, hi);
  for (int k0 = (lo / BT) * BT; k0 < hi; k0 += BT) {
    __syncthreads();
    load_rows<HD, BT>(ks, a.k, b, kvh, k0, a.Skv, a.Kh);
    __syncthreads();
    float s[T][T];
    zero(s);
    product<T, T, HD>(s, qs, G::LQ, 1, ks, G::LQ, 1, ty, tx);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int qp = a.q_offset + q0 + ty + 16 * i;
      float x[T], mx = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const bool vis = visible(qp, k0 + tx + 16 * j, a.Skv, a.causal,
                                 a.window);
        x[j] = vis ? s[i][j] * c2 : rt::kNegInf;
        mx = fmaxf(mx, x[j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j)
        sum += x[j] > 0.5f * rt::kNegInf ? exp2f(x[j] - mn) : 0.f;
      l[i] = l[i] * exp2f(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const float lt = half_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    // D_i = dO_i . o_i, its columns split over the half warp
    float d = 0.f;
    if (row < a.Sq) {
      const size_t base = ((size_t(b) * a.Sq + row) * a.H + h) * HDV;
#pragma unroll
      for (int j = 0; j < G::NV; ++j)
        d = fmaf(a.dout[base + tx + 16 * j], a.o[base + tx + 16 * j], d);
    }
    d = half_sum(d);
    if (tx == 0 && row < a.Sq) {
      const size_t r = (size_t(b) * a.H + h) * a.Sq + row;
      a.lse[r] = lt > 0.f ? m[i] + log2f(lt) : 0.f;
      a.dd[r] = d;
    }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory, from the
// resident Q, dO, K and V tiles: P = exp2(x - LSE) where visible, else 0
template <int HD, int HDV>
__device__ __forceinline__ void p_and_ds(const Args& a, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* lse,
                                         const float* dd, float* ps,
                                         float* dss, int q0, int k0, int ty,
                                         int tx) {
  using G = Geo<HD, HDV>;
  constexpr int T = G::T;
  float s[T][T], dp[T][T];
  zero(s);
  zero(dp);
  product<T, T, HD>(s, qs, G::LQ, 1, ks, G::LQ, 1, ty, tx);
  product<T, T, HDV>(dp, dos, G::LV, 1, vs, G::LV, 1, ty, tx);
  const float c2 = a.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int c = tx + 16 * j;
      const bool vis = row < a.Sq &&
                       visible(a.q_offset + row, k0 + c, a.Skv, a.causal,
                               a.window);
      const float p = vis ? exp2f(s[i][j] * c2 - lse[r]) : 0.f;
      if (ps != nullptr) ps[r * G::LP + c] = p;
      dss[r * G::LP + c] = p * (dp[i][j] - dd[r]);
    }
  }
}

// LSE and D of rows [q0, q0 + BT) of head h into shared memory
template <int BT>
__device__ __forceinline__ void load_row_stats(const Args& a, float* lse,
                                               float* dd, int b, int h,
                                               int q0) {
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const int row = q0 + r;
    const size_t i = (size_t(b) * a.H + h) * a.Sq + row;
    lse[r] = row < a.Sq ? a.lse[i] : 0.f;
    dd[r] = row < a.Sq ? a.dd[i] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (key tile, b, kv head)
// ---------------------------------------------------------------------------
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const Args a) {
  using G = Geo<HD, HDV>;
  constexpr int BT = G::BT, T = G::T;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BT * G::LQ;
  float* qs = vs + BT * G::LV;
  float* dos = qs + BT * G::LQ;
  float* ps = dos + BT * G::LV;
  float* dss = ps + BT * G::LP;
  float* lse = dss + BT * G::LP;
  float* dd = lse + BT;
  const int bk = blockIdx.y, b = bk / a.Kh, kvh = bk - b * a.Kh;
  const int Gq = a.H / a.Kh;
  const int k0 = blockIdx.x * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_rows<HD, BT>(ks, a.k, b, kvh, k0, a.Skv, a.Kh);
  load_rows<HDV, BT>(vs, a.v, b, kvh, k0, a.Skv, a.Kh);
  // the query rows that may see a key of [k0, k0 + BT)
  int rlo = 0, rhi = a.Sq;
  if (a.causal) {
    rlo = max(0, k0 - a.q_offset);
    if (a.window)
      rhi = min(a.Sq, k0 + BT - 1 + a.window - a.q_offset);
  }
  float dk[T][G::ND], dv[T][G::NV];
  zero(dk);
  zero(dv);
  for (int g = 0; g < Gq; ++g) {
    const int h = kvh * Gq + g;
    for (int q0 = (rlo / BT) * BT; q0 < rhi; q0 += BT) {
      __syncthreads();
      load_rows<HD, BT>(qs, a.q, b, h, q0, a.Sq, a.H);
      load_rows<HDV, BT>(dos, a.dout, b, h, q0, a.Sq, a.H);
      load_row_stats<BT>(a, lse, dd, b, h, q0);
      __syncthreads();
      p_and_ds<HD, HDV>(a, qs, dos, ks, vs, lse, dd, ps, dss, q0, k0, ty,
                        tx);
      __syncthreads();
      // dV[key][c] += sum_row P[row][key] dO[row][c]
      product<T, G::NV, BT>(dv, ps, 1, G::LP, dos, 1, G::LV, ty, tx);
      // dK[key][d] += sum_row dS[row][key] Q[row][d]
      product<T, G::ND, BT>(dk, dss, 1, G::LP, qs, 1, G::LQ, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Skv) continue;
    const size_t row = (size_t(b) * a.Skv + key) * a.Kh + kvh;
#pragma unroll
    for (int j = 0; j < G::ND; ++j)
      a.dk[row * HD + tx + 16 * j] = dk[i][j] * a.scale;
#pragma unroll
    for (int j = 0; j < G::NV; ++j) a.dv[row * HDV + tx + 16 * j] = dv[i][j];
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (query tile, b, h)
// ---------------------------------------------------------------------------
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const Args a) {
  using G = Geo<HD, HDV>;
  constexpr int BT = G::BT, T = G::T;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * G::LQ;
  float* ks = dos + BT * G::LV;
  float* vs = ks + BT * G::LQ;
  float* dss = vs + BT * G::LV;
  float* lse = dss + 2 * BT * G::LP;   // the layout of dkdv_kernel's
  float* dd = lse + BT;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.Kh);
  const int q0 = blockIdx.x * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_rows<HD, BT>(qs, a.q, b, h, q0, a.Sq, a.H);
  load_rows<HDV, BT>(dos, a.dout, b, h, q0, a.Sq, a.H);
  load_row_stats<BT>(a, lse, dd, b, h, q0);
  float dq[T][G::ND];
  zero(dq);
  int lo, hi;
  key_range(a, q0, BT, lo, hi);
  for (int k0 = (lo / BT) * BT; k0 < hi; k0 += BT) {
    __syncthreads();
    load_rows<HD, BT>(ks, a.k, b, kvh, k0, a.Skv, a.Kh);
    load_rows<HDV, BT>(vs, a.v, b, kvh, k0, a.Skv, a.Kh);
    __syncthreads();
    p_and_ds<HD, HDV>(a, qs, dos, ks, vs, lse, dd, nullptr, dss, q0, k0, ty,
                      tx);
    __syncthreads();
    // dQ[row][d] += sum_key dS[row][key] K[key][d]
    product<T, G::ND, BT>(dq, dss, G::LP, 1, ks, 1, G::LQ, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const size_t base = ((size_t(b) * a.Sq + row) * a.H + h) * HD;
#pragma unroll
    for (int j = 0; j < G::ND; ++j)
      a.dq[base + tx + 16 * j] = dq[i][j] * a.scale;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD, int HDV>
int launch(const Args& a, int tile, cudaStream_t s) {
  using G = Geo<HD, HDV>;
  if (tile != G::BT) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = 4 * G::kRowSmem;
  const int kv_bytes = 4 * G::kKVSmem;
  const int q_bytes = 4 * G::kQSmem;
  cudaError_t e;
  if ((e = allow_smem(row_kernel<HD, HDV>, row_bytes)) != cudaSuccess ||
      (e = allow_smem(dkdv_kernel<HD, HDV>, kv_bytes)) != cudaSuccess ||
      (e = allow_smem(dq_kernel<HD, HDV>, q_bytes)) != cudaSuccess)
    return static_cast<int>(e);
  const int qt = (a.Sq + G::BT - 1) / G::BT;
  const int kt = (a.Skv + G::BT - 1) / G::BT;
  row_kernel<HD, HDV><<<dim3(qt, a.B * a.H), kThreads, row_bytes, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<HD, HDV><<<dim3(kt, a.B * a.Kh), kThreads, kv_bytes, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  dq_kernel<HD, HDV><<<dim3(qt, a.B * a.H), kThreads, q_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, hd), k (B, Skv, Kh, hd), v (B, Skv, Kh, hdv), o and dout
// (B, Sq, H, hdv), all f32 and contiguous; writes dq, dk, dv (shaped as q,
// k, v) and uses scratch (2 B H Sq floats: each row's LSE and D).  tile is
// the wrapper's tile rows, refused if it is not this launcher's own.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int B,
    int Sq, int Skv, int H, int Kh, int hd, int hdv, int q_offset,
    int causal, int window, float scale, int tile, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.lse = static_cast<float*>(scratch);
  a.dd = a.lse + size_t(B) * H * Sq;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Kh = Kh;
  a.q_offset = q_offset;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_CASE(D, DV) \
  if (hd == D && hdv == DV) return launch<D, DV>(a, tile, s);
  RT_CASE(16, 16) RT_CASE(32, 32) RT_CASE(64, 64) RT_CASE(128, 128)
  RT_CASE(192, 128) RT_CASE(256, 256)
#undef RT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
