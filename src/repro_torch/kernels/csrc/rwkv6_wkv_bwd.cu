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
// as it was, so serving keeps its bits).  The design rests on the state's
// columns being independent: S[:, j] and dS[:, j] are updated from column
// j alone.
//   * one (b, h) runs on a cluster of C = hd / 32 CTAs (cudaLaunchKernelEx
//     with a cluster dimension; hd 16: one CTA of 16 columns); CTA rank c
//     owns state columns [32 c, 32 c + 32), one row per 4 lanes (2 at hd
//     16), 8 columns a lane.  At the training shape: 256 CTAs of 256
//     threads, 128 clusters of 2, all resident at once (2 CTAs an SM at 128
//     registers a thread; clusters of 4 CTAs of 16 columns left a second
//     wave: 124 fit);
//   * pass 1 runs the recurrence on the CTA's columns from state0 over the
//     whole sequence and writes the state at the start of every chunk of
//     TC = 16 steps into an f32 scratch tensor, in each thread's own layout
//     (k, w and v in a 3-stage cp.async ring).  A checkpoint every 8 steps
//     doubled its bytes, and pass 1 waited on them;
//   * then, chunk by chunk from the last, the chunk's r, k, w rows, its v
//     and dy columns and each thread's chunk-start state arrive by 16-byte
//     cp.async (2 stages: the next chunk, the previous one in time, loads
//     during this one).  Each chunk is two sub-chunks of TR = 8 steps whose
//     states a thread recomputes into registers (8 x 8) and walks back,
//     carrying dS: the second from the state 8 steps in, then the first
//     from the chunk's first state again;
//   * dv of the CTA's columns is complete inside the CTA: the sum over rows
//     is a halving butterfly over the warp's 8 rows, then the warps'
//     partials in shared memory added in warp order;
//   * dr, dk and dw are sums over all columns: each step's row sums over the
//     CTA's columns (xor shuffles within the lanes of a row) are pushed
//     into the shared memory of the rank that owns the row (rank c owns
//     rows [RC c, RC c + RC)), with this rank's part of v_t . dy_t, through
//     distributed shared memory (cluster.map_shared_rank).  A split cluster
//     barrier (arrive after the pushes, wait after dv is written) lets rank
//     c sum its rows over the C ranks in rank order, add the u terms and
//     write them.  The pushed partials are double-buffered by chunk, so one
//     barrier a chunk keeps a rank from overwriting what its owner still
//     reads; sum_i r u k needs every row, which every CTA holds;
//   * du's per-(b, h) sums land in a scratch tensor that a second kernel
//     adds over b in order;
//   * geometry (Geo, mirrored by kernels/rwkv6_wkv.py::_bwd_geometry and
//     checked by the launcher): 91,712 B of shared memory at hd 64,
//     175,168 B at hd 128;
//   * no atomics and every sum in a fixed order: the same inputs give the
//     same bits.
// On an H100 (tools/kernel_stages.py wkvbwd, per CTA at the training
// shape) the backward walk takes under half of a CTA's cycles; the rest is
// the per-chunk copies, dots and barriers and pass 1, and the walk's
// shuffles and shared loads share one pipe with the copies' issue.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;

template <int HD>
struct Geo {
  static constexpr int JC = HD < 32 ? HD : 32;   // state columns per CTA
  static constexpr int C = HD / JC;        // CTAs per (b, h): the cluster
  static constexpr int E = 8;              // columns per thread
  static constexpr int L = JC / E;         // lanes per row
  static constexpr int NT = HD * L;        // threads per CTA
  static constexpr int NW = NT / 32;       // warps
  static constexpr int MINB = 512 / NT;    // CTAs an SM: 128 registers
  static constexpr int TC = 16;            // steps per chunk
  static constexpr int TR = 8;             // steps per sub-chunk in registers
  static constexpr int RC = HD / C;        // rows each rank reduces
  static_assert((L == 2 || L == 4) && JC % 16 == 0 && NT % 32 == 0 &&
                NT <= 1024 && C <= 8 && NT % RC == 0 && TC == 2 * TR,
                "geometry");
  // floats of shared memory.  Pass 1: a 3-stage ring of k, w (TC x HD
  // each) and v (TC x JC).  Pass 2, in the same region: 2 stages of r, k, w
  // (TC x HD each), v and dy (TC x JC each), and 2 buffers of the row
  // partials that the C ranks push for this rank's rows (per rank: dr, dk,
  // dw, each TC x RC, then v.dy, TC).  Then dv's warp partials (TC x NW x
  // JC); each thread's chunk-start state, 2 stages; u; sum_i r u k per
  // step; du's per-thread sums.
  static constexpr int kStage1 = TC * (2 * HD + JC);
  static constexpr int kStage = TC * (3 * HD + 2 * JC);
  static constexpr int kOQ = 3 * TC * RC + TC;
  static constexpr int kOwn = C * kOQ;
  static constexpr int kRegion = 3 * kStage1 > 2 * kStage + 2 * kOwn
                                     ? 3 * kStage1
                                     : 2 * kStage + 2 * kOwn;
  static constexpr int kFloats = kRegion + TC * NW * JC + 2 * NT * E + HD +
                                 TC + NT;
};

struct Args {
  const float *r, *k, *v, *w, *u, *state0, *dy, *dstate;
  float *dr, *dk, *dv, *dw, *du_part, *dstate0, *ckpt;
  int S, H, nc;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// steps t0 .. t0 + N of a (B, S, H, HD) tensor at (b, h), columns [c0, c0
// + W), into dst (rows of W); steps past S as zeros
template <int HD, int W, int N>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const Args& a, int b, int h,
                                           int c0, int t0) {
  constexpr int W4 = W / 4;
  for (int idx = threadIdx.x; idx < N * W4; idx += Geo<HD>::NT) {
    const int t = idx / W4, c = 4 * (idx - t * W4);
    const bool ok = t0 + t < a.S;
    cp_async16(dst + t * W + c,
               src + ((size_t(b) * a.S + (ok ? t0 + t : 0)) * a.H + h) * HD +
                   c0 + c,
               ok);
  }
}

// pass 1's stage: k, w (all rows) and v (the CTA's columns), TC steps
template <int HD>
__device__ __forceinline__ void stage_pass1(float* st, const Args& a, int b,
                                            int h, int col0, int t0) {
  using G = Geo<HD>;
  constexpr int TC = G::TC;
  stage_rows<HD, HD, TC>(st, a.k, a, b, h, 0, t0);
  stage_rows<HD, HD, TC>(st + TC * HD, a.w, a, b, h, 0, t0);
  stage_rows<HD, G::JC, TC>(st + 2 * TC * HD, a.v, a, b, h, col0, t0);
}

// pass 2's stage: r, k, w (all rows), v and dy (the CTA's columns), TC
// steps
template <int HD>
__device__ __forceinline__ void stage_pass2(float* st, const Args& a, int b,
                                            int h, int col0, int t0) {
  using G = Geo<HD>;
  constexpr int TC = G::TC, JC = G::JC;
  stage_rows<HD, HD, TC>(st, a.r, a, b, h, 0, t0);
  stage_rows<HD, HD, TC>(st + TC * HD, a.k, a, b, h, 0, t0);
  stage_rows<HD, HD, TC>(st + 2 * TC * HD, a.w, a, b, h, 0, t0);
  stage_rows<HD, JC, TC>(st + 3 * TC * HD, a.v, a, b, h, col0, t0);
  stage_rows<HD, JC, TC>(st + 3 * TC * HD + TC * JC, a.dy, a, b, h, col0,
                         t0);
}

template <int E>
__device__ __forceinline__ void load_row(float (&x)[E], const float* p) {
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + e);
    x[e] = q.x;
    x[e + 1] = q.y;
    x[e + 2] = q.z;
    x[e + 3] = q.w;
  }
}
template <int E>
__device__ __forceinline__ void store_row(float* p, const float (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 4)
    *reinterpret_cast<float4*>(p + e) =
        make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
}

// n of N steps of the recurrence on a thread's row i, columns j0 .. j0 +
// E of the CTA's (sk, sw rows of HD, sv rows of JC); FULL (n == N) leaves
// out the per-step test, so the unrolled steps form one block that the
// compiler schedules as a whole
template <int HD, int N, bool FULL>
__device__ __forceinline__ void advance(float (&s)[Geo<HD>::E], int n,
                                        const float* sk, const float* sw,
                                        const float* sv, int i, int j0) {
  using G = Geo<HD>;
  constexpr int JC = G::JC, E = G::E;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (FULL || t < n) {
      const float kk = sk[t * HD + i], ww = sw[t * HD + i];
      float vv[E];
      load_row(vv, sv + t * JC + j0);
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] = fmaf(ww, s[e], kk * vv[e]);
    }
  }
}

// n of the TR steps of a sub-chunk of pass 2 on a thread's row i and
// columns j0 .. j0 + E: the states before each step recomputed from s into
// registers, then the steps walked backwards carrying ds.  Each step's row
// sums over the CTA's columns are pushed to the row's rank through dst (L
// 4: lanes 0, 1, 2 of the row dr, dk, dw; L 2: lane 0 dr and dw, lane 1
// dk; stride RC a step), and its dv partial over the warp's rows goes to
// pdv.  Every pointer starts at the sub-chunk's first step.  FULL as in
// advance.
template <int HD, bool FULL>
__device__ __forceinline__ void walk(float (&s)[Geo<HD>::E],
                                     float (&ds)[Geo<HD>::E], int n,
                                     const float* sr, const float* sk,
                                     const float* sw, const float* sv,
                                     const float* sdy, float* dst, float* pdv,
                                     int i, int cgp, int j0, int lane,
                                     int warp) {
  using G = Geo<HD>;
  constexpr int TC = G::TC, TR = G::TR, E = G::E, L = G::L, NW = G::NW;
  constexpr int JC = G::JC, RC = G::RC;
  // the sub-chunk's states, before each of its steps, in registers
  float hist[TR][E];
#pragma unroll
  for (int t = 0; t < TR; ++t) {
    if (FULL || t < n) {
      const float kk = sk[t * HD + i], ww = sw[t * HD + i];
      float vv[E];
      load_row(vv, sv + t * JC + j0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        hist[t][e] = s[e];
        s[e] = fmaf(ww, s[e], kk * vv[e]);
      }
    }
  }
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float* pd = pdv + warp * JC + j0 + (b4 ? 4 : 0) + (b3 ? 2 : 0) +
              (b2 ? 1 : 0);
  float* dsel = dst + (cgp == 1 ? TC * RC : cgp == 2 ? 2 * TC * RC : 0);
#pragma unroll
  for (int t = TR - 1; t >= 0; --t) {
    if (FULL || t < n) {
      const float rr = sr[t * HD + i], kk = sk[t * HD + i],
                  ww = sw[t * HD + i];
      float vv[E], yy[E];
      load_row(vv, sv + t * JC + j0);
      load_row(yy, sdy + t * JC + j0);
      float drp = 0.f, dwp = 0.f, dkp = 0.f, dvp[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        drp = fmaf(yy[e], hist[t][e], drp);
        dwp = fmaf(ds[e], hist[t][e], dwp);
        dkp = fmaf(ds[e], vv[e], dkp);
        dvp[e] = ds[e] * kk;
        ds[e] = fmaf(ww, ds[e], rr * yy[e]);
      }
      // the row's sums over the CTA's columns: its L lanes
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {
        drp += __shfl_xor_sync(rt::kFull, drp, o);
        dkp += __shfl_xor_sync(rt::kFull, dkp, o);
        dwp += __shfl_xor_sync(rt::kFull, dwp, o);
      }
      if (cgp < 3) dsel[t * RC] = cgp == 0 ? drp : cgp == 1 ? dkp : dwp;
      if (L == 2 && cgp == 0) dst[2 * TC * RC + t * RC] = dwp;
      // dv over the warp's 32 / L rows (lane bits log2 L .. 4), halving:
      // after the xor-16, -8 and -4 steps a lane keeps column e = 4 bit4 +
      // 2 bit3 + bit2 (L 4: of all 8 rows), and at L 2 the xor-2 step adds
      // the last pair of rows
      float a4[4], a2[2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        a4[m] = (b4 ? dvp[4 + m] : dvp[m]) +
                __shfl_xor_sync(rt::kFull, b4 ? dvp[m] : dvp[4 + m], 16);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        a2[m] = (b3 ? a4[2 + m] : a4[m]) +
                __shfl_xor_sync(rt::kFull, b3 ? a4[m] : a4[2 + m], 8);
      float x = (b2 ? a2[1] : a2[0]) +
                __shfl_xor_sync(rt::kFull, b2 ? a2[0] : a2[1], 4);
      if (L == 2) x += __shfl_xor_sync(rt::kFull, x, 2);
      if (L == 4 || (lane & 2) == 0) pd[t * NW * JC] = x;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Geo<HD>::NT, Geo<HD>::MINB)
    wkv6_bwd_kernel(const Args a) {
  using G = Geo<HD>;
  constexpr int TC = G::TC, TR = G::TR, E = G::E, L = G::L, NT = G::NT;
  constexpr int NW = G::NW, JC = G::JC, C = G::C, RC = G::RC, OQ = G::kOQ;
  extern __shared__ __align__(16) float smem[];
  float* region = smem;                       // pass 1's ring, or pass 2's
  float* own = region + 2 * G::kStage;        // 2 x kOwn (pass 2)
  float* pdv = region + G::kRegion;           // [TC][NW][JC]
  float* ckb = pdv + TC * NW * JC;            // 2 x [NT][E]
  float* su = ckb + 2 * NT * E;               // [HD]
  float* rku = su + HD;                       // [TC]
  float* dured = rku + TC;                    // [NT]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / L, cgp = tid % L;       // row, column group
  const int col0 = rank * JC, j0 = cgp * E;   // the CTA's, the thread's
  const size_t sbase = size_t(bh) * HD * HD + size_t(i) * HD + col0 + j0;
  float* my_ckpt = a.ckpt + (size_t(bh) * C + rank) * a.nc * NT * E + tid * E;
  for (int x = tid; x < HD; x += NT) su[x] = a.u[h * HD + x];

  // pass 1: the state at the start of each chunk, k, w and v in a 3-stage
  // ring (chunks ch + 1 and ch + 2 load while chunk ch runs)
  float s[E];
  if (a.state0 != nullptr)
    load_row(s, a.state0 + sbase);
  else
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] = 0.f;
  stage_pass1<HD>(region, a, b, h, col0, 0);
  cp_async_commit();
  if (a.nc > 1) stage_pass1<HD>(region + G::kStage1, a, b, h, col0, TC);
  cp_async_commit();
  for (int ch = 0; ch < a.nc; ++ch) {
    if (ch + 2 < a.nc)
      stage_pass1<HD>(region + ((ch + 2) % 3) * G::kStage1, a, b, h, col0,
                      (ch + 2) * TC);
    cp_async_commit();
    store_row(my_ckpt + size_t(ch) * NT * E, s);
    cp_async_wait<2>();
    __syncthreads();
    const float* sk = region + (ch % 3) * G::kStage1;
    const float* sw = sk + TC * HD;
    const float* sv = sw + TC * HD;
    const int n = min(TC, a.S - ch * TC);
    if (n == TC)
      advance<HD, TC, true>(s, n, sk, sw, sv, i, j0);
    else
      advance<HD, TC, false>(s, n, sk, sw, sv, i, j0);
    __syncthreads();                 // this stage read before it is refilled
  }
  // every rank is done with pass 1, whose ring holds the partial buffers
  // that the others push into in pass 2
  cluster_arrive();
  cluster_wait();

  // pass 2: chunks in reverse, each recomputed, then walked backwards
  float ds[E];
  if (a.dstate != nullptr)
    load_row(ds, a.dstate + sbase);
  else
#pragma unroll
    for (int e = 0; e < E; ++e) ds[e] = 0.f;
  float du = 0.f;       // row rank RC + tid % RC, over this thread's steps
  // where this thread's row sums go: its row's rank, this rank's slot
  float* dst0 = cluster.map_shared_rank(own, i / RC) + rank * OQ + i % RC;
  // a chunk's stage and each thread's chunk-start state arrive together
  auto stage = [&](int ch) {
    stage_pass2<HD>(region + (ch & 1) * G::kStage, a, b, h, col0, ch * TC);
    float* cb = ckb + (ch & 1) * NT * E + tid * E;
    const float* src = my_ckpt + size_t(ch) * NT * E;
#pragma unroll
    for (int e = 0; e < E; e += 4) cp_async16(cb + e, src + e, true);
  };
  stage(a.nc - 1);
  cp_async_commit();
  for (int ch = a.nc - 1; ch >= 0; --ch) {
    const int t0 = ch * TC, n = min(TC, a.S - t0);
    cp_async_wait<0>();
    // the chunk's stage has landed, and every warp is done with the last
    // chunk, whose buffers the next chunk's copies now refill
    __syncthreads();
    if (ch > 0) stage(ch - 1);
    cp_async_commit();
    load_row(s, ckb + (ch & 1) * NT * E + tid * E);
    const float* sr = region + (ch & 1) * G::kStage;
    const float* sk = sr + TC * HD;
    const float* sw = sk + TC * HD;
    const float* sv = sw + TC * HD;
    const float* sdy = sv + TC * JC;
    const int ob = (ch & 1) * G::kOwn;     // this chunk's partial buffers
    // per step: sum_i r u k over every row, and v . dy over the CTA's
    // columns, pushed to every rank (16 lanes a step; steps past S read
    // zeros)
    for (int x = tid; x < TC * 16; x += NT) {
      const int t = x >> 4, l = x & 15;
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int m = 0; m < JC / 16; ++m)
        a1 = fmaf(sv[t * JC + l + 16 * m], sdy[t * JC + l + 16 * m], a1);
#pragma unroll
      for (int m = 0; m < HD / 16; ++m)
        a2 = fmaf(sr[t * HD + l + 16 * m] * su[l + 16 * m],
                  sk[t * HD + l + 16 * m], a2);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        a1 += __shfl_xor_sync(rt::kFull, a1, o);
        a2 += __shfl_xor_sync(rt::kFull, a2, o);
      }
      if (l == 0) rku[t] = a2;
      if (l < C)
        cluster.map_shared_rank(own, l)[ob + rank * OQ + 3 * TC * RC + t] =
            a1;
    }
    // the chunk's second sub-chunk from the state TR steps in, then its
    // first from the chunk's first state again
    const int nhi = n - TR;
    if (nhi > 0) {
      advance<HD, TR, true>(s, TR, sk, sw, sv, i, j0);
      if (nhi == TR)
        walk<HD, true>(s, ds, TR, sr + TR * HD, sk + TR * HD, sw + TR * HD,
                       sv + TR * JC, sdy + TR * JC, dst0 + ob + TR * RC,
                       pdv + TR * NW * JC, i, cgp, j0, lane, warp);
      else
        walk<HD, false>(s, ds, nhi, sr + TR * HD, sk + TR * HD,
                        sw + TR * HD, sv + TR * JC, sdy + TR * JC,
                        dst0 + ob + TR * RC, pdv + TR * NW * JC, i, cgp, j0,
                        lane, warp);
      load_row(s, ckb + (ch & 1) * NT * E + tid * E);
    }
    if (n >= TR)
      walk<HD, true>(s, ds, TR, sr, sk, sw, sv, sdy, dst0 + ob, pdv, i, cgp,
                     j0, lane, warp);
    else
      walk<HD, false>(s, ds, n, sr, sk, sw, sv, sdy, dst0 + ob, pdv, i, cgp,
                      j0, lane, warp);
    cluster_arrive();     // this rank's pushes of the chunk are written
    __syncthreads();
    // dv of the CTA's columns: the warps' partials in warp order
    for (int x = tid; x < n * JC; x += NT) {
      const int t = x / JC, j = x - t * JC;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) acc += pdv[(t * NW + wp) * JC + j];
      a.dv[((size_t(b) * a.S + t0 + t) * a.H + h) * HD + col0 + j] =
          fmaf(sdy[t * JC + j], rku[t], acc);
    }
    cluster_wait();       // every rank's pushes of the chunk have landed
    // rows [rank RC, rank RC + RC): the C ranks' partials in rank order
    for (int x = tid; x < n * RC; x += NT) {
      const int t = x / RC, r = x - t * RC, row = rank * RC + r;
      float vdy = 0.f, sdr = 0.f, sdk = 0.f, sdw = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float* oq = own + ob + q * OQ;
        vdy += oq[3 * TC * RC + t];
        sdr += oq[t * RC + r];
        sdk += oq[TC * RC + t * RC + r];
        sdw += oq[2 * TC * RC + t * RC + r];
      }
      const float uu = su[row], rr = sr[t * HD + row], kk = sk[t * HD + row];
      const size_t o = ((size_t(b) * a.S + t0 + t) * a.H + h) * HD + row;
      a.dr[o] = fmaf(uu * kk, vdy, sdr);
      a.dk[o] = fmaf(rr * uu, vdy, sdk);
      a.dw[o] = sdw;
      du = fmaf(rr * kk, vdy, du);
    }
  }
  store_row(a.dstate0 + sbase, ds);
  // du of the rank's rows: each row's NT / RC threads in order.  No rank
  // touches another's memory after its last barrier wait.
  dured[tid] = du;
  __syncthreads();
  if (tid < RC) {
    float acc = 0.f;
    for (int m = 0; m < NT / RC; ++m) acc += dured[tid + m * RC];
    a.du_part[size_t(bh) * HD + rank * RC + tid] = acc;
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
int launch(const Args& a, float* du, int B, int cluster, int chunk, int smem,
           cudaStream_t s) {
  using G = Geo<HD>;
  constexpr int bytes = 4 * G::kFloats;
  static_assert(bytes <= 227 * 1024, "shared memory");
  if (cluster != G::C || chunk != G::TC || smem != bytes ||
      a.nc != (a.S + G::TC - 1) / G::TC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wkv6_bwd_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // all of the SM's unified memory as shared memory where that fits more
  // CTAs
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G::C, B * a.H, 1);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kern, a)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n = a.H * HD;
  du_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(a.du_part, du, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, dy, dr, dk, dv, dw: (B, S, H, hd) f32; u, du: (H, hd);
// state0 (may be null: zero), dstate (the final state's gradient; may be
// null: zero) and dstate0: (B, H, hd, hd); every tensor 16-byte aligned.
// scratch: B H hd floats (du's partials), then B H ceil(S / chunk) hd^2
// (the chunk-start states).  cluster, chunk and smem are the wrapper's
// geometry (kernels/rwkv6_wkv.py::_bwd_geometry), refused if they are not
// this launcher's own.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* state0, const void* dy,
                               const void* dstate, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* dstate0,
                               void* scratch, int B, int S, int H, int hd,
                               int cluster, int chunk, int smem,
                               void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.state0 = static_cast<const float*>(state0);
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dw = static_cast<float*>(dw);
  a.dstate0 = static_cast<float*>(dstate0);
  a.du_part = static_cast<float*>(scratch);
  a.ckpt = a.du_part + size_t(B) * H * hd;
  a.S = S;
  a.H = H;
  a.nc = (S + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dus = static_cast<float*>(du);
#define RT_CASE(D) \
  if (hd == D) return launch<D>(a, dus, B, cluster, chunk, smem, s);
  RT_CASE(16) RT_CASE(32) RT_CASE(64) RT_CASE(128)
#undef RT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
