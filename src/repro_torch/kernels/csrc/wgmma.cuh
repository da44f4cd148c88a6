// Hopper's warpgroup products (wgmma, sm_90a) on bf16 operands with f32
// accumulators, and the shared-memory layouts they read, for the bf16
// flash kernels (flash_wgmma_kernel and flash_wgspan_kernel).
//
// A warpgroup is 4 consecutive warps (128 threads); warp w of it holds rows
// 16 w .. 16 w + 15 of the 64-row tile.  Within a warp the registers are
// m16n8k16 mma.sync's (mma.cuh): the accumulator of an m64nN product is
// N / 8 n8 blocks of 4 floats, d[4 j + e] at (row g + 8 (e >= 2), column
// 8 j + 2 t + (e & 1)) for lane 4 g + t; a register A operand (m64k16) is
// 4 bf16 pairs, a0 (g, k 2t..2t+1), a1 (g + 8, the same), a2 (g, k 2t+8..
// 2t+9), a3 (g + 8, the same).  So two neighbouring n8 blocks of an
// accumulator, packed in pairs, are the A operand of a product whose k
// runs over their 16 columns.
//
// Operands in shared memory are tiles of R rows of D bf16.  A row of up to
// 64 bf16 (32, 64 or 128 bytes) is one swizzle atom wide and is stored in
// the swizzled layout of its width: the 16-byte chunk c of row r sits at
// byte r * 2D + 16 c, with bits [4, 7) of that offset XORed by bits [7,
// 10) (CUTLASS's Swizzle<B, 4, 3>: B = 1, 2, 3 for 32-, 64- and 128-byte
// rows), counted from a 1024-byte boundary.  A row of 128, 192 or 256 bf16
// is stored as two, three or four column blocks of 64, each an R-row tile
// of 128-byte swizzled rows, block b starting b * R * 128 bytes after the
// first.  The descriptor names the mode, so the hardware undoes the XOR on
// its own addresses: both sides must agree, or the numbers come out wrong
// without any error.
//   * K-major (rows along k: Q and K in S = Q K^T): a k16 step is 32
//     bytes of each row of one column block; the descriptor of step kk
//     starts in block kk / (atom / 16), 32 (kk % (atom / 16)) bytes in;
//     SBO is the 8-row group's 8 atom-row bytes; LBO is unused.
//   * MN-major (rows along k, columns along n: V in O += P V, through the
//     transpose bit, which 16-bit types allow): a k16 step is 16 whole
//     rows, 16 atom rows on; SBO is again the 8-row group's stride
//     (PTX's canonical MN-major layout ((T, 8, m), (8, k)) : ((1, T, LBO),
//     (8T, SBO)) in 16-byte units, CUTLASS's make_gmma_desc).  LBO is the
//     stride between column blocks along n: at 128 columns (N = 128) the
//     R * 128 bytes to the second block.  Where n fits one atom it is never
//     used, and is set equal to SBO, which reads the same whichever of the
//     two fields the hardware takes for the k stride.  At 256 columns P.V
//     runs as two N = 128 products, one on blocks 0-1 and one on blocks
//     2-3, each starting at its first block with the same LBO.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace rt {

// a tile of R rows of D bf16: one swizzle atom a row up to D = 64; D / 64
// column blocks of 64 at D = 128, 192 and 256 (a row of 384 or 512 bytes
// is three or four atoms: the same rule, more blocks)
template <int D, int R>
struct Swz {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 192 ||
                    D == 256,
                "rows of 16, 32, 64 bf16 (one atom), or of 128, 192 or 256 "
                "(two, three or four 64-column blocks)");
  static constexpr int kD = D;
  static constexpr int kAtom = D < 64 ? D : 64;    // bf16 an atom row
  static constexpr int kRow = 2 * kAtom;           // bytes an atom row
  static constexpr int kMask = kRow / 16 - 1;      // 16-byte chunks - 1
  static constexpr uint64_t kMode = kAtom == 64 ? 1 : kAtom == 32 ? 2 : 3;
  static constexpr uint32_t kGroup = 8 * kRow;     // 8 rows: SBO
  static constexpr uint32_t kBlock = R * kRow;     // a column block
  static constexpr uint32_t kBytes = D / kAtom * kBlock;
  // the MN-major LBO: the next column block, or SBO where there is none
  static constexpr uint32_t kLbo = D > kAtom ? kBlock : kGroup;
  // byte offset of the 16-byte chunk c of row r
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t off = r * kRow + 16 * (c & kMask);
    return c / (kMask + 1) * kBlock + (off ^ (((off >> 7) & kMask) << 4));
  }
  // where the K-major k16 step kk (columns 16 kk .. 16 kk + 15) starts
  __host__ __device__ static constexpr uint32_t kstep(int kk) {
    return kk / (kAtom / 16) * kBlock + 32 * (kk % (kAtom / 16));
  }
};

__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint64_t mode,
                                            uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}
// a K-major operand: a step of tile type T at shared address addr
template <class T>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return wg_desc(addr, T::kMode, 16, T::kGroup);
}
// an MN-major operand (k along rows, n along a row) of tile type T
template <class T>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return wg_desc(addr, T::kMode, T::kLbo, T::kGroup);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wgmma reads and writes its registers after the asm statement has
// returned: these keep the compiler from touching them, or reusing them,
// before wg_wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define RT_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= A (64 x k16) . B (64 x k16)^T, both K-major in shared
// memory; acc 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A (64 x k16, registers) . B (k16 x N), B MN-major in
// shared memory (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40),
        RT_D8(48), RT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : RT_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef RT_D8

}  // namespace rt
