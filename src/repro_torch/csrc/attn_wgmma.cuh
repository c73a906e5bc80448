// Hopper-native pieces of the bf16 attention kernels (sm_90a): mbarriers,
// TMA tile loads through a tensor map, and warpgroup matrix products
// (wgmma.mma_async) with their shared-memory descriptors.
//
// Tiles in shared memory are what TMA writes with a swizzle: a tile of 64
// rows of HD bf16 is cut into column boxes of RB = min(2 HD, 128) bytes
// per row (one box at HD <= 64, two at HD = 128, four at HD = 256), each
// box 64 rows x RB bytes with the RB-byte swizzle (128B, 64B or 32B). A
// head dim hd < HD has a tensor map of inner extent hd: TMA zero-fills the
// columns past it. A wgmma descriptor names the same swizzle, so the two
// always agree:
//   - K-major operand (Q and K: rows are M or N, the head dim is K): the
//     8-row groups are SBO = 8 RB bytes apart; the k-step of 16 elements
//     (32 bytes) moves 32 bytes along the row, into the next box when the
//     row's RB bytes are used up.
//   - MN-major operand (V in P.V, and in the backward dO in dV += P^T dO,
//     Q in dK += dS^T Q, K in dQ += dS K: rows are K, the head dim is N): K
//     rows are RB bytes apart, 8-row groups SBO = 8 RB, and the N-blocks
//     of RB bytes (the boxes) LBO = 64 RB apart; the k-step of 16 kv rows
//     moves 16 RB bytes. The transpose bit of the instruction says so.
// Every box starts on 1024 bytes, the period of the widest swizzle.
#pragma once

#include <cuda.h>

#include "attn_mma.cuh"

namespace attn {

// ---------------------------------------------------------------------------
// mbarriers (shared::cta)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` more of asynchronous copies this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Named barriers 1.. (0 is __syncthreads) over `count` threads: sync
// waits for the barrier, arrive passes it without waiting.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One TMA box of a 4-D tensor map into shared memory; completion is
// counted in bytes on `bar`. Coordinates innermost first.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses on 16 bytes)
// from global into shared memory, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Move registers between warpgroups of a warp-specialised block: every
// warp of a warpgroup runs it, the producer lowering its count and the
// consumers raising theirs (N a multiple of 8 in 24..256).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
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
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous product that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// Row bytes of one swizzled box for a head dim, and the descriptor's
// layout code for that swizzle (1 = 128B, 2 = 64B, 3 = 32B).
template <int HD>
struct WgBox {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "head dim of the wgmma tile");
  static constexpr int RB = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int COLS = RB / 2;               // elements a box row
  static constexpr int NBOX = HD / COLS;
  static constexpr int BYTES = 64 * RB;             // one box
  static constexpr int TILE = NBOX * BYTES;         // 64 rows x HD
  static constexpr uint32_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
};

__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// K-major operand (Q or K tile at `tile`), k-step kk of 16 elements.
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using W = WgBox<HD>;
  const uint32_t off = (kk * 32 / W::RB) * W::BYTES + (kk * 32) % W::RB;
  return wg_desc(tile + off, 16, 8 * W::RB, W::LAYOUT);
}

// MN-major operand (V tile at `tile`), k-step kt of 16 kv rows.
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kt) {
  using W = WgBox<HD>;
  return wg_desc(tile + kt * 16 * W::RB, W::BYTES, 8 * W::RB, W::LAYOUT);
}

// d (m64 x n64, f32) = A (64 x 16, K-major in shared memory) *
// B (n64 x 16, K-major in shared memory)^T, plus d where scale_d is 1
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, f32) = A (64 x 16 bf16, registers) * B (n64 x 16, K-major
// in shared memory)^T, plus d where scale_d is 1
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The A-fragments (mma.sync's m16 x k16 layout, which wgmma also takes
// from registers) of a warp's rows r0 .. r0 + 15 of a 64 x HD tile at
// shared address `tile` that TMA wrote in swizzled boxes: the 16-byte
// chunk at byte `off` of a box lies at off ^ (((off >> 7) & MASK) << 4),
// MASK 7, 3 or 1 for the 128B, 64B or 32B swizzle. One ldmatrix.x4 a
// k-step of 16 columns.
template <int HD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[HD / 16][4],
                                             uint32_t tile, int r0) {
  using W = WgBox<HD>;
  constexpr uint32_t MASK = W::RB == 128 ? 7 : W::RB == 64 ? 3 : 1;
  const int lane = threadIdx.x % 32;
  const uint32_t r = r0 + lane % 16;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t cb = kk * 32 + (lane / 16) * 16;   // byte of the row
    const uint32_t off = r * W::RB + cb % W::RB;
    const uint32_t addr = tile + (cb / W::RB) * W::BYTES +
                          (off ^ (((off >> 7) & MASK) << 4));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(f[kk][0]), "=r"(f[kk][1]), "=r"(f[kk][2]), "=r"(f[kk][3])
        : "r"(addr)
        : "memory");
  }
}

// d (m64 x n16, f32) += A (64 x 16 bf16, registers) * B (16 x n16,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n32, f32) += A (64 x 16 bf16, registers) * B (16 x n32,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64, f32) += A (64 x 16 bf16, registers) * B (16 x n64,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, f32) += A (64 x 16 bf16, registers) * B (16 x n128,
// MN-major in shared memory: the transpose bit is set), into d[OFF ..
// OFF + 15]
template <int OFF = 0, int N = 16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
        "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
        "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
        "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
        "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]),
        "+f"(d[OFF + 8][0]), "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
        "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]), "+f"(d[OFF + 9][3]),
        "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]), "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]),
        "+f"(d[OFF + 11][0]), "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]),
        "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]), "+f"(d[OFF + 12][2]), "+f"(d[OFF + 12][3]),
        "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]), "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]),
        "+f"(d[OFF + 14][0]), "+f"(d[OFF + 14][1]), "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]),
        "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]), "+f"(d[OFF + 15][2]), "+f"(d[OFF + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x nHD) += A (registers) * B (MN-major V tile, k-step at db). At
// HD = 256 that is two n128 products, one over each half of the columns:
// boxes 0-1 and 2-3 of the tile, 2 BYTES apart (desc_mnmajor's LBO steps
// from box to box inside one product).
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (HD == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  else {
    // the descriptor's address field counts 16-byte units (bits 0-13)
    constexpr uint64_t HALF = (2 * WgBox<HD>::BYTES) >> 4;
    wgmma_rs_n128<0>(d, a, db);
    wgmma_rs_n128<16>(d, a, db + HALF);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched once through the
// runtime, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map (head dim, seq, head, batch) of a bf16 (B, heads, S, hd) view
// with element strides (sb, sh, ss), in boxes of (COLS, 64, 1, 1) that
// tile the instance's HD >= hd columns: the columns past hd, like the rows
// past S, are out of bounds and arrive zero-filled (and still count in
// the box's bytes on the barrier).
template <int HD>
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int hd,
                            int S, int heads, int B, long long sb,
                            long long sh, long long ss) {
  using W = WgBox<HD>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)W::COLS, 64, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = W::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : W::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
