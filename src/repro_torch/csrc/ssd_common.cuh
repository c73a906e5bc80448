// Tile code shared by the SSD scan's kernels (csrc/ssd_scan.cu, the
// forward, and csrc/ssd_scan_bwd.cu, its gradient): the block shape, a
// block-wide prefix sum, the f32 register tile of a 64 x W product from
// shared memory, the batched 16-byte staging of global rows (f32 or
// bf16, widened to f32) into shared memory, as they are or transposed,
// and the warp tiles on the tensor cores (bf16, an f32 operand split into
// a bf16 pair hi + lo) with their f32 counterpart on the CUDA cores.
#pragma once

#include "attn_mma.cuh"

namespace ssd {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int TILE = 64;     // rows of a query tile and of a source tile
constexpr int LT = TILE + 4; // row stride of a transposed 64-wide tile
constexpr int MAX_N = 128;   // state dim: a multiple of 16 up to this
constexpr int MAX_Q = 256;   // chunk

// Inclusive prefix sum over the block's threads; wtot (NW floats) ends
// with the block's total in wtot[NW - 1].
__device__ __forceinline__ float block_scan(float v, float* wtot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wtot[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < NW ? wtot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < NW; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < NW) wtot[lane] = t;
  }
  __syncthreads();
  if (w > 0) v += wtot[w - 1];
  return v;
}

// ---------------------------------------------------------------------------
// Register tile of a 64 x W product (W = the head dim, or 64 for C.B^T):
// CX threads across the columns, each CQ float4 groups at columns 4 tx +
// 4 CX q; RG thread rows of RPT contiguous rows. Threads past ACTIVE idle
// (only at W <= 8).
// ---------------------------------------------------------------------------
template <int W>
struct OutMap {
  static constexpr int CX = W / 4 < 16 ? W / 4 : 16;
  static constexpr int CQ = W / 4 / CX;
  static constexpr int RG = 64 < NT / CX ? 64 : NT / CX;
  static constexpr int RPT = TILE / RG;
  static constexpr int ACTIVE = RG * CX;
};

// acc[i][q][e] += sum_k At[k][RPT ty + i] * Bt[k][4 tx + 4 CX q + e]: At is
// K x 64 (row stride lda), Bt is K x W (row stride ldb), both f32 in
// shared memory with 16-byte aligned rows.
template <int W>
__device__ __forceinline__ void tile_mac(
    float (&acc)[OutMap<W>::RPT][OutMap<W>::CQ][4], const float* At, int lda,
    const float* Bt, int ldb, int K, int ty, int tx) {
  using M = OutMap<W>;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[M::RPT];
    const float* ap = At + k * lda + ty * M::RPT;
    if constexpr (M::RPT == 4) {
      const float4 t = *reinterpret_cast<const float4*>(ap);
      av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < M::RPT; ++i) av[i] = ap[i];
    }
    float4 bv[M::CQ];
#pragma unroll
    for (int q = 0; q < M::CQ; ++q)
      bv[q] = *reinterpret_cast<const float4*>(Bt + k * ldb + 4 * tx +
                                               4 * M::CX * q);
#pragma unroll
    for (int i = 0; i < M::RPT; ++i)
#pragma unroll
      for (int q = 0; q < M::CQ; ++q) {
        acc[i][q][0] = fmaf(av[i], bv[q].x, acc[i][q][0]);
        acc[i][q][1] = fmaf(av[i], bv[q].y, acc[i][q][1]);
        acc[i][q][2] = fmaf(av[i], bv[q].z, acc[i][q][2]);
        acc[i][q][3] = fmaf(av[i], bv[q].w, acc[i][q][3]);
      }
  }
}

template <int W>
__device__ __forceinline__ void tile_zero(
    float (&acc)[OutMap<W>::RPT][OutMap<W>::CQ][4]) {
#pragma unroll
  for (int i = 0; i < OutMap<W>::RPT; ++i)
#pragma unroll
    for (int q = 0; q < OutMap<W>::CQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
}

// ---------------------------------------------------------------------------
// Global -> shared staging, 16 bytes a load (4 f32 or 8 bf16), widened to
// f32. A thread issues up to STAGE loads before it stores any of them, so
// a tile costs about one memory latency, not one a row.
// ---------------------------------------------------------------------------
constexpr int STAGE = 8;

template <typename T>
struct Wide {
  static constexpr int V = 16 / sizeof(T);
};

__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Four floats into shared memory as f32 (16 bytes) or bf16 (8 bytes).
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

struct One {
  __device__ float operator()(int) const { return 1.f; }
};

// dst[r * ld + c] = src[r * src_row + c] * scale(r) for r < rows, c < cols
// (cols a multiple of 16 bytes of T), in f32 or rounded to bf16; rows at
// or past `valid` are zero.
template <typename D, typename T, typename Scale>
__device__ __forceinline__ void stage_rows(D* dst, int ld, const T* src,
                                           long long src_row, int rows,
                                           int cols, int valid,
                                           Scale scale) {
  constexpr int V = Wide<T>::V;
  const int cpr = cols / V, total = rows * cpr;
  for (int base = 0; base < total; base += STAGE * NT) {
    uint4 buf[STAGE];
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int c = base + i * NT + threadIdx.x;
      const int r = c / cpr;
      buf[i] = c < total && r < valid
                   ? *reinterpret_cast<const uint4*>(
                         src + r * src_row + (c - r * cpr) * V)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int c = base + i * NT + threadIdx.x;
      if (c >= total) break;
      const int r = c / cpr, col = (c - r * cpr) * V;
      const float sc = r < valid ? scale(r) : 0.f;
      float f[V];
      widen(buf[i], f);
#pragma unroll
      for (int e = 0; e < V; e += 4)
        store4(dst + r * ld + col + e, f[e] * sc, f[e + 1] * sc,
               f[e + 2] * sc, f[e + 3] * sc);
    }
  }
}

// dstT[c * ldT + r] = src[r * src_row + c] * scale(r) for the TILE rows of
// a tile, c < cols; rows at or past `valid` are zero. Neighbouring threads take
// neighbouring rows, so the transposed stores hit distinct banks.
template <typename T, typename Scale = One>
__device__ __forceinline__ void stage_transposed(float* dstT, int ldT,
                                                 const T* src,
                                                 long long src_row, int cols,
                                                 int valid,
                                                 Scale scale = Scale()) {
  constexpr int V = Wide<T>::V;
  const int total = TILE * (cols / V);
  for (int base = 0; base < total; base += STAGE * NT) {
    uint4 buf[STAGE];
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int c = base + i * NT + threadIdx.x;
      const int r = c % TILE, cg = c / TILE;
      buf[i] = c < total && r < valid
                   ? *reinterpret_cast<const uint4*>(src + r * src_row +
                                                     cg * V)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int c = base + i * NT + threadIdx.x;
      if (c >= total) break;
      const int r = c % TILE, cg = c / TILE;
      float f[V];
      widen(buf[i], f);
      const float sc = r < valid ? scale(r) : 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) dstT[(cg * V + e) * ldT + r] = f[e] * sc;
    }
  }
}

// ---------------------------------------------------------------------------
// Warp tiles in the mma.sync m16n8k16 accumulator layout: a warp's 16 x
// 8 NTW f32 tile, element e of n-tile j of lane l at row l/4 + 8 (e/2),
// column 8 j + 2 (l%4) + e%2. In bf16 the products run on the tensor cores
// (bf16 in, f32 accumulate); an f32 operand enters as the bf16 pair hi +
// lo (lo the rounding error of hi), so each term keeps ~16 bits. In f32
// the same tile runs on the CUDA cores (TF32 would keep ~11 bits).
// Shared tiles have rows padded by 16 bytes, so the 8 row addresses of an
// ldmatrix hit 8 bank groups.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// A fragments (16 x 16) of A stored [m][k] (frag_a) or [k][m] (frag_a_t),
// `p` at (m, k) = (0, 0).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* p,
                                       int ld) {
  const int lane = threadIdx.x % 32;
  attn::ldsm_x4(a, p + (lane % 16) * ld + (lane / 16) * 8);
}
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* p,
                                         int ld) {
  const int lane = threadIdx.x % 32;
  attn::ldsm_x4_t(a, p + (lane % 8 + 8 * (lane / 16)) * ld +
                         8 * ((lane / 8) % 2));
}

// B fragments (16 x 8) of two n-tiles, b[0..1] the first and b[2..3] the
// second, of B stored [k][n] (frag_b_kn) or [n][k] (frag_b_nk); the
// frag_b1_* forms load one n-tile.
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* p,
                                          int ld) {
  const int lane = threadIdx.x % 32;
  attn::ldsm_x4_t(b, p + (((lane / 8) % 2) * 8 + lane % 8) * ld +
                         (lane / 16) * 8);
}
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* p,
                                          int ld) {
  const int lane = threadIdx.x % 32;
  attn::ldsm_x4(b, p + (lane % 8 + 8 * (lane / 16)) * ld +
                       8 * ((lane / 8) % 2));
}
__device__ __forceinline__ void frag_b1_kn(uint32_t (&b)[2], const bf16* p,
                                           int ld) {
  attn::ldsm_x2_t(b, p + (threadIdx.x % 16) * ld);
}
__device__ __forceinline__ void frag_b1_nk(uint32_t (&b)[2], const bf16* p,
                                           int ld) {
  const int lane = threadIdx.x % 32;
  attn::ldsm_x2(b, p + (lane % 8) * ld + 8 * ((lane / 8) % 2));
}

// acc (16 x 8 NTW) += A (16 x K) . B (K x 8 NTW), K a multiple of 16: A at
// `a` stored [m][k] (AT false) or [k][m] (AT true), B at `b` stored
// [k][n] (BKN true) or [n][k]. A split operand (SA, SB) is a bf16 pair,
// its lo part `alo` / `blo` elements past its hi part: the product adds
// lo.B (A split) and A.lo (B split) to hi.hi. Every term is added in one
// fixed order.
template <int NTW, bool AT, bool BKN, bool SA, bool SB>
__device__ __forceinline__ void tile_mma(float (&acc)[NTW][4], const bf16* a,
                                         int lda, int alo, const bf16* b,
                                         int ldb, int blo, int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* ap = AT ? a + k0 * lda : a + k0;
    uint32_t ah[4], al[4];
    if constexpr (AT) {
      frag_a_t(ah, ap, lda);
      if constexpr (SA) frag_a_t(al, ap + alo, lda);
    } else {
      frag_a(ah, ap, lda);
      if constexpr (SA) frag_a(al, ap + alo, lda);
    }
#pragma unroll
    for (int n = 0; n + 1 < NTW; n += 2) {
      const bf16* bp = BKN ? b + k0 * ldb + 8 * n : b + 8 * n * ldb + k0;
      uint32_t bh[4];
      if constexpr (BKN) frag_b_kn(bh, bp, ldb); else frag_b_nk(bh, bp, ldb);
      attn::mma_bf16(acc[n], ah, bh[0], bh[1]);
      attn::mma_bf16(acc[n + 1], ah, bh[2], bh[3]);
      if constexpr (SA) {
        attn::mma_bf16(acc[n], al, bh[0], bh[1]);
        attn::mma_bf16(acc[n + 1], al, bh[2], bh[3]);
      }
      if constexpr (SB) {
        uint32_t bl[4];
        if constexpr (BKN) frag_b_kn(bl, bp + blo, ldb);
        else frag_b_nk(bl, bp + blo, ldb);
        attn::mma_bf16(acc[n], ah, bl[0], bl[1]);
        attn::mma_bf16(acc[n + 1], ah, bl[2], bl[3]);
      }
    }
    if constexpr (NTW % 2 == 1) {
      constexpr int n = NTW - 1;
      const bf16* bp = BKN ? b + k0 * ldb + 8 * n : b + 8 * n * ldb + k0;
      uint32_t bh[2];
      if constexpr (BKN) frag_b1_kn(bh, bp, ldb); else frag_b1_nk(bh, bp, ldb);
      attn::mma_bf16(acc[n], ah, bh[0], bh[1]);
      if constexpr (SA) attn::mma_bf16(acc[n], al, bh[0], bh[1]);
      if constexpr (SB) {
        uint32_t bl[2];
        if constexpr (BKN) frag_b1_kn(bl, bp + blo, ldb);
        else frag_b1_nk(bl, bp + blo, ldb);
        attn::mma_bf16(acc[n], ah, bl[0], bl[1]);
      }
    }
  }
}

// The same tile in f32 on the CUDA cores (the split flags and lo offsets
// are ignored: an f32 operand is exact). K any size.
template <int NTW, bool AT, bool BKN, bool SA, bool SB>
__device__ __forceinline__ void tile_mma(float (&acc)[NTW][4],
                                         const float* a, int lda, int,
                                         const float* b, int ldb, int,
                                         int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = AT ? a[k * lda + g] : a[g * lda + k];
    const float a1 = AT ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int c = 8 * n + t2;
      float b0, b1;
      if constexpr (BKN) {
        const float2 v = *reinterpret_cast<const float2*>(b + k * ldb + c);
        b0 = v.x;
        b1 = v.y;
      } else {
        b0 = b[c * ldb + k];
        b1 = b[(c + 1) * ldb + k];
      }
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

// Two consecutive values of f32 or bf16 (8- or 4-byte aligned) as f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two consecutive values (8-byte aligned in f32, 4 in bf16) into a tile:
// f32 as they are; bf16 rounded, or (SPLIT) as the pair hi at p, lo at
// p + lo.
template <bool SPLIT>
__device__ __forceinline__ void put2(float* p, int, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <bool SPLIT>
__device__ __forceinline__ void put2(bf16* p, int lo, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
  if constexpr (SPLIT) {
    const float2 hf = __bfloat1622float2(h);
    *reinterpret_cast<__nv_bfloat162*>(p + lo) =
        __floats2bfloat162_rn(a - hf.x, b - hf.y);
  }
}

// Rows of a global tile into a shared operand tile that enters a product
// split: dst[r * ld + c] = src[r * src_row + c] * scale(r) for r < rows, c
// < cols, rows at or past `valid` zero, stored by put2<true> (f32 as it
// is, bf16 as the pair hi + lo, lo elements apart). cols is a multiple of
// 16 bytes of T; loads are batched as in stage_rows.
template <typename E, typename T, typename Scale>
__device__ __forceinline__ void stage_split(E* dst, int ld, int lo,
                                            const T* src, long long src_row,
                                            int rows, int cols, int valid,
                                            Scale scale) {
  constexpr int V = Wide<T>::V;
  const int cpr = cols / V, total = rows * cpr;
  for (int base = 0; base < total; base += STAGE * NT) {
    uint4 buf[STAGE];
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int c = base + i * NT + threadIdx.x;
      const int r = c / cpr;
      buf[i] = c < total && r < valid
                   ? *reinterpret_cast<const uint4*>(
                         src + r * src_row + (c - r * cpr) * V)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int c = base + i * NT + threadIdx.x;
      if (c >= total) break;
      const int r = c / cpr, col = (c - r * cpr) * V;
      const float sc = r < valid ? scale(r) : 0.f;
      float f[V];
      widen(buf[i], f);
#pragma unroll
      for (int e = 0; e < V; e += 2)
        put2<true>(dst + r * ld + col + e, lo, f[e] * sc, f[e + 1] * sc);
    }
  }
}

}  // namespace ssd
