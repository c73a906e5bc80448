// flash_prefill_bwd: the gradient of flash_prefill (dQ, dK, dV from dO).
//
// Replaces the gradient the JAX package takes of its attention: the TPU
// kernel src/repro/kernels/flash_prefill/kernel.py (flash_prefill) has no
// backward, and the JAX train step differentiates the jnp oracle
// flash_reference (src/repro/models/attention.py:44) instead. The plain
// version is kernels/flash_prefill/ref.py::flash_prefill_bwd_ref.
//
// FlashAttention-2's deterministic two-pass scheme, in three launches (a
// fourth where the dQ pass splits its walk, below):
//   1. D = rowsum(dO o O), 16 or 32 lanes a query row; the same pass
//      copies the forward's LSE beside D, 64 rows a tile ((B H, nq, [LSE,
//      D], 64) f32, zero past Sq), so that a tile's 512 bytes are one
//      bulk copy;
//   2. dK, dV: a block owns one (batch, kv head, 64-row kv tile) and walks
//      the group's query heads and the query tiles that meet the band; for
//      each it recomputes S^T = K Q^T and P^T = exp(S^T - LSE) from the
//      forward's log-sum-exp, dP^T = V dO^T and dS^T = P^T o (dP^T - D),
//      times the soft cap's derivative 1 - tanh^2, and accumulates
//      dV += P^T dO and dK += dS^T Q in f32 registers, with no atomics;
//   3. dQ: a block owns one (batch, head, q tile) and walks its kv tiles,
//      recomputing P and dS the same way: dQ += dS K.
// dQ and dK are scaled by `scale` once, at the store. Every sum runs in a
// fixed order, so two identical calls give identical bits. The masks are
// FlashWalk's (flash_prefill.cu): key kp is visible to query row r where
// kp < Skv, kp <= (Skv - Sq) + r when causal, kp > (Skv - Sq) + r - window
// with a window; rows past Sq and keys past Skv are zero-filled and masked.
// Tiles wholly above the diagonal or outside the window are skipped, and
// the mask is evaluated only on the tiles (16 rows of a warp x 64) that
// straddle an edge.
//
// Bound on the H100: 2.5 times the forward's operations (five products of
// the forward's size against two), so bound by operations at the
// training shapes, as the forward is. The two passes recompute S and dP
// in both: seven products where the bound counts five, so this scheme
// reaches at most 5/7 of the bound. A one-pass dQ would need atomics (or
// FlashAttention-3's ordered semaphores), and two identical calls would
// no longer give identical bits.
//
// bf16 at hd <= 128 (instances 16, 32, 64, 128 and the padded 64 and 128)
// runs on wgmma and TMA (attn_wgmma.cuh), warp-specialised: one producer
// warpgroup, whose single working thread issues every copy, and NC (dK/dV)
// or QH (dQ) consumer warpgroups of 64 rows each (wgmma's M). Q, K, V and
// dO are read through 4-D tensor maps in the caller's strides (rows past
// S and columns past hd arrive zero-filled), into the swizzled boxes the
// wgmma descriptors name.
//   dK/dV: K and V of the block's 64 kv rows are loaded once and stay.
//   The producer streams the items (query head of the group, q tile) in
//   order, each Q, dO and its LSE/D tile, through a ring of 2 NC stages
//   with full/empty mbarriers. With NC = 2 the two consumer warpgroups
//   take alternate items, each summing its own dK and dV for the same 64
//   kv rows; at the end warpgroup 1 hands its sums to warpgroup 0 through
//   the freed ring, which adds them (a fixed order) and stores. So a block
//   is 64 kv rows whatever NC, the grid has B Hkv ceil(Skv / 64) blocks
//   (256 for yi-6b's 16 (batch, kv head) pairs at S = 1024, two waves on
//   132 SMs that balance the causal walks), and the two warpgroups' work
//   interleaves on the tensor cores. S^T and dP^T are wgmma with both
//   operands from shared memory, K-major (K or V as A, Q or dO as B). P^T
//   and dS^T are formed on the accumulator registers, rounded to bf16
//   A-fragments in registers (as FlashAttention-2 rounds them before its
//   products), and dV += P^T dO, dK += dS^T Q take dO and Q as MN-major B
//   operands through the transpose bit, as the forward's P V takes V. At
//   hd <= 64 the products of one warpgroup are pipelined: S^T and dP^T of
//   item j + 1 are issued ahead of dV and dK of item j, and P and dS of
//   item j + 1 are formed while those run (on an H100, 2% faster at the
//   seamless encoder's shape than retiring them in turn). At hd 128 they
//   retire in turn: dK + dV take 128 f32 registers a thread and S^T +
//   dP^T 64, so item j's A-fragments cannot stay in flight beside the
//   next scores.
//   With NC = 2 the producer gives its registers to the consumers
//   (setmaxnreg, 24 and 240); the warpgroups' products interleave without
//   a turn order (the forward's ping-pong measured no faster here).
//   dQ: Q and dO of QH query heads of one kv head (the forward's
//   flash_heads_per_block rule) stay resident, each warp's rows also as
//   A-fragments in registers (read once from the swizzled boxes with
//   ldmatrix); K and V tiles stream through a three-stage ring. S = Q K^T
//   and dP = dO V^T are wgmma with A from those registers and K, V as
//   K-major B; dQ += dS K takes K as the MN-major B operand. With
//   QH = 2 the two warpgroups take turns to issue their products (named
//   barriers 1 and 2, the forward's ping-pong). q tiles launch heaviest
//   first; dK/dV's kv tile 0, the heaviest under the causal mask, is
//   blockIdx.y = 0.
//   Where the dQ grid would leave most of the card idle (seamless-m4t's
//   cross-attention: 64 queries, one q tile a head, 16 blocks), each q
//   tile's kv walk is cut into dq_split parts, one block each; a block
//   writes its part of dQ unscaled in f32 and launch 4 sums the parts in
//   part order (no atomics: the bits still repeat).
// The host picks NC, QH and the split from shapes alone
// (kernels/flash_prefill/kernel.py::bwd_warpgroups, bwd_dq_split): NC = 2
// where a block's walk has at least two items, QH as the forward, a split
// where the dQ grid fills less than half the SMs.
//
// bf16 at hd 256 (gemma3-1b) keeps the mma.sync kernels (m16n8k16,
// attn_mma.cuh's fragments, 8 warps a block): 64 rows of f32 dK + dV are
// 256 registers a thread, more than the 255 a thread may have, so a
// wgmma consumer warpgroup cannot hold them. In each tile's score phase
// warps 0-3 compute S (16 rows each) and warps 4-7 compute dP, which they
// pass on through shared memory; warps 0-3 then form P and dS, round them
// to bf16 into shared memory and every warp accumulates its 16 rows x
// HD/2 columns of the outputs. One stage, no copy overlapped with compute.
// f32 runs on the CUDA cores in full f32 (attn_simt.cuh's float4 tiles;
// TF32 would break the 5e-5 tolerance): a thread owns a 4 x 4 grid of
// scores and 4 rows x HD/16 output columns. Tiles are 64 rows, 32 in f32
// at hd 256 (four 64-row f32 tiles of 256 columns would need 266 KB).
#include <type_traits>

#include "attn_simt.cuh"
#include "attn_wgmma.cuh"

using namespace attn;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BWD_NT = 256;   // threads a block of the mma / simt kernels
constexpr int BT_LD = 64;     // query rows a tile of the LSE / D buffer

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;   // (B, H, Sq): the forward's
  float* ld;          // (B H, nq, 2, 64): LSE and D of each 64-row tile
  void *dq, *dk, *dv;
  // (batch, head, seq) element strides of q, k, v, o, dout, dq, dk, dv
  long long s[24];
  int H, Hkv, Sq, Skv, causal, window;
  float scale, softcap;
  int hd;
  int nq;             // 64-row query tiles, ceil(Sq / 64)
  int B;
  // bf16 dQ at hd <= 128: the kv walk of a q tile in dq_split parts, each
  // block's unscaled f32 part in dq_part (dq_split, B H, nq 64, hd), summed
  // in part order by launch 4 (dq_split 1: no part, no launch 4)
  int dq_split;
  float* dq_part;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qr, int kp) {
  const int qp = a.Skv - a.Sq + qr;
  bool ok = qr < a.Sq && kp < a.Skv;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
}

// Whether every pair of query rows q_lo .. q_lo + nq - 1 and keys k_lo ..
// k_lo + nk - 1 is visible.
__device__ __forceinline__ bool pairs_full(const BwdArgs& a, int q_lo,
                                           int nq, int k_lo, int nk) {
  const int off = a.Skv - a.Sq;
  bool f = q_lo + nq <= a.Sq && k_lo + nk <= a.Skv;
  if (a.causal) f = f && k_lo + nk - 1 <= off + q_lo;
  if (a.window > 0) f = f && k_lo > off + q_lo + nq - 1 - a.window;
  return f;
}

// exp(score - lse) of a visible pair (0 elsewhere); pc gets P times the
// soft cap's derivative 1 - tanh^2 (P itself without a cap).
__device__ __forceinline__ float probs(float s, float lse, float scale,
                                       float softcap, bool vis, float& pc) {
  const float x = score_post(s, scale, softcap);
  const float p = vis ? expf(x - lse) : 0.f;
  if (softcap > 0.f) {
    const float t = x / softcap;
    pc = p * (1.f - t * t);
  } else {
    pc = p;
  }
  return p;
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const long long* s,
                                       int b, int h, long long r) {
  return static_cast<const T*>(base) + b * s[0] + h * s[1] + r * s[2];
}

// The LSE / D buffer: element of query row r of (batch, head) bh; D is 64
// floats further.
__device__ __forceinline__ long long ld_index(const BwdArgs& a, int bh,
                                              int r) {
  return ((long long)bh * a.nq + r / BT_LD) * (2 * BT_LD) + r % BT_LD;
}

// Copy a BT x HD tile, row r from src + r * rs, into shared memory of row
// stride ls elements, 16 bytes a copy; rows at or past `valid` and columns
// at or past hd are zero-filled. The caller commits and waits.
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_tile(T* dst, int ls, const T* src,
                                          long long rs, int valid, int hd) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = HD / EPC;
  for (int i = threadIdx.x; i < BT * CPR; i += BWD_NT) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    T* d = dst + r * ls + c;
    if (r < valid && c < hd)
      cp_async16(d, src + r * rs + c);
    else
      zero16(d);
  }
}

// LSE and D of BT query rows from row q0 of head (b, h) into shared memory
// (0 past Sq, where the mask hides the row).
template <int BT>
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const BwdArgs& a, int b, int h,
                                          int q0) {
  for (int i = threadIdx.x; i < BT; i += BWD_NT) {
    const bool ok = q0 + i < a.Sq;
    const long long idx = ld_index(a, b * a.H + h, q0 + i);
    lse_s[i] = ok ? a.ld[idx] : 0.f;
    d_s[i] = ok ? a.ld[idx + BT_LD] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launch 1: D = rowsum(dO o O), and the LSE beside it
// ---------------------------------------------------------------------------
// LPR lanes a row, 16 bytes a lane (rows start on 16 bytes, hd is a
// multiple of 16): 16 lanes where a row is at most 256 bytes (bf16 up to
// hd 128), else 32.
template <typename T, int LPR>
__global__ void __launch_bounds__(BWD_NT) flash_prefill_bwd_dsum_kernel(
    const BwdArgs a) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int RPB = BWD_NT / LPR;          // rows a block
  const int lane = threadIdx.x % LPR;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int r = blockIdx.y * RPB + threadIdx.x / LPR;
  float acc = 0.f;
  if (r < a.Sq) {
    const T* o = at<T>(a.o, a.s + 9, b, h, r);
    const T* d = at<T>(a.dout, a.s + 12, b, h, r);
    for (int c = lane * EPC; c < a.hd; c += LPR * EPC) {
      float x[EPC], y[EPC];
      load16_f32(o + c, x);
      load16_f32(d + c, y);
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc = fmaf(x[e], y[e], acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0 && r < a.nq * BT_LD) {
    const long long idx = ld_index(a, bh, r);
    a.ld[idx] = r < a.Sq ? a.lse[(long long)bh * a.Sq + r] : 0.f;
    a.ld[idx + BT_LD] = acc;
  }
}

template <typename T>
cudaError_t launch_dsum(const BwdArgs& a, int B, cudaStream_t stream) {
  const int rows = a.nq * BT_LD;
  if (a.hd * (int)sizeof(T) <= 256) {
    flash_prefill_bwd_dsum_kernel<T, 16>
        <<<dim3(B * a.H, (rows + BWD_NT / 16 - 1) / (BWD_NT / 16)), BWD_NT, 0,
           stream>>>(a);
  } else {
    flash_prefill_bwd_dsum_kernel<T, 32>
        <<<dim3(B * a.H, (rows + BWD_NT / 32 - 1) / (BWD_NT / 32)), BWD_NT, 0,
           stream>>>(a);
  }
  return cudaGetLastError();
}

// The kv walk of one q tile: tiles kv_begin + BT t for t < nt (FlashWalk).
template <int BT>
struct KvWalk {
  int kv_begin, nt;
  __device__ KvWalk(const BwdArgs& a, int q0) {
    const int off = a.Skv - a.Sq, q_last = min(q0 + BT, a.Sq) - 1;
    int kv_end = a.Skv;
    if (a.causal) kv_end = min(a.Skv, off + q_last + 1);
    int kb = 0;
    if (a.window > 0) kb = max(0, off + q0 - a.window + 1);
    kv_begin = (kb / BT) * BT;
    nt = kv_end > kv_begin ? (kv_end - kv_begin + BT - 1) / BT : 0;
  }
};

// ---------------------------------------------------------------------------
// bf16 at hd 256: mma.sync, 8 warps
// ---------------------------------------------------------------------------

// s (16 x 64, the mma accumulator layout) = X[0..16) . Y[0..64)^T over the
// head dim; X and Y bf16 tiles of row stride LS in shared memory.
template <int HD, int LS>
__device__ __forceinline__ void mma_scores(float (&s)[8][4], const bf16* X,
                                           const bf16* Y) {
  constexpr int KSTEPS = HD / 16;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const bf16* xrow = X + (lane % 16) * LS + (lane / 16) * 8;
  const bf16* yrow = Y + (lane % 8) * LS;
#pragma unroll
  for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, xrow + kk * 16);
    ldsm_x4(a1, xrow + (kk + 1) * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bb[4];
      ldsm_x4(bb, yrow + 8 * j * LS + kk * 16 + (lane / 8) * 8);
      mma_bf16(s[j], a0, bb[0], bb[1]);
      mma_bf16(s[j], a1, bb[2], bb[3]);
    }
  }
  if constexpr (KSTEPS % 2 == 1) {
    uint32_t a0[4];
    ldsm_x4(a0, xrow + (KSTEPS - 1) * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bb[2];
      ldsm_x2(bb, yrow + 8 * j * LS + (KSTEPS - 1) * 16 +
                      ((lane / 8) % 2) * 8);
      mma_bf16(s[j], a0, bb[0], bb[1]);
    }
  }
}

// acc (16 rows x NC columns) += M[0..16) . Z: M a 16 x 64 bf16 tile of row
// stride MS, Z 64 rows of NC bf16 columns (row stride LS), both in shared
// memory. Z's rows are the contraction, so its fragments come through
// ldmatrix.trans, as V's do in the forward's P V.
template <int NC, int LS, int MS>
__device__ __forceinline__ void mma_rows(float (&acc)[NC / 8][4],
                                         const bf16* M, const bf16* Z) {
  constexpr int NT = NC / 8;
  const int lane = threadIdx.x % 32;
  const bf16* mrow = M + (lane % 16) * MS + (lane / 16) * 8;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t af[4];
    ldsm_x4(af, mrow + kt * 16);
    const bf16* zrow =
        Z + (16 * kt + ((lane / 8) % 2) * 8 + lane % 8) * LS + (lane / 16) * 8;
#pragma unroll
    for (int n = 0; n + 1 < NT; n += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, zrow + n * 8);
      mma_bf16(acc[n], af, bb[0], bb[1]);
      mma_bf16(acc[n + 1], af, bb[2], bb[3]);
    }
    if constexpr (NT % 2 == 1) {
      uint32_t bb[2];
      ldsm_x2_t(bb, zrow + (NT - 1) * 8);
      mma_bf16(acc[NT - 1], af, bb[0], bb[1]);
    }
  }
}

// Write a warp's 16 rows x NC columns (from column c0) of an accumulator,
// times `mul`, as bf16: rows r < n_valid, columns < hd.
template <int NC, typename RowFn>
__device__ __forceinline__ void mma_store_rows(const float (&acc)[NC / 8][4],
                                               float mul, int n_valid,
                                               int c0, int hd, RowFn row) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    if (r >= n_valid) continue;
    bf16* dst = row(r);
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const int c = c0 + 8 * n + 2 * t4;
      if (c >= hd) continue;                // a pair is in or out whole
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
          acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
}

template <int HD>
struct MmaBwdSmem {
  static constexpr int LS = HD + 8;          // bf16 tile rows, +16 bytes
  static constexpr int PS = 64 + 8;          // P / dS rows (bf16)
  static constexpr int FS = 64 + 4;          // dP rows (f32)
  static constexpr size_t TILE = 64 * LS * sizeof(bf16);
  static constexpr size_t BYTES = 4 * TILE + 2 * 64 * PS * sizeof(bf16) +
                                  64 * FS * sizeof(float) +
                                  2 * 64 * sizeof(float);
};

// The score phase of one pair of 64-row tiles, shared by both kernels.
// Warps 0-3 compute S = X Y^T for their 16 rows of X, warps 4-7 dP = X2
// Y2^T and leave it in dPs; then warps 0-3 form P and dS and store them as
// bf16 to Ps (when given) and DSs. Row r of X and column c of Y are mapped
// to (query row, key position) by qk(r, c, qr, kp); lse and D of query row
// qr - q0 are read from lse_s and d_s.
template <int HD, typename QkFn>
__device__ __forceinline__ void mma_score_phase(
    const BwdArgs& a, const bf16* X, const bf16* Y, const bf16* X2,
    const bf16* Y2, float* dPs, bf16* Ps, bf16* DSs, const float* lse_s,
    const float* d_s, int q0, QkFn qk) {
  using L = MmaBwdSmem<HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = (warp % 4) * 16;
  float s[8][4];
  if (warp < 4) {
    mma_scores<HD, L::LS>(s, X + wr * L::LS, Y);
  } else {
    mma_scores<HD, L::LS>(s, X2 + wr * L::LS, Y2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(dPs + (wr + g + 8 * i) * L::FS + 8 * j +
                                   2 * t4) =
            make_float2(s[j][2 * i], s[j][2 * i + 1]);
  }
  __syncthreads();                            // dP has landed
  if (warp < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + g + 8 * i, c = 8 * j + 2 * t4;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int qr, kp;
          qk(r, c + e, qr, kp);
          float pc;
          p[e] = probs(s[j][2 * i + e], lse_s[qr - q0], a.scale, a.softcap,
                       visible(a, qr, kp), pc);
          ds[e] = pc * (dPs[r * L::FS + c + e] - d_s[qr - q0]);
        }
        if (Ps != nullptr)
          *reinterpret_cast<uint32_t*>(Ps + r * L::PS + c) =
              pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(DSs + r * L::PS + c) =
            pack_bf16(ds[0], ds[1]);
      }
  }
  __syncthreads();                            // P and dS have landed
}

template <int HD, bool PAD>
__global__ void __launch_bounds__(BWD_NT, 1)
    flash_prefill_bwd_dkdv_mma_kernel(const BwdArgs a) {
  using L = MmaBwdSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + 64 * L::LS;
  bf16* Qs = Vs + 64 * L::LS;
  bf16* Os = Qs + 64 * L::LS;                 // dO
  bf16* Ps = Os + 64 * L::LS;                 // P^T (kv rows, q columns)
  bf16* DSs = Ps + 64 * L::PS;                // dS^T
  float* dPs = reinterpret_cast<float*>(DSs + 64 * L::PS);
  float* lse_s = dPs + 64 * L::FS;
  float* d_s = lse_s + 64;

  const int hd = head_dim<HD, PAD>(a.hd);
  const int G = a.H / a.Hkv;
  const int b = blockIdx.x / a.Hkv, kh = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * 64, off = a.Skv - a.Sq;
  load_tile<bf16, HD, 64>(Ks, L::LS, at<bf16>(a.k, a.s + 3, b, kh, k0),
                          a.s[5], a.Skv - k0, hd);
  load_tile<bf16, HD, 64>(Vs, L::LS, at<bf16>(a.v, a.s + 6, b, kh, k0),
                          a.s[8], a.Skv - k0, hd);
  cp_async_commit();
  // the query rows that see a key of this tile
  const int kl = min(k0 + 64, a.Skv);
  const int q_lo = a.causal ? max(0, k0 - off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, kl - 1 - off + a.window) : a.Sq;
  const int t_lo = q_lo / 64, t_hi = q_hi > q_lo ? (q_hi + 63) / 64 : t_lo;

  const int warp = threadIdx.x / 32;
  const int wr = (warp % 4) * 16, c0 = (warp / 4) * (HD / 2);
  float dk[HD / 16][4], dv[HD / 16][4];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kh * G + gq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * 64;
      __syncthreads();                        // the last tile is consumed
      load_tile<bf16, HD, 64>(Qs, L::LS, at<bf16>(a.q, a.s, b, h, q0),
                              a.s[2], a.Sq - q0, hd);
      load_tile<bf16, HD, 64>(Os, L::LS, at<bf16>(a.dout, a.s + 12, b, h,
                                                  q0),
                              a.s[14], a.Sq - q0, hd);
      cp_async_commit();
      load_rows<64>(lse_s, d_s, a, b, h, q0);
      cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T, dP^T = V dO^T: rows are keys, columns queries
      mma_score_phase<HD>(a, Ks, Qs, Vs, Os, dPs, Ps, DSs, lse_s, d_s, q0,
                          [&](int r, int c, int& qr, int& kp) {
                            qr = q0 + c;
                            kp = k0 + r;
                          });
      mma_rows<HD / 2, L::LS, L::PS>(dv, Ps + wr * L::PS, Os + c0);
      mma_rows<HD / 2, L::LS, L::PS>(dk, DSs + wr * L::PS, Qs + c0);
    }
  }
  cp_async_wait<0>();
  const int n_valid = a.Skv - k0 - wr;
  mma_store_rows<HD / 2>(dk, a.scale, n_valid, c0, hd, [&](int r) {
    return static_cast<bf16*>(a.dk) + b * a.s[18] + kh * a.s[19] +
           (long long)(k0 + wr + r) * a.s[20];
  });
  mma_store_rows<HD / 2>(dv, 1.f, n_valid, c0, hd, [&](int r) {
    return static_cast<bf16*>(a.dv) + b * a.s[21] + kh * a.s[22] +
           (long long)(k0 + wr + r) * a.s[23];
  });
}

template <int HD, bool PAD>
__global__ void __launch_bounds__(BWD_NT, 1)
    flash_prefill_bwd_dq_mma_kernel(const BwdArgs a) {
  using L = MmaBwdSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + 64 * L::LS;                 // dO
  bf16* Ks = Os + 64 * L::LS;
  bf16* Vs = Ks + 64 * L::LS;
  bf16* DSs = Vs + 64 * L::LS + 64 * L::PS;   // dS (q rows, kv columns)
  float* dPs = reinterpret_cast<float*>(DSs + 64 * L::PS);
  float* lse_s = dPs + 64 * L::FS;
  float* d_s = lse_s + 64;

  const int hd = head_dim<HD, PAD>(a.hd);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;   // heaviest first
  load_tile<bf16, HD, 64>(Qs, L::LS, at<bf16>(a.q, a.s, b, h, q0), a.s[2],
                          a.Sq - q0, hd);
  load_tile<bf16, HD, 64>(Os, L::LS, at<bf16>(a.dout, a.s + 12, b, h, q0),
                          a.s[14], a.Sq - q0, hd);
  cp_async_commit();
  load_rows<64>(lse_s, d_s, a, b, h, q0);
  const KvWalk<64> w(a, q0);

  const int warp = threadIdx.x / 32;
  const int wr = (warp % 4) * 16, c0 = (warp / 4) * (HD / 2);
  float dq[HD / 16][4];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = 0; t < w.nt; ++t) {
    const int kv0 = w.kv_begin + 64 * t;
    __syncthreads();
    load_tile<bf16, HD, 64>(Ks, L::LS, at<bf16>(a.k, a.s + 3, b, kh, kv0),
                            a.s[5], a.Skv - kv0, hd);
    load_tile<bf16, HD, 64>(Vs, L::LS, at<bf16>(a.v, a.s + 6, b, kh, kv0),
                            a.s[8], a.Skv - kv0, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // S = Q K^T, dP = dO V^T: rows are queries, columns keys
    mma_score_phase<HD>(a, Qs, Ks, Os, Vs, dPs, nullptr, DSs, lse_s, d_s, q0,
                        [&](int r, int c, int& qr, int& kp) {
                          qr = q0 + r;
                          kp = kv0 + c;
                        });
    mma_rows<HD / 2, L::LS, L::PS>(dq, DSs + wr * L::PS, Ks + c0);
  }
  cp_async_wait<0>();
  mma_store_rows<HD / 2>(dq, a.scale, a.Sq - q0 - wr, c0, hd, [&](int r) {
    return static_cast<bf16*>(a.dq) + b * a.s[15] + h * a.s[16] +
           (long long)(q0 + wr + r) * a.s[17];
  });
}

// ---------------------------------------------------------------------------
// bf16 at hd <= 128: wgmma + TMA, one producer and NC / QH consumer
// warpgroups
// ---------------------------------------------------------------------------

// P and dS of a warp's 16 x 64 block of one tile, in place on the wgmma
// accumulators (the mma.sync layout: element e of n-tile j is row lane/4 +
// 8 (e/2), column 8 j + 2 (lane%4) + e%2): s (q.k) becomes P = exp(score
// - LSE), dp (dO.v) becomes dS = P' (dP - D), P' = P times the soft cap's
// 1 - tanh^2. lsed(j, e, lse, d) gives LSE and D of element (j, e)'s query
// row; vis(r, c) is the mask of warp-local row r and column c, not
// evaluated when `full`. exp is the hardware ex2 (~2 ulp), far below the
// bf16 rounding of P and dS that follows.
template <typename LsedFn, typename VisFn>
__device__ __forceinline__ void probs_frag(float (&s)[8][4],
                                           float (&dp)[8][4],
                                           const BwdArgs& a, bool full,
                                           LsedFn lsed, VisFn vis) {
  constexpr float L2E = 1.4426950408889634f;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool cap = a.softcap > 0.f;
  const float c1 = a.scale * L2E;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lse, d, p, pc;
      lsed(j, e, lse, d);
      if (!cap) {
        p = ex2(fmaf(s[j][e], c1, -lse * L2E));
        pc = p;
      } else {
        const float x = score_post(s[j][e], a.scale, a.softcap);
        p = ex2((x - lse) * L2E);
        const float t = x / a.softcap;
        pc = p * (1.f - t * t);
      }
      if (!full && !vis(g + 8 * (e / 2), 8 * j + 2 * t4 + e % 2)) {
        p = 0.f;
        pc = 0.f;
      }
      s[j][e] = p;
      dp[j][e] = pc * (dp[j][e] - d);
    }
}

// A warp's 16 x 64 accumulator block as the bf16 A-fragments of four
// k-steps of 16 (the forward's P for P V).
__device__ __forceinline__ void pack_frags(const float (&s)[8][4],
                                           uint32_t (&f)[4][4]) {
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    f[k2][0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
    f[k2][1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
    f[k2][2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
    f[k2][3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
  }
}

template <int R>
__device__ __forceinline__ void zero_frag(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
}

// Shared memory of the dK/dV kernel: the K and V tiles, the ring of 2 NC
// stages (Q tiles, dO tiles, then each stage's LSE and D), the barriers,
// and 1024 bytes of alignment slack. 163 KB at hd 128 with NC = 2.
template <int HD, int NC>
struct DkdvSmem {
  static constexpr int RS = 2 * NC;
  static constexpr size_t BYTES = (size_t)(2 + 2 * RS) * WgBox<HD>::TILE +
                                  RS * 2 * BT_LD * sizeof(float) +
                                  (1 + 2 * RS) * sizeof(uint64_t) + 1024;
};

template <int HD, int NC, bool PAD>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_prefill_bwd_dkdv_wgmma_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using W = WgBox<HD>;
  constexpr int RS = DkdvSmem<HD, NC>::RS;
  constexpr int TE = W::TILE / 2;        // elements of a tile
  constexpr int BE = W::BYTES / 2;       // elements of a box
  constexpr bool REG = NC == 2;           // setmaxnreg 24 / 240
  constexpr bool OVERLAP = HD <= 64;      // P, dS of j + 1 under dV, dK of j
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base =
      smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;                    // RS stages
  bf16* Os = Qs + RS * TE;               // dO, RS stages
  float* lds = reinterpret_cast<float*>(Os + RS * TE);   // RS x [LSE, D]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(lds + RS * 2 * BT_LD);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + RS;

  const int G = a.H / a.Hkv;
  const int b = blockIdx.x / a.Hkv, kh = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * 64, off = a.Skv - a.Sq;
  // the query tiles t_lo .. t_lo + nqt - 1 that see a key of this tile;
  // item i is query head kh G + i / nqt of the group, tile t_lo + i % nqt
  const int kl = min(k0 + 64, a.Skv);
  const int q_lo = a.causal ? max(0, k0 - off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, kl - 1 - off + a.window) : a.Sq;
  const int t_lo = q_lo / 64;
  const int nqt = q_hi > q_lo ? (q_hi + 63) / 64 - t_lo : 0;
  const int N = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < RS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);   // the one warpgroup that takes stage s
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warp index through a shuffle, so that ptxas sees the role branch
  // as warp-uniform and gives each role its setmaxnreg count
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= 4 * NC) {
    if constexpr (REG) regs_dec<24>();
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(kvfull, 2 * W::TILE);
      for (int j = 0; j < W::NBOX; ++j) {
        tma_load4(Ks + j * BE, &tk, kvfull, j * W::COLS, k0, kh, b);
        tma_load4(Vs + j * BE, &tv, kvfull, j * W::COLS, k0, kh, b);
      }
      for (int i = 0; i < N; ++i) {
        const int s = i % RS;
        mbar_wait(&empty[s], ((i / RS) & 1) ^ 1);    // round 0 passes
        const int h = kh * G + i / nqt, t = t_lo + i % nqt;
        mbar_expect_tx(&full[s], 2 * W::TILE + 2 * BT_LD * sizeof(float));
        for (int j = 0; j < W::NBOX; ++j) {
          tma_load4(Qs + s * TE + j * BE, &tq, &full[s], j * W::COLS,
                    t * 64, h, b);
          tma_load4(Os + s * TE + j * BE, &tdo, &full[s], j * W::COLS,
                    t * 64, h, b);
        }
        bulk_load(lds + s * 2 * BT_LD,
                  a.ld + ((long long)(b * a.H + h) * a.nq + t) * 2 * BT_LD,
                  2 * BT_LD * sizeof(float), &full[s]);
      }
    }
  } else {
    if constexpr (REG) regs_inc<240>();
    const int wg = warp / 4;               // takes items wg, wg + NC, ...
    const int wr0 = (warp % 4) * 16;       // the warp's first kv row
    const int t4 = threadIdx.x % 4;
    float dk[HD / 8][4], dv[HD / 8][4], sc[8][4], dp[8][4];
    zero_frag(dk);
    zero_frag(dv);
    zero_frag(sc);
    zero_frag(dp);
    uint32_t pa[4][4], da[4][4];
    const uint32_t kt = smem_u32(Ks), vt = smem_u32(Vs);
    const int n = N > wg ? (N - wg + NC - 1) / NC : 0;

    auto wait_full = [&](int j) {
      const int i = wg + NC * j;
      mbar_wait(&full[i % RS], (i / RS) & 1);
    };
    auto issue_sdp = [&](int j) {          // S^T and dP^T of item j
      const int s = (wg + NC * j) % RS;
      const uint32_t qt = smem_u32(Qs + s * TE), ot = smem_u32(Os + s * TE);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc, desc_kmajor<HD>(kt, kk), desc_kmajor<HD>(qt, kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor<HD>(vt, kk), desc_kmajor<HD>(ot, kk),
                     kk > 0);
      wg_commit();
    };
    // Item j: S^T and dP^T have landed in sc and dp. With OVERLAP, dV and
    // dK of item j - 1 may still be on the tensor cores, and S^T, dP^T of
    // item j + 1 are issued ahead of dV, dK of item j. At hd 128 the
    // products retire in turn instead: dK + dV + S^T + dP^T take 192 of
    // the 240 registers, and item j's A-fragments in flight beside the
    // next scores would take 32 more (ptxas then spills and serialises
    // the products); the other warpgroup's products fill the gaps. No
    // product is issued in a data-dependent branch (the last item is a
    // separate instance), and between a product's issue and its wait no
    // other instruction touches its registers.
    auto step = [&](int j, auto more) {
      constexpr bool MORE = decltype(more)::value;
      const int i = wg + NC * j, s = i % RS;
      const int q0 = (t_lo + i % nqt) * 64;
      const float* ld = lds + s * 2 * BT_LD;
      probs_frag(sc, dp, a, pairs_full(a, q0, 64, k0 + wr0, 16),
                 [&](int jj, int e, float& lse, float& d) {
                   const int c = 8 * jj + 2 * t4 + e % 2;
                   lse = ld[c];
                   d = ld[BT_LD + c];
                 },
                 [&](int r, int c) {
                   return visible(a, q0 + c, k0 + wr0 + r);
                 });
      if constexpr (OVERLAP) {
        wg_wait<0>();                      // dV, dK of item j - 1 landed
        fence_regs(dk);
        fence_regs(dv);
        if (j > 0) mbar_arrive(&empty[(i - NC) % RS]);
      }
      pack_frags(sc, pa);
      pack_frags(dp, da);
      if constexpr (OVERLAP && MORE) wait_full(j + 1);
      wg_fence();
      if constexpr (OVERLAP && MORE) issue_sdp(j + 1);
      const uint32_t qt = smem_u32(Qs + s * TE), ot = smem_u32(Os + s * TE);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2)
        wgmma_rs<HD>(dv, pa[k2], desc_mnmajor<HD>(ot, k2));
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2)
        wgmma_rs<HD>(dk, da[k2], desc_mnmajor<HD>(qt, k2));
      wg_commit();
      if constexpr (OVERLAP) {
        if constexpr (MORE) {
          wg_wait<1>();                    // S^T, dP^T of item j + 1
          fence_regs(sc);
          fence_regs(dp);
        }
      } else {
        wg_wait<0>();                      // dV, dK of item j landed
        fence_regs(dk);
        fence_regs(dv);
        mbar_arrive(&empty[s]);
        if constexpr (MORE) {
          wait_full(j + 1);
          wg_fence();
          issue_sdp(j + 1);
          wg_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
        }
      }
    };
    mbar_wait(kvfull, 0);                  // K and V have landed
    if (n > 0) {
      wait_full(0);
      wg_fence();
      issue_sdp(0);
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      for (int j = 0; j + 1 < n; ++j) step(j, std::true_type());
      step(n - 1, std::false_type());
      wg_wait<0>();             // inside the branch: no product in flight
      fence_regs(dk);           // where the paths join
      fence_regs(dv);
    }
    if constexpr (NC == 2) {
      // warpgroup 1's sums through the ring, which no copy or product
      // touches any more, to warpgroup 0: dK = dK_0 + dK_1, in that order
      float4* red = reinterpret_cast<float4*>(Qs);
      const int tid = threadIdx.x % 128;
      bar_sync(3, 256);
      if (wg == 1) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          red[c * 128 + tid] = make_float4(dk[c][0], dk[c][1], dk[c][2],
                                           dk[c][3]);
          red[(HD / 8 + c) * 128 + tid] = make_float4(dv[c][0], dv[c][1],
                                                      dv[c][2], dv[c][3]);
        }
      }
      bar_sync(3, 256);
      if (wg == 0) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          const float4 x = red[c * 128 + tid];
          const float4 y = red[(HD / 8 + c) * 128 + tid];
          dk[c][0] += x.x; dk[c][1] += x.y; dk[c][2] += x.z; dk[c][3] += x.w;
          dv[c][0] += y.x; dv[c][1] += y.y; dv[c][2] += y.z; dv[c][3] += y.w;
        }
      }
    }
    if (wg == 0) {
      const int hd = head_dim<HD, PAD>(a.hd);
      const int n_valid = a.Skv - k0 - wr0;
      mma_store_rows<HD>(dk, a.scale, n_valid, 0, hd, [&](int r) {
        return static_cast<bf16*>(a.dk) + b * a.s[18] + kh * a.s[19] +
               (long long)(k0 + wr0 + r) * a.s[20];
      });
      mma_store_rows<HD>(dv, 1.f, n_valid, 0, hd, [&](int r) {
        return static_cast<bf16*>(a.dv) + b * a.s[21] + kh * a.s[22] +
               (long long)(k0 + wr0 + r) * a.s[23];
      });
    }
  }
}

// Shared memory of the dQ kernel: QH Q and dO tiles, the K and V rings,
// the barriers, 1024 bytes of alignment slack. 161 KB at hd 128, QH = 2.
constexpr int DQ_RING = 3;
template <int HD, int QH>
struct DqSmem {
  static constexpr size_t BYTES =
      (size_t)(2 * QH + 2 * DQ_RING) * WgBox<HD>::TILE +
      (1 + 2 * DQ_RING) * sizeof(uint64_t) + 1024;
};

template <int HD, int QH, bool PAD>
__global__ void __launch_bounds__(128 * (QH + 1), 1)
    flash_prefill_bwd_dq_wgmma_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using W = WgBox<HD>;
  constexpr int TE = W::TILE / 2;
  constexpr int BE = W::BYTES / 2;
  constexpr bool REG = QH == 2;           // setmaxnreg 24 / 240
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base =
      smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Os = Qs + QH * TE;               // dO
  bf16* Ks = Os + QH * TE;
  bf16* Vs = Ks + DQ_RING * TE;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Vs + DQ_RING * TE);
  uint64_t* kvfull = qfull + 1;
  uint64_t* empty = kvfull + DQ_RING;

  const int per = a.H / QH;
  const int b = blockIdx.x / per, h0 = (blockIdx.x % per) * QH;
  const int kh = h0 / (a.H / a.Hkv);
  const int qtile = a.nq - 1 - blockIdx.y;          // heaviest first
  const int q0 = qtile * 64;
  KvWalk<64> w(a, q0);
  if (a.dq_split > 1) {                  // part blockIdx.z of the walk
    const int per = (w.nt + a.dq_split - 1) / a.dq_split;
    const int t0 = min(w.nt, (int)blockIdx.z * per);
    w.kv_begin += 64 * t0;
    w.nt = min(w.nt - t0, per);
  }

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < DQ_RING; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&empty[s], 128 * QH);      // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= 4 * QH) {
    if constexpr (REG) regs_dec<24>();
    if (threadIdx.x == 128 * QH) {
      mbar_expect_tx(qfull, 2 * QH * W::TILE);
      for (int i = 0; i < QH; ++i)
        for (int j = 0; j < W::NBOX; ++j) {
          tma_load4(Qs + i * TE + j * BE, &tq, qfull, j * W::COLS, q0,
                    h0 + i, b);
          tma_load4(Os + i * TE + j * BE, &tdo, qfull, j * W::COLS, q0,
                    h0 + i, b);
        }
      for (int t = 0; t < w.nt; ++t) {
        const int s = t % DQ_RING;
        mbar_wait(&empty[s], ((t / DQ_RING) & 1) ^ 1);
        const int kv0 = w.kv_begin + 64 * t;
        mbar_expect_tx(&kvfull[s], 2 * W::TILE);
        for (int j = 0; j < W::NBOX; ++j) {
          tma_load4(Ks + s * TE + j * BE, &tk, &kvfull[s], j * W::COLS, kv0,
                    kh, b);
          tma_load4(Vs + s * TE + j * BE, &tv, &kvfull[s], j * W::COLS, kv0,
                    kh, b);
        }
      }
    }
  } else {
    if constexpr (REG) regs_inc<240>();
    const int hq = warp / 4;               // the warpgroup's query head
    const int wr0 = (warp % 4) * 16;       // the warp's first q row
    const int g = (threadIdx.x % 32) / 4;
    const int h = h0 + hq;
    // LSE and D of the thread's rows wr0 + g and wr0 + g + 8
    const float* ld = a.ld + ((long long)(b * a.H + h) * a.nq + qtile) *
                                 2 * BT_LD;
    const float lse_r[2] = {ld[wr0 + g], ld[wr0 + g + 8]};
    const float d_r[2] = {ld[BT_LD + wr0 + g], ld[BT_LD + wr0 + g + 8]};
    float dq[HD / 8][4], sc[8][4], dp[8][4];
    zero_frag(dq);
    zero_frag(sc);
    zero_frag(dp);
    // Q and dO stay for the whole walk: their warp rows as A-fragments in
    // registers, so S and dP read only K and V from shared memory
    uint32_t da[4][4], qf[HD / 16][4], of[HD / 16][4];
    auto issue_sdp = [&](int t) {          // S and dP of kv tile t
      const int s = t % DQ_RING;
      const uint32_t kt = smem_u32(Ks + s * TE), vt = smem_u32(Vs + s * TE);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_n64_k(sc, qf[kk], desc_kmajor<HD>(kt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_n64_k(dp, of[kk], desc_kmajor<HD>(vt, kk), kk > 0);
      wg_commit();
    };
    // the forward's ping-pong: with two consumer warpgroups they take
    // turns to issue their products, so the one's P and dS run under the
    // other's products
    auto my_turn = [&]() {
      if constexpr (QH == 2) bar_sync(1 + hq, 256);
    };
    auto your_turn = [&]() {
      if constexpr (QH == 2) bar_arrive(2 - hq, 256);
    };
    if constexpr (QH == 2)
      if (hq == 1) bar_arrive(1, 256);     // warpgroup 0 goes first
    auto step = [&](int t, auto more) {
      constexpr bool MORE = decltype(more)::value;
      const int s = t % DQ_RING;
      const int kv0 = w.kv_begin + 64 * t;
      probs_frag(sc, dp, a, pairs_full(a, q0 + wr0, 16, kv0, 64),
                 [&](int, int e, float& lse, float& d) {
                   lse = lse_r[e / 2];
                   d = d_r[e / 2];
                 },
                 [&](int r, int c) {
                   return visible(a, q0 + wr0 + r, kv0 + c);
                 });
      wg_wait<0>();                        // dQ of tile t - 1 has landed
      fence_regs(dq);
      if (t > 0) mbar_arrive(&empty[(t - 1) % DQ_RING]);
      pack_frags(dp, da);
      if constexpr (MORE)
        mbar_wait(&kvfull[(t + 1) % DQ_RING], ((t + 1) / DQ_RING) & 1);
      my_turn();
      wg_fence();
      if constexpr (MORE) issue_sdp(t + 1);
      const uint32_t kt = smem_u32(Ks + s * TE);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2)
        wgmma_rs<HD>(dq, da[k2], desc_mnmajor<HD>(kt, k2));
      wg_commit();
      your_turn();
      if constexpr (MORE) {
        wg_wait<1>();                      // S, dP of tile t + 1
        fence_regs(sc);
        fence_regs(dp);
      }
    };
    mbar_wait(qfull, 0);
    load_a_frags<HD>(qf, smem_u32(Qs + hq * TE), wr0);
    load_a_frags<HD>(of, smem_u32(Os + hq * TE), wr0);
    if (w.nt > 0) {
      mbar_wait(&kvfull[0], 0);
      my_turn();
      wg_fence();
      issue_sdp(0);
      your_turn();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      for (int t = 0; t + 1 < w.nt; ++t) step(t, std::true_type());
      step(w.nt - 1, std::false_type());
      wg_wait<0>();             // inside the branch: no product in flight
      fence_regs(dq);           // where the paths join
    }
    const int hd = head_dim<HD, PAD>(a.hd);
    if (a.dq_split > 1) {
      // this part of the walk, unscaled, every row of the tile (an empty
      // part writes its zeros too: launch 4 sums every part)
      float* part = a.dq_part +
                    (((long long)blockIdx.z * a.B * a.H + b * a.H + h) *
                         a.nq * 64 + q0 + wr0) * hd;
      const int lane = threadIdx.x % 32, t4 = lane % 4;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          const int col = 8 * c + 2 * t4;
          if (col < hd)
            *reinterpret_cast<float2*>(part + (g + 8 * i) * hd + col) =
                make_float2(dq[c][2 * i], dq[c][2 * i + 1]);
        }
    } else {
      mma_store_rows<HD>(dq, a.scale, a.Sq - q0 - wr0, 0, hd, [&](int r) {
        return static_cast<bf16*>(a.dq) + b * a.s[15] + h * a.s[16] +
               (long long)(q0 + wr0 + r) * a.s[17];
      });
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores, 256 threads as a 16 x 16 grid
// ---------------------------------------------------------------------------

template <int HD>
struct SimtBwd {
  static constexpr int BT = HD <= 128 ? 64 : 32;   // tile rows
  static constexpr int R = BT / 16;                // rows (and score cols)
  static constexpr int LS = HD + 4;                // tile rows (f32)
  static constexpr int PS = BT + 4;                // P / dS rows
  static constexpr size_t BYTES =
      (4 * BT * LS + 2 * BT * PS + 2 * BT) * sizeof(float);
};

// s[i][j] = X[ty + 16 i] . Y[tx + 16 j] over the head dim (float4 steps).
template <int HD>
__device__ __forceinline__ void simt_scores(
    float (&s)[SimtBwd<HD>::R][SimtBwd<HD>::R], const float* X,
    const float* Y) {
  using L = SimtBwd<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < L::R; ++i)
#pragma unroll
    for (int j = 0; j < L::R; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 xv[L::R], yv[L::R];
#pragma unroll
    for (int i = 0; i < L::R; ++i)
      xv[i] = load4_f32(X + (ty + 16 * i) * L::LS + d);
#pragma unroll
    for (int j = 0; j < L::R; ++j)
      yv[j] = load4_f32(Y + (tx + 16 * j) * L::LS + d);
#pragma unroll
    for (int i = 0; i < L::R; ++i)
#pragma unroll
      for (int j = 0; j < L::R; ++j) {
        float acc = s[i][j];
        acc = fmaf(xv[i].x, yv[j].x, acc);
        acc = fmaf(xv[i].y, yv[j].y, acc);
        acc = fmaf(xv[i].z, yv[j].z, acc);
        acc = fmaf(xv[i].w, yv[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// acc[i][j] += sum_c M[ty + 16 i][c] Z[c][tx + 16 j], c < BT.
template <int HD>
__device__ __forceinline__ void simt_rows(
    float (&acc)[SimtBwd<HD>::R][HD / 16], const float* M, const float* Z) {
  using L = SimtBwd<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < L::BT; ++c) {
    float mv[L::R];
#pragma unroll
    for (int i = 0; i < L::R; ++i) mv[i] = M[(ty + 16 * i) * L::PS + c];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const float z = Z[c * L::LS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < L::R; ++i) acc[i][j] = fmaf(mv[i], z, acc[i][j]);
    }
  }
}

// The score phase: S = X Y^T and dP = X2 Y2^T, then P (to Ps, when given)
// and dS (to DSs); qk maps (row, column) to (query row, key position).
template <int HD, typename QkFn>
__device__ __forceinline__ void simt_score_phase(
    const BwdArgs& a, const float* X, const float* Y, const float* X2,
    const float* Y2, float* Ps, float* DSs, const float* lse_s,
    const float* d_s, int q0, QkFn qk) {
  using L = SimtBwd<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[L::R][L::R], dp[L::R][L::R];
  simt_scores<HD>(s, X, Y);
  simt_scores<HD>(dp, X2, Y2);
#pragma unroll
  for (int i = 0; i < L::R; ++i)
#pragma unroll
    for (int j = 0; j < L::R; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      int qr, kp;
      qk(r, c, qr, kp);
      float pc;
      const float p = probs(s[i][j], lse_s[qr - q0], a.scale, a.softcap,
                            visible(a, qr, kp), pc);
      if (Ps != nullptr) Ps[r * L::PS + c] = p;
      DSs[r * L::PS + c] = pc * (dp[i][j] - d_s[qr - q0]);
    }
  __syncthreads();
}

template <int HD>
__device__ __forceinline__ void simt_store_rows(
    const float (&acc)[SimtBwd<HD>::R][HD / 16], float mul, int n_valid,
    int hd, float* base, long long rs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < SimtBwd<HD>::R; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_valid) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) base[r * rs + c] = acc[i][j] * mul;
    }
  }
}

template <int HD, bool PAD>
__global__ void __launch_bounds__(BWD_NT, 1)
    flash_prefill_bwd_dkdv_simt_kernel(const BwdArgs a) {
  using L = SimtBwd<HD>;
  constexpr int BT = L::BT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BT * L::LS;
  float* Qs = Vs + BT * L::LS;
  float* Os = Qs + BT * L::LS;
  float* Ps = Os + BT * L::LS;
  float* DSs = Ps + BT * L::PS;
  float* lse_s = DSs + BT * L::PS;
  float* d_s = lse_s + BT;

  const int hd = head_dim<HD, PAD>(a.hd);
  const int G = a.H / a.Hkv;
  const int b = blockIdx.x / a.Hkv, kh = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * BT, off = a.Skv - a.Sq;
  load_tile<float, HD, BT>(Ks, L::LS, at<float>(a.k, a.s + 3, b, kh, k0),
                           a.s[5], a.Skv - k0, hd);
  load_tile<float, HD, BT>(Vs, L::LS, at<float>(a.v, a.s + 6, b, kh, k0),
                           a.s[8], a.Skv - k0, hd);
  cp_async_commit();
  const int kl = min(k0 + BT, a.Skv);
  const int q_lo = a.causal ? max(0, k0 - off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, kl - 1 - off + a.window) : a.Sq;
  const int t_lo = q_lo / BT, t_hi = q_hi > q_lo ? (q_hi + BT - 1) / BT : t_lo;

  float dk[L::R][HD / 16], dv[L::R][HD / 16];
#pragma unroll
  for (int i = 0; i < L::R; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kh * G + gq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BT;
      __syncthreads();
      load_tile<float, HD, BT>(Qs, L::LS, at<float>(a.q, a.s, b, h, q0),
                               a.s[2], a.Sq - q0, hd);
      load_tile<float, HD, BT>(Os, L::LS,
                               at<float>(a.dout, a.s + 12, b, h, q0),
                               a.s[14], a.Sq - q0, hd);
      cp_async_commit();
      load_rows<BT>(lse_s, d_s, a, b, h, q0);
      cp_async_wait<0>();
      __syncthreads();
      simt_score_phase<HD>(a, Ks, Qs, Vs, Os, Ps, DSs, lse_s, d_s, q0,
                           [&](int r, int c, int& qr, int& kp) {
                             qr = q0 + c;
                             kp = k0 + r;
                           });
      simt_rows<HD>(dv, Ps, Os);
      simt_rows<HD>(dk, DSs, Qs);
    }
  }
  cp_async_wait<0>();
  float* dkb = static_cast<float*>(a.dk) + b * a.s[18] + kh * a.s[19] +
               (long long)k0 * a.s[20];
  float* dvb = static_cast<float*>(a.dv) + b * a.s[21] + kh * a.s[22] +
               (long long)k0 * a.s[23];
  simt_store_rows<HD>(dk, a.scale, a.Skv - k0, hd, dkb, a.s[20]);
  simt_store_rows<HD>(dv, 1.f, a.Skv - k0, hd, dvb, a.s[23]);
}

template <int HD, bool PAD>
__global__ void __launch_bounds__(BWD_NT, 1)
    flash_prefill_bwd_dq_simt_kernel(const BwdArgs a) {
  using L = SimtBwd<HD>;
  constexpr int BT = L::BT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + BT * L::LS;
  float* Ks = Os + BT * L::LS;
  float* Vs = Ks + BT * L::LS;
  float* DSs = Vs + BT * L::LS + BT * L::PS;
  float* lse_s = DSs + BT * L::PS;
  float* d_s = lse_s + BT;

  const int hd = head_dim<HD, PAD>(a.hd);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  load_tile<float, HD, BT>(Qs, L::LS, at<float>(a.q, a.s, b, h, q0), a.s[2],
                           a.Sq - q0, hd);
  load_tile<float, HD, BT>(Os, L::LS, at<float>(a.dout, a.s + 12, b, h, q0),
                           a.s[14], a.Sq - q0, hd);
  cp_async_commit();
  load_rows<BT>(lse_s, d_s, a, b, h, q0);
  const KvWalk<BT> w(a, q0);

  float dq[L::R][HD / 16];
#pragma unroll
  for (int i = 0; i < L::R; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dq[i][j] = 0.f;

  for (int t = 0; t < w.nt; ++t) {
    const int kv0 = w.kv_begin + BT * t;
    __syncthreads();
    load_tile<float, HD, BT>(Ks, L::LS, at<float>(a.k, a.s + 3, b, kh, kv0),
                             a.s[5], a.Skv - kv0, hd);
    load_tile<float, HD, BT>(Vs, L::LS, at<float>(a.v, a.s + 6, b, kh, kv0),
                             a.s[8], a.Skv - kv0, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    simt_score_phase<HD>(a, Qs, Ks, Os, Vs, nullptr, DSs, lse_s, d_s, q0,
                         [&](int r, int c, int& qr, int& kp) {
                           qr = q0 + r;
                           kp = kv0 + c;
                         });
    simt_rows<HD>(dq, DSs, Ks);
  }
  cp_async_wait<0>();
  float* dqb = static_cast<float*>(a.dq) + b * a.s[15] + h * a.s[16] +
               (long long)q0 * a.s[17];
  simt_store_rows<HD>(dq, a.scale, a.Sq - q0, hd, dqb, a.s[17]);
}

// launch 4 (bf16, dq_split > 1): dQ = scale * the sum of the parts, in part
// order; a thread 4 columns of one row (hd is a multiple of 16)
__global__ void __launch_bounds__(BWD_NT) flash_prefill_bwd_dq_sum_kernel(
    const BwdArgs a) {
  const int hd4 = a.hd / 4, rows = a.nq * 64;
  const long long i =
      (long long)blockIdx.x * BWD_NT + threadIdx.x;   // (bh, row, col / 4)
  if (i >= (long long)a.B * a.H * rows * hd4) return;
  const int c = (int)(i % hd4) * 4;
  const int r = (int)((i / hd4) % rows);
  const int bh = (int)(i / ((long long)hd4 * rows));
  if (r >= a.Sq) return;
  const long long stride = (long long)a.B * a.H * rows * a.hd;
  const float* part = a.dq_part + ((long long)bh * rows + r) * a.hd + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < a.dq_split; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(part + p * stride);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* dq = static_cast<bf16*>(a.dq) + (bh / a.H) * a.s[15] +
             (bh % a.H) * a.s[16] + (long long)r * a.s[17] + c;
  reinterpret_cast<__nv_bfloat162*>(dq)[0] =
      __floats2bfloat162_rn(acc.x * a.scale, acc.y * a.scale);
  reinterpret_cast<__nv_bfloat162*>(dq)[1] =
      __floats2bfloat162_rn(acc.z * a.scale, acc.w * a.scale);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t launch(K kern, dim3 grid, size_t bytes, cudaStream_t stream,
                   const BwdArgs& a) {
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, BWD_NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_wg(K kern, dim3 grid, int threads, size_t bytes,
                      cudaStream_t stream, const CUtensorMap (&m)[4],
                      const BwdArgs& a) {
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, bytes, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

// The bf16 wgmma passes 2 and 3: NC consumer warpgroups of the dK/dV
// kernel, QH query heads a block of the dQ kernel.
template <int HD, bool PAD>
cudaError_t launch_wgmma(const BwdArgs& a, int B, int nc, int qh,
                         cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = make_map<HD>(&m[0], a.q, a.hd, a.Sq, a.H, B, a.s[0],
                                 a.s[1], a.s[2]);
  if (err == cudaSuccess)
    err = make_map<HD>(&m[1], a.k, a.hd, a.Skv, a.Hkv, B, a.s[3], a.s[4],
                       a.s[5]);
  if (err == cudaSuccess)
    err = make_map<HD>(&m[2], a.v, a.hd, a.Skv, a.Hkv, B, a.s[6], a.s[7],
                       a.s[8]);
  if (err == cudaSuccess)
    err = make_map<HD>(&m[3], a.dout, a.hd, a.Sq, a.H, B, a.s[12], a.s[13],
                       a.s[14]);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(B * a.Hkv, (a.Skv + 63) / 64);
  if (nc == 2)
    err = launch_wg(flash_prefill_bwd_dkdv_wgmma_kernel<HD, 2, PAD>, kv_grid,
                    384, DkdvSmem<HD, 2>::BYTES, stream, m, a);
  else
    err = launch_wg(flash_prefill_bwd_dkdv_wgmma_kernel<HD, 1, PAD>, kv_grid,
                    256, DkdvSmem<HD, 1>::BYTES, stream, m, a);
  if (err != cudaSuccess) return err;
  const int z = a.dq_split;
  if (qh == 2)
    err = launch_wg(flash_prefill_bwd_dq_wgmma_kernel<HD, 2, PAD>,
                    dim3(B * a.H / 2, a.nq, z), 384, DqSmem<HD, 2>::BYTES,
                    stream, m, a);
  else
    err = launch_wg(flash_prefill_bwd_dq_wgmma_kernel<HD, 1, PAD>,
                    dim3(B * a.H, a.nq, z), 256, DqSmem<HD, 1>::BYTES,
                    stream, m, a);
  if (err == cudaSuccess && z > 1) {
    const long long n = (long long)B * a.H * a.nq * 64 * (a.hd / 4);
    err = launch(flash_prefill_bwd_dq_sum_kernel,
                 dim3((unsigned)((n + BWD_NT - 1) / BWD_NT)), 0, stream, a);
  }
  return err;
}

template <int HD, bool PAD>
cudaError_t launch_bwd(int dtype, BwdArgs a, int B, int nc, int qh,
                       cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 0) {
    using L = SimtBwd<HD>;
    a.dq_split = 1;                      // the bf16 wgmma dQ's alone
    err = launch_dsum<float>(a, B, stream);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dkdv_simt_kernel<HD, PAD>,
                   dim3(B * a.Hkv, (a.Skv + L::BT - 1) / L::BT), L::BYTES,
                   stream, a);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dq_simt_kernel<HD, PAD>,
                   dim3(B * a.H, (a.Sq + L::BT - 1) / L::BT), L::BYTES,
                   stream, a);
    return err;
  }
  err = launch_dsum<bf16>(a, B, stream);
  if (err != cudaSuccess) return err;
  if constexpr (HD == 256) {
    using L = MmaBwdSmem<HD>;
    a.dq_split = 1;
    err = launch(flash_prefill_bwd_dkdv_mma_kernel<HD, PAD>,
                 dim3(B * a.Hkv, (a.Skv + 63) / 64), L::BYTES, stream, a);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dq_mma_kernel<HD, PAD>,
                   dim3(B * a.H, a.nq), L::BYTES, stream, a);
    return err;
  } else {
    return launch_wgmma<HD, PAD>(a, B, nc, qh, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// alike). st: 24 element strides, (batch, head, seq) for each of q, k, v,
// o, dout, dq, dk, dv in (B, heads, S, hd) views; every tensor starts on
// 16 bytes and every stride is a whole number of 16-byte chunks (the
// wrapper checks). lse: the forward's (B, H, Sq) f32 log-sum-exp; ld: a
// f32 scratch buffer of B * H * ceil(Sq / 64) * 128 floats on 16 bytes
// for LSE and D by 64-row tiles. hd: a multiple of 16 up to 256. nc: the
// consumer warpgroups (1 or 2) of the bf16 dK/dV kernel at hd <= 128; qh:
// the query heads a block (1, or 2 where H / Hkv is even) of its dQ
// kernel; dq_split: the parts of its kv walk (1, or more with dq_part, a
// f32 scratch buffer of dq_split * B * H * ceil(Sq / 64) * 64 * hd floats).
// Three launches on `stream`, a fourth (the sum of the dQ parts) where
// dq_split > 1; returns the first cudaError_t.
extern "C" int flash_prefill_bwd(int dtype, int hd, const void* q,
                                 const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse,
                                 float* ld, void* dq, void* dk, void* dv,
                                 const long long* st, int B, int H, int Hkv,
                                 int Sq, int Skv, int causal, int window,
                                 float scale, float softcap, int nc, int qh,
                                 int dq_split, float* dq_part,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0 || Skv == 0) return 0;
  if ((dtype != 0 && dtype != 1) || (nc != 1 && nc != 2) ||
      (qh != 1 && qh != 2) || H % Hkv != 0 || (qh == 2 && (H / Hkv) % 2) ||
      dq_split < 1 || (dq_split > 1 && dq_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.ld = ld;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 24; ++i) a.s[i] = st[i];
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.hd = hd;
  a.nq = (Sq + BT_LD - 1) / BT_LD;
  a.B = B;
  a.dq_split = dq_split;
  a.dq_part = dq_part;
  cudaError_t err = cudaErrorInvalidValue;
  ATTN_DISPATCH_HD(hd, HD, PAD,
                   err = (launch_bwd<HD, PAD>(dtype, a, B, nc, qh, s)));
  return static_cast<int>(err);
}
