// flash_prefill_bwd: the gradient of flash_prefill (dQ, dK, dV from dO).
//
// Replaces the gradient the JAX package takes of its attention: the TPU
// kernel src/repro/kernels/flash_prefill/kernel.py (flash_prefill) has no
// backward, and the JAX train step differentiates the jnp oracle
// flash_reference (src/repro/models/attention.py:44) instead. The plain
// version is kernels/flash_prefill/ref.py::flash_prefill_bwd_ref.
//
// FlashAttention-2's deterministic two-pass scheme, in three launches:
//   1. D = rowsum(dO o O), one warp a query row;
//   2. dK, dV: a block owns one (batch, kv head, kv tile) and walks the
//      group's query heads and the query tiles that meet the band; for
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
//
// Bound on the H100: 2.5 times the forward's operations (five products of
// the forward's size against two), so bound by operations at the
// training shapes, as the forward is.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, attn_mma.cuh's
// fragments): 8 warps a block. In each tile's score phase warps 0-3
// compute S (16 rows each) and warps 4-7 compute dP, which they pass on
// through shared memory; warps 0-3 then form P and dS, round them to bf16
// into shared memory (as FlashAttention-2 does before its products) and
// every warp accumulates its 16 rows x HD/2 columns of the outputs. f32
// runs on the CUDA cores in full f32 (attn_simt.cuh's float4 tiles): a
// thread owns a 4 x 4 grid of scores and 4 rows x HD/16 output columns.
// Tiles are 64 rows, 32 in f32 at hd 256 (four 64-row f32 tiles of 256
// columns would need 266 KB). Simple first: one stage, no copy overlapped
// with compute.
#include "attn_simt.cuh"

using namespace attn;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BWD_NT = 256;   // threads a block (8 warps)

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;   // (B, H, Sq)
  float* dsum;        // (B, H, Sq): D
  void *dq, *dk, *dv;
  // (batch, head, seq) element strides of q, k, v, o, dout, dq, dk, dv
  long long s[24];
  int H, Hkv, Sq, Skv, causal, window;
  float scale, softcap;
  int hd;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qr, int kp) {
  const int qp = a.Skv - a.Sq + qr;
  bool ok = qr < a.Sq && kp < a.Skv;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
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
    const long long idx = ((long long)b * a.H + h) * a.Sq + q0 + i;
    const bool ok = q0 + i < a.Sq;
    lse_s[i] = ok ? a.lse[idx] : 0.f;
    d_s[i] = ok ? a.dsum[idx] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launch 1: D = rowsum(dO o O), one warp a row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(BWD_NT) flash_prefill_bwd_dsum_kernel(
    const BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int r = blockIdx.y * (BWD_NT / 32) + warp;
  if (r >= a.Sq) return;
  const T* o = at<T>(a.o, a.s + 9, b, h, r);
  const T* d = at<T>(a.dout, a.s + 12, b, h, r);
  float acc = 0.f;
  for (int c = lane; c < a.hd; c += 32) acc += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dsum[((long long)b * a.H + h) * a.Sq + r] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, 8 warps
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

template <int HD, bool PAD>
cudaError_t launch_bwd(int dtype, const BwdArgs& a, int B,
                       cudaStream_t stream) {
  const dim3 dsum_grid(B * a.H, (a.Sq + BWD_NT / 32 - 1) / (BWD_NT / 32));
  cudaError_t err;
  if (dtype == 0) {
    using L = SimtBwd<HD>;
    err = launch(flash_prefill_bwd_dsum_kernel<float>, dsum_grid, 0, stream, a);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dkdv_simt_kernel<HD, PAD>,
                   dim3(B * a.Hkv, (a.Skv + L::BT - 1) / L::BT), L::BYTES,
                   stream, a);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dq_simt_kernel<HD, PAD>,
                   dim3(B * a.H, (a.Sq + L::BT - 1) / L::BT), L::BYTES,
                   stream, a);
  } else {
    using L = MmaBwdSmem<HD>;
    err = launch(flash_prefill_bwd_dsum_kernel<bf16>, dsum_grid, 0, stream, a);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dkdv_mma_kernel<HD, PAD>,
                   dim3(B * a.Hkv, (a.Skv + 63) / 64), L::BYTES, stream, a);
    if (err == cudaSuccess)
      err = launch(flash_prefill_bwd_dq_mma_kernel<HD, PAD>,
                   dim3(B * a.H, (a.Sq + 63) / 64), L::BYTES, stream, a);
  }
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// alike). st: 24 element strides, (batch, head, seq) for each of q, k, v,
// o, dout, dq, dk, dv in (B, heads, S, hd) views; every tensor starts on
// 16 bytes and every stride is a whole number of 16-byte chunks (the
// wrapper checks). lse: the forward's (B, H, Sq) f32 log-sum-exp; dsum: a
// (B, H, Sq) f32 scratch buffer for D. hd: a multiple of 16 up to 256.
// Three launches on `stream`; returns the first cudaError_t.
extern "C" int flash_prefill_bwd(int dtype, int hd, const void* q,
                                 const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse,
                                 float* dsum, void* dq, void* dk, void* dv,
                                 const long long* st, int B, int H, int Hkv,
                                 int Sq, int Skv, int causal, int window,
                                 float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0 || Skv == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dsum = dsum;
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
  cudaError_t err = cudaErrorInvalidValue;
  ATTN_DISPATCH_HD(hd, HD, PAD, err = (launch_bwd<HD, PAD>(dtype, a, B, s)));
  return static_cast<int>(err);
}
