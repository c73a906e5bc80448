// ssd_scan: the Mamba2 SSD chunked scan, y and the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan, _kernel). Per (batch, head), over chunks of Q steps:
//   y   = (C.B^T o L).(x dt) + exp(a_cum) (C.h_in^T) + D x,
//         L[t, s] = exp(a_cum[t] - a_cum[s]) for s <= t, 0 above,
//   h  <- h exp(a_cum[-1]) + (x dt)^T . (B exp(a_cum[-1] - a_cum)),
// with a_cum the within-chunk cumulative sum of dt * A, and h (hd x N,
// f32) written out as h_final. x, B, C and y are f32 or bf16; dt, A, D,
// h0 and h_final are f32; every sum is taken in f32.
//
// Bound on the H100 at the main path's shape (b 1, S 2048 in 8 chunks of
// 256, 80 heads of hd 64, 1 group, N 128): the useful work is ~8.1 GFLOP
// (C.B^T over the causal pairs once per chunk and group, the three
// products per chunk and head) against ~89 MB in f32, so the f32 kernel
// is bound by operations (0.121 ms at 67 TF/s) and the bf16 one by bytes
// (~0.014 ms at 3.35 TB/s).
//
// Design: the SSD block decomposition spread over the card, in four
// launches of one op call, deterministic and without atomics. The TPU
// kernel walks the chunks of a head in order on one core; the port's
// first kernel did the same with one block per head (80 blocks for 132
// SMs, a sequential walk, C.B^T recomputed for each of the 80 heads of a
// group). Now (the launch plan is kernels/ssd_scan/kernel.py::ssd_plan):
//   1. chunk states, one block per (chunk, head): a block scan gives the
//      chunk's a_cum (kept in a scratch tensor for phase 4), then S_c =
//      (x dt exp(a_last - a_cum))^T B, hd x N in f32 register tiles,
//      stored [n][d].
//   2. state passing, one thread per state element: h_in[c] = h; h = h
//      exp(a_last_c) + S_c over the nc chunks (8 chunks' loads in flight
//      at once), S_c overwritten in place by h_in[c]; starts from h0 or
//      zeros and writes h_final. hd N values a chunk, bound by bytes.
//   3. C.B^T, one block per (chunk, group, query tile, source tile at or
//      below it): 64 x 64 tiles into a scratch tensor, computed once for
//      every head of the group and read back from L2.
//   4. chunk outputs, one block per (chunk, 64-row query tile, block of up
//      to 8 heads of one group), query tiles heaviest first: per head the
//      carried-in term exp(a_t) C_t.h_in^T, then for each source tile P =
//      C.B^T exp(a_t - a_s), taken for s <= t only (above the diagonal
//      the exponent is positive and could overflow to inf, and inf * 0 is
//      NaN), times x dt.
// A chunk is any size from 1 to 256: prefill of an S-token prompt runs
// chunk = min(256, S); rows past the chunk read as zero. Padded tail
// steps (dt = 0) decay by exp(0) = 1 and add nothing. Tiles come in by
// batched 16-byte loads, so a tile costs about one memory latency.
//
// Precision. The state path (phases 1 and 2, h_final) is f32 on the CUDA
// cores in both dtypes: h_final is held to f32's tolerance in bf16 too.
// f32 products run from shared memory on register tiles read as float4s
// (4 rows x 4 or 8 columns a thread); TF32 would break the 3e-4
// tolerance. In bf16, C.B^T (exact: bf16 inputs, f32 accumulation) and
// the phase-4 products run on the tensor cores (mma.sync m16n8k16), the
// f32 operands h_in and P split into bf16 pairs hi + lo (below;
// `split_bf16` and the warp tile `tile_mma` are in ssd_common.cuh, which
// the gradient shares).

#include "attn_mma.cuh"
#include "ssd_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;
using namespace ssd;

constexpr int NJ = MAX_N / 64;

// ---------------------------------------------------------------------------
// 1. chunk states: one block per (chunk, head)
// ---------------------------------------------------------------------------
// State tile hd x N: TY threads over d (DR contiguous rows each), 16 over
// n (float4 columns n = 4 tx + 64 j).
template <int HD>
struct StMap {
  static constexpr int TY = HD < 16 ? HD : 16;
  static constexpr int DR = HD / TY;
  static constexpr int ACTIVE = TY * 16;
};

size_t state_smem(int hd, int N) {
  return ((size_t)TILE * (hd + 4) + (size_t)TILE * (N + 4) + 2 * MAX_Q +
          NW) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) ssd_scan_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ acum, int S, int nh,
    int G, int N, int Q) {
  using M = StMap<HD>;
  constexpr int XS = HD + 4;
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 4;
  float* Xs = smem;                 // TILE x XS   x dt exp(a_last - a_cum)
  float* Bs = Xs + TILE * XS;       // TILE x NP   B rows
  float* ac = Bs + TILE * NP;       // Q           a_cum
  float* ws = ac + MAX_Q;           // Q           dt exp(a_last - a_cum)
  float* wtot = ws + MAX_Q;         // NW          scan scratch

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, g = h / (nh / G);
  const long long c0 = (long long)c * Q;
  const float a_h = A[h];
  const float* dtb = dt + ((long long)b * S + c0) * nh + h;

  float carry = 0.f;
  for (int base = 0; base < Q; base += NT) {
    const int t = base + tid;
    const float dtv = t < Q ? dtb[(long long)t * nh] : 0.f;
    const float v = block_scan(dtv * a_h, wtot) + carry;
    if (t < Q) {
      ac[t] = v;
      ws[t] = dtv;
    }
    carry += wtot[NW - 1];
    __syncthreads();
  }
  const float a_last = ac[Q - 1];
  float* acb = acum + ((long long)b * nh + h) * S + c0;
  for (int t = tid; t < Q; t += NT) {
    acb[t] = ac[t];
    ws[t] *= expf(a_last - ac[t]);
  }
  __syncthreads();

  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const T* xb = x + ((long long)b * S + c0) * xrow + (long long)h * HD;
  const T* Bb = Bm + ((long long)b * S + c0) * brow + (long long)g * N;
  const int ty = tid / 16, tx = tid % 16;
  float acc[M::DR][NJ][4];
#pragma unroll
  for (int i = 0; i < M::DR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int s0 = 0; s0 < Q; s0 += TILE) {
    const int rows = min(TILE, Q - s0);
    stage_rows(Xs, XS, xb + s0 * xrow, xrow, TILE, HD, rows,
               [&](int r) { return ws[s0 + r]; });
    stage_rows(Bs, NP, Bb + s0 * brow, brow, TILE, N, rows, One());
    __syncthreads();
    if (tid < M::ACTIVE) {
#pragma unroll 2
      for (int k = 0; k < rows; ++k) {
        float xv[M::DR];
        const float* xp = Xs + k * XS + ty * M::DR;
        if constexpr (M::DR == 4) {
          const float4 t = *reinterpret_cast<const float4*>(xp);
          xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
        } else {
#pragma unroll
          for (int i = 0; i < M::DR; ++i) xv[i] = xp[i];
        }
        float4 bv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = 4 * tx + 64 * j;
          bv[j] = n < N ? *reinterpret_cast<const float4*>(Bs + k * NP + n)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < M::DR; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            acc[i][j][0] = fmaf(xv[i], bv[j].x, acc[i][j][0]);
            acc[i][j][1] = fmaf(xv[i], bv[j].y, acc[i][j][1]);
            acc[i][j][2] = fmaf(xv[i], bv[j].z, acc[i][j][2]);
            acc[i][j][3] = fmaf(xv[i], bv[j].w, acc[i][j][3]);
          }
      }
    }
    __syncthreads();
  }
  // S_c stored as [n][d]: phase 3 reads h_in^T rows straight
  if (tid < M::ACTIVE) {
    float* sb = states + (((long long)b * nc + c) * nh + h) * HD * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * tx + 64 * j + e;
        if (n >= N) continue;
        float* dst = sb + (long long)n * HD + ty * M::DR;
        if constexpr (M::DR == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[0][j][e], acc[1][j][e], acc[2][j][e], acc[3][j][e]);
        } else {
#pragma unroll
          for (int i = 0; i < M::DR; ++i) dst[i] = acc[i][j][e];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// 2. state passing: one thread per state element of one (batch, head)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) ssd_scan_pass_kernel(
    float* __restrict__ states, const float* __restrict__ acum,
    const float* __restrict__ h0, float* __restrict__ hout, int S, int nh,
    int hd, int HDN, int Q) {
  const int e = blockIdx.x * NT + threadIdx.x;    // [n][d] in the scratch
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= HDN) return;
  const int nc = S / Q;
  const int n = e / hd, d = e - n * hd;
  const long long bh = (long long)b * nh + h;
  const long long io = bh * HDN + (long long)d * (HDN / hd) + n;  // [d][n]
  float v = h0 != nullptr ? h0[io] : 0.f;
  const float* ab = acum + bh * S + Q - 1;        // a_last of each chunk
  const long long cstride = (long long)nh * HDN;
  float* p = states + ((long long)b * nc * nh + h) * HDN + e;
  // PASS chunks' loads in flight at once, then their serial updates
  constexpr int PASS = 8;
  for (int c0 = 0; c0 < nc; c0 += PASS) {
    float sc[PASS], al[PASS];
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      const bool ok = c0 + i < nc;
      sc[i] = ok ? p[(c0 + i) * cstride] : 0.f;
      al[i] = ok ? ab[(long long)(c0 + i) * Q] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      if (c0 + i >= nc) break;
      p[(c0 + i) * cstride] = v;                // h_in of chunk c0 + i
      v = v * expf(al[i]) + sc[i];
    }
  }
  hout[io] = v;
}

// ---------------------------------------------------------------------------
// 3. C.B^T: one block per (chunk, group, query tile, source tile <= it),
// written once to a scratch tensor (b, nc, G, QP, QP) f32 as [s][t], QP =
// the chunk rounded up to 64; every head of the group reads it (from L2).
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulate: exact
// products of the bf16 inputs), f32 on the CUDA cores.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tile_pair(int p, int& qt, int& si) {
  qt = 0;
  while (p > qt) {
    p -= qt + 1;
    ++qt;
  }
  si = p;
}

size_t cb_smem(int dtype, int N) {
  if (dtype == 1) return (size_t)2 * TILE * (N + 8) * sizeof(__nv_bfloat16);
  return (size_t)2 * N * LT * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_cb_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    float* __restrict__ cb, int S, int G, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_cb[];
  const int nc = S / Q, QP = (Q + TILE - 1) / TILE * TILE;
  int qt, si;
  tile_pair(blockIdx.x, qt, si);
  const int b = blockIdx.y / nc, c = blockIdx.y % nc, g = blockIdx.z;
  const int t0 = qt * TILE, s0 = si * TILE;
  const long long c0 = (long long)c * Q, brow = (long long)G * N;
  const T* Cb = Cm + ((long long)b * S + c0 + t0) * brow + (long long)g * N;
  const T* Bb = Bm + ((long long)b * S + c0 + s0) * brow + (long long)g * N;
  float* out = cb + (((long long)b * nc + c) * G + g) * QP * QP +
               (long long)s0 * QP + t0;
  const int rows_q = min(TILE, Q - t0), rows_s = min(TILE, Q - s0);
  if constexpr (sizeof(T) == 2) {
    // rows of N bf16 padded by 16 bytes: ldmatrix's 8 rows hit 8 bank groups
    const int STR = N + 8;
    __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_cb);
    __nv_bfloat16* Bs = Cs + TILE * STR;
    const int cpr = N / 8;
    for (int e = threadIdx.x; e < TILE * cpr; e += NT) {
      const int r = e / cpr, col = (e - r * cpr) * 8;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Cs + r * STR + col) =
          r < rows_q ? *reinterpret_cast<const uint4*>(Cb + r * brow + col)
                     : z;
      *reinterpret_cast<uint4*>(Bs + r * STR + col) =
          r < rows_s ? *reinterpret_cast<const uint4*>(Bb + r * brow + col)
                     : z;
    }
    __syncthreads();
    // warp w: rows 16 (w % 4) .. + 15, columns 32 (w / 4) .. + 31
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const __nv_bfloat16* arow = Cs + (r0 + lane % 16) * STR + (lane / 16) * 8;
    const __nv_bfloat16* brw = Bs + (n0 + lane % 8) * STR;
    const int ks = N / 16;
    for (int kk = 0; kk < ks; ++kk) {
      uint32_t af[4];
      attn::ldsm_x4(af, arow + kk * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[2];
        attn::ldsm_x2(bf, brw + 8 * j * STR + kk * 16 + ((lane / 8) % 2) * 8);
        attn::mma_bf16(acc[j], af, bf[0], bf[1]);
      }
    }
    const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + gq + 8 * (e / 2), sc = n0 + 8 * j + 2 * t4 + e % 2;
        out[(long long)sc * QP + t] = acc[j][e];
      }
  } else {
    using MC = OutMap<TILE>;
    float* CsT = reinterpret_cast<float*>(smem_cb);
    float* BsT = CsT + N * LT;
    stage_transposed(CsT, LT, Cb, brow, N, rows_q);
    stage_transposed(BsT, LT, Bb, brow, N, rows_s);
    __syncthreads();
    const int cy = threadIdx.x / MC::CX, cx = threadIdx.x % MC::CX;
    float acc[MC::RPT][MC::CQ][4];
    tile_zero<TILE>(acc);
    tile_mac<TILE>(acc, CsT, LT, BsT, LT, N, cy, cx);
    static_assert(MC::RPT == 4 && MC::CQ == 1, "4 rows, 4 columns a thread");
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(out + (long long)(4 * cx + e) * QP +
                                 4 * cy) =
          make_float4(acc[0][0][e], acc[1][0][e], acc[2][0][e],
                      acc[3][0][e]);
  }
}

// ---------------------------------------------------------------------------
// 4. chunk outputs: one block per (chunk, query tile, heads of one group)
// ---------------------------------------------------------------------------
// Shared memory in floats: C^T (N x LT), h_in^T (N x (hd + 4)), P^T (64 x
// LT), x dt (64 x (hd + 4)), a_cum and dt of the chunk. Two blocks an SM
// up to hd 64.
struct OutSmem {
  int cs, hs, pt, xs, ac, dts, total;
  __host__ __device__ OutSmem(int hd, int N) {
    cs = 0;
    hs = cs + N * LT;
    pt = hs + N * (hd + 4);
    xs = pt + TILE * LT;
    ac = xs + TILE * (hd + 4);
    dts = ac + MAX_Q;
    total = dts + MAX_Q;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT, HD <= 64 ? 2 : 1) ssd_scan_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ states, const float* __restrict__ acum,
    const float* __restrict__ cb, T* __restrict__ y, int has_h0, int S,
    int nh, int G, int N, int Q, int hb) {
  using M = OutMap<HD>;
  constexpr int XS = HD + 4;
  constexpr int PE = TILE * TILE / NT;          // P^T entries a thread
  extern __shared__ __align__(16) float smem[];
  const int nqt = (Q + TILE - 1) / TILE, QP = nqt * TILE;
  const OutSmem L(HD, N);
  float* CsT = smem + L.cs;
  float* HsT = smem + L.hs;
  float* Pt = smem + L.pt;
  float* Xs = smem + L.xs;
  float* ac = smem + L.ac;
  float* dts = smem + L.dts;

  const int tid = threadIdx.x;
  const int nc = S / Q;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int qt = nqt - 1 - blockIdx.z;          // heaviest tiles first
  const int h_first = blockIdx.x * hb;
  const int g = h_first / (nh / G);
  const long long c0 = (long long)c * Q;
  const int t0 = qt * TILE, rows_q = min(TILE, Q - t0);
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const T* Cb = Cm + ((long long)b * S + c0) * brow + (long long)g * N;
  const float* cbg = cb + (((long long)b * nc + c) * G + g) * QP * QP + t0;

  stage_transposed(CsT, LT, Cb + t0 * brow, brow, N, rows_q);
  const int ty = tid / M::CX, tx = tid % M::CX;
  const bool has_state = c > 0 || has_h0;
  for (int hh = 0; hh < hb; ++hh) {
    const int h = h_first + hh;
    const float* acb = acum + ((long long)b * nh + h) * S + c0;
    const float* dtb = dt + ((long long)b * S + c0) * nh + h;
    for (int t = tid; t < Q; t += NT) {
      ac[t] = acb[t];
      dts[t] = dtb[(long long)t * nh];
    }
    if (has_state) {
      const float* hin =
          states + (((long long)b * nc + c) * nh + h) * (long long)HD * N;
      stage_rows(HsT, XS, hin, HD, N, HD, N, One());
    }
    __syncthreads();
    float acc[M::RPT][M::CQ][4];
    tile_zero<HD>(acc);
    if (has_state && tid < M::ACTIVE) {
      // carried-in state: exp(a_cum[t]) * C_t . h_in^T
      tile_mac<HD>(acc, CsT, LT, HsT, XS, N, ty, tx);
#pragma unroll
      for (int i = 0; i < M::RPT; ++i) {
        const int r = ty * M::RPT + i;
        const float dec = r < rows_q ? expf(ac[t0 + r]) : 0.f;
#pragma unroll
        for (int q = 0; q < M::CQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][q][e] *= dec;
      }
    }
    const T* xb = x + c0 * xrow + (long long)b * S * xrow + (long long)h * HD;
    for (int si = 0; si <= qt; ++si) {
      const int s0 = si * TILE, rows_s = min(TILE, Q - s0);
      // P^T[s][t]: the causal pairs of real rows only, exponent <= 0
      const float* cbt = cbg + (long long)s0 * QP;
      float v[PE];
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int e = tid + i * NT;
        v[i] = cbt[(long long)(e / TILE) * QP + e % TILE];
      }
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int e = tid + i * NT;
        const int s = e / TILE, t = e % TILE;
        const int ts = t0 + t, ss = s0 + s;
        Pt[s * LT + t] = (ss <= ts && t < rows_q)
                             ? v[i] * expf(ac[ts] - ac[ss])
                             : 0.f;
      }
      stage_rows(Xs, XS, xb + s0 * xrow, xrow, TILE, HD, rows_s,
                 [&](int r) { return dts[s0 + r]; });
      __syncthreads();
      if (tid < M::ACTIVE) tile_mac<HD>(acc, Pt, LT, Xs, XS, rows_s, ty, tx);
      __syncthreads();      // Pt, Xs reloaded; ac, h_in^T for the next head
    }
    if (tid < M::ACTIVE) {
      const float d_h = D[h];
      T* yb = y + c0 * xrow + (long long)b * S * xrow + (long long)h * HD;
#pragma unroll
      for (int i = 0; i < M::RPT; ++i) {
        const int r = ty * M::RPT + i;
        if (r >= rows_q) continue;
        const long long row = (long long)(t0 + r) * xrow;
#pragma unroll
        for (int q = 0; q < M::CQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * tx + 4 * M::CX * q + e;
            yb[row + d] =
                from_f32<T>(acc[i][q][e] + d_h * to_f32(xb[row + d]));
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4, bf16 at hd >= 32: the same chunk outputs on the tensor cores
// (mma.sync m16n8k16, f32 accumulate). C and x are bf16 already and enter
// as they are; the f32 operands, h_in and P' = C.B^T exp(a_t - a_s) dt_s
// (dt folded into P), enter as a bf16 pair hi + lo (lo = the rounding
// error of hi), two products each, so every term keeps ~16 bits: one
// bf16 rounding of h_in or P would shift y by up to 2^-9 of the sum of
// |terms|, which at the serve shapes exceeds the 3e-2 tolerance where the
// terms cancel. The state path stays f32. 8 warps: warp w owns rows
// 16 (w % 4) .. + 15 and half the head dim, columns (w / 4) hd / 2 ..
// + hd / 2 - 1. Shared tiles are bf16 rows padded by 16 bytes, so the 8
// row addresses of every ldmatrix hit 8 bank groups.
// ---------------------------------------------------------------------------
size_t out_mma_smem(int hd, int N) {
  return ((size_t)TILE * (N + 8) + 2 * (size_t)N * (hd + 8) +
          2 * (size_t)TILE * (TILE + 8) + (size_t)TILE * (hd + 8)) *
             sizeof(__nv_bfloat16) +
         2 * MAX_Q * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NT, HD <= 64 ? 2 : 1)
    ssd_scan_out_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ states, const float* __restrict__ acum,
    const float* __restrict__ cb, __nv_bfloat16* __restrict__ y,
    int has_h0, int S, int nh, int G, int N, int Q, int hb) {
  using bf16 = __nv_bfloat16;
  static_assert(HD >= 32, "two n-tiles of 8 columns a warp at least");
  constexpr int NTW = HD / 16;                  // n-tiles a warp
  constexpr int HS = HD + 8, PS = TILE + 8, XS = HD + 8;
  constexpr int PE = TILE * TILE / NT;          // P entries a thread
  const int CS = N + 8;
  extern __shared__ __align__(16) unsigned char smem_om[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_om);  // [t][n]  C
  bf16* Hh = Cs + TILE * CS;                    // [n][d]  h_in^T, hi
  bf16* Hl = Hh + N * HS;                       //         and lo
  bf16* Ph = Hl + N * HS;                       // [t][s]  P', hi
  bf16* Pl = Ph + TILE * PS;                    //         and lo
  bf16* Xs = Pl + TILE * PS;                    // [s][d]  x
  float* ac = reinterpret_cast<float*>(Xs + TILE * XS);
  float* dts = ac + MAX_Q;

  const int tid = threadIdx.x;
  const int nqt = (Q + TILE - 1) / TILE, QP = nqt * TILE;
  const int nc = S / Q;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int qt = nqt - 1 - blockIdx.z;          // heaviest tiles first
  const int h_first = blockIdx.x * hb;
  const int g = h_first / (nh / G);
  const long long c0 = (long long)c * Q;
  const int t0 = qt * TILE, rows_q = min(TILE, Q - t0);
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const bf16* Cb = Cm + ((long long)b * S + c0) * brow + (long long)g * N;
  const float* cbg = cb + (((long long)b * nc + c) * G + g) * QP * QP + t0;
  const int warp = tid / 32, lane = tid % 32, g4 = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (warp % 4), n0 = (warp / 4) * (HD / 2);

  stage_rows(Cs, CS, Cb + t0 * brow, brow, TILE, N, rows_q, One());
  const bool has_state = c > 0 || has_h0;
  for (int hh = 0; hh < hb; ++hh) {
    const int h = h_first + hh;
    const float* acb = acum + ((long long)b * nh + h) * S + c0;
    const float* dtb = dt + ((long long)b * S + c0) * nh + h;
    for (int t = tid; t < Q; t += NT) {
      ac[t] = acb[t];
      dts[t] = dtb[(long long)t * nh];
    }
    if (has_state) {
      const float* hin =
          states + (((long long)b * nc + c) * nh + h) * (long long)HD * N;
      for (int e = tid; e < N * HD / 4; e += NT) {
        const int n = e / (HD / 4), d = (e - n * (HD / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(hin + e * 4);
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_bf16(f[i], Hh[n * HS + d + i], Hl[n * HS + d + i]);
      }
    }
    __syncthreads();
    float acc[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (has_state) {
      // carried-in state: exp(a_cum[t]) * C_t . h_in^T
      for (int kk = 0; kk < N / 16; ++kk) {
        const bf16* a = Cs + r0 * CS + kk * 16;
        tile_mma<NTW, false, true, false, false>(
            acc, a, CS, 0, Hh + kk * 16 * HS + n0, HS, 0, 16);
        tile_mma<NTW, false, true, false, false>(
            acc, a, CS, 0, Hl + kk * 16 * HS + n0, HS, 0, 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + g4 + 8 * i;
        const float dec = r < rows_q ? expf(ac[t0 + r]) : 0.f;
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          acc[n][2 * i] *= dec;
          acc[n][2 * i + 1] *= dec;
        }
      }
    }
    const bf16* xb =
        x + c0 * xrow + (long long)b * S * xrow + (long long)h * HD;
    for (int si = 0; si <= qt; ++si) {
      const int s0 = si * TILE, rows_s = min(TILE, Q - s0);
      // P'[t][s]: the causal pairs of real rows only, exponent <= 0
      const float* cbt = cbg + (long long)s0 * QP;
      float v[PE];
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int e = tid + i * NT;
        v[i] = cbt[(long long)(e / TILE) * QP + e % TILE];
      }
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int e = tid + i * NT;
        const int sr = e / TILE, t = e % TILE;
        const int ts = t0 + t, ss = s0 + sr;
        const float pv = (ss <= ts && t < rows_q)
                             ? v[i] * expf(ac[ts] - ac[ss]) * dts[ss]
                             : 0.f;
        split_bf16(pv, Ph[t * PS + sr], Pl[t * PS + sr]);
      }
      stage_rows(Xs, XS, xb + s0 * xrow, xrow, TILE, HD, rows_s, One());
      __syncthreads();
#pragma unroll
      for (int kt = 0; kt < TILE / 16; ++kt) {
        const bf16* xk = Xs + kt * 16 * XS + n0;
        tile_mma<NTW, false, true, false, false>(
            acc, Ph + r0 * PS + kt * 16, PS, 0, xk, XS, 0, 16);
        tile_mma<NTW, false, true, false, false>(
            acc, Pl + r0 * PS + kt * 16, PS, 0, xk, XS, 0, 16);
      }
      __syncthreads();      // P, x reloaded; ac, h_in^T for the next head
    }
    const float d_h = D[h];
    bf16* yb = y + c0 * xrow + (long long)b * S * xrow + (long long)h * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g4 + 8 * i;
      if (r >= rows_q) continue;
      const long long row = (long long)(t0 + r) * xrow;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int d = n0 + 8 * n + 2 * t4;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + row + d));
        *reinterpret_cast<__nv_bfloat162*>(yb + row + d) =
            __floats2bfloat162_rn(acc[n][2 * i] + d_h * xv.x,
                                  acc[n][2 * i + 1] + d_h * xv.y);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* h0, void* y, void* hout, void* states,
                   void* acum, void* cb, int b, int S, int nh, int G, int N,
                   int Q, int hb, const int* grid, cudaStream_t stream) {
  auto k1 = ssd_scan_state_kernel<T, HD>;
  const size_t b1 = state_smem(HD, N);
  cudaError_t err = attn::allow_smem(k1, b1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(grid[0], grid[1], grid[2]), NT, b1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<float*>(states), static_cast<float*>(acum), S, nh, G, N,
      Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_pass_kernel<<<dim3(grid[3], grid[4], grid[5]), NT, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(acum),
      static_cast<const float*>(h0), static_cast<float*>(hout), S, nh, HD,
      HD * N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k3 = ssd_scan_cb_kernel<T>;
  const size_t b3 = cb_smem(sizeof(T) == 2, N);
  err = attn::allow_smem(k3, b3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(grid[6], grid[7], grid[8]), NT, b3, stream>>>(
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(cb), S, G, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid4(grid[9], grid[10], grid[11]);
  if constexpr (sizeof(T) == 2 && HD >= 32) {
    auto k4 = ssd_scan_out_mma_kernel<HD>;
    const size_t b4 = out_mma_smem(HD, N);
    err = attn::allow_smem(k4, b4);
    if (err != cudaSuccess) return err;
    k4<<<grid4, NT, b4, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(D),
        static_cast<const float*>(states), static_cast<const float*>(acum),
        static_cast<const float*>(cb), static_cast<__nv_bfloat16*>(y),
        h0 != nullptr, S, nh, G, N, Q, hb);
  } else {
    auto k4 = ssd_scan_out_kernel<T, HD>;
    const size_t b4 = OutSmem(HD, N).total * sizeof(float);
    err = attn::allow_smem(k4, b4);
    if (err != cudaSuccess) return err;
    k4<<<grid4, NT, b4, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const T*>(C), static_cast<const float*>(D),
        static_cast<const float*>(states), static_cast<const float*>(acum),
        static_cast<const float*>(cb), static_cast<T*>(y), h0 != nullptr,
        S, nh, G, N, Q, hb);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* D,
                     const void* h0, void* y, void* hout, void* states,
                     void* acum, void* cb, int b, int S, int nh, int G,
                     int N, int Q, int hb, const int* grid, cudaStream_t s) {
#define SSD_CASE(HD)                                                      \
  case HD:                                                                \
    return launch<T, HD>(x, dt, A, B, C, D, h0, y, hout, states, acum, cb, \
                         b, S, nh, G, N, Q, hb, grid, s);
  switch (hd) {
    SSD_CASE(8)
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef SSD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). x, y: (b, S, nh, hd);
// dt: (b, S, nh) f32; A, D: (nh,) f32; B, C: (b, S, G, N); h0 (may be
// null for zeros) and hout: (b, nh, hd, N) f32; scratch states (b, S /
// chunk, nh, N, hd) f32, acum (b, nh, S) f32 and cb (b, S / chunk, G, QP,
// QP) f32, QP the chunk rounded up to 64; all contiguous. hd in
// {8, 16, 32, 64, 128}; N a multiple of 16 up to 128; chunk 1..256 and S
// a multiple of it; hb heads a chunk-output block, dividing nh / G.
// grid: the (x, y, z) grids of the four launches, from the wrapper's
// `ssd_plan` (chunk states, state passing, C.B^T, chunk outputs), which
// also states how each kernel reads its block index. Four launches on
// `stream`. Returns a cudaError_t code.
extern "C" int ssd_scan(int dtype, int hd, const void* x, const void* dt,
                        const void* A, const void* B, const void* C,
                        const void* D, const void* h0, void* y, void* hout,
                        void* states, void* acum, void* cb, int b, int S,
                        int nh, int G, int N, int chunk, int hb,
                        const int* grid, void* stream) {
  if (chunk <= 0 || chunk > MAX_Q || S % chunk != 0 || G <= 0 ||
      nh % G != 0 || N <= 0 || N % 16 != 0 || N > MAX_N || hb <= 0 ||
      (nh / G) % hb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || S == 0 || nh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch<float>(hd, x, dt, A, B, C, D, h0, y, hout, states, acum,
                          cb, b, S, nh, G, N, chunk, hb, grid, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(hd, x, dt, A, B, C, D, h0, y, hout,
                                  states, acum, cb, b, S, nh, G, N, chunk,
                                  hb, grid, s);
  }
  return static_cast<int>(err);
}
