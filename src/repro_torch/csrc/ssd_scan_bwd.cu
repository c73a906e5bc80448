// ssd_scan_bwd: the gradient of the Mamba2 SSD chunked scan (ssd_scan.cu).
//
// The JAX train step takes it with jax.vjp of the jnp ssd_chunked
// (src/repro/models/ssd.py:34); the TPU kernel (src/repro/kernels/
// ssd_scan/kernel.py) has no backward. From the forward's inputs, what the
// forward kept (each chunk's carried-in state h_in, the within-chunk
// a_cum and C.B^T), dy and dh_final (or zeros) it returns dx, ddt, dA, dB,
// dC, dD and dh0. Per (batch, head) and chunk of Q rows, with xdt = x dt,
// w_s = exp(a_last - a_cum_s) and L[t, s] = exp(a_cum_t - a_cum_s) for
// s <= t (0 above):
//   (a) G_c = sum_t exp(a_cum_t) dy_t^T C_t (hd x N), the gradient of
//       h_in[c] through the chunk's own outputs.
//   (b) Reverse state passing from dh_final: dh_out[c] = dh, then
//       dh <- dh exp(a_last_c) + G_c; dh0 = dh at the end. The chunk decay's
//       own gradient, exp(a_last_c) <dh_out[c], h_in[c]>, joins d a_cum at
//       the chunk's last row.
//   (c) Per chunk, with dS = dh_out[c], dP[t, s] = dy_t . xdt_s,
//       dCB = dP o L and M = C.B^T o L:
//         d xdt_s = w_s dS B_s + sum_t M[t, s] dy_t,
//         dB_s   += w_s dS^T xdt_s + sum_t dCB[t, s] C_t  (this head's share),
//         dC_t   += exp(a_cum_t) h_in^T dy_t + sum_s dCB[t, s] B_s,
//         d a_cum_t = rowsum(dCB o CB)_t - colsum(dCB o CB)_t
//                     + dy_t . y_off_t - q_t,  q_t = w_t xdt_t . (dS B_t),
//       plus, at t = Q - 1, sum_t q_t and the decay's gradient. Then
//       da = the reverse cumulative sum of d a_cum within the chunk,
//       dx = d xdt dt + D dy, ddt = sum_d d xdt x + da A, and the chunk's
//       parts of dA (sum da dt) and dD (sum dy . x).
//   (d) Fixed-order sums: dB and dC over the heads of a group, dA and dD
//       over batch and chunks.
// x, B, C, dy, dx, dB and dC are f32 or bf16; everything else is f32, and
// every sum is taken in f32.
//
// What the forward kept: the forward kernel hands back its scratch (h_in
// per chunk after its passing phase, a_cum, C.B^T; `keep_scratch` in
// kernels/ssd_scan/kernel.py) rather than the backward recomputing its
// first three phases: they are computed anyway, and under remat only one
// layer's are alive at a time (~47 MB at mamba2-2.7b's training shape,
// b=2, S=2048).
//
// Design: four launches, deterministic and without atomics (each output
// element is written by one thread, each sum taken in one fixed order).
//   1. dstate, one block per (chunk, head): G_c, as the forward's
//      chunk-state phase computes S_c, into a scratch in the forward's
//      states layout ([n][d]).
//   2. reverse pass, one block per (batch, head): the block's threads hold
//      the hd x N state gradient in registers and walk the chunks from the
//      last; G_c is overwritten in place by dh_out[c], and a fixed-order
//      block sum gives the decay's gradient.
//   3. chunk gradients, one block per (chunk, head), the whole chunk: pass
//      A walks the source tiles s (64 rows), each against the query tiles
//      at or after it, for d xdt, dB and colsum; pass B walks the query
//      tiles t, each against the source tiles at or before it, for dC and
//      rowsum. Each recomputes dP = dy xdt^T on its tiles and reads C.B^T
//      from the forward. Then d a_cum's reverse cumulative sum (a block
//      scan), ddt, dx and the chunk's parts of dA and dD. dB and dC go out
//      per head into f32 scratch rows.
//   4. reduce: dB, dC over each group's heads in head order, dA, dD over
//      (batch, chunk) in order.
// Every product is f32 on the CUDA cores in both dtypes, on the forward's
// register tiles (ssd_common.cuh); bf16 inputs are widened on load. L is
// formed for s <= t only: above the diagonal the exponent is positive and
// could overflow to inf, and inf * 0 is NaN. A chunk is any size from 1 to
// 256; rows past it read as zero. Padded tail steps (dt = 0) pass the
// state gradient through unchanged and add nothing.

#include "attn_mma.cuh"
#include "ssd_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;
using namespace ssd;

constexpr int MAX_HD = 128;
constexpr int MAX_E = MAX_N * MAX_HD / NT;   // state elements a thread, pass 2

// Sum of v over the W lanes (a power of two, W-aligned) that share a row;
// every lane of the warp calls it, and the W lanes get the same bits.
template <int W>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, in one fixed order, returned to every thread;
// red holds NW floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = lanes_sum<32>(v);
  __syncthreads();                  // red is free from its previous use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}

// ---------------------------------------------------------------------------
// 1. dstate: G_c^T[n][d] = sum_t C_t[n] exp(a_cum_t) dy_t[d], one block per
// (chunk, head); rows n in two 64-row register tiles (the second where
// N > 64).
// ---------------------------------------------------------------------------
constexpr int CP = MAX_N + 4;    // row stride of a C tile, any N

size_t dstate_smem(int hd) {
  return ((size_t)TILE * CP + (size_t)TILE * (hd + 4) + MAX_Q) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_dstate_kernel(
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ acum, float* __restrict__ dstates, int S,
    int nh, int G, int N, int Q) {
  using M = OutMap<HD>;
  constexpr int XS = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                 // TILE x CP   C rows [t][n]
  float* Ys = Cs + TILE * CP;       // TILE x XS   exp(a_cum) dy rows [t][d]
  float* ac = Ys + TILE * XS;       // Q           a_cum

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, g = h / (nh / G);
  const long long c0 = (long long)c * Q;
  const float* acb = acum + ((long long)b * nh + h) * S + c0;
  for (int t = tid; t < Q; t += NT) ac[t] = acb[t];
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const T* yb = dy + ((long long)b * S + c0) * xrow + (long long)h * HD;
  const T* Cb = Cm + ((long long)b * S + c0) * brow + (long long)g * N;
  const int ty = tid / M::CX, tx = tid % M::CX;
  float acc[2][M::RPT][M::CQ][4];
  tile_zero<HD>(acc[0]);
  tile_zero<HD>(acc[1]);
  __syncthreads();
  for (int t0 = 0; t0 < Q; t0 += TILE) {
    const int rows = min(TILE, Q - t0);
    stage_rows(Cs, CP, Cb + t0 * brow, brow, TILE, N, rows, One());
    stage_rows(Ys, XS, yb + t0 * xrow, xrow, TILE, HD, rows,
               [&](int r) { return expf(ac[t0 + r]); });
    __syncthreads();
    if (tid < M::ACTIVE) {
      tile_mac<HD>(acc[0], Cs, CP, Ys, XS, rows, ty, tx);
      if (N > TILE) tile_mac<HD>(acc[1], Cs + TILE, CP, Ys, XS, rows, ty, tx);
    }
    __syncthreads();
  }
  if (tid >= M::ACTIVE) return;
  float* gb = dstates + (((long long)b * nc + c) * nh + h) * HD * N;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < M::RPT; ++i) {
      const int n = TILE * j + ty * M::RPT + i;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < M::CQ; ++q)
        *reinterpret_cast<float4*>(gb + (long long)n * HD + 4 * tx +
                                   4 * M::CX * q) =
            make_float4(acc[j][i][q][0], acc[j][i][q][1], acc[j][i][q][2],
                        acc[j][i][q][3]);
    }
}

// ---------------------------------------------------------------------------
// 2. reverse state passing: one block per (batch, head), MAX_E state
// elements a thread in registers ([n][d] order, as the scratch)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) ssd_scan_bwd_pass_kernel(
    float* __restrict__ dstates, const float* __restrict__ states,
    const float* __restrict__ acum, const float* __restrict__ dh_final,
    float* __restrict__ dh0, float* __restrict__ decay, int S, int nh,
    int hd, int N, int Q) {
  __shared__ float red[NW];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = S / Q, HDN = hd * N;
  const long long bh = (long long)b * nh + h;
  float dh[MAX_E];
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) {
    const int e = tid + i * NT, n = e / hd, d = e - n * hd;
    dh[i] = e < HDN && dh_final != nullptr
                ? dh_final[bh * HDN + (long long)d * N + n]
                : 0.f;
  }
  const long long cstride = (long long)nh * HDN;
  for (int c = nc - 1; c >= 0; --c) {
    const float ex = expf(acum[bh * S + (long long)c * Q + Q - 1]);
    const long long off = ((long long)b * nc + c) * cstride +
                          (long long)h * HDN;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_E; ++i) {
      const int e = tid + i * NT;
      if (e < HDN) {
        const float gc = dstates[off + e];
        dot = fmaf(dh[i], states[off + e], dot);
        dstates[off + e] = dh[i];          // dh_out[c]
        dh[i] = fmaf(dh[i], ex, gc);       // dh_in[c]
      }
    }
    dot = block_sum(dot, red);
    if (tid == 0) decay[bh * nc + c] = ex * dot;
  }
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) {
    const int e = tid + i * NT, n = e / hd, d = e - n * hd;
    if (e < HDN) dh0[bh * HDN + (long long)d * N + n] = dh[i];
  }
}

// ---------------------------------------------------------------------------
// 3. chunk gradients: one block per (chunk, head)
// ---------------------------------------------------------------------------
// Shared memory in floats. NP is N rounded up to 64 or 128: the register
// tiles of dB and dC are NP wide, their columns past N never stored.
// Pass A: B^T (NP x LT) and xdt^T (HD x LT) of the source tile, then
// either dS (NP x XS) and dS^T (HD x NS) for the state terms or, for each
// query tile, dy^T (HD x LT), dy (TILE x XS), C (TILE x NS) and M^T,
// dCB^T (TILE x LT each). Pass B over the same floats: dy^T of the query
// tile, h_in^T (HD x NS), then for each source tile xdt^T, B (TILE x NS)
// and dCB^T (TILE x LT). After them the chunk's row vectors.
template <int HD, int NP>
struct ChunkSmem {
  static constexpr int XS = HD + 4, NS = NP + 4;
  static constexpr int A_FIXED = NP * LT + HD * LT;
  static constexpr int A_STATE = NP * XS + HD * NS;
  static constexpr int A_LOOP = HD * LT + TILE * XS + TILE * NS +
                                2 * TILE * LT;
  static constexpr int A =
      A_FIXED + (A_STATE > A_LOOP ? A_STATE : A_LOOP);
  static constexpr int B = 2 * HD * LT + HD * NS + TILE * NS + TILE * LT;
  static constexpr int ROWS = A > B ? A : B;
  static constexpr int TOTAL = ROWS + 5 * MAX_Q + NW;
};

template <typename T, int HD, int NP>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ states, const float* __restrict__ acum,
    const float* __restrict__ cb, const T* __restrict__ dy,
    const float* __restrict__ dstates, const float* __restrict__ decay,
    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ pA, float* __restrict__ pD,
    int S, int nh, int G, int N, int Q) {
  using L = ChunkSmem<HD, NP>;
  using MX = OutMap<HD>;      // TILE x HD tiles: d xdt
  using MN = OutMap<NP>;      // TILE x NP tiles: dB, dC
  using MP = OutMap<TILE>;    // the 64 x 64 score tiles
  static_assert(MP::RPT == 4 && MP::CQ == 1, "4 x 4 score entries a thread");
  constexpr int XS = L::XS, NS = L::NS;
  extern __shared__ __align__(16) float smem[];
  float* ac = smem + L::ROWS;   // a_cum of the chunk
  float* dts = ac + MAX_Q;      // dt
  float* dac = dts + MAX_Q;     // d a_cum, gathered row by row
  float* qv = dac + MAX_Q;      // q_t
  float* xg = qv + MAX_Q;       // sum_d d xdt x
  float* red = xg + MAX_Q;      // NW floats

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, g = h / (nh / G);
  const int QP = (Q + TILE - 1) / TILE * TILE;
  const long long c0 = (long long)c * Q;
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const long long xoff = ((long long)b * S + c0) * xrow + (long long)h * HD;
  const long long boff = ((long long)b * S + c0) * brow + (long long)g * N;
  const T* xb = x + xoff;
  const T* yb = dy + xoff;
  T* dxb = dx + xoff;
  const T* Bb = Bm + boff;
  const T* Cb = Cm + boff;
  const long long soff = (((long long)b * nc + c) * nh + h) * HD * N;
  const float* hin = states + soff;         // h_in[c], [n][d]
  const float* dSg = dstates + soff;        // dh_out[c], [n][d]
  const float* cbg = cb + (((long long)b * nc + c) * G + g) * QP * QP;
  const long long hrow = (long long)nh * N;  // a row of dBh / dCh
  float* dBb = dBh + ((long long)b * S + c0) * hrow + (long long)h * N;
  float* dCb = dCh + ((long long)b * S + c0) * hrow + (long long)h * N;
  const float a_h = A[h], d_h = D[h];
  const float* acb = acum + ((long long)b * nh + h) * S + c0;
  const float* dtb = dt + ((long long)b * S + c0) * nh + h;
  for (int t = tid; t < Q; t += NT) {
    ac[t] = acb[t];
    dts[t] = dtb[(long long)t * nh];
  }
  __syncthreads();
  const float a_last = ac[Q - 1];
  const int xy = tid / MX::CX, xx = tid % MX::CX;
  const int ny = tid / MN::CX, nx = tid % MN::CX;
  const int py = tid / MP::CX, px = tid % MP::CX;
  float dyx = 0.f;            // this thread's part of sum dy . x

  // ---- pass A: the rows s of each source tile ------------------------------
  for (int s0 = 0; s0 < Q; s0 += TILE) {
    const int rows_s = min(TILE, Q - s0);
    float* BT = smem;                 // [n][s]
    float* XT = BT + NP * LT;         // [d][s]  xdt
    float* U = XT + HD * LT;
    float* dSs = U;                   // [n][d]
    float* dST = U + NP * XS;         // [d][n]
    stage_transposed(BT, LT, Bb + s0 * brow, brow, N, rows_s);
    stage_transposed(XT, LT, xb + s0 * xrow, xrow, HD, rows_s,
                     [&](int r) { return dts[s0 + r]; });
    stage_rows(dSs, XS, dSg, HD, N, HD, N, One());
    for (int n0 = 0; n0 < N; n0 += TILE)
      stage_transposed(dST + n0, NS, dSg + n0 * HD, HD, HD,
                       min(TILE, N - n0));
    __syncthreads();

    // the state terms: d xdt_s = w_s dS B_s, dB_s = w_s dS^T xdt_s, q_s
    float ax[MX::RPT][MX::CQ][4], an[MN::RPT][MN::CQ][4];
    tile_zero<HD>(ax);
    tile_zero<NP>(an);
    if (tid < MX::ACTIVE) tile_mac<HD>(ax, BT, LT, dSs, XS, N, xy, xx);
    if (tid < MN::ACTIVE) tile_mac<NP>(an, XT, LT, dST, NS, HD, ny, nx);
    float qp[MX::RPT];
#pragma unroll
    for (int i = 0; i < MX::RPT; ++i) {
      const int r = xy * MX::RPT + i;
      const bool live = tid < MX::ACTIVE && r < rows_s;
      const float w = live ? expf(a_last - ac[s0 + r]) : 0.f;
      qp[i] = 0.f;
#pragma unroll
      for (int q = 0; q < MX::CQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ax[i][q][e] *= w;
          if (live)
            qp[i] = fmaf(ax[i][q][e],
                         XT[(4 * xx + 4 * MX::CX * q + e) * LT + r], qp[i]);
        }
      qp[i] = lanes_sum<MX::CX>(qp[i]);
      if (live && xx == 0) {
        qv[s0 + r] = qp[i];
        dac[s0 + r] = -qp[i];
      }
    }
#pragma unroll
    for (int i = 0; i < MN::RPT; ++i) {
      const int r = ny * MN::RPT + i;
      const float w = r < rows_s ? expf(a_last - ac[s0 + r]) : 0.f;
#pragma unroll
      for (int q = 0; q < MN::CQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) an[i][q][e] *= w;
    }
    __syncthreads();          // dS and dS^T done: their floats take the tiles

    // the query tiles at or after this one
    float* YT = U;                    // [d][t]
    float* Ys = YT + HD * LT;         // [t][d]
    float* Cs = Ys + TILE * XS;       // [t][n]
    float* Mt = Cs + TILE * NS;       // [t][s]  M
    float* Dt = Mt + TILE * LT;       // [t][s]  dCB
    float cr[MP::RPT] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = s0; t0 < Q; t0 += TILE) {
      const int rows_t = min(TILE, Q - t0);
      stage_transposed(YT, LT, yb + t0 * xrow, xrow, HD, rows_t);
      stage_rows(Ys, XS, yb + t0 * xrow, xrow, TILE, HD, rows_t, One());
      stage_rows(Cs, NS, Cb + t0 * brow, brow, TILE, N, rows_t, One());
      __syncthreads();
      float p[MP::RPT][MP::CQ][4];        // dP^T[s][t]
      tile_zero<TILE>(p);
      tile_mac<TILE>(p, XT, LT, YT, LT, HD, py, px);
#pragma unroll
      for (int i = 0; i < MP::RPT; ++i) {
        const int s = py * MP::RPT + i, sg = s0 + s;
        const float4 cv4 = *reinterpret_cast<const float4*>(
            cbg + (long long)sg * QP + t0 + 4 * px);
        const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * px + e, tg = t0 + t;
          const bool ok = sg <= tg && tg < Q;
          const float l = ok ? expf(ac[tg] - ac[sg]) : 0.f;
          const float cbv = ok ? cv[e] : 0.f;
          const float dcb = ok ? p[i][0][e] * l : 0.f;
          cr[i] = fmaf(dcb, cbv, cr[i]);
          Mt[t * LT + s] = cbv * l;
          Dt[t * LT + s] = dcb;
        }
      }
      __syncthreads();
      if (tid < MX::ACTIVE) tile_mac<HD>(ax, Mt, LT, Ys, XS, rows_t, xy, xx);
      if (tid < MN::ACTIVE) tile_mac<NP>(an, Dt, LT, Cs, NS, rows_t, ny, nx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < MP::RPT; ++i) {
      const float v = lanes_sum<MP::CX>(cr[i]);
      const int s = py * MP::RPT + i;
      if (px == 0 && s < rows_s) dac[s0 + s] -= v;
    }

    // dx, sum_d d xdt x and this tile's rows of dB
#pragma unroll
    for (int i = 0; i < MX::RPT; ++i) {
      const int r = xy * MX::RPT + i;
      const bool live = tid < MX::ACTIVE && r < rows_s;
      float xgp = 0.f;
      if (live) {
        const long long row = (long long)(s0 + r) * xrow;
        const float dtv = dts[s0 + r];
#pragma unroll
        for (int q = 0; q < MX::CQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * xx + 4 * MX::CX * q + e;
            const float xv = to_f32(xb[row + d]), yv = to_f32(yb[row + d]);
            const float gv = ax[i][q][e];
            dxb[row + d] = from_f32<T>(fmaf(gv, dtv, d_h * yv));
            xgp = fmaf(gv, xv, xgp);
            dyx = fmaf(yv, xv, dyx);
          }
      }
      xgp = lanes_sum<MX::CX>(xgp);
      if (live && xx == 0) xg[s0 + r] = xgp;
    }
    if (tid < MN::ACTIVE) {
#pragma unroll
      for (int i = 0; i < MN::RPT; ++i) {
        const int r = ny * MN::RPT + i;
        if (r >= rows_s) continue;
#pragma unroll
        for (int q = 0; q < MN::CQ; ++q) {
          const int n = 4 * nx + 4 * MN::CX * q;
          if (n < N)
            *reinterpret_cast<float4*>(dBb + (long long)(s0 + r) * hrow +
                                       n) =
                make_float4(an[i][q][0], an[i][q][1], an[i][q][2],
                            an[i][q][3]);
        }
      }
    }
  }
  __syncthreads();            // pass A's floats are free

  // ---- pass B: the rows t of each query tile -------------------------------
  {
    float* YT = smem;                 // [d][t]
    float* HT = YT + HD * LT;         // [d][n]  h_in^T
    float* XT = HT + HD * NS;         // [d][s]  xdt
    float* Bs = XT + HD * LT;         // [s][n]
    float* Pt = Bs + TILE * NS;       // [s][t]  dCB
    for (int n0 = 0; n0 < N; n0 += TILE)
      stage_transposed(HT + n0, NS, hin + n0 * HD, HD, HD,
                       min(TILE, N - n0));
    for (int t0 = 0; t0 < Q; t0 += TILE) {
      const int rows_t = min(TILE, Q - t0);
      stage_transposed(YT, LT, yb + t0 * xrow, xrow, HD, rows_t);
      __syncthreads();
      // the state term exp(a_cum_t) h_in^T dy_t, and dy_t . y_off_t
      float an[MN::RPT][MN::CQ][4];
      tile_zero<NP>(an);
      if (tid < MN::ACTIVE) tile_mac<NP>(an, YT, LT, HT, NS, HD, ny, nx);
#pragma unroll
      for (int i = 0; i < MN::RPT; ++i) {
        const int r = ny * MN::RPT + i;
        const bool live = tid < MN::ACTIVE && r < rows_t;
        const float et = live ? expf(ac[t0 + r]) : 0.f;
        float yo = 0.f;
#pragma unroll
        for (int q = 0; q < MN::CQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            an[i][q][e] *= et;
            const int n = 4 * nx + 4 * MN::CX * q + e;
            if (live && n < N)
              yo = fmaf(an[i][q][e], to_f32(Cb[(t0 + r) * brow + n]), yo);
          }
        yo = lanes_sum<MN::CX>(yo);
        if (live && nx == 0) dac[t0 + r] += yo;
      }
      // the source tiles at or before this one
      float rr[MP::RPT] = {0.f, 0.f, 0.f, 0.f};
      for (int s0 = 0; s0 <= t0; s0 += TILE) {
        const int rows_s = min(TILE, Q - s0);
        stage_transposed(XT, LT, xb + s0 * xrow, xrow, HD, rows_s,
                         [&](int r) { return dts[s0 + r]; });
        stage_rows(Bs, NS, Bb + s0 * brow, brow, TILE, N, rows_s, One());
        __syncthreads();
        float p[MP::RPT][MP::CQ][4];      // dP[t][s]
        tile_zero<TILE>(p);
        tile_mac<TILE>(p, YT, LT, XT, LT, HD, py, px);
#pragma unroll
        for (int i = 0; i < MP::RPT; ++i) {
          const int t = py * MP::RPT + i, tg = t0 + t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 4 * px + e, sg = s0 + s;
            const bool ok = sg <= tg && tg < Q;
            const float cbv = ok ? cbg[(long long)sg * QP + tg] : 0.f;
            const float dcb = ok ? p[i][0][e] * expf(ac[tg] - ac[sg]) : 0.f;
            rr[i] = fmaf(dcb, cbv, rr[i]);
            Pt[s * LT + t] = dcb;
          }
        }
        __syncthreads();
        if (tid < MN::ACTIVE) tile_mac<NP>(an, Pt, LT, Bs, NS, rows_s, ny, nx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < MP::RPT; ++i) {
        const float v = lanes_sum<MP::CX>(rr[i]);
        const int t = py * MP::RPT + i;
        if (px == 0 && t < rows_t) dac[t0 + t] += v;
      }
      if (tid < MN::ACTIVE) {
#pragma unroll
        for (int i = 0; i < MN::RPT; ++i) {
          const int r = ny * MN::RPT + i;
          if (r >= rows_t) continue;
#pragma unroll
          for (int q = 0; q < MN::CQ; ++q) {
            const int n = 4 * nx + 4 * MN::CX * q;
            if (n < N)
              *reinterpret_cast<float4*>(dCb + (long long)(t0 + r) * hrow +
                                         n) =
                  make_float4(an[i][q][0], an[i][q][1], an[i][q][2],
                              an[i][q][3]);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- d a_cum -> da (reverse cumulative sum), ddt, dA and dD parts -------
  if (tid == 0) {
    float qs = 0.f;
    for (int t = 0; t < Q; ++t) qs += qv[t];
    dac[Q - 1] += qs + decay[((long long)b * nh + h) * nc + c];
  }
  __syncthreads();
  float carry = 0.f, dap = 0.f;
  for (int base = 0; base < Q; base += NT) {
    const int j = base + tid, t = Q - 1 - j;
    const float da = block_scan(j < Q ? dac[t] : 0.f, red) + carry;
    if (j < Q) {
      ddt[((long long)b * S + c0 + t) * nh + h] = fmaf(da, a_h, xg[t]);
      dap = fmaf(da, dts[t], dap);
    }
    carry += red[NW - 1];
    __syncthreads();
  }
  const float sa = block_sum(dap, red);
  const float sd = block_sum(dyx, red);
  if (tid == 0) {
    pA[((long long)b * nc + c) * nh + h] = sa;
    pD[((long long)b * nc + c) * nh + h] = sd;
  }
}

// ---------------------------------------------------------------------------
// 4. reduce: dB, dC (b S G N) over each group's heads in head order; the
// first nh threads also sum dA, dD over the (batch, chunk) parts in order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_reduce_kernel(
    const float* __restrict__ dBh, const float* __restrict__ dCh,
    const float* __restrict__ pA, const float* __restrict__ pD,
    T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
    float* __restrict__ dD, long long rows, int nh, int G, int N, int parts) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  const int rep = nh / G;
  const long long gn = (long long)G * N;
  if (i < rows * gn) {
    const long long r = i / gn;
    const int k = (int)(i - r * gn), g = k / N, n = k - g * N;
    const long long base = (r * nh + (long long)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < rep; ++j) {
      sb += dBh[base + (long long)j * N];
      sc += dCh[base + (long long)j * N];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  }
  if (i < nh) {
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < parts; ++k) {
      sa += pA[(long long)k * nh + i];
      sd += pD[(long long)k * nh + i];
    }
    dA[i] = sa;
    dD[i] = sd;
  }
}

struct BwdArgs {
  const void *x, *dt, *A, *B, *C, *D, *states, *acum, *cb, *dy, *dh_final;
  void *dx, *ddt, *dA, *dB, *dC, *dD, *dh0;
  void *dstates, *decay, *dBh, *dCh, *pA, *pD;
  int b, S, nh, G, N, Q;
};

template <typename T, int HD, int NP>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int nc = a.S / a.Q;
  auto k1 = ssd_scan_bwd_dstate_kernel<T, HD>;
  const size_t b1 = dstate_smem(HD);
  cudaError_t err = attn::allow_smem(k1, b1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc, a.nh, a.b), NT, b1, stream>>>(
      static_cast<const T*>(a.C), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.acum), static_cast<float*>(a.dstates),
      a.S, a.nh, a.G, a.N, a.Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_pass_kernel<<<dim3(a.nh, a.b), NT, 0, stream>>>(
      static_cast<float*>(a.dstates), static_cast<const float*>(a.states),
      static_cast<const float*>(a.acum),
      static_cast<const float*>(a.dh_final), static_cast<float*>(a.dh0),
      static_cast<float*>(a.decay), a.S, a.nh, HD, a.N, a.Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k3 = ssd_scan_bwd_chunk_kernel<T, HD, NP>;
  const size_t b3 = ChunkSmem<HD, NP>::TOTAL * sizeof(float);
  err = attn::allow_smem(k3, b3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nc, a.nh, a.b), NT, b3, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.B),
      static_cast<const T*>(a.C), static_cast<const float*>(a.D),
      static_cast<const float*>(a.states), static_cast<const float*>(a.acum),
      static_cast<const float*>(a.cb), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.dstates),
      static_cast<const float*>(a.decay), static_cast<T*>(a.dx),
      static_cast<float*>(a.ddt), static_cast<float*>(a.dBh),
      static_cast<float*>(a.dCh), static_cast<float*>(a.pA),
      static_cast<float*>(a.pD), a.S, a.nh, a.G, a.N, a.Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.b * a.S;
  const long long work = rows * a.G * a.N > a.nh ? rows * a.G * a.N : a.nh;
  ssd_scan_bwd_reduce_kernel<T><<<(unsigned)((work + NT - 1) / NT), NT, 0,
                             stream>>>(
      static_cast<const float*>(a.dBh), static_cast<const float*>(a.dCh),
      static_cast<const float*>(a.pA), static_cast<const float*>(a.pD),
      static_cast<T*>(a.dB), static_cast<T*>(a.dC),
      static_cast<float*>(a.dA), static_cast<float*>(a.dD), rows, a.nh, a.G,
      a.N, a.b * nc);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_np(const BwdArgs& a, cudaStream_t s) {
  return a.N <= TILE ? launch_bwd<T, HD, TILE>(a, s)
                     : launch_bwd<T, HD, 2 * TILE>(a, s);
}

template <typename T>
cudaError_t dispatch_bwd(int hd, const BwdArgs& a, cudaStream_t s) {
  switch (hd) {
    case 8: return dispatch_np<T, 8>(a, s);
    case 16: return dispatch_np<T, 16>(a, s);
    case 32: return dispatch_np<T, 32>(a, s);
    case 64: return dispatch_np<T, 64>(a, s);
    case 128: return dispatch_np<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB and dC). The
// forward's inputs as `ssd_scan` takes them: x (b, S, nh, hd); dt (b, S,
// nh) f32; A, D (nh,) f32; B, C (b, S, G, N). What the forward kept:
// states (b, S / chunk, nh, N, hd) f32 holding each chunk's h_in, acum
// (b, nh, S) f32, cb (b, S / chunk, G, QP, QP) f32. dy like x; dh_final
// (b, nh, hd, N) f32 or null for zeros. Out: dx like x, ddt like dt, dA
// and dD (nh,) f32, dB and dC like B, dh0 (b, nh, hd, N) f32. Scratch:
// dstates like states, decay (b, nh, S / chunk), dBh and dCh (b, S, nh,
// N), pA and pD (b, S / chunk, nh), all f32. All contiguous. hd in {8, 16,
// 32, 64, 128}; N a multiple of 16 up to 128; chunk 1..256 and S a
// multiple of it. Four launches on `stream`. Returns a cudaError_t code.
extern "C" int ssd_scan_bwd(int dtype, int hd, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            const void* D, const void* states,
                            const void* acum, const void* cb, const void* dy,
                            const void* dh_final, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* dD, void* dh0,
                            void* dstates, void* decay, void* dBh, void* dCh,
                            void* pA, void* pD, int b, int S, int nh, int G,
                            int N, int chunk, void* stream) {
  if (chunk <= 0 || chunk > MAX_Q || S % chunk != 0 || G <= 0 ||
      nh % G != 0 || N <= 0 || N % 16 != 0 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || S == 0 || nh == 0) return 0;
  const BwdArgs a{x,  dt,  A,   B,  C,  D,   states,  acum,  cb,
                  dy, dh_final, dx, ddt, dA, dB, dC, dD, dh0,
                  dstates, decay, dBh, dCh, pA, pD, b, S, nh, G, N, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_bwd<float>(hd, a, s);
  } else if (dtype == 1) {
    err = dispatch_bwd<__nv_bfloat16>(hd, a, s);
  }
  return static_cast<int>(err);
}
