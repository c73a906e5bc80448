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
// x, B, C, dy, dx, dB and dC are f32 or bf16; everything else is f32.
//
// Bound on the H100 at mamba2-2.7b's training shape (b 2, S 2048 in 8
// chunks of 256, 80 heads of hd 64, 1 group, N 128; `ssd_bwd_flops_bytes`
// in chip_smoke.py): ~32.5 GFLOP (per chunk and head the state gradient
// and the three state terms, 8 Q hd N, and dP and M^T dy over the causal
// pairs, 4 P hd; per chunk and group the heads' summed dCB times C and B,
// 4 P N) against ~133 MB of inputs and outputs in bf16 (~265 MB in f32).
// f32 is bound by operations (0.49 ms at 67 TF/s), bf16 by bytes (0.04
// ms at 3.35 TB/s).
//
// What the forward kept: the forward kernel hands back its scratch (h_in
// per chunk after its passing phase, a_cum, C.B^T; `keep_scratch` in
// kernels/ssd_scan/kernel.py) rather than the backward recomputing its
// first three phases: they are computed anyway, and under remat only one
// layer's are alive at a time (~47 MB at the training shape).
//
// Design: seven launches, deterministic and without atomics (each output
// element is written by one thread, each sum taken in one fixed order).
// The grids and the scratch shapes are `ssd_bwd_plan` in
// kernels/ssd_scan/kernel.py. What a group shares runs by head blocks: hb
// heads of one group (the most, up to 8, that divide the group's heads
// and leave a block for every SM), so the products with C and B run once
// per head block, not once per head; what is a head's own runs by heads,
// for more blocks to hide each other's loads. In launches 4 and 5 the
// 64-row tile is the fastest grid index, so the blocks that read one
// head's dS or h_in, and one chunk's C.B^T, run together and find it in
// L2 (the scratch of a training call exceeds L2); launch 3's blocks, long
// and uneven, run the heaviest tiles first.
//   1. dstate, one block per (chunk, head): G_c^T = C^T (exp(a_cum) dy)
//      over the chunk's 64-row tiles, into a scratch in the forward's
//      states layout ([n][d]).
//   2. reverse pass, one thread per state element of a (batch, head), as
//      the forward's passing kernel: eight chunks' loads in flight; dh_out
//      [c] is written where launches 3 and 4 read dS (in bf16 as its hi
//      and lo planes, with h_in's for launch 5, so no later launch splits
//      them); each block writes its part of <dh_out[c], h_in[c]> (summed
//      over its 256 elements in one order), and launch 6 sums the parts in
//      block order.
//   3. source side, one block per (head block, chunk, 64-row source tile
//      s), the heaviest tiles first: each head's state term of dB_s (w_s
//      dt_s x_s dS); then for each query tile t >= s and each head, with
//      x_s and dy_t arriving by cp.async one (tile, head) ahead: dP^T =
//      (x_s . dy_t^T) dt_s, the only time dP is formed; dCB^T = dP^T o L^T
//      for s <= t, its parts of d a_cum (colsum over t for the rows s,
//      rowsum over this tile's s for the rows t), and the heads' sum of
//      dCB^T in registers. That sum goes to shared memory and to a scratch
//      tile (launch 5 reads it), and dB_s += dCB^T C_t runs once for the
//      head block. dB leaves as one f32 row part per head block.
//   4. head side, one block per (head, chunk, source tile s): d xdt_s =
//      w_s B_s dS^T and q_s, then d xdt_s += M^T dy_t over the query tiles
//      t >= s (M^T formed in shared memory from C.B^T, the next tile's
//      dy_t and C.B^T loaded during this one's product), dx, sum_d d xdt x
//      and dy . x.
//   5. query side, one block per (head block, chunk, query tile t): per
//      head the state term exp(a_cum_t) dy_t h_in and its dot with C_t
//      (y_off), summed over the heads; then dC_t += dCB B_s over the
//      source tiles s <= t from launch 3's scratch tiles, each item's
//      operands by cp.async one item ahead. dC leaves as one f32 row part
//      per head block.
//   6. scan, one block per (head, chunk): d a_cum from launch 3-5's row
//      vectors in one order, the decay's gradient, the reverse cumulative
//      sum (a block scan), ddt and the chunk's parts of dA, dD.
//   7. reduce: dB and dC over each group's head blocks in order, dA and
//      dD over (batch, chunk) in order.
// dP is formed once per (source tile, query tile, head): keeping it costs
// one summed 64 x 64 tile per tile pair and head block (launch 3 writes
// it, launch 5 reads it from L2), where forming it again in launch 5
// would rerun hb products a pair.
//
// Out of device memory: no per-head dB or dC row (the first port wrote
// (b, S, nh, N) f32 twice, ~670 MB of traffic at the training shape for
// 1 MB of outputs); no per-head dCB; M and L are formed in registers and
// shared memory. What goes out besides the outputs: G_c / dh_out (the
// states' size; in bf16 also the hi / lo planes of dh_out and h_in, each
// the states' size), one summed dCB tile per tile pair and head block,
// the dB / dC parts (nh / hb rows of N per row of the sequence), and per
// (chunk, head) a few row vectors.
//
// Precision. Every product of launches 1 and 3-5 runs on the tile of
// ssd_common.cuh (`tile_mma`): in bf16 on the tensor cores (mma.sync
// m16n8k16, f32 accumulate), in f32 on the CUDA cores (TF32 would break
// the 5e-5 tolerance). In bf16, dy, x, B and C are bf16 already and enter
// exactly; a row scale that does not fall on the contracted index (dt_s
// on dP^T, w_s dt_s and w_s on the state terms, exp(a_cum_t) on dC_t's
// state term) is applied to the f32 accumulator after the product; an f32
// operand on the contracted index (dS, h_in, M^T, the summed dCB,
// exp(a_cum) dy in launch 1) enters as a bf16 pair hi + lo, two products.
// No product has two f32 operands. Launches 2, 6 and 7 and every
// elementwise step are f32. L = 2^(log2(e) (a_cum_t - a_cum_s)) on the
// special-function unit (ex2.approx, ~2 ulp), formed for s <= t only:
// above the diagonal the exponent is positive and could overflow to inf,
// and inf * 0 is NaN. A chunk is any size from 1 to 256; rows past it read
// as zero. Padded tail steps (dt = 0) pass the state gradient through
// unchanged and add nothing. hd 8 pads the contracted head dim to 16 with
// zeros.

#include "attn_mma.cuh"
#include "ssd_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;
using namespace ssd;

constexpr int PASS = 8;      // chunks in flight in the reverse pass
constexpr float LOG2E = 1.4426950408889634f;

// Sum of v over the W lanes (a power of two, W-aligned) that share a row;
// every lane of the warp calls it, and the W lanes get the same bits.
template <int W>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Column sums of an accumulator tile's 8 row groups: v[m] is this lane's
// part of its m-th column (n-tile m / 2, column m % 2); three butterfly
// rounds (lanes ^ 16, ^ 8, ^ 4) leave in every lane the sum, in one fixed
// order, of its column lane / 4.
__device__ __forceinline__ float cols_sum8(const float (&v)[8]) {
  const int g = threadIdx.x % 32 / 4;
  float a[4], b[2];
  const bool hi2 = g & 4, hi1 = g & 2, hi0 = g & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi2 ? v[i] : v[i + 4];
    a[i] = (hi2 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi1 ? a[i] : a[i + 2];
    b[i] = (hi1 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = hi0 ? b[0] : b[1];
  return (hi0 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
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

// The 8 warps over an R x W output of 16 x 8 NTW warp tiles: STRIPS rows
// of 16, PARTS column parts; warp w < WARPS owns rows 16 (w % STRIPS) and
// columns 8 NTW (w / STRIPS) onwards, the others idle.
template <int R, int W>
struct WMap {
  static constexpr int STRIPS = R / 16;
  static constexpr int PARTS = W / 8 < NW / STRIPS ? W / 8 : NW / STRIPS;
  static constexpr int NTW = W / 8 / PARTS;
  static constexpr int WARPS = STRIPS * PARTS;
};

template <int NTW>
__device__ __forceinline__ void acc_zero(float (&a)[NTW][4]) {
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// Shared operand tiles of T: rows padded by 16 bytes; SPL copies (hi, lo)
// for a split operand in bf16.
template <typename T, int HD, int NP>
struct Tiles {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int SPL = sizeof(T) == 2 ? 2 : 1;
  static constexpr int HK = HD < 16 ? 16 : HD;   // contracted head dim
  static constexpr int XL = HK + PAD;            // [rows][d]
  static constexpr int PL = TILE + PAD;          // [s][t]
  static constexpr int NL = NP + PAD;            // [rows][n]
};

// cp.async of ROWS rows of `cols` T (a multiple of 16 bytes) at a global
// row stride into a shared tile (row stride ld): rows at or past `valid`
// and columns cols .. colsP - 1 zero-filled. The caller commits.
template <int ROWS, typename T>
__device__ __forceinline__ void async_tile(T* dst, int ld, const T* src,
                                           long long src_row, int valid,
                                           int cols, int colsP) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = colsP / V;
  for (int i = threadIdx.x; i < ROWS * cpr; i += NT) {
    const int r = i / cpr, col = (i - r * cpr) * V;
    if (r < valid && col < cols)
      attn::cp_async16(dst + r * ld + col, src + r * src_row + col);
    else
      attn::zero16(dst + r * ld + col);
  }
}

// ---------------------------------------------------------------------------
// 1. dstate: G_c^T[n][d] = sum_t C_t[n] exp(a_cum_t) dy_t[d], one block per
// (chunk, head); A = C^T (stored [t][n]), B = exp(a_cum) dy (split).
// ---------------------------------------------------------------------------
template <typename T, int HD, int NP>
size_t dstate_smem() {
  using K = Tiles<T, HD, NP>;
  return (size_t)(TILE * K::NL + TILE * K::XL * K::SPL) * sizeof(T) +
         MAX_Q * sizeof(float);
}

template <typename T, int HD, int NP>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_dstate_kernel(
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ acum, float* __restrict__ dstates, int S,
    int nh, int G, int N, int Q) {
  using K = Tiles<T, HD, NP>;
  using W = WMap<NP, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);        // [t][n]  C
  T* Ys = Cs + TILE * K::NL;                     // [t][d]  exp(a_cum) dy
  float* ac = reinterpret_cast<float*>(Ys + TILE * K::XL * K::SPL);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, g = h / (nh / G);
  const long long c0 = (long long)c * Q;
  const float* acb = acum + ((long long)b * nh + h) * S + c0;
  for (int t = tid; t < Q; t += NT) ac[t] = acb[t];
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const T* yb = dy + ((long long)b * S + c0) * xrow + (long long)h * HD;
  const T* Cb = Cm + ((long long)b * S + c0) * brow + (long long)g * N;
  const int strip = warp % W::STRIPS, part = warp / W::STRIPS;
  float acc[W::NTW][4];
  acc_zero(acc);
  __syncthreads();
  for (int t0 = 0; t0 < Q; t0 += TILE) {
    const int rows = min(TILE, Q - t0);
    async_tile<TILE>(Cs, K::NL, Cb + t0 * brow, brow, rows, N, NP);
    attn::cp_async_commit();
    stage_split(Ys, K::XL, TILE * K::XL, yb + t0 * xrow, xrow, TILE, HD,
                rows, [&](int r) { return expf(ac[t0 + r]); });
    attn::cp_async_wait<0>();
    __syncthreads();
    if (warp < W::WARPS)
      tile_mma<W::NTW, true, true, false, true>(
          acc, Cs + 16 * strip, K::NL, 0, Ys + 8 * W::NTW * part, K::XL,
          TILE * K::XL, TILE);
    __syncthreads();
  }
  if (warp >= W::WARPS) return;
  float* gb = dstates + (((long long)b * nc + c) * nh + h) * HD * N;
#pragma unroll
  for (int j = 0; j < W::NTW; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = 16 * strip + lane / 4 + 8 * i;
      const int d = 8 * W::NTW * part + 8 * j + 2 * (lane % 4);
      if (n < N)
        *reinterpret_cast<float2*>(gb + (long long)n * HD + d) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
}

// ---------------------------------------------------------------------------
// 2. reverse state passing: one thread per state element of one (batch,
// head), [n][d] as the scratch; the decay's dot in per-block parts. It
// writes dh_out[c] where launches 3 and 4 read dS, and in bf16 the hi +
// lo planes of dh_out[c] and of h_in[c] (the operands of their products
// on the tensor cores), so no later launch splits them again.
// ---------------------------------------------------------------------------
// v into the planes of a (batch, chunk, head) slice of HDN elements: f32
// as it is; bf16 as hi at e, lo at HDN + e
__device__ __forceinline__ void put_plane(float* base, int, int e, float v) {
  base[e] = v;
}
__device__ __forceinline__ void put_plane(bf16* base, int HDN, int e,
                                          float v) {
  split_bf16(v, base[e], base[HDN + e]);
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_pass_kernel(
    const float* dstates, const float* __restrict__ states,
    const float* __restrict__ acum, const float* __restrict__ dh_final,
    float* __restrict__ dh0, float* __restrict__ decay, T* dso,
    T* __restrict__ hso, int S, int nh, int hd, int HDN, int Q) {
  constexpr int SPL = sizeof(T) == 2 ? 2 : 1;
  __shared__ float red[PASS][NW];
  const int tid = threadIdx.x, e = blockIdx.x * NT + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool live = e < HDN;
  const int nc = S / Q, n = e / hd, d = e - n * hd;
  const long long bh = (long long)b * nh + h;
  const long long io = bh * HDN + (long long)d * (HDN / hd) + n;  // [d][n]
  float dh = live && dh_final != nullptr ? dh_final[io] : 0.f;
  const float* ab = acum + bh * S + Q - 1;        // a_last of each chunk
  const long long cstride = (long long)nh * HDN;
  const long long off = ((long long)b * nc * nh + h) * HDN;
  const float* gp = dstates + off + e;
  const float* hp = states + off + e;
  float* dec = decay + bh * nc * gridDim.x + blockIdx.x;
  for (int top = nc - 1; top >= 0; top -= PASS) {
    // chunks top, top - 1, ..., top - PASS + 1: every load in flight first
    float gv[PASS], hv[PASS], al[PASS];
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      const int c = top - i;
      const bool ok = c >= 0;
      gv[i] = ok && live ? gp[c * cstride] : 0.f;
      hv[i] = ok && live ? hp[c * cstride] : 0.f;
      al[i] = ok ? ab[(long long)c * Q] : 0.f;
    }
    float dot[PASS];
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      const int c = top - i;
      dot[i] = dh * hv[i];
      if (c >= 0) {
        if (live) {
          put_plane(dso + (off + c * cstride) * SPL, HDN, e, dh);  // dh_out
          if (hso != nullptr)
            put_plane(hso + (off + c * cstride) * SPL, HDN, e, hv[i]);
        }
        dh = fmaf(dh, expf(al[i]), gv[i]);     // dh_in[c]
      }
    }
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      const float v = lanes_sum<32>(dot[i]);
      if (tid % 32 == 0) red[i][tid / 32] = v;
    }
    __syncthreads();
    if (tid < PASS && top - tid >= 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += red[tid][w];
      dec[(long long)(top - tid) * gridDim.x] = s;
    }
    __syncthreads();
  }
  if (live) dh0[io] = dh;
}

// ---------------------------------------------------------------------------
// Row vectors a (batch, chunk, head) hands to the scan (launch 6): the
// rowsum of dCB o CB by source tile (q_tiles of them), then the colsum,
// q, sum_d d xdt x and y_off, each QP floats.
// ---------------------------------------------------------------------------
enum { V_COL = 0, V_Q = 1, V_XG = 2, V_YO = 3, V_EXTRA = 4 };

// A (batch, chunk, head)'s dS or h_in, [n][d], into a shared operand tile
// (rows N .. NP - 1 and columns HD .. HK - 1 zero): SPL planes (hi, lo) of
// HD N elements each from `slice`, NP XL elements apart in the tile.
template <typename T, int HD, int NP>
__device__ __forceinline__ void async_state(T* dst, const T* slice, int N) {
  using K = Tiles<T, HD, NP>;
#pragma unroll
  for (int p = 0; p < K::SPL; ++p)
    async_tile<NP>(dst + p * NP * K::XL, K::XL, slice + p * HD * N, HD, N,
                   HD, K::HK);
}

// The state slice (dh_out or h_in planes) of (b, c, h), in elements of T
template <typename T>
__device__ __forceinline__ const T* state_slice(const T* base, int b, int c,
                                                int h, int nc, int nh,
                                                int HDN) {
  constexpr int SPL = sizeof(T) == 2 ? 2 : 1;
  return base + (((long long)b * nc + c) * nh + h) * HDN * SPL;
}

// f32 scratch of launch 3 after its operand tiles, in floats
struct SrcVec {
  int ac, dts, colp, rowp, total;
  __host__ __device__ SrcVec(int hb, int Q) {
    ac = 0;                       // [hb][Q]  a_cum log2(e), the block's heads
    dts = ac + hb * Q;            // [hb][Q]  dt
    colp = dts + hb * Q;          // [2][hb][64]  colsum by column part
    rowp = colp + 2 * hb * TILE;  // [4][hb][64]  rowsum by row strip
    total = rowp + 4 * hb * TILE;
  }
};

// Operand tiles of launch 3, in elements of T: x_s and dy_t (NBUF
// buffers each, filled by cp.async one (query tile, head) ahead), then dS
// (the heads' state terms, first) or the summed dCB^T and C_t over the
// same bytes. Two blocks an SM in bf16 up to hd 64.
template <typename T, int HD, int NP>
struct SrcSmem : Tiles<T, HD, NP> {
  using K = Tiles<T, HD, NP>;
  static constexpr int NBUF = sizeof(T) == 4 && HD == 128 ? 1 : 2;
  static constexpr int X = 0;                          // [NBUF][s][d]
  static constexpr int DY = X + NBUF * TILE * K::XL;   // [NBUF][t][d]
  static constexpr int U = DY + NBUF * TILE * K::XL;
  static constexpr int DS = U;                         // [n][d] split
  static constexpr int DCB = U;                        // [s][t] split
  static constexpr int CT = DCB + TILE * K::PL * K::SPL;   // [t][n]
  static constexpr int END1 = DS + NP * K::XL * K::SPL;
  static constexpr int END2 = CT + TILE * K::NL;
  static constexpr int END = END1 > END2 ? END1 : END2;
  static constexpr int MIN_BLOCKS = sizeof(T) == 2 && HD <= 64 ? 2 : 1;
  static size_t bytes(int hb, int Q) {
    return (size_t)END * sizeof(T) + SrcVec(hb, Q).total * sizeof(float);
  }
};

// dCB tile (s tile si, t tile tj) of a (batch, chunk, head block) in the
// scratch: SPL planes of QP x QP T, [s][t]
template <typename T>
__device__ __forceinline__ T* dcb_tile(float* dcb, int bc, int nhb, int hblk,
                                       int QP) {
  constexpr int SPL = sizeof(T) == 2 ? 2 : 1;
  return reinterpret_cast<T*>(dcb) +
         ((long long)bc * nhb + hblk) * SPL * (long long)QP * QP;
}

// ---------------------------------------------------------------------------
// 3. source side: one block per (head block, chunk, source tile s): each
// head's state term of dB_s; then for each query tile t >= s, each head:
// dP^T, dCB^T and its parts of d a_cum; the heads' sum of dCB^T to its
// scratch tile and dB_s += dCB^T C_t.
// ---------------------------------------------------------------------------
template <typename T, int HD, int NP>
__global__ void __launch_bounds__(NT, SrcSmem<T, HD, NP>::MIN_BLOCKS)
    ssd_scan_bwd_src_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ Cm, const float* __restrict__ acum,
    const float* __restrict__ cb, const T* __restrict__ dy,
    const T* __restrict__ dso, float* __restrict__ dBp,
    float* __restrict__ dcb, float* __restrict__ vecs, int S, int nh, int G,
    int N, int Q, int hb) {
  using L = SrcSmem<T, HD, NP>;
  using WP = WMap<TILE, TILE>;   // dP^T [s][t]
  using WB = WMap<TILE, NP>;     // dB [s][n]
  static_assert(WP::STRIPS == 4 && WP::PARTS == 2 && WB::PARTS == 2,
                "4 row strips x 2 column parts");
  constexpr int XL = L::XL, PL = L::PL, NL = L::NL, HK = L::HK;
  constexpr int NBUF = L::NBUF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Dsm = sm + L::DS;
  T* Dc = sm + L::DCB;
  T* Ct = sm + L::CT;
  const SrcVec V(hb, Q);
  float* fv = reinterpret_cast<float*>(sm + L::END);
  float* ac = fv + V.ac;
  float* dts = fv + V.dts;
  float* colp = fv + V.colp;
  float* rowp = fv + V.rowp;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t2 = 2 * (lane % 4);
  const int nc = S / Q, nqt = (Q + TILE - 1) / TILE, QP = nqt * TILE;
  const int nhb = nh / hb, NV = nqt + V_EXTRA;
  const int hblk = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int si = blockIdx.z;
  const int h0 = hblk * hb, grp = h0 / (nh / G);
  const int s0 = si * TILE, rows_s = min(TILE, Q - s0);
  const long long c0 = (long long)c * Q;
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const long long xbase = ((long long)b * S + c0) * xrow;
  const T* Cb = Cm + ((long long)b * S + c0) * brow + (long long)grp * N;
  const float* cbg = cb + (((long long)b * nc + c) * G + grp) * QP * QP;
  T* dcbt = dcb_tile<T>(dcb, b * nc + c, nhb, hblk, QP);
  float* vb = vecs + (((long long)b * nc + c) * nh + h0) * NV * QP;
  const int ps = warp % 4, pp = warp / 4;   // dP^T and dB: strip, part

  for (int i = tid; i < hb * Q; i += NT) {
    const int hh = i / Q, t = i - hh * Q;
    ac[i] = acum[((long long)b * nh + h0 + hh) * S + c0 + t] * LOG2E;
    dts[i] = dt[((long long)b * S + c0 + t) * nh + h0 + hh];
  }
  for (int i = tid; i < 2 * hb * TILE; i += NT) colp[i] = 0.f;

  // ---- each head's state term: dB_s += w_s dt_s x_s dS (B = dS [n][d]) --
  T* X0 = sm + L::X;
  float dB[WB::NTW][4];
  acc_zero(dB);
  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh;
    async_tile<TILE>(X0, XL, x + xbase + (long long)h * HD + s0 * xrow, xrow,
                     rows_s, HD, HK);
    async_state<T, HD, NP>(Dsm, state_slice(dso, b, c, h, nc, nh, HD * N),
                           N);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    const float* ah = ac + hh * Q;
    const float* dh = dts + hh * Q;
    const float a_last = ah[Q - 1];
    // in two halves of the warp's columns, to keep registers for dB
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      constexpr int NH = WB::NTW / 2;
      float tmp[NH][4];
      acc_zero(tmp);
      tile_mma<NH, false, false, false, true>(
          tmp, X0 + 16 * ps * XL, XL, 0,
          Dsm + (8 * WB::NTW * pp + 8 * NH * half) * XL, XL, NP * XL, HK);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int sl = 16 * ps + g4 + 8 * i;
        const float w = sl < rows_s
                            ? dh[s0 + sl] * attn::ex2(a_last - ah[s0 + sl])
                            : 0.f;
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            dB[NH * half + j][2 * i + k] =
                fmaf(tmp[j][2 * i + k], w, dB[NH * half + j][2 * i + k]);
      }
    }
    __syncthreads();            // X0 and dS are restaged
  }

  // ---- the query tiles t >= s: dP^T once per tile pair and head ----------
  // (query tile, head) pairs in order, x_s and dy_t one pair ahead
  const int n_it = (nqt - si) * hb;
  auto issue = [&](int it) {
    const int tj = si + it / hb, h = h0 + it % hb, buf = it % NBUF;
    const long long hoff = xbase + (long long)h * HD;
    async_tile<TILE>(sm + L::X + buf * TILE * XL, XL, x + hoff + s0 * xrow,
                     xrow, rows_s, HD, HK);
    async_tile<TILE>(sm + L::DY + buf * TILE * XL, XL,
                     dy + hoff + (long long)tj * TILE * xrow, xrow,
                     min(TILE, Q - tj * TILE), HD, HK);
    attn::cp_async_commit();
  };
  issue(0);
  float cbv[WP::NTW][4], dsum[WP::NTW][4];
  for (int it = 0; it < n_it; ++it) {
    const int tj = si + it / hb, hh = it % hb;
    const int t0 = tj * TILE, rows_t = min(TILE, Q - t0);
    const T* Xs = sm + L::X + (it % NBUF) * TILE * XL;
    const T* Ys = sm + L::DY + (it % NBUF) * TILE * XL;
    if (NBUF == 2 && it + 1 < n_it) {
      issue(it + 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    if (hh == 0) {
      // C.B^T of this warp's fragment, for every head of the query tile
#pragma unroll
      for (int j = 0; j < WP::NTW; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = s0 + 16 * ps + g4 + 8 * i;
          const int t = t0 + 32 * pp + 8 * j + t2;
          const float2 v = s < Q ? *reinterpret_cast<const float2*>(
                                       cbg + (long long)s * QP + t)
                                 : make_float2(0.f, 0.f);
          cbv[j][2 * i] = v.x;
          cbv[j][2 * i + 1] = v.y;
        }
      acc_zero(dsum);
    }
    __syncthreads();
    const float* ah = ac + hh * Q;
    const float* dh = dts + hh * Q;
    float p[WP::NTW][4];
    acc_zero(p);
    tile_mma<WP::NTW, false, false, false, false>(
        p, Xs + 16 * ps * XL, XL, 0, Ys + 32 * pp * XL, XL, 0, HK);
    static_assert(WP::NTW == 4, "8 columns a thread");
    float cs[2] = {0.f, 0.f}, rs[8];
#pragma unroll
    for (int j = 0; j < WP::NTW; ++j) {
      rs[2 * j] = rs[2 * j + 1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + 16 * ps + g4 + 8 * (e / 2);
        const int t = t0 + 32 * pp + 8 * j + t2 + e % 2;
        const bool ok = s <= t && t < Q;
        const float v =
            ok ? p[j][e] * dh[s] * attn::ex2(ah[t] - ah[s]) : 0.f;  // dCB^T
        const float r = v * cbv[j][e];
        cs[e / 2] += r;
        rs[2 * j + e % 2] += r;
        dsum[j][e] += v;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = lanes_sum<4>(cs[i]);
      if (lane % 4 == 0)
        colp[(pp * hb + hh) * TILE + 16 * ps + g4 + 8 * i] += v;
    }
    rowp[(ps * hb + hh) * TILE + 32 * pp + 8 * (g4 / 2) + t2 + g4 % 2] =
        cols_sum8(rs);
    __syncthreads();            // the x / dy buffer is free
    if (NBUF == 1 && it + 1 < n_it) issue(it + 1);
    if (hh + 1 < hb) continue;

    // the query tile's last head: its rowsum over the 4 strips in order,
    // the heads' dCB^T into shared memory and its scratch tile, C_t, and
    // dB_s += dCB^T C_t once for the head block
    for (int i = tid; i < hb * TILE; i += NT) {
      const int k = i / TILE, tl = i - k * TILE;
      if (t0 + tl < Q) {
        const float* r = rowp + k * TILE + tl;
        vb[((long long)k * NV + si) * QP + t0 + tl] =
            ((r[0] + r[hb * TILE]) + r[2 * hb * TILE]) + r[3 * hb * TILE];
      }
    }
#pragma unroll
    for (int j = 0; j < WP::NTW; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        put2<true>(Dc + (16 * ps + g4 + 8 * i) * PL + 32 * pp + 8 * j + t2,
                   TILE * PL, dsum[j][2 * i], dsum[j][2 * i + 1]);
    async_tile<TILE>(Ct, NL, Cb + t0 * brow, brow, rows_t, N, NP);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    {
      constexpr int VT = 16 / sizeof(T), CPR = TILE / VT;
      for (int i = tid; i < L::SPL * TILE * CPR; i += NT) {
        const int pl = i / (TILE * CPR), r = (i / CPR) % TILE;
        const int col = (i % CPR) * VT;
        *reinterpret_cast<uint4*>(dcbt + (long long)pl * QP * QP +
                                  (long long)(s0 + r) * QP + t0 + col) =
            *reinterpret_cast<const uint4*>(Dc + pl * TILE * PL + r * PL +
                                            col);
      }
    }
    tile_mma<WB::NTW, false, true, true, false>(
        dB, Dc + 16 * ps * PL, PL, TILE * PL, Ct + 8 * WB::NTW * pp, NL, 0,
        TILE);
    __syncthreads();            // rowp, Dc and Ct are free
  }

  // ---- out: the head block's dB rows and each head's colsum ---------------
  float* dBb = dBp + (((long long)b * S + c0 + s0) * nhb + hblk) * N;
#pragma unroll
  for (int j = 0; j < WB::NTW; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sl = 16 * ps + g4 + 8 * i;
      const int n = 8 * WB::NTW * pp + 8 * j + t2;
      if (sl < rows_s && n < N)
        *reinterpret_cast<float2*>(dBb + (long long)sl * nhb * N + n) =
            make_float2(dB[j][2 * i], dB[j][2 * i + 1]);
    }
  for (int i = tid; i < hb * TILE; i += NT) {
    const int hh = i / TILE, sl = i - hh * TILE;
    if (sl < rows_s)
      vb[((long long)hh * NV + nqt + V_COL) * QP + s0 + sl] =
          colp[hh * TILE + sl] + colp[(hb + hh) * TILE + sl];
  }
}

// ---------------------------------------------------------------------------
// 4. head side: one block per (head, chunk, source tile s): d xdt_s = w_s
// B_s dS^T + sum_t M^T dy_t over the query tiles t >= s, q_s, dx, sum_d
// d xdt x and dy . x. What is the head's own needs no sum over heads, so
// each head has its blocks, and many blocks (two an SM up to hd 64) hide
// each other's loads. B_s and dS arrive by cp.async; then each
// query tile's dy_t (two buffers, over B_s and dS) by cp.async and its
// C.B^T values into registers, the next tile's during this one's product;
// x, dy and dx of the rows s go between global memory and registers.
// ---------------------------------------------------------------------------
template <typename T, int HD, int NP>
struct HeadSmem : Tiles<T, HD, NP> {
  using K = Tiles<T, HD, NP>;
  static constexpr int BS = 0;                          // [s][n]  B_s
  static constexpr int DS = BS + TILE * K::NL;          // [n][d]  dS
  static constexpr int END1 = DS + NP * K::XL * K::SPL;
  static constexpr int MT = 0;                          // [s][t]  M^T
  static constexpr int DY = MT + TILE * K::PL * K::SPL; // [2][t][d]  dy_t
  static constexpr int END2 = DY + 2 * TILE * K::XL;
  static constexpr int END = END1 > END2 ? END1 : END2;
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
  static size_t bytes(int Q) {
    return (size_t)END * sizeof(T) +
           (size_t)(Q + 5 * TILE + NW) * sizeof(float);
  }
};

template <typename T, int HD, int NP>
__global__ void __launch_bounds__(NT, HeadSmem<T, HD, NP>::MIN_BLOCKS)
    ssd_scan_bwd_head_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ Bm, const float* __restrict__ D,
    const float* __restrict__ acum, const float* __restrict__ cb,
    const T* __restrict__ dy, const T* __restrict__ dso,
    T* __restrict__ dx, float* __restrict__ vecs, float* __restrict__ dyxp,
    int S, int nh, int G, int N, int Q) {
  using L = HeadSmem<T, HD, NP>;
  using WX = WMap<TILE, HD>;     // d xdt [s][d]
  constexpr int XL = L::XL, PL = L::PL, NL = L::NL, HK = L::HK;
  constexpr int PE = TILE * TILE / 2 / NT;     // M^T column pairs a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Bs = sm + L::BS;
  T* Ds = sm + L::DS;
  T* Mt = sm + L::MT;
  float* ah = reinterpret_cast<float*>(sm + L::END);   // [Q]  a_cum log2(e)
  float* dh = ah + Q;                                   // [64]  dt_s
  float* qp = dh + TILE;                                // [2][64]
  float* xgp = qp + 2 * TILE;                           // [2][64]
  float* dyxw = xgp + 2 * TILE;                         // [NW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t2 = 2 * (lane % 4);
  const int nc = S / Q, nqt = (Q + TILE - 1) / TILE, QP = nqt * TILE;
  const int NV = nqt + V_EXTRA;
  const int si = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int grp = h / (nh / G);
  const int s0 = si * TILE, rows_s = min(TILE, Q - s0);
  const long long c0 = (long long)c * Q;
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const long long hoff = ((long long)b * S + c0) * xrow + (long long)h * HD;
  const T* Bb = Bm + ((long long)b * S + c0) * brow + (long long)grp * N;
  const float* cbg = cb + (((long long)b * nc + c) * G + grp) * QP * QP;

  async_tile<TILE>(Bs, NL, Bb + s0 * brow, brow, rows_s, N, NP);
  async_state<T, HD, NP>(Ds, state_slice(dso, b, c, h, nc, nh, HD * N), N);
  attn::cp_async_commit();
  // this thread's C.B^T pairs of query tile tj, masked to s <= t < Q
  float2 cv[PE];
  auto load_cb = [&](int tj) {
#pragma unroll
    for (int k = 0; k < PE; ++k) {
      const int i = tid + k * NT, sl = i / (TILE / 2);
      const int t = tj * TILE + 2 * (i - sl * (TILE / 2));
      cv[k] = *reinterpret_cast<const float2*>(cbg + (long long)(s0 + sl) *
                                               QP + t);
    }
  };
  load_cb(si);
  for (int t = tid; t < Q; t += NT)
    ah[t] = acum[((long long)b * nh + h) * S + c0 + t] * LOG2E;
  if (tid < TILE)
    dh[tid] = tid < rows_s ? dt[((long long)b * S + c0 + s0 + tid) * nh + h]
                           : 0.f;
  attn::cp_async_wait<0>();
  __syncthreads();
  const float a_last = ah[Q - 1];
  const int xs = warp % WX::STRIPS, xp = warp / WX::STRIPS;
  const bool xw = xp < WX::PARTS;
  const int d0 = 8 * WX::NTW * xp;
  // d xdt_s = w_s B_s dS^T (B = dS stored [n][d] = [k][n]), and q_s
  float gx[WX::NTW][4];
  acc_zero(gx);
  if (xw) {
    tile_mma<WX::NTW, false, true, false, true>(
        gx, Bs + 16 * xs * NL, NL, 0, Ds + d0, XL, NP * XL, NP);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sl = 16 * xs + g4 + 8 * i;
      const bool live = sl < rows_s;
      const float w = live ? attn::ex2(a_last - ah[s0 + sl]) : 0.f;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < WX::NTW; ++j) {
        const float2 xv = live ? load2(x + hoff + (long long)(s0 + sl) *
                                       xrow + d0 + 8 * j + t2)
                               : make_float2(0.f, 0.f);
        gx[j][2 * i] *= w;
        gx[j][2 * i + 1] *= w;
        q = fmaf(gx[j][2 * i], xv.x, fmaf(gx[j][2 * i + 1], xv.y, q));
      }
      q = lanes_sum<4>(q);
      if (lane % 4 == 0) qp[xp * TILE + sl] = q * dh[sl];
    }
  }
  // d xdt_s += sum_t M[t, s] dy_t over the query tiles
  auto issue = [&](int tj) {
    const int t0 = tj * TILE;
    async_tile<TILE>(sm + L::DY + (tj % 2) * TILE * XL, XL,
                     dy + hoff + t0 * xrow, xrow, min(TILE, Q - t0), HD, HK);
    attn::cp_async_commit();
  };
  __syncthreads();              // Bs, Ds are read: M^T and dy_t take them
  issue(si);
  for (int tj = si; tj < nqt; ++tj) {
    const int t0 = tj * TILE;
#pragma unroll
    for (int k = 0; k < PE; ++k) {
      const int i = tid + k * NT, sl = i / (TILE / 2);
      const int tl = 2 * (i - sl * (TILE / 2));
      const int s = s0 + sl, t = t0 + tl;
      const float as = ah[s];
      put2<true>(Mt + sl * PL + tl, TILE * PL,
                 s <= t && t < Q ? cv[k].x * attn::ex2(ah[t] - as) : 0.f,
                 s <= t + 1 && t + 1 < Q
                     ? cv[k].y * attn::ex2(ah[t + 1] - as)
                     : 0.f);
    }
    if (tj + 1 < nqt) {
      issue(tj + 1);
      load_cb(tj + 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();            // M^T and dy_t ready
    if (xw)
      tile_mma<WX::NTW, false, true, true, false>(
          gx, Mt + 16 * xs * PL, PL, TILE * PL,
          sm + L::DY + (tj % 2) * TILE * XL + d0, XL, 0, TILE);
    __syncthreads();            // M^T and this dy_t buffer are free
  }
  // dx, sum_d d xdt x and sum dy . x
  float dyx = 0.f;
  if (xw) {
    const float d_h = D[h];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sl = 16 * xs + g4 + 8 * i;
      float xg = 0.f;
      if (sl < rows_s) {
        const long long row = hoff + (long long)(s0 + sl) * xrow;
        const float dtv = dh[sl];
#pragma unroll
        for (int j = 0; j < WX::NTW; ++j) {
          const int d = d0 + 8 * j + t2;
          const float2 xv = load2(x + row + d), yv = load2(dy + row + d);
          const float g0 = gx[j][2 * i], g1 = gx[j][2 * i + 1];
          put2<false>(dx + row + d, 0, fmaf(g0, dtv, d_h * yv.x),
                      fmaf(g1, dtv, d_h * yv.y));
          xg = fmaf(g0, xv.x, fmaf(g1, xv.y, xg));
          dyx = fmaf(yv.x, xv.x, fmaf(yv.y, xv.y, dyx));
        }
      }
      xg = lanes_sum<4>(xg);
      if (lane % 4 == 0) xgp[xp * TILE + sl] = xg;
    }
  }
  dyx = lanes_sum<32>(dyx);
  if (lane == 0) dyxw[warp] = dyx;
  __syncthreads();
  float* vb = vecs + (((long long)b * nc + c) * nh + h) * NV * QP + s0;
  if (tid < rows_s) {
    const float* q = qp + tid;
    const float* xg = xgp + tid;
    vb[(nqt + V_Q) * QP + tid] = WX::PARTS > 1 ? q[0] + q[TILE] : q[0];
    vb[(nqt + V_XG) * QP + tid] = WX::PARTS > 1 ? xg[0] + xg[TILE] : xg[0];
  }
  if (tid == 0) {
    float sd = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sd += dyxw[w];
    dyxp[(((long long)b * nc + c) * nh + h) * nqt + si] = sd;
  }
}

// ---------------------------------------------------------------------------
// 5. query side: one block per (head block, chunk, query tile t): per head
// (dy_t and h_in by cp.async, the next head's during this one's product)
// the state term of dC_t and y_off; then over the source tiles s <= t
// (their summed dCB tile and B_s likewise one ahead) dC_t += dCB B_s.
// ---------------------------------------------------------------------------
template <typename T, int HD, int NP>
struct QrySmem : Tiles<T, HD, NP> {
  using K = Tiles<T, HD, NP>;
  static constexpr int NBUF = sizeof(T) == 4 && HD == 128 ? 1 : 2;
  static constexpr int CT = 0;                          // [t][n]  C_t
  static constexpr int U = CT + TILE * K::NL;
  static constexpr int HEAD = TILE * K::XL + NP * K::XL * K::SPL;
  static constexpr int DY = U;                          // [NBUF][t][d]
  static constexpr int HIN = DY + TILE * K::XL;         //   [n][d] h_in
  static constexpr int SRC = TILE * K::PL * K::SPL + TILE * K::NL;
  static constexpr int DCB = U;                         // [NBUF][s][t]
  static constexpr int BS = DCB + TILE * K::PL * K::SPL;  //   [s][n] B_s
  static constexpr int UB = HEAD > SRC ? HEAD : SRC;    // a buffer
  static constexpr int END = U + NBUF * UB;
  static size_t bytes(int hb) {
    return (size_t)END * sizeof(T) + (size_t)3 * hb * TILE * sizeof(float);
  }
};

template <typename T, int HD, int NP>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_qry_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ hso, const float* __restrict__ acum,
    const T* __restrict__ dy, const float* __restrict__ dcb,
    float* __restrict__ dCp, float* __restrict__ vecs, int has_h0, int S,
    int nh, int G, int N, int Q, int hb) {
  using L = QrySmem<T, HD, NP>;
  using WC = WMap<TILE, NP>;
  static_assert(WC::STRIPS == 4 && WC::PARTS == 2, "4 strips x 2 parts");
  constexpr int XL = L::XL, PL = L::PL, NL = L::NL, HK = L::HK;
  constexpr int NBUF = L::NBUF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Ct = sm + L::CT;
  float* ac = reinterpret_cast<float*>(sm + L::END);   // [hb][64]
  float* yop = ac + hb * TILE;                          // [hb][2][64]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t2 = 2 * (lane % 4);
  const int nc = S / Q, nqt = (Q + TILE - 1) / TILE, QP = nqt * TILE;
  const int nhb = nh / hb, NV = nqt + V_EXTRA;
  const int tj = nqt - 1 - blockIdx.x;            // heaviest tiles first
  const int hblk = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int h0 = hblk * hb, grp = h0 / (nh / G);
  const int t0 = tj * TILE, rows_t = min(TILE, Q - t0);
  const long long c0 = (long long)c * Q;
  const long long xrow = (long long)nh * HD, brow = (long long)G * N;
  const long long xbase = ((long long)b * S + c0) * xrow;
  const T* Bb = Bm + ((long long)b * S + c0) * brow + (long long)grp * N;
  const T* Cb = Cm + ((long long)b * S + c0) * brow + (long long)grp * N;
  const T* dcbt = dcb_tile<T>(const_cast<float*>(dcb), b * nc + c, nhb,
                              hblk, QP);
  const bool has_state = c > 0 || has_h0;
  const int cs = warp % 4, cp = warp / 4, n0 = 8 * WC::NTW * cp;

  // work items: the heads (when a state is carried in), then the source
  // tiles s <= t; each item's operands one item ahead
  const int nh_it = has_state ? hb : 0, n_it = nh_it + tj + 1;
  auto issue = [&](int it) {
    T* ub = sm + L::U + (it % NBUF) * L::UB;
    if (it < nh_it) {
      const int h = h0 + it;
      async_tile<TILE>(ub + (L::DY - L::U), XL,
                       dy + xbase + (long long)h * HD + t0 * xrow, xrow,
                       rows_t, HD, HK);
      async_state<T, HD, NP>(ub + (L::HIN - L::U),
                             state_slice(hso, b, c, h, nc, nh, HD * N), N);
    } else {
      const int s0 = (it - nh_it) * TILE;
#pragma unroll
      for (int p = 0; p < L::SPL; ++p)
        async_tile<TILE>(ub + (L::DCB - L::U) + p * TILE * PL, PL,
                         dcbt + (long long)p * QP * QP + (long long)s0 * QP +
                             t0,
                         QP, TILE, TILE, TILE);
      async_tile<TILE>(ub + (L::BS - L::U), NL, Bb + s0 * brow, brow,
                       min(TILE, Q - s0), N, NP);
    }
    attn::cp_async_commit();
  };
  async_tile<TILE>(Ct, NL, Cb + t0 * brow, brow, rows_t, N, NP);
  issue(0);
  for (int i = tid; i < hb * TILE; i += NT) {
    const int hh = i / TILE, tl = i - hh * TILE;
    ac[i] = tl < rows_t ? acum[((long long)b * nh + h0 + hh) * S + c0 + t0 +
                               tl]
                        : 0.f;
  }
  float dC[WC::NTW][4];
  acc_zero(dC);
  for (int it = 0; it < n_it; ++it) {
    const T* ub = sm + L::U + (it % NBUF) * L::UB;
    if (NBUF == 2 && it + 1 < n_it) {
      issue(it + 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    if (it < nh_it) {
      // exp(a_cum_t) dy_t h_in (B = h_in stored [n][d]), its dot with C_t
      const int hh = it;
      const T* Ys = ub + (L::DY - L::U);
      const T* Hs = ub + (L::HIN - L::U);
      float tmp[WC::NTW][4];
      acc_zero(tmp);
      tile_mma<WC::NTW, false, false, false, true>(
          tmp, Ys + 16 * cs * XL, XL, 0, Hs + n0 * XL, XL, NP * XL, HK);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tl = 16 * cs + g4 + 8 * i;
        const float et = tl < rows_t ? expf(ac[hh * TILE + tl]) : 0.f;
        float yo = 0.f;
#pragma unroll
        for (int j = 0; j < WC::NTW; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float v = tmp[j][2 * i + k] * et;
            yo = fmaf(v, to_f32(Ct[tl * NL + n0 + 8 * j + t2 + k]), yo);
            dC[j][2 * i + k] += v;
          }
        yo = lanes_sum<4>(yo);
        if (lane % 4 == 0) yop[(hh * 2 + cp) * TILE + tl] = yo;
      }
    } else {
      // dC_t += dCB B_s (A = dCB stored [s][t])
      tile_mma<WC::NTW, true, true, true, false>(
          dC, ub + (L::DCB - L::U) + 16 * cs, PL, TILE * PL,
          ub + (L::BS - L::U) + n0, NL, 0, TILE);
    }
    __syncthreads();            // the buffer is free
    if (NBUF == 1 && it + 1 < n_it) issue(it + 1);
  }
  float* dCb = dCp + (((long long)b * S + c0 + t0) * nhb + hblk) * N;
#pragma unroll
  for (int j = 0; j < WC::NTW; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tl = 16 * cs + g4 + 8 * i;
      const int n = n0 + 8 * j + t2;
      if (tl < rows_t && n < N)
        *reinterpret_cast<float2*>(dCb + (long long)tl * nhb * N + n) =
            make_float2(dC[j][2 * i], dC[j][2 * i + 1]);
    }
  float* vb = vecs + (((long long)b * nc + c) * nh + h0) * NV * QP;
  for (int i = tid; i < hb * TILE; i += NT) {
    const int hh = i / TILE, tl = i - hh * TILE;
    if (tl < rows_t)
      vb[((long long)hh * NV + nqt + V_YO) * QP + t0 + tl] =
          has_state ? yop[hh * 2 * TILE + tl] + yop[(hh * 2 + 1) * TILE + tl]
                    : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 6. scan: one block per (head, chunk, batch): d a_cum, its reverse
// cumulative sum, ddt and the chunk's parts of dA and dD
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) ssd_scan_bwd_scan_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ acum, const float* __restrict__ vecs,
    const float* __restrict__ decay, const float* __restrict__ dyxp,
    float* __restrict__ ddt, float* __restrict__ pA, float* __restrict__ pD,
    int S, int nh, int Q, int pass_blocks) {
  __shared__ float red[NW];
  __shared__ float dec_s;
  const int tid = threadIdx.x;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, nqt = (Q + TILE - 1) / TILE, QP = nqt * TILE;
  const int NV = nqt + V_EXTRA;
  const long long bh = (long long)b * nh + h, c0 = (long long)c * Q;
  const long long part = ((long long)b * nc + c) * nh + h;
  const float* vb = vecs + part * NV * QP;
  const int t = Q - 1 - tid;                     // thread tid: row t
  float dac = 0.f, qv = 0.f, xg = 0.f, dtv = 0.f;
  if (t >= 0) {
    float r = 0.f;
    for (int i = 0; i <= t / TILE; ++i) r += vb[i * QP + t];
    qv = vb[(nqt + V_Q) * QP + t];
    dac = ((r - vb[(nqt + V_COL) * QP + t]) + vb[(nqt + V_YO) * QP + t]) - qv;
    xg = vb[(nqt + V_XG) * QP + t];
    dtv = dt[((long long)b * S + c0 + t) * nh + h];
  }
  if (tid == 0) {
    const float* dp = decay + (bh * nc + c) * pass_blocks;
    float s = 0.f;
    for (int k = 0; k < pass_blocks; ++k) s += dp[k];
    dec_s = expf(acum[bh * S + c0 + Q - 1]) * s;
  }
  const float qs = block_sum(qv, red);           // (its barriers cover dec_s)
  if (tid == 0) dac += qs + dec_s;               // row Q - 1
  __syncthreads();                               // red is read above
  const float da = block_scan(dac, red);         // sum over rows >= t
  if (t >= 0) ddt[((long long)b * S + c0 + t) * nh + h] = fmaf(da, A[h], xg);
  const float sa = block_sum(t >= 0 ? da * dtv : 0.f, red);
  if (tid == 0) {
    float sd = 0.f;
    for (int i = 0; i < nqt; ++i) sd += dyxp[part * nqt + i];
    pA[part] = sa;
    pD[part] = sd;
  }
}

// ---------------------------------------------------------------------------
// 7. reduce: dB, dC (b S G N) over each group's head blocks in order; the
// first nh threads also sum dA, dD over the (batch, chunk) parts in order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_reduce_kernel(
    const float* __restrict__ dBp, const float* __restrict__ dCp,
    const float* __restrict__ pA, const float* __restrict__ pD,
    T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
    float* __restrict__ dD, long long rows, int nh, int G, int N, int nhb,
    int parts) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  const int per = nhb / G;
  const long long gn = (long long)G * N;
  if (i < rows * gn) {
    const long long r = i / gn;
    const int k = (int)(i - r * gn), g = k / N, n = k - g * N;
    const long long base = (r * nhb + (long long)g * per) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < per; ++j) {
      sb += dBp[base + (long long)j * N];
      sc += dCp[base + (long long)j * N];
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
  void *dstates, *dsplit, *hsplit, *decay, *dcb, *vecs, *dyx, *dBp, *dCp,
      *pA, *pD;
  int b, S, nh, G, N, Q, hb, has_h0;
  const int* grid;
};

template <typename T, int HD, int NP>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int* gr = a.grid;
  auto dim = [&](int k) { return dim3(gr[3 * k], gr[3 * k + 1], gr[3 * k + 2]); };
  const int nc = a.S / a.Q;
  auto k1 = ssd_scan_bwd_dstate_kernel<T, HD, NP>;
  const size_t b1 = dstate_smem<T, HD, NP>();
  cudaError_t err = attn::allow_smem(k1, b1);
  if (err != cudaSuccess) return err;
  k1<<<dim(0), NT, b1, stream>>>(
      static_cast<const T*>(a.C), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.acum), static_cast<float*>(a.dstates),
      a.S, a.nh, a.G, a.N, a.Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dS (dh_out) and h_in as the products take them: in f32 dh_out in
  // place of G_c and h_in as kept; in bf16 their hi / lo planes
  constexpr bool BF = sizeof(T) == 2;
  T* dso = static_cast<T*>(BF ? a.dsplit : a.dstates);
  T* hso = BF ? static_cast<T*>(a.hsplit) : nullptr;
  ssd_scan_bwd_pass_kernel<T><<<dim(1), NT, 0, stream>>>(
      static_cast<const float*>(a.dstates),
      static_cast<const float*>(a.states),
      static_cast<const float*>(a.acum),
      static_cast<const float*>(a.dh_final), static_cast<float*>(a.dh0),
      static_cast<float*>(a.decay), dso, hso, a.S, a.nh, HD, HD * a.N, a.Q);
  const T* hin = BF ? hso : static_cast<const T*>(a.states);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k3 = ssd_scan_bwd_src_kernel<T, HD, NP>;
  const size_t b3 = SrcSmem<T, HD, NP>::bytes(a.hb, a.Q);
  err = attn::allow_smem(k3, b3);
  if (err != cudaSuccess) return err;
  k3<<<dim(2), NT, b3, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const T*>(a.C), static_cast<const float*>(a.acum),
      static_cast<const float*>(a.cb), static_cast<const T*>(a.dy), dso,
      static_cast<float*>(a.dBp),
      static_cast<float*>(a.dcb), static_cast<float*>(a.vecs), a.S, a.nh,
      a.G, a.N, a.Q, a.hb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kh = ssd_scan_bwd_head_kernel<T, HD, NP>;
  const size_t bh = HeadSmem<T, HD, NP>::bytes(a.Q);
  err = attn::allow_smem(kh, bh);
  if (err != cudaSuccess) return err;
  kh<<<dim(3), NT, bh, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const T*>(a.B), static_cast<const float*>(a.D),
      static_cast<const float*>(a.acum), static_cast<const float*>(a.cb),
      static_cast<const T*>(a.dy), dso, static_cast<T*>(a.dx),
      static_cast<float*>(a.vecs),
      static_cast<float*>(a.dyx), a.S, a.nh, a.G, a.N, a.Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k4 = ssd_scan_bwd_qry_kernel<T, HD, NP>;
  const size_t b4 = QrySmem<T, HD, NP>::bytes(a.hb);
  err = attn::allow_smem(k4, b4);
  if (err != cudaSuccess) return err;
  k4<<<dim(4), NT, b4, stream>>>(
      static_cast<const T*>(a.B), static_cast<const T*>(a.C), hin,
      static_cast<const float*>(a.acum), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.dcb),
      static_cast<float*>(a.dCp), static_cast<float*>(a.vecs),
      a.has_h0, a.S, a.nh, a.G, a.N, a.Q, a.hb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_scan_kernel<<<dim(5), NT, 0, stream>>>(
      static_cast<const float*>(a.dt), static_cast<const float*>(a.A),
      static_cast<const float*>(a.acum), static_cast<const float*>(a.vecs),
      static_cast<const float*>(a.decay), static_cast<const float*>(a.dyx),
      static_cast<float*>(a.ddt), static_cast<float*>(a.pA),
      static_cast<float*>(a.pD), a.S, a.nh, a.Q, gr[3]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.b * a.S;
  ssd_scan_bwd_reduce_kernel<T><<<dim(6), NT, 0, stream>>>(
      static_cast<const float*>(a.dBp), static_cast<const float*>(a.dCp),
      static_cast<const float*>(a.pA), static_cast<const float*>(a.pD),
      static_cast<T*>(a.dB), static_cast<T*>(a.dC),
      static_cast<float*>(a.dA), static_cast<float*>(a.dD), rows, a.nh, a.G,
      a.N, a.nh / a.hb, a.b * nc);
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
// (b, nh, hd, N) f32 or null for zeros; has_h0 whether the forward had an
// h0. Out: dx like x, ddt like dt, dA and dD (nh,) f32, dB and dC like B,
// dh0 (b, nh, hd, N) f32. Scratch, all f32, the shapes of the wrapper's
// `ssd_bwd_plan`: dstates like states (G_c, then in f32 dh_out); in bf16
// dsplit and hsplit like states, the hi and lo bf16 planes of dh_out and
// of h_in in the same bytes (unused in f32); decay (b, nh, S / chunk,
// pass blocks); dcb (b, S / chunk, nh / hb, QP, QP), each head block's
// summed dCB tiles (in bf16 hi and lo planes); vecs (b, S / chunk, nh,
// q_tiles + 4, QP), the row vectors; dyx (b, S / chunk, nh, q_tiles); dBp
// and dCp (b, S, nh / hb, N), the head blocks' row parts; pA and pD (b,
// S / chunk, nh). All contiguous. hd in {8, 16, 32, 64, 128}; N a
// multiple of 16 up to 128; chunk 1..256 and S a multiple of it; hb heads
// a block, dividing nh / G. grid: the (x, y, z) grids of the seven
// launches (dstate, reverse pass, source side, head side, query side,
// scan, reduce) from `ssd_bwd_plan`. Seven launches on `stream`. Returns
// a cudaError_t code.
extern "C" int ssd_scan_bwd(int dtype, int hd, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            const void* D, const void* states,
                            const void* acum, const void* cb, const void* dy,
                            const void* dh_final, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* dD, void* dh0,
                            void* dstates, void* dsplit, void* hsplit,
                            void* decay, void* dcb, void* vecs, void* dyx,
                            void* dBp, void* dCp, void* pA, void* pD, int b,
                            int S, int nh, int G, int N,
                            int chunk, int hb, int has_h0, const int* grid,
                            void* stream) {
  if (chunk <= 0 || chunk > MAX_Q || S % chunk != 0 || G <= 0 ||
      nh % G != 0 || N <= 0 || N % 16 != 0 || N > MAX_N || hb <= 0 ||
      hb > NW || (nh / G) % hb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || S == 0 || nh == 0) return 0;
  const BwdArgs a{x,      dt,     A,      B,     C,    D,    states,
                  acum,   cb,     dy,     dh_final, dx, ddt,  dA,
                  dB,     dC,     dD,     dh0,   dstates, dsplit, hsplit,
                  decay,  dcb,    vecs,   dyx,   dBp,  dCp,  pA,
                  pD,     b,      S,      nh,    G,    N,    chunk,
                  hb,     has_h0, grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_bwd<float>(hd, a, s);
  } else if (dtype == 1) {
    err = dispatch_bwd<__nv_bfloat16>(hd, a, s);
  }
  return static_cast<int>(err);
}
