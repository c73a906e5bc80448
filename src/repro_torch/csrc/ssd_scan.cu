// ssd_scan: the Mamba2 SSD chunked scan, y and the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan, _kernel). Per (batch, head), walking the chunks in order:
//   y   = (C.B^T o L).(x dt) + exp(a_cum) (C.h^T) + D x,
//         L[t, s] = exp(a_cum[t] - a_cum[s]) for s <= t, 0 above,
//   h  <- h exp(a_cum[-1]) + (x dt)^T . (B exp(a_cum[-1] - a_cum)),
// with a_cum the within-chunk cumulative sum of dt * A, and h (hd x N,
// f32) written out as h_final. x, B, C and y are f32 or bf16; dt, A, D,
// h0 and h_final are f32; all arithmetic is f32.
//
// Bound on the H100 at the main path's shape (b 1, S 2048 in 8 chunks of
// 256, 80 heads of hd 64, 1 group, N 128): the useful work is ~8.1 GFLOP
// (C.B^T over the causal pairs once per chunk and group, the three
// products per chunk and head) against ~89 MB in f32, so the f32 kernel
// is bound by operations (0.121 ms at 67 TF/s) and the bf16 one by bytes
// (~0.014 ms at 3.35 TB/s).
//
// Design. The TPU grid's sequential chunk axis becomes a loop inside one
// block per (batch, head) (80 blocks at b = 1, fewer than the 132 SMs);
// the state h stays in shared memory across the whole walk, as Pallas kept
// it in VMEM scratch. A chunk is any size from 1 up: prefill of an
// S-token prompt runs chunk = min(256, S), so nothing assumes a multiple
// of 16. At chunk 256 the B and C tiles and the 256 x 256 decay matrix
// would not fit a block's 227 KB, so a chunk is cut into 64-row query
// tiles and 64-row source tiles, and each tile's C.B^T and decay are
// computed on the fly for the causal pairs only: exp() is never taken of
// a positive exponent, so nothing overflows to inf and no inf * 0 makes a
// NaN. Rows past the chunk read as zero. Padded tail steps (dt = 0) decay
// by exp(0) = 1 and add nothing, so they are exact identities. C.B^T is
// recomputed for every head of a group (as the TPU kernel does), about
// twice the useful work at one group. Products run on the f32 CUDA cores
// from shared memory with register tiles; tensor cores, TMA and more
// blocks per head are later work.
#include "attn_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int TQ = 64;       // query rows per tile
constexpr int TS = 64;       // source rows per tile
constexpr int PS = TS + 1;   // row stride of the score tile
constexpr int MAX_N = 128;   // state dim: a multiple of 16 up to this

// Thread layout of a TQ x HD output tile: CX threads across the columns,
// RG thread rows; each thread holds RPT rows x CPT columns.
template <int HD>
struct YMap {
  static constexpr int CX = HD < 16 ? HD : 16;
  static constexpr int RG = NT / CX;
  static constexpr int RPT = TQ / RG;
  static constexpr int CPT = HD / CX;
};

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

// rows x cols tile from global rows (row stride `src_row` elements) into
// shared memory (row stride `ld`) as f32, times scale(r); rows at or past
// `valid` read as zero.
template <typename T, typename Scale>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long src_row, int rows,
                                          int cols, int valid, Scale scale) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ld + c] =
        r < valid ? to_f32(src[r * src_row + c]) * scale(r) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ hout, int S, int nh, int G, int N, int Q) {
  using M = YMap<HD>;
  extern __shared__ float smem[];
  const int NP = N + 1;                 // padded row: column reads spread
  float* hs = smem;                     // HD x NP   the carried state
  float* Cs = hs + HD * NP;             // TQ x NP   C rows of a query tile
  float* Bs = Cs + TQ * NP;             // TS x NP   B rows of a source tile
  float* Xs = Bs + TS * NP;             // TS x HD   x * dt (* decay)
  float* Ps = Xs + TS * HD;             // TQ x PS   (C.B^T o L) tile
  float* acum = Ps + TQ * PS;           // Q         a_cum of the chunk
  float* dts = acum + Q;                // Q         dt of the chunk
  float* wtot = dts + Q;                // NW        scan scratch

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / G);
  const float a_h = A[h], d_h = D[h];
  const long long xrow = (long long)nh * HD;   // x/y elements per step
  const long long brow = (long long)G * N;     // B/C elements per step
  const T* xb = x + (long long)b * S * xrow + (long long)h * HD;
  T* yb = y + (long long)b * S * xrow + (long long)h * HD;
  const T* Bb = Bm + (long long)b * S * brow + (long long)g * N;
  const T* Cb = Cm + (long long)b * S * brow + (long long)g * N;
  const float* dtb = dt + (long long)b * S * nh + h;
  const long long hoff = ((long long)b * nh + h) * HD * N;

  for (int e = tid; e < HD * N; e += NT) {
    const int d = e / N, n = e - d * N;
    hs[d * NP + n] = h0 != nullptr ? h0[hoff + e] : 0.f;
  }

  // output tile layout (YMap) and score tile layout (16 x 16, 4 x 4 each)
  const int ty = tid / M::CX, tx = tid % M::CX;
  const int sy = tid / 16, sx = tid % 16;
  // state layout: thread (dy, nx) holds d = dy + 16 i, n = nx + 16 j
  constexpr int DI = (HD + 15) / 16;
  const int dy = tid / 16, nx = tid % 16;
  const int nj = N / 16;

  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const long long c0 = (long long)c * Q;
    // -- dt and the within-chunk cumulative sum of dt * A ----------------
    float carry = 0.f;
    for (int base = 0; base < Q; base += NT) {
      const int t = base + tid;
      const float dtv = t < Q ? dtb[(c0 + t) * nh] : 0.f;
      const float v = block_scan(dtv * a_h, wtot) + carry;
      if (t < Q) {
        dts[t] = dtv;
        acum[t] = v;
      }
      carry += wtot[NW - 1];
      __syncthreads();
    }
    const float a_last = acum[Q - 1];
    const bool has_state = c > 0 || h0 != nullptr;

    // -- outputs, one query tile at a time --------------------------------
    for (int t0 = 0; t0 < Q; t0 += TQ) {
      load_tile(Cs, NP, Cb + (c0 + t0) * brow, brow, TQ, N, Q - t0,
                [](int) { return 1.f; });
      __syncthreads();
      float acc[M::RPT][M::CPT];
#pragma unroll
      for (int i = 0; i < M::RPT; ++i)
#pragma unroll
        for (int j = 0; j < M::CPT; ++j) acc[i][j] = 0.f;
      if (has_state) {
        // carried-in state: exp(a_cum[t]) * C_t . h^T
        for (int n = 0; n < N; ++n) {
          float cv[M::RPT], hv[M::CPT];
#pragma unroll
          for (int i = 0; i < M::RPT; ++i)
            cv[i] = Cs[(ty + M::RG * i) * NP + n];
#pragma unroll
          for (int j = 0; j < M::CPT; ++j)
            hv[j] = hs[(tx + M::CX * j) * NP + n];
#pragma unroll
          for (int i = 0; i < M::RPT; ++i)
#pragma unroll
            for (int j = 0; j < M::CPT; ++j) acc[i][j] += cv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < M::RPT; ++i) {
          const int t = t0 + ty + M::RG * i;
          const float dec = t < Q ? expf(acum[t]) : 0.f;
#pragma unroll
          for (int j = 0; j < M::CPT; ++j) acc[i][j] *= dec;
        }
      }
      // within the chunk: source tiles up to the diagonal
      const int s_end = min(t0 + TQ, Q);
      for (int s0 = 0; s0 < s_end; s0 += TS) {
        load_tile(Bs, NP, Bb + (c0 + s0) * brow, brow, TS, N, Q - s0,
                  [](int) { return 1.f; });
        load_tile(Xs, HD, xb + (c0 + s0) * xrow, xrow, TS, HD, Q - s0,
                  [&](int r) { return dts[s0 + r]; });
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(sy + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(sx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + sy + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + sx + 16 * j;
            // s <= t < Q: the causal pairs of real rows, exponent <= 0
            Ps[(sy + 16 * i) * PS + sx + 16 * j] =
                (s <= t && t < Q) ? sc[i][j] * expf(acum[t] - acum[s])
                                  : 0.f;
          }
        }
        __syncthreads();
        for (int k = 0; k < TS; ++k) {
          float pv[M::RPT], xv[M::CPT];
#pragma unroll
          for (int i = 0; i < M::RPT; ++i)
            pv[i] = Ps[(ty + M::RG * i) * PS + k];
#pragma unroll
          for (int j = 0; j < M::CPT; ++j) xv[j] = Xs[k * HD + tx + M::CX * j];
#pragma unroll
          for (int i = 0; i < M::RPT; ++i)
#pragma unroll
            for (int j = 0; j < M::CPT; ++j) acc[i][j] += pv[i] * xv[j];
        }
        __syncthreads();   // Bs, Xs, Ps (and Cs after the last) reused
      }
#pragma unroll
      for (int i = 0; i < M::RPT; ++i) {
        const int t = t0 + ty + M::RG * i;
        if (t >= Q) continue;
        const long long row = (c0 + t) * xrow;
#pragma unroll
        for (int j = 0; j < M::CPT; ++j) {
          const int d = tx + M::CX * j;
          yb[row + d] = from_f32<T>(acc[i][j] + d_h * to_f32(xb[row + d]));
        }
      }
    }

    // -- chunk-end state: h exp(a_last) + (x dt)^T (B exp(a_last - a_cum))
    float st[DI][MAX_N / 16];
#pragma unroll
    for (int i = 0; i < DI; ++i)
#pragma unroll
      for (int j = 0; j < MAX_N / 16; ++j) st[i][j] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += TS) {
      load_tile(Bs, NP, Bb + (c0 + s0) * brow, brow, TS, N, Q - s0,
                [](int) { return 1.f; });
      load_tile(Xs, HD, xb + (c0 + s0) * xrow, xrow, TS, HD, Q - s0,
                [&](int r) {
                  return dts[s0 + r] * expf(a_last - acum[s0 + r]);
                });
      __syncthreads();
      for (int k = 0; k < TS; ++k) {
        float xv[DI], bv[MAX_N / 16];
#pragma unroll
        for (int i = 0; i < DI; ++i) {
          const int d = dy + 16 * i;
          xv[i] = d < HD ? Xs[k * HD + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MAX_N / 16; ++j)
          bv[j] = j < nj ? Bs[k * NP + nx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < DI; ++i)
#pragma unroll
          for (int j = 0; j < MAX_N / 16; ++j) st[i][j] += xv[i] * bv[j];
      }
      __syncthreads();
    }
    // every read of hs for this chunk's outputs is behind the barriers
    const float dec = expf(a_last);
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = dy + 16 * i;
      if (d >= HD) continue;
#pragma unroll
      for (int j = 0; j < MAX_N / 16; ++j) {
        if (j >= nj) continue;
        float* p = hs + d * NP + nx + 16 * j;
        *p = *p * dec + st[i][j];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < HD * N; e += NT) {
    const int d = e / N, n = e - d * N;
    hout[hoff + e] = hs[d * NP + n];
  }
}

size_t smem_bytes(int hd, int N, int Q) {
  const size_t NP = N + 1;
  const size_t floats = hd * NP + TQ * NP + TS * NP + (size_t)TS * hd +
                        (size_t)TQ * PS + 2 * (size_t)Q + NW;
  return floats * sizeof(float);
}

template <typename T, int HD>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* h0, void* y, void* hout, int b, int S, int nh,
                   int G, int N, int Q, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T, HD>;
  const size_t bytes = smem_bytes(HD, N, Q);
  cudaError_t err = attn::allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(nh, b);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hout), S, nh, G, N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* D,
                     const void* h0, void* y, void* hout, int b, int S,
                     int nh, int G, int N, int Q, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(x, dt, A, B, C, D, h0, y, hout, b, S, nh, G, N, Q, s);
    case 16: return launch<T, 16>(x, dt, A, B, C, D, h0, y, hout, b, S, nh, G, N, Q, s);
    case 32: return launch<T, 32>(x, dt, A, B, C, D, h0, y, hout, b, S, nh, G, N, Q, s);
    case 64: return launch<T, 64>(x, dt, A, B, C, D, h0, y, hout, b, S, nh, G, N, Q, s);
    case 128: return launch<T, 128>(x, dt, A, B, C, D, h0, y, hout, b, S, nh, G, N, Q, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). x, y: (b, S, nh, hd);
// dt: (b, S, nh) f32; A, D: (nh,) f32; B, C: (b, S, G, N); h0 (may be
// null for zeros) and hout: (b, nh, hd, N) f32; all contiguous. hd in
// {8, 16, 32, 64, 128}; N a multiple of 16 up to 128; S a multiple of
// chunk. Returns a cudaError_t code.
extern "C" int ssd_scan(int dtype, int hd, const void* x, const void* dt,
                        const void* A, const void* B, const void* C,
                        const void* D, const void* h0, void* y, void* hout,
                        int b, int S, int nh, int G, int N, int chunk,
                        void* stream) {
  if (chunk <= 0 || S % chunk != 0 || G <= 0 || nh % G != 0 || N <= 0 ||
      N % 16 != 0 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || S == 0 || nh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch<float>(hd, x, dt, A, B, C, D, h0, y, hout, b, S, nh, G,
                          N, chunk, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(hd, x, dt, A, B, C, D, h0, y, hout, b, S,
                                  nh, G, N, chunk, s);
  }
  return static_cast<int>(err);
}

