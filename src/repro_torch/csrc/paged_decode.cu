// paged_decode and paged_insert: the two kernels of every decode step.
//
// paged_decode replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode/kernel.py (paged_decode, _kernel and
// _dbuf_kernel; the TPU's double-buffered DMA schedule computes the same
// function, so both map onto this one kernel): one query token per
// sequence, GQA, online softmax over the pages of the block table, masked
// by `lens`, optional soft cap.
//
// Bound on the H100: bytes. Each (sequence, kv head) reads its context's
// K and V once and does 4*G*hd flops per position, ~2 flops a byte in
// f32. So the kernel runs one block per (sequence, KV head): each K/V
// page is read once for all G query heads of its group, straight from the
// pool through the block table (no gather first), and the block walks
// only ceil(lens / page) table entries, so trash slots past the live
// length are never read. Pages are taken up to 64 rows at a time into
// shared memory; one warp per query head computes scores and the softmax
// update, then all threads fold the tile into the (G, hd) accumulator.
// With B * Hkv blocks (32 at the main path's B = 8, yi-6b) the card is
// far from full; splitting the context across blocks (flash-decoding)
// and vector loads are later work.
//
// paged_insert replaces src/repro/kernels/paged_decode/kernel.py
// (paged_insert, _insert_kernel): one block per sequence writes its new
// token's K and V row into pool page page_idx[b], row offset[b], in place.
// Idle decode slots all target the reserved trash page 0, so several
// blocks may write the same trash row at once: benign, and never a live
// page (the engine points every idle slot's table row at page 0).
#include "attn_common.cuh"

using namespace attn;

constexpr int DEC_NT = 128;            // 4 warps
constexpr int DEC_ROWS = 64;           // kv positions per tile (2 per lane)

template <int HD>
__host__ __device__ constexpr size_t decode_smem_floats(int G) {
  return (size_t)G * (HD + 1)          // Qs
         + (size_t)DEC_ROWS * (HD + 1)  // Ks
         + (size_t)DEC_ROWS * HD        // Vs
         + (size_t)G * DEC_ROWS         // Ps
         + (size_t)G * HD               // As: accumulators
         + 3 * (size_t)G;               // Ms, Ls, Cs
}

template <typename T, int HD>
__global__ void __launch_bounds__(DEC_NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ o, int H, int Hkv,
    int page, int pps, float scale, float softcap) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Qs = smem;
  float* Ks = Qs + G * (HD + 1);
  float* Vs = Ks + DEC_ROWS * (HD + 1);
  float* Ps = Vs + DEC_ROWS * HD;
  float* As = Ps + G * DEC_ROWS;
  float* Ms = As + G * HD;
  float* Ls = Ms + G;
  float* Cs = Ls + G;

  const T* qb = q + ((long long)b * H + (long long)kh * G) * HD;
  for (int idx = tid; idx < G * HD; idx += DEC_NT) {
    Qs[(idx / HD) * (HD + 1) + idx % HD] = to_f32(qb[idx]);
    As[idx] = 0.f;
  }
  for (int g = tid; g < G; g += DEC_NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  const int len = min(lens[b], pps * page);
  const int* tab = table + (long long)b * pps;
  const int rows = max(1, DEC_ROWS / page) * page;   // whole pages a tile
  const long long row_elems = (long long)Hkv * HD;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += rows) {
    for (int idx = tid; idx < rows * HD; idx += DEC_NT) {
      const int r = idx / HD, d = idx % HD, pos = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (pos < len) {
        const long long src = ((long long)tab[pos / page] * page + pos % page)
                              * row_elems + (long long)kh * HD + d;
        kx = to_f32(kp[src]);
        vx = to_f32(vp[src]);
      }
      Ks[r * (HD + 1) + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();
    // scores and the softmax update: one warp per query head
    for (int g = warp; g < G; g += DEC_NT / 32) {
      float sv[2];
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r = lane + 32 * t;
        float s = NEG_INF;
        if (r < rows) {
          float acc = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; ++d)
            acc = fmaf(Qs[g * (HD + 1) + d], Ks[r * (HD + 1) + d], acc);
          s = score_post(acc, scale, softcap);
          if (k0 + r >= len) s = NEG_INF;
        }
        sv[t] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r = lane + 32 * t;
        if (r < rows) {
          const float p = expf(sv[t] - m_new);
          Ps[g * DEC_ROWS + r] = p;
          rs += p;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + rs;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += DEC_NT) {
      const int g = idx / HD, d = idx % HD;
      float a = As[idx] * Cs[g];
      for (int r = 0; r < rows; ++r)
        a = fmaf(Ps[g * DEC_ROWS + r], Vs[r * HD + d], a);
      As[idx] = a;
    }
    __syncthreads();
  }
  T* ob = o + ((long long)b * H + (long long)kh * G) * HD;
  for (int idx = tid; idx < G * HD; idx += DEC_NT)
    ob[idx] = from_f32<T>(As[idx] / fmaxf(Ls[idx / HD], DEN_MIN));
}

template <typename T, int HD>
static cudaError_t launch_decode(const void* q, const void* kp,
                                 const void* vp, const void* table,
                                 const void* lens, void* o, int B, int H,
                                 int Hkv, int page, int pps, float scale,
                                 float softcap, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, HD>;
  const size_t bytes = decode_smem_floats<HD>(H / Hkv) * sizeof(float);
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  kern<<<grid, DEC_NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(o), H, Hkv, page, pps,
      scale, softcap);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. q/o (B, H, hd), pools (num_pages,
// page, Hkv, hd), table (B, pps) i32, lens (B,) i32, all contiguous.
// page must be <= 64. Returns a cudaError_t code.
extern "C" int paged_decode(int dtype, int hd, const void* q, const void* kp,
                            const void* vp, const void* table,
                            const void* lens, void* o, int B, int H, int Hkv,
                            int page, int pps, float scale, float softcap,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page > DEC_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    ATTN_DISPATCH_HD(hd, HD, err = launch_decode<float, HD>(
        q, kp, vp, table, lens, o, B, H, Hkv, page, pps, scale, softcap, s));
  } else if (dtype == 1) {
    ATTN_DISPATCH_HD(hd, HD, err = launch_decode<__nv_bfloat16, HD>(
        q, kp, vp, table, lens, o, B, H, Hkv, page, pps, scale, softcap, s));
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// paged_insert: element copy of one (Hkv, hd) row per sequence, in place.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void paged_insert_kernel(T* __restrict__ kp, T* __restrict__ vp,
                                    const T* __restrict__ kn,
                                    const T* __restrict__ vn,
                                    const int* __restrict__ page_idx,
                                    const int* __restrict__ offset, int page,
                                    int row_elems) {
  const int b = blockIdx.x;
  const long long dst =
      ((long long)page_idx[b] * page + offset[b]) * row_elems;
  const long long src = (long long)b * row_elems;
  for (int i = threadIdx.x; i < row_elems; i += blockDim.x) {
    kp[dst + i] = kn[src + i];
    vp[dst + i] = vn[src + i];
  }
}

// elem_bytes: 4 (float32) or 2 (bfloat16; copied as raw 16-bit words).
// k/v_new must already have the pools' dtype. Returns a cudaError_t code.
extern "C" int paged_insert(int elem_bytes, void* kp, void* vp,
                            const void* kn, const void* vn,
                            const void* page_idx, const void* offset, int B,
                            int page, int row_elems, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (elem_bytes == 4) {
    paged_insert_kernel<uint32_t><<<B, threads, 0, s>>>(
        static_cast<uint32_t*>(kp), static_cast<uint32_t*>(vp),
        static_cast<const uint32_t*>(kn), static_cast<const uint32_t*>(vn),
        static_cast<const int*>(page_idx), static_cast<const int*>(offset),
        page, row_elems);
  } else if (elem_bytes == 2) {
    paged_insert_kernel<uint16_t><<<B, threads, 0, s>>>(
        static_cast<uint16_t*>(kp), static_cast<uint16_t*>(vp),
        static_cast<const uint16_t*>(kn), static_cast<const uint16_t*>(vn),
        static_cast<const int*>(page_idx), static_cast<const int*>(offset),
        page, row_elems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
