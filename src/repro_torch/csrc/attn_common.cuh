// Shared pieces of the port's attention kernels for Hopper (sm_90a):
// storage-type conversion, the finite masking constants of the JAX
// kernels, and the online-softmax tile update used by flash_prefill and
// prefix_prefill.
//
// Numerics follow the Pallas kernels exactly: masked scores are the finite
// NEG_INF (not -inf), so a leading fully-masked tile contributes exp(0)
// and is wiped by corr = exp(NEG_INF - m) = 0 once a real score arrives;
// the final denominator clamps at 1e-37. All math is f32, whatever the
// storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -2.3819763e38f;
constexpr float DEN_MIN = 1e-37f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// s * scale, then the optional tanh soft cap (same order as the JAX code).
__device__ __forceinline__ float score_post(float s, float scale,
                                            float softcap) {
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return s;
}

// ---------------------------------------------------------------------------
// Tiled prefill attention (flash_prefill, prefix_prefill).
//
// One block of NT = 256 threads owns a BQ = 64-row query tile of one
// (batch, head). The threads form a 16 x 16 grid: ty = tid / 16 owns query
// rows 4*ty .. 4*ty+3; tx = tid % 16 owns score columns tx + 16*j (j < 4)
// of the BKV = 64-row kv tile and output columns tx + 16*c (c < HD/16).
// The 16 threads that share a row are one half-warp, so row max and row
// sum are xor-shuffles over offsets 8..1. Tiles sit in shared memory as
// f32; Q and K rows are padded by one float so the column reads of the
// score loop hit 16 different banks.
// ---------------------------------------------------------------------------
constexpr int NT = 256;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int RPT = 4;   // query rows per thread
constexpr int CPT = 4;   // score columns per thread

template <int HD>
struct Smem {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int QS = HD + 1;
  static constexpr int KS = HD + 1;
  static constexpr int VS = HD;
  static constexpr int PS = BKV + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QS;
  static constexpr int V_OFF = K_OFF + BKV * KS;
  static constexpr int P_OFF = V_OFF + BKV * VS;
  static constexpr int FLOATS = P_OFF + BQ * PS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int HD>
struct TileState {
  float m[RPT];
  float l[RPT];
  float acc[RPT][HD / 16];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
    }
  }
};

// Fill `nrows` rows of a shared-memory tile (row stride `stride` floats)
// from global memory. `row(r)` returns the row's first element, or nullptr
// for a row past the data (filled with zeros; the mask hides it).
template <int HD, typename T, typename RowFn>
__device__ __forceinline__ void load_rows(float* dst, int stride, int nrows,
                                          RowFn row) {
  for (int idx = threadIdx.x; idx < nrows * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const T* src = row(r);
    dst[r * stride + d] = src ? to_f32(src[d]) : 0.f;
  }
}

// One online-softmax step over the kv tile in Ks/Vs (already loaded and
// synchronised). `visible(r, c)` is the mask of query row r, kv column c
// (tile-local). Ends with a barrier, so the caller may reload Ks/Vs.
template <int HD, typename MaskFn>
__device__ __forceinline__ void attend_tile(TileState<HD>& st,
                                            const float* Qs, const float* Ks,
                                            const float* Vs, float* Ps,
                                            float scale, float softcap,
                                            MaskFn visible) {
  using L = Smem<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[RPT], kv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * L::QS + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * L::KS + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float v = score_post(s[i][j], scale, softcap);
      if (!visible(r, tx + 16 * j)) v = NEG_INF;
      s[i][j] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    const float corr = expf(st.m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(s[i][j] - m_new);
      Ps[r * L::PS + tx + 16 * j] = p;
      rs += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    st.l[i] = st.l[i] * corr + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) st.acc[i][c] *= corr;
  }
  __syncthreads();
  for (int kk = 0; kk < BKV; ++kk) {
    float pv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * L::PS + kk];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float vv = Vs[kk * L::VS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) st.acc[i][c] = fmaf(pv[i], vv, st.acc[i][c]);
    }
  }
  __syncthreads();
}

// Write the finished query tile: acc / max(l, 1e-37), rows < n_valid only.
template <int HD, typename T, typename RowFn>
__device__ __forceinline__ void store_tile(const TileState<HD>& st,
                                           int n_valid, RowFn row) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    if (r >= n_valid) continue;
    T* dst = row(r);
    const float den = fmaxf(st.l[i], DEN_MIN);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
      dst[tx + 16 * c] = from_f32<T>(st.acc[i][c] / den);
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above the 48 KB
// static limit) and report the first failure.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn

// Dispatch a head dim known at run time onto the compiled instances.
#define ATTN_DISPATCH_HD(hd, HD, ...)           \
  switch (hd) {                                 \
    case 16: { constexpr int HD = 16; __VA_ARGS__; break; }   \
    case 32: { constexpr int HD = 32; __VA_ARGS__; break; }   \
    case 64: { constexpr int HD = 64; __VA_ARGS__; break; }   \
    case 128: { constexpr int HD = 128; __VA_ARGS__; break; } \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }
