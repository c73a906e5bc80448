// Shared pieces of the port's kernels for Hopper (sm_90a): storage-type
// conversion, the finite masking constants of the JAX attention kernels,
// the soft cap, the dynamic shared-memory opt-in and the head-dim
// dispatch. The tiles themselves are in attn_mma.cuh (bf16, mma.sync),
// attn_wgmma.cuh (bf16, wgmma + TMA) and attn_simt.cuh (f32).
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
