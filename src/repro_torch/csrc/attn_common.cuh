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

// The head dim an instance runs (ATTN_DISPATCH_HD): its HD, a
// compile-time constant, unless it is a padded instance, which takes the
// caller's hd < HD.
template <int HD, bool PAD>
__device__ __forceinline__ int head_dim(int hd) {
  return PAD ? hd : HD;
}

}  // namespace attn

// Dispatch a head dim known at run time onto the compiled instances HD of
// 16, 32, 64, 128 and 256. A head dim hd that is a multiple of 16 and at
// most 256 runs on the smallest instance HD >= hd: hd == HD on the exact
// instance (PAD false), where the head dim is the compile-time HD; any
// other hd on the padded one (PAD true), which takes hd at run time,
// addresses global rows in hd, zero-fills the columns past hd on every
// load into shared memory and masks them on every store (hd = 112 runs on
// the padded 128 instance, 144..240 on the padded 256 one). Any other hd
// is refused. kernels/build.py::head_dim_instance states the same rule.
#define ATTN_DISPATCH_HD(hd, HD, PAD, ...)                                 \
  do {                                                                     \
    if ((hd) < 16 || (hd) > 256 || (hd) % 16 != 0)                         \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    if ((hd) == 16) {                                                      \
      constexpr int HD = 16; constexpr bool PAD = false; __VA_ARGS__;      \
    } else if ((hd) == 32) {                                               \
      constexpr int HD = 32; constexpr bool PAD = false; __VA_ARGS__;      \
    } else if ((hd) == 64) {                                               \
      constexpr int HD = 64; constexpr bool PAD = false; __VA_ARGS__;      \
    } else if ((hd) == 128) {                                              \
      constexpr int HD = 128; constexpr bool PAD = false; __VA_ARGS__;     \
    } else if ((hd) == 256) {                                              \
      constexpr int HD = 256; constexpr bool PAD = false; __VA_ARGS__;     \
    } else if ((hd) < 64) {                                                \
      constexpr int HD = 64; constexpr bool PAD = true; __VA_ARGS__;       \
    } else if ((hd) < 128) {                                               \
      constexpr int HD = 128; constexpr bool PAD = true; __VA_ARGS__;      \
    } else {                                                               \
      constexpr int HD = 256; constexpr bool PAD = true; __VA_ARGS__;      \
    }                                                                      \
  } while (0)
