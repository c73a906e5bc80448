// flash_prefill: blocked online-softmax attention over dense Q/K/V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill/kernel.py
// (flash_prefill, _kernel): causal or not, GQA through the kv head index,
// sliding window, soft cap, and the offset mask kpos <= (Skv - Sq) + qpos
// when Sq < Skv.
//
// Bound on the H100: at the main path's shapes (yi-6b, S = 1024, hd 128)
// the work is ~4*S*S/2*hd*H flops against ~4*S*H*hd*4 bytes, far above the
// card's ridge, so it is bound by operations. This first kernel runs the
// two products on the f32 CUDA cores (67 TF/s peak), not the tensor cores:
// it keeps one 64-row Q tile resident in shared memory, streams 64-row K/V
// tiles past it, register-blocks a 4 x 4 score tile and a 4 x (hd/16)
// output tile per thread, and skips kv tiles that lie wholly above the
// causal diagonal or wholly before the window. Tensor cores (mma/wgmma on
// bf16 tiles) and TMA loads are later work.
//
// The TPU grid's sequential kv axis becomes a loop inside the block; the
// (m, l, acc) state that Pallas kept in VMEM scratch lives in registers.
// Any layout is taken through strides (last dim contiguous), so the
// model's (B, S, H, hd) tensors are read without a transpose.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    int H, int Hkv, int Sq, int Skv, int causal, int window, float scale,
    float softcap) {
  using L = Smem<HD>;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ps = smem + L::P_OFF;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  T* ob = o + b * osb + h * osh;

  load_rows<HD, T>(Qs, L::QS, BQ, [&](int r) -> const T* {
    return q0 + r < Sq ? qb + (long long)(q0 + r) * qss : nullptr;
  });

  TileState<HD> st;
  st.init();
  const int off = Skv - Sq;                       // offset of query row 0
  const int q_hi = min(q0 + BQ, Sq) - 1;          // last real row
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, off + q_hi + 1);  // tiles above: skipped
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, off + q0 - window + 1);
  kv_begin = (kv_begin / BKV) * BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    load_rows<HD, T>(Ks, L::KS, BKV, [&](int r) -> const T* {
      return k0 + r < Skv ? kb + (long long)(k0 + r) * kss : nullptr;
    });
    load_rows<HD, T>(Vs, L::VS, BKV, [&](int r) -> const T* {
      return k0 + r < Skv ? vb + (long long)(k0 + r) * vss : nullptr;
    });
    __syncthreads();
    attend_tile<HD>(st, Qs, Ks, Vs, Ps, scale, softcap, [&](int r, int c) {
      const int qp = off + q0 + r, kp = k0 + c;
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      return ok;
    });
  }
  store_tile<HD, T>(st, Sq - q0, [&](int r) -> T* {
    return ob + (long long)(q0 + r) * oss;
  });
}

template <typename T, int HD>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, const long long* st, int B, int H,
                          int Hkv, int Sq, int Skv, int causal, int window,
                          float scale, float softcap, cudaStream_t stream) {
  auto kern = flash_prefill_kernel<T, HD>;
  const size_t bytes = Smem<HD>::BYTES;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], H,
      Hkv, Sq, Skv, causal, window, scale, softcap);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, seq) for each of q, k, v, o. Returns a cudaError_t code.
extern "C" int flash_prefill(int dtype, int hd, const void* q, const void* k,
                             const void* v, void* o, const long long* strides,
                             int B, int H, int Hkv, int Sq, int Skv,
                             int causal, int window, float scale,
                             float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    ATTN_DISPATCH_HD(hd, HD, err = launch<float, HD>(
        q, k, v, o, strides, B, H, Hkv, Sq, Skv, causal, window, scale,
        softcap, s));
  } else if (dtype == 1) {
    ATTN_DISPATCH_HD(hd, HD, err = launch<__nv_bfloat16, HD>(
        q, k, v, o, strides, B, H, Hkv, Sq, Skv, causal, window, scale,
        softcap, s));
  }
  return static_cast<int>(err);
}
