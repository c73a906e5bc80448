// prefix_prefill: suffix queries attend over prefix KV read straight from
// the paged pool, then over their own suffix KV, with one online-softmax
// state across both phases.
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefix_prefill/kernel.py
// (prefix_prefill, _kernel and _dbuf_kernel; the TPU's double-buffered DMA
// schedule computes the same function, so both map onto this one kernel).
//
// Bound on the H100: at the main path's shapes (yi-6b, a 512-token suffix
// over a 1024-token prefix, hd 128) the products dominate the bytes by
// far, so it is bound by operations. Like flash_prefill this first kernel
// computes on the f32 CUDA cores: one 64-row Q tile stays in shared
// memory while 64-position K/V tiles stream past. Phase 1 gathers each
// tile row by row through the block table (no dense prefix is ever
// materialised) and walks only ceil(prefix_len / 64) tiles, so
// trash-padded table slots beyond the live prefix are never read. Phase 2
// walks the suffix under the local causal mask and skips tiles wholly
// above the diagonal. Tensor cores and TMA loads are later work.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int HD>
__global__ void __launch_bounds__(NT) prefix_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ ks,
    const T* __restrict__ vs, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ plens, const int* __restrict__ slens,
    T* __restrict__ o,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    int H, int Hkv, int Sq, int page, int npp, float scale, float softcap) {
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
  T* ob = o + b * osb + h * osh;

  load_rows<HD, T>(Qs, L::QS, BQ, [&](int r) -> const T* {
    return q0 + r < Sq ? qb + (long long)(q0 + r) * qss : nullptr;
  });

  TileState<HD> st;
  st.init();

  // phase 1: the live prefix, gathered through the block table
  const int* tab = table + (long long)b * npp;
  const int plen = min(plens[b], npp * page);
  const long long row_elems = (long long)Hkv * HD;
  for (int k0 = 0; k0 < plen; k0 += BKV) {
    auto pool_row = [&](const T* pool, int r) -> const T* {
      const int pos = k0 + r;
      if (pos >= plen) return nullptr;
      const long long slot = (long long)tab[pos / page] * page + pos % page;
      return pool + slot * row_elems + (long long)kh * HD;
    };
    load_rows<HD, T>(Ks, L::KS, BKV, [&](int r) { return pool_row(kp, r); });
    load_rows<HD, T>(Vs, L::VS, BKV, [&](int r) { return pool_row(vp, r); });
    __syncthreads();
    attend_tile<HD>(st, Qs, Ks, Vs, Ps, scale, softcap,
                    [&](int, int c) { return k0 + c < plen; });
  }

  // phase 2: the suffix itself, local causal (every suffix query already
  // sees the whole prefix, so the offset cancels)
  const int slen = slens[b];
  const int q_hi = min(q0 + BQ, Sq) - 1;
  const int kv_end = min(min(slen, Sq), q_hi + 1);
  const T* kb = ks + b * ksb + kh * ksh;
  const T* vb = vs + b * vsb + kh * vsh;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    load_rows<HD, T>(Ks, L::KS, BKV, [&](int r) -> const T* {
      return k0 + r < Sq ? kb + (long long)(k0 + r) * kss : nullptr;
    });
    load_rows<HD, T>(Vs, L::VS, BKV, [&](int r) -> const T* {
      return k0 + r < Sq ? vb + (long long)(k0 + r) * vss : nullptr;
    });
    __syncthreads();
    attend_tile<HD>(st, Qs, Ks, Vs, Ps, scale, softcap, [&](int r, int c) {
      const int kpos = k0 + c;
      return kpos <= q0 + r && kpos < slen;
    });
  }
  store_tile<HD, T>(st, Sq - q0, [&](int r) -> T* {
    return ob + (long long)(q0 + r) * oss;
  });
}

template <typename T, int HD>
static cudaError_t launch(const void* q, const void* ks, const void* vs,
                          const void* kp, const void* vp, const void* table,
                          const void* plens, const void* slens, void* o,
                          const long long* st, int B, int H, int Hkv, int Sq,
                          int page, int npp, float scale, float softcap,
                          cudaStream_t stream) {
  auto kern = prefix_prefill_kernel<T, HD>;
  const size_t bytes = Smem<HD>::BYTES;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ks),
      static_cast<const T*>(vs), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(plens), static_cast<const int*>(slens),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], H, Hkv, Sq, page, npp, scale,
      softcap);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, seq) for each of q, k_suf, v_suf, o; the pools are contiguous
// (num_pages, page, Hkv, hd). Returns a cudaError_t code.
extern "C" int prefix_prefill(int dtype, int hd, const void* q,
                              const void* ks, const void* vs, const void* kp,
                              const void* vp, const void* table,
                              const void* plens, const void* slens, void* o,
                              const long long* strides, int B, int H,
                              int Hkv, int Sq, int page, int npp, float scale,
                              float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    ATTN_DISPATCH_HD(hd, HD, err = launch<float, HD>(
        q, ks, vs, kp, vp, table, plens, slens, o, strides, B, H, Hkv, Sq,
        page, npp, scale, softcap, s));
  } else if (dtype == 1) {
    ATTN_DISPATCH_HD(hd, HD, err = launch<__nv_bfloat16, HD>(
        q, ks, vs, kp, vp, table, plens, slens, o, strides, B, H, Hkv, Sq,
        page, npp, scale, softcap, s));
  }
  return static_cast<int>(err);
}
