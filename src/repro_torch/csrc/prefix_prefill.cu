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
// far, so it is bound by operations: 989 TF/s in bf16 on the tensor
// cores, 67 TF/s in f32 on the CUDA cores. One block owns a 64-row Q tile
// of one (batch, head) and walks 64-row K/V tiles: phase 1 over the live
// prefix, each row addressed through tab[pos / page] (no dense prefix is
// ever materialised; only ceil(prefix_len / 64) tiles, so trash-padded
// table slots are never read), phase 2 over the suffix under the local
// causal mask and the ragged suffix_lens, skipping tiles wholly above the
// diagonal. Every tile is copied with 16-byte cp.async into a ring in
// shared memory, so the next tiles are in flight while one is computed;
// the live block-table entries are staged in shared memory first.
//
// bf16 runs on the tensor cores (attn_mma.cuh: mma.sync m16n8k16, Q in
// registers, P.V from registers). Where H / Hkv is even a block serves
// two query heads of one kv head (8 warps, a three-stage ring, 139 KB of
// shared memory at hd 128, one block per SM by its ~220 registers a
// thread), so each K/V tile it copies feeds twice the rows. P is rounded
// to bf16 before P.V, as SDPA does; the TPU kernel multiplies in f32
// (kernel.py:63, 70-71): about 2^-9 of |o| more error, inside the 3e-2
// tolerance. f32 stays on the CUDA cores in full precision
// (attn_simt.cuh: 8 x 4 score and 8 x hd/16 output register tiles with
// float4 reads; a two-stage ring; 184 KB, one block of 4 warps per SM).
//
// Head dims as flash_prefill.cu: instances of 16..256, a head dim below
// its instance reads zeros in its padding columns and never stores them.
// At hd 256 the bf16 ring has two stages and the f32 ring one, to stay
// within a block's 227 KB of shared memory.
#include "attn_simt.cuh"

using namespace attn;
using bf16 = __nv_bfloat16;

// Everything a block needs to find its rows, shared by both kernels.
template <typename T>
struct PrefixArgs {
  const T *q, *ks, *vs, *kp, *vp;
  const int *table, *plens, *slens;
  T* o;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int H, Hkv, Sq, page, npp;
  float scale, softcap;
  int hd;           // the head dim; the instance's HD >= hd (attn_common)
};

// The block's walk: n1 prefix tiles, then n2 suffix tiles. The live
// part of the block table is staged in shared memory (`tab_s`, one read
// of each entry), so the copies of a prefix tile wait on no global load.
template <typename T, int HD, bool PAD>
struct PrefixWalk {
  const T *qb, *kb, *vb, *kp, *vp;
  T* ob;
  const int* tab;
  int* tab_s;
  int q0, kh, plen, slen, kv_end, n1, nt, page_shift, hd;
  long long row_elems;

  // The block serves query heads blockIdx.y * qh .. + qh - 1, all of one
  // kv head (qh divides H / Hkv); qb and ob point at the first.
  __device__ PrefixWalk(const PrefixArgs<T>& a, int bq, int qh,
                        int* tab_smem) {
    tab_s = tab_smem;
    hd = head_dim<HD, PAD>(a.hd);
    q0 = blockIdx.x * bq;
    const int h = blockIdx.y * qh, b = blockIdx.z;
    kh = h / (a.H / a.Hkv);
    qb = a.q + b * a.qsb + h * a.qsh;
    ob = a.o + b * a.osb + h * a.osh;
    // pos / page as a shift when the page is a power of two
    page_shift = __popc(a.page) == 1 ? __ffs(a.page) - 1 : -1;
    kb = a.ks + b * a.ksb + kh * a.ksh;
    vb = a.vs + b * a.vsb + kh * a.vsh;
    kp = a.kp;
    vp = a.vp;
    tab = a.table + (long long)b * a.npp;
    plen = min(a.plens[b], a.npp * a.page);
    slen = a.slens[b];
    // suffix keys past kv_end are masked for every row of this tile
    kv_end = max(0, min(min(slen, a.Sq), min(q0 + bq, a.Sq)));
    n1 = (plen + 63) / 64;
    nt = n1 + (kv_end + 63) / 64;
    row_elems = (long long)a.Hkv * hd;
  }

  // Stage the live table entries; the caller synchronises before issue().
  __device__ __forceinline__ void stage_table(const PrefixArgs<T>& a,
                                              int nthr) const {
    for (int i = threadIdx.x; i < (plen + a.page - 1) / a.page; i += nthr)
      tab_s[i] = tab[i];
  }

  // Whether every column of walk tile t is visible to every query row
  // from tile-local row r0 on (a warp asks for its own 16 rows).
  __device__ __forceinline__ bool full(int t, int r0) const {
    if (t < n1) return t * 64 + 64 <= plen;
    const int k0 = (t - n1) * 64;
    return k0 + 63 <= q0 + r0 && k0 + 64 <= slen;
  }

  // Issue the copies of walk tile t into the given K/V buffers.
  template <int NTHR>
  __device__ __forceinline__ void issue(const PrefixArgs<T>& a, int t,
                                        T* kd, T* vd, int ks, int vs) const {
    if (t < n1) {
      const int k0 = t * 64;
      copy_kv_rows<T, HD, 64, NTHR>(kd, vd, ks, vs, kp, vp, hd,
                                    [&](int r) {
        const int pos = k0 + r;
        if (pos >= plen) return RowSrc{0, 0, false};
        const int pi = page_shift >= 0 ? pos >> page_shift : pos / a.page;
        const long long off =
            ((long long)tab_s[pi] * a.page + pos - pi * a.page) * row_elems +
            (long long)kh * hd;
        return RowSrc{off, off, true};
      });
    } else {
      const int k0 = (t - n1) * 64;
      copy_kv_rows<T, HD, 64, NTHR>(kd, vd, ks, vs, kb, vb, hd,
                                    [&](int r) {
        const long long pos = k0 + r;
        if (pos >= kv_end) return RowSrc{0, 0, false};
        return RowSrc{pos * a.kss, pos * a.vss, true};
      });
    }
  }

  // Issue the copies of the block's qh Q tiles (rows past Sq and columns
  // past hd zero-filled); head i goes to Qs + i * tile.
  template <int NTHR>
  __device__ __forceinline__ void issue_q(const PrefixArgs<T>& a, T* Qs,
                                          int qs, int qh, int tile) const {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = HD / EPC;
    const int c = (threadIdx.x % CPR) * EPC;
    for (int i = 0; i < qh; ++i)
      for (int r = threadIdx.x / CPR; r < 64; r += NTHR / CPR) {
        T* dst = Qs + i * tile + r * qs + c;
        if (q0 + r < a.Sq && c < hd)
          cp_async16(dst, qb + i * a.qsh + (long long)(q0 + r) * a.qss + c);
        else
          zero16(dst);
      }
  }
};

// Stages of the bf16 kernel's K/V ring: QH + 1, but two at hd 256, where
// a 64-row tile is 33 KB (three stages and two Q tiles would take 264 KB,
// over the 227 KB a block may have).
template <int HD, int QH>
__host__ __device__ constexpr int mma_stages() {
  return HD > 128 ? 2 : QH + 1;
}

// QH query heads of one kv head a block (4 warps each), so every K/V
// tile copied serves QH x 64 query rows: at QH = 2 the copies move half
// the bytes of one head a block. The ring has QH + 1 stages: at QH = 2
// (one block per SM by registers) tile t + 2 is in flight while tile t
// is computed; at QH = 1 two stages keep two blocks per SM.
template <int HD, int QH, bool PAD>
__global__ void __launch_bounds__(MMA_NT * QH, QH == 1 ? 2 : 1)
    prefix_prefill_mma_kernel(const PrefixArgs<bf16> a) {
  using L = MmaSmem<HD>;
  constexpr int NTHR = MMA_NT * QH;
  constexpr int STAGES = mma_stages<HD, QH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + QH * L::TILE;
  bf16* Vs = Ks + STAGES * L::TILE;
  const PrefixWalk<bf16, HD, PAD> w(
      a, MMA_BQ, QH,
      reinterpret_cast<int*>(smem_raw + L::bytes(QH, STAGES)));
  const int warp = threadIdx.x / 32;
  const int hq = warp / 4;                        // the warp's query head
  const int wr0 = (warp % 4) * 16;                // and its first row
  auto issue = [&](int t) {
    if (t < w.nt)
      w.template issue<NTHR>(a, t, Ks + (t % STAGES) * L::TILE,
                             Vs + (t % STAGES) * L::TILE, L::STRIDE,
                             L::STRIDE);
    cp_async_commit();     // one group a tile, empty past the walk
  };

  w.stage_table(a, NTHR);
  __syncthreads();
  w.template issue_q<NTHR>(a, Qs, L::STRIDE, QH, L::TILE);
  for (int t = 0; t < STAGES - 1; ++t) issue(t);   // Q joins tile 0
  MmaState<HD> st;
  st.init();
  for (int t = 0; t < w.nt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();       // tile t landed; tile t - 1's stage is free
    if (t == 0) st.load_q(Qs + hq * L::TILE + wr0 * L::STRIDE);
    issue(t + STAGES - 1);
    const bf16* kt = Ks + (t % STAGES) * L::TILE;
    const bf16* vt = Vs + (t % STAGES) * L::TILE;
    if (t < w.n1) {
      const int k0 = t * 64;
      mma_attend<HD>(st, kt, vt, a.scale, a.softcap, w.full(t, wr0),
                     [&](int, int c) { return k0 + c < w.plen; });
    } else {
      const int k0 = (t - w.n1) * 64;
      const int qr0 = w.q0 + wr0;
      mma_attend<HD>(st, kt, vt, a.scale, a.softcap, w.full(t, wr0),
                     [&](int r, int c) {
                       const int kpos = k0 + c;
                       return kpos <= qr0 + r && kpos < w.slen;
                     });
    }
  }
  cp_async_wait<0>();
  bf16* ob = w.ob + hq * a.osh;
  mma_store<HD>(st, a.Sq - w.q0 - wr0, w.hd, [&](int r) {
    return ob + (long long)(w.q0 + wr0 + r) * a.oss;
  });
}

template <int HD, bool PAD>
__global__ void __launch_bounds__(SIMT_NT)
    prefix_prefill_simt_kernel(const PrefixArgs<float> a) {
  using L = SimtSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Qs = sm + L::Q_OFF;
  float* Ks = sm + L::K_OFF;
  float* Vs = sm + L::V_OFF;
  float* Ps = sm + L::P_OFF;
  const PrefixWalk<float, HD, PAD> w(
      a, SIMT_BQ, 1, reinterpret_cast<int*>(smem_raw + L::BYTES));

  w.stage_table(a, SIMT_NT);
  __syncthreads();
  w.template issue_q<SIMT_NT>(a, Qs, L::QS, 1, 0);
  auto issue = [&](int t) {
    if (t < w.nt)
      w.template issue<SIMT_NT>(a, t, Ks + (t % L::STAGES) * SIMT_BKV * L::KS,
                                Vs + (t % L::STAGES) * SIMT_BKV * L::VS,
                                L::KS, L::VS);
    cp_async_commit();
  };
  issue(0);                // Q joins tile 0
  SimtState<HD> st;
  st.init();
  for (int t = 0; t < w.nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();       // tile t landed; tile t - 1's buffers are free
    if (L::STAGES == 2) issue(t + 1);   // in flight while t is computed
    const float* kt = Ks + (t % L::STAGES) * SIMT_BKV * L::KS;
    const float* vt = Vs + (t % L::STAGES) * SIMT_BKV * L::VS;
    if (t < w.n1) {
      const int k0 = t * 64;
      simt_attend<HD>(st, Qs, kt, vt, Ps, a.scale, a.softcap,
                      w.full(t, 0),
                      [&](int, int c) { return k0 + c < w.plen; });
    } else {
      const int k0 = (t - w.n1) * 64;
      simt_attend<HD>(st, Qs, kt, vt, Ps, a.scale, a.softcap, w.full(t, 0),
                      [&](int r, int c) {
                        const int kpos = k0 + c;
                        return kpos <= w.q0 + r && kpos < w.slen;
                      });
    }
    if (L::STAGES == 1) {  // one stage: the copy waits for the tile's use
      __syncthreads();
      issue(t + 1);
    }
  }
  cp_async_wait<0>();
  simt_store<HD>(st, a.Sq - w.q0, w.hd, [&](int r) {
    return w.ob + (long long)(w.q0 + r) * a.oss;
  });
}

template <typename T>
static PrefixArgs<T> make_args(const void* q, const void* ks, const void* vs,
                               const void* kp, const void* vp,
                               const void* table, const void* plens,
                               const void* slens, void* o,
                               const long long* st, int H, int Hkv, int Sq,
                               int page, int npp, float scale,
                               float softcap, int hd) {
  return PrefixArgs<T>{
      static_cast<const T*>(q), static_cast<const T*>(ks),
      static_cast<const T*>(vs), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(plens), static_cast<const int*>(slens),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], H, Hkv, Sq, page, npp, scale,
      softcap, hd};
}

// Tiles, then the staged table (npp ints, rounded up to 16 bytes); qh
// query heads and 128 * qh threads a block.
template <typename K, typename A>
static cudaError_t launch(K kern, size_t tile_bytes, int qh, const A& args,
                          int B, int H, int Sq, cudaStream_t stream) {
  const size_t bytes = tile_bytes + ((size_t)args.npp * 4 + 15) / 16 * 16;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 63) / 64, H / qh, B);
  kern<<<grid, 128 * qh, bytes, stream>>>(args);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, seq) for each of q, k_suf, v_suf, o; the pools are contiguous
// (num_pages, page, Hkv, hd). q, k_suf, v_suf and the pools must start on
// 16 bytes and their row strides be multiples of 16 bytes (the wrapper
// checks). hd: a multiple of 16 up to 256 (attn_common.cuh). Returns a
// cudaError_t code.
extern "C" int prefix_prefill(int dtype, int hd, const void* q,
                              const void* ks, const void* vs, const void* kp,
                              const void* vp, const void* table,
                              const void* plens, const void* slens, void* o,
                              const long long* strides, int B, int H,
                              int Hkv, int Sq, int page, int npp, float scale,
                              float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    const auto args = make_args<float>(q, ks, vs, kp, vp, table, plens,
                                       slens, o, strides, H, Hkv, Sq, page,
                                       npp, scale, softcap, hd);
    ATTN_DISPATCH_HD(hd, HD, PAD,
                     err = launch(prefix_prefill_simt_kernel<HD, PAD>,
                                  SimtSmem<HD>::BYTES, 1, args, B, H, Sq,
                                  s));
  } else if (dtype == 1) {
    const auto args = make_args<bf16>(q, ks, vs, kp, vp, table, plens, slens,
                                      o, strides, H, Hkv, Sq, page, npp,
                                      scale, softcap, hd);
    // two query heads a block where the group size allows
    if ((H / Hkv) % 2 == 0) {
      ATTN_DISPATCH_HD(hd, HD, PAD,
                       err = launch(prefix_prefill_mma_kernel<HD, 2, PAD>,
                                    MmaSmem<HD>::bytes(2, mma_stages<HD, 2>()),
                                    2, args, B, H, Sq, s));
    } else {
      ATTN_DISPATCH_HD(hd, HD, PAD,
                       err = launch(prefix_prefill_mma_kernel<HD, 1, PAD>,
                                    MmaSmem<HD>::bytes(1, mma_stages<HD, 1>()),
                                    1, args, B, H, Sq, s));
    }
  }
  return static_cast<int>(err);
}
