// flash_prefill: blocked online-softmax attention over dense Q/K/V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill/kernel.py
// (flash_prefill, _kernel): causal or not, GQA through the kv head index,
// sliding window, soft cap, the offset mask kpos <= (Skv - Sq) + qpos when
// Sq < Skv, the finite NEG_INF mask (a row with no visible score yet takes
// exp(0) per masked score, cancelled by corr later) and the 1e-37 clamp.
//
// Bound on the H100: at the main path's shapes (yi-6b, S = 512..1024, hd
// 128, 32 query heads over 4 kv heads) the causal products are ~4 S^2/2
// hd H flops against ~4 S H hd bytes, far above the card's ridge, so it
// is bound by operations: 989 TF/s in bf16 on the tensor cores, 67 TF/s in
// f32 on the CUDA cores.
//
// Both kernels launch the q tiles heaviest first (grid.y counts q tiles
// from the last, which sees the most kv tiles under the causal mask), so
// the last wave is short rows, and skip kv tiles wholly above the
// diagonal or wholly before the window. Masks are evaluated only on the
// tiles that straddle an edge.
//
// bf16: FlashAttention-3 style on wgmma and TMA (attn_wgmma.cuh). K and V
// are dense strided tensors, so one 4-D tensor map (head dim, seq, head,
// batch) each describes them in the caller's strides; a box never crosses
// into another head or batch, and rows past Skv arrive zero-filled. A
// producer warpgroup (one thread) keeps K/V tiles in flight in a
// three-stage ring with full/empty mbarriers; each consumer warpgroup owns
// 64 query rows (wgmma's M) of one query head. Where H / Hkv is even and
// the grid still fills the card, two consumer warpgroups serve two query
// heads of one kv head, so every K/V tile copied feeds 128 rows (the host
// decides from shapes alone, kernels/flash_prefill/kernel.py). S = Q K^T
// is wgmma with Q and K from shared memory (K-major); the online softmax
// runs on the accumulator registers (attn_mma.cuh's softmax_scores); P is
// converted in registers to bf16 A-fragments and O += P V takes V from
// shared memory through the transpose bit of the B descriptor. The
// products are pipelined within a warpgroup: S of tile t + 1 is issued
// before P V of tile t, and the softmax of tile t + 1 runs while P V of
// tile t is still on the tensor cores (the output rescale waits for it).
// P is
// rounded to bf16 before P.V, as SDPA does; the TPU kernel multiplies in
// f32 (kernel.py:65-67): about 2^-9 of |o| more error, inside the 3e-2
// bf16 tolerance.
//
// f32 stays on the CUDA cores in full f32 (TF32 would break the 5e-5
// tolerance and the f32 card-vs-CPU token identity): attn_simt.cuh's 8 x 4
// score and 8 x hd/16 output register tiles read as float4s, fed by a
// two-stage ring of 16-byte cp.async copies.
//
// Head dims: instances of 16, 32, 64, 128 and 256 (attn_common.cuh). A
// head dim below its instance (zamba2-7b's 112 on the 128 one) reads its
// padding columns as zeros (TMA's out-of-bounds fill in bf16, zero-filled
// copies in f32) and never stores them. At hd 256 (gemma3-1b) a bf16
// block serves one query head, as two would need 257 KB of shared memory,
// and its 128 accumulator registers a thread share the 255 of a thread
// with the scores and P; the f32 kernel's ring has one stage there.
#include <type_traits>

#include "attn_simt.cuh"
#include "attn_wgmma.cuh"

using namespace attn;
using bf16 = __nv_bfloat16;

namespace {

constexpr int RING = 3;   // K/V stages of the bf16 kernel

struct FlashArgs {
  const void *q, *k, *v;
  void* o;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int H, Hkv, Sq, Skv, causal, window, nq;
  float scale, softcap;
  int hd;           // the head dim; the instance's HD >= hd (attn_common)
  float* lse;       // (B, H, Sq) f32 log-sum-exp, or null (serving)
};

// The kv walk of one 64-row q tile: tiles kv_begin + 64 t for t < nt.
struct FlashWalk {
  int q0, off, kv_begin, nt;

  __device__ FlashWalk(const FlashArgs& a, int qtile) {
    q0 = qtile * 64;
    off = a.Skv - a.Sq;                              // offset of query row 0
    const int q_hi = min(q0 + 64, a.Sq) - 1;         // last real row
    int kv_end = a.Skv;
    if (a.causal) kv_end = min(a.Skv, off + q_hi + 1);   // above: skipped
    int kb = 0;
    if (a.window > 0) kb = max(0, off + q0 - a.window + 1);
    kv_begin = (kb / 64) * 64;
    nt = kv_end > kv_begin ? (kv_end - kv_begin + 63) / 64 : 0;
  }

  // Whether every pair of tile t is visible to tile rows r0 .. r0+rows-1.
  __device__ __forceinline__ bool full(const FlashArgs& a, int t, int r0,
                                       int rows) const {
    const int k0 = kv_begin + 64 * t;
    const int qlo = off + q0 + r0, qhi = qlo + rows - 1;
    bool f = k0 + 64 <= a.Skv;
    if (a.causal) f = f && k0 + 63 <= qlo;
    if (a.window > 0) f = f && k0 > qhi - a.window;
    return f;
  }

  // The mask of tile row r (from q0) and column c of tile t.
  __device__ __forceinline__ bool visible(const FlashArgs& a, int t, int r,
                                          int c) const {
    const int kp = kv_begin + 64 * t + c, qp = off + q0 + r;
    bool ok = kp < a.Skv;
    if (a.causal) ok = ok && kp <= qp;
    if (a.window > 0) ok = ok && kp > qp - a.window;
    return ok;
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, QH consumer warpgroups and one producer warpgroup.
// ---------------------------------------------------------------------------
template <int HD, int QH, bool PAD>
__global__ void __launch_bounds__(128 * (QH + 1), 1)
    flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const FlashArgs a) {
  using W = WgBox<HD>;
  constexpr int TE = W::TILE / 2;        // elements of a tile
  constexpr int BE = W::BYTES / 2;       // elements of a box
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  // every box on 1024 bytes, the period of the 128-byte swizzle
  unsigned char* base =
      smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + QH * TE;
  bf16* Vs = Ks + RING * TE;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Vs + RING * TE);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + RING;
  uint64_t* empty = vfull + RING;

  const int per = a.H / QH;
  const int b = blockIdx.x / per, h0 = (blockIdx.x % per) * QH;
  const int kh = h0 / (a.H / a.Hkv);
  const FlashWalk w(a, a.nq - 1 - blockIdx.y);     // heaviest tiles first

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 128 * QH);      // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 4 * QH) {
    // producer: one thread issues every copy; the others have nothing to do
    if (threadIdx.x == 128 * QH) {
      mbar_expect_tx(qfull, QH * W::TILE);
      for (int i = 0; i < QH; ++i)
        for (int j = 0; j < W::NBOX; ++j)
          tma_load4(Qs + i * TE + j * BE, &tq, qfull, j * W::COLS, w.q0,
                    h0 + i, b);
      for (int t = 0; t < w.nt; ++t) {
        const int s = t % RING;
        mbar_wait(&empty[s], ((t / RING) & 1) ^ 1);   // round 0 passes
        const int k0 = w.kv_begin + 64 * t;
        mbar_expect_tx(&kfull[s], W::TILE);
        for (int j = 0; j < W::NBOX; ++j)
          tma_load4(Ks + s * TE + j * BE, &tk, &kfull[s], j * W::COLS, k0,
                    kh, b);
        mbar_expect_tx(&vfull[s], W::TILE);
        for (int j = 0; j < W::NBOX; ++j)
          tma_load4(Vs + s * TE + j * BE, &tv, &vfull[s], j * W::COLS, k0,
                    kh, b);
      }
    }
  } else {
    const int hq = warp / 4;               // the warpgroup's query head
    const int wr0 = (warp % 4) * 16;       // the warp's first tile row
    float o[HD / 8][4];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    const uint32_t qt = smem_u32(Qs + hq * TE);
    // Software pipeline, per kv tile t: the softmax of tile t runs while
    // P V of tile t - 1 is still on the tensor cores, and S = Q K^T of tile
    // t + 1 is issued ahead of P V of tile t. Between a product's issue
    // and its wait no other instruction touches its accumulators, and no
    // product is issued in a data-dependent branch (the last tile is a
    // separate instance of the step), or ptxas serialises the products.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    auto wgmma_s = [&](int t) {            // S of tile t into sc
      const uint32_t kt = smem_u32(Ks + (t % RING) * TE);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc, desc_kmajor<HD>(qt, kk), desc_kmajor<HD>(kt, kk),
                     kk > 0);
      wg_commit();
    };
    // the landed scores, copied out of the accumulators: from here on only
    // the next S product touches sc
    auto take_s = [&](float (&p)[8][4]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("mov.b32 %0, %1;\n" : "=f"(p[j][e]) : "f"(sc[j][e]));
    };
    float ps[8][4];                        // S, then P, of the current tile
    // With two consumer warpgroups, they take turns to issue their
    // products (named barriers 1 and 2; FlashAttention-3's ping-pong), so
    // the softmax of one runs under the products of the other: fed by the
    // same tiles, they would otherwise run in step and leave the tensor
    // cores idle during both softmaxes.
    auto my_turn = [&]() {
      if constexpr (QH == 2) bar_sync(1 + hq, 256);
    };
    auto your_turn = [&]() {
      if constexpr (QH == 2) bar_arrive(2 - hq, 256);
    };
    if constexpr (QH == 2)
      if (hq == 1) bar_arrive(1, 256);     // warpgroup 0 goes first
    auto step = [&](int t, auto more) {
      constexpr bool MORE = decltype(more)::value;
      float corr[2];
      softmax_scores(ps, ps, corr, m, l, a.scale, a.softcap,
                     w.full(a, t, wr0, 16), [&](int r, int c) {
                       return w.visible(a, t, wr0 + r, c);
                     });
      wg_wait<0>();                        // P V of tile t - 1 has landed
      fence_regs(o);
      if (t > 0) mbar_arrive(&empty[(t - 1) % RING]);
      // unconditional (rescale_rows skips corr = 1 behind a branch): no
      // accumulator is written in a data-dependent branch
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        pa[k2][0] = pack_bf16(ps[2 * k2][0], ps[2 * k2][1]);
        pa[k2][1] = pack_bf16(ps[2 * k2][2], ps[2 * k2][3]);
        pa[k2][2] = pack_bf16(ps[2 * k2 + 1][0], ps[2 * k2 + 1][1]);
        pa[k2][3] = pack_bf16(ps[2 * k2 + 1][2], ps[2 * k2 + 1][3]);
      }
      fence_regs(o);
      if constexpr (MORE)
        mbar_wait(&kfull[(t + 1) % RING], ((t + 1) / RING) & 1);
      mbar_wait(&vfull[t % RING], (t / RING) & 1);
      const uint32_t vt = smem_u32(Vs + (t % RING) * TE);
      my_turn();
      wg_fence();
      if constexpr (MORE) wgmma_s(t + 1);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2)
        wgmma_rs<HD>(o, pa[k2], desc_mnmajor<HD>(vt, k2));
      wg_commit();
      your_turn();
      if constexpr (MORE) {
        wg_wait<1>();                      // S of tile t + 1 has landed
        take_s(ps);
      }
    };
    mbar_wait(qfull, 0);
    if (w.nt > 0) {
      mbar_wait(&kfull[0], 0);
      fence_regs(sc);
      my_turn();
      wg_fence();
      wgmma_s(0);
      your_turn();
      wg_wait<0>();
      take_s(ps);
      for (int t = 0; t + 1 < w.nt; ++t) step(t, std::true_type());
      step(w.nt - 1, std::false_type());
      wg_wait<0>();             // inside the branch: no product in flight
      fence_regs(o);            // where the paths join
    }
    bf16* ob = static_cast<bf16*>(a.o) + b * a.osb + (h0 + hq) * a.osh;
    store_rows_bf16<HD>(o, l, a.Sq - w.q0 - wr0, head_dim<HD, PAD>(a.hd),
                        [&](int r) {
      return ob + (long long)(w.q0 + wr0 + r) * a.oss;
    });
    // without a cap, m is the row max of the raw scores q.k (see
    // softmax_scores), so the natural-log LSE is scale m + ln l
    if (a.lse != nullptr)
      store_lse_rows(m, l, a.Sq - w.q0 - wr0, a.softcap > 0.f ? 1.f : a.scale,
                     a.lse + ((long long)b * a.H + h0 + hq) * a.Sq + w.q0 +
                         wr0);
  }
}

// ---------------------------------------------------------------------------
// f32: register tiles on the CUDA cores, one (batch, head) a block.
// ---------------------------------------------------------------------------
template <int HD, bool PAD>
__global__ void __launch_bounds__(SIMT_NT)
    flash_prefill_simt_kernel(const FlashArgs a) {
  using L = SimtSmem<HD>;
  const int hd = head_dim<HD, PAD>(a.hd);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Qs = sm + L::Q_OFF;
  float* Ks = sm + L::K_OFF;
  float* Vs = sm + L::V_OFF;
  float* Ps = sm + L::P_OFF;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.Hkv);
  const FlashWalk w(a, a.nq - 1 - blockIdx.y);     // heaviest tiles first
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kh * a.vsh;
  float* ob = static_cast<float*>(a.o) + b * a.osb + h * a.osh;

  // the Q tile, rows past Sq and columns past hd zero-filled
  constexpr int CPR = HD / 4;
  const int c = (threadIdx.x % CPR) * 4;
  for (int r = threadIdx.x / CPR; r < 64; r += SIMT_NT / CPR) {
    float* dst = Qs + r * L::QS + c;
    if (w.q0 + r < a.Sq && c < hd)
      cp_async16(dst, qb + (long long)(w.q0 + r) * a.qss + c);
    else
      zero16(dst);
  }
  auto issue = [&](int t) {
    const int k0 = w.kv_begin + 64 * t, stg = t % L::STAGES;
    copy_kv_rows<float, HD, SIMT_BKV, SIMT_NT>(
        Ks + stg * SIMT_BKV * L::KS, Vs + stg * SIMT_BKV * L::VS, L::KS,
        L::VS, kb, vb, hd, [&](int r) {
          const long long pos = k0 + r;
          if (pos >= a.Skv) return RowSrc{0, 0, false};
          return RowSrc{pos * a.kss, pos * a.vss, true};
        });
  };
  if (w.nt > 0) issue(0);
  cp_async_commit();                       // Q joins tile 0
  SimtState<HD> st;
  st.init();
  for (int t = 0; t < w.nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();       // tile t landed; tile t - 1's buffers are free
    if (L::STAGES == 2) {  // tile t + 1 flies while tile t is computed
      if (t + 1 < w.nt) issue(t + 1);
      cp_async_commit();
    }
    const int stg = t % L::STAGES;
    simt_attend<HD>(st, Qs, Ks + stg * SIMT_BKV * L::KS,
                    Vs + stg * SIMT_BKV * L::VS, Ps, a.scale, a.softcap,
                    w.full(a, t, 0, 64),
                    [&](int r, int cc) { return w.visible(a, t, r, cc); });
    if (L::STAGES == 1) {  // one stage: the copy waits for the tile's use
      __syncthreads();
      if (t + 1 < w.nt) issue(t + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  simt_store<HD>(st, a.Sq - w.q0, hd, [&](int r) {
    return ob + (long long)(w.q0 + r) * a.oss;
  });
  if (a.lse != nullptr && threadIdx.x % 16 == 0) {
    // m is the max of the scaled (and capped) scores: LSE = m + ln l
    float* lse = a.lse + ((long long)b * a.H + h) * a.Sq + w.q0;
#pragma unroll
    for (int i = 0; i < SIMT_RPT; ++i) {
      const int r = threadIdx.x / 16 + 8 * i;
      if (r < a.Sq - w.q0)
        lse[r] = st.m[i] + logf(fmaxf(st.l[i], DEN_MIN));
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Shared memory of the bf16 kernel: QH Q tiles and the K and V rings,
// 1024 bytes of alignment slack, the barriers. At HD = 256 a tile is 32
// KB: one query head a block fits (7 tiles, 225 KB of the 227 KB a block
// may have), two would not.
template <int HD, int QH>
constexpr size_t wgmma_smem_bytes() {
  return (size_t)(QH + 2 * RING) * WgBox<HD>::TILE + 1024 +
         (1 + 3 * RING) * sizeof(uint64_t);
}

template <int HD, int QH, bool PAD>
cudaError_t launch_wgmma(const FlashArgs& a, int B, cudaStream_t stream) {
  if constexpr (wgmma_smem_bytes<HD, QH>() > 232448) {
    return cudaErrorInvalidValue;   // the wrapper asks for QH = 1 there
  } else {
    CUtensorMap tq, tk, tv;
    cudaError_t err = make_map<HD>(&tq, a.q, a.hd, a.Sq, a.H, B, a.qsb,
                                   a.qsh, a.qss);
    if (err == cudaSuccess)
      err = make_map<HD>(&tk, a.k, a.hd, a.Skv, a.Hkv, B, a.ksb, a.ksh,
                         a.kss);
    if (err == cudaSuccess)
      err = make_map<HD>(&tv, a.v, a.hd, a.Skv, a.Hkv, B, a.vsb, a.vsh,
                         a.vss);
    if (err != cudaSuccess) return err;
    auto kern = flash_prefill_wgmma_kernel<HD, QH, PAD>;
    const size_t bytes = wgmma_smem_bytes<HD, QH>();
    err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(B * a.H / QH, a.nq);
    kern<<<grid, 128 * (QH + 1), bytes, stream>>>(tq, tk, tv, a);
    return cudaGetLastError();
  }
}

template <int HD, bool PAD>
cudaError_t launch_simt(const FlashArgs& a, int B, cudaStream_t stream) {
  auto kern = flash_prefill_simt_kernel<HD, PAD>;
  const size_t bytes = SimtSmem<HD>::BYTES;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * a.H, a.nq);
  kern<<<grid, SIMT_NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, seq) for each of q, k, v, o; every tensor starts on 16 bytes and
// every stride is a whole number of 16-byte chunks (the wrapper checks).
// qh: query heads a block of the bf16 kernel (1, or 2 where H / Hkv is
// even and hd <= 128). hd: a multiple of 16 up to 256 (attn_common.cuh).
// lse: a (B, H, Sq) f32 buffer for each row's natural-log log-sum-exp of
// its scaled (and capped) visible scores, which the backward
// (flash_prefill_bwd.cu) recomputes P from, or null. Returns a
// cudaError_t code.
extern "C" int flash_prefill(int dtype, int hd, const void* q, const void* k,
                             const void* v, void* o, const long long* st,
                             int B, int H, int Hkv, int Sq, int Skv,
                             int causal, int window, float scale,
                             float softcap, int qh, float* lse,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const FlashArgs a{q,      k,      v,      o,      st[0],  st[1],
                    st[2],  st[3],  st[4],  st[5],  st[6],  st[7],
                    st[8],  st[9],  st[10], st[11], H,      Hkv,
                    Sq,     Skv,    causal, window, (Sq + 63) / 64,
                    scale,  softcap, hd,     lse};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    ATTN_DISPATCH_HD(hd, HD, PAD, err = (launch_simt<HD, PAD>(a, B, s)));
  } else if (dtype == 1 && qh == 2 && (H / Hkv) % 2 == 0) {
    ATTN_DISPATCH_HD(hd, HD, PAD, err = (launch_wgmma<HD, 2, PAD>(a, B, s)));
  } else if (dtype == 1 && qh == 1) {
    ATTN_DISPATCH_HD(hd, HD, PAD, err = (launch_wgmma<HD, 1, PAD>(a, B, s)));
  }
  return static_cast<int>(err);
}
