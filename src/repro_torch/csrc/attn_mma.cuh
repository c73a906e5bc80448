// Tile code of the redesigned attention kernels for Hopper (sm_90a):
// asynchronous 16-byte tile copies (cp.async) into a two-stage ring, and
// the FlashAttention-2 bf16 tile on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate). prefix_prefill runs on it; its online softmax
// and row store also serve flash_prefill's wgmma tile (attn_wgmma.cuh),
// whose accumulators have the same per-warp layout.
//
// The bf16 tile: 4 warps own a 64-row Q tile, each warp 16 rows. The
// warp's Q fragments are loaded once (ldmatrix) and stay in
// registers for the whole kv walk. For each 64-row K/V tile in shared
// memory, S = Q K^T accumulates in registers (8 n-tiles of 8 keys), the
// online softmax runs on those accumulator fragments (row max and sum are
// shuffles within a quad, the 4 lanes that share a row), and P is turned
// into bf16 A-fragments in registers and multiplied by V (ldmatrix.trans),
// never touching shared memory. Rows of a tile are padded by 16 bytes so
// the 8 row addresses of every ldmatrix hit 8 different bank groups.
//
// Numerics: the finite NEG_INF mask and the 1e-37 clamp of the Pallas
// kernels (attn_common.cuh). P is rounded to bf16 before P.V, as PyTorch's
// SDPA does; the TPU kernel multiplies in f32. That adds about 2^-9 of |o|
// to the error, inside the 3e-2 bf16 tolerance. The row sum l is taken
// from the unrounded f32 P; each thread keeps its own part of it and the
// quad adds them up once, at the end. exp is the hardware ex2 (~2 ulp),
// far below the bf16 rounding of P that follows it.
#pragma once

#include "attn_common.cuh"

namespace attn {

// ---------------------------------------------------------------------------
// cp.async: 16-byte global -> shared copies that bypass registers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Where a K/V tile row comes from: element offsets into the K and V
// tensors, or ok = false for a row past the data (zero-filled: the mask
// hides it, and P = 0 never meets a NaN from stale shared memory).
struct RowSrc {
  long long k, v;
  bool ok;
};

// Issue the copies of ROWS rows of HD elements into a K and a V tile
// (row strides ks, vs elements), 16 bytes a copy. Each thread keeps one
// 16-byte column and walks rows, so `src(r)` (a block-table lookup in a
// paged walk) runs once per row and thread and serves K and V alike.
// Columns at or past the head dim hd (<= HD, a multiple of 16) are
// zero-filled: the tile's padding never holds stale data. The caller
// commits the group.
template <typename T, int HD, int ROWS, int NTHR, typename SrcFn>
__device__ __forceinline__ void copy_kv_rows(T* kd, T* vd, int ks, int vs,
                                             const T* kbase, const T* vbase,
                                             int hd, SrcFn src) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = HD / EPC;
  static_assert(NTHR % CPR == 0, "a thread keeps one column");
  const int c = (threadIdx.x % CPR) * EPC;
  const bool col_live = c < hd;
  for (int r = threadIdx.x / CPR; r < ROWS; r += NTHR / CPR) {
    const RowSrc s = src(r);
    T* kdst = kd + r * ks + c;
    T* vdst = vd + r * vs + c;
    if (s.ok && col_live) {
      cp_async16(kdst, kbase + s.k + c);
      cp_async16(vdst, vbase + s.v + c);
    } else {
      zero16(kdst);
      zero16(vdst);
    }
  }
}

// 16 bytes of a shared-memory row, widened to f32 (4 floats or 8 bf16).
__device__ __forceinline__ void load16_f32(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 4 consecutive elements of a shared-memory row, widened to f32.
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---------------------------------------------------------------------------
// Tensor-core primitives (warp-wide).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx, ~2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, `lo` in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The bf16 FlashAttention-2 tile.
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;   // 4 warps a query head, 16 rows each
constexpr int MMA_BQ = 64;
constexpr int MMA_BKV = 64;

// Shared memory of a block that serves `qh` query heads of one kv head:
// qh Q tiles, then the K ring, then the V ring, `stages` tiles each.
template <int HD>
struct MmaSmem {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int STRIDE = HD + 8;            // bf16; +16 bytes a row
  static constexpr int TILE = MMA_BQ * STRIDE;     // one 64-row tile
  __host__ __device__ static constexpr size_t bytes(int qh, int stages) {
    return (size_t)(qh + 2 * stages) * TILE * sizeof(__nv_bfloat16);
  }
};

// Per-thread state of one warp's 16 query rows: the Q fragments, the
// output accumulators (HD/8 n-tiles), and of rows lane/4 and lane/4 + 8
// the running max m and this thread's part of the running sum l.
template <int HD>
struct MmaState {
  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // The warp's 16 Q rows (starting at `Qs`) into A-fragments.
  __device__ __forceinline__ void load_q(const __nv_bfloat16* Qs) {
    const int lane = threadIdx.x % 32;
    const __nv_bfloat16* row =
        Qs + (lane % 16) * MmaSmem<HD>::STRIDE + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], row + kk * 16);
  }
};

// The online-softmax step of a warp's 16 rows on an 8 x 4 fragment tile
// of scores (8 n-tiles of 8 keys, the mma.sync / wgmma accumulator
// layout: element e of n-tile j is row lane/4 + 8 (e/2), column 8 j +
// 2 (lane%4) + e%2). Turns the scores sin into P (f32) in s (which may
// be sin itself), folds it into the running
// max m and this thread's part of the sum l, and returns in corr the
// factor by which the output accumulators must be rescaled (by
// rescale_rows, which the wgmma tile defers until its previous product
// has landed). `visible(r, c)`: the mask of warp-local row r and tile
// column c, not evaluated when `full`.
template <typename MaskFn>
__device__ __forceinline__ void softmax_scores(const float (&sin)[8][4],
                                               float (&s)[8][4],
                                               float (&corr)[2],
                                               float (&m)[2], float (&l)[2],
                                               float scale, float softcap,
                                               bool full, MaskFn visible) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  // Without a soft cap the row max is taken over the raw scores q.k and
  // p = 2^(s c - m c) with c = scale * log2(e): one FFMA and one ex2 a
  // score, the same function as exp(scale s - max(scale s)) since scale >
  // 0. With a cap, over the capped scores and c = log2(e). A row with no
  // visible score yet (m = NEG_INF) takes exp(NEG_INF - NEG_INF) = 1 for
  // each masked score, as the TPU kernel does.
  const bool cap = softcap > 0.f;
  const float c = (cap ? 1.f : scale) * 1.4426950408889634f;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = cap ? score_post(sin[j][e], scale, softcap) : sin[j][e];
      if (!full && !visible(g + (e / 2) * 8, 8 * j + 2 * t4 + (e % 2)))
        v = NEG_INF;
      s[j][e] = v;
      mx[e / 2] = fmaxf(mx[e / 2], v);
    }
  float mc[2], rs[2] = {0.f, 0.f};
  bool none[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = ex2((m[i] - m_new) * c);
    m[i] = m_new;
    mc[i] = m_new * c;
    none[i] = m_new == NEG_INF;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          none[e / 2] ? 1.f : ex2(fmaf(s[j][e], c, -mc[e / 2]));
      s[j][e] = p;
      rs[e / 2] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
}

// o *= corr by rows (lane/4 and lane/4 + 8); once the row maxima settle,
// corr is 1 and the rescale is skipped.
template <int NO>
__device__ __forceinline__ void rescale_rows(float (&o)[NO][4],
                                             const float (&corr)[2]) {
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
  }
}

// Both: the step of mma_attend, which owns its accumulators throughout.
template <int NO, typename MaskFn>
__device__ __forceinline__ void online_softmax(float (&s)[8][4],
                                               float (&o)[NO][4],
                                               float (&m)[2], float (&l)[2],
                                               float scale, float softcap,
                                               bool full, MaskFn visible) {
  float corr[2];
  softmax_scores(s, s, corr, m, l, scale, softcap, full, visible);
  rescale_rows(o, corr);
}

// One online-softmax step of a warp's 16 rows over a 64-row K/V tile in
// shared memory. `visible(r, c)`: the mask of warp-local query row r
// (0..15) and tile column c (0..63), not evaluated when `full` says every
// pair of the tile is visible. Touches no shared memory but Ks/Vs, and
// has no barrier: the caller synchronises the ring.
template <int HD, typename MaskFn>
__device__ __forceinline__ void mma_attend(MmaState<HD>& st,
                                           const __nv_bfloat16* Ks,
                                           const __nv_bfloat16* Vs,
                                           float scale, float softcap,
                                           bool full, MaskFn visible) {
  constexpr int S = MmaSmem<HD>::STRIDE;
  constexpr int KSTEPS = HD / 16;
  const int lane = threadIdx.x % 32;

  // S = Q K^T: 8 n-tiles of 8 keys, the 8 independent accumulators
  // innermost; one ldmatrix.x4 covers two k-steps
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const __nv_bfloat16* krow = Ks + (lane % 8) * S;
#pragma unroll
  for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[4];
      ldsm_x4(b, krow + 8 * j * S + kk * 16 + (lane / 8) * 8);
      mma_bf16(s[j], st.qf[kk], b[0], b[1]);
      mma_bf16(s[j], st.qf[kk + 1], b[2], b[3]);
    }
  }
  if constexpr (KSTEPS % 2 == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      ldsm_x2(b, krow + 8 * j * S + (KSTEPS - 1) * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(s[j], st.qf[KSTEPS - 1], b[0], b[1]);
    }
  }

  online_softmax(s, st.o, st.m, st.l, scale, softcap, full, visible);

  // O += P V: P's accumulator fragments are the A-fragments of P.V
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                           pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                           pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                           pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
    const __nv_bfloat16* vrow =
        Vs + (16 * kt + ((lane / 8) % 2) * 8 + lane % 8) * S + (lane / 16) * 8;
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + n * 8);
      mma_bf16(st.o[n], a, b[0], b[1]);
      mma_bf16(st.o[n + 1], a, b[2], b[3]);
    }
  }
}

// Write a warp's finished rows from the accumulator layout: o / max(l,
// 1e-37) as bf16, warp-local rows r < n_valid and columns < hd only; l is
// each thread's part of its rows' sums. `row(r)` returns the output row's
// first element.
template <int HD, typename RowFn>
__device__ __forceinline__ void store_rows_bf16(const float (&o)[HD / 8][4],
                                                const float (&l2)[2],
                                                int n_valid, int hd,
                                                RowFn row) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l2[i];                   // the quad's parts of the row sum
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = g + 8 * i;
    if (r >= n_valid) continue;
    __nv_bfloat16* dst = row(r);
    const float den = fmaxf(l, DEN_MIN);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (8 * n + 2 * t4 >= hd) continue;     // a pair is in or out whole
      __nv_bfloat162 v = __floats2bfloat162_rn(o[n][2 * i] / den,
                                               o[n][2 * i + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * t4) = v;
    }
  }
}

// The natural-log log-sum-exp of a warp's rows (lane/4 and lane/4 + 8)
// from the online softmax's running max m and this thread's parts l2 of
// the sums: m * mscale + ln(max(l, 1e-37)), mscale the factor that turns
// m into the units of the scaled scores (see softmax_scores). Warp-local
// rows r < n_valid go to dst[r].
__device__ __forceinline__ void store_lse_rows(const float (&m)[2],
                                               const float (&l2)[2],
                                               int n_valid, float mscale,
                                               float* dst) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l2[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = g + 8 * i;
    if (t4 == 0 && r < n_valid)
      dst[r] = m[i] * mscale + logf(fmaxf(l, DEN_MIN));
  }
}

template <int HD, typename RowFn>
__device__ __forceinline__ void mma_store(const MmaState<HD>& st,
                                          int n_valid, int hd, RowFn row) {
  store_rows_bf16<HD>(st.o, st.l, n_valid, hd, row);
}

}  // namespace attn
