// The f32 prefill tile of the redesigned attention kernels, on the CUDA
// cores. TF32 tensor cores would keep ~3 decimal digits, outside the 5e-5
// f32 tolerance and the f32 card-vs-CPU token identity, so f32 stays on
// the FMA units; the design cuts shared-memory reads per FMA instead.
//
// A block of 128 threads owns a 64-row Q tile and streams 64-row K/V
// tiles (cp.async, two-stage ring, see attn_mma.cuh). The threads form an
// 8 x 16 grid: ty = tid / 16 owns query rows ty + 8 i (i < 8), tx = tid %
// 16 owns score columns tx + 16 j (j < 4) and output columns in float4
// chunks. Per 4-element step of the head dim a thread reads 8 Q and 4 K
// float4s from shared memory for 128 FMAs (the previous tile read 8
// words for 16 FMAs); per 4 keys, P.V reads 8 P and 4 * HD/64 V float4s
// for 32 * HD/16 FMAs (256 at hd 128). Rows are padded by 16 bytes so
// the two query rows a warp reads and the 8 K rows of each quarter-warp
// fall in different banks.
//
// Shared memory at hd 128: Q 33.8 KB + K 2 x 33.8 KB + V 2 x 32.8 KB + P
// 17.4 KB = 184 KB, one block (4 warps) per SM. At hd 256 two stages
// would take 340 KB, over the 227 KB a block may have, so the ring has one
// stage there (211 KB): the copy of tile t + 1 starts once tile t is done
// (SimtSmem::STAGES; the callers' loops take either).
#pragma once

#include "attn_mma.cuh"

namespace attn {

constexpr int SIMT_NT = 128;
constexpr int SIMT_BQ = 64;
constexpr int SIMT_BKV = 64;
constexpr int SIMT_RPT = 8;   // query rows per thread
constexpr int SIMT_CPT = 4;   // score columns per thread

template <int HD>
struct SimtSmem {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int QS = HD + 4;
  static constexpr int KS = HD + 4;
  static constexpr int VS = HD;
  static constexpr int PS = SIMT_BKV + 4;
  static constexpr int OV = HD / 16 < 4 ? HD / 16 : 4;   // output vector
  static constexpr int OC = HD / 16 / OV;                // output chunks
  static constexpr int STAGES = HD <= 128 ? 2 : 1;          // K/V ring
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + SIMT_BQ * QS;
  static constexpr int V_OFF = K_OFF + STAGES * SIMT_BKV * KS;
  static constexpr int P_OFF = V_OFF + STAGES * SIMT_BKV * VS;
  static constexpr int FLOATS = P_OFF + SIMT_BQ * PS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int HD>
struct SimtState {
  float m[SIMT_RPT];
  float l[SIMT_RPT];
  float o[SIMT_RPT][HD / 16];   // column c * 16 * OV + tx * OV + e

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < SIMT_RPT; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) o[i][c] = 0.f;
    }
  }
};

// One online-softmax step over the kv tile in Ks/Vs. `visible(r, c)` is
// the mask of tile row r and kv column c, not evaluated when `full` says
// every pair of the tile is visible. Writes P to Ps between two halves
// separated by a barrier; the caller's ring barrier protects Ps from the
// next tile.
template <int HD, typename MaskFn>
__device__ __forceinline__ void simt_attend(SimtState<HD>& st,
                                            const float* Qs, const float* Ks,
                                            const float* Vs, float* Ps,
                                            float scale, float softcap,
                                            bool full, MaskFn visible) {
  using L = SimtSmem<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[SIMT_RPT][SIMT_CPT];
#pragma unroll
  for (int i = 0; i < SIMT_RPT; ++i)
#pragma unroll
    for (int j = 0; j < SIMT_CPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qv[SIMT_RPT], kv[SIMT_CPT];
#pragma unroll
    for (int i = 0; i < SIMT_RPT; ++i)
      qv[i] = load4_f32(Qs + (ty + 8 * i) * L::QS + d);
#pragma unroll
    for (int j = 0; j < SIMT_CPT; ++j)
      kv[j] = load4_f32(Ks + (tx + 16 * j) * L::KS + d);
#pragma unroll
    for (int i = 0; i < SIMT_RPT; ++i)
#pragma unroll
      for (int j = 0; j < SIMT_CPT; ++j) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        s[i][j] = a;
      }
  }
#pragma unroll
  for (int i = 0; i < SIMT_RPT; ++i) {
    const int r = ty + 8 * i;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SIMT_CPT; ++j) {
      float v = score_post(s[i][j], scale, softcap);
      if (!full && !visible(r, tx + 16 * j)) v = NEG_INF;
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
    for (int j = 0; j < SIMT_CPT; ++j) {
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
    for (int c = 0; c < HD / 16; ++c) st.o[i][c] *= corr;
  }
  __syncthreads();
#pragma unroll 1
  for (int kk = 0; kk < SIMT_BKV; kk += 4) {
    float4 pv[SIMT_RPT];
#pragma unroll
    for (int i = 0; i < SIMT_RPT; ++i)
      pv[i] = load4_f32(Ps + (ty + 8 * i) * L::PS + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* vrow = Vs + (kk + u) * L::VS + tx * L::OV;
#pragma unroll
      for (int c = 0; c < L::OC; ++c) {
        float vv[L::OV];
        if constexpr (L::OV == 4) {
          const float4 t = load4_f32(vrow + c * 64);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < L::OV; ++e) vv[e] = vrow[c * 16 * L::OV + e];
        }
#pragma unroll
        for (int i = 0; i < SIMT_RPT; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < L::OV; ++e)
            st.o[i][c * L::OV + e] = fmaf(p, vv[e], st.o[i][c * L::OV + e]);
        }
      }
    }
  }
}

// Write the finished tile: o / max(l, 1e-37), rows < n_valid and
// columns < hd only.
template <int HD, typename RowFn>
__device__ __forceinline__ void simt_store(const SimtState<HD>& st,
                                           int n_valid, int hd, RowFn row) {
  using L = SimtSmem<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < SIMT_RPT; ++i) {
    const int r = ty + 8 * i;
    if (r >= n_valid) continue;
    float* dst = row(r);
    const float den = fmaxf(st.l[i], DEN_MIN);
#pragma unroll
    for (int c = 0; c < L::OC; ++c) {
      const int col = c * 16 * L::OV + tx * L::OV;
      if (col >= hd) continue;            // OV columns are in or out whole
#pragma unroll
      for (int e = 0; e < L::OV; ++e)
        dst[col + e] = st.o[i][c * L::OV + e] / den;
    }
  }
}

}  // namespace attn
