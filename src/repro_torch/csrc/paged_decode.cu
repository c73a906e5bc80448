// paged_decode and paged_insert: the two kernels of every decode step.
//
// paged_decode replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode/kernel.py (paged_decode, _kernel and
// _dbuf_kernel; the TPU's double-buffered DMA schedule computes the same
// function, so both map onto this one design): one query token per
// sequence, GQA, online softmax over the pages of the block table, masked
// by `lens`, optional soft cap.
//
// Bound on the H100: bytes. Each (sequence, kv head) reads its context's
// K and V once and does 4*G*hd flops per position, ~2 flops a byte in
// f32. The TPU walks the pages of one sequence in order; here the context
// is split across blocks (flash-decoding) so that enough bytes are in
// flight to keep HBM busy:
//
// - paged_decode_split_kernel, grid (B, Hkv, n_split): a block owns one
//   (sequence, kv head) and a range of `split_pages` whole pages. It reads
//   each K/V row once for all G = H / Hkv query heads of the group, in
//   32-row tiles copied with 16-byte cp.async into a two-stage ring in
//   shared memory, so the next tile is in flight while the current one is
//   scored. Each warp reads the tile's table entries once (one page per
//   lane) and hands them round by shuffle. Only live positions are copied
//   (rows past `lens` are zero-filled and masked), so trash-padded table
//   slots are never read. Scores: lane = row, warp = a group of query
//   heads, K read as 16-byte vectors; the softmax of a tile is warp-local.
//   P.V: each thread owns 4 output columns of up to 4 heads. The partial
//   (m, l, acc[G, hd]) goes to an f32 workspace; a split that starts at or
//   past lens[b] writes the empty partial (NEG_INF, 0, 0) and exits.
// - paged_decode_combine_kernel, one block per (sequence, head): merges
//   the live splits in a fixed order with corr = exp(m_i - m_max), then
//   divides by max(l, 1e-37). No atomics: outputs repeat bit for bit, and
//   lens[b] = 0 gives 0 as the TPU kernel does. Given a buffer, it also
//   writes each row's log-sum-exp of its scaled (and capped) live scores,
//   m_max + ln(max(l, 1e-37)): a cache sharded along its sequence
//   (models/sharded.py::decode_attend) combines the ranks' outputs by it.
//   A row with no live key gets NEG_INF + ln(1e-37), about NEG_INF, whose
//   weight beside any live rank's is 0.
//
// The split count is chosen on the host from shapes alone
// (kernels/paged_decode/kernel.py::decode_split); lens never goes back to
// the host.
//
// paged_insert replaces src/repro/kernels/paged_decode/kernel.py
// (paged_insert, _insert_kernel): one block per sequence writes its new
// token's K and V row into pool page page_idx[b], row offset[b], in place.
// Idle decode slots all target the reserved trash page 0, so several
// blocks may write the same trash row at once: benign, and never a live
// page (the engine points every idle slot's table row at page 0).
//
// On the decode path the insert is not launched on its own: it moves 16-32
// KB a step, ~10 ns of HBM time under a ~2.5 us launch. The split kernel's
// INSERT instance (entry paged_insert_decode) computes paged_insert at
// page table[b, (len-1) / page], row (len-1) % page, followed by
// paged_decode, in one launch, as TensorRT-LLM's masked multi-head
// attention writes the current token's K/V. The block (b, kh, sp) whose
// range [start, end) holds position len - 1 (always the last row of its
// last tile, as end = len there) writes k/v_new[b, kh] into both pools,
// rounded to the storage type, and after the cp.async wait of that tile
// overwrites the same row of its shared-memory ring with those values: the
// row its copy brought may be stale or new, as the copy and the store race
// within the block, and neither matters. No other block reads that row:
// the prefix cache shares only full pages, so a tail page being written
// belongs to one sequence. Idle slots (table rows all trash page 0) both
// write and read page 0 in the same launch; that race touches only rows
// whose outputs the engine throws away. len = 0 writes nothing.
//
// Head dims: instances of 16..256 (attn_common.cuh). A head dim below its
// instance addresses rows in hd, zero-fills its padding columns of Q and
// of every K/V tile and writes only its hd columns (workspace, output and
// the inserted row). At hd 256 a P.V thread owns 4 columns of 8 heads and
// an INSERT thread 2 elements of the new row; the f32 rings take 130 KB of
// shared memory. paged_insert copies rows of any width.
#include "attn_mma.cuh"

using namespace attn;

constexpr int DEC_NT = 128;       // 4 warps
constexpr int DEC_ROWS = 32;      // kv positions a tile: one per lane
constexpr int DEC_GMAX = 16;      // largest query-head group H / Hkv
constexpr int DEC_SPT = DEC_GMAX / (DEC_NT / 32);   // score heads a thread

// Shared memory: K and V rings in the storage type (K rows padded by 16
// bytes so a quarter-warp's 16-byte row reads hit distinct banks), then
// Q (G, hd), P (G, DEC_ROWS) and the tile's corrections (G) in f32.
template <typename T, int HD>
struct DecodeSmem {
  static constexpr int EPC = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int KS = HD + EPC;
  static constexpr int VS = HD;
  static constexpr size_t V_OFF = 2 * DEC_ROWS * KS * sizeof(T);
  static constexpr size_t Q_OFF = V_OFF + 2 * DEC_ROWS * VS * sizeof(T);
  static size_t bytes(int G) {
    return Q_OFF + (size_t)G * (HD + DEC_ROWS + 1) * sizeof(float);
  }
};

// The new token's rows for the INSERT instance: k/v_new (B, Hkv, hd) in
// TN (the pools' type or f32), and the pools to write them into (the same
// memory as the kernel's kp/vp, which it reads only through cp.async).
// Empty in the decode-only instance.
template <typename T, typename TN>
struct InsertRows {
  const TN* kn;
  const TN* vn;
  T* kw;
  T* vw;
};

template <typename T, int HD, bool PAD, bool INSERT, typename TN>
__global__ void __launch_bounds__(DEC_NT) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int H, int Hkv, int hd_arg, int page,
    int pps, int split_pages, float scale, float softcap,
    InsertRows<T, TN> ins) {
  using L = DecodeSmem<T, HD>;
  const int hd = head_dim<HD, PAD>(hd_arg);
  constexpr int CPR = HD / L::EPC;             // 16-byte chunks a row
  constexpr int NPG = DEC_NT / (HD / 4);       // P.V head groups
  constexpr int APT = (DEC_GMAX + NPG - 1) / NPG;
  constexpr int NPT = (HD + DEC_NT - 1) / DEC_NT;  // new-row elements/thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  const int b = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(lens[b], pps * page);
  const int start = sp * split_pages * page;
  const int end = min(len, start + split_pages * page);
  // partial of head kh * G + g: slot slot0 + g * n_split
  const long long slot0 =
      ((long long)b * H + (long long)kh * G) * n_split + sp;

  if (start >= end) {
    for (int i = tid; i < G * hd; i += DEC_NT)
      ws_acc[(slot0 + (long long)(i / hd) * n_split) * hd + i % hd] = 0.f;
    for (int g = tid; g < G; g += DEC_NT) {
      ws_ml[2 * (slot0 + (long long)g * n_split)] = NEG_INF;
      ws_ml[2 * (slot0 + (long long)g * n_split) + 1] = 0.f;
    }
    return;
  }

  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = reinterpret_cast<T*>(smem_raw + L::V_OFF);
  float* Qs = reinterpret_cast<float*>(smem_raw + L::Q_OFF);
  float* Ps = Qs + G * HD;
  float* Cs = Ps + G * DEC_ROWS;

  // Q of the group in f32, its columns past hd zero
  const T* qb = q + ((long long)b * H + (long long)kh * G) * hd;
  for (int i = tid; i < G * HD; i += DEC_NT) {
    const int d = i % HD;
    Qs[i] = d < hd ? to_f32(qb[(i / HD) * hd + d]) : 0.f;
  }

  const int* tab = table + (long long)b * pps;
  const long long row_elems = (long long)Hkv * hd;

  // INSERT: this block owns position len - 1 iff it lies in [start, end);
  // thread tid keeps elements tid + DEC_NT j (< hd) of the new K and V rows
  const bool owner = INSERT && len - 1 < end;
  T k_new[NPT], v_new[NPT];
  if constexpr (INSERT) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int d = tid + DEC_NT * j;
      if (owner && d < hd) {
        const long long src = ((long long)b * Hkv + kh) * hd + d;
        k_new[j] = from_f32<T>(to_f32(ins.kn[src]));
        v_new[j] = from_f32<T>(to_f32(ins.vn[src]));
        const long long dst =
            ((long long)tab[(len - 1) / page] * page + (len - 1) % page) *
                row_elems + (long long)kh * hd + d;
        ins.kw[dst] = k_new[j];
        ins.vw[dst] = v_new[j];
      }
    }
  }
  const int ntiles = (end - start + DEC_ROWS - 1) / DEC_ROWS;
  auto issue = [&](int t, int buf) {
    const int k0 = start + t * DEC_ROWS;
    const int p0 = k0 / page;
    const int p_last = (min(k0 + DEC_ROWS, end) - 1) / page;
    // one table read per page: lane j holds page p0 + j of the tile
    const int my_pid = p0 + lane <= p_last ? tab[p0 + lane] : 0;
    T* kd = Ks + buf * DEC_ROWS * L::KS;
    T* vd = Vs + buf * DEC_ROWS * L::VS;
#pragma unroll
    for (int base = 0; base < DEC_ROWS * CPR; base += DEC_NT) {
      const int idx = base + tid;
      const int r = idx / CPR, c = (idx % CPR) * L::EPC;
      const int pos = k0 + r;
      const int pid =
          __shfl_sync(0xffffffffu, my_pid, (pos / page - p0) & 31);
      if (r < DEC_ROWS) {
        T* kdst = kd + r * L::KS + c;
        T* vdst = vd + r * L::VS + c;
        if (pos < end && c < hd) {
          const long long src =
              ((long long)pid * page + pos % page) * row_elems +
              (long long)kh * hd + c;
          cp_async16(kdst, kp + src);
          cp_async16(vdst, vp + src);
        } else {
          zero16(kdst);
          zero16(vdst);
        }
      }
    }
  };

  // score heads of this thread: warp + 4 i; their (m, l), replicated
  // across the warp's lanes
  float m[DEC_SPT], l[DEC_SPT];
#pragma unroll
  for (int i = 0; i < DEC_SPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  // P.V: output columns 4 c .. 4 c + 3 of heads hg + NPG a
  const int c4 = tid % (HD / 4), hg = tid / (HD / 4);
  float acc[APT][4];
#pragma unroll
  for (int a = 0; a < APT; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

  issue(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();       // tile t landed; tile t - 1's buffers are free
    if (t + 1 < ntiles) issue(t + 1, (t + 1) & 1);
    cp_async_commit();
    const T* kt = Ks + (t & 1) * DEC_ROWS * L::KS;
    const T* vt = Vs + (t & 1) * DEC_ROWS * L::VS;
    const int k0 = start + t * DEC_ROWS;
    if constexpr (INSERT) {
      // the owner's last tile ends at len - 1: its ring row takes the new
      // values, whatever the copy of that row read
      if (owner && t == ntiles - 1) {
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int d = tid + DEC_NT * j;
          if (d < hd) {
            Ks[((t & 1) * DEC_ROWS + len - 1 - k0) * L::KS + d] = k_new[j];
            Vs[((t & 1) * DEC_ROWS + len - 1 - k0) * L::VS + d] = v_new[j];
          }
        }
        __syncthreads();
      }
    }

    // scores of row `lane` for this warp's heads, then the warp-local
    // softmax update of each head
    float s[DEC_SPT];
#pragma unroll
    for (int i = 0; i < DEC_SPT; ++i) s[i] = 0.f;
    const T* krow = kt + lane * L::KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += L::EPC) {
      float kf[L::EPC];
      load16_f32(krow + d, kf);
#pragma unroll
      for (int i = 0; i < DEC_SPT; ++i) {
        const int g = warp + 4 * i;
        if (g < G) {
          const float* qg = Qs + g * HD + d;
#pragma unroll
          for (int e = 0; e < L::EPC; e += 4) {
            const float4 qv = load4_f32(qg + e);
            s[i] = fmaf(qv.x, kf[e], s[i]);
            s[i] = fmaf(qv.y, kf[e + 1], s[i]);
            s[i] = fmaf(qv.z, kf[e + 2], s[i]);
            s[i] = fmaf(qv.w, kf[e + 3], s[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DEC_SPT; ++i) {
      const int g = warp + 4 * i;
      if (g >= G) continue;
      float v = score_post(s[i], scale, softcap);
      if (k0 + lane >= end) v = NEG_INF;
      float mx = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(v - m_new);
      float rs = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
      Ps[g * DEC_ROWS + lane] = p;
      if (lane == 0) Cs[g] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V over the tile's live rows (4 at a time)
#pragma unroll
    for (int a = 0; a < APT; ++a) {
      const int g = hg + NPG * a;
      if (g < G) {
        const float corr = Cs[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] *= corr;
      }
    }
    const int rows = min(DEC_ROWS, end - k0);
    for (int r = 0; r < rows; r += 4) {
      float4 vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = load4_f32(vt + (r + u) * L::VS + 4 * c4);
#pragma unroll
      for (int a = 0; a < APT; ++a) {
        const int g = hg + NPG * a;
        if (g < G) {
          const float4 p = load4_f32(Ps + g * DEC_ROWS + r);
          const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[a][0] = fmaf(pu[u], vv[u].x, acc[a][0]);
            acc[a][1] = fmaf(pu[u], vv[u].y, acc[a][1]);
            acc[a][2] = fmaf(pu[u], vv[u].z, acc[a][2]);
            acc[a][3] = fmaf(pu[u], vv[u].w, acc[a][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < APT; ++a) {
    const int g = hg + NPG * a;
    if (g < G && 4 * c4 < hd)
      *reinterpret_cast<float4*>(
          ws_acc + (slot0 + (long long)g * n_split) * hd + 4 * c4) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < DEC_SPT; ++i) {
      const int g = warp + 4 * i;
      if (g < G) {
        ws_ml[2 * (slot0 + (long long)g * n_split)] = m[i];
        ws_ml[2 * (slot0 + (long long)g * n_split) + 1] = l[i];
      }
    }
  }
}

// One block of hd (<= HD) threads per (sequence, head): merge the live
// splits in split order, then o = acc / max(l, 1e-37) in the storage type,
// and the row's log-sum-exp into lse[bh] where lse is given.
template <typename T, int HD, bool PAD>
__global__ void __launch_bounds__(HD) paged_decode_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    const int* __restrict__ lens, T* __restrict__ o, float* __restrict__ lse,
    int H, int hd_arg, int page, int pps, int split_pages, int n_split) {
  const int hd = head_dim<HD, PAD>(hd_arg);
  const int bh = blockIdx.x, d = threadIdx.x;
  const int len = min(lens[bh / H], pps * page);
  const int split_rows = split_pages * page;
  const int n_live = min(n_split, (len + split_rows - 1) / split_rows);
  const float* ml = ws_ml + (long long)bh * n_split * 2;
  const float* acc = ws_acc + (long long)bh * n_split * hd;
  float m_max = NEG_INF;
  for (int s = 0; s < n_live; ++s) m_max = fmaxf(m_max, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float corr = expf(ml[2 * s] - m_max);
    l += ml[2 * s + 1] * corr;
    a += acc[(long long)s * hd + d] * corr;
  }
  o[(long long)bh * hd + d] = from_f32<T>(a / fmaxf(l, DEN_MIN));
  if (lse != nullptr && d == 0) lse[bh] = m_max + logf(fmaxf(l, DEN_MIN));
}

template <typename T, int HD, bool PAD, bool INSERT, typename TN>
static cudaError_t launch_decode(const void* q, const void* kp,
                                 const void* vp, const void* table,
                                 const void* lens, void* o, void* ws, int B,
                                 int H, int Hkv, int hd, int page, int pps,
                                 int split_pages, int n_split, float scale,
                                 float softcap, InsertRows<T, TN> ins,
                                 float* lse, cudaStream_t stream) {
  auto kern = paged_decode_split_kernel<T, HD, PAD, INSERT, TN>;
  const size_t bytes = DecodeSmem<T, HD>::bytes(H / Hkv);
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)B * H * n_split * hd;
  kern<<<dim3(B, Hkv, n_split), DEC_NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lens), ws_acc, ws_ml, H, Hkv, hd, page, pps,
      split_pages, scale, softcap, ins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T, HD, PAD><<<B * H, hd, 0, stream>>>(
      ws_acc, ws_ml, static_cast<const int*>(lens), static_cast<T*>(o), lse,
      H, hd, page, pps, split_pages, n_split);
  return cudaGetLastError();
}

static bool decode_shapes_ok(int H, int Hkv, int pps, int split_pages,
                             int n_split) {
  return H % Hkv == 0 && H / Hkv <= DEC_GMAX && split_pages >= 1 &&
         n_split >= 1 && (long long)n_split * split_pages >= pps;
}

// dtype: 0 = float32, 1 = bfloat16. q/o (B, H, hd), pools (num_pages,
// page, Hkv, hd), table (B, pps) i32, lens (B,) i32, all contiguous, the
// pools on 16 bytes; H / Hkv <= 16; hd a multiple of 16 up to 256
// (attn_common.cuh). ws: f32 workspace of B * H * n_split * (hd + 2)
// floats, 16-byte aligned. lse: a (B, H) f32 buffer for each row's
// log-sum-exp, or null. Launches the split kernel and the combine kernel
// on `stream`. Returns a cudaError_t code.
extern "C" int paged_decode(int dtype, int hd, const void* q, const void* kp,
                            const void* vp, const void* table,
                            const void* lens, void* o, void* ws, int B,
                            int H, int Hkv, int page, int pps,
                            int split_pages, int n_split, float scale,
                            float softcap, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (!decode_shapes_ok(H, Hkv, pps, split_pages, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    ATTN_DISPATCH_HD(hd, HD, PAD,
        err = (launch_decode<float, HD, PAD, false, float>(
            q, kp, vp, table, lens, o, ws, B, H, Hkv, hd, page, pps,
            split_pages, n_split, scale, softcap, {}, lse, s)));
  } else if (dtype == 1) {
    ATTN_DISPATCH_HD(hd, HD, PAD,
        err = (launch_decode<__nv_bfloat16, HD, PAD, false, __nv_bfloat16>(
            q, kp, vp, table, lens, o, ws, B, H, Hkv, hd, page, pps,
            split_pages, n_split, scale, softcap, {}, lse, s)));
  }
  return static_cast<int>(err);
}

// paged_insert at (table[b, (len-1) / page], (len-1) % page) of each
// sequence, then paged_decode, in the same two launches as paged_decode.
// new_dtype: the type of k/v_new (B, Hkv, hd) contiguous, 0 = float32 or
// the pools' dtype; they are rounded to the pools' type in the kernel. The
// pools are written in place. Otherwise as paged_decode, lse included.
extern "C" int paged_insert_decode(int dtype, int new_dtype, int hd,
                                   const void* q, const void* kn,
                                   const void* vn, void* kp, void* vp,
                                   const void* table, const void* lens,
                                   void* o, void* ws, int B, int H, int Hkv,
                                   int page, int pps, int split_pages,
                                   int n_split, float scale, float softcap,
                                   float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!decode_shapes_ok(H, Hkv, pps, split_pages, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  using BF = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && new_dtype == 0) {
    const InsertRows<float, float> ins{
        static_cast<const float*>(kn), static_cast<const float*>(vn),
        static_cast<float*>(kp), static_cast<float*>(vp)};
    ATTN_DISPATCH_HD(hd, HD, PAD,
        err = (launch_decode<float, HD, PAD, true, float>(
            q, kp, vp, table, lens, o, ws, B, H, Hkv, hd, page, pps,
            split_pages, n_split, scale, softcap, ins, lse, s)));
  } else if (dtype == 1 && new_dtype == 1) {
    const InsertRows<BF, BF> ins{
        static_cast<const BF*>(kn), static_cast<const BF*>(vn),
        static_cast<BF*>(kp), static_cast<BF*>(vp)};
    ATTN_DISPATCH_HD(hd, HD, PAD,
        err = (launch_decode<BF, HD, PAD, true, BF>(
            q, kp, vp, table, lens, o, ws, B, H, Hkv, hd, page, pps,
            split_pages, n_split, scale, softcap, ins, lse, s)));
  } else if (dtype == 1 && new_dtype == 0) {
    const InsertRows<BF, float> ins{
        static_cast<const float*>(kn), static_cast<const float*>(vn),
        static_cast<BF*>(kp), static_cast<BF*>(vp)};
    ATTN_DISPATCH_HD(hd, HD, PAD,
        err = (launch_decode<BF, HD, PAD, true, float>(
            q, kp, vp, table, lens, o, ws, B, H, Hkv, hd, page, pps,
            split_pages, n_split, scale, softcap, ins, lse, s)));
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
