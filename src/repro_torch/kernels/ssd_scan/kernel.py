"""Launch wrapper of the CUDA kernels in `csrc/ssd_scan.cu`.

Takes the JAX layout, x (b, S, nh, hd), dt (b, S, nh) f32, A and D (nh,)
f32, B and C (b, S, G, N), h0 (b, nh, hd, N) f32 or None, all contiguous
on one CUDA device. One call of the op makes four CUDA launches (chunk
states, state passing, C.B^T, chunk outputs; see `ssd_plan`) and adds
one to `ssd_scan.launches`: the count is of op calls that launch, one
per prefill layer. An empty input (b, S or nh 0) launches nothing and
counts nothing.

`ssd_scan_bwd` wraps `csrc/ssd_scan_bwd.cu`, the gradient, from what the
forward kept (`keep_scratch=True`: each chunk's carried-in state, a_cum
and C.B^T); each call (seven launches, `ssd_bwd_plan`: chunk state
gradients, reverse state passing, the source side of each chunk by head
blocks, its head side by heads, its query side by head blocks, the scan of
d a_cum, the fixed-order sums) adds one to `ssd_scan_bwd.launches`, and
an empty input none.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..build import DTYPE_CODES, check, library, require_cuda, stream_of

HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 256        # the chunk-output kernel keeps C.B^T of 4 tiles
TILE = 64              # rows of a query tile and of a source tile
PASS_THREADS = 256     # state elements a block of the passing kernel
MAX_HEADS_PER_BLOCK = 8


@dataclass(frozen=True)
class SsdPlan:
    """The four launches of one `ssd_scan` call, from shapes alone. The
    wrapper hands these grids to the C entry, which launches them as they
    are; `cb_block` and `out_block` state how the kernels read their
    block index.

    1. chunk states, grid `grid_state` = (nc, nh, b): one block per
       (chunk, head) scans dt * A within the chunk (into `acum`, (b, nh,
       S) f32) and writes S_c = (x dt exp(a_last - a_cum))^T B into
       `states` ((b, nc, nh, N, hd) f32: transposed, so that phase 4 reads
       rows of h_in^T).
    2. state passing, grid `grid_pass` = (ceil(hd N / 256), nh, b): each
       thread walks the nc chunks of one state element, overwrites S_c by
       the chunk's carried-in state h_in and writes h_final.
    3. C.B^T, grid `grid_cb` = (q_tiles (q_tiles + 1) / 2, nc b, G): one
       block per (query tile, source tile at or below it), chunk and
       group writes its 64 x 64 tile into `cb` ((b, nc, G, QP, QP) f32,
       QP = q_tiles * 64), once for all the heads of the group.
    4. chunk outputs, grid `grid_out` = (nh / heads_per_block, nc b,
       q_tiles): block (x, y, z) serves chunk y % nc of batch y // nc,
       query tile q_tiles - 1 - z (the heaviest first) and heads x *
       heads_per_block .. + heads_per_block - 1, all of one group.
    """
    chunks: int
    q_tiles: int
    heads_per_block: int
    grid_state: Tuple[int, int, int]
    grid_pass: Tuple[int, int, int]
    grid_cb: Tuple[int, int, int]
    grid_out: Tuple[int, int, int]
    states_shape: Tuple[int, ...]
    acum_shape: Tuple[int, ...]
    cb_shape: Tuple[int, ...]

    def cb_block(self, x: int, y: int, z: int):
        """(batch, chunk, group, query tile, source tile) of C.B^T block
        (x, y, z): x counts the pairs source tile <= query tile row by
        row."""
        qt, si = 0, x
        while si > qt:
            si -= qt + 1
            qt += 1
        return y // self.chunks, y % self.chunks, z, qt, si

    def out_block(self, x: int, y: int, z: int):
        """(batch, chunk, query tile, heads) of chunk-output block (x, y,
        z), as the kernel reads its block index."""
        hb = self.heads_per_block
        return (y // self.chunks, y % self.chunks, self.q_tiles - 1 - z,
                tuple(range(x * hb, (x + 1) * hb)))


def heads_per_block(b: int, nc: int, nqt: int, nh: int, G: int,
                    sm_count: int) -> int:
    """The most heads (up to 8) that divide a group's heads and still leave
    a block for every SM, a block serving one (batch, chunk, 64-row tile,
    head block); 1 where none does."""
    rep = nh // G
    for d in range(min(rep, MAX_HEADS_PER_BLOCK), 0, -1):
        if rep % d == 0 and b * nc * nqt * (nh // d) >= sm_count:
            return d
    return 1


def ssd_plan(b: int, S: int, nh: int, hd: int, G: int, N: int, chunk: int,
             sm_count: int = 132) -> SsdPlan:
    """Heads per chunk-output block by `heads_per_block`."""
    nc = S // chunk
    nqt = -(-chunk // TILE)
    hb = heads_per_block(b, nc, nqt, nh, G, sm_count)
    return SsdPlan(
        chunks=nc, q_tiles=nqt, heads_per_block=hb,
        grid_state=(nc, nh, b),
        grid_pass=(-(-hd * N // PASS_THREADS), nh, b),
        grid_cb=(nqt * (nqt + 1) // 2, nc * b, G),
        grid_out=(nh // hb, nc * b, nqt),
        states_shape=(b, nc, nh, N, hd), acum_shape=(b, nh, S),
        cb_shape=(b, nc, G, nqt * TILE, nqt * TILE))


@dataclass(frozen=True)
class SsdBwdPlan:
    """The seven launches of one `ssd_scan_bwd` call, from shapes alone
    (grids as the C entry launches them; `src_block`, `head_block` and
    `qry_block` state how launches 3-5 read their block index), and the
    f32 scratch each shape needs. hb = `heads_per_block`, nhb = nh / hb head blocks, QP the
    chunk rounded up to 64.

    1. dstate, grid `grid_dstate` = (nc, nh, b): G_c into `dstates_shape`
       (the forward's states layout, [n][d]).
    2. reverse pass, grid `grid_pass` = (ceil(hd N / 256), nh, b): one
       thread per state element; G_c becomes dh_out[c], and each block
       writes its part of the decay's dot into `decay_shape` (b, nh, nc,
       blocks).
    3. source side, grid `grid_src` = (nhb, nc b, q_tiles): block (x, y,
       z) serves head block x of chunk y % nc, batch y // nc, source tile
       z (tile 0, with the most query tiles after it, first). It writes
       the head block's summed dCB tiles (`dcb_shape`, [s][t]; in bf16 two
       bf16 planes in the same bytes), its rows of dB (`parts_shape`,
       (b, S, nhb, N)) and row vectors (`vecs_shape`: the rowsum of dCB o
       CB by source tile, then colsum, q, sum_d d xdt x and y_off, QP
       each).
    4. head side, grid `grid_head` = (q_tiles, nh, nc b): block (x, y, z)
       serves source tile x of head y, chunk z % nc, batch z // nc (the
       tiles that read one head's dS run together): dx, q, sum_d d xdt x
       and dy . x by source tile (`dyx_shape`).
    5. query side, grid `grid_qry` = (q_tiles, nhb, nc b): block (x, y,
       z) serves query tile q_tiles - 1 - x (the most source tiles first)
       of head block y: its rows of dC (`parts_shape`) and y_off.
    6. scan, grid `grid_scan` = (nh, nc, b): ddt and the chunk's parts of
       dA and dD (`ad_shape`).
    7. reduce, grid `grid_reduce`: dB, dC over each group's head blocks,
       dA, dD over the (batch, chunk) parts.
    """
    chunks: int
    q_tiles: int
    heads_per_block: int
    grid_dstate: Tuple[int, int, int]
    grid_pass: Tuple[int, int, int]
    grid_src: Tuple[int, int, int]
    grid_head: Tuple[int, int, int]
    grid_qry: Tuple[int, int, int]
    grid_scan: Tuple[int, int, int]
    grid_reduce: Tuple[int, int, int]
    dstates_shape: Tuple[int, ...]
    split_shape: Tuple[int, ...]
    decay_shape: Tuple[int, ...]
    dcb_shape: Tuple[int, ...]
    vecs_shape: Tuple[int, ...]
    dyx_shape: Tuple[int, ...]
    parts_shape: Tuple[int, ...]
    ad_shape: Tuple[int, ...]

    @property
    def grids(self):
        return (self.grid_dstate, self.grid_pass, self.grid_src,
                self.grid_head, self.grid_qry, self.grid_scan,
                self.grid_reduce)

    def src_block(self, x: int, y: int, z: int):
        """(batch, chunk, source tile, heads) of source-side block (x, y,
        z)."""
        hb = self.heads_per_block
        return (y // self.chunks, y % self.chunks, z,
                tuple(range(x * hb, (x + 1) * hb)))

    def head_block(self, x: int, y: int, z: int):
        """(batch, chunk, source tile, head) of head-side block (x, y,
        z)."""
        return z // self.chunks, z % self.chunks, x, y

    def qry_block(self, x: int, y: int, z: int):
        """(batch, chunk, query tile, heads) of query-side block (x, y,
        z)."""
        hb = self.heads_per_block
        return (z // self.chunks, z % self.chunks, self.q_tiles - 1 - x,
                tuple(range(y * hb, (y + 1) * hb)))

    def scratch_shapes(self):
        """Every f32 scratch tensor of a call, by its C name."""
        return dict(dstates=self.dstates_shape, dsplit=self.split_shape,
                    hsplit=self.split_shape, decay=self.decay_shape,
                    dcb=self.dcb_shape, vecs=self.vecs_shape,
                    dyx=self.dyx_shape, dBp=self.parts_shape,
                    dCp=self.parts_shape, pA=self.ad_shape,
                    pD=self.ad_shape)


def ssd_bwd_plan(b: int, S: int, nh: int, hd: int, G: int, N: int,
                 chunk: int, sm_count: int = 132,
                 bf16: bool = False) -> SsdBwdPlan:
    """`bf16`: the call's dtype is bf16, whose dS and h_in go to the
    tensor cores as bf16 pairs (`split_shape` is the states' then, else
    empty)."""
    nc = S // chunk
    nqt = -(-chunk // TILE)
    QP = nqt * TILE
    hb = heads_per_block(b, nc, nqt, nh, G, sm_count)
    nhb = nh // hb
    npass = -(-hd * N // PASS_THREADS)
    reduce_work = max(b * S * G * N, nh)
    return SsdBwdPlan(
        chunks=nc, q_tiles=nqt, heads_per_block=hb,
        grid_dstate=(nc, nh, b), grid_pass=(npass, nh, b),
        grid_src=(nhb, nc * b, nqt), grid_head=(nqt, nh, nc * b),
        grid_qry=(nqt, nhb, nc * b),
        grid_scan=(nh, nc, b),
        grid_reduce=(-(-reduce_work // PASS_THREADS), 1, 1),
        dstates_shape=(b, nc, nh, N, hd),
        split_shape=(b, nc, nh, N, hd) if bf16 else (0,),
        decay_shape=(b, nh, nc, npass),
        dcb_shape=(b, nc, nhb, QP, QP), vecs_shape=(b, nc, nh, nqt + 4, QP),
        dyx_shape=(b, nc, nh, nqt), parts_shape=(b, S, nhb, N),
        ad_shape=(b, nc, nh))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, x, dt, A, B, C, D, h0, chunk):
    """The checks the forward and the backward make on the forward's
    inputs; the tensors are on one CUDA device."""
    f32 = torch.float32
    tensors = [x, dt, A, B, C, D] + ([h0] if h0 is not None else [])
    require_cuda(name, *tensors)
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"{name}: x, B, C are f32 or bf16, of one dtype")
    if any(t.dtype != f32 for t in (dt, A, D)) or \
            (h0 is not None and h0.dtype != f32):
        raise TypeError(f"{name}: dt, A, D and h0 are f32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if hd not in HEAD_DIMS or N % 16 or N > MAX_STATE or nh % G:
        raise ValueError(f"{name}: unsupported hd={hd}, N={N}, nh={nh}, "
                         f"G={G}")
    if chunk <= 0 or chunk > MAX_CHUNK or S % chunk:
        raise ValueError(f"{name}: S={S} is not a multiple of "
                         f"chunk={chunk} (at most {MAX_CHUNK})")
    if tuple(dt.shape) != (b, S, nh) or tuple(C.shape) != tuple(B.shape) \
            or tuple(B.shape[:2]) != (b, S) or A.shape != (nh,) \
            or D.shape != (nh,) \
            or (h0 is not None and tuple(h0.shape) != (b, nh, hd, N)):
        raise ValueError(f"{name}: inconsistent shapes")


def ssd_scan(x, dt, A, B, C, D, *, chunk: int, h0=None,
             keep_scratch: bool = False):
    """-> (y (b, S, nh, hd) in x's dtype, h_final (b, nh, hd, N) f32), and
    with `keep_scratch` a third item, what the backward reads: (states,
    acum, cb), each chunk's carried-in state h_in ((b, nc, nh, N, hd),
    transposed), a_cum ((b, nh, S)) and C.B^T ((b, nc, G, QP, QP), [s][t]),
    all f32."""
    f32 = torch.float32
    _check("ssd_scan", x, dt, A, B, C, D, h0, chunk)
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((b, nh, hd, N), dtype=f32, device=x.device)
    plan = ssd_plan(b, S, nh, hd, G, N, chunk,
                    _sm_count(x.device.index or 0))
    states = torch.empty(plan.states_shape, dtype=f32, device=x.device)
    acum = torch.empty(plan.acum_shape, dtype=f32, device=x.device)
    cb = torch.empty(plan.cb_shape, dtype=f32, device=x.device)
    if b and S and nh:
        grids = (ctypes.c_int * 12)(*plan.grid_state, *plan.grid_pass,
                                    *plan.grid_cb, *plan.grid_out)
        check(library().ssd_scan(
            DTYPE_CODES[x.dtype], hd, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            h.data_ptr(), states.data_ptr(), acum.data_ptr(), cb.data_ptr(),
            b, S, nh, G, N, chunk, plan.heads_per_block, grids,
            stream_of(x)),
            "ssd_scan")
        ssd_scan.launches += 1
    else:
        h.copy_(h0) if h0 is not None else h.zero_()
    if keep_scratch:
        return y, h, (states, acum, cb)
    return y, h


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, A, B, C, D, kept, dy, dh_final=None, *, chunk: int,
                 h0=None):
    """The gradient of `ssd_scan`: its inputs as it takes them, `kept` the
    (states, acum, cb) of its call with `keep_scratch=True`, dy like y and
    dh_final (b, nh, hd, N) f32 or None (zeros) -> (dx, ddt, dA, dB, dC,
    dD, dh0): dx, dB, dC in x's dtype, the rest f32; dh0 None where h0 is
    None. The scratch is `ssd_bwd_plan`'s, all f32: G_c / dh_out like the
    kept states (in bf16 also dh_out's and h_in's hi / lo planes, each the
    states' size), each head block's summed dCB tiles, (b, S, nh / hb, N)
    row parts of dB and dC (hb heads a block, not one row a head), and
    small per-chunk vectors; one op call, seven launches."""
    f32 = torch.float32
    name = "ssd_scan_bwd"
    _check(name, x, dt, A, B, C, D, h0, chunk)
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    states, acum, cb = kept
    plan = ssd_plan(b, S, nh, hd, G, N, chunk)
    extra = [states, acum, cb, dy] + ([dh_final] if dh_final is not None
                                      else [])
    require_cuda(name, x, *extra)
    if tuple(states.shape) != plan.states_shape \
            or tuple(acum.shape) != plan.acum_shape \
            or tuple(cb.shape) != plan.cb_shape \
            or any(t.dtype != f32 for t in (states, acum, cb)):
        raise ValueError(f"{name}: `kept` is not what ssd_scan kept for "
                         f"these shapes")
    if dy.shape != x.shape or dy.dtype != x.dtype or (
            dh_final is not None and (dh_final.dtype != f32 or tuple(
                dh_final.shape) != (b, nh, hd, N))):
        raise ValueError(f"{name}: dy must be like x, dh_final (b, nh, hd, "
                         f"N) f32")
    if not all(t.is_contiguous() for t in extra):
        raise ValueError(f"{name}: every tensor must be contiguous")
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    dD = torch.empty_like(D)
    dh0 = torch.empty((b, nh, hd, N), dtype=f32, device=x.device)
    bplan = ssd_bwd_plan(b, S, nh, hd, G, N, chunk,
                         _sm_count(x.device.index or 0),
                         bf16=x.dtype == torch.bfloat16)
    scr = {k: torch.empty(v, dtype=f32, device=x.device)
           for k, v in bplan.scratch_shapes().items()}
    if b and S and nh:
        grids = (ctypes.c_int * 21)(*(n for g in bplan.grids for n in g))
        check(library().ssd_scan_bwd(
            DTYPE_CODES[x.dtype], hd, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            states.data_ptr(), acum.data_ptr(), cb.data_ptr(), dy.data_ptr(),
            dh_final.data_ptr() if dh_final is not None else None,
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
            *(scr[k].data_ptr() for k in (
                "dstates", "dsplit", "hsplit", "decay", "dcb", "vecs", "dyx",
                "dBp", "dCp", "pA", "pD")),
            b, S, nh, G, N, chunk, bplan.heads_per_block, int(h0 is not None),
            grids, stream_of(x)),
            name)
        ssd_scan_bwd.launches += 1
    else:
        dA.zero_()
        dD.zero_()
        dh0.copy_(dh_final) if dh_final is not None else dh0.zero_()
    return dx, ddt, dA, dB, dC, dD, dh0 if h0 is not None else None


ssd_scan_bwd.launches = 0
