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
and C.B^T); each call (four launches: chunk state gradients, reverse
state passing, chunk gradients, reductions) adds one to
`ssd_scan_bwd.launches`, and an empty input none.
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


def ssd_plan(b: int, S: int, nh: int, hd: int, G: int, N: int, chunk: int,
             sm_count: int = 132) -> SsdPlan:
    """Heads per chunk-output block: the most (up to 8) that divide a
    group's heads and still leave a block for every SM."""
    nc = S // chunk
    nqt = -(-chunk // TILE)
    rep = nh // G
    hb = 1
    for d in range(min(rep, MAX_HEADS_PER_BLOCK), 0, -1):
        if rep % d == 0 and b * nc * nqt * (nh // d) >= sm_count:
            hb = d
            break
    return SsdPlan(
        chunks=nc, q_tiles=nqt, heads_per_block=hb,
        grid_state=(nc, nh, b),
        grid_pass=(-(-hd * N // PASS_THREADS), nh, b),
        grid_cb=(nqt * (nqt + 1) // 2, nc * b, G),
        grid_out=(nh // hb, nc * b, nqt),
        states_shape=(b, nc, nh, N, hd), acum_shape=(b, nh, S),
        cb_shape=(b, nc, G, nqt * TILE, nqt * TILE))


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
    None."""
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
    nc = plan.chunks

    def scratch(*shape):
        return torch.empty(shape, dtype=f32, device=x.device)
    dstates = scratch(*plan.states_shape)
    decay = scratch(b, nh, nc)
    dBh, dCh = scratch(b, S, nh, N), scratch(b, S, nh, N)
    pA, pD = scratch(b, nc, nh), scratch(b, nc, nh)
    if b and S and nh:
        check(library().ssd_scan_bwd(
            DTYPE_CODES[x.dtype], hd, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            states.data_ptr(), acum.data_ptr(), cb.data_ptr(), dy.data_ptr(),
            dh_final.data_ptr() if dh_final is not None else None,
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dD.data_ptr(), dh0.data_ptr(), dstates.data_ptr(),
            decay.data_ptr(), dBh.data_ptr(), dCh.data_ptr(), pA.data_ptr(),
            pD.data_ptr(), b, S, nh, G, N, chunk, stream_of(x)),
            name)
        ssd_scan_bwd.launches += 1
    else:
        dA.zero_()
        dD.zero_()
        dh0.copy_(dh_final) if dh_final is not None else dh0.zero_()
    return dx, ddt, dA, dB, dC, dD, dh0 if h0 is not None else None


ssd_scan_bwd.launches = 0
