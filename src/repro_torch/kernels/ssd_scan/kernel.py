"""Launch wrapper of the CUDA kernels in `csrc/ssd_scan.cu`.

Takes the JAX layout, x (b, S, nh, hd), dt (b, S, nh) f32, A and D (nh,)
f32, B and C (b, S, G, N), h0 (b, nh, hd, N) f32 or None, all contiguous
on one CUDA device. One call of the op makes four CUDA launches (chunk
states, state passing, C.B^T, chunk outputs; see `ssd_plan`) and adds
one to `ssd_scan.launches`: the count is of op calls, one per prefill
layer.
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


def ssd_scan(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """-> (y (b, S, nh, hd) in x's dtype, h_final (b, nh, hd, N) f32)."""
    f32 = torch.float32
    tensors = [x, dt, A, B, C, D] + ([h0] if h0 is not None else [])
    require_cuda("ssd_scan", *tensors)
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError("ssd_scan: x, B, C are f32 or bf16, of one dtype")
    if any(t.dtype != f32 for t in (dt, A, D)) or \
            (h0 is not None and h0.dtype != f32):
        raise TypeError("ssd_scan: dt, A, D and h0 are f32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: every tensor must be contiguous")
    if hd not in HEAD_DIMS or N % 16 or N > MAX_STATE or nh % G:
        raise ValueError(f"ssd_scan: unsupported hd={hd}, N={N}, nh={nh}, "
                         f"G={G}")
    if chunk <= 0 or chunk > MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of "
                         f"chunk={chunk} (at most {MAX_CHUNK})")
    if tuple(dt.shape) != (b, S, nh) or tuple(C.shape) != tuple(B.shape) \
            or tuple(B.shape[:2]) != (b, S) or A.shape != (nh,) \
            or D.shape != (nh,) \
            or (h0 is not None and tuple(h0.shape) != (b, nh, hd, N)):
        raise ValueError("ssd_scan: inconsistent shapes")
    y = torch.empty_like(x)
    h = torch.empty((b, nh, hd, N), dtype=f32, device=x.device)
    if b and S and nh:
        plan = ssd_plan(b, S, nh, hd, G, N, chunk,
                        _sm_count(x.device.index or 0))
        states = torch.empty(plan.states_shape, dtype=f32, device=x.device)
        acum = torch.empty(plan.acum_shape, dtype=f32, device=x.device)
        cb = torch.empty(plan.cb_shape, dtype=f32, device=x.device)
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
    return y, h


ssd_scan.launches = 0
