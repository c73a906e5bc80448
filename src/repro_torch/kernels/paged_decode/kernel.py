"""Launch wrappers of the CUDA kernels in `csrc/paged_decode.cu`.

Each wrapper checks its inputs, allocates the output, launches on the
current stream and counts the launch in its `launches` attribute. They
take CUDA tensors only; `ops.py` routes CPU tensors to the plain
versions in `ref.py`.
"""
from __future__ import annotations

import functools
import math

import torch

from ..build import (DTYPE_CODES, check, head_dim_instance, library,
                     pad_head_dim, padded_head_dim, require_aligned,
                     require_cuda, stream_of)


DEC_ROWS = 32          # kv positions a tile of the split kernel
DEC_GMAX = 16          # largest query-head group H / Hkv a launch takes


def decode_split(B: int, Hkv: int, pps: int, page: int,
                 sm_count: int = 132):
    """(pages per split, number of splits) of the split kernel, from shapes
    alone (never from `lens`: the decode loop does not sync with the host).

    Pages per split is the largest power of two that still gives
    B * Hkv * n_split >= 2 * sm_count blocks, but no fewer pages than fill
    one 32-row tile, and no more than the table has."""
    least = max(1, -(-DEC_ROWS // page))
    per = 1
    while per < pps:
        per *= 2
    while per > least and B * Hkv * -(-pps // per) < 2 * sm_count:
        per //= 2
    per = max(1, min(per, pps))
    return per, -(-pps // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_decode(name, q, k_pages, v_pages, block_table, lens):
    """The checks every decode launch makes; raises on what the split
    kernel does not take."""
    require_cuda(name, q, k_pages, v_pages, block_table, lens)
    _, H, hd = q.shape
    Hkv = k_pages.shape[2]
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: f32/bf16 of one dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    padded_head_dim(name, hd)
    if H % Hkv:
        raise ValueError(f"{name}: H={H} is not a multiple of Hkv={Hkv}")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and lens must be int32")


def _by_groups(q, Hkv, run):
    """`run(q_part, first)` -> (out, lse or None) over slices of at most
    `DEC_GMAX` query heads of each kv head's group (the split kernel's
    largest group), both put back in head order; `first` is true for the
    first slice only. A group of at most `DEC_GMAX` is one call on `q`
    itself."""
    B, H, hd = q.shape
    G = H // Hkv
    if G <= DEC_GMAX:
        return run(q, True)
    qg = q.view(B, Hkv, G, hd)
    outs, lses = [], []
    for g0 in range(0, G, DEC_GMAX):
        g = min(DEC_GMAX, G - g0)
        # contiguous: with one kv head the slice reshapes to a view with
        # the whole group's batch stride, which the kernel does not take
        part = qg[:, :, g0:g0 + g].reshape(B, Hkv * g, hd).contiguous()
        out, lse = run(part, g0 == 0)
        outs.append(out.view(B, Hkv, g, hd))
        lses.append(None if lse is None else lse.view(B, Hkv, g))
    lse = None if lses[0] is None else torch.cat(lses, dim=2).view(B, H)
    return torch.cat(outs, dim=2).view(B, H, hd), lse


def _launch_decode(q, k_pages, v_pages, block_table, lens, scale, softcap,
                   k_new=None, v_new=None, with_lse=False):
    """Launch the C entry `paged_decode`, or `paged_insert_decode` when new
    rows are given, over query-head slices of at most `DEC_GMAX` a group
    (the rows go in with the first slice; the rest only read them), or
    zero-padded to the next multiple of 16 where the head dim is not one:
    the pools are then padded copies, and an insert is copied back into
    the pools. -> ((B, H, hd), the (B, H) f32 log-sum-exp of each row's
    scaled and capped live scores where `with_lse`, else None)."""
    B, H, hd = q.shape
    Hkv = k_pages.shape[2]
    hdp = padded_head_dim("paged_decode", hd)
    if hdp != hd:
        scale = scale if scale is not None else 1.0 / math.sqrt(hd)
        kp, vp = pad_head_dim(k_pages, hdp), pad_head_dim(v_pages, hdp)
        new = [None if t is None else pad_head_dim(t, hdp)
               for t in (k_new, v_new)]
        out, lse = _launch_decode(pad_head_dim(q, hdp), kp, vp, block_table,
                                  lens, scale, softcap, *new, with_lse)
        if k_new is not None:
            k_pages.copy_(kp[..., :hd])
            v_pages.copy_(vp[..., :hd])
        return out[..., :hd].contiguous(), lse

    def run(part, first):
        new = (k_new, v_new) if first else (None, None)
        return _launch_split(part, k_pages, v_pages, block_table, lens,
                             scale, softcap, *new, with_lse)
    return _by_groups(q, Hkv, run)


def _launch_split(q, k_pages, v_pages, block_table, lens, scale, softcap,
                  k_new=None, v_new=None, with_lse=False):
    """Allocate the output (and the log-sum-exp where `with_lse`) and the
    split workspace and launch one C entry, for a group of at most
    `DEC_GMAX` query heads and a compiled head dim. -> (out, lse or
    None)."""
    head_dim_instance("paged_decode", q.shape[2])
    require_aligned("paged_decode", k_pages, v_pages)
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    pps = block_table.shape[1]
    per, n_split = decode_split(B, Hkv, pps, page,
                                _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    ws = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                     device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tail = (k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            lens.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, Hkv, page,
            pps, per, n_split, float(scale), float(softcap or 0.0),
            None if lse is None else lse.data_ptr(), stream_of(q))
    if k_new is None:
        check(library().paged_decode(DTYPE_CODES[q.dtype], hd, q.data_ptr(),
                                     *tail), "paged_decode")
    else:
        check(library().paged_insert_decode(
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_new.dtype], hd, q.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), *tail),
            "paged_insert_decode")
    return out, lse


def paged_decode(q, k_pages, v_pages, block_table, lens, *, scale=None,
                 softcap: float = 0.0, return_lse: bool = False):
    """q: (B, H, hd); k/v_pages: (num_pages, page, Hkv, hd); block_table:
    (B, pps) i32; lens: (B,) i32 -> (B, H, hd), and with `return_lse` also
    the (B, H) f32 log-sum-exp of each row's scaled (and capped) live
    scores (about -2.38e38 for a row with no live key). Two launches
    (split, combine) count as one call of the op, as do the launches of a
    group above `DEC_GMAX` query heads, which runs in slices
    (`_by_groups`)."""
    _check_decode("paged_decode", q, k_pages, v_pages, block_table, lens)
    if q.numel() == 0:
        # no query: nothing to launch
        out = torch.zeros_like(q)
        return (out, torch.zeros(q.shape[:2], device=q.device)) \
            if return_lse else out
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    block_table, lens = block_table.contiguous(), lens.contiguous()
    out, lse = _launch_decode(q, k_pages, v_pages, block_table, lens, scale,
                              softcap, with_lse=return_lse)
    paged_decode.launches += 1
    return (out, lse) if return_lse else out


paged_decode.launches = 0


def paged_insert_decode(q, k_new, v_new, k_pages, v_pages, block_table,
                        lens, *, scale=None, softcap: float = 0.0):
    """`paged_insert` of k/v_new (B, Hkv, hd) at page `block_table[b,
    (len-1) // page]`, row `(len-1) % page` (len = min(lens[b], pps *
    page); nothing where it is 0), in place, then `paged_decode`, in the
    split kernel's two launches. k/v_new are f32 or the pools' dtype and
    are rounded to the pools' dtype in the kernel. One call counts once
    in `paged_decode.launches`, in `paged_insert.launches` and in its own
    `launches`."""
    name = "paged_insert_decode"
    _check_decode(name, q, k_pages, v_pages, block_table, lens)
    require_cuda(name, q, k_new, v_new)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name}: the pools are written in place and "
                         f"must be contiguous")
    B, _, hd = q.shape
    Hkv = k_pages.shape[2]
    if tuple(k_new.shape) != (B, Hkv, hd) or k_new.shape != v_new.shape:
        raise ValueError(f"{name}: new rows {tuple(k_new.shape)} do not "
                         f"match (B, Hkv, hd) = {(B, Hkv, hd)}")
    if k_new.dtype not in (torch.float32, k_pages.dtype) \
            or v_new.dtype != k_new.dtype:
        raise TypeError(f"{name}: new rows of f32 or the pools' "
                        f"{k_pages.dtype}, got {k_new.dtype}, "
                        f"{v_new.dtype}")
    if q.numel() == 0:
        return torch.zeros_like(q)      # no sequence: nothing to launch
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    block_table, lens = block_table.contiguous(), lens.contiguous()
    out, _ = _launch_decode(q, k_pages, v_pages, block_table, lens, scale,
                            softcap, k_new, v_new)
    paged_decode.launches += 1
    paged_insert.launches += 1
    paged_insert_decode.launches += 1
    return out


paged_insert_decode.launches = 0


def paged_insert(k_pages, v_pages, k_new, v_new, page_idx, offset):
    """In place: row `offset[b]` of page `page_idx[b]` of each pool takes
    `k/v_new[b]`. k/v_pages (num_pages, page, Hkv, hd) contiguous; k/v_new
    (B, Hkv, hd); page_idx/offset (B,) i32. Returns the pools."""
    require_cuda("paged_insert", k_pages, v_pages, k_new, v_new, page_idx,
                 offset)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_insert: the pools are written in place and "
                         "must be contiguous")
    if page_idx.dtype != torch.int32 or offset.dtype != torch.int32:
        raise TypeError("paged_insert: page_idx and offset must be int32")
    if k_pages.dtype not in DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_insert: pools of f32/bf16, got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    _, page, Hkv, hd = k_pages.shape
    B = k_new.shape[0]
    if tuple(k_new.shape) != (B, Hkv, hd) or k_new.shape != v_new.shape:
        raise ValueError(f"paged_insert: new rows {tuple(k_new.shape)} do "
                         f"not match pools {tuple(k_pages.shape)}")
    k_new = k_new.to(k_pages.dtype).contiguous()
    v_new = v_new.to(v_pages.dtype).contiguous()
    page_idx, offset = page_idx.contiguous(), offset.contiguous()
    if B:
        check(library().paged_insert(
            k_pages.element_size(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), page_idx.data_ptr(),
            offset.data_ptr(), B, page, Hkv * hd, stream_of(k_pages)),
            "paged_insert")
        paged_insert.launches += 1
    return k_pages, v_pages


paged_insert.launches = 0
