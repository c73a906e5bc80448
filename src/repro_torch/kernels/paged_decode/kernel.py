"""Launch wrappers of the CUDA kernels in `csrc/paged_decode.cu`.

Each wrapper checks its inputs, allocates the output, launches on the
current stream and counts the launch in its `launches` attribute. They
take CUDA tensors only; `ops.py` routes CPU tensors to the plain
versions in `ref.py`.
"""
from __future__ import annotations

import math

import torch

from ..build import (DTYPE_CODES, HEAD_DIMS, check, library, require_cuda,
                     stream_of)


def paged_decode(q, k_pages, v_pages, block_table, lens, *, scale=None,
                 softcap: float = 0.0):
    """q: (B, H, hd); k/v_pages: (num_pages, page, Hkv, hd); block_table:
    (B, pps) i32; lens: (B,) i32 -> (B, H, hd)."""
    require_cuda("paged_decode", q, k_pages, v_pages, block_table, lens)
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode: f32/bf16 of one dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if hd not in HEAD_DIMS or H % Hkv or page > 64:
        raise ValueError(f"paged_decode: unsupported hd={hd}, H={H}, "
                         f"Hkv={Hkv}, page={page}")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_decode: block_table and lens must be int32")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    block_table, lens = block_table.contiguous(), lens.contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    check(library().paged_decode(
        DTYPE_CODES[q.dtype], hd, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, H, Hkv, page, block_table.shape[1], float(scale),
        float(softcap or 0.0), stream_of(q)), "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


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
