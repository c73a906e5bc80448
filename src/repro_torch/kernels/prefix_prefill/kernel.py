"""Launch wrapper of the CUDA kernel in `csrc/prefix_prefill.cu`.

Takes the kernel layout of the JAX function, q (B, H, Sq, hd) and
k/v_suf (B, Hkv, Sq, hd), in any strides with a contiguous last dim: the
model's (B, S, H, hd) tensors come in as transposed views, never copied.
The kernel copies rows with 16-byte vector copies, so each of those
tensors must start on 16 bytes with strides in 16-byte units; the
wrapper raises on any other view. CUDA tensors only; each launch adds one
to `prefix_prefill.launches`.
"""
from __future__ import annotations

import math

import torch

from ..build import (DTYPE_CODES, bhs_strides, check, head_dim_instance,
                     library, pad_head_dim, padded_head_dim, require_aligned,
                     require_cuda, stream_of)


def prefix_prefill(q, k_suf, v_suf, k_pages, v_pages, prefix_table,
                   prefix_lens, suffix_lens=None, *, scale=None,
                   softcap: float = 0.0):
    """-> (B, H, Sq, hd), laid out like `q`. A head dim that is not a
    multiple of 16 runs zero-padded to the next one (`padded_head_dim`;
    the pools too, a copy), at the scale of the true head dim."""
    require_cuda("prefix_prefill", q, k_suf, v_suf, k_pages, v_pages,
                 prefix_table, prefix_lens)
    B, H, Sq, hd = q.shape
    Hkv = k_suf.shape[1]
    _, page, _, _ = k_pages.shape
    dt = q.dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in
                                    (k_suf, v_suf, k_pages, v_pages)):
        raise TypeError("prefix_prefill: f32/bf16 tensors of one dtype")
    if q.numel() == 0:
        return torch.zeros_like(q)      # no query row: nothing to launch
    hdp = padded_head_dim("prefix_prefill", hd)
    if hdp != hd:
        pad = [pad_head_dim(t, hdp) for t in (q, k_suf, v_suf, k_pages,
                                               v_pages)]
        return prefix_prefill(
            *pad, prefix_table, prefix_lens, suffix_lens,
            scale=scale if scale is not None else 1.0 / math.sqrt(hd),
            softcap=softcap)[..., :hd]
    head_dim_instance("prefix_prefill", hd)
    if H % Hkv:
        raise ValueError(f"prefix_prefill: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if suffix_lens is None:
        suffix_lens = torch.full((B,), Sq, dtype=torch.int32, device=q.device)
    for t in (prefix_table, prefix_lens, suffix_lens):
        if t.dtype != torch.int32:
            raise TypeError("prefix_prefill: table and lengths must be int32")
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    prefix_table = prefix_table.contiguous()
    prefix_lens, suffix_lens = prefix_lens.contiguous(), \
        suffix_lens.contiguous()
    require_aligned("prefix_prefill", q, k_suf, v_suf, k_pages, v_pages)
    out = torch.empty_like(q)       # keeps q's strides (dense views)
    strides = bhs_strides(q, k_suf, v_suf, out)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    check(library().prefix_prefill(
        DTYPE_CODES[dt], hd, q.data_ptr(), k_suf.data_ptr(),
        v_suf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        prefix_table.data_ptr(), prefix_lens.data_ptr(),
        suffix_lens.data_ptr(), out.data_ptr(), strides, B, H, Hkv, Sq,
        page, prefix_table.shape[1], float(scale), float(softcap or 0.0),
        stream_of(q)), "prefix_prefill")
    prefix_prefill.launches += 1
    return out


prefix_prefill.launches = 0
