"""Launch wrapper of the CUDA kernel in `csrc/flash_prefill.cu`.

Takes the kernel layout of the JAX function, q (B, H, Sq, hd) and k/v
(B, Hkv, Skv, hd), in any strides with a contiguous last dim, so the
model's (B, S, H, hd) tensors come in as transposed views. CUDA tensors
only; each launch adds one to `flash_prefill.launches`.
"""
from __future__ import annotations

import math

import torch

from ..build import (DTYPE_CODES, HEAD_DIMS, bhs_strides, check, library,
                     require_cuda, stream_of)


def flash_prefill(q, k, v, *, causal=True, window: int = 0, scale=None,
                  softcap: float = 0.0):
    """-> (B, H, Sq, hd), laid out like `q`."""
    require_cuda("flash_prefill", q, k, v)
    B, H, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_prefill: f32/bf16 tensors of one dtype")
    if hd not in HEAD_DIMS or H % Hkv:
        raise ValueError(f"flash_prefill: unsupported hd={hd}, H={H}, "
                         f"Hkv={Hkv}")
    out = torch.empty_like(q)       # keeps q's strides (dense views)
    strides = bhs_strides(q, k, v, out)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    check(library().flash_prefill(
        DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides, B, H, Hkv, Sq, Skv, int(bool(causal)),
        int(window), float(scale), float(softcap or 0.0), stream_of(q)),
        "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
