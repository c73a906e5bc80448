"""Launch wrapper of the CUDA kernels in `csrc/flash_prefill.cu`.

Takes the kernel layout of the JAX function, q (B, H, Sq, hd) and k/v
(B, Hkv, Skv, hd), in any strides with a contiguous last dim, so the
model's (B, S, H, hd) tensors come in as transposed views. Every tensor
must start on 16 bytes with strides in 16-byte units: the f32 kernel
copies 16-byte chunks, the bf16 kernel reads through TMA tensor maps.
CUDA tensors only; each launch adds one to `flash_prefill.launches`.
"""
from __future__ import annotations

import functools
import math

import torch

from ..build import (DTYPE_CODES, bhs_strides, check, head_dim_instance,
                     library, require_aligned, require_cuda, stream_of)

BQ = 64                 # query rows a consumer warpgroup (and a f32 block)


def flash_heads_per_block(B: int, H: int, Hkv: int, Sq: int,
                          sm_count: int = 132, hd: int = 128) -> int:
    """Query heads a block of the bf16 kernel serves, from shapes alone.

    Two query heads of one kv head (two consumer warpgroups that take
    turns on the tensor cores) halve the K/V bytes copied per product, but
    halve the blocks; they are taken where H / Hkv is even and the grid
    still has a block for at least 3/4 of the SMs. On an H100, yi-6b at
    S = 512 (128 blocks for 132 SMs) runs faster with two, at S = 200 (64
    blocks) with one. Head dims above 128 run on the 256 instance, whose
    tiles leave shared memory for one query head only."""
    blocks = B * (H // 2) * -(-Sq // BQ)
    if hd <= 128 and (H // Hkv) % 2 == 0 and 4 * blocks >= 3 * sm_count:
        return 2
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_prefill(q, k, v, *, causal=True, window: int = 0, scale=None,
                  softcap: float = 0.0):
    """-> (B, H, Sq, hd), laid out like `q`."""
    require_cuda("flash_prefill", q, k, v)
    B, H, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_prefill: f32/bf16 tensors of one dtype")
    head_dim_instance("flash_prefill", hd)
    if H % Hkv:
        raise ValueError(f"flash_prefill: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    out = torch.empty_like(q)       # keeps q's strides (dense views)
    require_aligned("flash_prefill", q, k, v, out)
    strides = bhs_strides(q, k, v, out)
    qh = flash_heads_per_block(B, H, Hkv, Sq, _sm_count(q.device.index or 0),
                               hd)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    check(library().flash_prefill(
        DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides, B, H, Hkv, Sq, Skv,
        int(bool(causal)), int(window), float(scale), float(softcap or 0.0),
        qh, stream_of(q)), "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
