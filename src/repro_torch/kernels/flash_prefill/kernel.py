"""Launch wrapper of the CUDA kernels in `csrc/flash_prefill.cu`.

Takes the kernel layout of the JAX function, q (B, H, Sq, hd) and k/v
(B, Hkv, Skv, hd), in any strides with a contiguous last dim, so the
model's (B, S, H, hd) tensors come in as transposed views. Every tensor
must start on 16 bytes with strides in 16-byte units: the f32 kernel
copies 16-byte chunks, the bf16 kernel reads through TMA tensor maps.
CUDA tensors only; each launch adds one to `flash_prefill.launches`.

`flash_prefill_bwd` wraps `csrc/flash_prefill_bwd.cu`, the gradient,
from the forward's output and log-sum-exp; each call (three kernel
launches, four where the bf16 dQ pass splits its walk) adds one to
`flash_prefill_bwd.launches`. The warpgroups of its bf16 kernels and the
dQ split come from shapes alone (`bwd_warpgroups`, `bwd_dq_split`).
"""
from __future__ import annotations

import functools
import math

import torch

from ..build import (DTYPE_CODES, bhs_strides, check, head_dim_instance,
                     library, pad_head_dim, padded_head_dim, require_aligned,
                     require_cuda, stream_of)

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


def bwd_warpgroups(B: int, H: int, Hkv: int, Sq: int, hd: int = 128,
                   sm_count: int = 132) -> tuple:
    """(NC, QH) of the bf16 backward kernels at hd <= 128, from shapes
    alone: NC consumer warpgroups of the dK/dV kernel, which take
    alternate items (query head of the group, 64-row q tile) of a block's
    walk over the same 64 kv rows, and QH query heads a block of the dQ
    kernel. NC = 2 where a walk has at least two items (G ceil(Sq / 64)
    >= 2), so the two warpgroups' products interleave on the tensor cores;
    one item leaves the second idle. QH follows the forward
    (`flash_heads_per_block`): the dQ kernel holds Q and dO of QH heads and
    streams K and V as the forward streams them. Head dims above 128 run
    the mma.sync kernels of the 256 instance, which take neither: (1,
    1)."""
    if hd > 128:
        return 1, 1
    nc = 2 if (H // Hkv) * -(-Sq // BQ) >= 2 else 1
    return nc, flash_heads_per_block(B, H, Hkv, Sq, sm_count, hd)


def bwd_dq_split(B: int, H: int, Sq: int, Skv: int, qh: int,
                 hd: int = 128, sm_count: int = 132) -> int:
    """Parts of each q tile's kv walk in the bf16 dQ kernel (hd <= 128),
    from shapes alone: 1 where its B H / QH ceil(Sq / 64) blocks fill at
    least half the SMs, else as many parts as fill the card, each at
    least two 64-key tiles long (seamless-m4t's cross-attention, 64
    queries over 1024 frames: 16 blocks, cut 8 ways). The parts' f32 sums
    are added in a fourth launch."""
    blocks = B * H // qh * -(-Sq // BQ)
    if hd > 128 or 2 * blocks >= sm_count:
        return 1
    return max(1, min(-(-Skv // 64) // 2, sm_count // blocks))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_lse(name, lse, q):
    B, H, Sq = q.shape[:3]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{name}: lse must be a contiguous f32 "
                         f"{(B, H, Sq)} tensor on {q.device}")


def flash_prefill(q, k, v, *, causal=True, window: int = 0, scale=None,
                  softcap: float = 0.0, lse=None):
    """-> (B, H, Sq, hd), laid out like `q`. A head dim that is not a
    multiple of 16 runs zero-padded to the next one (`padded_head_dim`),
    at the scale of the true head dim. With `lse`, a contiguous (B, H, Sq)
    f32 buffer, the kernel also writes each row's natural-log log-sum-exp
    of its scaled (and capped) visible scores, for the backward."""
    require_cuda("flash_prefill", q, k, v)
    if lse is not None:
        _check_lse("flash_prefill", lse, q)
    B, H, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_prefill: f32/bf16 tensors of one dtype")
    if q.numel() == 0 or Skv == 0:
        # nothing to launch: no query row, or no key (a row with no key
        # attends nothing: zeros, and the log-sum-exp of no score, -inf)
        if lse is not None:
            lse.fill_(float("-inf"))
        return torch.zeros_like(q)
    hdp = padded_head_dim("flash_prefill", hd)
    if hdp != hd:
        return flash_prefill(
            pad_head_dim(q, hdp), pad_head_dim(k, hdp), pad_head_dim(v, hdp),
            causal=causal, window=window,
            scale=scale if scale is not None else 1.0 / math.sqrt(hd),
            softcap=softcap, lse=lse)[..., :hd]
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
        qh, None if lse is None else lse.data_ptr(), stream_of(q)),
        "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_prefill_bwd(q, k, v, o, lse, do, *, causal=True, window: int = 0,
                      scale=None, softcap: float = 0.0):
    """The gradient of `flash_prefill`: q, do and the forward's output o
    (B, H, Sq, hd), k, v (B, Hkv, Skv, hd) in any 16-byte strides, the
    forward's (B, H, Sq) f32 log-sum-exp `lse` -> (dq, dk, dv) in the
    input dtype, laid out like q, k and v. A head dim that is not a
    multiple of 16 runs zero-padded, as in the forward."""
    name = "flash_prefill_bwd"
    require_cuda(name, q, k, v, o, lse, do)
    B, H, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype
                                         for t in (k, v, o, do)):
        raise TypeError(f"{name}: f32/bf16 tensors of one dtype")
    if o.shape != q.shape or do.shape != q.shape or v.shape != k.shape:
        raise ValueError(f"{name}: o and do must be shaped like q, v like k")
    _check_lse(name, lse, q)
    if q.numel() == 0 or k.numel() == 0:
        # no query row or no key: every gradient is zero (the C entry
        # launches nothing either)
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    if H % Hkv:
        raise ValueError(f"{name}: H={H} is not a multiple of Hkv={Hkv}")
    hdp = padded_head_dim(name, hd)
    if hdp != hd:
        grads = flash_prefill_bwd(
            *(pad_head_dim(t, hdp) for t in (q, k, v, o)), lse,
            pad_head_dim(do, hdp), causal=causal, window=window,
            scale=scale if scale is not None else 1.0 / math.sqrt(hd),
            softcap=softcap)
        return tuple(g[..., :hd] for g in grads)
    head_dim_instance(name, hd)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # LSE and D = rowsum(dO o O) by 64-row tiles, (B H, nq, 2, 64)
    ld = torch.empty(B * H * -(-Sq // BQ) * 2 * BQ, dtype=torch.float32,
                     device=q.device)
    require_aligned(name, q, k, v, o, do, dq, dk, dv)
    strides = bhs_strides(q, k, v, o, do, dq, dk, dv)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    sm = _sm_count(q.device.index or 0)
    nc, qh = bwd_warpgroups(B, H, Hkv, Sq, hd, sm)
    split = bwd_dq_split(B, H, Sq, Skv, qh, hd, sm) \
        if q.dtype == torch.bfloat16 else 1
    part = torch.empty(split * B * H * -(-Sq // BQ) * BQ * hd,
                       dtype=torch.float32, device=q.device) \
        if split > 1 else None
    check(library().flash_prefill_bwd(
        DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), ld.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, B, H, Hkv, Sq,
        Skv, int(bool(causal)), int(window), float(scale),
        float(softcap or 0.0), nc, qh, split,
        None if part is None else part.data_ptr(), stream_of(q)), name)
    flash_prefill_bwd.launches += 1
    return dq, dk, dv


flash_prefill_bwd.launches = 0
