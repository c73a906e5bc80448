"""Attention of the transformer (port of `repro/models/attention.py`).

`flash_reference` is the blocked online-softmax oracle the JAX model runs
for prefill: it visits only the (q_block, kv_block) tiles that intersect
the causal / sliding-window band and accumulates in f32. `dense_attention`
is the naive O(S^2) oracle. Both take the model layout (B, S, H, hd). The
port's prefill runs the `flash_prefill` kernel instead; these stay as the
plain versions the tests and the kernel's CPU path are held against.

`slab_attend` is the counterpart of JAX `decode_attend`: one query token
per sequence over a dense slab cache (B, Smax, Hkv, hd). Where JAX
computes it in jnp, the port views the slab as a page pool (no copy) and
runs the `paged_decode` kernel over an identity block table.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch

from ..kernels.paged_decode.ops import paged_decode_op

NEG_INF = -2.3819763e38  # finite "minus infinity" of the flash kernels


def _band_tiles(n_q: int, n_kv: int, block_q: int, block_kv: int,
                causal: bool, window: int) -> List[Tuple[int, int]]:
    """Static tile schedule: tiles (i, j) intersecting the attention band."""
    tiles = []
    for i in range(n_q):
        q_lo, q_hi = i * block_q, (i + 1) * block_q - 1
        for j in range(n_kv):
            k_lo, k_hi = j * block_kv, (j + 1) * block_kv - 1
            if causal and k_lo > q_hi:
                continue
            if window and k_hi < q_lo - window + 1:
                continue
            tiles.append((i, j))
    return tiles


def flash_reference(q, k, v, *, causal=True, window: int = 0,
                    block_q: int = 512, block_kv: int = 512,
                    scale: Optional[float] = None,
                    logit_softcap: float = 0.0,
                    prefix_len: Optional[int] = None):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd). GQA by head groups.

    When Sq < Skv the leading Skv - Sq kv positions are a prefix every
    query sees (offset causal mask). `prefix_len` (scalar) additionally
    marks only the first `prefix_len` of those positions valid.
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    assert H % Hkv == 0
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device

    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    pq = (-Sq) % block_q
    pkv = (-Skv) % block_kv
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pkv))
    Sqp, Skvp = Sq + pq, Skv + pkv
    n_q, n_kv = Sqp // block_q, Skvp // block_kv
    tiles = _band_tiles(n_q, n_kv, block_q, block_kv, causal and Sq == Skv,
                        window)

    acc = torch.zeros((B, Sqp, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sqp, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sqp, H), dtype=torch.float32, device=dev)
    q_idx = torch.arange(block_q, device=dev)
    kv_idx = torch.arange(block_kv, device=dev)
    for ti, tj in tiles:
        qsl = slice(ti * block_q, (ti + 1) * block_q)
        ksl = slice(tj * block_kv, (tj + 1) * block_kv)
        qs4 = q[:, qsl].reshape(B, block_q, Hkv, G, hd).float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qs4, k[:, ksl].float()) * scale
        if logit_softcap:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        qpos = ti * block_q + q_idx
        kpos = tj * block_kv + kv_idx
        if causal:
            mask = kpos[None, :] <= Skv - Sq + qpos[:, None]
        else:
            mask = torch.ones((block_q, block_kv), dtype=torch.bool,
                              device=dev)
        if window:
            mask = mask & (kpos[None, :] > Skv - Sq + qpos[:, None] - window)
        mask = mask & (kpos[None, :] < Skv)             # kv padding
        if prefix_len is not None:
            mask = mask & ((kpos[None, :] < prefix_len)
                           | (kpos[None, :] >= Skv - Sq))
        s = torch.where(mask[None, None, None], s, NEG_INF)

        s_max = s.amax(dim=-1).permute(0, 3, 1, 2).reshape(B, block_q, H)
        m_blk, l_blk, a_blk = m[:, qsl], l[:, qsl], acc[:, qsl]
        m_new = torch.maximum(m_blk, s_max)
        m_for_s = m_new.reshape(B, block_q, Hkv, G).permute(0, 2, 3, 1)
        p = torch.exp(s - m_for_s[..., None])
        corr = torch.exp(m_blk - m_new)
        l_new = l_blk * corr + p.sum(-1).permute(0, 3, 1, 2).reshape(
            B, block_q, H)
        pv = torch.einsum("bkgqs,bskh->bqkgh", p, v[:, ksl].float())
        acc[:, qsl] = a_blk * corr[..., None] + pv.reshape(B, block_q, H, hd)
        m[:, qsl] = m_new
        l[:, qsl] = l_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out[:, :Sq].to(q.dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain attention computes in: f32, or f64 for f64
    inputs (the gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def attention_mask(Sq: int, Skv: int, causal: bool, window: int, device):
    """(Sq, Skv) bool: key kp visible to query row r, the last Sq of the
    Skv positions (kp <= Skv - Sq + r when causal, kp > Skv - Sq + r -
    window with a window)."""
    qpos = torch.arange(Sq, device=device)
    kpos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= Skv - Sq + qpos[:, None]
    if window:
        mask &= kpos[None, :] > Skv - Sq + qpos[:, None] - window
    return mask


def dense_attention(q, k, v, *, causal=True, window: int = 0,
                    scale: Optional[float] = None, logit_softcap: float = 0.0):
    """Naive O(S^2) oracle. q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd)."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    acc = acc_dtype(q.dtype)
    qs = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qs.to(acc), k.to(acc)) * scale
    if logit_softcap:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(acc))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the dense slab as a page pool
# ---------------------------------------------------------------------------

def slab_page(smax: int) -> int:
    """Rows a page of the slab's page view: the largest of 32, 16, 8, 4, 2
    and 1 that divides `smax` (32 rows fill one tile of the decode kernel)."""
    return next(p for p in (32, 16, 8, 4, 2, 1) if smax % p == 0)


@functools.lru_cache(maxsize=None)
def slab_table(batch: int, smax: int, device: torch.device):
    """The block table of a (batch, smax) slab's page view, the identity:
    `table[b, j] = b * smax / page + j`, built once per shape and
    device."""
    pps = smax // slab_page(smax)
    return torch.arange(batch * pps, dtype=torch.int32,
                        device=device).reshape(batch, pps)


def slab_pages(k_cache, v_cache):
    """View a slab layer's caches (B, Smax, Hkv, hd), contiguous, as page
    pools (B * Smax / page, page, Hkv, hd) without a copy, with the block
    table that maps them back (`slab_table`). Returns (k_pages, v_pages,
    table); writes into the pools land in the slab."""
    B, smax, hkv, hd = k_cache.shape
    page = slab_page(smax)
    shape = (B * smax // page, page, hkv, hd)
    return (k_cache.view(shape), v_cache.view(shape),
            slab_table(B, smax, k_cache.device))


def slab_attend(q, k_cache, v_cache, kv_len, *, scale: Optional[float] = None,
                logit_softcap: float = 0.0, plain: bool = False,
                return_lse: bool = False):
    """One-token attention against a slab cache (JAX `decode_attend` with
    `window=0`). q: (B, H, hd); caches: (B, Smax, Hkv, hd); kv_len: (B,)
    i32 valid slots. A ring cache (sliding window) holds the last Smax
    tokens in rotation and is masked by slot validity alone, which is what
    `kv_len = min(pos + 1, Smax)` gives: softmax does not depend on the
    order of the keys. Runs the `paged_decode` kernel over the slab's page
    view (its plain version on the CPU or with `plain`). -> (B, H, hd), and
    with `return_lse` also the (B, H) f32 log-sum-exp of each row's live
    scores (`paged_decode_op`)."""
    kp, vp, table = slab_pages(k_cache, v_cache)
    lens = torch.broadcast_to(torch.as_tensor(kv_len, dtype=torch.int32,
                                              device=q.device),
                              (q.shape[0],)).contiguous()
    return paged_decode_op(q, kp, vp, table, lens, scale=scale,
                           softcap=logit_softcap, plain=plain,
                           return_lse=return_lse)
