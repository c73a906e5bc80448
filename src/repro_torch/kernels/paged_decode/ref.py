"""Plain PyTorch versions of paged decode attention and the paged insert
(port of `repro/kernels/paged_decode/ref.py`)."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def paged_decode_ref(q, k_pages, v_pages, block_table, lens, *,
                     scale=None, softcap: float = 0.0,
                     return_lse: bool = False):
    """q: (B, H, hd); k/v_pages: (num_pages, page, Hkv, hd); block_table:
    (B, pps) i32; lens: (B,) i32 -> (B, H, hd). Gathers each sequence's
    pages densely (what the kernel avoids) and softmaxes in f32. With
    `return_lse` also the (B, H) f32 log-sum-exp of each row's scaled (and
    capped) scores, masked ones at NEG_INF (about NEG_INF for a row with
    no live key)."""
    B, H, hd = q.shape
    num_pages, page_size, Hkv, _ = k_pages.shape
    pps = block_table.shape[1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tab = block_table.long()
    k_seq = k_pages[tab].reshape(B, pps * page_size, Hkv, hd)
    v_seq = v_pages[tab].reshape(B, pps * page_size, Hkv, hd)
    kr = torch.repeat_interleave(k_seq, G, dim=2)
    vr = torch.repeat_interleave(v_seq, G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kr.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(pps * page_size, device=q.device)
    mask = pos[None, :] < lens.long()[:, None]
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, vr.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def insert_at_lens(k_pages, v_pages, k_new, v_new, block_table, lens,
                   first_page: int = 0, n_pages=None):
    """`paged_insert_ref` of each sequence's new row at position len - 1
    (len = min(lens[b], pps * page)): page `block_table[b, (len-1) //
    page]`, row `(len-1) % page`. Sequences with len = 0, or whose
    position lies outside table slots [first_page, first_page + n_pages),
    write nothing. Returns the pools."""
    page = k_pages.shape[1]
    pps = block_table.shape[1]
    n = lens.long().clamp(max=pps * page)
    slot = (n - 1).clamp(min=0) // page
    hit = (n > 0) & (slot >= first_page)
    if n_pages is not None:
        hit &= slot < first_page + n_pages
    b = torch.nonzero(hit).flatten()
    pidx = block_table[b, slot[b]]
    return paged_insert_ref(k_pages, v_pages, k_new[b], v_new[b], pidx,
                            (n[b] - 1) % page)


def paged_insert_decode_ref(q, k_new, v_new, k_pages, v_pages, block_table,
                            lens, *, scale=None, softcap: float = 0.0):
    """`insert_at_lens`, in place, then `paged_decode_ref`: the function of
    the fused insert-and-decode kernel. Shapes as `paged_decode_ref`, with
    k/v_new (B, Hkv, hd)."""
    insert_at_lens(k_pages, v_pages, k_new, v_new, block_table, lens)
    return paged_decode_ref(q, k_pages, v_pages, block_table, lens,
                            scale=scale, softcap=softcap)


def paged_decode_split_ref(q, k_pages, v_pages, block_table, lens, *,
                           split_pages: int, scale=None,
                           softcap: float = 0.0, k_new=None, v_new=None):
    """The CUDA kernel's split-and-merge algorithm in plain PyTorch (the
    tests hold it against the JAX kernel; the op never runs it). Split s
    covers table slots [s * split_pages, (s + 1) * split_pages) and gives a
    partial (m, l, acc) over its live positions, or the empty partial
    (NEG_INF, 0, 0) when it starts at or past `lens`. The partials merge in
    split order with corr = exp(m_s - m_max), then acc / max(l, 1e-37).
    Same shapes as `paged_decode_ref`. With `k_new`/`v_new` (B, Hkv, hd),
    the split that holds position len - 1 first writes the new row there,
    in place (`insert_at_lens`), as the kernel's insert instance does."""
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    pps = block_table.shape[1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    live_len = lens.long().clamp(max=pps * page)
    qf = q.float().reshape(B, Hkv, G, hd)
    parts = []
    for p0 in range(0, pps, split_pages):
        if k_new is not None:
            insert_at_lens(k_pages, v_pages, k_new, v_new, block_table, lens,
                           p0, split_pages)
        tab = block_table[:, p0:p0 + split_pages].long()
        k = k_pages[tab].reshape(B, -1, Hkv, hd).float()
        v = v_pages[tab].reshape(B, -1, Hkv, hd).float()
        s = torch.einsum("bkgd,brkd->bkgr", qf, k) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        pos = p0 * page + torch.arange(k.shape[1], device=q.device)
        live = pos[None, :] < live_len[:, None]                  # (B, R)
        s = torch.where(live[:, None, None, :], s, NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        empty = ~live.any(-1)[:, None, None]
        m = torch.where(empty, NEG_INF, m)
        p = torch.where(empty[..., None], 0.0, p)
        parts.append((m, p.sum(-1), torch.einsum("bkgr,brkd->bkgd", p, v)))
    m_max = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(m_max)
    acc = torch.zeros_like(qf)
    for m, ls, a in parts:                         # fixed order, no atomics
        corr = torch.exp(m - m_max)
        l = l + ls * corr
        acc = acc + a * corr[..., None]
    o = acc / torch.clamp(l, min=1e-37)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def paged_insert_ref(k_pages, v_pages, k_new, v_new, page_idx, offset):
    """Write one new token per sequence into its page, in place: k/v_pages
    (num_pages, page, Hkv, hd); k/v_new (B, Hkv, hd); page_idx/offset (B,)
    i32. Returns the (updated) pools. Duplicate targets (idle slots all
    aim at trash page 0) leave one of the writes, as on the TPU."""
    pidx, off = page_idx.long(), offset.long()
    k_pages[pidx, off] = k_new.to(k_pages.dtype)
    v_pages[pidx, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages
