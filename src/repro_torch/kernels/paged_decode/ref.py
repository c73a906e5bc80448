"""Plain PyTorch versions of paged decode attention and the paged insert
(port of `repro/kernels/paged_decode/ref.py`)."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def paged_decode_ref(q, k_pages, v_pages, block_table, lens, *,
                     scale=None, softcap: float = 0.0):
    """q: (B, H, hd); k/v_pages: (num_pages, page, Hkv, hd); block_table:
    (B, pps) i32; lens: (B,) i32 -> (B, H, hd). Gathers each sequence's
    pages densely (what the kernel avoids) and softmaxes in f32."""
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
    o = torch.einsum("bhs,bshd->bhd", p, vr.float())
    return o.to(q.dtype)


def paged_insert_ref(k_pages, v_pages, k_new, v_new, page_idx, offset):
    """Write one new token per sequence into its page, in place: k/v_pages
    (num_pages, page, Hkv, hd); k/v_new (B, Hkv, hd); page_idx/offset (B,)
    i32. Returns the (updated) pools. Duplicate targets (idle slots all
    aim at trash page 0) leave one of the writes, as on the TPU."""
    pidx, off = page_idx.long(), offset.long()
    k_pages[pidx, off] = k_new.to(k_pages.dtype)
    v_pages[pidx, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages
