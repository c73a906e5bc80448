"""Plain PyTorch version of the fused suffix prefill over paged prefix KV
(port of `repro/kernels/prefix_prefill/ref.py`).

Suffix queries attend over (a) a prefix that lives in the paged KV pool,
addressed through a block table, and (b) their own suffix KV, with the
causal mask offset by the prefix length. This version gathers the prefix
pages densely (exactly what the kernel avoids) and runs a masked softmax
in f32."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def prefix_prefill_ref(q, k_suf, v_suf, k_pages, v_pages, prefix_table,
                       prefix_lens, suffix_lens=None, *, scale=None,
                       softcap: float = 0.0):
    """q: (B, H, Sq, hd); k/v_suf: (B, Hkv, Sq, hd); k/v_pages: (num_pages,
    page, Hkv, hd); prefix_table: (B, npp) i32; prefix_lens: (B,) i32;
    suffix_lens: (B,) i32 or None (default Sq). Returns (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    Hkv = k_suf.shape[1]
    page = k_pages.shape[1]
    npp = prefix_table.shape[1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    if suffix_lens is None:
        suffix_lens = torch.full((B,), Sq, dtype=torch.int32, device=dev)

    tab = prefix_table.long()
    kp = k_pages[tab].reshape(B, npp * page, Hkv, hd)
    vp = v_pages[tab].reshape(B, npp * page, Hkv, hd)
    k = torch.cat([kp.transpose(1, 2), k_suf.to(kp.dtype)], dim=2)
    v = torch.cat([vp.transpose(1, 2), v_suf.to(vp.dtype)], dim=2)
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=1)
        v = torch.repeat_interleave(v, G, dim=1)

    P = npp * page
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(P + Sq, device=dev)[None, None, None, :]
    qpos = torch.arange(Sq, device=dev)[None, None, :, None]
    plen = prefix_lens.long()[:, None, None, None]
    slen = suffix_lens.long()[:, None, None, None]
    in_prefix = kpos < P
    mask = torch.where(in_prefix, kpos < plen,
                       ((kpos - P) <= qpos) & ((kpos - P) < slen))
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-37)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
