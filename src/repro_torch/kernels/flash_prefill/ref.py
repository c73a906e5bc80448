"""Plain PyTorch version of flash prefill attention (port of
`repro/kernels/flash_prefill/ref.py`): a masked f32 softmax over the
whole score matrix, computed by `models.attention.dense_attention` on
the kernel layout's transposed views.

`flash_prefill_bwd_ref` is the plain version of the gradient kernel
(`csrc/flash_prefill_bwd.cu`), written out as the formula the kernel
computes (not taken through autograd): P recomputed from the forward's
log-sum-exp, D = rowsum(dO o O), dS = P o (dP - D) times the soft cap's
derivative. The JAX package has no backward kernel; its train step
differentiates `flash_reference`, which the tests hold this against.
"""
from __future__ import annotations

import math

import torch

from ...models.attention import NEG_INF, acc_dtype, attention_mask, \
    dense_attention


def _scores(q, k, scale, softcap):
    """Scaled, capped f32 (or f64) scores (B, Hkv, G, Sq, Skv) and the
    tanh of the cap (None without one), kernel layout in."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    acc = acc_dtype(q.dtype)
    qg = q.to(acc).reshape(B, Hkv, H // Hkv, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(acc)) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    return s, t


def flash_prefill_ref(q, k, v, *, causal=True, window: int = 0,
                      scale=None, softcap: float = 0.0,
                      return_lse: bool = False):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, H, Sq, hd), and
    with `return_lse` also the (B, H, Sq) natural-log log-sum-exp of each
    row's scaled (and capped) visible scores, as the kernel writes it for
    the backward (f32; f64 for f64 inputs)."""
    o = dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        scale=scale, logit_softcap=softcap).transpose(1, 2)
    if not return_lse:
        return o
    B, H, Sq, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s, _ = _scores(q, k, scale, softcap)
    mask = attention_mask(Sq, k.shape[2], causal, window, q.device)
    lse = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)
    return o, lse.reshape(B, H, Sq)


def flash_prefill_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                          window: int = 0, scale=None, softcap: float = 0.0):
    """The gradient of `flash_prefill_ref` from its output `o`, its
    log-sum-exp `lse` (B, H, Sq) and the output's gradient `do`, in the
    kernel layout (q, o, do (B, H, Sq, hd); k, v (B, Hkv, Skv, hd)) ->
    (dq, dk, dv) in the input dtype. Computed in f32 (f64 for f64
    inputs); dK and dV sum over each kv head's group of query heads."""
    B, H, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    acc = acc_dtype(q.dtype)
    s, t = _scores(q, k, scale, softcap)
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(acc).reshape(
        B, Hkv, G, Sq, 1)), 0.0)
    dog = do.to(acc).reshape(B, Hkv, G, Sq, hd)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.to(acc))
    d = (dog * o.to(acc).reshape(B, Hkv, G, Sq, hd)).sum(-1, keepdim=True)
    ds = p * (dp - d)
    if t is not None:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.to(acc)).reshape(
        B, H, Sq, hd)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds,
                      q.to(acc).reshape(B, Hkv, G, Sq, hd))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
