"""Plain PyTorch version of flash prefill attention (port of
`repro/kernels/flash_prefill/ref.py`): a masked f32 softmax over the
whole score matrix, computed by `models.attention.dense_attention` on
the kernel layout's transposed views."""
from __future__ import annotations

from ...models.attention import dense_attention


def flash_prefill_ref(q, k, v, *, causal=True, window: int = 0,
                      scale=None, softcap: float = 0.0):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, H, Sq, hd)."""
    o = dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        scale=scale, logit_softcap=softcap)
    return o.transpose(1, 2)
