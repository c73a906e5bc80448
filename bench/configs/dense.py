"""Plain reference of a dense decoder (Llama / Mistral / Yi family), in
float32 with TF32 off, in plain PyTorch: RMSNorm, rotary embeddings
(half-split, `rope_theta`), grouped-query causal attention, a SwiGLU
feed-forward, untied output head, as the configuration file states them.

It reads the weights that the benchmark drew (`dense_model.py`, the
port's layout: norms in the (1 + w) form, the FFN's gate and up fused in
`wi`) and imports nothing of the port. A whole sequence runs at once,
a layer at a time: each layer's weights are upcast on their own, and
attention runs in blocks of queries, so a 13k-token sequence fits beside
the served weights.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms(x, w, eps):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def _rope(x, cos, sin):
    """x: (T, heads, hd); cos, sin: (T, hd / 2)."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)


def logits(params: Dict[str, Any], cfg: Dict[str, Any],
           tokens: torch.Tensor, first: int,
           weight: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
           q_block: int = 1024) -> torch.Tensor:
    """Float32 logits (T - first, V) at positions first..T-1 of `tokens`
    (T,), each predicting the next token. `weight` maps each matrix to
    the float32 tensor used in its product (default: upcast); the
    control passes a lower-precision rounding here."""
    _no_tf32()
    up = weight or (lambda w: w.float())
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"]
    hd = cfg.get("head_dim") or d // H
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    T = tokens.shape[0]
    dev = params["embed"].device
    tokens = tokens.to(dev)
    pos = torch.arange(T, device=dev, dtype=torch.float32)
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=dev,
                                        dtype=torch.float32) / hd))
    ang = pos[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    causal_ok = (torch.arange(T, device=dev)[None, :]
                 <= torch.arange(T, device=dev)[:, None])   # (q, k)

    seg = params["seg0"]
    x = params["embed"][tokens].float()
    for l in range(cfg["num_hidden_layers"]):
        at = seg["attn"]
        h = _rms(x, seg["ln1"]["w"][l], eps)
        q = (h @ up(at["wq"][l]).reshape(d, H * hd)).view(T, H, hd)
        k = (h @ up(at["wk"][l]).reshape(d, Hkv * hd)).view(T, Hkv, hd)
        v = (h @ up(at["wv"][l]).reshape(d, Hkv * hd)).view(T, Hkv, hd)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
        o = torch.empty_like(q)
        for s in range(0, T, q_block):
            e = min(T, s + q_block)
            sc = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * hd ** -0.5
            sc = sc.masked_fill(~causal_ok[s:e, :e], float("-inf"))
            o[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:e])
            del sc
        x = x + o.reshape(T, H * hd) @ up(at["wo"][l]).reshape(H * hd, d)
        del q, k, v, o
        h = _rms(x, seg["ln2"]["w"][l], eps)
        g, u = torch.chunk(h @ up(seg["ffn"]["wi"][l]), 2, dim=-1)
        x = x + (F.silu(g) * u) @ up(seg["ffn"]["wo"][l])
        del h, g, u
    h = _rms(x[first:], params["final_norm"]["w"], eps)
    return h @ up(params["lm_head"])


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """The control's rounding: a matrix to float8 e4m3 with one scale for
    the tensor (its largest magnitude at e4m3's 448), back in float32: one
    step below the configuration's bfloat16."""
    w = w.float()
    scale = w.abs().amax().clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale
