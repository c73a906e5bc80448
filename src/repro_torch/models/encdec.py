"""Encoder-decoder model, the seamless-m4t backbone (port of
`repro/models/encdec.py`). The audio frontend is a stub, as in JAX: the
encoder takes precomputed frame embeddings (B, T_src, d).

prefill = encoder pass + cross-KV projection + decoder prefill over the
target prefix; decode = decoder step (the self-KV slab grows, the cross
KV is fixed). The encoder runs `flash_prefill(causal=False)` over the
frames; the decoder's self-attention is causal `flash_prefill` and its
cross-attention `flash_prefill(causal=False)` with Sq = S_tgt and Skv =
T_src. A decode step's self-attention is the fused `paged_insert` +
`paged_decode` over the slab's page view (`transformer.attn_decode`), its
cross-attention `paged_decode` over the cross-KV slab at full length
(`attention.slab_attend`, JAX `decode_attend`). `plain=True` runs the
plain versions instead. The serving engine does not run this family (nor
does the JAX engine); it runs at the facade (`models/api.py`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import sharded
from .common import (TensorSpec, apply_norm, embed_lookup, layer_of,
                     norm_params, param, shard)
from .moe import dense_ffn_apply, dense_ffn_params
from .transformer import (_out_proj, _qkv, attn_decode, attn_full,
                          attn_params, slab_slots)


def _xattn_params(gen, cfg, *, device, stack):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, stack=stack)
    return {"wq": param(gen, (d, H, hd), ("embed", "heads", None), **kw),
            "wk": param(gen, (d, Hkv, hd), ("kv_embed", "kv_heads", None),
                        **kw),
            "wv": param(gen, (d, Hkv, hd), ("kv_embed", "kv_heads", None),
                        **kw),
            "wo": param(gen, (H, hd, d), ("heads", None, "embed"), **kw)}


def init(gen: torch.Generator, cfg, *, device) -> Dict[str, Any]:
    """Random f32 params at the JAX init scales, drawn on `device` from
    `gen` (a generator on that device)."""
    d = cfg.d_model

    def block(n, cross):
        kw = dict(device=device, stack=n)
        p = {"ln1": norm_params(gen, d, cfg, **kw),
             "attn": attn_params(gen, cfg, **kw)}
        if cross:
            p["lnx"] = norm_params(gen, d, cfg, **kw)
            p["xattn"] = _xattn_params(gen, cfg, **kw)
        p["ln2"] = norm_params(gen, d, cfg, **kw)
        p["ffn"] = dense_ffn_params(gen, d, cfg.d_ff, **kw)
        return p
    return {
        "embed": param(gen, (cfg.vocab_size, d), ("vocab", "embed"),
                       device=device, scale=d ** -0.5),
        "enc": block(cfg.encoder_layers, False),
        "enc_norm": norm_params(gen, d, cfg, device=device),
        "dec": block(cfg.num_layers, True),
        "final_norm": norm_params(gen, d, cfg, device=device),
        "lm_head": param(gen, (d, cfg.vocab_size), ("embed", "vocab"),
                         device=device),
    }


def _proj(x, w):
    """(..., d) x (d, heads, hd) -> (..., heads, hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def _enc_layer(x, pl, cfg, positions, attn_blocks, plain):
    h = apply_norm(x, pl["ln1"], cfg)
    q, k, v = _qkv(pl["attn"], h, cfg, positions, cfg.rope_theta)
    o = sharded.flash_prefill(q, k, v, causal=False,
                              block_q=attn_blocks[0],
                              block_kv=attn_blocks[1], plain=plain)
    x = x + _out_proj(o, pl["attn"]["wo"])
    h = apply_norm(x, pl["ln2"], cfg)
    return x + dense_ffn_apply(pl["ffn"], h, cfg)


def encode(params, src_embeds, cfg, attn_blocks=(512, 512),
           plain: bool = False):
    """src_embeds: (B, T, d) frame embeddings -> encoder output (B, T, d)."""
    x = shard(src_embeds, "batch", None, "embed_act")
    B, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None]
    for l in range(cfg.encoder_layers):
        x = _enc_layer(x, layer_of(params["enc"], l), cfg, positions,
                       attn_blocks, plain)
    return apply_norm(x, params["enc_norm"], cfg)


def _dec_layer(x, pl, enc_out, cfg, positions, attn_blocks, plain):
    h = apply_norm(x, pl["ln1"], cfg)
    a, kv = attn_full(pl["attn"], h, cfg, "dense", positions, attn_blocks,
                      plain=plain)
    x = x + a
    h = apply_norm(x, pl["lnx"], cfg)
    xa = pl["xattn"]
    q = _proj(h, xa["wq"])
    xk, xv = _proj(enc_out, xa["wk"]), _proj(enc_out, xa["wv"])
    o = sharded.flash_prefill(q, xk, xv, causal=False,
                              block_q=attn_blocks[0],
                              block_kv=attn_blocks[1], plain=plain)
    x = x + _out_proj(o, xa["wo"])
    h = apply_norm(x, pl["ln2"], cfg)
    return x + dense_ffn_apply(pl["ffn"], h, cfg), kv, (xk, xv)


def _decoder_forward(params, tgt_tokens, enc_out, cfg, attn_blocks,
                     return_cache=False, max_len=None, plain=False):
    x = params["embed"][tgt_tokens.long()]
    x = shard(x, "batch", None, "embed_act")
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    ks, vs, xks, xvs = [], [], [], []
    for l in range(cfg.num_layers):
        x, (k, v), (xk, xv) = _dec_layer(x, layer_of(params["dec"], l),
                                         enc_out, cfg, positions,
                                         attn_blocks, plain)
        if return_cache:
            ks.append(k)
            vs.append(v)
            xks.append(xk)
            xvs.append(xv)
    x = apply_norm(x, params["final_norm"], cfg)
    if return_cache:
        x = x[:, -1:]          # last-position logits only at prefill
    logits = shard(x @ params["lm_head"], "batch", None, "vocab")
    cache = None
    if return_cache:
        k, v = torch.stack(ks), torch.stack(vs)
        target = max_len if max_len is not None else S
        if S < target:
            pad = (0, 0, 0, 0, 0, target - S)
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        cache = {"k": k, "v": v, "xk": torch.stack(xks),
                 "xv": torch.stack(xvs),
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}
    return logits, cache


def forward(params, batch, cfg, *, remat=False, attn_blocks=(512, 512),
            return_cache=False, max_len=None, plain: bool = False):
    """batch: {"src_embeds": (B, T, d), "tokens": (B, S)}. Returns
    (logits, cache, aux). `remat` is taken and ignored, as the JAX forward
    does (`repro/models/encdec.py::forward`): nothing is recomputed in the
    backward, so the step's products are those of JAX's."""
    del remat
    enc_out = encode(params, batch["src_embeds"], cfg, attn_blocks, plain)
    logits, cache = _decoder_forward(params, batch["tokens"], enc_out, cfg,
                                     attn_blocks, return_cache, max_len,
                                     plain)
    return logits, cache, 0.0


def prefill(params, batch, cfg, *, attn_blocks=(512, 512), max_len=None,
            plain: bool = False):
    logits, cache, _ = forward(params, batch, cfg, attn_blocks=attn_blocks,
                               return_cache=True, max_len=max_len,
                               plain=plain)
    return logits[:, -1], cache


def decode_step(params, cache, tokens, cfg, *, plain: bool = False):
    """tokens: (B,) int. Returns (logits, cache); the self-KV slabs and
    `pos` are updated in place and the same dict comes back."""
    x = embed_lookup(params["embed"], tokens.long())
    x = shard(x, "batch", "embed_act")
    B = x.shape[0]
    pos = cache["pos"]
    slots = slab_slots(pos, cache["k"][0], False)
    T = cache["xk"].shape[2]
    full = torch.full((B,), T, dtype=torch.int32, device=x.device)
    for l in range(cfg.num_layers):
        pl = layer_of(params["dec"], l)
        h = apply_norm(x, pl["ln1"], cfg)
        x = x + attn_decode(pl["attn"], h, cfg, "dense", cache["k"][l],
                            cache["v"][l], pos, slots, plain=plain)
        h = apply_norm(x, pl["lnx"], cfg)
        xa = pl["xattn"]
        o = sharded.slab_attend(_proj(h, xa["wq"]), cache["xk"][l],
                                cache["xv"][l], full, plain=plain)
        x = x + _out_proj(o, xa["wo"])
        h = apply_norm(x, pl["ln2"], cfg)
        x = x + dense_ffn_apply(pl["ffn"], h, cfg)
    x = apply_norm(x, params["final_norm"], cfg)
    logits = x @ params["lm_head"]
    pos.add_(1)
    return logits, cache


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                src_len: int = 4096):
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kv = TensorSpec((L, batch, max_len, Hkv, hd), dtype)
    xkv = TensorSpec((L, batch, src_len, Hkv, hd), dtype)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
            "pos": TensorSpec((batch,), torch.int32)}


def cache_logical_axes(cfg, batch: int = 0, max_len: int = 0):
    """Logical axes matching cache_specs (same tree structure)."""
    ax = ("layers", "kv_batch", "kv_seq", "kv_heads", None)
    return {"k": ax, "v": ax, "xk": ax, "xv": ax, "pos": ("kv_batch",)}
