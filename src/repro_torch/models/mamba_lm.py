"""Pure Mamba2 language model, attention-free (port of
`repro/models/mamba_lm.py`) [arXiv:2405.21060].

Params keep the JAX layout, `{"embed", "layers": {"ln", "m"},
"final_norm"}` with a leading layer axis on every leaf of `layers`, so
weights carry over one for one. Layers run in a Python loop where JAX used
`lax.scan`. Every prefill layer runs its scan through the `ssd_scan`
kernel; decode steps carry the state in plain PyTorch (`ssd_step`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import TensorSpec, apply_norm, embed_lookup, layer_of, \
    norm_params, param, remat_layer, shard
from .ssd import mamba_apply, mamba_params, mamba_state_specs, mamba_step


def init(gen: torch.Generator, cfg, *, device) -> Dict[str, Any]:
    """Random f32 params at the JAX init scales, drawn on `device` from
    `gen` (a generator on that device)."""
    d, L = cfg.d_model, cfg.num_layers
    return {
        "embed": param(gen, (cfg.vocab_size, d), ("vocab", "embed"),
                       device=device, scale=d ** -0.5),
        "layers": {"ln": norm_params(gen, d, cfg, device=device, stack=L),
                   "m": mamba_params(gen, cfg, device=device, stack=L)},
        "final_norm": norm_params(gen, d, cfg, device=device),
    }


def _block(x, pl, cfg, plain):
    h = apply_norm(x, pl["ln"], cfg)
    y, state = mamba_apply(pl["m"], h, cfg, plain=plain)
    return x + y, state


def forward(params, tokens, cfg, *, remat=False, return_cache=False,
            max_len=None, attn_blocks=None, frontend_embeds=None,
            plain: bool = False):
    """tokens: (B, S) int. Returns (logits, cache, aux). With
    `return_cache`, only the last position's logits (B, 1, V) and the
    cache `{"ssm", "conv", "pos"}` of `cache_specs`' layout. `max_len`,
    `attn_blocks` and `frontend_embeds` are taken, and unused, as in JAX
    (a constant-size state, no attention): the engine passes them to
    every family. `remat` recomputes each layer in the backward."""
    del max_len, attn_blocks, frontend_embeds
    x = params["embed"][tokens.long()]
    x = shard(x, "batch", None, "embed_act")
    ssm, conv = [], {"x": [], "B": [], "C": []}
    block = remat_layer(_block, remat)
    for l in range(cfg.num_layers):
        x, (s, c) = block(x, layer_of(params["layers"], l), cfg, plain)
        if return_cache:
            ssm.append(s)
            for k in conv:
                conv[k].append(c[k])
    x = apply_norm(x, params["final_norm"], cfg)
    if return_cache:
        x = x[:, -1:]          # last-position logits only at prefill
    logits = x @ params["embed"].T.to(x.dtype)          # tied
    logits = shard(logits, "batch", None, "vocab")
    cache = None
    if return_cache:
        cache = {"ssm": torch.stack(ssm),
                 "conv": {k: torch.stack(v) for k, v in conv.items()},
                 "pos": torch.full((tokens.shape[0],), tokens.shape[1],
                                   dtype=torch.int32, device=x.device)}
    return logits, cache, 0.0


def prefill(params, tokens, cfg, *, attn_blocks=None, max_len=None,
            frontend_embeds=None, plain: bool = False):
    """Returns (last-token logits (B, V), cache); `attn_blocks`, `max_len`
    and `frontend_embeds` are taken, and unused, as in JAX."""
    logits, cache, _ = forward(params, tokens, cfg, return_cache=True,
                               attn_blocks=attn_blocks, max_len=max_len,
                               frontend_embeds=frontend_embeds, plain=plain)
    return logits[:, -1], cache


def decode_step(params, cache, tokens, cfg, *, plain: bool = False):
    """One token per slot. tokens: (B,) int. Returns (logits, cache).

    The state leaves and `pos` are updated in place (JAX donated the
    cache and returned a new one); the same dict comes back. No kernel
    runs here, so `plain` changes nothing."""
    del plain
    x = embed_lookup(params["embed"], tokens.long())
    x = shard(x, "batch", "embed_act")
    ssm, conv = cache["ssm"], cache["conv"]
    for l in range(cfg.num_layers):
        pl = layer_of(params["layers"], l)
        h = apply_norm(x[:, None], pl["ln"], cfg)[:, 0]
        y, (s, c) = mamba_step(pl["m"], h, cfg,
                               (ssm[l], {k: v[l] for k, v in conv.items()}))
        x = x + y
        ssm[l] = s
        for k, v in conv.items():
            v[l] = c[k]
    x = apply_norm(x[:, None], params["final_norm"], cfg)[:, 0]
    logits = x @ params["embed"].T.to(x.dtype)
    cache["pos"].add_(1)
    return logits, cache


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """`{"ssm": (L, B, nh, hd, N) f32, "conv": {"x", "B", "C": (L, B, W-1,
    c)}, "pos": (B,) i32}`; `max_len` is unused (constant-size state)."""
    ssm, conv = mamba_state_specs(cfg, batch, dtype)
    L = cfg.num_layers
    return {
        "ssm": TensorSpec((L,) + ssm.shape, ssm.dtype),
        "conv": {k: TensorSpec((L,) + s.shape, s.dtype)
                 for k, s in conv.items()},
        "pos": TensorSpec((batch,), torch.int32),
    }


def cache_logical_axes(cfg, batch: int = 0, max_len: int = 0):
    """Logical axes matching cache_specs (same tree structure)."""
    conv = {"x": ("layers", "kv_batch", None, "ssm_inner"),
            "B": ("layers", "kv_batch", None, "state"),
            "C": ("layers", "kv_batch", None, "state")}
    return {"ssm": ("layers", "kv_batch", "heads", None, None),
            "conv": conv, "pos": ("kv_batch",)}
