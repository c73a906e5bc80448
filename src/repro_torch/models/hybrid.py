"""Zamba2-style hybrid (port of `repro/models/hybrid.py`)
[arXiv:2411.15242]: a Mamba2 backbone plus ONE shared attention block
applied every `hybrid_attn_every` layers (weights shared across
invocations, each invocation with its own KV cache).

Layout: n_groups = num_layers // every groups of (every mamba blocks + a
shared-block invocation), then a tail of the leftover mamba blocks.
Params keep the JAX layout (`groups` leaves with leading (G, E) axes,
`tail` leaves with a leading layer axis), so weights carry over one for
one. Every mamba prefill runs its scan through the `ssd_scan` kernel
(`models/ssd.py::mamba_apply`); the shared block's prefill runs
`flash_prefill` and its decode the fused `paged_insert` + `paged_decode`
over each group's KV slab viewed as pages (`transformer.attn_decode`).
`plain=True` runs the plain versions instead.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .common import (TensorSpec, apply_norm, embed_lookup, layer_of,
                     norm_params, param)
from .moe import dense_ffn_apply, dense_ffn_params
from .ssd import mamba_apply, mamba_params, mamba_state_specs, mamba_step
from .transformer import attn_decode, attn_full, attn_params, slab_slots


def _plan(cfg) -> Tuple[int, int, int]:
    every = cfg.hybrid_attn_every
    n_groups = cfg.num_layers // every
    tail = cfg.num_layers - n_groups * every
    return every, n_groups, tail


def _mamba_layers(gen, cfg, n, *, device):
    return {"m": mamba_params(gen, cfg, device=device, stack=n),
            "ln": norm_params(gen, cfg.d_model, cfg, device=device,
                              stack=n)}


def _reshape(tree, lead):
    return {k: _reshape(v, lead) if isinstance(v, dict)
            else v.reshape(*lead, *v.shape[1:]) for k, v in tree.items()}


def init(gen: torch.Generator, cfg, *, device) -> Dict[str, Any]:
    """Random f32 params at the JAX init scales, drawn on `device` from
    `gen` (a generator on that device)."""
    every, n_groups, tail = _plan(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": param(gen, (cfg.vocab_size, d), device=device,
                       scale=d ** -0.5),
        "final_norm": norm_params(gen, d, cfg, device=device),
        "lm_head": param(gen, (d, cfg.vocab_size), device=device),
        "groups": _reshape(_mamba_layers(gen, cfg, n_groups * every,
                                         device=device), (n_groups, every)),
        "shared": {
            "ln1": norm_params(gen, d, cfg, device=device),
            "attn": attn_params(gen, cfg, device=device, stack=0),
            "ln2": norm_params(gen, d, cfg, device=device),
            "ffn": dense_ffn_params(gen, d, cfg.d_ff, device=device),
        },
    }
    if tail:
        p["tail"] = _mamba_layers(gen, cfg, tail, device=device)
    return p


def _shared_block(ps, x, cfg, positions, attn_blocks, plain):
    h = apply_norm(x, ps["ln1"], cfg)
    a, kv = attn_full(ps["attn"], h, cfg, "dense", positions, attn_blocks,
                      plain=plain)
    x = x + a
    h = apply_norm(x, ps["ln2"], cfg)
    return x + dense_ffn_apply(ps["ffn"], h, cfg), kv


def _mamba_run(layers, n, x, cfg, plain, states):
    """Prefill `n` stacked mamba blocks; appends each block's (ssm, conv)
    to `states` when it is a list."""
    for l in range(n):
        pl = layer_of(layers, l)
        h = apply_norm(x, pl["ln"], cfg)
        y, st = mamba_apply(pl["m"], h, cfg, plain=plain)
        x = x + y
        if states is not None:
            states.append(st)
    return x


def _stack_states(states, lead):
    ssm = torch.stack([s for s, _ in states])
    conv = {k: torch.stack([c[k] for _, c in states]) for k in states[0][1]}
    return (ssm.reshape(*lead, *ssm.shape[1:]),
            {k: v.reshape(*lead, *v.shape[1:]) for k, v in conv.items()})


def forward(params, tokens, cfg, *, attn_blocks=(512, 512),
            return_cache=False, max_len=None, frontend_embeds=None,
            plain: bool = False):
    """tokens: (B, S) int. Returns (logits, cache, aux). With
    `return_cache`, only the last position's logits (B, 1, V) and the
    cache of `cache_specs`' layout, k/v padded to `max_len` (default S).
    `frontend_embeds` is taken, and unused, as in JAX."""
    del frontend_embeds
    every, n_groups, tail = _plan(cfg)
    x = embed_lookup(params["embed"], tokens.long())
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    g_states = [] if return_cache else None
    ks, vs = [], []
    for g in range(n_groups):
        x = _mamba_run(layer_of(params["groups"], g), every, x, cfg, plain,
                       g_states)
        x, (k, v) = _shared_block(params["shared"], x, cfg, positions,
                                  attn_blocks, plain)
        if return_cache:
            ks.append(k)
            vs.append(v)
    t_states = [] if return_cache and tail else None
    if tail:
        x = _mamba_run(params["tail"], tail, x, cfg, plain, t_states)

    x = apply_norm(x, params["final_norm"], cfg)
    if return_cache:
        x = x[:, -1:]          # last-position logits only at prefill
    logits = x @ params["lm_head"]
    cache = None
    if return_cache:
        target = max_len if max_len is not None else S
        k, v = torch.stack(ks), torch.stack(vs)       # (G, B, S, kv, hd)
        if S < target:
            pad = (0, 0, 0, 0, 0, target - S)
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        ssm, conv = _stack_states(g_states, (n_groups, every))
        cache = {"ssm": ssm, "conv": conv,             # (G, E, B, ...)
                 "k": k, "v": v,
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}
        if tail:
            cache["tail_ssm"], cache["tail_conv"] = _stack_states(
                t_states, (tail,))
    return logits, cache, 0.0


def prefill(params, tokens, cfg, *, attn_blocks=(512, 512), max_len=None,
            frontend_embeds=None, plain: bool = False):
    logits, cache, _ = forward(params, tokens, cfg, attn_blocks=attn_blocks,
                               return_cache=True, max_len=max_len,
                               plain=plain)
    return logits[:, -1], cache


def _mamba_steps(layers, n, x, cfg, ssm, conv):
    """Decode `n` stacked mamba blocks, their state (ssm[l], conv[*][l])
    updated in place."""
    for l in range(n):
        pl = layer_of(layers, l)
        h = apply_norm(x, pl["ln"], cfg)
        y, (s, c) = mamba_step(pl["m"], h, cfg,
                               (ssm[l], {k: v[l] for k, v in conv.items()}))
        x = x + y
        ssm[l] = s
        for k, v in conv.items():
            v[l] = c[k]
    return x


def decode_step(params, cache, tokens, cfg, *, plain: bool = False):
    """One token per slot. tokens: (B,) int. Returns (logits, cache).

    The state leaves, the KV slabs and `pos` are updated in place (JAX
    donated the cache and returned a new one); the same dict comes back.
    Each group's shared-block invocation writes its new K/V row and
    attends over its own slab (`transformer.attn_decode`)."""
    every, n_groups, tail = _plan(cfg)
    x = embed_lookup(params["embed"], tokens.long())
    pos = cache["pos"]
    ps = params["shared"]
    slots = slab_slots(pos, cache["k"][0], False)
    for g in range(n_groups):
        x = _mamba_steps(layer_of(params["groups"], g), every, x, cfg,
                         cache["ssm"][g],
                         {k: v[g] for k, v in cache["conv"].items()})
        h = apply_norm(x, ps["ln1"], cfg)
        x = x + attn_decode(ps["attn"], h, cfg, "dense", cache["k"][g],
                            cache["v"][g], pos, slots, plain=plain)
        h = apply_norm(x, ps["ln2"], cfg)
        x = x + dense_ffn_apply(ps["ffn"], h, cfg)
    if tail:
        x = _mamba_steps(params["tail"], tail, x, cfg, cache["tail_ssm"],
                         cache["tail_conv"])
    x = apply_norm(x, params["final_norm"], cfg)
    logits = x @ params["lm_head"]
    pos.add_(1)
    return logits, cache


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """`{"ssm": (G, E, B, nh, hd, N) f32, "conv": {"x", "B", "C": (G, E,
    B, W-1, c)}, "k", "v": (G, B, max_len, Hkv, hd), "pos": (B,) i32}`
    plus `tail_ssm` / `tail_conv` with a leading tail axis."""
    every, n_groups, tail = _plan(cfg)
    ssm, conv = mamba_state_specs(cfg, batch, dtype)
    kv = TensorSpec((n_groups, batch, max_len, cfg.num_kv_heads,
                     cfg.head_dim), dtype)

    def stk(pre, s):
        return TensorSpec(pre + tuple(s.shape), s.dtype)
    out = {
        "ssm": stk((n_groups, every), ssm),
        "conv": {k: stk((n_groups, every), s) for k, s in conv.items()},
        "k": kv, "v": kv,
        "pos": TensorSpec((batch,), torch.int32),
    }
    if tail:
        out["tail_ssm"] = stk((tail,), ssm)
        out["tail_conv"] = {k: stk((tail,), s) for k, s in conv.items()}
    return out
