"""Decoder-only transformer, paged-KV path (port of
`repro/models/transformer.py`).

Params keep the JAX layout: per-segment trees `seg{i}` whose leaves carry
a leading layer axis, so weights carry over one for one
(`repro_torch.weights.from_jax`). Layers run in a Python loop where JAX
used `lax.scan`. Attention goes through the hand-written kernels:
`flash_prefill` for a prefill from scratch, `prefix_prefill` for a
prefill over pool pages, `paged_insert` + `paged_decode` for every decode
step. Each op takes the plain version for CPU tensors; `plain=True`
forces the plain version on any device (the reference of the whole-model
check in `chip_smoke.py`).

Not ported yet: the dense-slab `decode_step`/`attn_decode` and the ring
packing of windowed caches (ROADMAP A7), the dense `prefix_kv` branch
(A8), MoE routed experts and VLM frontends (A9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..kernels.flash_prefill.ops import flash_prefill_op
from ..kernels.paged_decode.ops import paged_decode_op, paged_insert_op
from ..kernels.prefix_prefill.ops import prefix_prefill_op
from .common import (apply_norm, apply_rope, embed_lookup, norm_params, param,
                     rmsnorm)
from .moe import dense_ffn_apply, dense_ffn_params

LOCAL_ROPE_THETA = 10000.0  # gemma3 local layers


# ---------------------------------------------------------------------------
# segment plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str      # "dense" | "moe" | "local" | "global"
    n: int


def layer_plan(cfg) -> List[Segment]:
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.family == "moe":
            kind = "dense" if i < cfg.moe.first_k_dense else "moe"
        elif cfg.local_global_ratio:
            r = cfg.local_global_ratio
            kind = "global" if (i % (r + 1)) == r else "local"
        elif cfg.sliding_window:
            kind = "local"
        else:
            kind = "dense"
        kinds.append(kind)
    segs: List[Segment] = []
    for k in kinds:
        if segs and segs[-1].kind == k:
            segs[-1] = Segment(k, segs[-1].n + 1)
        else:
            segs.append(Segment(k, 1))
    return segs


def _is_windowed(kind: str, cfg) -> bool:
    return kind == "local" and cfg.sliding_window > 0


def _rope_theta(kind: str, cfg) -> float:
    if cfg.local_global_ratio and kind == "local":
        return LOCAL_ROPE_THETA
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_params(gen, cfg, *, device, stack):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, stack=stack)
    p = {
        "wq": param(gen, (d, H, hd), **kw),
        "wk": param(gen, (d, Hkv, hd), **kw),
        "wv": param(gen, (d, Hkv, hd), **kw),
        "wo": param(gen, (H, hd, d), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = param(gen, (hd,), init="zeros", **kw)
        p["k_norm"] = param(gen, (hd,), init="zeros", **kw)
    return p


def layer_params(gen, cfg, kind: str, *, device, stack):
    if kind == "moe":
        raise NotImplementedError("MoE routed experts are not ported yet "
                                  "(ROADMAP A9)")
    ff = cfg.moe.dense_d_ff or cfg.d_ff if cfg.family == "moe" else cfg.d_ff
    return {
        "ln1": norm_params(gen, cfg.d_model, cfg, device=device, stack=stack),
        "attn": attn_params(gen, cfg, device=device, stack=stack),
        "ln2": norm_params(gen, cfg.d_model, cfg, device=device, stack=stack),
        "ffn": dense_ffn_params(gen, cfg.d_model, ff, device=device,
                                stack=stack),
    }


def init(gen: torch.Generator, cfg, *, device) -> Dict[str, Any]:
    """Random f32 params at the JAX init scales, drawn on `device` from
    `gen` (a generator on that device)."""
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": param(gen, (cfg.vocab_size, d), device=device,
                       scale=d ** -0.5),
        "final_norm": norm_params(gen, d, cfg, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = param(gen, (d, cfg.vocab_size), device=device)
    for i, seg in enumerate(layer_plan(cfg)):
        p[f"seg{i}"] = layer_params(gen, cfg, seg.kind, device=device,
                                    stack=seg.n)
    return p


def _layer(tree, l: int):
    """Layer `l` of a segment's stacked params (views, no copy)."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# attention block application
# ---------------------------------------------------------------------------

def _qkv(p, x, cfg, positions, theta):
    B, S, d = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ p["wk"].reshape(d, Hkv * hd)).view(B, S, Hkv, hd)
    v = (x @ p["wv"].reshape(d, Hkv * hd)).view(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, theta, cfg.rope_fraction, cfg.rope_interleaved)
    k = apply_rope(k, positions, theta, cfg.rope_fraction, cfg.rope_interleaved)
    return q, k, v


def _out_proj(o, wo):
    """(..., H, hd) x (H, hd, d) -> (..., d)."""
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def attn_full(p, x, cfg, kind, positions, attn_blocks=(512, 512),
              paged_prefix=None, plain: bool = False):
    """Full-sequence attention (prefill). Returns (out, (k, v)).

    Without `paged_prefix` the queries attend causally over themselves
    through the `flash_prefill` kernel (where the JAX model runs the jnp
    `flash_reference`). `paged_prefix` = (k_pages, v_pages, block_table,
    prefix_lens) reads a prefix straight from the page pool through the
    `prefix_prefill` kernel. The returned cache holds only this chunk's
    KV."""
    window = cfg.sliding_window if _is_windowed(kind, cfg) else 0
    q, k, v = _qkv(p, x, cfg, positions, _rope_theta(kind, cfg))
    if paged_prefix is not None:
        assert window == 0, "prefix reuse needs full attention"
        kp_l, vp_l, table, plens = paged_prefix
        o = prefix_prefill_op(q, k, v, kp_l, vp_l, table, plens,
                              block_q=attn_blocks[0], block_kv=attn_blocks[1],
                              softcap=cfg.attn_logit_softcap, plain=plain)
    else:
        o = flash_prefill_op(q, k, v, causal=True, window=window,
                             block_q=attn_blocks[0], block_kv=attn_blocks[1],
                             softcap=cfg.attn_logit_softcap, plain=plain)
    return _out_proj(o, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg):
    x = embed_lookup(params["embed"], tokens.long())
    if cfg.embedding_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def _layer_body(x, pl, cfg, kind, positions, attn_blocks, paged_prefix=None,
                plain=False):
    h = apply_norm(x, pl["ln1"], cfg)
    a, kv = attn_full(pl["attn"], h, cfg, kind, positions, attn_blocks,
                      paged_prefix=paged_prefix, plain=plain)
    x = x + a
    h = apply_norm(x, pl["ln2"], cfg)
    return x + dense_ffn_apply(pl["ffn"], h, cfg), kv


def forward(params, tokens, cfg, *, attn_blocks=(512, 512),
            return_cache=False, max_len=None, prefix_kv=None,
            prefix_pages=None, prefix_table=None, prefix_len=None,
            pos_offset=0, last_pos=None, plain: bool = False):
    """Full-sequence forward. tokens: (B, S) int. Returns (logits, cache,
    aux).

    Fused paged path: `prefix_pages` maps segment names to {"k", "v"}
    page pools of shape (layers, num_pages, page_size, Hkv, hd) and
    `prefix_table` (B, npp) i32 addresses the prefix pages; `prefix_len`
    ((B,) or scalar) counts the live prefix tokens (trash-padded table
    slots are masked) and `pos_offset` shifts the rope positions.

    `last_pos` picks which position's logits to return with
    `return_cache` (default: the last one)."""
    if prefix_kv is not None:
        raise NotImplementedError("the dense prefix_kv branch is not ported "
                                  "yet (ROADMAP A8); use prefix_pages")
    x = embed_tokens(params, tokens, cfg)
    B, S, _ = x.shape
    dev = x.device
    positions = (int(pos_offset)
                 + torch.arange(S, dtype=torch.int32, device=dev))[None, :]
    plens = None
    if prefix_pages is not None:
        assert prefix_table is not None and prefix_len is not None
        plens = torch.broadcast_to(
            torch.as_tensor(prefix_len, dtype=torch.int32, device=dev),
            (B,)).contiguous()
    cache: Dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        sp = params[f"seg{i}"]
        ppg = prefix_pages.get(f"seg{i}") if prefix_pages is not None \
            else None
        ks, vs = [], []
        for l in range(seg.n):
            paged = None
            if ppg is not None:
                paged = (ppg["k"][l], ppg["v"][l], prefix_table, plens)
            x, (k, v) = _layer_body(x, _layer(sp, l), cfg, seg.kind,
                                    positions, attn_blocks,
                                    paged_prefix=paged, plain=plain)
            if return_cache:
                ks.append(k)
                vs.append(v)
        if return_cache:
            k_seg, v_seg = torch.stack(ks), torch.stack(vs)
            target = S if max_len is None else max_len
            if _is_windowed(seg.kind, cfg):
                target = min(cfg.sliding_window, target)
            if S > target:
                raise NotImplementedError("ring-packed window caches are "
                                          "not ported yet (ROADMAP A7)")
            if S < target:
                pad = (0, 0, 0, 0, 0, target - S)
                k_seg = torch.nn.functional.pad(k_seg, pad)
                v_seg = torch.nn.functional.pad(v_seg, pad)
            cache[f"seg{i}"] = {"k": k_seg, "v": v_seg}
    x = apply_norm(x, params["final_norm"], cfg)
    if return_cache:
        # prefill only needs one position's logits, not the (B, S, V) tensor
        if last_pos is None:
            x_last = x[:, -1]
        else:
            lp = torch.broadcast_to(
                torch.as_tensor(last_pos, dtype=torch.long, device=dev), (B,))
            x_last = x[torch.arange(B, device=dev), lp]
        logits = unembed(params, x_last, cfg)[:, None]
        cache["pos"] = torch.full((B,), S + int(pos_offset),
                                  dtype=torch.int32, device=dev)
    else:
        logits = unembed(params, x, cfg)
    return logits, cache, 0.0


def unembed(params, x, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w


def decode_step_paged(params, cache, tokens, cfg, *, plain: bool = False):
    """Paged-KV decode step. tokens: (B,) int. Returns (logits, cache).

    The cache holds per-segment page pools `(layers, num_pages,
    page_size, Hkv, hd)` shared across sequences, plus one block table
    `(B, pages_per_seq)` used by every layer. The new token's K/V goes
    into page `pos // page_size`, row `pos % page_size`, through the
    `paged_insert` kernel, then attention runs through `paged_decode`.

    The pools and `pos` are updated in place where they lie (JAX donated
    the cache buffers and returned new ones); the same dict comes back.
    """
    x = embed_lookup(params["embed"], tokens.long())
    if cfg.embedding_scale:
        x = x * (cfg.d_model ** 0.5)
    pos = cache["pos"]
    table = cache["block_tables"]
    B = tokens.shape[0]
    max_pps = table.shape[1]
    bidx = torch.arange(B, device=x.device)
    for i, seg in enumerate(layer_plan(cfg)):
        kc, vc = cache[f"seg{i}"]["k"], cache[f"seg{i}"]["v"]
        page_size = kc.shape[2]
        # freed/idle slots keep pos growing into the reserved trash page 0;
        # clamp so the page walk stays in-table and the write stays benign
        wpos = torch.clamp(pos, max=max_pps * page_size - 1)
        pidx = table[bidx, (wpos // page_size).long()]
        off = wpos % page_size
        lens = torch.clamp(pos + 1, max=max_pps * page_size)
        theta = _rope_theta(seg.kind, cfg)
        for l in range(seg.n):
            pl = _layer(params[f"seg{i}"], l)
            h = apply_norm(x, pl["ln1"], cfg)
            q, k, v = _qkv(pl["attn"], h[:, None], cfg, pos[:, None], theta)
            q, k, v = q[:, 0], k[:, 0], v[:, 0]
            paged_insert_op(kc[l], vc[l], k, v, pidx, off, plain=plain)
            o = paged_decode_op(q, kc[l], vc[l], table, lens,
                                softcap=cfg.attn_logit_softcap, plain=plain)
            x = x + _out_proj(o, pl["attn"]["wo"])
            h = apply_norm(x, pl["ln2"], cfg)
            x = x + dense_ffn_apply(pl["ffn"], h, cfg)
    x = apply_norm(x, params["final_norm"], cfg)
    logits = unembed(params, x, cfg)
    pos.add_(1)
    return logits, cache


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def paged_cache_specs(cfg, batch: int, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, max_len: Optional[int] = None):
    """Shapes and dtypes of a paged KV cache.

    Per attention segment: k/v pools `(layers, num_pages, page_size, Hkv,
    hd)`. `block_tables` is `(batch, pages_per_seq)` with pages_per_seq =
    ceil(max_len / page_size); unassigned entries point at the reserved
    trash page 0. `pos` is the per-slot write cursor."""
    max_len = max_len if max_len is not None else num_pages * page_size
    pps = -(-max_len // page_size)
    out: Dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        shp = (seg.n, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        out[f"seg{i}"] = {"k": TensorSpec(shp, dtype),
                          "v": TensorSpec(shp, dtype)}
    out["block_tables"] = TensorSpec((batch, pps), torch.int32)
    out["pos"] = TensorSpec((batch,), torch.int32)
    return out
