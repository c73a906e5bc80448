"""Decoder-only transformer (port of `repro/models/transformer.py`).

Params keep the JAX layout: per-segment trees `seg{i}` whose leaves carry
a leading layer axis, so weights carry over one for one
(`repro_torch.weights.from_jax`). Layers run in a Python loop where JAX
used `lax.scan`. Attention goes through the hand-written kernels:
`flash_prefill` for a prefill from scratch, `prefix_prefill` for a
prefill over pool pages, and for every decode step `paged_insert` +
`paged_decode`, over the paged pools (`decode_step_paged`) or over the
dense slot slab viewed as pages (`decode_step`, `models/attention.py::
slab_pages`). Each op takes the plain version for CPU tensors;
`plain=True` forces the plain version on any device (the reference of
the whole-model check in `chip_smoke.py`).

MoE layers run `models/moe.py::moe_apply` (the routed experts' batched
products in `torch.bmm`, as JAX computes them outside any kernel); a VLM
prepends its frontend embeddings to the token embeddings. The dense
`prefix_kv` branch (the serving engine's `fused_prefix=False` fallback)
runs `prefix_prefill` over the gathered prefix viewed as pages with an
identity table, the same function as JAX's `flash_reference` with
`prefix_len`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..kernels.paged_decode.ops import paged_insert_decode_op, paged_insert_op
from ..kernels.prefix_prefill.ops import prefix_prefill_op
from . import sharded
from .attention import slab_attend, slab_page, slab_pages, slab_table
from .common import (TensorSpec, apply_norm, apply_rope, embed_lookup,
                     is_dtensor, layer_of, norm_params, param, remat_layer,
                     rmsnorm, shard)
from .moe import dense_ffn_apply, dense_ffn_params, moe_apply, moe_params

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

def attn_params(gen, cfg, *, device, stack, dtype=torch.float32):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, stack=stack, dtype=dtype)
    p = {
        "wq": param(gen, (d, H, hd), ("embed", "heads", None), **kw),
        "wk": param(gen, (d, Hkv, hd), ("kv_embed", "kv_heads", None), **kw),
        "wv": param(gen, (d, Hkv, hd), ("kv_embed", "kv_heads", None), **kw),
        "wo": param(gen, (H, hd, d), ("heads", None, "embed"), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = param(gen, (hd,), (None,), init="zeros", **kw)
        p["k_norm"] = param(gen, (hd,), (None,), init="zeros", **kw)
    return p


def layer_params(gen, cfg, kind: str, *, device, stack,
                 dtype=torch.float32):
    kw = dict(device=device, stack=stack, dtype=dtype)
    p = {
        "ln1": norm_params(gen, cfg.d_model, cfg, **kw),
        "attn": attn_params(gen, cfg, **kw),
        "ln2": norm_params(gen, cfg.d_model, cfg, **kw),
    }
    if kind == "moe":
        p["moe"] = moe_params(gen, cfg, **kw)
    else:
        ff = cfg.moe.dense_d_ff or cfg.d_ff if cfg.family == "moe" \
            else cfg.d_ff
        p["ffn"] = dense_ffn_params(gen, cfg.d_model, ff, **kw)
    return p


def init(gen: torch.Generator, cfg, *, device,
         dtype=torch.float32) -> Dict[str, Any]:
    """Random params at the JAX init scales, drawn in f32 on `device` from
    `gen` (a generator on that device) and stored in `dtype` (a stacked
    leaf a layer at a time, `common.param`). A tree of `Box` leaves with
    JAX's logical axes."""
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p: Dict[str, Any] = {
        "embed": param(gen, (cfg.vocab_size, d), ("vocab", "embed"),
                       scale=d ** -0.5, **kw),
        "final_norm": norm_params(gen, d, cfg, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = param(gen, (d, cfg.vocab_size), ("embed", "vocab"),
                             **kw)
    for i, seg in enumerate(layer_plan(cfg)):
        p[f"seg{i}"] = layer_params(gen, cfg, seg.kind, stack=seg.n, **kw)
    return p


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


def dense_prefix_pages(pk, pv, prefix_len):
    """A gathered dense prefix pk/pv (B, P, Hkv, hd) as `paged_prefix`:
    its page view with the identity table (`slab_pages`, no copy) and
    (B,) i32 live lengths, `prefix_len` (scalar or (B,); None: all P)."""
    B, P = pk.shape[:2]
    kp, vp, table = slab_pages(pk.contiguous(), pv.contiguous())
    plens = torch.broadcast_to(torch.as_tensor(
        P if prefix_len is None else prefix_len, dtype=torch.int32,
        device=pk.device), (B,)).contiguous()
    return kp, vp, table, plens


def attn_full(p, x, cfg, kind, positions, attn_blocks=(512, 512),
              prefix=None, prefix_len=None, paged_prefix=None,
              plain: bool = False):
    """Full-sequence attention (prefill). Returns (out, (k, v)).

    Without a prefix the queries attend causally over themselves through
    the `flash_prefill` kernel (where the JAX model runs the jnp
    `flash_reference`). `paged_prefix` = (k_pages, v_pages, block_table,
    prefix_lens) reads a prefix straight from the page pool through the
    `prefix_prefill` kernel. `prefix` = (k, v), a dense (B, P, Hkv, hd)
    prefix of already-roped KV of which the first `prefix_len` positions
    are live, runs the same kernel over its page view
    (`dense_prefix_pages`). The returned cache holds only this chunk's
    KV."""
    window = cfg.sliding_window if _is_windowed(kind, cfg) else 0
    q, k, v = _qkv(p, x, cfg, positions, _rope_theta(kind, cfg))
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    if prefix is not None:
        assert paged_prefix is None
        paged_prefix = dense_prefix_pages(prefix[0].to(k.dtype),
                                          prefix[1].to(v.dtype), prefix_len)
    if paged_prefix is not None:
        assert window == 0, "prefix reuse needs full attention"
        kp_l, vp_l, table, plens = paged_prefix
        o = prefix_prefill_op(q, k, v, kp_l, vp_l, table, plens,
                              block_q=attn_blocks[0], block_kv=attn_blocks[1],
                              softcap=cfg.attn_logit_softcap, plain=plain)
    else:
        o = sharded.flash_prefill(q, k, v, causal=True, window=window,
                                  block_q=attn_blocks[0],
                                  block_kv=attn_blocks[1],
                                  softcap=cfg.attn_logit_softcap, plain=plain)
    return _out_proj(o, p["wo"]), (k, v)


def slab_slots(pos, k_cache, ring: bool):
    """Where a decode step writes and reads on a slab layer (B, Smax, Hkv,
    hd), from the write cursors pos (B,) i32: attention covers slots <
    lens = min(pos + 1, Smax); the new row goes to slot min(pos, Smax - 1)
    = lens - 1 of a full cache, and to slot pos % Smax of a ring
    (sliding-window) cache, which is page `table[b, slot // page]`, row
    `slot % page` of its page view (`slab_pages`). Returns (lens,
    page_idx, offset), the last two None for a full cache. The same for
    every layer of a segment, so `decode_step` computes it once."""
    B, smax = k_cache.shape[:2]
    lens = torch.clamp(pos + 1, max=smax)
    if not ring or is_dtensor(k_cache):
        return lens, None, None
    page = slab_page(smax)
    slot = pos % smax
    table = slab_table(B, smax, k_cache.device)
    pidx = torch.gather(table, 1, (slot // page).long()[:, None])[:, 0]
    return lens, pidx, (slot % page).to(torch.int32)


def attn_decode(p, x, cfg, kind, k_cache, v_cache, pos, slots,
                plain: bool = False):
    """Single-token attention over one slab layer. x: (B, d); caches (B,
    Smax, Hkv, hd), written in place; pos: (B,) i32 current write index;
    `slots`: `slab_slots(pos, k_cache, ring)` of the layer's segment.
    Returns the attention output (B, d).

    On a full cache the write slot is the last live one, so one
    `paged_insert_decode_op` writes and attends (one launch pair on the
    card, as in `decode_step_paged`). On a ring cache past its window it
    is not, so the row goes in through `paged_insert_op` and
    `slab_attend` follows."""
    q, k, v = _qkv(p, x[:, None], cfg, pos[:, None], _rope_theta(kind, cfg))
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    lens, pidx, off = slots
    if is_dtensor(k_cache):
        smax = k_cache.shape[1]
        slot = pos % smax if _is_windowed(kind, cfg) else lens - 1
        o = sharded.decode_attend(q, k_cache, v_cache, lens, slot=slot,
                                  k_new=k, v_new=v,
                                  softcap=cfg.attn_logit_softcap, plain=plain)
        return _out_proj(o, p["wo"])
    kp, vp, table = slab_pages(k_cache, v_cache)
    if _is_windowed(kind, cfg):
        paged_insert_op(kp, vp, k, v, pidx, off, plain=plain)
        o = slab_attend(q, k_cache, v_cache, lens,
                        logit_softcap=cfg.attn_logit_softcap, plain=plain)
    else:
        o = paged_insert_decode_op(q, k, v, kp, vp, table, lens,
                                   softcap=cfg.attn_logit_softcap,
                                   plain=plain)
    return _out_proj(o, p["wo"])


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _ffn(pl, x, cfg, kind):
    """The layer's FFN: routed experts on a MoE layer, else dense.
    Returns (out, aux), aux 0.0 for a dense layer."""
    if kind == "moe":
        return moe_apply(pl["moe"], x, cfg)
    return dense_ffn_apply(pl["ffn"], x, cfg), 0.0


def embed_tokens(params, tokens, cfg, frontend_embeds=None):
    """Token embeddings; a VLM's frontend embeddings (B, P, d) go first."""
    x = params["embed"][tokens.long()]   # vocab-sharded gather
    if cfg.embedding_scale:
        x = x * (cfg.d_model ** 0.5)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


def _layer_body(x, pl, cfg, kind, positions, attn_blocks, prefix=None,
                prefix_len=None, paged_prefix=None, plain=False):
    h = apply_norm(x, pl["ln1"], cfg)
    a, kv = attn_full(pl["attn"], h, cfg, kind, positions, attn_blocks,
                      prefix=prefix, prefix_len=prefix_len,
                      paged_prefix=paged_prefix, plain=plain)
    x = x + a
    h = apply_norm(x, pl["ln2"], cfg)
    f, aux = _ffn(pl, h, cfg, kind)
    return shard(x + f, "batch", None, "embed_act"), kv, aux


def forward(params, tokens, cfg, *, frontend_embeds=None, remat=False,
            attn_blocks=(512, 512), return_cache=False, max_len=None,
            prefix_kv=None, prefix_pages=None, prefix_table=None,
            prefix_len=None, pos_offset=0, last_pos=None,
            plain: bool = False):
    """Full-sequence forward. tokens: (B, S) int; `frontend_embeds` (B,
    P, d) go before them (VLM). Returns (logits, cache, aux), aux the sum
    of the MoE layers' load-balance losses. `remat` recomputes each layer
    in the backward (`common.remat_layer`).

    Prefix reuse: `prefix_kv` maps segment names to {"k", "v"} of shape
    (layers, B, P, Hkv, hd) holding the cached, already-roped KV of the
    first P prompt positions; `tokens` then covers only the suffix,
    `pos_offset` (= the live prefix) shifts its rope positions and
    `prefix_len` (scalar or (B,)) marks how many of the P positions are
    live when the gather was padded to a bucket.

    Fused paged path: `prefix_pages` maps segment names to {"k", "v"}
    page pools of shape (layers, num_pages, page_size, Hkv, hd) and
    `prefix_table` (B, npp) i32 addresses the prefix pages; `prefix_len`
    ((B,) or scalar) counts the live prefix tokens (trash-padded table
    slots are masked) and `pos_offset` shifts the rope positions.

    `last_pos` picks which position's logits to return with
    `return_cache` (default: the last one)."""
    x = embed_tokens(params, tokens, cfg, frontend_embeds)
    x = shard(x, "batch", None, "embed_act")
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
    aux_total = 0.0
    cache: Dict[str, Any] = {}
    body = remat_layer(_layer_body, remat)
    for i, seg in enumerate(layer_plan(cfg)):
        sp = params[f"seg{i}"]
        ppg = prefix_pages.get(f"seg{i}") if prefix_pages is not None \
            else None
        pkv = prefix_kv.get(f"seg{i}") if prefix_kv is not None else None
        ks, vs = [], []
        for l in range(seg.n):
            paged = prefix = None
            if ppg is not None:
                paged = (ppg["k"][l], ppg["v"][l], prefix_table, plens)
            elif pkv is not None:
                prefix = (pkv["k"][l], pkv["v"][l])
            x, (k, v), aux = body(
                x, layer_of(sp, l), cfg, seg.kind, positions, attn_blocks,
                prefix=prefix, prefix_len=prefix_len, paged_prefix=paged,
                plain=plain)
            aux_total = aux_total + aux
            if return_cache:
                ks.append(k)
                vs.append(v)
        if return_cache:
            k_seg, v_seg = torch.stack(ks), torch.stack(vs)
            target = S if max_len is None else max_len
            if _is_windowed(seg.kind, cfg):
                target = min(cfg.sliding_window, target)
            if S > target:
                # ring-pack the trailing `target` positions: position p
                # lives in slot p % target, a roll of the tail
                k_seg = torch.roll(k_seg[:, :, -target:], S % target, dims=2)
                v_seg = torch.roll(v_seg[:, :, -target:], S % target, dims=2)
            elif S < target:
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
    return logits, cache, aux_total


def prefill(params, tokens, cfg, *, frontend_embeds=None,
            attn_blocks=(512, 512), max_len=None, plain: bool = False):
    """Returns (last-token logits (B, V), cache sized for max_len)."""
    logits, cache, _ = forward(params, tokens, cfg,
                               frontend_embeds=frontend_embeds,
                               attn_blocks=attn_blocks, return_cache=True,
                               max_len=max_len, plain=plain)
    return logits[:, -1], cache


def unembed(params, x, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    # arity-aware constraint: decode logits are (B, V), train/prefill (B,S,V)
    ax = ("batch", None, "vocab") if logits.ndim == 3 else ("batch", "vocab")
    return shard(logits, *ax)


def decode_step(params, cache, tokens, cfg, *, plain: bool = False):
    """Dense-slab decode step. tokens: (B,) int. Returns (logits, cache).

    The cache holds per-segment slabs `(layers, B, Smax, Hkv, hd)`, one
    slot per sequence (`cache_specs`: Smax is the window for windowed
    segments), and `pos`. Each layer writes the new token's K/V and
    attends through `attn_decode`. The slabs and `pos` are updated in
    place (JAX donated the cache and returned a new one); the same dict
    comes back."""
    x = embed_lookup(params["embed"], tokens.long())
    if cfg.embedding_scale:
        x = x * (cfg.d_model ** 0.5)
    x = shard(x, "batch", "embed_act")
    pos = cache["pos"]
    for i, seg in enumerate(layer_plan(cfg)):
        kc, vc = cache[f"seg{i}"]["k"], cache[f"seg{i}"]["v"]
        slots = slab_slots(pos, kc[0], _is_windowed(seg.kind, cfg))
        for l in range(seg.n):
            pl = layer_of(params[f"seg{i}"], l)
            h = apply_norm(x, pl["ln1"], cfg)
            x = x + attn_decode(pl["attn"], h, cfg, seg.kind, kc[l], vc[l],
                                pos, slots, plain=plain)
            h = apply_norm(x, pl["ln2"], cfg)
            x = x + _ffn(pl, h[:, None], cfg, seg.kind)[0][:, 0]
    x = apply_norm(x, params["final_norm"], cfg)
    logits = unembed(params, x, cfg)
    pos.add_(1)
    return logits, cache


def decode_step_paged(params, cache, tokens, cfg, *, plain: bool = False):
    """Paged-KV decode step. tokens: (B,) int. Returns (logits, cache).

    The cache holds per-segment page pools `(layers, num_pages,
    page_size, Hkv, hd)` shared across sequences, plus one block table
    `(B, pages_per_seq)` used by every layer. The new token's K/V goes
    into page `pos // page_size`, row `pos % page_size`, and attention
    runs over the table, in one `paged_insert_decode_op` a layer (on the
    card, `paged_decode`'s split kernel writes the row).

    The pools and `pos` are updated in place where they lie (JAX donated
    the cache buffers and returned new ones); the same dict comes back.
    """
    x = embed_lookup(params["embed"], tokens.long())
    if cfg.embedding_scale:
        x = x * (cfg.d_model ** 0.5)
    x = shard(x, "batch", "embed_act")
    pos = cache["pos"]
    table = cache["block_tables"]
    max_pps = table.shape[1]
    for i, seg in enumerate(layer_plan(cfg)):
        kc, vc = cache[f"seg{i}"]["k"], cache[f"seg{i}"]["v"]
        page_size = kc.shape[2]
        # freed/idle slots keep pos growing into the reserved trash page 0;
        # clamp so the page walk stays in-table and the write (at position
        # lens - 1) stays benign
        lens = torch.clamp(pos + 1, max=max_pps * page_size)
        theta = _rope_theta(seg.kind, cfg)
        for l in range(seg.n):
            pl = layer_of(params[f"seg{i}"], l)
            h = apply_norm(x, pl["ln1"], cfg)
            q, k, v = _qkv(pl["attn"], h[:, None], cfg, pos[:, None], theta)
            q, k, v = q[:, 0], k[:, 0], v[:, 0]
            o = paged_insert_decode_op(q, k, v, kc[l], vc[l], table, lens,
                                       softcap=cfg.attn_logit_softcap,
                                       plain=plain)
            x = x + _out_proj(o, pl["attn"]["wo"])
            h = apply_norm(x, pl["ln2"], cfg)
            x = x + _ffn(pl, h[:, None], cfg, seg.kind)[0][:, 0]
    x = apply_norm(x, params["final_norm"], cfg)
    logits = unembed(params, x, cfg)
    pos.add_(1)
    return logits, cache


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


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """Shapes and dtypes of the dense-slab KV cache: per segment k/v
    `(layers, batch, S, Hkv, hd)` with S = max_len, or min(window,
    max_len) for a windowed segment (a ring); `pos` the per-slot write
    cursor."""
    out: Dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        S = (min(cfg.sliding_window, max_len) if _is_windowed(seg.kind, cfg)
             else max_len)
        shp = (seg.n, batch, S, cfg.num_kv_heads, cfg.head_dim)
        out[f"seg{i}"] = {"k": TensorSpec(shp, dtype),
                          "v": TensorSpec(shp, dtype)}
    out["pos"] = TensorSpec((batch,), torch.int32)
    return out


def cache_logical_axes(cfg, batch: int = 0, max_len: int = 0):
    """Logical axes matching cache_specs (same tree structure)."""
    out: Dict[str, Any] = {}
    for i, _seg in enumerate(layer_plan(cfg)):
        ax = ("layers", "kv_batch", "kv_seq", "kv_heads", None)
        out[f"seg{i}"] = {"k": ax, "v": ax}
    out["pos"] = ("kv_batch",)
    return out
