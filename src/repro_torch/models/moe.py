"""FFN blocks: routed experts and the dense FFN (port of
`repro/models/moe.py`).

`moe_apply` is the JAX package's plain-pjit dispatch (`_moe_apply_pjit`),
the one it runs on a single device: top-k routing with a static
per-expert capacity C = max(ceil(T*k/E * cf), 8), tokens scattered into
(E, C, d) expert buffers, two batched expert products (`torch.bmm`, as
JAX computes them outside any Pallas kernel) and a weighted combine.
Tokens past an expert's capacity are dropped (GShard), in the order of
the exclusive cumsum over token-major (token, choice) pairs, so padded
prefill positions and idle decode slots route and take capacity exactly
as in JAX. The mesh dispatches (`moe_apply_grouped`,
`moe_apply_shard_map`) compute the same function under sharding rules
and are ROADMAP A15.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .common import act_fn, param


def moe_params(gen, cfg, *, device, stack: int = 0,
               dtype=torch.float32) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    m = cfg.moe
    E = m.num_experts
    kw = dict(device=device, stack=stack, dtype=dtype)
    p = {
        "router": param(gen, (d, E), **kw),
        "wi": param(gen, (E, d, 2 * ff), **kw),
        "wo": param(gen, (E, ff, d), **kw),
    }
    if m.num_shared_experts:
        sf = ff * m.num_shared_experts
        p["shared_wi"] = param(gen, (d, 2 * sf), **kw)
        p["shared_wo"] = param(gen, (sf, d), **kw)
    return p


def capacity(T: int, cfg, capacity_factor: float = 0.0) -> int:
    """Slots per expert: max(ceil(T*k/E * cf), 8), cf = `capacity_factor`
    or the config's or 2.0."""
    m = cfg.moe
    cf = capacity_factor or m.capacity_factor or 2.0
    return max(int(math.ceil(T * m.num_experts_per_tok / m.num_experts
                             * cf)), 8)


def _routed_core(xf, router, wi, wo, cfg, capacity_factor: float = 0.0,
                 topi=None):
    """Top-k routed experts on flat tokens xf (T, d). Returns (out (T, d),
    aux). `topi` (T, k), when given, replaces the router's top-k choices
    (weighted by the router's gates at those experts): a whole-model
    check replays one path's routing on another."""
    T, d = xf.shape
    m = cfg.moe
    E, k = m.num_experts, m.num_experts_per_tok
    act = act_fn(cfg.mlp_activation)
    dev = xf.device

    logits = xf.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)                         # (T, E)
    if topi is None:
        topw, topi = torch.topk(gates, k, dim=-1, sorted=True)    # (T, k)
    else:
        topw = torch.gather(gates, 1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    C = capacity(T, cfg, capacity_factor)
    flat_e = topi.reshape(-1)                                     # (T*k,)
    # position of each routed token within its expert's buffer: the
    # exclusive cumsum over token-major (token, choice) order
    onehot = torch.nn.functional.one_hot(flat_e, E)               # (T*k, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    overflow = slot >= C                                          # dropped
    dst = torch.where(overflow, E * C, flat_e * C + slot)         # sentinel

    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
    # one sentinel row past the buffers takes every dropped token
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=dev)
    buf[dst] = xf[tok_idx]
    buf = buf[:E * C].view(E, C, d)

    h = torch.bmm(buf, wi)                                        # (E, C, 2ff)
    g, u = torch.chunk(h, 2, dim=-1)
    y = torch.bmm(act(g) * u, wo).reshape(E * C, d)

    w = torch.where(overflow, 0.0, topw.reshape(-1)).to(xf.dtype)
    gathered = (y[torch.clamp(dst, max=E * C - 1)] * w[:, None]).view(T, k, d)
    # the JAX scatter-add adds each token's k rows in choice order
    out = gathered[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j]
    return out, _load_balance_loss(gates, topi, E)


def _shared_part(p, xf, cfg):
    act = act_fn(cfg.mlp_activation)
    h = xf @ p["shared_wi"]
    g, u = torch.chunk(h, 2, dim=-1)
    return (act(g) * u) @ p["shared_wo"]


def moe_apply(p, x, cfg, capacity_factor: float = 0.0):
    """x: (B, S, d) -> ((B, S, d), aux): JAX `_moe_apply_pjit`."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    out, aux = _routed_core(xf, p["router"], p["wi"], p["wo"], cfg,
                            capacity_factor)
    if cfg.moe.num_shared_experts:
        out = out + _shared_part(p, xf, cfg)
    return out.view(B, S, d), aux


def _load_balance_loss(gates, topi, E):
    """Switch-style aux loss (fraction routed x mean gate)."""
    T, k = topi.shape
    fr = torch.bincount(topi.reshape(-1), minlength=E).float() / (T * k)
    pe = gates.mean(dim=0)
    return E * torch.sum(fr * pe)


def dense_ffn_params(gen, d, ff, *, device, stack: int = 0,
                     dtype=torch.float32):
    kw = dict(device=device, stack=stack, dtype=dtype)
    return {"wi": param(gen, (d, 2 * ff), **kw),
            "wo": param(gen, (ff, d), **kw)}


def dense_ffn_apply(p, x, cfg):
    """Gated FFN over a fused `wi` of shape (d, 2*ff): act(x@wi[:, :ff]) *
    (x@wi[:, ff:]), then @ wo."""
    act = act_fn(cfg.mlp_activation)
    h = x @ p["wi"]
    g, u = torch.chunk(h, 2, dim=-1)
    return (act(g) * u) @ p["wo"]
