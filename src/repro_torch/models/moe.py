"""FFN blocks: routed experts and the dense FFN (port of
`repro/models/moe.py`).

`moe_apply` picks the dispatch from the sharding rules as JAX does; with
none it is the JAX package's plain-pjit dispatch (`_moe_apply_pjit`),
the one it runs on a single device: top-k routing with a static
per-expert capacity C = max(ceil(T*k/E * cf), 8), tokens scattered into
(E, C, d) expert buffers, two batched expert products (`torch.bmm`, as
JAX computes them outside any Pallas kernel) and a weighted combine.
Tokens past an expert's capacity are dropped (GShard), in the order of
the exclusive cumsum over token-major (token, choice) pairs, so padded
prefill positions and idle decode slots route and take capacity exactly
as in JAX. The mesh dispatches (`moe_apply_grouped`,
`moe_apply_shard_map`) route per token group or per batch shard, each
group with its own capacity, as JAX's do.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .common import act_fn, current_rules, is_dtensor, param


def moe_params(gen, cfg, *, device, stack: int = 0,
               dtype=torch.float32) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    m = cfg.moe
    E = m.num_experts
    kw = dict(device=device, stack=stack, dtype=dtype)
    p = {
        "router": param(gen, (d, E), ("embed", "expert"), **kw),
        "wi": param(gen, (E, d, 2 * ff), ("expert", "embed", "mlp"), **kw),
        "wo": param(gen, (E, ff, d), ("expert", "mlp", "embed"), **kw),
    }
    if m.num_shared_experts:
        sf = ff * m.num_shared_experts
        p["shared_wi"] = param(gen, (d, 2 * sf), ("embed", "mlp"), **kw)
        p["shared_wo"] = param(gen, (sf, d), ("mlp", "embed"), **kw)
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
    buf = xf.new_zeros((E * C + 1, d))
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
    return out, _load_balance_loss(gates, onehot)


def _shared_part(p, xf, cfg):
    act = act_fn(cfg.mlp_activation)
    h = xf @ p["shared_wi"]
    g, u = torch.chunk(h, 2, dim=-1)
    return (act(g) * u) @ p["shared_wo"]


def moe_apply(p, x, cfg, capacity_factor: float = 0.0):
    """x: (B, S, d) -> ((B, S, d), aux). Dispatch picked from the active
    sharding rules, as in JAX: `moe_grouped` (shard-local groups) >
    `moe_shard_map` (routing per batch shard) > the plain dispatch."""
    rules = current_rules()
    if rules is not None and getattr(rules, "moe_grouped", False):
        return moe_apply_grouped(p, x, cfg, rules, capacity_factor)
    if rules is not None and getattr(rules, "moe_shard_map", False):
        return moe_apply_shard_map(p, x, cfg, rules, capacity_factor)
    return _moe_apply_pjit(p, x, cfg, capacity_factor)


def _batch_shards(rules) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in rules.mesh.shape:
            n *= rules.mesh.shape[a]
    return n


def _manual_shards(rules, B: int) -> int:
    """How many pieces the batch dim splits into over the manual (pod,
    data) axes: the resolved spec of ("batch", None, "embed_act")
    restricted to them (JAX `_manual_entries`)."""
    spec = rules.resolve(("batch", None, "embed_act"), (B, 1, 1))
    e = spec[0] if spec else None
    axes = () if e is None else (e if isinstance(e, tuple) else (e,))
    n = 1
    for a in axes:
        if a in ("pod", "data"):
            n *= rules.mesh.shape[a]
    return n


def route_groups(xf, router, wi, wo, cfg, capacity_factor: float, n: int):
    """Flat tokens xf (T, d) routed in n equal consecutive groups, each
    with its own capacity and drops; aux is the mean over the groups. One
    batch shard's dispatch (n = 1) or a shard's token groups."""
    if n == 1:
        return _routed_core(xf, router, wi, wo, cfg, capacity_factor)
    parts = [_routed_core(xg, router, wi, wo, cfg, capacity_factor)
             for xg in xf.chunk(n, dim=0)]
    return (torch.cat([o for o, _ in parts]),
            torch.stack([a for _, a in parts]).mean())


def _routed_by_groups(p, x, cfg, rules, capacity_factor: float, n: int):
    """x (B, S, d) routed in n token groups aligned with the batch shards
    (`route_groups`), plus the shared experts. On DTensors each rank
    routes its own shard's groups (`models/sharded.py::moe_shard_local`);
    on plain tensors the groups run in turn."""
    B, S, d = x.shape
    if is_dtensor(x):
        from .sharded import moe_shard_local
        out, aux = moe_shard_local(p, x, cfg, rules, capacity_factor, n)
    else:
        out, aux = route_groups(x.reshape(B * S, d), p["router"], p["wi"],
                                p["wo"], cfg, capacity_factor, n)
        out = out.reshape(x.shape)
    if cfg.moe.num_shared_experts:
        out = out + _shared_part(p, x.reshape(B * S, d), cfg).reshape(
            x.shape)
    return out, aux


def moe_apply_grouped(p, x, cfg, rules, capacity_factor: float = 0.0):
    """Dispatch in G = gcd(T, pod x data) token groups aligned with the
    batch shards (JAX `moe_apply_grouped`): routing, capacity and drops
    per group, so every gather and scatter stays group-local; aux is the
    mean over groups."""
    B, S, _ = x.shape
    G = math.gcd(B * S, _batch_shards(rules))
    return _routed_by_groups(p, x, cfg, rules, capacity_factor, G)


def moe_apply_shard_map(p, x, cfg, rules, capacity_factor: float = 0.0):
    """Routing per batch shard over the manual (pod, data) axes (JAX
    `moe_apply_shard_map`): each shard routes its own tokens with its own
    capacity, through the expert weights gathered whole over those axes;
    aux is the mean over the shards."""
    return _routed_by_groups(p, x, cfg, rules, capacity_factor,
                             _manual_shards(rules, x.shape[0]))


def _moe_apply_pjit(p, x, cfg, capacity_factor: float = 0.0):
    """x: (B, S, d) -> ((B, S, d), aux): JAX `_moe_apply_pjit`."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    out, aux = _routed_core(xf, p["router"], p["wi"], p["wo"], cfg,
                            capacity_factor)
    if cfg.moe.num_shared_experts:
        out = out + _shared_part(p, xf, cfg)
    return out.view(B, S, d), aux


def _load_balance_loss(gates, onehot):
    """Switch-style aux loss (fraction routed x mean gate); `onehot`
    (T*k, E) marks each routed choice's expert."""
    E = onehot.shape[1]
    fr = onehot.sum(dim=0).float() / onehot.shape[0]
    pe = gates.mean(dim=0)
    return E * torch.sum(fr * pe)


def dense_ffn_params(gen, d, ff, *, device, stack: int = 0,
                     dtype=torch.float32):
    kw = dict(device=device, stack=stack, dtype=dtype)
    return {"wi": param(gen, (d, 2 * ff), ("embed", "mlp"), **kw),
            "wo": param(gen, (ff, d), ("mlp", "embed"), **kw)}


def dense_ffn_apply(p, x, cfg):
    """Gated FFN over a fused `wi` of shape (d, 2*ff): act(x@wi[:, :ff]) *
    (x@wi[:, ff:]), then @ wo."""
    act = act_fn(cfg.mlp_activation)
    h = x @ p["wi"]
    g, u = torch.chunk(h, 2, dim=-1)
    return (act(g) * u) @ p["wo"]
