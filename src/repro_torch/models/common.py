"""Shared model-building blocks (port of `repro/models/common.py`).

Params are plain tensors in nested dicts. `param` draws from an explicit
`torch.Generator` at the JAX package's init scales; the draws differ from
`jax.random`, so parity tests carry JAX weights over with
`repro_torch.weights.from_jax` instead. `shard` is the identity: the port
runs on one card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache leaf (JAX's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def shard(x: torch.Tensor, *logical) -> torch.Tensor:
    """No sharding context on one card: the identity."""
    return x


def param(gen: torch.Generator, shape, *, device, dtype=torch.float32,
          scale: Optional[float] = None, init: str = "normal",
          stack: int = 0) -> torch.Tensor:
    """One parameter (or `stack` stacked copies, leading layer axis) with
    the scales of `repro/models/common.py::param`: normal * 1/sqrt(fan_in),
    fan_in = shape[-2] (shape[-1] for vectors), unless `scale` is given.

    Drawn in f32. A stacked leaf of another `dtype` is drawn a layer at a
    time into a tensor of that dtype, so a bf16 model's peak stays near
    its bf16 size (moonshot-v1-16b-a3b's expert `wi` alone is 69 GB in
    f32)."""
    full = ((stack,) if stack else ()) + tuple(shape)
    if init == "zeros":
        return torch.zeros(full, device=device, dtype=dtype)
    if init == "ones":
        return torch.ones(full, device=device, dtype=dtype)
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
    if stack and dtype != torch.float32:
        out = torch.empty(full, device=device, dtype=dtype)
        for l in range(stack):
            out[l] = param(gen, shape, device=device, scale=scale)
        return out
    v = torch.randn(full, generator=gen, device=device, dtype=torch.float32)
    v.mul_(scale)       # in place: no second full-size temporary
    return v if dtype == torch.float32 else v.to(dtype)


def layer_of(tree, l: int):
    """Layer `l` of stacked params (leading layer axis; views, no copy)."""
    return {k: layer_of(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def rmsnorm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)    # gemma-style (1+w)


def layernorm(x, w, b, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(x, p, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def norm_params(gen, d, cfg, *, device, stack: int = 0,
                dtype=torch.float32):
    kw = dict(device=device, stack=stack, dtype=dtype)
    if cfg.norm_type == "layernorm":
        return {"w": param(gen, (d,), init="ones", **kw),
                "b": param(gen, (d,), init="zeros", **kw)}
    return {"w": param(gen, (d,), init="zeros", **kw)}  # (1+w) form


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, theta, fraction=1.0, interleaved=False):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, fraction, theta, device=x.device)
    ang = positions[..., None].float() * inv            # (..., S, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    dt = x.dtype
    xr, xp = x[..., :rot].float(), x[..., rot:]
    if interleaved:
        x0, x1 = xr[..., 0::2], xr[..., 1::2]
        r0 = x0 * cos - x1 * sin
        r1 = x1 * cos + x0 * sin
        xr = torch.stack([r0, r1], dim=-1).reshape(xr.shape)
    else:
        half = rot // 2
        x0, x1 = xr[..., :half], xr[..., half:]
        xr = torch.cat([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return torch.cat([xr.to(dt), xp], dim=-1) if rot < hd else xr.to(dt)


def embed_lookup(table, tokens):
    return table[tokens]
