"""FFN blocks (port of the dense part of `repro/models/moe.py`).

Only the dense SwiGLU/GeGLU FFN is ported so far; routed experts
(`moe_apply` and its helpers) are ROADMAP A9.
"""
from __future__ import annotations

import torch

from .common import act_fn, param


def dense_ffn_params(gen, d, ff, *, device, stack: int = 0):
    return {
        "wi": param(gen, (d, 2 * ff), device=device, stack=stack),
        "wo": param(gen, (ff, d), device=device, stack=stack),
    }


def dense_ffn_apply(p, x, cfg):
    """Gated FFN over a fused `wi` of shape (d, 2*ff): act(x@wi[:, :ff]) *
    (x@wi[:, ff:]), then @ wo."""
    act = act_fn(cfg.mlp_activation)
    h = x @ p["wi"]
    g, u = torch.chunk(h, 2, dim=-1)
    return (act(g) * u) @ p["wo"]
