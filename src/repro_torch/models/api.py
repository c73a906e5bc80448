"""Model facade (port of `repro/models/api.py`).

The port covers the dense decoder, on the paged KV path and on the dense
slot slab (sliding-window and local-global archs on the slab only), and
the SSM family (`mamba_lm`) on the slab. Other families raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import mamba_lm, transformer

_PORTED = {"dense": transformer, "ssm": mamba_lm}
# family -> the ROADMAP item that ports it
_LATER = {
    "moe": "A9 (MoE routed experts)",
    "vlm": "A9 (VLM frontends)",
    "hybrid": "A11 (models/hybrid.py)",
    "encdec": "A11 (models/encdec.py)",
}


def _mod(cfg):
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP {_LATER.get(cfg.family, 'A')})")
    return _PORTED[cfg.family]


@dataclasses.dataclass
class Model:
    cfg: Any

    # ---- params ----------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        """Random f32 params on `device` (default: the generator's)."""
        return _mod(self.cfg).init(gen, self.cfg,
                                   device=device or gen.device)

    @staticmethod
    def cast(params, dtype, device):
        """Floating leaves to `dtype` on `device`. A leaf already there is
        returned as is (`Tensor.to` makes no copy), so engines that share
        one param tree share its memory."""
        def leaf(x):
            if isinstance(x, dict):
                return {k: leaf(v) for k, v in x.items()}
            return x.to(device=device,
                        dtype=dtype if x.is_floating_point() else x.dtype)
        return leaf(params)

    # ---- compute ----------------------------------------------------
    def forward(self, params, tokens, **kw):
        return _mod(self.cfg).forward(params, tokens, self.cfg, **kw)

    def decode_step(self, params, cache, tokens, *, plain=False):
        """Dense-slab decode step (KV slabs or SSM state, in place)."""
        return _mod(self.cfg).decode_step(params, cache, tokens, self.cfg,
                                          plain=plain)

    def decode_step_paged(self, params, cache, tokens, *, plain=False):
        if not supports_paged(self.cfg):
            raise NotImplementedError(
                f"paged KV decode unsupported for {self.cfg.name} "
                f"(family={self.cfg.family})")
        return _mod(self.cfg).decode_step_paged(params, cache, tokens,
                                                self.cfg, plain=plain)

    # ---- specs -------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return _mod(self.cfg).cache_specs(self.cfg, batch, max_len, dtype)

    def paged_cache_specs(self, batch: int, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, max_len=None):
        if not supports_paged(self.cfg):
            raise NotImplementedError(
                f"paged KV cache unsupported for {self.cfg.name}")
        return _mod(self.cfg).paged_cache_specs(
            self.cfg, batch, num_pages, page_size, dtype, max_len=max_len)


def supports_paged(cfg) -> bool:
    """Paged KV decode covers plain causal attention: dense/GQA (incl. MoE
    FFNs and VLM backbones) without sliding windows. SSM/hybrid state and
    ring-packed window caches stay on the dense slab path."""
    return (cfg.family in ("dense", "moe", "vlm")
            and cfg.sliding_window == 0
            and not cfg.local_global_ratio)


def supports_slab(cfg) -> bool:
    """Whether the family's dense-slab decode (`decode_step` over
    `cache_specs`) is ported: every ported family (the transformer and the
    SSM), as the JAX engine runs any arch on the slab that is not paged."""
    return hasattr(_mod(cfg), "decode_step")


def build_model(cfg) -> Model:
    _mod(cfg)
    return Model(cfg)
