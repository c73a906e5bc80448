"""Model facade (port of `repro/models/api.py`): one interface per family
for engines and launchers.

batch dicts (the JAX facade's):
  LM families:  {"tokens": (B, S) int [, "frontend_embeds": (B, P, d)]}
  encdec:       {"src_embeds": (B, T, d), "tokens": (B, S) int}
decode tokens: (B,) int.

`Model.forward` takes either such a batch (as in JAX: returns (logits,
aux)) or a token tensor plus the module's keyword arguments (returns the
module's (logits, cache, aux); what the engines call).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import encdec, hybrid, mamba_lm, transformer


def _mod(cfg):
    return {
        "dense": transformer, "moe": transformer, "vlm": transformer,
        "ssm": mamba_lm, "hybrid": hybrid, "encdec": encdec,
    }[cfg.family]


@dataclasses.dataclass
class Model:
    cfg: Any

    # ---- params ----------------------------------------------------
    def init(self, gen: torch.Generator, device=None, dtype=torch.float32):
        """Random params on `device` (default: the generator's), drawn in
        f32 and stored in `dtype`."""
        kw = {} if dtype == torch.float32 else {"dtype": dtype}
        return _mod(self.cfg).init(gen, self.cfg,
                                   device=device or gen.device, **kw)

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
    def forward(self, params, batch, **kw):
        """With a batch dict: full-sequence logits and aux (JAX
        `Model.forward`). With a token tensor: the module's forward and
        its (logits, cache, aux)."""
        m = _mod(self.cfg)
        if not isinstance(batch, dict):
            return m.forward(params, batch, self.cfg, **kw)
        if self.cfg.family == "encdec":
            logits, _, aux = m.forward(params, batch, self.cfg, **kw)
        else:
            logits, _, aux = m.forward(
                params, batch["tokens"], self.cfg,
                frontend_embeds=batch.get("frontend_embeds"), **kw)
        return logits, aux

    def prefill(self, params, batch, *, max_len: int, **kw):
        """Last-position logits (B, V) and the cache sized for `max_len`
        (JAX `Model.prefill`)."""
        m = _mod(self.cfg)
        if self.cfg.family == "encdec":
            return m.prefill(params, batch, self.cfg, max_len=max_len, **kw)
        return m.prefill(params, batch["tokens"], self.cfg, max_len=max_len,
                         frontend_embeds=batch.get("frontend_embeds"), **kw)

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
    def cache_specs(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    **kw):
        return _mod(self.cfg).cache_specs(self.cfg, batch, max_len, dtype,
                                          **kw)

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
    """Whether the serving engine runs the family on the dense slab
    (`decode_step` over `cache_specs`): every family but the
    encoder-decoder, whose prefill takes a batch with `src_embeds` (the
    JAX engine does not serve it either; it runs at the facade)."""
    return cfg.family != "encdec"


def build_model(cfg) -> Model:
    _mod(cfg)
    return Model(cfg)
