"""input_specs(): `TensorSpec` stand-ins for every (arch x shape) cell
(port of `repro/configs/shapes.py`).

No allocation: these feed the dry-run's fake tensors and the shardings
resolver. Modality frontends are stubs: VLM cells get patch embeddings,
audio cells get frame embeddings. Shapes and dtypes are JAX's
(`jnp.int32` tokens, `jnp.bfloat16` embeddings and caches).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.api import build_model
from ..models.common import TensorSpec
from .base import ModelConfig, ShapeConfig

# seamless decode cells: fixed encoder context length
ENCDEC_SRC_LEN = 4096


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16
    if cfg.family == "encdec":
        T = S // 2
        return {
            "src_embeds": TensorSpec((B, T, cfg.d_model), bf16),
            "tokens": TensorSpec((B, S - T), i32),
            "targets": TensorSpec((B, S - T), i32),
        }
    P = cfg.frontend_tokens
    specs = {
        "tokens": TensorSpec((B, S - P), i32),
        "targets": TensorSpec((B, S), i32),
    }
    if P:
        specs["frontend_embeds"] = TensorSpec((B, P, cfg.d_model), bf16)
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16
    if cfg.family == "encdec":
        return {
            "src_embeds": TensorSpec((B, S, cfg.d_model), bf16),
            "tokens": TensorSpec((B, 8), i32),  # primer prefix
        }
    P = cfg.frontend_tokens
    specs = {"tokens": TensorSpec((B, S - P), i32)}
    if P:
        specs["frontend_embeds"] = TensorSpec((B, P, cfg.d_model), bf16)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, Any]:
    """Returns (cache_specs, token_specs) for one decode step at kv=seq_len."""
    B, S = shape.global_batch, shape.seq_len
    model = build_model(cfg)
    kw = {"src_len": ENCDEC_SRC_LEN} if cfg.family == "encdec" else {}
    cache = model.cache_specs(B, S, torch.bfloat16, **kw)
    tokens = TensorSpec((B,), torch.int32)
    return cache, tokens


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return {"batch": train_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_specs(cfg, shape)}
    cache, tokens = decode_specs(cfg, shape)
    return {"cache": cache, "tokens": tokens}
