"""The dense decoder family (Llama-style: RoPE, GQA, SwiGLU, RMSNorm) as
the port runs it, and its weights.

`model_config` maps a published (Hugging Face style) config onto the
port's `ModelConfig`; `draw_weights` makes the weights from the seed on
the device, in the port's parameter layout and the served dtype, a few
large calls in all. The benchmark hands the same tensors to the port and
to the plain reference (`dense.py`). A configuration names this file by
its `family` key (`bench/model.py`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.model import DTYPES


def dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The sizes that the harness's arithmetic needs, by short name."""
    H = cfg["num_attention_heads"]
    d = cfg["hidden_size"]
    return dict(L=cfg["num_hidden_layers"], d=d, H=H,
                Hkv=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // H,
                ff=cfg["intermediate_size"], V=cfg["vocab_size"])


def model_config(cfg: Dict[str, Any]):
    """The port's `ModelConfig` of a dense decoder's published config."""
    from repro_torch.configs.base import ModelConfig
    if cfg.get("sliding_window"):
        raise ValueError("the dense paged path serves full attention only")
    n = dims(cfg)
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=n["L"],
        d_model=n["d"], num_heads=n["H"], num_kv_heads=n["Hkv"],
        d_ff=n["ff"], vocab_size=n["V"], head_dim=n["hd"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=cfg["torch_dtype"])


def draw_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Random weights of a dense decoder in the port's layout: one stacked
    segment `seg0` whose leaves lead with the layer axis, RMSNorm weights
    in the port's (1 + w) form, the gated FFN's `wi` fused (gate then up).
    Matrices are normal with std 1/sqrt(fan_in), the embedding std 1,
    the norms' w std 0.1 (so the reference has to apply them)."""
    n = dims(cfg)
    L, d, H, Hkv, hd, ff, V = (n[k] for k in
                                ("L", "d", "H", "Hkv", "hd", "ff", "V"))
    dtype = DTYPES[cfg["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def normal(shape, std):
        t = torch.empty(shape, device=device, dtype=dtype)
        return t.normal_(0.0, std, generator=gen)

    return {
        "embed": normal((V, d), 1.0),
        "final_norm": {"w": normal((d,), 0.1)},
        "lm_head": normal((d, V), d ** -0.5),
        "seg0": {
            "ln1": {"w": normal((L, d), 0.1)},
            "attn": {"wq": normal((L, d, H, hd), d ** -0.5),
                     "wk": normal((L, d, Hkv, hd), d ** -0.5),
                     "wv": normal((L, d, Hkv, hd), d ** -0.5),
                     "wo": normal((L, H, hd, d), (H * hd) ** -0.5)},
            "ln2": {"w": normal((L, d), 0.1)},
            "ffn": {"wi": normal((L, d, 2 * ff), d ** -0.5),
                    "wo": normal((L, ff, d), ff ** -0.5)},
        },
    }


def weight_bytes(cfg: Dict[str, Any]) -> int:
    """Bytes of the served weights (embedding included)."""
    n = dims(cfg)
    L, d, H, Hkv, hd, ff, V = (n[k] for k in
                                ("L", "d", "H", "Hkv", "hd", "ff", "V"))
    per_layer = d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * ff + 2 * d
    elems = 2 * V * d + d + L * per_layer
    return elems * DTYPES[cfg["torch_dtype"]].itemsize
