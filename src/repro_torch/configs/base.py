# Copied unchanged from src/repro/configs/base.py.
"""Model configuration schema shared by every assigned architecture.

Every field is plain data so configs hash/serialize cleanly (used as jit
static args and checkpoint metadata).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # DeepSeek/Moonlight-style extras
    num_shared_experts: int = 0
    first_k_dense: int = 0          # first k layers use a dense FFN
    dense_d_ff: int = 0             # d_ff of those dense layers (0 -> d_ff)
    router_jitter: float = 0.0
    capacity_factor: float = 0.0    # 0 -> dropless dense dispatch


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0              # N in Mamba2 / SSD
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256           # SSD block size
    ngroups: int = 1                # B/C groups (like GQA for SSM)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention pattern ---
    sliding_window: int = 0         # 0 -> full attention
    local_global_ratio: int = 0     # gemma3: N local layers per 1 global
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # chatglm3: rotary applied to a fraction
    rope_interleaved: bool = False  # pairwise (GLM/NeoX-2d) vs half-split
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False

    # --- FFN ---
    mlp_activation: str = "silu"    # silu (SwiGLU) | gelu (GeGLU)

    # --- norms / embeddings ---
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embedding_scale: bool = False   # gemma: scale embeds by sqrt(d)

    # --- sub-configs ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # --- hybrid (zamba2-style): shared attention block cadence ---
    hybrid_attn_every: int = 0      # insert shared attn block every N ssm layers

    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0         # >0 -> enc-dec; num_layers = decoder layers

    # --- modality frontend stubs ---
    frontend: str = "none"          # none | vision_patches | audio_frames
    frontend_tokens: int = 0        # patches/frames supplied by input_specs

    # --- numerics ---
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ---- derived quantities ----------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def num_params(self) -> int:
        """Analytic total parameter count (matches init'd pytree)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d + (0 if self.tie_embeddings else V * d)

        def attn_p():
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def dense_ffn(f):
            return 3 * d * f  # gate, up, down (SwiGLU)

        def norms():
            return 2 * d

        if self.family == "ssm":
            p = 0
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.ngroups * s.state_dim
            per = (d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)  # in_proj
                   + conv_dim * s.conv_width + conv_dim                   # conv + bias
                   + 2 * nheads                                           # A_log, D
                   + nheads                                               # dt_bias
                   + d_in                                                 # norm gate
                   + d_in * d + d)                                        # out_proj + norm
            p = per * self.num_layers
            return p + emb + d
        # transformer-ish
        per_layer = attn_p() + norms()
        if self.family in ("moe",):
            m = self.moe
            moe_layers = self.num_layers - m.first_k_dense
            e_ff = ff
            p = 0
            p += m.first_k_dense * dense_ffn(m.dense_d_ff or ff)
            p += moe_layers * (m.num_experts * dense_ffn(e_ff)
                               + m.num_shared_experts * dense_ffn(e_ff)
                               + d * m.num_experts)  # router
            p += self.num_layers * per_layer
        elif self.family == "hybrid":
            # zamba2: ssm blocks + one shared attn/ffn block
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.ngroups * s.state_dim
            per_ssm = (d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
                       + conv_dim * s.conv_width + conv_dim
                       + 2 * nheads + nheads + d_in + d_in * d + d)
            p = per_ssm * self.num_layers
            p += attn_p() + dense_ffn(ff) + norms()  # single shared block
        else:
            p = self.num_layers * (per_layer + dense_ffn(ff))
        if self.is_encdec:
            # encoder layers: self-attn + ffn; decoder adds cross-attn
            p += self.encoder_layers * (attn_p() + dense_ffn(ff) + norms())
            p += self.num_layers * attn_p()  # cross-attention
        p += emb + d  # final norm
        return p

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per sequence token (the DistServe transfer unit)."""
        if self.family == "ssm":
            return 0  # constant state, not per-token
        layers = self.num_layers
        if self.family == "hybrid":
            layers = self.num_layers // max(self.hybrid_attn_every, 1)
        return layers * 2 * self.kv_dim * dtype_bytes

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape regimes (assigned): every LM arch pairs with these four.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def long_context_ok(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM/hybrid/SWA)."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.sliding_window > 0  # SWA / local-global bound the KV
