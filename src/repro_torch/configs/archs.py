# Copied unchanged from src/repro/configs/archs.py.
"""The 10 assigned architectures (exact configs from the assignment sheet).

Each also ships a `smoke()` reduction: same family / wiring, tiny dims, so a
single forward/train step runs on CPU in tests.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig, SSMConfig

# --- mixtral-8x22b [arXiv:2401.04088] -------------------------------------
MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    sliding_window=4096,  # per assignment: SWA
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2),
)

# --- moonshot-v1-16b-a3b (Moonlight) [hf:moonshotai/Moonlight-16B-A3B] -----
MOONSHOT_16B_A3B = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=64, num_experts_per_tok=6,
                  num_shared_experts=2, first_k_dense=1, dense_d_ff=11264),
)

# --- phi3-medium-14b [arXiv:2404.14219] ------------------------------------
PHI3_MEDIUM = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352, head_dim=128,
    rope_theta=10000.0,
)

# --- yi-6b [arXiv:2403.04652] ----------------------------------------------
YI_6B = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5e6,
)

# --- chatglm3-6b [arXiv:2406.12793] ----------------------------------------
CHATGLM3_6B = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rope_theta=10000.0, rope_fraction=0.5, rope_interleaved=True,  # 2d RoPE
)

# --- gemma3-1b [hf:google/gemma-3-1b-pt] ------------------------------------
GEMMA3_1B = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    sliding_window=512, local_global_ratio=5,   # 5 local : 1 global
    rope_theta=1e6, qk_norm=True,
    tie_embeddings=True, embedding_scale=True,
)

# --- internvl2-76b [arXiv:2404.16821]: ViT stub + LLaMA3-70B-like backbone --
INTERNVL2_76B = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    rope_theta=5e5,
    frontend="vision_patches", frontend_tokens=1024,
)

# --- mamba2-2.7b [arXiv:2405.21060] -----------------------------------------
MAMBA2_2P7B = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    head_dim=1,  # unused for ssm
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
    norm_type="rmsnorm",
)

# --- zamba2-7b [arXiv:2411.15242] -------------------------------------------
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    hybrid_attn_every=6,   # shared attn block after every 6 mamba2 blocks
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
)

# --- seamless-m4t-large-v2 [arXiv:2308.11596] --------------------------------
SEAMLESS_M4T_V2 = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    encoder_layers=24,
    norm_type="layernorm",
    frontend="audio_frames", frontend_tokens=0,  # encoder input IS frames
)

ARCHS = {
    c.name: c for c in [
        MIXTRAL_8X22B, MOONSHOT_16B_A3B, PHI3_MEDIUM, YI_6B, CHATGLM3_6B,
        GEMMA3_1B, INTERNVL2_76B, MAMBA2_2P7B, ZAMBA2_7B, SEAMLESS_M4T_V2,
    ]
}


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.family == "ssm" or cfg.family == "hybrid":
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                              conv_width=4, chunk_size=16, ngroups=1)
    if cfg.family != "ssm":
        kw["num_heads"] = 4
        kw["num_kv_heads"] = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
        kw["d_ff"] = 128
    if cfg.family == "moe":
        kw["moe"] = MoEConfig(
            num_experts=4, num_experts_per_tok=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_d_ff=160 if cfg.moe.dense_d_ff else 0)
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    if cfg.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
        kw["num_layers"] = 4
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["num_layers"] = 2
    if cfg.frontend_tokens:
        kw["frontend_tokens"] = 4
    return cfg.replace(**kw)
