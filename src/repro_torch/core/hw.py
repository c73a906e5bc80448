# Copied unchanged from src/repro/core/hw.py.
"""Hardware constants for the roofline + analytical latency model.

TPU v5e is the deployment target (assignment constants). A100 numbers are
kept for sanity-checking the model against the paper's reported figures.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float      # FLOP/s
    hbm_bw: float               # B/s
    hbm_bytes: float
    ici_bw: float               # B/s per link
    ici_links: int              # usable links per chip (2D torus: 4)
    dcn_bw: float               # B/s per chip, cross-pod
    # empirical efficiency knobs (profiled on comparable systems)
    mm_eff: float = 0.55        # large-GEMM MXU efficiency
    attn_eff: float = 0.35      # flash-attention MXU efficiency
    hbm_eff: float = 0.8
    coll_latency: float = 4e-6  # per-collective latency (s)
    step_overhead: float = 50e-6


V5E = Chip(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_bytes=16e9,
    ici_bw=50e9,
    ici_links=4,
    dcn_bw=6.25e9,   # ~50 Gbps/chip effective across pods
)

A100_80G = Chip(
    name="a100-80g",
    peak_flops_bf16=312e12,
    hbm_bw=2.0e12,
    hbm_bytes=80e9,
    ici_bw=300e9,    # NVLink effective per-GPU
    ici_links=2,
    dcn_bw=3.1e9,    # 25 Gbps testbed in the paper
)

DEFAULT = V5E

# mesh geometry for the dry-run roofline
CHIPS_PER_POD = 256
POD_MESH = (16, 16)
