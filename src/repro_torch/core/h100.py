"""The NVIDIA H100 SXM5 80GB the port runs on, as a `hw.Chip` for the
latency model, and the fit of its efficiency fields to measured engine
step times.

`hw.py` is a copy of the JAX package's and stays unchanged; this module
is the port's counterpart of `hw.V5E`, the constant the JAX launcher
plans with (`launch/serve.py` plans with `H100`).

The peak rates come from the data sheet. The efficiency fields and the
step overhead are fitted to the port's own bf16 step times on the card
(`chip_smoke.py` phase 9a, `fit_chip` below), as the paper fits its
latency model by profiling its own engine (Appendix A): they describe the
port as it runs today, not the card's best. The decode step is host-bound
(ROADMAP B7), so `hbm_eff` comes out low; it is refitted when B7 lands.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from . import hw
from .latency_model import LatencyModel

H100 = hw.Chip(
    name="h100-sxm5-80g",
    peak_flops_bf16=989e12,     # dense bf16 tensor cores (data sheet)
    hbm_bw=3.35e12,             # HBM3 (data sheet)
    # torch.cuda.get_device_properties(0).total_memory on the card
    hbm_bytes=85_017_493_504,
    # NVLink 4: 900 GB/s a GPU, written as 450 GB/s x 2 links after the
    # A100 entry's convention (300 GB/s x 2 for its 600 GB/s). Data sheet
    # only: the machine the port runs on has one card, so nothing
    # measures it.
    ici_bw=450e9,
    ici_links=2,
    # cross-node bandwidth belongs to the cluster, not the card: the
    # paper's testbed figure (25 Gbps), as the A100 entry keeps it
    dcn_bw=3.1e9,
    # fitted by `fit_chip` to yi-6b bf16 step times of the port's Engine
    # (prefills of 4096-8192 tokens, decode steps of batch 1-8 over ~1000
    # tokens) on an "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
    # name,power.limit); `chip_smoke.py` phase 9a, PERF.md section 5.
    # The host-bound decode step took 29-55 ms from call to call on the
    # same card, so `hbm_eff` has come out between 0.09 and 0.24
    mm_eff=0.47322,
    attn_eff=0.280218,
    hbm_eff=0.0885997,
    step_overhead=0.00801915,
)


def fit_chip(cfg, prefill: Sequence[Tuple[int, float]],
             decode: Sequence[Tuple[int, float, float]],
             base: hw.Chip = H100) -> hw.Chip:
    """Fit `mm_eff`, `attn_eff`, `step_overhead` and `hbm_eff` of `base`
    to measured step times, on relative error, in two stages.

    `prefill` holds (L, seconds) of one from-scratch prefill of L tokens;
    `decode` holds (batch, ctx_tokens, seconds) of one decode step, with
    ctx_tokens the batch's cached tokens as the cluster charges them.

    1. Prefill, in the compute branch of `LatencyModel.prefill_time`
       (tp = pp = 1): T = G L / (P mm) + A(L) / (P attn) + C, linear in
       1/mm, 1/attn and C. The gemm term is linear in L and the attention
       term quadratic, so the two separate.
    2. Decode, in the memory branch of `decode_time` with that C:
       T - C = (W + KV(ctx)) / (B_hbm hbm). At tp = 1 the weight bytes do
       not change with the batch, so C and hbm cannot be fitted jointly
       from decode alone.

    Returns `base` with the four fields replaced; a value that is not a
    positive finite number comes back as it is, for the caller to refuse.
    """
    lm = LatencyModel(cfg, base)
    peak = base.peak_flops_bf16
    t = np.array([s for _, s in prefill], dtype=np.float64)
    a = np.array([[lm.gemm_flops_per_token() * L / peak,
                   lm.attn_flops([L]) / peak, 1.0] for L, _ in prefill])
    x, *_ = np.linalg.lstsq(a / t[:, None], np.ones_like(t), rcond=None)
    inv_mm, inv_attn, over = (float(v) for v in x)
    td = np.array([s for _, _, s in decode], dtype=np.float64)
    b = np.array([(lm.active_param_bytes(n) + lm.kv_read_bytes(ctx))
                  / base.hbm_bw for n, ctx, _ in decode])
    # minimise sum(((b y + C - T) / T)^2) over y = 1 / hbm
    inv_hbm = float(np.sum(b * (td - over) / td ** 2)
                    / np.sum(b ** 2 / td ** 2))
    return dataclasses.replace(base, mm_eff=_inv(inv_mm),
                               attn_eff=_inv(inv_attn),
                               hbm_eff=_inv(inv_hbm), step_overhead=over)


def _inv(v: float) -> float:
    return 1.0 / v if v else math.inf

