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
port as it runs today, not the card's best. The decode step is one CUDA
graph a decode engine (`serving/engine.py::DecodeGraph`), paced by the
card; `hbm_eff` and `step_overhead` come from it. Prefills run eagerly,
and below ~2k tokens the host's launches pace them (35-62 ms whatever
the length), which the form cannot hold: the fit leaves them out and the
model puts them at the card's time.
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
    # (prefills of 4096-8192 tokens; replayed decode steps of 8, 32 and 64
    # sequences at 1k-8k tokens each) on an "NVIDIA H100 80GB HBM3,
    # 700.00 W" (nvidia-smi name,power.limit); `chip_smoke.py` phase 9a,
    # PERF.md section 6. A second fit in the same call gave
    # mm_eff 0.438, attn_eff 0.354, hbm_eff 0.2993, step_overhead 0
    mm_eff=0.431351,
    attn_eff=0.385369,
    hbm_eff=0.299301,
    step_overhead=0.0,
)


def fit_chip(cfg, prefill: Sequence[Tuple[int, float]],
             decode: Sequence[Tuple[int, float, float]],
             base: hw.Chip = H100) -> hw.Chip:
    """Fit `hbm_eff`, `step_overhead`, `mm_eff` and `attn_eff` of `base`
    to measured step times, on relative error, in two stages.

    `prefill` holds (L, seconds) of one from-scratch prefill of L tokens;
    `decode` holds (batch, ctx_tokens, seconds) of one decode step, with
    ctx_tokens the batch's cached tokens as the cluster charges them.

    1. Decode, in the memory branch of `LatencyModel.decode_time`
       (tp = pp = 1): T = (W + KV(ctx)) / (B_hbm hbm) + C, linear in
       1/hbm and C, with C >= 0. The weight bytes W are the same at every
       point of a dense model, so the points must spread the KV bytes
       (batches and contexts): the slope gives hbm, the intercept C. One
       rate stands for two kernels' (the GEMMs read W, `paged_decode`
       the KV, at a rate far below theirs), so over a decode instance's
       batches the unconstrained intercept can come out below 0; an
       overhead is a time, so C then stays at 0 and hbm is fitted alone.
    2. Prefill, in the compute branch of `prefill_time` with that C:
       T - C = G L / (P mm) + A(L) / (P attn). The gemm term is linear in
       L and the attention term quadratic, so the two separate. The
       prefill points cannot place C themselves: over 4k-8k tokens any C
       from 0 to 12 ms fits yi-6b's within 1% on the card.

    Returns `base` with the four fields replaced; a value that is not a
    positive finite number comes back as it is, for the caller to refuse.
    """
    lm = LatencyModel(cfg, base)
    peak = base.peak_flops_bf16
    td = np.array([s for _, _, s in decode], dtype=np.float64)
    b = np.array([(lm.active_param_bytes(n) + lm.kv_read_bytes(ctx))
                  / base.hbm_bw for n, ctx, _ in decode]) / td
    # minimise sum((b y + C / T - 1)^2) over y = 1 / hbm and C >= 0
    (inv_hbm, over), *_ = np.linalg.lstsq(np.stack([b, 1.0 / td], 1),
                                          np.ones_like(td), rcond=None)
    if over < 0.0:
        inv_hbm, over = np.sum(b) / np.sum(b ** 2), 0.0
    over = float(over)
    t = np.array([s for _, s in prefill], dtype=np.float64)
    a = np.array([[lm.gemm_flops_per_token() * L / peak,
                   lm.attn_flops([L]) / peak] for L, _ in prefill])
    (inv_mm, inv_attn), *_ = np.linalg.lstsq(a / t[:, None], 1.0 - over / t,
                                             rcond=None)
    return dataclasses.replace(base, mm_eff=_inv(float(inv_mm)),
                               attn_eff=_inv(float(inv_attn)),
                               hbm_eff=_inv(float(inv_hbm)),
                               step_overhead=over)


def _inv(v: float) -> float:
    return 1.0 / v if v else math.inf

