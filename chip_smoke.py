#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no phase's error is caught):

1. build: print the card's name and power limit, turn TF32 off, build the
   CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a) and time it.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at its main path's shapes (yi-6b for the attention kernels, mamba2-2.7b
   for `ssd_scan`), in f32 and bf16, and time kernel, plain version and,
   where one exists, a PyTorch library call that computes the same
   function (a yardstick the port never calls). `paged_decode`,
   `prefix_prefill`, `flash_prefill` and `ssd_scan` also run at the serve
   phase's own shapes (B=8 tables of 128 pages with contexts up to 1532,
   B=1 at 1500; 512-token chunks over 512 and 384 prefix tokens;
   from-scratch prefills of 512 and 200 tokens; a 1536-token SSD scan);
   each row prints its achieved rate beside its bound (in f32 and bf16),
   `paged_decode` its split count, `flash_prefill` and `ssd_scan` the
   heads a block, and the split kernels whether two identical calls gave
   identical bits. The decode path's fused insert + decode kernel runs at
   the serve shapes too: output against the plain version (insert, then
   decode), both pools byte-equal, timed in turns with `paged_decode`
   alone on the same pools, so its row shows the insert's marginal cost;
   the standalone `paged_insert` also runs at B=1, the card's launch
   floor under the same timing. Then the head dims past the first
   instances: gemma3-1b's (4/1 heads of hd 256) `flash_prefill` at S=1024
   under the 512-token window and causal and at S=512, its slab decode
   (the fused insert + decode over a 2048-slot slab viewed as pages, and
   `paged_decode` over a 512-slot ring past the window), the standalone
   insert into the ring and `prefix_prefill`; zamba2-7b's attention (32/32
   heads of hd 112, on the 128 instance) in `flash_prefill`,
   `paged_decode` and `prefix_prefill`, and its `ssd_scan` (nh 112, N 64)
   at S=1536; seamless-m4t-large-v2's non-causal `flash_prefill` (16/16
   heads of hd 64) over 1024 frames and 64 target tokens over them, and
   its cross-attention decode (`paged_decode` over the 1024-frame slab);
   moonshot-v1-16b-a3b's group of 1 (16/16 heads of hd 128) in the three
   attention kernels at the serve phase's shapes.
3. serve yi-6b: `DisaggCluster` at full yi-6b width (random f32 weights
   from a seed, shared by both engines) serves a trace of 8 requests, some
   sharing a system prompt, with the prefix cache and 512-token chunked
   prefill. The four attention kernels' launch counts are read from this
   run.
4. check yi-6b: (a) on yi-6b-smoke, the disaggregated cluster on the card
   gives the same greedy f32 tokens as the same cluster on the CPU, where
   every kernel is its plain version; (b) a bf16 yi-6b model,
   teacher-forced over one prompt (a flash_prefill chunk, a prefix_prefill
   chunk) and 8 decode steps, gives the same logits through the kernels as
   through the plain versions, within a stated bound (with the attention
   projections at standard scales; see `standard_attention_scales`). The
   same comparison in f32 at the serving weights is printed for
   information. (c) For information, a `torch.profiler` trace of one
   batch-8 decode step, one 512-token prefill from scratch and one
   512-token chunk over a 1024-token prefix; the decode step's trace must
   hold one split kernel a layer and no standalone `paged_insert_kernel`.
   The yi-6b weights are then freed.
5. serve mamba2-2.7b: the same trace through `DisaggCluster` at full
   mamba2-2.7b width on the dense state slab (exact-length prefill, no
   prefix cache, no chunking). Every prefill layer runs `ssd_scan`; its
   launch count and the migrated state bytes are read from this run.
6. check mamba2-2.7b: (a) as 4(a) on mamba2-2.7b-smoke; (b) at full
   width, teacher-forced (a 512-token prefill, then 8 decode steps), the
   logits and the prefill's SSM state through the kernel against the plain
   versions, in f32 and bf16, each within a stated bound
   (`MAMBA_BOUNDS`); (c) for information, a `torch.profiler` trace of one
   1536-token prefill and one batch-8 decode step: the device's busy time,
   its idle share and the kernels that take most time.
7. serve gemma3-1b: the same trace through `DisaggCluster` at full
   gemma3-1b width (26 layers, 5 local : 1 global, window 512, hd 256) on
   the transformer's dense slab: exact-length prefill (`flash_prefill` in
   every layer; local caches ring-packed past the window, padded below
   it), slot writes, and the slab decode (`paged_insert` + `paged_decode`
   on the 22 ring layers, the fused kernel on the 4 global ones). Fails
   unless the launch counts and the migrated bytes (`kv_bytes`) are what
   the path must give; prints the real blob size beside them.
8. check gemma3-1b: (a) as 4(a) on gemma3-1b-smoke, and on yi-6b-smoke
   with `paged=False` (the bucketed slab prefill); (b) at full width,
   teacher-forced over a 700-token prompt and 8 decode steps on the slab,
   bf16 logits through the kernels against the plain versions within
   `GEMMA_LOGIT_BOUND`, at the serving weights (f32 printed beside them);
   (c) for information, a `torch.profiler` trace of one batch-8 slab
   decode step, which must hold one split kernel a layer and one
   standalone insert a ring layer.
9. the planning stack and the launcher, yi-6b at full width: (a) time
   one bf16 `Engine`'s own step times (from-scratch prefills of
   `HOST_PREFILL` and `FIT_PREFILL` tokens, decode steps of
   `FIT_DECODE_BATCH` sequences at `FIT_DECODE` tokens each; median of
   `FIT_REPS` after a warm-up),
   fit the H100 `Chip` (`core/h100.py::fit_chip`: `hbm_eff` and
   `step_overhead` on the decode steps, then the compute form on the
   device-bound `FIT_PREFILL`) and print every point against the fresh
   fit and the committed Chip; fails if a fitted value is not finite or
   an efficiency lies outside (0, 1]. (b) Plan sharegpt at rate 8 with
   Alg. 2 and Alg. 1 on the H100 Chip (one node of two cards) and serve
   the launcher's trace (`LIVE`) through `launch/serve.py::serve_live`
   with the low-affinity plan (f32, one copy of the weights for every
   engine); fails unless all 12 finish, the migrated bytes are the sum of
   `kv_bytes` and the four attention kernels launched. (c) The same
   cluster under `EngineCharge(LatencyModel(cfg, H100))` against the
   port's `SimDisaggBackend`: on the rate-20 trace the count of equal
   requests is printed; the same requests spaced `SPACED_GAP_S` apart
   must give every TTFT and TPOT equal to the float. (d) `FleetRouter`
   (prefix affinity) over two such clusters with the prefix cache, on
   `serve_trace`, against the same router over two `SimDisaggBackend`s:
   the `decisions` lists must be equal.
10. serve moonshot-v1-16b-a3b in bf16 at full width (48 layers, 64
   experts top-6 plus 2 shared; weights drawn a layer at a time): the
   yi-6b trace with the prefix cache and 512-token chunks, fused, then
   with `fused_prefix=False` (the dense-gather fallback); each fails
   unless 8/8 finish, the attention kernels launched 48 times a chunk or
   decode step by route, and the migrated bytes are the sum of
   `kv_bytes` over the inserts (`moe_serve_counts`); the fallback's
   tokens are compared with the fused run's.
11. check moonshot: (a) as 4(a) on moonshot-smoke (prefix, chunks) and
   mixtral-smoke (MoE on the slab); (b) teacher-forced logits, bf16 at
   full depth and f32 at 4 layers, held to `MOE_ROUTING_FLOOR` and
   `MOE_LOGIT_BOUND` (free run, then the plain path's routing replayed);
   (c) a profile of one bf16 decode step with the MoE's share.
12. serve zamba2-7b in f32 at full width on the slab (`ssd_scan` 81 and
   `flash_prefill` 13 a prefill, the fused insert + decode 13 a step;
   bytes the sum of `kv_bytes`); check: (a) smoke tokens, card against
   CPU; (b) logits and prefill SSM state, kernels against plain
   versions, f32 and bf16, held to `HYBRID_BOUNDS`.
13. at the facade: seamless-m4t-large-v2 at full width and depth (1024
   frames, a 64-token decoder prefill, 8 decode steps) and internvl2-76b
   at full width cut to 4 layers (1024 frontend embeddings + 200 tokens,
   8 decode steps on the slab): logits through the kernels against the
   plain versions, f32 and bf16, held to `FACADE_BOUNDS`, and each
   kernel's launches against the path's count.
14. training: (a) the backward kernel `flash_prefill_bwd` against
   `flash_prefill_bwd_ref` (each gradient within `BWD_BOUNDS` of its
   largest |value|, two calls' bits equal) and the forward's LSE against
   the plain LSE (`LSE_TOL`), f32 and bf16, at yi-6b's training shape
   (B=4, S=1024) and at gemma3-1b's, seamless-m4t-large-v2's encoder and
   cross-attention and zamba2-7b's (hd 112) attention, timed against
   their plain versions and SDPA's backward, each line with the route and
   tiles the backward takes there (`bwd_warpgroups`); (b) yi-6b at full
   width cut to 8 layers (`train_config`), bf16 compute, f32 params and AdamW,
   remat, B=4 x S=1024 of `SyntheticTokens`, attention projections at
   standard scales: one step's loss, grad_norm and every gradient leaf
   through the kernels against the plain versions (`TRAIN_BOUNDS`), with
   `flash_prefill` 16 and `flash_prefill_bwd` 8 launches a step; then 5
   steps timed (loss, wall time after a synchronise, tokens/s, MFU
   against 989 TF/s, peak memory) and a profile of one; (c) a restart of
   that step: checkpoint at step 2, restore into fresh tensors, run to
   step 4, equal to the straight run (`restart_phase`); (d) the launcher
   `python -m repro_torch.launch.train` on yi-6b-smoke for 20 steps with
   checkpoints every 10, then again: it resumes at step 20.
15. training the SSM families: (a) the backward kernel `ssd_scan_bwd`
   against `ssd_scan_bwd_ref` (each gradient within `SSD_BWD_BOUNDS` of
   its largest |value|, two calls' bits equal), f32 and bf16, at
   mamba2-2.7b's training shape (b=2, S=2048 in 8 chunks of 256, nh 80,
   hd 64, G 1, N 128), zamba2-7b's (nh 112, N 64) and a small shape with
   G=2, `h0` and `dh_final` given and a chunk of 40, timed against the
   plain version (no library call computes it), with the ptxas line of
   its instances and, at the two training shapes, each of its seven
   launches' device time; (b) mamba2-2.7b at full
   width and depth, bf16 compute, f32 params and AdamW, remat, B=2 x
   S=2048 of `SyntheticTokens`: one step's loss, grad_norm and every
   gradient leaf through the kernels against the plain versions
   (`TRAIN_BOUNDS`), with `ssd_scan` 128 and `ssd_scan_bwd` 64 launches a
   step, then 5 timed steps (MFU from `ssm_train_flops`) and a profile;
   (c) the same for zamba2-7b at full width cut to 14 layers (2 groups of
   6 and a tail of 2; the shared attention at standard scales; remat
   as JAX's, each group one checkpoint over its blocks' own, the tail
   unrematted): `ssd_scan` 38, `ssd_scan_bwd` 14, `flash_prefill` 4 and
   `flash_prefill_bwd` 2 launches a step; (d) the launcher
   `python -m repro_torch.launch.train --arch mamba2-2.7b-smoke --remat`
   on the card for 10 steps.

16. the sharding vocabulary and the dry-run tools: (a) `launch/dryrun.py::
   lower_cell` at full width on the fake 256/512-rank meshes (host work,
   run on the card's machine for its torch): yi-6b x train_4k,
   prefill_32k and decode_32k on pod1, decode_32k on pod2,
   moonshot-v1-16b-a3b x prefill_32k (the shard-local MoE dispatch),
   mixtral-8x22b x prefill_32k (serve_2d), mamba2-2.7b x long_500k, and
   zamba2-7b and seamless-m4t-large-v2 x train_4k (the remat structure),
   each with its status, seconds, dot flops, collectives by kind and
   per-rank peak; fails if a cell errs or its dot flops differ from JAX's
   `jaxpr_costs` in `tests/torch_dryrun_jax_flops.json`. (b)
   `launch/diagnose.py --serve-metrics` at full yi-6b width on the card
   (two replicas sharing one f32 copy of the weights, JAX's 10-request
   burst): the router's, each replica's and the fleet's dumps; fails
   unless finished plus shed is 10, the metric names are those of the
   yi-6b-smoke run on the CPU, and `flash_prefill` and `paged_decode`
   launched. (c) a decode cache split 4 ways along its sequence:
   `decode_attend` on 4 gloo ranks over CUDA tensors of this card, each
   rank's `paged_decode` combined by its log-sum-exp, against the
   unsharded kernel (`TOL`; the written caches bit for bit).

The last line of standard output is `{"ok": true, "device": {...}}`. The
full record also goes to `chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12,      # f32 outside the tensor cores
              "bfloat16": 989e12}    # dense bf16 tensor cores
TOL = {"float32": dict(atol=5e-5, rtol=5e-5),      # tests/test_kernels.py
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
SOURCES = {
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode/kernel.py:161"),
    "paged_insert": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode/kernel.py:241"),
    "prefix_prefill": ("src/repro_torch/csrc/prefix_prefill.cu",
                       "src/repro/kernels/prefix_prefill/kernel.py:183"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill/kernel.py:78"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:85"),
    # the gradient of flash_prefill: JAX takes it through the jnp oracle
    # (src/repro/models/attention.py:44), the TPU kernel has no backward
    "flash_prefill_bwd": ("src/repro_torch/csrc/flash_prefill_bwd.cu",
                          "src/repro/kernels/flash_prefill/kernel.py:78"),
    # the gradient of ssd_scan: JAX takes it through the jnp ssd_chunked
    # (src/repro/models/ssd.py:34), the TPU kernel has no backward
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:85"),
}
# the kernels each served path runs (their launches are read from its run)
PATHS = {"yi-6b": ("paged_decode", "paged_insert", "prefix_prefill",
                   "flash_prefill"),
         "mamba2-2.7b": ("ssd_scan",),
         "gemma3-1b": ("flash_prefill", "paged_decode", "paged_insert"),
         "launch.serve": ("paged_decode", "paged_insert", "prefix_prefill",
                          "flash_prefill"),
         "router": ("paged_decode", "paged_insert", "prefix_prefill",
                    "flash_prefill"),
         "moonshot-v1-16b-a3b": ("paged_decode", "paged_insert",
                                 "prefix_prefill", "flash_prefill"),
         "zamba2-7b": ("ssd_scan", "flash_prefill", "paged_decode",
                       "paged_insert"),
         "seamless-m4t-large-v2": ("flash_prefill", "paged_decode",
                                   "paged_insert"),
         "internvl2-76b": ("flash_prefill", "paged_decode", "paged_insert"),
         "train": ("flash_prefill", "flash_prefill_bwd"),
         "train-mamba2": ("ssd_scan", "ssd_scan_bwd")}
# the summary line's rows: (name, kernel, path, kernel-phase row[, the
# row's dtype, default float32: the dtype the path runs])
SUMMARY = [("paged_decode", "paged_decode", "yi-6b", "paged_decode"),
           ("paged_insert", "paged_insert", "yi-6b", "paged_insert"),
           ("prefix_prefill", "prefix_prefill", "yi-6b", "prefix_prefill"),
           ("flash_prefill", "flash_prefill", "yi-6b", "flash_prefill"),
           ("ssd_scan", "ssd_scan", "mamba2-2.7b", "ssd_scan"),
           ("flash_prefill@gemma3-1b", "flash_prefill", "gemma3-1b",
            "flash_prefill_gemma3_s1024_w512"),
           ("paged_decode@gemma3-1b", "paged_decode", "gemma3-1b",
            "slab_ring_decode_gemma3_b8"),
           ("paged_insert@gemma3-1b", "paged_insert", "gemma3-1b",
            "paged_insert_gemma3_b8")] + [
    (f"{k}@{path}", k, path, k)
    for path in ("launch.serve", "router")
    for k in ("paged_decode", "paged_insert", "prefix_prefill",
              "flash_prefill")] + [
    ("paged_decode@moonshot-v1-16b-a3b", "paged_decode",
     "moonshot-v1-16b-a3b", "paged_decode_moonshot_b8", "bfloat16"),
    ("paged_insert@moonshot-v1-16b-a3b", "paged_insert",
     "moonshot-v1-16b-a3b", "paged_insert_decode_moonshot_b8", "bfloat16"),
    ("prefix_prefill@moonshot-v1-16b-a3b", "prefix_prefill",
     "moonshot-v1-16b-a3b", "prefix_prefill_moonshot_p512", "bfloat16"),
    ("flash_prefill@moonshot-v1-16b-a3b", "flash_prefill",
     "moonshot-v1-16b-a3b", "flash_prefill_moonshot_s512", "bfloat16"),
    ("ssd_scan@zamba2-7b", "ssd_scan", "zamba2-7b",
     "ssd_scan_zamba2_s1536"),
    ("flash_prefill@zamba2-7b", "flash_prefill", "zamba2-7b",
     "flash_prefill_zamba2_s1024"),
    ("paged_decode@zamba2-7b", "paged_decode", "zamba2-7b",
     "paged_decode_zamba2_b8"),
    ("flash_prefill@seamless-m4t-large-v2", "flash_prefill",
     "seamless-m4t-large-v2", "flash_prefill_seamless_cross_s64"),
    ("paged_decode@seamless-m4t-large-v2", "paged_decode",
     "seamless-m4t-large-v2", "slab_decode_seamless_cross_b1"),
    ("flash_prefill@train", "flash_prefill", "train",
     "flash_prefill_lse_yi6b_train", "bfloat16"),
    ("flash_prefill_bwd@train", "flash_prefill_bwd", "train",
     "flash_prefill_bwd_yi6b_train", "bfloat16"),
    ("ssd_scan_bwd@train-mamba2", "ssd_scan_bwd", "train-mamba2",
     "ssd_scan_bwd_mamba2_train", "bfloat16")]
# whole-model bf16 check: kernel-path logits within this fraction of the
# plain path's largest |logit|. Both paths run the same bf16 matmuls; they
# differ only in where attention rounds to bf16 and in the f32 summation
# order, which drifts through 32 layers. A wrong kernel gives O(1)
# relative differences.
LOGIT_BOUND = 0.1
# the same check on gemma3-1b's slab path (26 layers, bf16), by the same
# argument: both paths run the same bf16 matmuls and differ only where
# attention rounds to bf16 and in the f32 summation order; qk-norm holds
# the attention scores near unit scale at the JAX init, so no rescaling of
# the projections is needed to keep softmax from a hard argmax.
GEMMA_LOGIT_BOUND = 0.1
# ssd_scan against its plain version: f32 as the JAX sweep
# (tests/test_kernels.py:237); in bf16 both read the same bf16 inputs and
# compute in f32, so y differs by about one bf16 rounding
SSD_TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
           "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# whole-model mamba2-2.7b check, kernel path vs plain path, as a fraction
# of the plain path's largest |value| (logits; prefill SSM state). A wrong
# kernel gives O(1) differences. f32: the SSM has no softmax to amplify a
# rounding, so the paths differ only by the scan's summation order (~5e-6
# of |y| per layer) added up over 64 layers: ~2e-5 of scale on an H100.
# bf16: where the two f32 scans round y to bf16 differently (one ulp,
# 2^-8), every later bf16 op of that layer and the layers above rounds
# differently too, so the paths drift apart at bf16's own noise level
# (5.6% of the largest logit, 8.6% of the largest state entry on an H100);
# the bf16 plain path's distance from the f32 plain path is printed beside
# it as that noise level.
MAMBA_BOUNDS = {"float32": 1e-4, "bfloat16": 0.25}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

SPIN_CYCLES = 40_000_000     # ~20 ms of device spin ahead of a timed run
L2_BYTES = 50 * 2**20           # H100 L2 cache


def time_ms(fn, iters=20, warmup=3):
    """Device time of one call, from CUDA events around `iters` calls.
    `fn` is a callable or a list of callables taken in turn (copies of the
    inputs, so that data a real caller finds cold in L2 is cold here too).
    The timed calls are queued behind a spin kernel (`torch.cuda._sleep`),
    so the host has queued them before the device reaches the first one:
    the events time the device's work, not the host's launch overhead."""
    import torch
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(nbytes):
    """How many copies of `nbytes` of inputs, taken in turn, keep each
    call's reads cold in the L2 cache (at least 3 x L2 in all)."""
    return max(1, min(16, -(-3 * L2_BYTES // max(nbytes, 1))))


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def achieved(r):
    """The row's achieved rate against the resource that bounds it."""
    if r["bound_by"] == "bytes":
        return f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s " \
               f"({r['bound_ms'] / r['ms']:.1%} of the bound)"
    return f"{r['flops'] / r['ms'] / 1e9:.2f} TF/s " \
           f"({r['bound_ms'] / r['ms']:.1%} of the bound)"


def max_err(out, ref, dtype_name, tols=TOL):
    import torch
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    tol = tols[dtype_name]
    ok = bool((err <= tol["atol"] + tol["rtol"] * b.abs()).all())
    return float(err.max()), ok


def sdpa(q, k, v, mask=None, causal=False):
    """Library yardstick: (B, H, S, hd) SDPA with GQA done by the library."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, enable_gqa=True)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def dtype_name(dtype):
    return str(dtype).split(".")[-1]


class Rows:
    """Kernel rows at one model's attention shapes (H query heads over Hkv
    kv heads of head dim hd) on the card, from one seeded generator: each
    method holds a kernel against its plain version on the same inputs and
    times kernel, plain version and library yardstick. Returns the row."""

    def __init__(self, H, Hkv, hd, seed, page=16):
        import torch
        self.H, self.Hkv, self.hd, self.page = H, Hkv, hd, page
        self.dev = "cuda"
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(self, *shape, dtype):
        import torch
        return torch.randn(shape, generator=self.gen, device=self.dev) \
            .to(dtype)

    def randperm(self, n):
        import torch
        return torch.randperm(n, generator=self.gen, device=self.dev)

    def heads(self):
        return f"H={self.H} Hkv={self.Hkv} hd={self.hd}"

    def decode(self, dtype, B, pps, lens, trash):
        """paged_decode over B tables of `pps` pages, timed on enough pool
        copies that each call reads its K/V cold from HBM, as a decode
        step's layer does. With `trash`, table slots past each live length
        point at page 0, as the engine leaves them."""
        import torch
        from repro_torch.kernels.paged_decode.kernel import (decode_split,
                                                             paged_decode)
        from repro_torch.kernels.paged_decode.ref import paged_decode_ref
        H, Hkv, hd, page, dev = self.H, self.Hkv, self.hd, self.page, \
            self.dev
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        num_pages = B * pps + 1
        q = self.randn(B, H, hd, dtype=dtype)
        perm = self.randperm(num_pages - 1) + 1
        table = perm.reshape(B, pps).to(torch.int32)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        if trash:
            slot = torch.arange(pps, device=dev)[None]
            table[slot >= (lens[:, None] + page - 1) // page] = 0
        n_ctx = int(lens.sum())
        live_pages = int(((lens + page - 1) // page).sum())
        nbytes = (2 * B * H * hd * es + 2 * n_ctx * Hkv * hd * es
                  + live_pages * 4 + B * 4)
        pools = [(self.randn(num_pages, page, Hkv, hd, dtype=dtype),
                  self.randn(num_pages, page, Hkv, hd, dtype=dtype))
                 for _ in range(cold_copies(nbytes))]
        kp, vp = pools[0]
        out = paged_decode(q, kp, vp, table, lens)
        again = paged_decode(q, kp, vp, table, lens)
        ref = paged_decode_ref(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        pos = torch.arange(pps * page, device=dev)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]

        def lib(kp, vp):
            ks = kp[table.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
            vs = vp[table.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
            return sdpa(q[:, :, None], ks, vs, mask=mask)
        per, n_split = decode_split(B, Hkv, pps, page, self.sms)
        return dict(
            shape=f"B={B} ctx<={int(lens.max())} pps={pps} page={page} "
                  f"{self.heads()}",
            max_abs_err=err, ok=ok and bool(torch.equal(out, again)),
            repeat_identical=bool(torch.equal(out, again)),
            ms=time_ms([lambda kp=kp, vp=vp: paged_decode(q, kp, vp, table,
                                                          lens)
                        for kp, vp in pools]),
            plain_ms=time_ms(lambda: paged_decode_ref(q, kp, vp, table,
                                                      lens)),
            library_ms=time_ms([lambda kp=kp, vp=vp: lib(kp, vp)
                                for kp, vp in pools]),
            library="page gather + scaled_dot_product_attention",
            bytes=nbytes, flops=4 * n_ctx * H * hd,
            split_pages=per, n_split=n_split, blocks=B * Hkv * n_split)

    def insert_decode(self, dtype, B, pps, lens):
        """The fused insert-and-decode kernel over B tables of `pps` pages
        (slots past each live length on trash page 0), on enough pool copies
        that each call reads its K/V cold, beside `paged_decode` alone on
        the same pools, timed in turns (fused, alone, fused, alone). The
        output is held to TOL, both pools must be byte-equal to the plain
        version's, and the decode-only kernel over the pools the fused call
        left must give the same bits. Bound: the decode's bytes plus the
        new rows read and written."""
        import torch
        from repro_torch.kernels.paged_decode.kernel import (
            decode_split, paged_decode, paged_insert_decode)
        from repro_torch.kernels.paged_decode.ref import \
            paged_insert_decode_ref
        H, Hkv, hd, page, dev = self.H, self.Hkv, self.hd, self.page, \
            self.dev
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        num_pages = B * pps + 1
        q = self.randn(B, H, hd, dtype=dtype)
        kn = self.randn(B, Hkv, hd, dtype=dtype)
        vn = self.randn(B, Hkv, hd, dtype=dtype)
        perm = self.randperm(num_pages - 1) + 1
        table = perm.reshape(B, pps).to(torch.int32)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        slot = torch.arange(pps, device=dev)[None]
        table[slot >= (lens[:, None] + page - 1) // page] = 0
        n_ctx = int(lens.sum())
        live_pages = int(((lens + page - 1) // page).sum())
        dec_bytes = (2 * B * H * hd * es + 2 * n_ctx * Hkv * hd * es
                     + live_pages * 4 + B * 4)
        nbytes = dec_bytes + 4 * B * Hkv * hd * es
        pools = [(self.randn(num_pages, page, Hkv, hd, dtype=dtype),
                  self.randn(num_pages, page, Hkv, hd, dtype=dtype))
                 for _ in range(cold_copies(nbytes))]
        kp, vp = pools[0]
        k2, v2 = kp.clone(), vp.clone()
        out = paged_insert_decode(q, kn, vn, kp, vp, table, lens)
        again = paged_insert_decode(q, kn, vn, kp, vp, table, lens)
        alone = paged_decode(q, kp, vp, table, lens)
        ref = paged_insert_decode_ref(q, kn, vn, k2, v2, table, lens)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        pools_equal = bool(torch.equal(kp, k2) and torch.equal(vp, v2))
        same = bool(torch.equal(out, again))
        as_decode = bool(torch.equal(out, alone))
        del k2, v2
        pos = torch.arange(pps * page, device=dev)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]
        wp = lens.long() - 1
        li = table[torch.arange(B, device=dev), wp // page].long()
        lo = wp % page

        def lib(kp, vp):
            kp.index_put_((li, lo), kn)
            vp.index_put_((li, lo), vn)
            ks = kp[table.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
            vs = vp[table.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
            return sdpa(q[:, :, None], ks, vs, mask=mask)
        fused = [lambda kp=kp, vp=vp: paged_insert_decode(q, kn, vn, kp, vp,
                                                          table, lens)
                 for kp, vp in pools]
        dec = [lambda kp=kp, vp=vp: paged_decode(q, kp, vp, table, lens)
               for kp, vp in pools]
        turns = [time_ms(f, iters=50) for f in (fused, dec, fused, dec)]
        ms, dec_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        per, n_split = decode_split(B, Hkv, pps, page, self.sms)
        return dict(
            shape=f"B={B} ctx<={int(lens.max())} pps={pps} page={page} "
                  f"{self.heads()}",
            max_abs_err=err, ok=ok and pools_equal and same and as_decode,
            pools_byte_equal=pools_equal, repeat_identical=same,
            equals_decode_alone=as_decode,
            ms=ms, decode_ms=dec_ms, marginal_ms=ms - dec_ms,
            turns_ms=turns,
            plain_ms=time_ms(lambda: paged_insert_decode_ref(
                q, kn, vn, kp, vp, table, lens)),
            library_ms=time_ms([lambda kp=kp, vp=vp: lib(kp, vp)
                                for kp, vp in pools]),
            library="index_put_ (K and V) + page gather + "
                    "scaled_dot_product_attention",
            bytes=nbytes, decode_bytes=dec_bytes, flops=4 * n_ctx * H * hd,
            split_pages=per, n_split=n_split, blocks=B * Hkv * n_split)

    def insert(self, dtype, B, kp, vp, table):
        """The standalone paged_insert: one token for each of B sequences
        into distinct pages (slot 5 of each table row), byte-exact against
        the plain version."""
        import torch
        from repro_torch.kernels.paged_decode.kernel import paged_insert
        from repro_torch.kernels.paged_decode.ref import paged_insert_ref
        Hkv, hd, page = self.Hkv, self.hd, kp.shape[1]
        es = torch.empty((), dtype=dtype).element_size()
        kn = self.randn(B, Hkv, hd, dtype=dtype)
        vn = self.randn(B, Hkv, hd, dtype=dtype)
        pidx = table[:B, 5].contiguous()                   # distinct pages
        off = torch.arange(B, dtype=torch.int32, device=self.dev) % page
        k1, v1 = kp.clone(), vp.clone()
        k2, v2 = kp.clone(), vp.clone()
        paged_insert(k1, v1, kn, vn, pidx, off)
        paged_insert_ref(k2, v2, kn, vn, pidx, off)
        torch.cuda.synchronize()
        exact = bool(torch.equal(k1, k2) and torch.equal(v1, v2))
        li, lo = pidx.long(), off.long()

        def lib_insert():
            k1.index_put_((li, lo), kn)
            v1.index_put_((li, lo), vn)
        return dict(
            shape=f"B={B} page={page} Hkv={Hkv} hd={hd}",
            max_abs_err=float((k1.float() - k2.float()).abs().max()),
            ok=exact,
            ms=time_ms(lambda: paged_insert(k1, v1, kn, vn, pidx, off)),
            plain_ms=time_ms(lambda: paged_insert_ref(k2, v2, kn, vn, pidx,
                                                      off)),
            library_ms=time_ms(lib_insert), library="index_put_ (K and V)",
            bytes=4 * B * Hkv * hd * es + 2 * B * 4, flops=0)

    def prefix(self, dtype, Sq, P):
        """prefix_prefill: an Sq-token suffix over a P-token prefix."""
        import torch
        from repro_torch.kernels.prefix_prefill.kernel import prefix_prefill
        from repro_torch.kernels.prefix_prefill.ref import prefix_prefill_ref
        H, Hkv, hd, page, dev = self.H, self.Hkv, self.hd, self.page, \
            self.dev
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        npp = P // page
        qs = self.randn(1, H, Sq, hd, dtype=dtype)
        ksf = self.randn(1, Hkv, Sq, hd, dtype=dtype)
        vsf = self.randn(1, Hkv, Sq, hd, dtype=dtype)
        kp = self.randn(npp + 1, page, Hkv, hd, dtype=dtype)
        vp = self.randn(npp + 1, page, Hkv, hd, dtype=dtype)
        perm = self.randperm(npp) + 1
        ptab = perm[None].to(torch.int32)
        plens = torch.tensor([P], dtype=torch.int32, device=dev)
        out = prefix_prefill(qs, ksf, vsf, kp, vp, ptab, plens)
        ref = prefix_prefill_ref(qs, ksf, vsf, kp, vp, ptab, plens)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        pairs = Sq * P + Sq * (Sq + 1) // 2
        kpos = torch.arange(P + Sq, device=dev)
        qpos = torch.arange(Sq, device=dev)
        pmask = (kpos[None, :] <= P + qpos[:, None])[None, None]

        def lib_prefix():
            kk = kp[ptab[0].long()].reshape(P, Hkv, hd).transpose(0, 1)[None]
            vv = vp[ptab[0].long()].reshape(P, Hkv, hd).transpose(0, 1)[None]
            return sdpa(qs, torch.cat([kk, ksf], 2), torch.cat([vv, vsf], 2),
                        mask=pmask)
        return dict(
            shape=f"Sq={Sq} prefix={P} page={page} {self.heads()}",
            max_abs_err=err, ok=ok,
            ms=time_ms(lambda: prefix_prefill(qs, ksf, vsf, kp, vp, ptab,
                                              plens)),
            plain_ms=time_ms(lambda: prefix_prefill_ref(
                qs, ksf, vsf, kp, vp, ptab, plens), iters=5),
            library_ms=time_ms(lib_prefix),
            library="page gather + concat + scaled_dot_product_attention",
            bytes=(2 * H * Sq * hd * es + 2 * Hkv * Sq * hd * es
                   + 2 * P * Hkv * hd * es + npp * 4 + 4),
            flops=4 * pairs * H * hd)

    def flash(self, dtype, S, window=0):
        """flash_prefill: an S-token causal prefill from scratch, under a
        sliding window where `window` > 0. In bf16 also the time with one
        and (where the kernel takes it) two query heads a block, forced by
        replacing `flash_heads_per_block` for the timing (the wrapper picks
        one from the shapes)."""
        import torch
        from repro_torch.kernels.flash_prefill import kernel as flash_kernel
        from repro_torch.kernels.flash_prefill.kernel import (
            flash_heads_per_block, flash_prefill)
        from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
        H, Hkv, hd = self.H, self.Hkv, self.hd
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        qf = self.randn(1, H, S, hd, dtype=dtype)
        kf = self.randn(1, Hkv, S, hd, dtype=dtype)
        vf = self.randn(1, Hkv, S, hd, dtype=dtype)
        kw = dict(causal=True, window=window)
        out = flash_prefill(qf, kf, vf, **kw)
        again = flash_prefill(qf, kf, vf, **kw)
        ref = flash_prefill_ref(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        same = bool(torch.equal(out, again))
        pos = torch.arange(S, device=self.dev)
        if window:
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)

            def lib():
                return sdpa(qf, kf, vf, mask=band)
            library = "scaled_dot_product_attention(band mask)"
        else:
            def lib():
                return sdpa(qf, kf, vf, causal=True)
            library = "scaled_dot_product_attention(is_causal=True)"
        pairs = sum(min(i + 1, window or S) for i in range(S))
        r = dict(
            shape=f"S={S} causal{f' window={window}' if window else ''} "
                  f"{self.heads()}",
            max_abs_err=err, ok=ok and same, repeat_identical=same,
            ms=time_ms(lambda: flash_prefill(qf, kf, vf, **kw)),
            plain_ms=time_ms(lambda: flash_prefill_ref(qf, kf, vf, **kw),
                             iters=5),
            library_ms=time_ms(lib), library=library,
            bytes=(2 * H * S * hd + 2 * Hkv * S * hd) * es,
            flops=4 * pairs * H * hd,
            heads_per_block=flash_heads_per_block(1, H, Hkv, S, self.sms,
                                                  hd))
        if dtype == torch.bfloat16:
            chosen = flash_kernel.flash_heads_per_block
            two = hd <= 128 and (H // Hkv) % 2 == 0
            try:
                for qh in ((1, 2) if two else (1,)):
                    flash_kernel.flash_heads_per_block = \
                        lambda *shape, qh=qh, **_: qh
                    r[f"ms_heads_per_block_{qh}"] = time_ms(
                        lambda: flash_prefill(qf, kf, vf, **kw))
            finally:
                flash_kernel.flash_heads_per_block = chosen
        return r

    def flash_nc(self, dtype, Sq, Skv):
        """flash_prefill without the causal mask: Sq queries over Skv keys
        (an encoder layer where Sq == Skv, a cross-attention layer
        otherwise)."""
        import torch
        from repro_torch.kernels.flash_prefill.kernel import (
            flash_heads_per_block, flash_prefill)
        from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
        H, Hkv, hd = self.H, self.Hkv, self.hd
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        qf = self.randn(1, H, Sq, hd, dtype=dtype)
        kf = self.randn(1, Hkv, Skv, hd, dtype=dtype)
        vf = self.randn(1, Hkv, Skv, hd, dtype=dtype)
        out = flash_prefill(qf, kf, vf, causal=False)
        again = flash_prefill(qf, kf, vf, causal=False)
        ref = flash_prefill_ref(qf, kf, vf, causal=False)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        same = bool(torch.equal(out, again))
        return dict(
            shape=f"Sq={Sq} Skv={Skv} non-causal {self.heads()}",
            max_abs_err=err, ok=ok and same, repeat_identical=same,
            ms=time_ms(lambda: flash_prefill(qf, kf, vf, causal=False)),
            plain_ms=time_ms(lambda: flash_prefill_ref(qf, kf, vf,
                                                       causal=False),
                             iters=5),
            library_ms=time_ms(lambda: sdpa(qf, kf, vf)),
            library="scaled_dot_product_attention",
            bytes=(2 * H * Sq * hd + 2 * Hkv * Skv * hd) * es,
            flops=4 * Sq * Skv * H * hd,
            heads_per_block=flash_heads_per_block(1, H, Hkv, Sq, self.sms,
                                                  hd))

    def slab_decode(self, dtype, B, smax, pos, ring):
        """The slab decode attention of `models/transformer.py::
        attn_decode` over a (B, smax, Hkv, hd) slab layer viewed as pages
        (`models/attention.py::slab_pages`), on enough slab copies that
        each call reads its K/V cold. A full slab (`ring=False`): the fused
        insert + decode of the new row at slot pos = lens - 1, both slabs
        byte-equal to the plain version's after it. A ring (pos past the
        window): `paged_decode` alone over all smax slots, as the ring
        layers run it after their standalone insert (its own row). Library:
        SDPA over the slab itself (no gather), after `index_put_` of the
        new rows for the full slab."""
        import torch
        from repro_torch.kernels.paged_decode.kernel import (
            decode_split, paged_decode, paged_insert_decode)
        from repro_torch.kernels.paged_decode.ref import (
            paged_decode_ref, paged_insert_decode_ref)
        from repro_torch.models.attention import slab_pages
        H, Hkv, hd, dev = self.H, self.Hkv, self.hd, self.dev
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        lens = torch.clamp(pos + 1, max=smax)
        q = self.randn(B, H, hd, dtype=dtype)
        kn = self.randn(B, Hkv, hd, dtype=dtype)
        vn = self.randn(B, Hkv, hd, dtype=dtype)
        n_ctx = int(lens.sum())
        nbytes = 2 * B * H * hd * es + 2 * n_ctx * Hkv * hd * es + B * 4
        if not ring:
            nbytes += 4 * B * Hkv * hd * es
        slabs = [(self.randn(B, smax, Hkv, hd, dtype=dtype),
                  self.randn(B, smax, Hkv, hd, dtype=dtype))
                 for _ in range(cold_copies(nbytes))]
        views = [slab_pages(kc, vc) for kc, vc in slabs]
        kp, vp, table = views[0]
        page = kp.shape[1]
        if ring:
            def kern(kp, vp):
                return paged_decode(q, kp, vp, table, lens)

            def plain(kp, vp):
                return paged_decode_ref(q, kp, vp, table, lens)
        else:
            def kern(kp, vp):
                return paged_insert_decode(q, kn, vn, kp, vp, table, lens)

            def plain(kp, vp):
                return paged_insert_decode_ref(q, kn, vn, kp, vp, table,
                                               lens)
        k2, v2 = kp.clone(), vp.clone()
        out = kern(kp, vp)
        again = kern(kp, vp)
        ref = plain(k2, v2)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        same = bool(torch.equal(out, again))
        pools_equal = bool(torch.equal(kp, k2) and torch.equal(vp, v2))
        del k2, v2
        slot = torch.arange(smax, device=dev)
        mask = (slot[None, :] < lens[:, None])[:, None, None, :]
        rows = torch.arange(B, device=dev)
        wp = lens.long() - 1

        def lib(kc, vc):
            if not ring:
                kc.index_put_((rows, wp), kn)
                vc.index_put_((rows, wp), vn)
            return sdpa(q[:, :, None], kc.transpose(1, 2),
                        vc.transpose(1, 2), mask=mask)
        per, n_split = decode_split(B, Hkv, smax // page, page, self.sms)
        return dict(
            shape=f"B={B} slab={smax}{' ring' if ring else ''} "
                  f"pos<={int(pos.max())} ctx<={int(lens.max())} "
                  f"page={page} {self.heads()}",
            max_abs_err=err, ok=ok and same and pools_equal,
            repeat_identical=same, pools_byte_equal=pools_equal,
            ms=time_ms([lambda kp=kp, vp=vp: kern(kp, vp)
                        for kp, vp, _ in views]),
            plain_ms=time_ms(lambda: plain(kp, vp)),
            library_ms=time_ms([lambda kc=kc, vc=vc: lib(kc, vc)
                                for kc, vc in slabs]),
            library=("" if ring else "index_put_ (K and V) + ")
            + "scaled_dot_product_attention over the slab",
            bytes=nbytes, flops=4 * n_ctx * H * hd,
            split_pages=per, n_split=n_split, blocks=B * Hkv * n_split)


def finish_rows(rows, dn):
    """Bound and achieved rate of each row, one log line each; raise if any
    row disagrees with its plain version."""
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], dn)
        r["achieved"] = achieved(r)
        split = (f" n_split={r['n_split']} ({r['split_pages']} pages, "
                 f"{r['blocks']} blocks)" if "n_split" in r else "")
        if "heads_per_block" in r:
            split += f" heads_per_block={r['heads_per_block']}" + "".join(
                f" ms[{q}]={r[f'ms_heads_per_block_{q}']:.4f}"
                for q in (1, 2) if f"ms_heads_per_block_{q}" in r)
        if "repeat_identical" in r:
            split += f" repeat_identical={r['repeat_identical']}"
        if "marginal_ms" in r:
            split += (f" decode_alone_ms={r['decode_ms']:.4f} "
                      f"insert_marginal_ms={r['marginal_ms']:.4f} "
                      f"pools_byte_equal={r['pools_byte_equal']} "
                      f"equals_decode_alone={r['equals_decode_alone']}")
        elif "pools_byte_equal" in r:
            split += f" pools_byte_equal={r['pools_byte_equal']}"
        log(f"kernel {name:28s} {dn:8s} {r['shape']}: "
            f"max_abs_err={r['max_abs_err']:.3e} "
            f"{'ok' if r['ok'] else 'MISMATCH'} "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"achieved={r['achieved']}{split}")
    bad = [n for n, r in rows.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel phase: {bad} disagree with their plain "
                         f"versions in {dn}")


# the serve trace's prompt lengths at the first decode step (B=8 tables of
# 128 pages), as the yi-6b rows take them
SERVE_LENS = [1532, 1100, 903, 640, 517, 300, 200, 33]


def kernel_phase(cfg, dtypes):
    """The four attention kernels at yi-6b's heads (32/4, hd 128): the
    PERF shapes and the serve phase's own."""
    import torch
    R = Rows(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 1234)
    page = R.page
    results = {}
    for dtype in dtypes:
        dn = dtype_name(dtype)
        rows = {}

        # -- paged_decode: B=8, context 1024 (ragged), page 16 -------------
        B, ctx = 8, 1024
        rows["paged_decode"] = R.decode(
            dtype, B, ctx // page, [ctx - 37 * i for i in range(B)],
            trash=False)
        # the serve phase's shapes: B=8 tables of 128 pages, and B=1
        rows["paged_decode_serve_b8"] = R.decode(
            dtype, 8, 128, SERVE_LENS,
            trash=True)
        rows["paged_decode_serve_b1"] = R.decode(dtype, 1, 128, [1500],
                                                 trash=True)
        table = R.randperm(B * ctx // page).reshape(B, ctx // page) \
            .to(torch.int32) + 1
        kp = R.randn(B * ctx // page + 1, page, R.Hkv, R.hd, dtype=dtype)
        vp = R.randn(B * ctx // page + 1, page, R.Hkv, R.hd, dtype=dtype)

        # -- paged_insert: one token per sequence, byte-exact; at B=1 the
        #    card's launch floor under the same timing ----------------------
        rows["paged_insert"] = R.insert(dtype, B, kp, vp, table)
        rows["paged_insert_b1"] = R.insert(dtype, 1, kp, vp, table)
        del kp, vp
        # -- the decode path's fused insert + decode, at the serve shapes --
        rows["paged_insert_decode_serve_b8"] = R.insert_decode(
            dtype, 8, 128, SERVE_LENS)
        rows["paged_insert_decode_serve_b1"] = R.insert_decode(
            dtype, 1, 128, [1500])

        # -- prefix_prefill: a 512-token suffix over a 1024-token prefix -
        rows["prefix_prefill"] = R.prefix(dtype, 512, 1024)
        # the serve phase's chunks: over a 512- and a 384-token prefix
        rows["prefix_prefill_p512"] = R.prefix(dtype, 512, 512)
        rows["prefix_prefill_p384"] = R.prefix(dtype, 512, 384)

        # -- flash_prefill: S=1024 causal, and the serve phase's first
        #    chunks of 512 and 200 tokens -----------------------------------
        for key, S in (("flash_prefill", 1024), ("flash_prefill_s512", 512),
                       ("flash_prefill_s200", 200)):
            rows[key] = R.flash(dtype, S)
        finish_rows(rows, dn)
        results[dn] = rows
    return results


# the gemma3-1b slab decode's lengths: the serve trace's prompts less 1 at
# the first decode step over a 2048-slot global slab, and positions past
# the window over a 512-slot ring
SLAB_POS = [1531, 1099, 902, 639, 516, 299, 199, 32]
RING_POS = [1531, 1099, 902, 639, 516, 600, 700, 800]


def wide_kernel_phase(gcfg, zcfg, dtypes):
    """The attention kernels at the head dims above 128 (gemma3-1b: 4/1
    heads of 256) and off the instances (zamba2-7b's attention: 32/32
    heads of 112, on the 128 instance with 16 padding columns): the
    gemma3-1b slab path's shapes, and the kernels it does not run at hd
    256 (prefix_prefill) and at hd 112."""
    import torch
    from repro_torch.models.attention import slab_pages
    G = Rows(gcfg.num_heads, gcfg.num_kv_heads, gcfg.head_dim, 2345)
    Z = Rows(zcfg.num_heads, zcfg.num_kv_heads, zcfg.head_dim, 3456)
    w = gcfg.sliding_window
    results = {}
    for dtype in dtypes:
        dn = dtype_name(dtype)
        rows = {}
        # -- gemma3-1b: prefill of a local layer (window 512) and of a
        #    global one (causal) at S=1024, and a 512-token prompt --------
        rows["flash_prefill_gemma3_s1024_w512"] = G.flash(dtype, 1024, w)
        rows["flash_prefill_gemma3_s1024"] = G.flash(dtype, 1024)
        rows["flash_prefill_gemma3_s512"] = G.flash(dtype, 512)
        # -- the slab decode: a global layer's fused insert + decode over a
        #    2048 slab, a ring layer's decode over its 512 ring past the
        #    window, and the ring layer's standalone insert -----------------
        rows["slab_decode_gemma3_b8"] = G.slab_decode(dtype, 8, 2048,
                                                      SLAB_POS, ring=False)
        rows["slab_ring_decode_gemma3_b8"] = G.slab_decode(
            dtype, 8, w, RING_POS, ring=True)
        kc = G.randn(8, w, G.Hkv, G.hd, dtype=dtype)
        kp, vp, table = slab_pages(kc, G.randn(8, w, G.Hkv, G.hd,
                                               dtype=dtype))
        rows["paged_insert_gemma3_b8"] = G.insert(dtype, 8, kp, vp, table)
        del kc, kp, vp
        rows["prefix_prefill_gemma3_p512"] = G.prefix(dtype, 512, 512)
        # -- zamba2-7b's attention shapes, hd 112 --------------------------
        rows["flash_prefill_zamba2_s1024"] = Z.flash(dtype, 1024)
        rows["paged_decode_zamba2_b8"] = Z.decode(
            dtype, 8, 128, SERVE_LENS,
            trash=True)
        rows["prefix_prefill_zamba2_p512"] = Z.prefix(dtype, 512, 512)
        finish_rows(rows, dn)
        results[dn] = rows
        torch.cuda.empty_cache()
    return results


def ssd_flops_bytes(b, S, nh, hd, G, N, Q, es):
    """Useful operations and bytes of one SSD scan: C.B^T over the causal
    pairs once per (chunk, group); per (chunk, head) the masked product
    with x dt, the carried-in state's product and the chunk's state.
    Bytes: x, B, C in and y out in the storage type, dt, A, D and h_final
    in f32, each once."""
    P = Q * (Q + 1) // 2
    nc = S // Q
    flops = b * nc * (G * 2 * P * N + nh * (2 * P * hd + 4 * Q * N * hd))
    nbytes = (2 * b * S * nh * hd * es + 2 * b * S * G * N * es
              + b * S * nh * 4 + 2 * nh * 4 + b * nh * hd * N * 4)
    return flops, nbytes


SSD_SHAPES = (("ssd_scan", 2048, 256), ("ssd_scan_s1536", 1536, 256),
              ("ssd_scan_ragged", 200, 200))


def ssd_kernel_phase(cfg, dtypes, shapes=SSD_SHAPES):
    """`ssd_scan` at a main path's shapes, (row, S, chunk) each; for
    mamba2-2.7b (`SSD_SHAPES`) a 2048-token prefill (8 chunks of 256),
    the traced 1536-token prefill (6 chunks) and a 200-token prompt (one
    ragged chunk of 200); two identical calls must give identical bits. Inputs have the distributions of the JAX sweep
    (tests/test_kernels.py::test_ssd_scan_sweep). No single PyTorch call
    computes an SSD scan, so there is no library yardstick."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_plan, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    s = cfg.ssm
    nh, hd = s.expand * cfg.d_model // s.head_dim, s.head_dim
    G, N = s.ngroups, s.state_dim
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    results = {}
    for dtype in dtypes:
        dn = str(dtype).split(".")[-1]
        es = torch.empty((), dtype=dtype).element_size()
        rows = {}
        for key, S, Q in shapes:
            x = randn(1, S, nh, hd).to(dtype)
            dt = torch.nn.functional.softplus(randn(1, S, nh)) * 0.1
            A = -torch.exp(randn(nh))
            B = randn(1, S, G, N).to(dtype)
            C = randn(1, S, G, N).to(dtype)
            D = randn(nh)
            y, h = ssd_scan(x, dt, A, B, C, D, chunk=Q)
            y2, h2 = ssd_scan(x, dt, A, B, C, D, chunk=Q)
            ry, rh = ssd_scan_ref(x, dt, A, B, C, D, chunk=Q)
            torch.cuda.synchronize()
            err_y, ok_y = max_err(y, ry, dn, SSD_TOL)
            err_h, ok_h = max_err(h, rh, "float32", SSD_TOL)
            same = bool(torch.equal(y, y2) and torch.equal(h, h2))
            flops, nbytes = ssd_flops_bytes(1, S, nh, hd, G, N, Q, es)
            rows[key] = dict(
                shape=f"b=1 S={S} chunk={Q} nh={nh} hd={hd} G={G} N={N}",
                max_abs_err=max(err_y, err_h), max_abs_err_y=err_y,
                max_abs_err_h=err_h, ok=ok_y and ok_h and same,
                repeat_identical=same,
                heads_per_block=ssd_plan(1, S, nh, hd, G, N, Q, sms)
                .heads_per_block,
                ms=time_ms(lambda: ssd_scan(x, dt, A, B, C, D, chunk=Q)),
                plain_ms=time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, D,
                                                      chunk=Q), iters=5),
                library_ms=None, library="none", bytes=nbytes, flops=flops)
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], dn)
            log(f"kernel {name:15s} {dn:8s} {r['shape']}: "
                f"max_abs_err y={r['max_abs_err_y']:.3e} "
                f"h={r['max_abs_err_h']:.3e} "
                f"{'ok' if r['ok'] else 'MISMATCH'} "
                f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms=none bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) achieved={achieved(r)} "
                f"heads_per_block={r['heads_per_block']} "
                f"repeat_identical={r['repeat_identical']}")
        results[dn] = rows
        bad = [n for n, r in rows.items() if not r["ok"]]
        if bad:
            raise SystemExit(f"kernel phase: {bad} disagree with their plain "
                             f"versions in {dn}")
    return results


# ---------------------------------------------------------------------------
# phases 3 and 5: disaggregated serving at full width
# ---------------------------------------------------------------------------

def serve_trace(vocab, seed=0, n=8):
    """8 requests, prompts of 200..1500 tokens, the first 5 sharing a
    384-token system prompt, 16..32 output tokens each."""
    import numpy as np
    from repro_torch.core.workload import Request
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, 384).tolist()
    lens = [1500, 640, 200, 1100, 900, 300, 1280, 520][:n]
    reqs = []
    for i, L in enumerate(lens):
        body = rng.integers(1, vocab, L).tolist()
        toks = (system + body)[:L] if i < 5 else body
        reqs.append(Request(i, 0.05 * i, L, 16 + (5 * i) % 17,
                            tokens=tuple(toks)))
    return reqs


def graph_launches(counts, engines):
    """-> (launches the card ran, by kernel; a line on the decode graphs).
    `counts` are the kernels' wrappers' counts. A decode engine's CUDA
    graph (`serving/engine.py::DecodeGraph`) passed its step's launches
    through the wrappers once, at the capture, which ran nothing; each
    replay runs them again without passing the wrappers."""
    ran, line = dict(counts), []
    for e in engines:
        g = e.decode_graph
        if g is None:
            continue
        for k, n in g.launches.items():
            ran[k] += (e.graph_replays - 1) * n
        step = {k: n for k, n in g.launches.items() if n}
        line.append(f"{e.graph_replays} replays of {json.dumps(step)}")
    return ran, "decode graphs: " + ("; ".join(line) or "none")


def serve_phase(cfg, params, path=None, **cluster_kw):
    """Serve `serve_trace` through `DisaggCluster` (1 prefill + 1 decode
    engine, 8 slots, max_len 2048, plus `cluster_kw`); the launch counts
    are set to 0 just before and read just after, and the launches of the
    decode graph's replays are added to them (`graph_launches`). Fails
    unless every request finishes well formed and every kernel of this
    model's path (`PATHS[path or cfg.name]`) passed its wrapper. Also records the decode engine's
    steps, the prefill engine's chunk and fused dispatches, the sizes
    (`Engine.kv_blob_bytes`) of the blobs whole-prompt prefills returned,
    the sum of `kv_bytes` over what each insert on the decode side took
    (the prompt less its decode-side prefix hit) and every request's
    tokens."""
    import torch
    from repro_torch.core.kv_transfer import kv_bytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.cluster import DisaggCluster

    dc = DisaggCluster(cfg, params, n_prefill=1, n_decode=1, max_batch=8,
                       max_len=2048, **cluster_kw)
    pre, dec = dc.prefill[0], dc.decode[0]
    blob_bytes, shipped = [], []

    def prefill_request(seq, _run=pre.prefill_request):
        first, blob, dt = _run(seq)
        blob_bytes.append(pre.kv_blob_bytes(blob))
        return first, blob, dt
    pre.prefill_request = prefill_request

    def insert_kv(seq, wire, shared=(), skip_tokens=0, _run=dec.insert_kv):
        ship = wire[1] - skip_tokens
        shipped.append(kv_bytes(cfg, ship) if ship else 0)
        return _run(seq, wire, shared=shared, skip_tokens=skip_tokens)
    dec.insert_kv = insert_kv
    reqs = serve_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = dc.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ran, graphs = graph_launches(counts, dc.decode)
    finished = [r for r in res.values() if r.finish >= 0
                and r.finish_reason != "failed"]
    ttft = statistics.median(r.ttft for r in res.values())
    tpot = statistics.median(r.tpot for r in res.values())
    prefix_hits = sum(r.prefix_hit for r in res.values())
    out = dict(submitted=len(reqs), served=len(res), finished=len(finished),
               ttft_median_s=ttft, tpot_median_s=tpot,
               kv_bytes_migrated=dc.tx.total_bytes,
               prefill_prefix_hit_tokens=prefix_hits,
               prompt_tokens=sum(r.in_len for r in reqs),
               generated_tokens=sum(r.n_generated for r in res.values()),
               wall_s=wall, launches=ran, wrapper_launches=counts,
               decode_steps=dc.decode[0].steps, blob_bytes=sum(blob_bytes),
               kv_bytes_of_inserts=sum(shipped),
               chunk_dispatches=pre.chunk_dispatches,
               fused_dispatches=pre.fused_dispatches,
               tokens={rid: list(r.tokens) for rid, r in res.items()})
    dn = dtype_name(cluster_kw.get("dtype", torch.float32))
    log(f"serve {cfg.name} {dn}: served={len(res)}/{len(reqs)} "
        f"finished={len(finished)} ttft_median={ttft:.4f}s "
        f"tpot_median={tpot:.4f}s (virtual clock) "
        f"kv_bytes_migrated={dc.tx.total_bytes} "
        f"prefix_hit_tokens={prefix_hits} wall={wall:.2f}s")
    log("kernels " + json.dumps(counts))
    log(f"{graphs}; launches run {json.dumps(ran)}")
    for rid, r in sorted(res.items()):
        req = reqs[rid]
        if len(r.tokens) != req.in_len + req.out_len or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise SystemExit(f"serve: request {rid} came back malformed")
    if len(finished) != len(reqs):
        raise SystemExit("serve: not every request finished")
    zero = [k for k in PATHS[path or cfg.name] if counts[k] <= 0]
    if zero:
        raise SystemExit(f"serve: kernels never launched on the main path: "
                         f"{zero}")
    # the wrapped methods above close a cycle through each engine: free
    # the cluster's pools now, not at the collector's next full pass
    del dc, pre, dec, prefill_request, insert_kv
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# phase 4: checks against the plain versions
# ---------------------------------------------------------------------------

def smoke_tokens_check(name, **cluster_kw):
    """`name` (a smoke config): the disaggregated cluster on the card
    (kernels) and on the CPU (plain versions) give the same greedy f32
    tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.workload import Request
    from repro_torch.models.api import build_model
    from repro_torch.serving.cluster import DisaggCluster

    cfg = get_config(name)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    toks = {}
    for dev in ("cuda", "cpu"):
        # fresh requests per run: a run fills in their lifecycle fields
        reqs = [Request(i, i * 0.01, 10 + (i % 4) * 7, 6) for i in range(6)]
        dc = DisaggCluster(cfg, params, n_prefill=1, n_decode=1,
                           max_batch=4, max_len=64, device=dev, **cluster_kw)
        toks[dev] = {rid: r.tokens for rid, r in dc.run(reqs).items()}
    same = toks["cuda"] == toks["cpu"]
    kw = "".join(f" {k}={v}" for k, v in cluster_kw.items())
    log(f"check {name}{kw} f32 tokens, card vs CPU plain versions: "
        f"{'identical' if same else 'DIFFER'} over {len(reqs)} requests")
    if not same:
        raise SystemExit("check: card tokens differ from the CPU reference")
    return dict(requests=len(reqs), identical=same)


def teacher_force(eng, tokens, n_first, n_prompt, plain):
    """On a fresh cache of `eng` (batch 1): prefill `tokens[:n_first]`
    from scratch (flash_prefill), then `tokens[n_first:n_prompt]` over the
    pool pages (prefix_prefill), then one decode step (the fused
    paged_insert + paged_decode) per remaining token. `plain=True` runs
    the plain versions instead of the kernels. Returns every stage's
    logits in f32."""
    import torch
    ps = eng._kv.page_size
    eng._cache = cache = eng._empty_cache()
    pages = list(range(1, -(-len(tokens) // ps) + 1))
    cache["block_tables"][0, :len(pages)] = torch.tensor(pages)
    toks = torch.as_tensor(tokens, device=eng.device)[None]
    pools = {k: v for k, v in cache.items() if k.startswith("seg")}
    out = []
    lg, kv, _ = eng.model.forward(eng.params, toks[:, :n_first],
                                  return_cache=True, plain=plain)
    out.append(lg[:, 0].float())
    eng._write_pages({k: kv[k] for k in pools}, pages[:n_first // ps])
    lg, kv, _ = eng.model.forward(
        eng.params, toks[:, n_first:n_prompt], return_cache=True,
        prefix_pages=pools,
        prefix_table=cache["block_tables"][:, :n_first // ps],
        prefix_len=n_first, pos_offset=n_first, plain=plain)
    out.append(lg[:, 0].float())
    eng._write_pages({k: kv[k] for k in pools},
                     pages[n_first // ps:n_prompt // ps])
    cache["pos"][0] = n_prompt
    for t in range(n_prompt, len(tokens)):
        lg, cache = eng.model.decode_step_paged(eng.params, cache,
                                                toks[:, t], plain=plain)
        out.append(lg.float())
    return torch.cat(out)


def standard_attention_scales(params, cfg):
    """Rescale the attention projections, in place, to the usual fan-in
    scales. The JAX init (kept by the port) takes fan_in = shape[-2], so
    wq/wk/wv of shape (d, heads, hd) get std 1/sqrt(heads) instead of
    1/sqrt(d): at yi-6b width the attention scores have a std of ~100 and
    the softmax is a hard argmax, which bf16 rounding flips from one path
    to the other. With these scales the comparison measures the kernels,
    not that instability."""
    for name, seg in params.items():
        if name.startswith("seg"):
            scale_attention(seg["attn"], cfg)


def scale_attention(a, cfg):
    """One attention block's projections (wq/wk/wv (d, heads, hd), wo (H,
    hd, d), stacked or not) to the usual fan-in scales, in place (see
    `standard_attention_scales`)."""
    import math as _m
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    a["wq"].mul_(_m.sqrt(H / d))
    a["wk"].mul_(_m.sqrt(Hkv / d))
    a["wv"].mul_(_m.sqrt(Hkv / d))
    a["wo"].mul_(1 / _m.sqrt(H))


def _compare(eng, tokens, what):
    import torch
    got = teacher_force(eng, tokens, 512, 768, plain=False)
    want = teacher_force(eng, tokens, 512, 768, plain=True)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"check yi-6b {what}: teacher-forced logits (prefill 512 + chunk "
        f"256 + 8 decode steps), kernels vs plain versions: "
        f"max_abs_diff={diff:.4e} max_abs_logit={scale:.4e} "
        f"argmax_agree={agree:.3f}")
    return dict(max_abs_diff=diff, max_abs_logit=scale, argmax_agree=agree)


def logits_check(cfg, params):
    """Whole-model check. For information: an f32 Engine at the serving
    weights, then with the attention projections at standard scales. Held
    to the bound: a bf16 Engine at full width, standard scales. Rescales
    `params` in place (the serving phase is over)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Engine

    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, 768 + 8).tolist()
    eng = Engine(cfg, params, max_batch=1, max_len=1024)  # shares params
    out = {"f32_serving_weights": _compare(
        eng, tokens, "f32, serving weights (information)")}
    standard_attention_scales(params, cfg)
    out["f32_standard_scales"] = _compare(
        eng, tokens, "f32, standard attention scales (information)")
    eng = Engine(cfg, params, dtype=torch.bfloat16, max_batch=1,
                 max_len=1024)
    r = _compare(eng, tokens, f"bf16 Engine, standard attention scales "
                              f"(bound {LOGIT_BOUND}*max_abs_logit)")
    r["bound"] = LOGIT_BOUND * r["max_abs_logit"]
    out["bf16"] = r
    if not (math.isfinite(r["max_abs_diff"])
            and r["max_abs_diff"] <= r["bound"]):
        raise SystemExit("check: kernel-path logits beyond the bound")
    return out


def mamba_teacher_force(model, params, tokens, n_prompt, plain):
    """Prefill `tokens[:n_prompt]` (every layer's scan through `ssd_scan`,
    or its plain version with `plain`), then one decode step per
    remaining token. Returns (every stage's logits in f32, the prefill's
    SSM state)."""
    import torch
    toks = torch.as_tensor(tokens, device=params["embed"].device)[None]
    lg, cache, _ = model.forward(params, toks[:, :n_prompt],
                                 return_cache=True, plain=plain)
    state = cache["ssm"].clone()
    out = [lg[:, 0].float()]
    for t in range(n_prompt, len(tokens)):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        out.append(lg.float())
    return torch.cat(out), state


def mamba_check(cfg, params):
    """Full-width mamba2-2.7b, teacher-forced over 512 prompt tokens and 8
    decode steps: logits and prefill SSM state through the kernel against
    the plain versions, in f32 (the serving weights) and bf16 (a cast of
    them), each held to `MAMBA_BOUNDS`."""
    import numpy as np
    import torch
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    tokens = np.random.default_rng(11).integers(1, cfg.vocab_size,
                                                512 + 8).tolist()
    out, plain_f32 = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        # f32: the same tensors
        p = model.cast(params, dtype, params["embed"].device)
        got, got_h = mamba_teacher_force(model, p, tokens, 512, plain=False)
        want, want_h = mamba_teacher_force(model, p, tokens, 512, plain=True)
        torch.cuda.synchronize()
        del p
        if plain_f32 is None:
            plain_f32 = (want, want_h)
        r = dict(max_abs_diff=float((got - want).abs().max()),
                 max_abs_logit=float(want.abs().max()),
                 state_max_abs_diff=float((got_h - want_h).abs().max()),
                 state_max_abs=float(want_h.abs().max()),
                 argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                    .float().mean()),
                 bound_fraction=MAMBA_BOUNDS[dn],
                 plain_vs_f32_plain=float((want - plain_f32[0]).abs().max()),
                 state_plain_vs_f32_plain=float(
                     (want_h - plain_f32[1]).abs().max()))
        r["bound"] = MAMBA_BOUNDS[dn] * r["max_abs_logit"]
        r["state_bound"] = MAMBA_BOUNDS[dn] * r["state_max_abs"]
        log(f"check {cfg.name} {dn}: teacher-forced (prefill 512 + 8 decode "
            f"steps), kernel vs plain versions: logits max_abs_diff="
            f"{r['max_abs_diff']:.4e} of max_abs_logit="
            f"{r['max_abs_logit']:.4e} (bound {r['bound']:.4e}); prefill "
            f"ssm state max_abs_diff={r['state_max_abs_diff']:.4e} of "
            f"{r['state_max_abs']:.4e} (bound {r['state_bound']:.4e}); "
            f"argmax_agree={r['argmax_agree']:.3f}; plain {dn} vs plain f32: "
            f"logits {r['plain_vs_f32_plain']:.4e}, state "
            f"{r['state_plain_vs_f32_plain']:.4e}")
        out[dn] = r
        if not (math.isfinite(r["max_abs_diff"])
                and math.isfinite(r["state_max_abs_diff"])
                and r["max_abs_diff"] <= r["bound"]
                and r["state_max_abs_diff"] <= r["state_bound"]):
            raise SystemExit(f"check: {cfg.name} {dn} kernel path beyond "
                             f"the bound")
    return out


def device_profile(fn, label, annotation=None):
    """Run `fn` once under `torch.profiler` (after one untimed run) and
    print its host wall time, the device's busy time (the sum of its
    kernels' durations) and idle share, and the kernels that took most
    time; with `annotation`, the name of `record_function` ranges inside
    `fn`, also their host time and the device time of the kernels they
    launched. For information; nothing is held to it."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    count = collections.Counter()
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if annotation and e.name == annotation:
            # the range's span on the device timeline, not a kernel
            spans.append((e.time_range.start, e.time_range.end))
            continue
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        count[e.name] += 1
        kernels.append((e.time_range.start, e.time_range.elapsed_us()))
    n = sum(count.values())
    busy = sum(by_name.values())
    top = [(k[:60], round(v, 3)) for k, v in by_name.most_common(5)]
    # the port's own kernels, by the name of the op they serve (the
    # longest op name a kernel's name holds: flash_prefill_bwd_* kernels
    # are not flash_prefill's)
    ported = collections.Counter()
    for k, v in by_name.items():
        ops = [op for op in SOURCES if op in k]
        if ops:
            ported[max(ops, key=len)] += v
    ported = {op: round(v, 3) for op, v in ported.items()}
    out = dict(wall_ms=wall_ms, device_busy_ms=busy, kernels=n,
               idle_share=1 - busy / wall_ms if wall_ms else None, top=top,
               ported_ms=ported, launches_by_kernel=dict(count))
    extra = ""
    if annotation:
        ranges = [e for e in prof.events() if e.name == annotation
                  and e.device_type != DeviceType.CUDA]
        host = sum(e.cpu_time_total for e in ranges) / 1e3
        # the kernels that start inside one of the ranges' device spans
        dev = sum(us for t, us in kernels
                  if any(a <= t < b for a, b in spans)) / 1e3
        out[annotation] = dict(ranges=len(ranges), host_ms=host,
                               device_ms=dev,
                               host_share=host / wall_ms if wall_ms else None,
                               device_share=dev / busy if busy else None)
        extra = (f" {annotation}: ranges={len(ranges)} host={host:.3f}ms "
                 f"device={dev:.3f}ms (device share "
                 f"{out[annotation]['device_share'] or 0:.3f})")
    log(f"profile {label}: wall={wall_ms:.3f}ms device_busy={busy:.3f}ms "
        f"idle_share={out['idle_share']:.3f} kernels={n} top={top} "
        f"ported_ms={ported}{extra}")
    return out


def mamba_profile(cfg, params):
    """Where a mamba2-2.7b step's time goes: one 1536-token prefill (6
    chunks of 256) and one decode step at batch 8, f32."""
    import torch
    from repro_torch.models.api import build_model
    model = build_model(cfg)
    dev = params["embed"].device
    toks = torch.randint(1, cfg.vocab_size, (1, 1536), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    specs = model.cache_specs(8, 2048, torch.float32)
    cache = {k: (torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 if not isinstance(v, dict) else
                 {c: torch.zeros(w.shape, dtype=w.dtype, device=dev)
                  for c, w in v.items()})
             for k, v in specs.items()}
    step_toks = toks[0, :8].contiguous()
    return {
        "prefill_1536": device_profile(
            lambda: model.forward(params, toks, return_cache=True),
            f"{cfg.name} prefill 1536 tokens"),
        "decode_b8": device_profile(
            lambda: model.decode_step(params, cache, step_toks),
            f"{cfg.name} decode step, batch 8"),
    }


def yi_profile(cfg, params):
    """Where a yi-6b step's time goes, f32: one decode step at batch 8 over
    the serve trace's prompt lengths (the fused paged_insert +
    paged_decode in every layer; fails unless the trace shows one split
    kernel a layer and no standalone `paged_insert_kernel`), one 512-token
    prefill from scratch (flash_prefill in every
    layer, the serve phase's first chunk) and one 512-token chunk over a
    1024-token prefix (prefix_prefill in every layer), on an Engine's
    paged cache."""
    import torch
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, max_batch=8, max_len=2048)   # shares params
    cache = eng._empty_cache()
    ps = eng._kv.page_size
    pps = cache["block_tables"].shape[1]
    lens = [1500, 640, 200, 1100, 900, 300, 1280, 520]
    for b, n in enumerate(lens):
        cache["block_tables"][b] = torch.arange(1 + b * pps,
                                                1 + (b + 1) * pps)
        cache["pos"][b] = n
    dev = eng.device
    gen = torch.Generator(device=dev).manual_seed(5)
    step = torch.randint(1, cfg.vocab_size, (8,), device=dev, generator=gen)
    chunk = torch.randint(1, cfg.vocab_size, (1, 512), device=dev,
                          generator=gen)
    pools = {k: v for k, v in cache.items() if k.startswith("seg")}
    decode = device_profile(
        lambda: eng.model.decode_step_paged(eng.params, cache, step),
        f"{cfg.name} decode step, batch 8, contexts 200..1500")
    split = sum(c for k, c in decode["launches_by_kernel"].items()
                if "paged_decode_split_kernel" in k)
    alone = sum(c for k, c in decode["launches_by_kernel"].items()
                if "paged_insert_kernel" in k)
    log(f"profile {cfg.name} decode step: kernels={decode['kernels']} "
        f"paged_decode_split_kernel={split} paged_insert_kernel={alone} "
        f"(the insert runs inside the split kernel: expected {cfg.num_layers}"
        f" and 0)")
    if split != cfg.num_layers or alone:
        raise SystemExit("profile: the decode step did not run one fused "
                         "insert + decode kernel a layer")
    out = {
        "decode_b8": decode,
        "prefill_512": device_profile(
            lambda: eng.model.forward(eng.params, chunk, return_cache=True),
            f"{cfg.name} 512-token prefill from scratch"),
        "chunk_512_over_1024": device_profile(
            lambda: eng.model.forward(
                eng.params, chunk, return_cache=True, prefix_pages=pools,
                prefix_table=cache["block_tables"][:1, :1024 // ps],
                prefix_len=1024, pos_offset=1024),
            f"{cfg.name} 512-token chunk over a 1024-token prefix"),
    }
    del eng, cache, pools
    return out


def gemma_serve_counts(cfg, serve):
    """The gemma3-1b serve phase's launches and bytes against what its path
    must give: flash_prefill once a layer and request; paged_decode once a
    layer and decode step; paged_insert as often, the global layers' inside
    the fused kernel and the ring layers' standalone; the migrated bytes
    the sum of `kv_bytes(cfg, prompt_len)` (each layer capped at the
    window, as the JAX cluster counts them). The real blob size is printed
    beside them."""
    from repro_torch.core.kv_transfer import kv_bytes
    from repro_torch.models.transformer import layer_plan
    L = cfg.num_layers
    ring = sum(sg.n for sg in layer_plan(cfg) if sg.kind == "local")
    n, steps, c = serve["submitted"], serve["decode_steps"], \
        serve["launches"]
    fused = c["paged_insert_decode"]
    want = {"flash_prefill": L * n, "paged_decode": L * steps,
            "paged_insert": L * steps, "fused": (L - ring) * steps,
            "standalone": ring * steps}
    got = {"flash_prefill": c["flash_prefill"],
           "paged_decode": c["paged_decode"],
           "paged_insert": c["paged_insert"], "fused": fused,
           "standalone": c["paged_insert"] - fused}
    want_bytes = sum(kv_bytes(cfg, r.in_len)
                     for r in serve_trace(cfg.vocab_size))
    log(f"serve {cfg.name}: launches {got} over {n} prefills and {steps} "
        f"decode steps (expected {want}); kv bytes migrated "
        f"{serve['kv_bytes_migrated']} (expected {want_bytes}: kv_bytes "
        f"caps each layer at the {cfg.sliding_window}-token window); the "
        f"prefill blobs hold {serve['blob_bytes']} bytes (Engine."
        f"kv_blob_bytes: f32 slabs, global layers at max_len)")
    serve["expected_launches"] = want
    serve["expected_kv_bytes"] = want_bytes
    if got != want or serve["kv_bytes_migrated"] != want_bytes:
        raise SystemExit(f"serve: {cfg.name} launches or bytes are off")


def slab_teacher_force(model, params, tokens, n_prompt, plain):
    """On the dense slab (batch 1, a 1024-slot cache): prefill
    `tokens[:n_prompt]` from scratch (flash_prefill in every layer; the
    local layers' caches ring-packed), then one decode step per remaining
    token (the standalone insert + paged_decode on ring layers, the fused
    insert + decode on global ones). `plain=True` runs the plain versions
    instead of the kernels. Returns every stage's logits in f32."""
    import torch
    toks = torch.as_tensor(tokens, device=params["embed"].device)[None]
    lg, cache, _ = model.forward(params, toks[:, :n_prompt],
                                 return_cache=True, max_len=1024,
                                 plain=plain)
    out = [lg[:, 0].float()]
    for t in range(n_prompt, len(tokens)):
        lg, cache = model.decode_step(params, cache, toks[:, t], plain=plain)
        out.append(lg.float())
    return torch.cat(out)


def gemma_check(cfg, params):
    """Full-width gemma3-1b on the slab, teacher-forced over a 700-token
    prompt (past the 512-token window, so the ring layers wrap) and 8
    decode steps: the kernel-path logits against the plain path's, at the
    serving weights (the JAX init, not rescaled). bf16 (a cast of the
    weights) is held to `GEMMA_LOGIT_BOUND` of the plain path's largest
    |logit|; f32 is printed for information."""
    import numpy as np
    import torch
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    tokens = np.random.default_rng(13).integers(1, cfg.vocab_size,
                                                700 + 8).tolist()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        p = model.cast(params, dtype, params["embed"].device)
        got = slab_teacher_force(model, p, tokens, 700, plain=False)
        want = slab_teacher_force(model, p, tokens, 700, plain=True)
        torch.cuda.synchronize()
        del p
        r = dict(max_abs_diff=float((got - want).abs().max()),
                 max_abs_logit=float(want.abs().max()),
                 argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                    .float().mean()),
                 held=dtype == torch.bfloat16)
        r["bound"] = GEMMA_LOGIT_BOUND * r["max_abs_logit"]
        log(f"check {cfg.name} {dn}, serving weights"
            f"{f' (bound {GEMMA_LOGIT_BOUND}*max_abs_logit)' if r['held'] else ' (information)'}"
            f": teacher-forced logits (slab prefill 700 + 8 decode steps), "
            f"kernels vs plain versions: max_abs_diff={r['max_abs_diff']:.4e}"
            f" max_abs_logit={r['max_abs_logit']:.4e} "
            f"argmax_agree={r['argmax_agree']:.3f}")
        out[dn] = r
        if r["held"] and not (math.isfinite(r["max_abs_diff"])
                              and r["max_abs_diff"] <= r["bound"]):
            raise SystemExit(f"check: {cfg.name} kernel-path logits beyond "
                             f"the bound")
    return out


def gemma_profile(cfg, params):
    """Where a gemma3-1b slab decode step's time goes, f32: one step at
    batch 8 at the serve trace's prompt lengths (22 ring layers: a
    standalone insert and paged_decode each; 4 global layers: the fused
    insert + decode)."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import layer_plan
    model = build_model(cfg)
    dev = params["embed"].device
    specs = model.cache_specs(8, 2048, torch.float32)
    cache = {k: (torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 if not isinstance(v, dict) else
                 {c: torch.randn(w.shape, dtype=w.dtype, device=dev)
                  for c, w in v.items()})
             for k, v in specs.items()}
    cache["pos"].copy_(torch.tensor([1500, 640, 200, 1100, 900, 300, 1280,
                                     520], dtype=torch.int32))
    step = torch.randint(1, cfg.vocab_size, (8,), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(9))
    prof = device_profile(lambda: model.decode_step(params, cache, step),
                          f"{cfg.name} slab decode step, batch 8, "
                          f"positions 200..1500")
    by = prof["launches_by_kernel"]
    split = sum(c for k, c in by.items() if "paged_decode_split_kernel" in k)
    alone = sum(c for k, c in by.items() if "paged_insert_kernel" in k)
    ring = sum(sg.n for sg in layer_plan(cfg) if sg.kind == "local")
    log(f"profile {cfg.name} decode step: kernels={prof['kernels']} "
        f"paged_decode_split_kernel={split} paged_insert_kernel={alone} "
        f"(expected {cfg.num_layers} and {ring}: one split kernel a layer, "
        f"a standalone insert on each ring layer)")
    if split != cfg.num_layers or alone != ring:
        raise SystemExit("profile: the slab decode step did not run the "
                         "kernels of its route")
    del cache
    return prof


# ---------------------------------------------------------------------------
# phase 9: the planning stack and the launcher (yi-6b at full width)
# ---------------------------------------------------------------------------

# from-scratch prefill lengths. On an H100 a bf16 yi-6b prefill of up to
# ~2000 tokens is host-bound (37-48 ms of launches whatever L), where the
# latency model's additive compute form cannot hold, so the fit's first
# stage takes device-bound lengths (each its own bucket: no padding) and
# the host-bound ones are predicted, not fitted
FIT_PREFILL = (4096, 5120, 6144, 8192)
HOST_PREFILL = (256, 512, 1024, 1536)
# decode steps with every slot of an engine of `FIT_DECODE_BATCH` slots
# live (the step reads every slot's cache, live or not), at each of
# `FIT_DECODE` tokens a sequence: the KV bytes spread from 0.5 to 34 GB
# beside 12.1 GB of weights
FIT_DECODE_BATCH = (8, 32, 64)
FIT_DECODE = (1024, 2048, 4096, 8192)
FIT_REPS = 5                            # median of 5 after a warm-up
# the launcher phase's requests: the CLI's `--live` trace (rate 20, 12
# requests) at full width, prompts clipped to 1536, outputs to 32
LIVE = dict(max_batch=8, max_len=2048, lm_tokens=512, chunk_tokens=512,
            max_in=1536, max_out=32, n=12, rate=20.0)
# phase 9c's spaced trace: each request arrives this many virtual seconds
# after the one before, long after it finished (checked), so no migration
# reaches a decode instance mid-step
SPACED_GAP_S = 5.0


def median_step(fn, reps=FIT_REPS):
    fn()                                            # warm-up
    gc.collect()
    return statistics.median(fn() for _ in range(reps))


def fit_phase(cfg):
    """9a. Fit the H100 `Chip`: time the bf16 yi-6b Engine's own step
    times (the ones a cluster charges), fit `core/h100.py::fit_chip` and
    print every point against the fresh fit and the committed Chip."""
    import torch
    from repro_torch.core.h100 import H100, fit_chip
    from repro_torch.core.latency_model import LatencyModel, Parallelism
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, Sequence

    params = build_model(cfg).cast(init_params(cfg), torch.bfloat16, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    eng = Engine(cfg, params, max_batch=FIT_DECODE_BATCH[0], max_len=8256,
                 dtype=torch.bfloat16, device="cuda")
    rng = __import__("numpy").random.default_rng(1)

    def prompt(L):
        return rng.integers(1, cfg.vocab_size, L).tolist()

    prefill, host = [], []
    for L in HOST_PREFILL + FIT_PREFILL:
        toks = prompt(L)
        (prefill if L in FIT_PREFILL else host).append((L, median_step(
            lambda: eng.prefill_request(Sequence(0, list(toks), 1))[2])))
    decode = []
    for b in FIT_DECODE_BATCH:
        if eng is None:
            eng = Engine(cfg, params, max_batch=b, max_len=8256,
                         dtype=torch.bfloat16, device="cuda")
        for c in FIT_DECODE:
            batch = []
            for i in range(b):
                seq = Sequence(100 + i, prompt(c), 16)
                first, blob, _ = eng.prefill_request(seq)
                seq.append_token(first)
                eng.insert_kv(seq, blob)
                batch.append(seq)
            eng.decode_step(batch)                  # warm-up
            gc.collect()
            pts = []
            for _ in range(FIT_REPS):
                ctx = sum(len(s.tokens) - 1 for s in batch)
                pts.append((eng.decode_step(batch), ctx))
            dt, ctx = sorted(pts)[FIT_REPS // 2]
            decode.append((b, ctx, dt))
            for seq in batch:
                eng.release(seq)
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    fitted = fit_chip(cfg, prefill, decode, base=H100)
    lms = {"fit": LatencyModel(cfg, fitted), "committed": LatencyModel(cfg, H100)}
    par = Parallelism()
    points = []
    for L, t in host + prefill:
        pred = {k: lm.prefill_time([L], par) for k, lm in lms.items()}
        points.append(dict(step="prefill", L=L, s=t, fitted=(L, t) in prefill,
                           **{f"{k}_s": v for k, v in pred.items()}))
    for b, ctx, t in decode:
        pred = {k: lm.decode_time(b, ctx, par) for k, lm in lms.items()}
        points.append(dict(step="decode", B=b, ctx=ctx, s=t, **{
            f"{k}_s": v for k, v in pred.items()}))
    for p in points:
        what = (f"prefill L={p['L']}" + ("" if p["fitted"] else
                                         " (host-bound, not fitted)")
                if p["step"] == "prefill" else
                f"decode B={p['B']} ctx={p['ctx']}")
        log(f"fit {what}: measured {p['s'] * 1e3:.3f} ms, fit "
            f"{p['fit_s'] * 1e3:.3f} ms ({p['fit_s'] / p['s'] - 1:+.1%}), "
            f"committed {p['committed_s'] * 1e3:.3f} ms "
            f"({p['committed_s'] / p['s'] - 1:+.1%})")
    fields = ("mm_eff", "attn_eff", "hbm_eff", "step_overhead")
    out = {f: {"fit": getattr(fitted, f), "committed": getattr(H100, f)}
           for f in fields}
    log("fit H100 Chip: " + ", ".join(
        f"{f} {v['fit']:.6g} (committed {v['committed']:.6g})"
        for f, v in out.items()))
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"fit: total_memory {total} (committed hbm_bytes "
        f"{H100.hbm_bytes:.0f})")
    bad = [f for f in fields if not math.isfinite(getattr(fitted, f))]
    bad += [f for f in fields[:3] if not 0.0 < getattr(fitted, f) <= 1.0]
    if bad:
        raise SystemExit(f"fit: {sorted(set(bad))} not finite or an "
                         f"efficiency outside (0, 1]: the form or the "
                         f"flop/byte count is wrong")
    return dict(points=points, chip=out, total_memory=total)


def _served(res, reqs, cfg, what):
    """Fail unless every request came back finished and well formed."""
    finished = [r for r in res.values() if r.finish >= 0
                and r.finish_reason != "failed"]
    for req in reqs:
        r = res[req.rid]
        if len(r.tokens) != req.in_len + req.out_len or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise SystemExit(f"{what}: request {req.rid} came back "
                             f"malformed")
    if len(res) != len(reqs) or len(finished) != len(reqs):
        raise SystemExit(f"{what}: {len(finished)}/{len(reqs)} finished")
    return len(finished)


def plan_serve_phase(cfg, params):
    """9b. Plan yi-6b / sharegpt at rate 8 with both searches on the H100
    Chip (one node of two cards), then serve the launcher's trace at full
    width through `launch/serve.py::serve_live` with the low-affinity
    plan. The four attention kernels' launches are read from this run."""
    import torch
    from repro_torch.core.h100 import H100
    from repro_torch.core.kv_transfer import kv_bytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import live_trace, plan, serve_live

    plans = {}
    for algo in ("low", "high"):
        t0 = time.perf_counter()
        _, spec, placement = plan(cfg, "sharegpt", 8.0, algo, n_node=1,
                                  m_per_node=2, n_requests=200, chip=H100)
        secs = time.perf_counter() - t0
        plans[algo] = dict(summary=placement.summary(), seconds=secs)
        log(f"plan {algo}: {secs:.2f}s {json.dumps(placement.summary())}")
        if algo == "low":
            low = placement
    log(f"plan: slo_ttft {spec.slo_ttft:.6f}s slo_tpot {spec.slo_tpot:.6f}s")
    reqs = live_trace(spec, LIVE["n"], LIVE["rate"], LIVE["max_in"],
                      LIVE["max_out"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res, cluster = serve_live(cfg, low, spec, params=params, device="cuda",
                              **LIVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ran, graphs = graph_launches(counts, cluster.decode)
    want_bytes = sum(kv_bytes(cfg, r.in_len) for r in reqs)
    out = dict(plans=plans, slo_ttft_s=spec.slo_ttft,
               slo_tpot_s=spec.slo_tpot, n_prefill=len(cluster.prefill),
               n_decode=len(cluster.decode), submitted=len(reqs),
               served=len(res), finished=_served(res, reqs, cfg, "launch"),
               ttft_median_s=statistics.median(r.ttft for r in res.values()),
               tpot_median_s=statistics.median(r.tpot for r in res.values()),
               kv_bytes_migrated=cluster.tx.total_bytes,
               kv_bytes_expected=want_bytes, launches=ran,
               wrapper_launches=counts, wall_s=wall,
               memory_allocated=torch.cuda.memory_allocated(),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"launch {cfg.name} f32 ({out['n_prefill']} prefill + "
        f"{out['n_decode']} decode engines, one copy of the weights): "
        f"served={out['served']}/{len(reqs)} finished={out['finished']} "
        f"ttft_median={out['ttft_median_s']:.4f}s "
        f"tpot_median={out['tpot_median_s']:.4f}s (virtual clock) "
        f"kv_bytes_migrated={cluster.tx.total_bytes} (expected {want_bytes}"
        f") wall={wall:.2f}s max_memory_allocated="
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB")
    log("launch kernels " + json.dumps(counts))
    log(f"launch {graphs}; launches run {json.dumps(ran)}")
    if cluster.tx.total_bytes != want_bytes:
        raise SystemExit("launch: migrated bytes are not the sum of kv_bytes")
    zero = [k for k in PATHS["launch.serve"] if counts[k] <= 0]
    if zero:
        raise SystemExit(f"launch: kernels never launched: {zero}")
    del cluster, res
    return out, spec, low


def _times(backend):
    return {rid: (r.ttft, r.tpot) for rid, r in backend.results.items()}


def charged_phase(cfg, params, spec, placement):
    """9c. The launcher's cluster under `EngineCharge(LatencyModel(cfg,
    H100))` against the port's `SimDisaggBackend`, same lm_tokens,
    chunking, transfer bandwidth and decode batch. On the launcher's rate
    20 trace the count of equal requests is printed: the JAX package's own
    live cluster and simulator differ there (a live decode instance pulls
    a migrant's KV at its next poll, the simulator at dispatch;
    `tests/test_torch_plan.py`). The same requests spaced `SPACED_GAP_S`
    apart must give each request's TTFT and TPOT equal to the float."""
    import torch
    from repro_torch.core.h100 import H100
    from repro_torch.core.latency_model import (EngineCharge, LatencyModel,
                                                Parallelism)
    from repro_torch.core.simulator import InstanceConfig, SimDisaggBackend
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import live_trace, serve_live
    from repro_torch.serving.cluster import DisaggCluster

    lm = LatencyModel(cfg, H100)
    par = Parallelism()
    kw = {k: LIVE[k] for k in ("max_batch", "max_len", "lm_tokens",
                               "chunk_tokens")}
    reqs = live_trace(spec, LIVE["n"], LIVE["rate"], LIVE["max_in"],
                      LIVE["max_out"])
    spaced = [dataclasses.replace(r, arrive=SPACED_GAP_S * (i + 1))
              for i, r in enumerate(reqs)]

    out = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    res, dense = serve_live(cfg, placement, spec, params=params,
                            device="cuda", charge=EngineCharge(lm, par),
                            **LIVE)
    _served(res, reqs, cfg, "charged")
    n_p, n_d = len(dense.prefill), len(dense.decode)
    bw = dense.tx.bandwidth

    def sim(trace):
        b = SimDisaggBackend(lm, InstanceConfig(par, n_p),
                             InstanceConfig(par, n_d), transfer_bw=bw,
                             lm_tokens=kw["lm_tokens"],
                             chunk_tokens=kw["chunk_tokens"],
                             max_decode_batch=kw["max_batch"])
        for r in trace:
            b.submit(dataclasses.replace(r))
        b.drain()
        return b

    want, got = _times(sim(reqs)), _times(dense)
    out["rate20_equal"] = sum(got[i] == want[i] for i in want)
    log(f"charged {cfg.name} rate-20 trace: {out['rate20_equal']}/"
        f"{len(want)} requests with TTFT and TPOT equal to the sim's "
        f"(information: the reference's live/sim difference)")
    del dense, res
    live = DisaggCluster(cfg, params, n_prefill=n_p, n_decode=n_d,
                         charge=EngineCharge(lm, par), device="cuda", **kw)
    for r in spaced:
        live.submit(dataclasses.replace(r))
    live.drain()
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    s = sim(spaced)
    got, want = _times(live), _times(s)
    _served(live.results, spaced, cfg, "charged")
    overlap = [r.rid for r in spaced[1:]
               if live.states[r.rid - 1].request.finish >= r.arrive]
    equal = sum(got[i] == want[i] for i in want)
    out.update(spaced_equal=equal, n=len(want),
               ttft_s={i: got[i][0] for i in sorted(got)},
               tpot_s={i: got[i][1] for i in sorted(got)},
               decisions_equal=live.dispatcher.decisions == s.disp.decisions)
    log(f"charged {cfg.name} spaced trace ({SPACED_GAP_S}s apart): "
        f"{equal}/{len(want)} requests with TTFT and TPOT equal to the "
        f"float to the sim's; dispatch decisions equal "
        f"{out['decisions_equal']}; ttft_median "
        f"{statistics.median(v[0] for v in got.values()):.6f}s tpot_median "
        f"{statistics.median(v[1] for v in got.values()):.6f}s")
    log("charged kernels " + json.dumps(out["launches"]))
    if overlap:
        raise SystemExit(f"charged: requests {overlap} arrived before the "
                         f"one ahead finished")
    if equal != len(want) or not out["decisions_equal"]:
        bad = sorted(i for i in want if got[i] != want[i])
        raise SystemExit(f"charged: requests {bad} differ from the sim: "
                         f"{[(got[i], want[i]) for i in bad[:3]]}")
    del live
    return out


def router_phase(cfg, params):
    """9d. `FleetRouter(policy="prefix_affinity")` over two full-width
    yi-6b `DisaggCluster`s (1 + 1 engines each, prefix cache, one copy of
    the weights, the H100 charge) against the same router over two
    `SimDisaggBackend`s, on `serve_trace` (8 requests, five sharing a
    384-token system prompt): the `decisions` lists must be equal."""
    import torch
    from repro_torch.core.h100 import H100
    from repro_torch.core.latency_model import (EngineCharge, LatencyModel,
                                                Parallelism)
    from repro_torch.core.simulator import InstanceConfig, SimDisaggBackend
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.cluster import DisaggCluster
    from repro_torch.serving.router import FleetRouter

    lm = LatencyModel(cfg, H100)
    par = Parallelism()
    kw = dict(max_batch=8, lm_tokens=512, chunk_tokens=512,
              prefix_cache=True)
    live = [DisaggCluster(cfg, params, n_prefill=1, n_decode=1, max_len=2048,
                          charge=EngineCharge(lm, par), seed=i,
                          device="cuda", **kw) for i in range(2)]
    log(f"router: 4 engines built, memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sim_kw = dict(kw, max_decode_batch=kw["max_batch"])
    del sim_kw["max_batch"]
    sims = [SimDisaggBackend(lm, InstanceConfig(par, 1),
                             InstanceConfig(par, 1),
                             transfer_bw=live[0].tx.bandwidth, **sim_kw)
            for _ in range(2)]
    reqs = serve_trace(cfg.vocab_size)
    routers, results = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for fleet in (live, sims):
        fr = FleetRouter(fleet, policy="prefix_affinity")
        for r in reqs:
            fr.submit(dataclasses.replace(r))
        results.append(fr.drain())
        routers.append(fr)
        if fleet is live:
            torch.cuda.synchronize()
            counts = launch_counts()
            ran, graphs = graph_launches(
                counts, [e for c in live for e in c.decode])
    res, sres = results
    hits = [c.prefill[0].prefix_hit_tokens for c in live]
    same_ttft = sum(res[i].ttft == sres[i].ttft for i in sres)
    out = dict(submitted=len(reqs), served=len(res),
               finished=_served(res, reqs, cfg, "router"),
               decisions=routers[0].decisions,
               decisions_equal=routers[0].decisions == routers[1].decisions,
               prefix_hit_tokens=hits, ttft_equal_to_sim=same_ttft,
               ttft_median_s=statistics.median(r.ttft for r in res.values()),
               tpot_median_s=statistics.median(r.tpot for r in res.values()),
               launches=ran, wrapper_launches=counts)
    log(f"router {cfg.name} x2 replicas: served={len(res)}/{len(reqs)} "
        f"decisions {routers[0].decisions}; equal to the sim fleet's "
        f"{out['decisions_equal']}; prefix-hit tokens per replica {hits}; "
        f"{same_ttft}/{len(sres)} TTFTs equal to the sim's; ttft_median "
        f"{out['ttft_median_s']:.6f}s")
    log("router kernels " + json.dumps(counts))
    log(f"router {graphs}; launches run {json.dumps(ran)}")
    if not out["decisions_equal"]:
        raise SystemExit(f"router: decisions differ from the sim fleet's: "
                         f"{routers[1].decisions}")
    zero = [k for k in PATHS["router"] if counts[k] <= 0]
    if zero:
        raise SystemExit(f"router: kernels never launched: {zero}")
    del live, routers
    return out


# ---------------------------------------------------------------------------
# phases 10-13: the remaining model families (MoE, hybrid, encdec, VLM)
# ---------------------------------------------------------------------------

def family_kernel_phase(dtypes):
    """The attention kernels at the new families' shapes:
    seamless-m4t-large-v2's non-causal `flash_prefill` (16/16 heads of hd
    64) over its encoder's 1024 frames and its cross-attention's 64 target
    tokens over them; moonshot-v1-16b-a3b's group of 1 (16/16 heads of hd
    128) in the three attention kernels at the serve phase's shapes.
    (`ssd_scan` at zamba2-7b's shape runs in `ssd_kernel_phase`.)"""
    import torch
    E = Rows(16, 16, 64, 4567)
    M = Rows(16, 16, 128, 5678)
    results = {}
    for dtype in dtypes:
        dn = dtype_name(dtype)
        rows = {
            "flash_prefill_seamless_enc_t1024": E.flash_nc(dtype, 1024,
                                                           1024),
            "flash_prefill_seamless_cross_s64": E.flash_nc(dtype, 64, 1024),
            "flash_prefill_moonshot_s512": M.flash(dtype, 512),
            "prefix_prefill_moonshot_p512": M.prefix(dtype, 512, 512),
            "paged_decode_moonshot_b8": M.decode(dtype, 8, 128, SERVE_LENS,
                                                 trash=True),
            "paged_insert_decode_moonshot_b8": M.insert_decode(
                dtype, 8, 128, SERVE_LENS),
            # a decode step's cross-attention: paged_decode over the
            # 1024-frame cross-KV slab's page view, every slot live
            "slab_decode_seamless_cross_b1": E.slab_decode(
                dtype, 1, 1024, [1023], ring=True),
        }
        finish_rows(rows, dn)
        results[dn] = rows
        torch.cuda.empty_cache()
    return results


# moonshot-v1-16b-a3b teacher-forced logits, kernel path against plain
# path. Top-k routing is discontinuous: where the two paths' hidden
# states differ by bf16 rounding, a token whose 6th and 7th gates nearly
# tie takes another expert on one path, its hidden state then moves by
# more than rounding, and over 47 MoE layers such flips compound. So the
# check has two parts. (1) Free run: the share of top-6 choices (every
# MoE layer, every token) on which the two paths agree must reach
# MOE_ROUTING_FLOOR. Chance agreement is 6/64 ~ 0.09, which is what a
# wrong kernel (scrambled hidden states) gives; at full depth in bf16 a
# correct one gave 0.942 on the H100 (first run of this phase: every
# row then had a flip, and the first bound, 0.95 with rows held only
# where no flip occurred, failed). (2) Replayed routing: the kernel path
# again, each MoE layer taking the plain path's expert choices (weighted
# by its own gates), so that only the attention kernels' rounding
# differs; every row within MOE_LOGIT_BOUND of the plain path's largest
# |logit| (bf16 as LOGIT_BOUND for yi-6b).
MOE_LOGIT_BOUND = {"bfloat16": 0.1, "float32": 1e-3}
MOE_ROUTING_FLOOR = {"bfloat16": 0.8, "float32": 0.99}
# zamba2-7b, kernel path against plain path, as a fraction of the plain
# path's largest |value| (logits; prefill SSM state), in the style of
# MAMBA_BOUNDS. Its 13 shared-attention calls run at standard attention
# scales (C1). f32: the scans' summation order over 81 layers (~2e-5 of
# scale for mamba2-2.7b's 64) plus the attention kernels' f32 order;
# bf16: the SSM's bf16 drift, as for mamba2-2.7b.
HYBRID_BOUNDS = {"float32": 1e-3, "bfloat16": 0.25}
# seamless-m4t-large-v2 and internvl2-76b at the facade, kernel path
# against plain path, as a fraction of the plain path's largest |logit|,
# at standard attention scales: bf16 as LOGIT_BOUND; f32 the kernels'
# f32 summation order through 48 (4) layers.
FACADE_BOUNDS = {"float32": 1e-3, "bfloat16": 0.1}


class RoutingLog:
    """While active, records each MoE layer call's top-k expert choices
    (computed from the same router inputs as `models/moe._routed_core`):
    a list of (T, k) index tensors in call order. With `replay` (such a
    list), call i takes the choices `replay[i]` instead of its own."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.calls, self._orig = [], moe._routed_core

        def rec(xf, router, wi, wo, cfg, capacity_factor=0.0):
            if self.replay is not None:
                topi = self.replay[len(self.calls)]
            else:
                gates = torch.softmax(xf.float() @ router.float(), dim=-1)
                topi = torch.topk(gates, cfg.moe.num_experts_per_tok,
                                  dim=-1).indices
            self.calls.append(topi)
            return self._orig(xf, router, wi, wo, cfg, capacity_factor,
                              topi=topi)
        moe._routed_core = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._routed_core = self._orig


def routing_agreement(got, want, E, n_rows):
    """(share of top-k choices the two call lists agree on, per row: did
    the row's own token (the last of each call) take the same experts in
    every layer). The calls split into `n_rows` stages of equal count."""
    import torch
    F = torch.nn.functional
    agree, total = 0.0, 0
    per_stage = len(got) // n_rows
    clean = [True] * n_rows
    for i, (a, b) in enumerate(zip(got, want)):
        oa, ob = F.one_hot(a, E).sum(1), F.one_hot(b, E).sum(1)
        tok = (oa * ob).sum(-1).float() / a.shape[1]          # (T,)
        agree += float(tok.sum())
        total += tok.numel()
        if float(tok[-1]) < 1.0:
            clean[i // per_stage] = False
    return agree / total, clean


def moe_logits_check(cfg, params, dtype, what):
    """Teacher-forced over one prompt (a 512-token prefill from scratch,
    a 256-token chunk over it, 8 decode steps) on an Engine's paged
    cache, through the kernels and through the plain versions, then
    through the kernels on the plain path's routing; held to
    `MOE_ROUTING_FLOOR` and `MOE_LOGIT_BOUND` (see there)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Engine

    dn = dtype_name(dtype)
    tokens = np.random.default_rng(17).integers(1, cfg.vocab_size,
                                                768 + 8).tolist()
    eng = Engine(cfg, params, dtype=dtype, max_batch=1, max_len=1024)
    with RoutingLog() as rk:
        got = teacher_force(eng, tokens, 512, 768, plain=False)
    with RoutingLog() as rp:
        want = teacher_force(eng, tokens, 512, 768, plain=True)
    with RoutingLog(replay=rp.calls):
        replayed = teacher_force(eng, tokens, 512, 768, plain=False)
    torch.cuda.synchronize()
    del eng
    n_rows = want.shape[0]
    share, clean = routing_agreement(rk.calls, rp.calls,
                                     cfg.moe.num_experts, n_rows)
    free_diff = (got - want).abs().amax(-1).tolist()
    row_diff = (replayed - want).abs().amax(-1).tolist()
    scale = float(want.abs().max())
    r = dict(max_abs_logit=scale, max_abs_diff=max(row_diff),
             row_max_abs_diff=row_diff, free_row_max_abs_diff=free_diff,
             rows_routing_equal=clean, routing_agreement=share,
             routing_floor=MOE_ROUTING_FLOOR[dn],
             bound=MOE_LOGIT_BOUND[dn] * scale,
             argmax_agree=float((replayed.argmax(-1) == want.argmax(-1))
                                .float().mean()),
             free_argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()))
    log(f"check {cfg.name} {dn} {what}: teacher-forced logits (prefill 512 "
        f"+ chunk 256 + 8 decode steps), kernels vs plain versions. Free "
        f"run: top-{cfg.moe.num_experts_per_tok} choices agree {share:.4f} "
        f"(floor {r['routing_floor']}; chance "
        f"{cfg.moe.num_experts_per_tok / cfg.moe.num_experts:.3f}), rows "
        f"with every layer's choices equal {sum(clean)}/{n_rows}, row "
        f"max_abs_diff {[round(d, 4) for d in free_diff]}, argmax_agree "
        f"{r['free_argmax_agree']:.3f}. On the plain path's routing: "
        f"max_abs_diff={r['max_abs_diff']:.4e} (bound {r['bound']:.4e} = "
        f"{MOE_LOGIT_BOUND[dn]}*max_abs_logit {scale:.4e}), rows "
        f"{[round(d, 4) for d in row_diff]}, argmax_agree "
        f"{r['argmax_agree']:.3f}")
    if not (share >= r["routing_floor"] and math.isfinite(r["max_abs_diff"])
            and r["max_abs_diff"] <= r["bound"]):
        raise SystemExit(f"check: {cfg.name} {dn} kernel path beyond the "
                         f"bound")
    return r


def fallback_view_diff(cfg):
    """For information: `prefix_prefill` in bf16 at the model's heads, a
    512-token chunk over a 512-token prefix read from 16-row pool pages
    (the fused path), against the same prefix gathered densely and read
    through its 32-row page view (the `fused_prefix=False` path): the
    largest difference, and whether the two are bit-equal."""
    import torch
    from repro_torch.kernels.prefix_prefill.kernel import prefix_prefill
    from repro_torch.models.attention import slab_pages
    gen = torch.Generator(device="cuda").manual_seed(6789)
    H, Hkv, hd, bf = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)
    q, k, v = randn(1, H, 512, hd), randn(1, Hkv, 512, hd), \
        randn(1, Hkv, 512, hd)
    kp, vp = randn(33, 16, Hkv, hd), randn(33, 16, Hkv, hd)
    table = (torch.randperm(32, generator=gen, device="cuda") + 1)[None] \
        .to(torch.int32)
    plens = torch.tensor([512], dtype=torch.int32, device="cuda")
    fused = prefix_prefill(q, k, v, kp, vp, table, plens)
    dk = kp[table[0].long()].reshape(1, 512, Hkv, hd)
    dv = vp[table[0].long()].reshape(1, 512, Hkv, hd)
    gk, gv, gt = slab_pages(dk, dv)
    dense = prefix_prefill(q, k, v, gk, gv, gt, plens)
    torch.cuda.synchronize()
    out = dict(page_rows=(16, gk.shape[1]),
               max_abs_diff=float((fused.float() - dense.float()).abs()
                                  .max()),
               bit_equal=bool(torch.equal(fused, dense)))
    log(f"prefix_prefill bf16 {cfg.name} heads, 512 over 512: 16-row pool "
        f"pages vs the gather's {gk.shape[1]}-row page view: max_abs_diff "
        f"{out['max_abs_diff']:.3e}, bit-equal {out['bit_equal']}")
    return out


def moe_serve_counts(cfg, serve, yi):
    """The moonshot serve phase's launches and bytes against what its path
    must give: per chunk of a prefill, one `flash_prefill` a layer when
    the chunk starts from scratch, else one `prefix_prefill` a layer (the
    fused path's dispatches: `prefix_prefill` = 48 x the fused
    dispatches); `paged_decode` one a layer and decode step; migrated
    bytes the sum of `kv_bytes` over what each decode-side insert took.
    Printed beside them: the yi-6b serve's counts in this run scaled to 48
    layers and 6x the KV bytes a token (the same trace and schedule would
    give those)."""
    from repro_torch.configs import get_config
    from repro_torch.core.kv_transfer import kv_bytes
    L = cfg.num_layers
    c, steps = serve["launches"], serve["decode_steps"]
    chunks, fused = serve["chunk_dispatches"], serve["fused_dispatches"]
    got = {"flash_prefill+prefix_prefill": c["flash_prefill"]
           + c["prefix_prefill"], "paged_decode": c["paged_decode"],
           "paged_insert_decode": c["paged_insert_decode"]}
    want = {"flash_prefill+prefix_prefill": L * chunks,
            "paged_decode": L * steps, "paged_insert_decode": L * steps}
    if fused:
        got["prefix_prefill"] = c["prefix_prefill"]
        want["prefix_prefill"] = L * fused
    yl = yi["launches"]
    ratio = kv_bytes(cfg, 1) // kv_bytes(get_config("yi-6b"), 1)
    pred = dict(flash_prefill=yl["flash_prefill"] * L // 32,
                prefix_prefill=yl["prefix_prefill"] * L // 32,
                kv_bytes=yi["kv_bytes_migrated"] * ratio)
    log(f"serve {cfg.name}: launches {got} over {chunks} chunks ({fused} "
        f"fused) and {steps} decode steps (expected {want}); "
        f"flash_prefill={c['flash_prefill']} prefix_prefill="
        f"{c['prefix_prefill']} (yi-6b's in this run x 48/32: "
        f"{pred['flash_prefill']} / {pred['prefix_prefill']}); kv bytes "
        f"migrated {serve['kv_bytes_migrated']} (expected "
        f"{serve['kv_bytes_of_inserts']}, the sum of kv_bytes over the "
        f"inserts; yi-6b's x {ratio}: {pred['kv_bytes']}); the prefill "
        f"blobs hold {serve['blob_bytes']} bytes")
    serve.update(expected_launches=want, predicted=pred)
    if got != want or serve["kv_bytes_migrated"] != \
            serve["kv_bytes_of_inserts"]:
        raise SystemExit(f"serve: {cfg.name} launches or bytes are off")


def moe_profile(cfg, params):
    """Where a moonshot-v1-16b-a3b bf16 decode step's time goes: one step
    at batch 8 at the serve trace's prompt lengths on an Engine's paged
    cache, with every MoE layer's `moe_apply` in a `record_function`
    range (its host time and its kernels' device time)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, dtype=torch.bfloat16, max_batch=8,
                 max_len=2048)
    cache = eng._empty_cache()
    pps = cache["block_tables"].shape[1]
    for b, n in enumerate([1500, 640, 200, 1100, 900, 300, 1280, 520]):
        cache["block_tables"][b] = torch.arange(1 + b * pps,
                                                1 + (b + 1) * pps)
        cache["pos"][b] = n
    step = torch.randint(1, cfg.vocab_size, (8,), device=eng.device,
                         generator=torch.Generator(device=eng.device)
                         .manual_seed(5))
    orig = transformer.moe_apply

    def annotated(*a, **kw):
        with torch.profiler.record_function("moe_apply"):
            return orig(*a, **kw)
    transformer.moe_apply = annotated
    try:
        out = device_profile(
            lambda: eng.model.decode_step_paged(eng.params, cache, step),
            f"{cfg.name} bf16 decode step, batch 8, contexts 200..1500",
            annotation="moe_apply")
    finally:
        transformer.moe_apply = orig
    del eng, cache
    return out


def moonshot_phase(cfg, yi_serve):
    """10-11. moonshot-v1-16b-a3b at full width in bf16 (48 layers, 64
    experts top-6 plus 2 shared, the first layer dense), its weights drawn
    a layer at a time in bf16: the serve trace with the prefix cache and
    512-token chunks, fused (`moe_serve_counts`), then with
    `fused_prefix=False` (the dense-gather fallback; its tokens against
    the fused run's); (a) smoke tokens, card against the CPU, for
    moonshot-smoke (paged, prefix, chunks) and mixtral-smoke (MoE on the
    slab, windowed); (b) teacher-forced logits at standard attention
    scales, bf16 at full depth, then f32 with the depth cut to 4 layers
    (`moe_logits_check`); (c) a profile of one bf16 decode step."""
    import torch
    out = {}
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.bfloat16)
    kw = dict(prefix_cache=True, chunk_tokens=512, dtype=torch.bfloat16)
    out["serve"] = serve = serve_phase(cfg, params, **kw)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve {cfg.name} bf16: peak memory {out['peak_memory_gib']:.2f} "
        f"GiB (weights and both engines' page pools)")
    moe_serve_counts(cfg, serve, yi_serve)
    out["serve_unfused"] = unf = serve_phase(cfg, params, fused_prefix=False,
                                             **kw)
    moe_serve_counts(cfg, unf, yi_serve)
    same = sorted(r for r in serve["tokens"]
                  if serve["tokens"][r] == unf["tokens"][r])
    out["unfused_equal_requests"] = same
    log(f"serve {cfg.name} bf16 fused_prefix=False: tokens equal to the "
        f"fused run's on {len(same)}/{len(serve['tokens'])} requests "
        f"{same}")
    out["fallback_view"] = fallback_view_diff(cfg)
    for r in (serve, unf):
        r.pop("tokens")
    out["check_tokens"] = smoke_tokens_check("moonshot-v1-16b-a3b-smoke",
                                             prefix_cache=True,
                                             chunk_tokens=16)
    out["check_tokens_mixtral"] = smoke_tokens_check("mixtral-8x22b-smoke")
    standard_attention_scales(params, cfg)
    out["check_bf16"] = moe_logits_check(cfg, params, torch.bfloat16,
                                         "full depth, standard attention "
                                         "scales")
    out["profile"] = moe_profile(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = cfg.replace(num_layers=4)
    params = init_params(cut)
    standard_attention_scales(params, cut)
    out["check_f32_4_layers"] = moe_logits_check(
        cut, params, torch.float32, "4 of 48 layers, standard attention "
        "scales")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hybrid_serve_counts(cfg, serve):
    """The zamba2-7b serve phase's launches and bytes against what its
    path must give: per prefill `ssd_scan` once a mamba layer (81) and
    `flash_prefill` once a shared-block call (13); per decode step the
    fused insert + decode once a shared-block call; migrated bytes the
    sum of `kv_bytes(cfg, prompt_len)` (13 layers of bf16 KV a token plus
    81 layers of f32 SSM state, no conv state: the reference's
    accounting). The real blob size is printed beside them."""
    from repro_torch.core.kv_transfer import kv_bytes
    n, steps, c = serve["submitted"], serve["decode_steps"], \
        serve["launches"]
    G = cfg.num_layers // cfg.hybrid_attn_every
    want = {"ssd_scan": cfg.num_layers * n, "flash_prefill": G * n,
            "paged_decode": G * steps, "paged_insert_decode": G * steps,
            "paged_insert": G * steps}
    got = {k: c[k] for k in want}
    want_bytes = sum(kv_bytes(cfg, r.in_len)
                     for r in serve_trace(cfg.vocab_size))
    log(f"serve {cfg.name}: launches {got} over {n} prefills and {steps} "
        f"decode steps (expected {want}); bytes migrated "
        f"{serve['kv_bytes_migrated']} (expected {want_bytes}: kv_bytes, "
        f"{G} layers of bf16 KV a token plus {cfg.num_layers} layers of "
        f"f32 SSM state); the prefill blobs hold {serve['blob_bytes']} "
        f"bytes (f32 state, conv state and KV slabs at max_len)")
    serve.update(expected_launches=want, expected_kv_bytes=want_bytes)
    serve.pop("tokens")
    if got != want or serve["kv_bytes_migrated"] != want_bytes:
        raise SystemExit(f"serve: {cfg.name} launches or bytes are off")


def hybrid_teacher_force(model, params, tokens, n_prompt, plain):
    """Prefill `tokens[:n_prompt]` (81 scans through `ssd_scan`, 13 shared
    attention calls through `flash_prefill`) into a 1024-slot slab, then
    one decode step per remaining token. Returns (every stage's logits in
    f32, the prefill's SSM state)."""
    import torch
    toks = torch.as_tensor(tokens, device=params["embed"].device)[None]
    lg, cache, _ = model.forward(params, toks[:, :n_prompt],
                                 return_cache=True, max_len=1024,
                                 plain=plain)
    state = cache["ssm"].clone()
    out = [lg[:, 0].float()]
    for t in range(n_prompt, len(tokens)):
        lg, cache = model.decode_step(params, cache, toks[:, t], plain=plain)
        out.append(lg.float())
    return torch.cat(out), state


def hybrid_check(cfg, params):
    """Full-width zamba2-7b, teacher-forced over 512 prompt tokens and 8
    decode steps: logits and prefill SSM state through the kernels
    against the plain versions, f32 and bf16 (a cast), each held to
    `HYBRID_BOUNDS`."""
    import numpy as np
    import torch
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    tokens = np.random.default_rng(19).integers(1, cfg.vocab_size,
                                                512 + 8).tolist()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        p = model.cast(params, dtype, params["embed"].device)
        got, got_h = hybrid_teacher_force(model, p, tokens, 512, False)
        want, want_h = hybrid_teacher_force(model, p, tokens, 512, True)
        torch.cuda.synchronize()
        del p
        r = dict(max_abs_diff=float((got - want).abs().max()),
                 max_abs_logit=float(want.abs().max()),
                 state_max_abs_diff=float((got_h - want_h).abs().max()),
                 state_max_abs=float(want_h.abs().max()),
                 argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                    .float().mean()),
                 bound_fraction=HYBRID_BOUNDS[dn])
        r["bound"] = HYBRID_BOUNDS[dn] * r["max_abs_logit"]
        r["state_bound"] = HYBRID_BOUNDS[dn] * r["state_max_abs"]
        log(f"check {cfg.name} {dn}, standard attention scales: teacher-"
            f"forced (slab prefill 512 + 8 decode steps), kernels vs plain "
            f"versions: logits max_abs_diff={r['max_abs_diff']:.4e} of "
            f"max_abs_logit={r['max_abs_logit']:.4e} (bound "
            f"{r['bound']:.4e}); prefill ssm state max_abs_diff="
            f"{r['state_max_abs_diff']:.4e} of {r['state_max_abs']:.4e} "
            f"(bound {r['state_bound']:.4e}); argmax_agree="
            f"{r['argmax_agree']:.3f}")
        out[dn] = r
        if not (math.isfinite(r["max_abs_diff"])
                and math.isfinite(r["state_max_abs_diff"])
                and r["max_abs_diff"] <= r["bound"]
                and r["state_max_abs_diff"] <= r["state_bound"]):
            raise SystemExit(f"check: {cfg.name} {dn} kernel path beyond "
                             f"the bound")
    return out


def zamba_phase(cfg):
    """12. zamba2-7b at full width in f32 (81 mamba layers in 13 groups
    of 6 plus a tail of 3; one shared block of 32/32 heads of hd 112):
    the serve trace on the slab (`hybrid_serve_counts`); (a) smoke tokens,
    card against the CPU; (b) `hybrid_check` at standard attention
    scales."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg)
    out = {"serve": serve_phase(cfg, params)}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve {cfg.name} f32: peak memory {out['peak_memory_gib']:.2f} "
        f"GiB (weights and both engines' slabs)")
    hybrid_serve_counts(cfg, out["serve"])
    out["check_tokens"] = smoke_tokens_check("zamba2-7b-smoke")
    scale_attention(params["shared"]["attn"], cfg)
    out["check"] = hybrid_check(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def facade_check(cfg, params, batch, n_prompt_tokens, max_len, expect):
    """Through the facade (`Model.prefill` on a batch dict, then one
    `Model.decode_step` per remaining token), the logits through the
    kernels against the plain versions, f32 and bf16 (a cast), each held
    to `FACADE_BOUNDS`. `expect` gives each kernel's launches in the
    kernel run (counts set to 0 just before it)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.api import build_model
    model = build_model(cfg)
    toks = batch["tokens"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        p = model.cast(params, dtype, toks.device)
        b = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in batch.items()}
        b["tokens"] = toks[:, :n_prompt_tokens]
        runs = {}
        for plain in (False, True):
            torch.cuda.synchronize()
            reset_launch_counts()
            lg, cache = model.prefill(p, b, max_len=max_len, plain=plain)
            rows = [lg.float()]
            for t in range(n_prompt_tokens, toks.shape[1]):
                lg, cache = model.decode_step(p, cache, toks[:, t],
                                              plain=plain)
                rows.append(lg.float())
            torch.cuda.synchronize()
            runs[plain] = (torch.cat(rows), launch_counts())
            del cache
        del p
        got, want = runs[False][0], runs[True][0]
        counts = runs[False][1]
        r = dict(max_abs_diff=float((got - want).abs().max()),
                 max_abs_logit=float(want.abs().max()),
                 argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                    .float().mean()),
                 launches=counts, plain_launches=runs[True][1])
        r["bound"] = FACADE_BOUNDS[dn] * r["max_abs_logit"]
        launched = {k: counts[k] for k in expect}
        log(f"check {cfg.name} {dn}, standard attention scales: facade "
            f"prefill + {toks.shape[1] - n_prompt_tokens} decode steps, "
            f"kernels vs plain versions: max_abs_diff="
            f"{r['max_abs_diff']:.4e} of max_abs_logit="
            f"{r['max_abs_logit']:.4e} (bound {r['bound']:.4e}); "
            f"argmax_agree={r['argmax_agree']:.3f}; launches {launched} "
            f"(expected {expect}; plain run "
            f"{sum(runs[True][1].values())})")
        out[dn] = r
        if not (math.isfinite(r["max_abs_diff"])
                and r["max_abs_diff"] <= r["bound"]) \
                or launched != expect or sum(runs[True][1].values()):
            raise SystemExit(f"check: {cfg.name} {dn} kernel path beyond "
                             f"the bound or off its kernels")
    return out


def facade_phase(ecfg, vcfg):
    """13. The encoder-decoder and the VLM at the facade. (a)
    seamless-m4t-large-v2 at full width and depth (24 + 24 layers, d
    1024, 16/16 heads of hd 64): encode 1024 frames, a 64-token decoder
    prefill, 8 decode steps (the decoder's self-attention through the
    fused insert + decode, its cross-attention through `paged_decode`
    over the cross-KV slab). (b) internvl2-76b at full width (d 8192,
    64/8 heads of hd 128) with the depth cut to 4 of 80 layers: 1024
    frontend embeddings plus 200 text tokens, prefill on the slab, 8
    decode steps. Both at standard attention scales, `facade_check`."""
    import torch
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = init_params(ecfg)
    for blk in ("enc", "dec"):
        scale_attention(params[blk]["attn"], ecfg)
    scale_attention(params["dec"]["xattn"], ecfg)
    L, Le = ecfg.num_layers, ecfg.encoder_layers
    batch = {"src_embeds": 0.3 * torch.randn(1, 1024, ecfg.d_model,
                                             generator=gen, device="cuda"),
             "tokens": torch.randint(1, ecfg.vocab_size, (1, 64 + 8),
                                     generator=gen, device="cuda")}
    out["seamless"] = facade_check(
        ecfg, params, batch, 64, 128,
        {"flash_prefill": Le + 2 * L, "paged_decode": 8 * 2 * L,
         "paged_insert_decode": 8 * L})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = vcfg.replace(num_layers=4)
    params = init_params(cut)
    standard_attention_scales(params, cut)
    batch = {"frontend_embeds": cut.d_model ** -0.5 * torch.randn(
                 1, 1024, cut.d_model, generator=gen, device="cuda"),
             "tokens": torch.randint(1, cut.vocab_size, (1, 200 + 8),
                                     generator=gen, device="cuda")}
    out["internvl2"] = facade_check(
        cut, params, batch, 200, 1280,
        {"flash_prefill": 4, "paged_decode": 8 * 4,
         "paged_insert_decode": 8 * 4})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: training (yi-6b width, 8 layers) through flash_prefill and its
# backward kernel
# ---------------------------------------------------------------------------

# the backward kernel against `flash_prefill_bwd_ref` on the same o, lse
# and do: each gradient within this fraction of its largest |value|.
# f32: the same f32 formula in another summation order (~1e-6 of scale
# in the card tests). bf16: the kernel rounds P and dS to bf16 before its
# products (2^-9 each, as FlashAttention-2 does) and stores bf16; a wrong
# kernel gives O(1) differences. The forward's LSE (natural log, ~5 at
# these shapes) within atol 2e-4 + rtol 2e-5 of the plain one: the bf16
# kernel forms its row sums from ex2.approx, ~2 ulp a term.
BWD_BOUNDS = {"float32": 5e-5, "bfloat16": 2e-2}
LSE_TOL = dict(atol=2e-4, rtol=2e-5)
# (row name, B, H, Hkv, Sq, Skv, hd, causal, window)
TRAIN_SHAPES = (
    ("yi6b_train", 4, 32, 4, 1024, 1024, 128, True, 0),
    ("gemma3_s1024_w512", 1, 4, 1, 1024, 1024, 256, True, 512),
    ("seamless_encoder", 1, 16, 16, 1024, 1024, 64, False, 0),
    ("seamless_cross", 1, 16, 16, 64, 1024, 64, False, 0),
    ("zamba2_s1024", 1, 32, 32, 1024, 1024, 112, True, 0))
# The 8-layer yi-6b train step through the kernels against the same step
# through the plain versions (`plain=True`), bf16 compute, f32 params, the
# attention projections at standard scales (C1). Both paths run the same
# bf16 matmuls; they differ where attention rounds to bf16 (the kernels
# round P and dS before their products, the plain path only its outputs)
# and in f32 summation order. Bounds: the loss (~11, a mean over 4096
# tokens) within 2e-2; every gradient leaf within 0.1 of its largest
# |grad| (as LOGIT_BOUND; a wrong backward gives O(1)); grad_norm within
# 2e-2 relative.
TRAIN_BOUNDS = {"loss": 2e-2, "leaf": 0.1, "grad_norm": 2e-2}
# Phase 15's SSM steps also run in f32 compute, kernels against plain
# versions. Both paths then run the same f32 matmuls (TF32 off) and differ
# only by the kernels' f32 summation order (~1e-6 of scale a call in the
# kernel rows). Bounds: the loss within 1e-5 relative; every leaf within
# 1e-3 of its max|grad|, which leaves room for the per-head leaves
# (dt_bias, A_log, D), whose gradients are sums over every token of terms
# that largely cancel; a wrong kernel gives O(1). In bf16 those leaves
# move with bf16's own rounding through 64 layers (dt_bias 15.7% of its
# max|grad| between the kernel and plain paths of mamba2-2.7b on an H100,
# against TRAIN_BOUNDS' 0.1). So there each leaf k has its bf16 noise
# n_k, the plain bf16 step's distance from the plain f32 step (the
# truth), and three checks: n_k <= BF16_NOISE_CEILING, above which bf16
# cannot witness the leaf and the phase fails; the kernel bf16 step within
# max(0.1, 2 n_k) of the plain bf16 step, two bf16 paths being about
# sqrt(2) noises apart; and the kernel bf16 step within max(0.1, 2 n_k) of
# the plain f32 step, one noise with room for its spread over the leaves
# (zamba2-7b's groups/m/conv_Bb sits at 1.53 n_k on an H100, where its f32
# step through the kernels is within 2.3e-5 of the plain one).
F32_TRAIN_BOUNDS = {"loss": 1e-5, "leaf": 1e-3}
BF16_NOISE_CEILING = 0.3
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 4, 1024, 5


def mask_pairs(Sq, Skv, causal, window):
    """Visible (query, key) pairs of one head: what the work depends on."""
    from repro_torch.models.attention import attention_mask
    return int(attention_mask(Sq, Skv, causal, window, "cuda").sum())


def train_kernel_rows(dtype, name, B, H, Hkv, Sq, Skv, hd, causal, window,
                      seed):
    """At one shape: the backward kernel against `flash_prefill_bwd_ref` on
    the plain forward's o and lse (and two calls' bits), the forward's LSE
    against the plain LSE, and the times of the backward kernel, its plain
    version and SDPA's backward (the library yardstick). Returns the
    backward's row and the forward-with-LSE row."""
    import torch
    from repro_torch.kernels.flash_prefill.kernel import (bwd_warpgroups,
                                                          flash_prefill,
                                                          flash_prefill_bwd)
    from repro_torch.kernels.flash_prefill.ref import (flash_prefill_bwd_ref,
                                                       flash_prefill_ref)
    dn = dtype_name(dtype)
    # the backward's route and tiles at this shape (kernel.py, csrc)
    if dtype == torch.float32:
        design = "f32 CUDA cores, 64-row tiles" if hd <= 128 else \
            "f32 CUDA cores, 32-row tiles"
    elif hd > 128:
        design = "mma.sync, 8 warps, 64-row tiles (hd 256 instance)"
    else:
        nc, qh = bwd_warpgroups(
            B, H, Hkv, Sq, hd,
            torch.cuda.get_device_properties(0).multi_processor_count)
        design = (f"wgmma+TMA: dK/dV {nc} consumer warpgroup(s) a 64-row "
                  f"kv tile, dQ {qh} query head(s) a 64-row q tile")
    es = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def model_layout(S, n):      # (B, S, n, hd) viewed as (B, n, S, hd)
        return torch.randn((B, S, n, hd), generator=gen, device="cuda") \
            .to(dtype).transpose(1, 2)
    q, k, v = model_layout(Sq, H), model_layout(Skv, Hkv), \
        model_layout(Skv, Hkv)
    do = model_layout(Sq, H)
    kw = dict(causal=causal, window=window)
    o, lse = flash_prefill_ref(q, k, v, return_lse=True, **kw)
    lse = lse.float().contiguous()
    lse_k = torch.empty_like(lse)
    o_k = flash_prefill(q, k, v, lse=lse_k, **kw)
    got = flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    again = flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    want = flash_prefill_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = float((g.float() - w.float()).abs().max())
        s = float(w.float().abs().max())
        errs[g_name] = (e, s)
        ok = ok and e <= BWD_BOUNDS[dn] * s
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    lse_err = float((lse_k - lse).abs().max())
    lse_ok = bool((lse_k - lse).abs().le(
        LSE_TOL["atol"] + LSE_TOL["rtol"] * lse.abs()).all())
    o_err, o_ok = max_err(o_k, o, dn)
    pairs = mask_pairs(Sq, Skv, causal, window) * B
    fwd_flops = 4 * pairs * H * hd
    qo_bytes = B * H * Sq * hd * es
    kv_bytes_ = B * Hkv * Skv * hd * es

    # the library yardstick: SDPA's backward on the same inputs (GQA by the
    # library), never called by the port
    mask = None
    if window:
        from repro_torch.models.attention import attention_mask
        mask = attention_mask(Sq, Skv, causal, window, "cuda")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, mask=mask, causal=causal and not window
               and Sq == Skv)

    def lib_bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    shape = (f"B={B} Sq={Sq} Skv={Skv} {'causal' if causal else 'non-causal'}"
             f"{f' window={window}' if window else ''} H={H} Hkv={Hkv} "
             f"hd={hd}")
    bwd = dict(
        shape=shape, design=design,
        max_abs_err=max(e for e, _ in errs.values()),
        grad_err_of_scale={g: [e, s] for g, (e, s) in errs.items()},
        bound_of_scale=BWD_BOUNDS[dn], ok=ok and same,
        repeat_identical=same,
        ms=time_ms(lambda: flash_prefill_bwd(q, k, v, o, lse, do, **kw)),
        plain_ms=time_ms(lambda: flash_prefill_bwd_ref(q, k, v, o, lse, do,
                                                       **kw), iters=3),
        library_ms=time_ms(lib_bwd),
        library="scaled_dot_product_attention backward",
        bytes=3 * qo_bytes + 2 * kv_bytes_ + B * H * Sq * 4
        + qo_bytes + 2 * kv_bytes_,
        flops=int(2.5 * fwd_flops))
    bwd["launch_us"] = bwd_launch_us(
        lambda: flash_prefill_bwd(q, k, v, o, lse, do, **kw))
    fwd = dict(
        shape=shape + " with LSE", max_abs_err=o_err, lse_max_abs_err=lse_err,
        ok=o_ok and lse_ok,
        ms=time_ms(lambda: flash_prefill(q, k, v, lse=lse_k, **kw)),
        plain_ms=time_ms(lambda: flash_prefill_ref(q, k, v, return_lse=True,
                                                   **kw), iters=3),
        library_ms=time_ms(lambda: sdpa(q, k, v, mask=mask,
                                        causal=causal and not window
                                        and Sq == Skv)),
        library="scaled_dot_product_attention",
        bytes=2 * qo_bytes + 2 * kv_bytes_ + B * H * Sq * 4,
        flops=fwd_flops)
    log(f"kernel flash_prefill_bwd {name} {dn} [{design}]: launches us "
        f"{bwd['launch_us']}; grads "
        f"(max_abs_err, max|ref|) {errs} bound {BWD_BOUNDS[dn]} of max|ref|; "
        f"repeat_identical={same}; forward LSE max_abs_err={lse_err:.3e} "
        f"{'ok' if lse_ok else 'MISMATCH'}")
    del leaves, out
    return bwd, fwd


# the backward's launches by kernel name (csrc/flash_prefill_bwd.cu)
BWD_LAUNCHES = (("dQ sum", "flash_prefill_bwd_dq_sum"),
                ("D", "flash_prefill_bwd_dsum"),
                ("dK/dV", "flash_prefill_bwd_dkdv"),
                ("dQ", "flash_prefill_bwd_dq"))


def bwd_launch_us(fn, calls=5, launches=BWD_LAUNCHES):
    """Device microseconds of each of a backward's launches (by default
    `flash_prefill_bwd`'s: D, dK/dV, dQ and, where dQ's walk is split, the
    sum of its parts), the mean over the launches torch.profiler recorded
    in `calls` calls of `fn`; `launches` maps labels to kernel names,
    first match wins."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        for label, key in launches:
            if key in e.key:
                out[label] = round(dev / max(e.count, 1), 2)
                break
    return out


def bwd_ptxas(build_log: Path) -> str:
    """Registers and spill bytes of each wgmma instance of the backward
    (`-Xptxas -v` of the build), `<kernel><HD,warpgroups,PAD>`."""
    if not build_log.exists():
        return "ptxas flash_prefill_bwd: no build log (library reused)"
    out, entry = [], None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = None
            for kern in ("dkdv_wgmma_kernel", "dq_wgmma_kernel"):
                if kern in name:
                    args = name.split(kern + "I")[1].split("EEEv")[0]
                    nums = [a for a in args.replace("Li", " ").replace(
                        "ELb", " ").replace("E", " ").split()]
                    entry = f"{kern.split('_wgmma')[0]}<{','.join(nums)}>"
        elif entry and "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split()[-1]
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split()[0]
            out.append(f"{entry} {regs} regs {spill} spill")
            entry = None
    return "ptxas flash_prefill_bwd (kernel<HD,warpgroups,PAD>): " + \
        "; ".join(out)


def train_kernel_phase(dtypes):
    """14a. `flash_prefill_bwd` and the forward's LSE at the training shape
    and the other families' attention shapes, f32 and bf16."""
    import torch
    from repro_torch.kernels.build import BUILD_DIR
    log(bwd_ptxas(BUILD_DIR / "build.log"))
    results = {}
    for dtype in dtypes:
        dn = dtype_name(dtype)
        rows = {}
        for i, (name, *shape) in enumerate(TRAIN_SHAPES):
            bwd, fwd = train_kernel_rows(dtype, name, *shape, seed=100 + i)
            rows[f"flash_prefill_bwd_{name}"] = bwd
            rows[f"flash_prefill_lse_{name}"] = fwd
            gc.collect()
            torch.cuda.empty_cache()
        finish_rows(rows, dn)
        results[dn] = rows
    return results


def train_config():
    """yi-6b at full width with its depth cut to TRAIN_LAYERS (f32 params
    and grads and both AdamW moments, 16 bytes a parameter: 32 layers
    would need ~97 GB)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("yi-6b"), num_layers=TRAIN_LAYERS,
                               name=f"yi-6b-{TRAIN_LAYERS}l")


def train_flops(cfg, B, S):
    """Model flops of one train step (MFU's numerator): 3 x the forward
    (forward, then the backward's two products per forward product; the
    remat recompute not counted), the forward being 2 flops per matmul
    parameter per token (the layers' projections and FFN and the lm_head;
    the embedding lookup is not a product) plus causal attention's two
    products, 2 x 2 H hd flops per visible key, (S + 1) / 2 keys per query
    on average."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    per_layer = d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * cfg.d_ff
    n_mm = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = cfg.num_layers * 4 * H * hd * (S + 1) / 2
    return 3 * B * S * (2 * n_mm + attn), n_mm


def train_step_phase(cfg, want=None, prepare=standard_attention_scales,
                     flops_fn=train_flops, B=TRAIN_B, S=TRAIN_S,
                     f32_check=False):
    """14b. The 8-layer yi-6b train step (bf16 compute, f32 params and
    AdamW, remat, B x S tokens of `SyntheticTokens`) once through the
    kernels and once through the plain versions from the same params,
    held to TRAIN_BOUNDS, with the kernels' launches counted against
    `want` (default: the transformer's two `flash_prefill` and one
    `flash_prefill_bwd` a layer); then TRAIN_STEPS steps timed, and a
    profile of one more. `prepare(params, cfg)` rescales the attention
    (C1) and `flops_fn(cfg, B, S)` gives the step's model flops and
    matmul params; phase 15 passes the SSM families' own. With
    `f32_check` the same step also runs in f32 compute through the
    kernels and through the plain versions, held to F32_TRAIN_BOUNDS, and
    each bf16 leaf is held against its bf16 noise and the plain f32 step
    (see F32_TRAIN_BOUNDS)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                global_norm, tree_leaves)
    from repro_torch.training.train_step import (make_loss_fn,
                                                 make_train_step,
                                                 value_and_grad)
    model = build_model(cfg)
    params = init_params(cfg)
    if prepare is not None:
        prepare(params, cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, B, S))

    def batch(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in data.batch_at(i).items()}
    out = dict(config=cfg.name, params=n_params)
    b0 = batch(0)

    def grads(plain, dtype=torch.bfloat16):
        _, met, g = value_and_grad(
            make_loss_fn(model, plain=plain, compute_dtype=dtype), params,
            b0)
        torch.cuda.synchronize()
        return float(met["loss"]), g

    def fracs(g, h):
        """Each leaf's max |g - h| over h's max |value|, by name."""
        return {key: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                      1e-30)
                for (key, a), b in zip(_named_leaves(g), tree_leaves(h))}
    torch.cuda.synchronize()
    reset_launch_counts()
    loss_k, g_k = grads(False)
    counts = launch_counts()
    loss_p, g_p = grads(True)
    want = want or {"flash_prefill": 2 * cfg.num_layers,
                    "flash_prefill_bwd": cfg.num_layers}
    got = {k: counts[k] for k in want}
    gn_k, gn_p = float(global_norm(g_k)), float(global_norm(g_p))
    diff = fracs(g_k, g_p)
    bound_of = dict.fromkeys(diff, TRAIN_BOUNDS["leaf"])
    ok32 = True
    if f32_check:
        loss_pf, g_pf = grads(True, torch.float32)
        noise = fracs(g_p, g_pf)
        truth = fracs(g_k, g_pf)
        del g_k, g_p
        gc.collect()
        loss_kf, g_kf = grads(False, torch.float32)
        diff32 = fracs(g_kf, g_pf)
        del g_kf, g_pf
        leaf = TRAIN_BOUNDS["leaf"]
        bound_of = {k: max(leaf, 2 * noise[k]) for k in diff}
        worst32 = max(diff32, key=diff32.get)
        worst_truth = max(truth, key=lambda k: truth[k] / bound_of[k])
        noisiest = sorted(noise, key=noise.get, reverse=True)[:4]
        ok32 = (abs(loss_kf - loss_pf)
                <= F32_TRAIN_BOUNDS["loss"] * abs(loss_pf)
                and diff32[worst32] <= F32_TRAIN_BOUNDS["leaf"]
                and noise[noisiest[0]] <= BF16_NOISE_CEILING
                and all(truth[k] <= bound_of[k] for k in truth))
        out.update(f32_loss_kernels=loss_kf, f32_loss_plain=loss_pf,
                   f32_worst_leaf=worst32,
                   f32_worst_leaf_of_scale=diff32[worst32],
                   f32_bounds=F32_TRAIN_BOUNDS, bf16_noise_of_scale=noise,
                   bf16_noise_ceiling=BF16_NOISE_CEILING,
                   bf16_kernels_vs_f32_of_scale=truth,
                   bf16_kernels_vs_f32_worst_leaf=worst_truth,
                   bf16_kernels_vs_f32_bound=bound_of[worst_truth])
        log(f"train {cfg.name} f32 B={B} S={S}, one step, kernels vs plain "
            f"versions: loss {loss_kf:.7f} vs {loss_pf:.7f} (bound "
            f"{F32_TRAIN_BOUNDS['loss']} relative); worst leaf {worst32} "
            f"{diff32[worst32]:.4e} of its max|grad| (bound "
            f"{F32_TRAIN_BOUNDS['leaf']}); bf16 noise (plain bf16 vs plain "
            f"f32) of the noisiest leaves "
            f"{ {k: f'{noise[k]:.4e}' for k in noisiest} } (ceiling "
            f"{BF16_NOISE_CEILING}); kernel bf16 vs plain f32, nearest its "
            f"bound: {worst_truth} {truth[worst_truth]:.4e} (bound "
            f"{bound_of[worst_truth]:.4e}, its noise "
            f"{noise[worst_truth]:.4e})")
    else:
        del g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    worst_leaf = max(diff, key=lambda k: diff[k] / bound_of[k])
    worst = diff[worst_leaf]
    ok = (abs(loss_k - loss_p) <= TRAIN_BOUNDS["loss"]
          and all(diff[k] <= bound_of[k] for k in diff)
          and abs(gn_k - gn_p) <= TRAIN_BOUNDS["grad_norm"] * gn_p
          and got == want and math.isfinite(loss_k) and ok32)
    out.update(loss_kernels=loss_k, loss_plain=loss_p, grad_norm_kernels=gn_k,
               grad_norm_plain=gn_p, worst_leaf_of_scale=worst,
               worst_leaf=worst_leaf, worst_leaf_bound=bound_of[worst_leaf],
               launches=counts, expected=want, bounds=TRAIN_BOUNDS)
    log(f"train {cfg.name} bf16 B={B} S={S} ({n_params} "
        f"params), one step, kernels vs plain versions: loss {loss_k:.6f} "
        f"vs {loss_p:.6f} (bound {TRAIN_BOUNDS['loss']}); grad_norm "
        f"{gn_k:.6f} vs {gn_p:.6f} (bound {TRAIN_BOUNDS['grad_norm']} "
        f"relative); worst leaf {worst_leaf} {worst:.4e} of its max|grad| "
        f"(bound {bound_of[worst_leaf]:.4e}"
        + (f"; vs plain f32 {truth[worst_leaf]:.4e}, its noise "
           f"{noise[worst_leaf]:.4e}" if f32_check else "")
        + f"); launches {got} (expected {want})")
    if not ok:
        raise SystemExit("train: the kernel path's step is beyond its bounds "
                         "or off its kernels")

    step = make_train_step(model, AdamWConfig())
    opt = adamw_init(params)
    flops, n_mm = flops_fn(cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        bi = batch(i)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, bi)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = launch_counts()
        steps.append(dict(step=i, loss=loss, grad_norm=float(m["grad_norm"]),
                          s=dt, tokens_per_s=B * S / dt,
                          mfu=flops / dt / PEAK_FLOPS["bfloat16"],
                          launches={k: c[k] for k in want}))
        log(f"train {cfg.name} step {i}: loss {loss:.6f} grad_norm "
            f"{steps[-1]['grad_norm']:.4f} {dt * 1e3:.2f} ms "
            f"{steps[-1]['tokens_per_s']:.0f} tokens/s MFU "
            f"{steps[-1]['mfu']:.4f} launches {steps[-1]['launches']}")
        if steps[-1]["launches"] != want or not math.isfinite(loss):
            raise SystemExit("train: a step was off its kernels or not "
                             "finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(s["s"] for s in steps[1:])
    out.update(steps=steps, median_step_s=med,
               tokens_per_s=B * S / med,
               mfu=flops / med / PEAK_FLOPS["bfloat16"], flops=flops,
               matmul_params=n_mm, peak_gib=peak)
    log(f"train {cfg.name}: median step (steps 1..{TRAIN_STEPS - 1}) "
        f"{med * 1e3:.2f} ms, {out['tokens_per_s']:.0f} tokens/s, MFU "
        f"{out['mfu']:.4f} of 989 TF/s (model flops {flops:.4e} a step "
        f"({flops_fn.__name__}; {n_mm} matmul params); remat's recompute "
        f"not counted), peak {peak:.2f} GiB")
    k = TRAIN_STEPS
    out["profile"] = device_profile(
        lambda: step(params, opt, batch(k)), f"{cfg.name} train step")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out, {"launches": counts}


def _named_leaves(tree):
    """(path, leaf) in `tree_leaves` order."""
    out = []

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else k, node[k])
        else:
            out.append((prefix, node))
    rec("", tree)
    return out


def restart_phase(cfg):
    """14c. Restart at the train step's own size (`train_config`, bf16,
    remat, B x S tokens, seed-0 params at standard attention scales): a
    straight run of 4 steps that checkpoints after step 2, a second
    straight run, and a run restored from the checkpoint into fresh
    tensors for steps 2..4. The restored run must equal the straight run
    to the bit where the two straight runs do; where they do not (an op
    of the step is nondeterministic on the card: the candidates are the
    embedding's backward, `index_put_` with accumulate, and the
    cross-entropy's gather backward), within 2 x (lr_3 + lr_4) of it, the
    most that Adam's sign-like step can move a param in two steps. The
    checkpoint (23 GB: f32 params and both moments) is written at level 0,
    zlib's stored blocks: the card's machine has no zstandard, and zlib's
    default level would take minutes over it."""
    import shutil
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    from repro_torch.training.train_step import make_train_step
    model = build_model(cfg)
    opt_cfg = AdamWConfig()
    step = make_train_step(model, opt_cfg)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S))
    root = ROOT / "build" / "train_restart"
    shutil.rmtree(root, ignore_errors=True)

    def fresh():
        p = init_params(cfg)
        standard_attention_scales(p, cfg)
        return p, adamw_init(p)

    def run(p, o, a, b, save_at=None):
        for i in range(a, b):
            bi = {k: torch.from_numpy(v).to("cuda")
                  for k, v in data.batch_at(i).items()}
            p, o, _ = step(p, o, bi)
            if save_at == i + 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save(str(root / f"step_{i + 1}"), i + 1, p, o, level=0)
                times["save_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        return p, o

    def diff(x, y):
        leaves = list(zip(tree_leaves(x[0]) + tree_leaves(x[1]),
                          tree_leaves(y[0]) + tree_leaves(y[1])))
        return (all(bool(torch.equal(a, b)) for a, b in leaves),
                max(float((a.float() - b.float()).abs().max())
                    for a, b in leaves))
    times = {}
    straight = run(*fresh(), 0, 4, save_at=2)
    again = run(*fresh(), 0, 4)
    det, det_diff = diff(straight, again)
    del again
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s, p_r, o_r, _ = ckpt.restore(str(root / "step_2"), *straight,
                                  device="cuda")
    torch.cuda.synchronize()
    times["restore_s"] = time.perf_counter() - t0
    restored = run(p_r, o_r, s, 4)
    exact, max_diff = diff(straight, restored)
    bound = 2 * sum(opt_cfg.lr * min(t / opt_cfg.warmup_steps, 1.0)
                    for t in (3, 4))
    ok = s == 2 and (exact if det else max_diff <= bound)
    log(f"train restart {cfg.name}: checkpoint at step 2 (saved in "
        f"{times['save_s']:.1f}s, restored into fresh tensors in "
        f"{times['restore_s']:.1f}s), steps 2..4; two straight runs "
        f"bit-equal {det} (max diff {det_diff:.3e}); restored vs straight "
        f"bit-equal {exact} (max diff {max_diff:.3e}"
        f"{'' if det else f', bound {bound:.3e}'})")
    shutil.rmtree(root, ignore_errors=True)
    del straight, restored, p_r, o_r
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("train: the restored run left the straight run")
    return dict(step=s, straight_runs_bit_equal=det,
                straight_runs_max_diff=det_diff, bit_equal=exact,
                max_diff=max_diff, bound=None if det else bound, **times)


def launcher_phase():
    """14d. `python -m repro_torch.launch.train --arch yi-6b-smoke --steps
    20 --ckpt-every 10` on the card, then the same command again, which
    must resume at step 20 and run no step."""
    import os
    import shutil
    ck = ROOT / "build" / "train_launcher"
    shutil.rmtree(ck, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "yi-6b-smoke", "--steps", "20", "--ckpt-dir", str(ck),
           "--ckpt-every", "10"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300)
        runs.append((r, time.perf_counter() - t0))
    (first, t1), (second, t2) = runs
    lines = first.stdout.splitlines()
    losses = [float(ln.split()[4]) for ln in lines
              if ln.startswith("[train] step ")]
    ok = (first.returncode == 0 and second.returncode == 0
          and len(losses) == 20 and all(map(math.isfinite, losses))
          and "[train] checkpointed step 10" in lines
          and "[train] checkpointed step 20" in lines
          and second.stdout.splitlines() == ["[train] resumed from step 20"])
    log(f"train launcher yi-6b-smoke on the card: 20 steps in {t1:.1f}s, "
        f"loss {losses[0] if losses else float('nan'):.4f} -> "
        f"{losses[-1] if losses else float('nan'):.4f}, checkpoints at 10 "
        f"and 20; second run {t2:.1f}s: {second.stdout.strip()!r}")
    shutil.rmtree(ck, ignore_errors=True)
    if not ok:
        raise SystemExit(f"train: the launcher failed or did not resume:\n"
                         f"{first.stdout}{first.stderr}{second.stdout}"
                         f"{second.stderr}")
    return dict(first_s=t1, second_s=t2, losses=losses,
                second_stdout=second.stdout)


# ---------------------------------------------------------------------------
# phase 15: training the SSM families (mamba2-2.7b, zamba2-7b) through
# ssd_scan and its backward kernel
# ---------------------------------------------------------------------------

# the backward kernel against `ssd_scan_bwd_ref` on the same inputs: each
# gradient within this fraction of its largest |value|. f32: the same f32
# function in another summation order (the kernel's decomposition against
# autograd of `ssd_chunked` differs by ~1e-6 of scale on the CPU at S =
# 512, chunk 256). bf16: both read the same bf16 inputs and compute in
# f32; the kernel rounds dx, dB and dC to bf16 once, the plain version
# rounds dx's two terms apart and adds them in bf16 (a few ulp of 2^-8);
# ddt, dA, dD and dh0 are f32 on both sides. A wrong kernel gives O(1).
SSD_BWD_BOUNDS = {"float32": 5e-5, "bfloat16": 2e-2}
# (row name, b, S, nh, hd, G, N, chunk, h0 and dh_final given)
SSD_BWD_SHAPES = (
    ("mamba2_train", 2, 2048, 80, 64, 1, 128, 256, False),
    ("zamba2_train", 2, 2048, 112, 64, 1, 64, 256, False),
    ("small_g2_h0", 2, 200, 8, 32, 2, 32, 40, True))
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
# the seven launches of csrc/ssd_scan_bwd.cu by kernel name
SSD_BWD_LAUNCHES = (("dstate", "ssd_scan_bwd_dstate"),
                    ("pass", "ssd_scan_bwd_pass"),
                    ("source", "ssd_scan_bwd_src"),
                    ("head", "ssd_scan_bwd_head"),
                    ("query", "ssd_scan_bwd_qry"),
                    ("scan", "ssd_scan_bwd_scan"),
                    ("reduce", "ssd_scan_bwd_reduce"))
SSM_TRAIN_B, SSM_TRAIN_S = 2, 2048
# zamba2-7b's 81 layers (6.75 B parameters, ~108 GB of f32 params, grads
# and moments) cut to 2 groups of 6 and a tail of 2: two applications of
# the shared block, and the tail path
ZAMBA_TRAIN_LAYERS = 14


def ssd_bwd_flops_bytes(b, S, nh, hd, G, N, Q, es, given):
    """Operations and bytes the gradient of one SSD scan needs, whatever
    the kernel keeps. Per (batch, chunk, head): the chunk's state gradient
    (2 Q hd N), the state terms of d xdt, dB and dC (3 x 2 Q hd N), and
    over the P causal pairs dP = dy xdt^T and M^T dy (2 x 2 P hd). Per
    (batch, chunk, group), as the forward counts C.B^T: the heads' masked
    dCB summed first, then its two products with C and B (2 x 2 P N).
    Bytes, each once: x, dy, B, C in and dx, dB, dC out in the storage
    type; dt, A, D in and ddt, dA, dD out in f32; h0 and dh_final in and
    dh0 out where `given`. The forward's kept scratch (each chunk's h_in,
    a_cum, C.B^T) is this design's choice, not the function's, and is not
    counted."""
    P = Q * (Q + 1) // 2
    nc = S // Q
    flops = b * nc * (nh * (8 * Q * hd * N + 4 * P * hd) + G * 4 * P * N)
    state = b * nh * hd * N * 4
    nbytes = (3 * b * S * nh * hd * es + 4 * b * S * G * N * es
              + 2 * b * S * nh * 4 + 4 * nh * 4
              + (3 * state if given else 0))
    return flops, nbytes


def ssd_bwd_ptxas(build_log: Path) -> str:
    """Registers and spill bytes of `ssd_scan_bwd`'s instances at the
    training shapes (hd 64, N 64 / 128: `<dtype,HD,NP>`), the range over
    all its instances, and any "wgmma serialized" note (`-Xptxas -v` of
    the build)."""
    if not build_log.exists():
        return "ptxas ssd_scan_bwd: no build log (library reused)"
    seen, notes, entry, spill = {}, 0, None, "0"
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = None
            if "ssd_scan_bwd_" in name:
                kind = name.split("ssd_scan_bwd_")[-1].split("_kernel")[0]
                ty = "bf16" if "bfloat16" in name else "f32"
                nums = [t.split("E")[0] for t in name.split("Li")[1:]]
                entry = f"{kind}<{','.join([ty] + nums)}>" \
                    if "kernelI" in name else kind
        elif entry and "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split()[-1]
        elif entry and "Used" in line and "registers" in line:
            seen[entry] = (int(line.split("Used")[1].split()[0]), int(spill))
            entry = None
        if "wgmma" in line and "serializ" in line and "ssd_scan_bwd" in line:
            notes += 1
    if not seen:
        return "ptxas ssd_scan_bwd: no instance in the build log"
    shown = [f"{k} {r} regs {sp} spill" for k, (r, sp) in seen.items()
             if ",64," in k or k.startswith(("pass", "scan", "reduce"))]
    regs = [r for r, _ in seen.values()]
    spilling = [k for k, (_, sp) in seen.items() if sp]
    return (f"ptxas ssd_scan_bwd: {'; '.join(shown)}; all {len(seen)} "
            f"instances {min(regs)}..{max(regs)} regs, spilling "
            f"{spilling or 'none'}, wgmma serialized notes {notes}")


def ssd_bwd_kernel_phase(dtypes):
    """15a. `ssd_scan_bwd` against `ssd_scan_bwd_ref` at `SSD_BWD_SHAPES`
    (the forward kernel's kept scratch as its input), f32 and bf16; two
    identical calls must give identical bits. No PyTorch call computes the
    scan's gradient, so there is no library yardstick. At the training
    shapes, each of the seven launches' device time (torch.profiler)."""
    import torch
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    log(ssd_bwd_ptxas(BUILD_DIR / "build.log"))
    results = {}
    for dtype in dtypes:
        dn = dtype_name(dtype)
        es = torch.empty((), dtype=dtype).element_size()
        rows = {}
        for i, (name, b, S, nh, hd, G, N, Q, given) in enumerate(
                SSD_BWD_SHAPES):
            gen = torch.Generator(device="cuda").manual_seed(500 + i)

            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            x = randn(b, S, nh, hd).to(dtype)
            dt = torch.nn.functional.softplus(randn(b, S, nh)) * 0.1
            A = -torch.exp(randn(nh))
            B = randn(b, S, G, N).to(dtype)
            C = randn(b, S, G, N).to(dtype)
            D = randn(nh)
            h0 = randn(b, nh, hd, N) if given else None
            dh = randn(b, nh, hd, N) if given else None
            dy = randn(b, S, nh, hd).to(dtype)
            _, _, kept = ssd_scan(x, dt, A, B, C, D, chunk=Q, h0=h0,
                                  keep_scratch=True)

            def kern():
                return ssd_scan_bwd(x, dt, A, B, C, D, kept, dy, dh,
                                    chunk=Q, h0=h0)

            def plain():
                return ssd_scan_bwd_ref(x, dt, A, B, C, D, dy, dh, chunk=Q,
                                        h0=h0)
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            errs, ok = {}, True
            for g_name, g, w in zip(SSD_GRADS, got, want):
                if w is None:
                    continue
                e = float((g.float() - w.float()).abs().max())
                sc = float(w.float().abs().max())
                errs[g_name] = (e, sc)
                ok = ok and g.dtype == w.dtype and \
                    e <= SSD_BWD_BOUNDS[dn] * sc
            same = all(bool(torch.equal(u, v)) for u, v in zip(got, again)
                       if u is not None)
            del got, again, want
            flops, nbytes = ssd_bwd_flops_bytes(b, S, nh, hd, G, N, Q, es,
                                                given)
            r = dict(
                shape=(f"b={b} S={S} chunk={Q} nh={nh} hd={hd} G={G} N={N}"
                       f"{' h0 dh_final' if given else ''}"),
                max_abs_err=max(e for e, _ in errs.values()),
                grad_err_of_scale={k: list(v) for k, v in errs.items()},
                bound_of_scale=SSD_BWD_BOUNDS[dn], ok=ok and same,
                repeat_identical=same, ms=time_ms(kern, iters=10),
                plain_ms=time_ms(plain, iters=3, warmup=1),
                library_ms=None, library="none", bytes=nbytes, flops=flops)
            r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dn)
            r["achieved"] = achieved(r)
            if name.endswith("_train"):
                r["launch_us"] = bwd_launch_us(kern,
                                               launches=SSD_BWD_LAUNCHES)
                log(f"profile ssd_scan_bwd {name} {dn}: launches us "
                    f"{r['launch_us']}")
            rows[f"ssd_scan_bwd_{name}"] = r
            shown = {k: (f"{e:.3e}", f"{sc:.3e}") for k, (e, sc) in
                     errs.items()}
            log(f"kernel ssd_scan_bwd {name} {dn} {r['shape']}: grads "
                f"(max_abs_err, max|ref|) {shown} "
                f"bound {SSD_BWD_BOUNDS[dn]} of max|ref| "
                f"{'ok' if r['ok'] else 'MISMATCH'} kernel_ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} library_ms=none "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"achieved={r['achieved']} repeat_identical={same}")
            del x, dt, A, B, C, D, h0, dh, dy, kept
            gc.collect()
            torch.cuda.empty_cache()
        results[dn] = rows
        bad = [n for n, r in rows.items() if not r["ok"]]
        if bad:
            raise SystemExit(f"kernel phase: {bad} disagree with their plain "
                             f"versions in {dn}")
    return results


def ssm_train_flops(cfg, B, S):
    """Model flops of one train step of an SSM or a hybrid (MFU's
    numerator): 3 x the forward (as `train_flops`; remat's recompute not
    counted), the forward being 2 flops per matmul parameter per token
    (each mamba layer's wz, wx, wB, wC, wdt and out_proj; the hybrid's
    shared block once per application; the lm_head or the tied embedding)
    plus the SSD scan's products in every layer (`ssd_flops_bytes`) and
    the shared block's causal attention. The depthwise conv and the norms
    are not products."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    gn = s.ngroups * s.state_dim
    n_mm = cfg.num_layers * (d * (2 * d_in + 2 * gn + nh) + d_in * d) \
        + d * cfg.vocab_size
    scan = cfg.num_layers * ssd_flops_bytes(
        B, S, nh, s.head_dim, s.ngroups, s.state_dim, min(s.chunk_size, S),
        2)[0]
    attn = 0.0
    if cfg.hybrid_attn_every:
        apps = cfg.num_layers // cfg.hybrid_attn_every
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n_mm += apps * (d * (H + 2 * Hkv) * hd + H * hd * d
                        + 3 * d * cfg.d_ff)
        attn = apps * B * S * 4 * H * hd * (S + 1) / 2
    return 3 * (2 * B * S * n_mm + scan + attn), n_mm


def zamba_train_config():
    """zamba2-7b at full width with its depth cut to ZAMBA_TRAIN_LAYERS."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2-7b"),
                               num_layers=ZAMBA_TRAIN_LAYERS,
                               name=f"zamba2-7b-{ZAMBA_TRAIN_LAYERS}l")


def ssm_train_phase():
    """15b-15c. mamba2-2.7b at full width and depth, then zamba2-7b at full
    width and ZAMBA_TRAIN_LAYERS layers, through `train_step_phase`: one
    step against the plain versions (TRAIN_BOUNDS) with each family's
    launches, 5 timed steps and a profile."""
    from repro_torch.configs import get_config
    mcfg = get_config("mamba2-2.7b")
    L = mcfg.num_layers
    out = {}
    out["mamba2"], path = train_step_phase(
        mcfg, want={"ssd_scan": 2 * L, "ssd_scan_bwd": L}, prepare=None,
        flops_fn=ssm_train_flops, B=SSM_TRAIN_B, S=SSM_TRAIN_S,
        f32_check=True)
    zcfg = zamba_train_config()
    Lz, apps = zcfg.num_layers, zcfg.num_layers // zcfg.hybrid_attn_every
    grouped = apps * zcfg.hybrid_attn_every     # mamba blocks in the groups
    # remat as JAX's: each group is one checkpoint over its blocks' own,
    # so a grouped block scans 3 times (forward, the group's recompute,
    # its own), a tail block once; the shared block runs twice
    out["zamba2"], _ = train_step_phase(
        zcfg, want={"ssd_scan": Lz + 2 * grouped, "ssd_scan_bwd": Lz,
                    "flash_prefill": 2 * apps, "flash_prefill_bwd": apps},
        prepare=lambda p, c: scale_attention(p["shared"]["attn"], c),
        flops_fn=ssm_train_flops, B=SSM_TRAIN_B, S=SSM_TRAIN_S,
        f32_check=True)
    return out, path


def ssm_launcher_phase():
    """15d. `python -m repro_torch.launch.train --arch mamba2-2.7b-smoke
    --steps 10 --remat` on the card: 10 finite losses, exit 0."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "mamba2-2.7b-smoke", "--steps", "10", "--remat"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    secs = time.perf_counter() - t0
    losses = [float(ln.split()[4]) for ln in r.stdout.splitlines()
              if ln.startswith("[train] step ")]
    log(f"train launcher mamba2-2.7b-smoke --remat on the card: "
        f"{len(losses)} steps in {secs:.1f}s, loss "
        f"{losses[0] if losses else float('nan'):.4f} -> "
        f"{losses[-1] if losses else float('nan'):.4f}")
    if r.returncode != 0 or len(losses) != 10 or \
            not all(map(math.isfinite, losses)):
        raise SystemExit(f"train: the launcher failed on mamba2-2.7b-smoke:"
                         f"\n{r.stdout}{r.stderr}")
    return dict(seconds=secs, losses=losses)


# ---------------------------------------------------------------------------

def ptxas_summary(build_log: Path) -> str:
    """Registers per kernel instance and the instances that spill, from
    the `-Xptxas -v` output of the build (absent when a fresh library was
    reused)."""
    if not build_log.exists():
        return "ptxas: no build log (library reused)"
    regs, spills, entry = [], [], ""
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and "Used" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
        elif "spill stores" in line and not line.strip().endswith(
                "0 bytes spill stores, 0 bytes spill loads"):
            spills.append(f"{entry}: {line.strip()}")
    return (f"ptxas: {len(regs)} kernel instances, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, "
            f"{len(spills)} spilling" + "".join(f"\n  {s}" for s in spills))


# phase 16 (a): the dry-run's cells (arch, shape, multi_pod)
DRYRUN_CELLS = (("yi-6b", "train_4k", False), ("yi-6b", "prefill_32k", False),
                ("yi-6b", "decode_32k", False), ("yi-6b", "decode_32k", True),
                ("moonshot-v1-16b-a3b", "prefill_32k", False),
                ("mixtral-8x22b", "prefill_32k", False),
                ("mamba2-2.7b", "long_500k", False),
                # the remat structure (hybrid groups, encoder-decoder
                # without remat) shows in a train step's dot flops
                ("zamba2-7b", "train_4k", False),
                ("seamless-m4t-large-v2", "train_4k", False))


def dryrun_cell(cell):
    """One cell of `DRYRUN_CELLS` through `lower_cell`, in a process of
    its own (host work on fake tensors: the card stays idle)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import lower_cell
    arch, shape, mp = cell
    t0 = time.perf_counter()
    rec = lower_cell(arch, shape, multi_pod=mp)
    rec.pop("collective_ops", None)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


DRYRUN_WORKERS = 3      # processes: zamba2-7b's cell alone is ~2 min


def dryrun_phase():
    """Phase 16 (a): each cell of `DRYRUN_CELLS` through `lower_cell` on
    the fake mesh, `DRYRUN_WORKERS` cells at a time (each in a spawned
    process with its own fake process group); its dot flops against
    JAX's where the committed file holds the cell."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    jax_flops = json.loads((ROOT / "tests" / "torch_dryrun_jax_flops.json")
                           .read_text())["dot_flops"]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            DRYRUN_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        # the longest cells first, so that they do not start last
        order = sorted(range(len(DRYRUN_CELLS)),
                       key=lambda i: DRYRUN_CELLS[i][0] != "zamba2-7b")
        futs = {i: pool.submit(dryrun_cell, DRYRUN_CELLS[i]) for i in order}
        recs = [futs[i].result() for i in range(len(DRYRUN_CELLS))]
    log(f"dryrun: {len(recs)} cells in {time.perf_counter() - t0:.1f}s "
        f"({DRYRUN_WORKERS} processes)")
    out, bad = [], []
    for (arch, shape, mp), rec in zip(DRYRUN_CELLS, recs):
        secs = rec["wall_s"]
        flops = rec["cost_corrected"]["dot_flops"]
        want = jax_flops.get(f"{arch}/{shape}")
        coll = {k: f"{v / 1e9:.3f}GB"
                for k, v in rec["collectives"]["by_kind"].items()}
        log(f"dryrun {arch} x {shape} {'pod2' if mp else 'pod1'}: "
            f"{rec['status']} in {secs:.1f}s, dot_flops {flops} (JAX "
            f"{want if want is not None else 'not in the file'}), "
            f"collectives {coll} ici "
            f"{rec['collectives']['ici_bytes'] / 1e9:.3f}GB dcn "
            f"{rec['collectives']['dcn_bytes'] / 1e9:.3f}GB, per-rank peak "
            f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB (arguments "
            f"{rec['memory']['argument_bytes'] / 2**30:.2f}), fallbacks "
            f"{rec['fallbacks']}")
        if rec["status"] != "ok" or (want is not None and flops != want):
            bad.append(f"{arch}/{shape}")
        out.append(rec)
    if bad:
        raise SystemExit(f"dryrun: {bad} failed or differ from JAX")
    return out


def seq_sharded_decode_phase():
    """16c. `models/sharded.py::decode_attend` with the cache split 4 ways
    along its sequence, on 4 gloo ranks over CUDA tensors of this card
    (`tests/torch_sharded_worker.py decode_cuda`): each rank runs
    `paged_insert` and `paged_decode` over its shard, the ranks combine by
    the kernel's log-sum-exp. Held to the unsharded kernel: f32 and bf16
    within `TOL`, the written caches bit for bit."""
    import os
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_sharded_worker import decode_cuda_expected, decode_cuda_inputs
    work = ROOT / "build" / "seq_decode"
    work.mkdir(parents=True, exist_ok=True)
    (work / "gloo_store").unlink(missing_ok=True)
    d = decode_cuda_inputs()
    np.savez(work / "in.npz", **d)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_worker.py"),
         str(work / "in.npz"), str(work / "out.npz"), "decode_cuda"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"seq-sharded decode: the 4 ranks failed "
                         f"(rc {r.returncode}):\n{r.stderr[-3000:]}")
    out = dict(np.load(work / "out.npz"))
    res, ok = {"placements": list(out["cu_placements"]), "seconds": secs}, \
        "Shard(dim=1)" in list(out["cu_placements"])
    for dn, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        want, kc, vc = decode_cuda_expected(d, dtype, "cuda")
        got = torch.from_numpy(out[f"cu_{dn}_o"]).cuda()
        err, good = max_err(got, want, dtype_name(dtype))
        same = bool(np.array_equal(out[f"cu_{dn}_kc"],
                                   kc.float().cpu().numpy())
                    and np.array_equal(out[f"cu_{dn}_vc"],
                                       vc.float().cpu().numpy()))
        res[dn] = dict(max_abs_err=err, ok=good, caches_equal=same)
        ok = ok and good and same
    log(f"seq-sharded decode on the card: 4 gloo ranks over CUDA tensors, "
        f"Smax 256 split 4 ways ({res['placements']}), rows on ranks 0 "
        f"and 2, rank 3 without a live key; against the unsharded kernel "
        f"f32 {res['f32']} bf16 {res['bf16']} in {secs:.1f}s "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("seq-sharded decode differs from the unsharded "
                         "kernel")
    return res


def serve_metrics_phase():
    """Phase 16 (b): `diagnose --serve-metrics` at full yi-6b width on the
    card against the yi-6b-smoke run's metric names on the CPU."""
    import re
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.diagnose import serve_metrics

    def parse(text):
        return {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^([a-zA-Z_]\w*) ([-0-9.e+infa]+)$", text, re.M)}
    cpu_text = serve_metrics("yi-6b-smoke", device="cpu", echo=False)
    cpu = parse(cpu_text)
    reset_launch_counts()
    t0 = time.perf_counter()
    text = serve_metrics("yi-6b", device="cuda", echo=False)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    for line in text.splitlines():
        if not line.startswith("#"):
            log(f"metrics {line}")
    got = parse(text)
    fin, shed = (got.get(f"repro_requests_{k}", 0)   # a counter at 0 is
                 for k in ("finished", "shed"))       # not exported
    done = fin + shed

    def names(m):
        # a replica that served no request has no latency histograms, and
        # which replica serves what depends on the clock: compare the
        # names with the replica's number taken out
        return {re.sub(r"replica\d+", "replicaN", k) for k in m}
    # a counter is exported once it counts: one that counted on one side
    # only (requests shed by the router, which depends on the clock) is
    # zero on the other
    counters = {re.sub(r"replica\d+", "replicaN", m) for m in re.findall(
        r"^# TYPE (\S+) counter$", text + cpu_text, re.M)}
    same = not ((names(got) ^ names(cpu)) - counters)
    log(f"serve-metrics yi-6b x2 replicas on the card: {secs:.1f}s, "
        f"finished {fin:.0f} + shed {shed:.0f} = {done:.0f} of 10; "
        f"{len(got)} metrics ({len(cpu)} on the CPU), names equal to the "
        f"CPU run's but for counters that counted on one side only {same} "
        f"(only on the card: "
        f"{sorted(names(got) - names(cpu))}, only on the CPU: "
        f"{sorted(names(cpu) - names(got))}); launches {launches}")
    if done != 10 or not same or \
            not launches["flash_prefill"] or not launches["paged_decode"]:
        raise SystemExit("serve-metrics: requests lost, metric names off, "
                         "or an attention kernel never launched")
    return {"seconds": secs, "metrics": got, "launches": launches}


def init_params(cfg, dtype=None):
    """Random weights of `cfg` on the card, from seed 0, drawn in f32 and
    stored in `dtype` (default f32; a bf16 model is drawn a layer at a
    time, never whole in f32)."""
    import torch
    from repro_torch.models.api import build_model
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, "cuda", dtype=dtype)
    torch.cuda.synchronize()
    log(f"init {cfg.name} {dtype_name(dtype)} params on the card: "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    return params


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.configs import get_config
    from repro_torch.core.kv_transfer import kv_bytes
    from repro_torch.kernels.build import BUILD_DIR, build_seconds, library
    library()
    log(f"build: {build_seconds():.1f}s ({BUILD_DIR})")
    log(ptxas_summary(BUILD_DIR / "build.log"))

    record = {"device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()},
              "nvidia_smi": smi, "build_s": build_seconds()}
    cfg = get_config("yi-6b")
    mcfg = get_config("mamba2-2.7b")
    gcfg = get_config("gemma3-1b")
    dtypes = (torch.float32, torch.bfloat16)
    record["kernels"] = kernel_phase(cfg, dtypes)
    for dn, rows in ssd_kernel_phase(mcfg, dtypes).items():
        record["kernels"][dn].update(rows)
    zcfg = get_config("zamba2-7b")
    for dn, rows in wide_kernel_phase(gcfg, zcfg, dtypes).items():
        record["kernels"][dn].update(rows)
    for dn, rows in ssd_kernel_phase(
            zcfg, dtypes, (("ssd_scan_zamba2_s1536", 1536, 256),)).items():
        record["kernels"][dn].update(rows)
    for dn, rows in family_kernel_phase(dtypes).items():
        record["kernels"][dn].update(rows)

    # -- yi-6b: the paged path ---------------------------------------------
    params = init_params(cfg)
    record["serve"] = serve_phase(cfg, params, prefix_cache=True,
                                  chunk_tokens=512)
    record["check_tokens"] = smoke_tokens_check("yi-6b-smoke",
                                                prefix_cache=True,
                                                chunk_tokens=16)
    record["profile_yi"] = yi_profile(cfg, params)
    record["check_logits"] = logits_check(cfg, params)
    del params                  # one model's weights on the card at a time
    gc.collect()
    torch.cuda.empty_cache()

    # -- mamba2-2.7b: the dense state slab ---------------------------------
    params = init_params(mcfg)
    record["serve_mamba"] = serve = serve_phase(mcfg, params)
    want_launches = serve["submitted"] * mcfg.num_layers
    want_bytes = serve["submitted"] * kv_bytes(mcfg, 0)
    log(f"serve {mcfg.name}: ssd_scan launches {serve['launches']['ssd_scan']}"
        f" (expected {want_launches}: one per prefill layer), state bytes "
        f"migrated {serve['kv_bytes_migrated']} (expected {want_bytes})")
    if serve["launches"]["ssd_scan"] != want_launches or \
            serve["kv_bytes_migrated"] != want_bytes:
        raise SystemExit("serve: mamba2-2.7b launches or bytes are off")
    record["check_tokens_mamba"] = smoke_tokens_check("mamba2-2.7b-smoke")
    record["check_mamba"] = mamba_check(mcfg, params)
    record["profile_mamba"] = mamba_profile(mcfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- gemma3-1b: the transformer's dense slab ---------------------------
    params = init_params(gcfg)
    record["serve_gemma"] = serve = serve_phase(gcfg, params)
    gemma_serve_counts(gcfg, serve)
    record["check_tokens_gemma"] = smoke_tokens_check("gemma3-1b-smoke")
    record["check_tokens_yi_slab"] = smoke_tokens_check("yi-6b-smoke",
                                                        paged=False)
    record["check_gemma"] = gemma_check(gcfg, params)
    record["profile_gemma"] = gemma_profile(gcfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- the planning stack and the launcher: yi-6b at full width ---------
    record["fit"] = fit_phase(cfg)
    params = init_params(cfg)
    record["launch"], spec, placement = plan_serve_phase(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    record["charged"] = charged_phase(cfg, params, spec, placement)
    gc.collect()
    torch.cuda.empty_cache()
    record["router"] = router_phase(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- the remaining families: MoE, hybrid, encoder-decoder, VLM ----------
    record["moonshot"] = moonshot_phase(get_config("moonshot-v1-16b-a3b"),
                                        record["serve"])
    record["zamba2"] = zamba_phase(zcfg)
    record["facade"] = facade_phase(get_config("seamless-m4t-large-v2"),
                                    get_config("internvl2-76b"))

    # -- training: yi-6b at full width, 8 layers ----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    for dn, rows in train_kernel_phase(dtypes).items():
        record["kernels"][dn].update(rows)
    record["train"], train_path = train_step_phase(train_config())
    record["train_restart"] = restart_phase(train_config())
    record["train_launcher"] = launcher_phase()

    # -- training the SSM families: mamba2-2.7b, zamba2-7b ------------------
    gc.collect()
    torch.cuda.empty_cache()
    for dn, rows in ssd_bwd_kernel_phase(dtypes).items():
        record["kernels"][dn].update(rows)
    record["train_ssm"], mamba_train_path = ssm_train_phase()
    record["train_ssm_launcher"] = ssm_launcher_phase()

    # -- the sharding vocabulary: dry-run cells, serve metrics -------------
    gc.collect()
    torch.cuda.empty_cache()
    record["dryrun"] = dryrun_phase()
    record["serve_metrics"] = serve_metrics_phase()
    record["seq_sharded_decode"] = seq_sharded_decode_phase()

    serves = {"yi-6b": record["serve"], "mamba2-2.7b": record["serve_mamba"],
              "gemma3-1b": record["serve_gemma"],
              "launch.serve": record["launch"], "router": record["router"],
              "moonshot-v1-16b-a3b": record["moonshot"]["serve"],
              "zamba2-7b": record["zamba2"]["serve"],
              "seamless-m4t-large-v2":
                  record["facade"]["seamless"]["float32"],
              "train": train_path, "train-mamba2": mamba_train_path}
    rows = []
    for name, kern, path, row, *dt in SUMMARY:
        src, replaces = SOURCES[kern]
        r = record["kernels"][dt[0] if dt else "float32"][row]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": serves[path]["launches"][kern],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": rows}))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(smi)
    print(json.dumps({"ok": True, "device": record["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
