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
   `paged_decode` and `prefix_prefill`.
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

The last line of standard output is `{"ok": true, "device": {...}}`. The
full record also goes to `chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

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
}
# the kernels each served path runs (their launches are read from its run)
PATHS = {"yi-6b": ("paged_decode", "paged_insert", "prefix_prefill",
                   "flash_prefill"),
         "mamba2-2.7b": ("ssd_scan",),
         "gemma3-1b": ("flash_prefill", "paged_decode", "paged_insert")}
# the summary line's rows: (name, kernel, path, kernel-phase row)
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
            "paged_insert_gemma3_b8")]
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
            dtype, 8, 128, [1532, 1100, 903, 640, 517, 300, 200, 33],
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
            dtype, 8, 128, [1532, 1100, 903, 640, 517, 300, 200, 33])
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
            dtype, 8, 128, [1532, 1100, 903, 640, 517, 300, 200, 33],
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


def ssd_kernel_phase(cfg, dtypes):
    """`ssd_scan` at the mamba2-2.7b main path's shapes: a 2048-token
    prefill (8 chunks of 256), the traced 1536-token prefill (6 chunks)
    and a 200-token prompt (one ragged chunk of 200); two identical calls
    must give identical bits. Inputs have the distributions of the JAX sweep
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
        for key, S, Q in (("ssd_scan", 2048, 256),
                          ("ssd_scan_s1536", 1536, 256),
                          ("ssd_scan_ragged", 200, 200)):
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


def serve_phase(cfg, params, **cluster_kw):
    """Serve `serve_trace` through `DisaggCluster` (1 prefill + 1 decode
    engine, 8 slots, max_len 2048, plus `cluster_kw`); the launch counts
    are set to 0 just before and read just after. Fails unless every
    request finishes well formed and every kernel of this model's path
    (`PATHS`) launched. Also records the decode engine's steps and the
    sizes (`Engine.kv_blob_bytes`) of the blobs whole-prompt prefills
    returned."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.cluster import DisaggCluster

    dc = DisaggCluster(cfg, params, n_prefill=1, n_decode=1, max_batch=8,
                       max_len=2048, **cluster_kw)
    pre = dc.prefill[0]
    blob_bytes = []

    def prefill_request(seq, _run=pre.prefill_request):
        first, blob, dt = _run(seq)
        blob_bytes.append(pre.kv_blob_bytes(blob))
        return first, blob, dt
    pre.prefill_request = prefill_request
    reqs = serve_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = dc.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
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
               wall_s=wall, launches=counts,
               decode_steps=dc.decode[0].steps, blob_bytes=sum(blob_bytes))
    log(f"serve {cfg.name} f32: served={len(res)}/{len(reqs)} "
        f"finished={len(finished)} ttft_median={ttft:.4f}s "
        f"tpot_median={tpot:.4f}s (virtual clock) "
        f"kv_bytes_migrated={dc.tx.total_bytes} "
        f"prefix_hit_tokens={prefix_hits} wall={wall:.2f}s")
    log("kernels " + json.dumps(counts))
    for rid, r in sorted(res.items()):
        req = reqs[rid]
        if len(r.tokens) != req.in_len + req.out_len or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise SystemExit(f"serve: request {rid} came back malformed")
    if len(finished) != len(reqs):
        raise SystemExit("serve: not every request finished")
    zero = [k for k in PATHS[cfg.name] if counts[k] <= 0]
    if zero:
        raise SystemExit(f"serve: kernels never launched on the main path: "
                         f"{zero}")
    del dc
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
    import math as _m
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    for name, seg in params.items():
        if not name.startswith("seg"):
            continue
        a = seg["attn"]
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


def device_profile(fn, label):
    """Run `fn` once under `torch.profiler` (after one untimed run) and
    print its host wall time, the device's busy time (the sum of its
    kernels' durations) and idle share, and the kernels that took most
    time. For information; nothing is held to it."""
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            count[e.name] += 1
    n = sum(count.values())
    busy = sum(by_name.values())
    top = [(k[:60], round(v, 3)) for k, v in by_name.most_common(5)]
    # the port's own kernels, by the name of the op they serve
    ported = {op: round(sum(v for k, v in by_name.items() if op in k), 3)
              for op in SOURCES if any(op in k for k in by_name)}
    out = dict(wall_ms=wall_ms, device_busy_ms=busy, kernels=n,
               idle_share=1 - busy / wall_ms if wall_ms else None, top=top,
               ported_ms=ported, launches_by_kernel=dict(count))
    log(f"profile {label}: wall={wall_ms:.3f}ms device_busy={busy:.3f}ms "
        f"idle_share={out['idle_share']:.3f} kernels={n} top={top} "
        f"ported_ms={ported}")
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


def init_params(cfg):
    """Random f32 weights of `cfg` on the card, from seed 0."""
    import torch
    from repro_torch.models.api import build_model
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, "cuda")
    torch.cuda.synchronize()
    log(f"init {cfg.name} f32 params on the card: "
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
    for dn, rows in wide_kernel_phase(gcfg, get_config("zamba2-7b"),
                                      dtypes).items():
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

    serves = {"yi-6b": record["serve"], "mamba2-2.7b": record["serve_mamba"],
              "gemma3-1b": record["serve_gemma"]}
    rows = []
    for name, kern, path, row in SUMMARY:
        src, replaces = SOURCES[kern]
        r = record["kernels"]["float32"][row]
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
