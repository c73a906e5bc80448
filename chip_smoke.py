#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no phase's error is caught):

1. build: print the card's name and power limit, turn TF32 off, build the
   CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a) and time it.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at yi-6b shapes, in f32 and bf16, and time kernel, plain version and a
   PyTorch library call that computes the same function (a yardstick the
   port never calls).
3. serve: `DisaggCluster` at full yi-6b width (random f32 weights from a
   seed, shared by both engines) serves a trace of 8 requests, some
   sharing a system prompt, with the prefix cache and 512-token chunked
   prefill. Every kernel's launch count is read from this run.
4. check: (a) on yi-6b-smoke, the disaggregated cluster on the card gives
   the same greedy f32 tokens as the same cluster on the CPU, where every
   kernel is its plain version; (b) a bf16 yi-6b model, teacher-forced over
   one prompt (a flash_prefill chunk, a prefix_prefill chunk) and 8 decode
   steps, gives the same logits through the kernels as through the plain
   versions, within a stated bound (with the attention projections at
   standard scales; see `standard_attention_scales`). The same comparison
   in f32 at the serving weights is printed for information.

The last line of standard output is `{"ok": true, "device": {...}}`. The
full record also goes to `chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

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
}
# whole-model bf16 check: kernel-path logits within this fraction of the
# plain path's largest |logit|. Both paths run the same bf16 matmuls; they
# differ only in where attention rounds to bf16 and in the f32 summation
# order, which drifts through 32 layers. A wrong kernel gives O(1)
# relative differences.
LOGIT_BOUND = 0.1


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref, dtype_name):
    import torch
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    tol = TOL[dtype_name]
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

def kernel_phase(cfg, dtypes):
    import torch
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from repro_torch.kernels.paged_decode.kernel import (paged_decode,
                                                         paged_insert)
    from repro_torch.kernels.paged_decode.ref import (paged_decode_ref,
                                                      paged_insert_ref)
    from repro_torch.kernels.prefix_prefill.kernel import prefix_prefill
    from repro_torch.kernels.prefix_prefill.ref import prefix_prefill_ref

    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page = 16
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    results = {}
    for dtype in dtypes:
        dn = str(dtype).split(".")[-1]
        es = torch.empty((), dtype=dtype).element_size()
        rows = {}

        # -- paged_decode: B=8, context 1024 (ragged), page 16 -------------
        B, ctx = 8, 1024
        pps = ctx // page
        num_pages = B * pps + 1
        q = randn(B, H, hd, dtype=dtype)
        kp = randn(num_pages, page, Hkv, hd, dtype=dtype)
        vp = randn(num_pages, page, Hkv, hd, dtype=dtype)
        perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
        table = perm.reshape(B, pps).to(torch.int32)
        lens = torch.tensor([ctx - 37 * i for i in range(B)],
                            dtype=torch.int32, device=dev)
        out = paged_decode(q, kp, vp, table, lens)
        ref = paged_decode_ref(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        n_ctx = int(lens.sum())
        nbytes = (2 * B * H * hd * es + 2 * n_ctx * Hkv * hd * es
                  + table.numel() * 4 + B * 4)
        flops = 4 * n_ctx * H * hd
        pos = torch.arange(pps * page, device=dev)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]

        def lib_decode():
            ks = kp[table.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
            vs = vp[table.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
            return sdpa(q[:, :, None], ks, vs, mask=mask)
        rows["paged_decode"] = dict(
            shape=f"B={B} ctx<={ctx} page={page} H={H} Hkv={Hkv} hd={hd}",
            max_abs_err=err, ok=ok,
            ms=time_ms(lambda: paged_decode(q, kp, vp, table, lens)),
            plain_ms=time_ms(lambda: paged_decode_ref(q, kp, vp, table,
                                                      lens)),
            library_ms=time_ms(lib_decode),
            library="page gather + scaled_dot_product_attention",
            bytes=nbytes, flops=flops)

        # -- paged_insert: one token per sequence, byte-exact ------------
        kn = randn(B, Hkv, hd, dtype=dtype)
        vn = randn(B, Hkv, hd, dtype=dtype)
        pidx = table[:, 5].contiguous()                    # distinct pages
        off = torch.arange(B, dtype=torch.int32, device=dev) % page
        k1, v1 = kp.clone(), vp.clone()
        k2, v2 = kp.clone(), vp.clone()
        paged_insert(k1, v1, kn, vn, pidx, off)
        paged_insert_ref(k2, v2, kn, vn, pidx, off)
        torch.cuda.synchronize()
        exact = bool(torch.equal(k1, k2) and torch.equal(v1, v2))
        nbytes = 4 * B * Hkv * hd * es + 2 * B * 4
        li, lo = pidx.long(), off.long()

        def lib_insert():
            k1.index_put_((li, lo), kn)
            v1.index_put_((li, lo), vn)
        rows["paged_insert"] = dict(
            shape=f"B={B} page={page} Hkv={Hkv} hd={hd}",
            max_abs_err=float((k1.float() - k2.float()).abs().max()),
            ok=exact,
            ms=time_ms(lambda: paged_insert(k1, v1, kn, vn, pidx, off)),
            plain_ms=time_ms(lambda: paged_insert_ref(k2, v2, kn, vn, pidx,
                                                      off)),
            library_ms=time_ms(lib_insert), library="index_put_ (K and V)",
            bytes=nbytes, flops=0)
        del k1, v1, k2, v2

        # -- prefix_prefill: a 512-token suffix over a 1024-token prefix -
        Sq, P = 512, 1024
        npp = P // page
        qs = randn(1, H, Sq, hd, dtype=dtype)
        ksf = randn(1, Hkv, Sq, hd, dtype=dtype)
        vsf = randn(1, Hkv, Sq, hd, dtype=dtype)
        ptab = table[:1, :npp].contiguous()
        plens = torch.tensor([P], dtype=torch.int32, device=dev)
        out = prefix_prefill(qs, ksf, vsf, kp, vp, ptab, plens)
        ref = prefix_prefill_ref(qs, ksf, vsf, kp, vp, ptab, plens)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        pairs = Sq * P + Sq * (Sq + 1) // 2
        nbytes = (2 * H * Sq * hd * es + 2 * Hkv * Sq * hd * es
                  + 2 * P * Hkv * hd * es + npp * 4 + 4)
        kpos = torch.arange(P + Sq, device=dev)
        qpos = torch.arange(Sq, device=dev)
        pmask = (kpos[None, :] <= P + qpos[:, None])[None, None]

        def lib_prefix():
            kk = kp[ptab[0].long()].reshape(P, Hkv, hd).transpose(0, 1)[None]
            vv = vp[ptab[0].long()].reshape(P, Hkv, hd).transpose(0, 1)[None]
            return sdpa(qs, torch.cat([kk, ksf], 2), torch.cat([vv, vsf], 2),
                        mask=pmask)
        rows["prefix_prefill"] = dict(
            shape=f"Sq={Sq} prefix={P} page={page} H={H} Hkv={Hkv} hd={hd}",
            max_abs_err=err, ok=ok,
            ms=time_ms(lambda: prefix_prefill(qs, ksf, vsf, kp, vp, ptab,
                                              plens)),
            plain_ms=time_ms(lambda: prefix_prefill_ref(
                qs, ksf, vsf, kp, vp, ptab, plens), iters=5),
            library_ms=time_ms(lib_prefix),
            library="page gather + concat + scaled_dot_product_attention",
            bytes=nbytes, flops=4 * pairs * H * hd)

        # -- flash_prefill: S=1024, causal --------------------------------
        S = 1024
        qf = randn(1, H, S, hd, dtype=dtype)
        kf = randn(1, Hkv, S, hd, dtype=dtype)
        vf = randn(1, Hkv, S, hd, dtype=dtype)
        out = flash_prefill(qf, kf, vf, causal=True)
        ref = flash_prefill_ref(qf, kf, vf, causal=True)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, dn)
        rows["flash_prefill"] = dict(
            shape=f"S={S} causal H={H} Hkv={Hkv} hd={hd}",
            max_abs_err=err, ok=ok,
            ms=time_ms(lambda: flash_prefill(qf, kf, vf, causal=True)),
            plain_ms=time_ms(lambda: flash_prefill_ref(qf, kf, vf,
                                                       causal=True),
                             iters=5),
            library_ms=time_ms(lambda: sdpa(qf, kf, vf, causal=True)),
            library="scaled_dot_product_attention(is_causal=True)",
            bytes=(2 * H * S * hd + 2 * Hkv * S * hd) * es,
            flops=4 * (S * (S + 1) // 2) * H * hd)

        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], dn)
            log(f"kernel {name:14s} {dn:8s} {r['shape']}: "
                f"max_abs_err={r['max_abs_err']:.3e} "
                f"{'ok' if r['ok'] else 'MISMATCH'} "
                f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
        results[dn] = rows
        bad = [n for n, r in rows.items() if not r["ok"]]
        if bad:
            raise SystemExit(f"kernel phase: {bad} disagree with their plain "
                             f"versions in {dn}")
    return results


# ---------------------------------------------------------------------------
# phase 3: disaggregated serving at full yi-6b width
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


def serve_phase(cfg, params):
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.cluster import DisaggCluster

    dc = DisaggCluster(cfg, params, n_prefill=1, n_decode=1, max_batch=8,
                       max_len=2048, prefix_cache=True, chunk_tokens=512)
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
               wall_s=wall, launches=counts)
    log(f"serve yi-6b f32: served={len(res)}/{len(reqs)} "
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
    zero = [k for k, v in counts.items() if v <= 0]
    if zero:
        raise SystemExit(f"serve: kernels never launched on the main path: "
                         f"{zero}")
    del dc
    return out


# ---------------------------------------------------------------------------
# phase 4: checks against the plain versions
# ---------------------------------------------------------------------------

def smoke_tokens_check():
    """yi-6b-smoke: the disaggregated cluster on the card (kernels) and on
    the CPU (plain versions) give the same greedy f32 tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.workload import Request
    from repro_torch.models.api import build_model
    from repro_torch.serving.cluster import DisaggCluster

    cfg = get_config("yi-6b-smoke")
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    toks = {}
    for dev in ("cuda", "cpu"):
        # fresh requests per run: a run fills in their lifecycle fields
        reqs = [Request(i, i * 0.01, 10 + (i % 4) * 7, 6) for i in range(6)]
        dc = DisaggCluster(cfg, params, n_prefill=1, n_decode=1,
                           max_batch=4, max_len=64, prefix_cache=True,
                           chunk_tokens=16, device=dev)
        toks[dev] = {rid: r.tokens for rid, r in dc.run(reqs).items()}
    same = toks["cuda"] == toks["cpu"]
    log(f"check yi-6b-smoke f32 tokens, card vs CPU plain versions: "
        f"{'identical' if same else 'DIFFER'} over {len(reqs)} requests")
    if not same:
        raise SystemExit("check: card tokens differ from the CPU reference")
    return dict(requests=len(reqs), identical=same)


def teacher_force(eng, tokens, n_first, n_prompt, plain):
    """On a fresh cache of `eng` (batch 1): prefill `tokens[:n_first]`
    from scratch (flash_prefill), then `tokens[n_first:n_prompt]` over the
    pool pages (prefix_prefill), then one decode step (paged_insert +
    paged_decode) per remaining token. `plain=True` runs the plain
    versions instead of the kernels. Returns every stage's logits in
    f32."""
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
    from repro_torch.kernels.build import BUILD_DIR, build_seconds, library
    library()
    log(f"build: {build_seconds():.1f}s ({BUILD_DIR})")
    log(ptxas_summary(BUILD_DIR / "build.log"))

    record = {"device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()},
              "nvidia_smi": smi, "build_s": build_seconds()}
    cfg = get_config("yi-6b")
    record["kernels"] = kernel_phase(cfg, (torch.float32, torch.bfloat16))
    from repro_torch.models.api import build_model
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, "cuda")
    torch.cuda.synchronize()
    log(f"init yi-6b f32 params on the card: "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    record["serve"] = serve_phase(cfg, params)
    record["check_tokens"] = smoke_tokens_check()
    record["check_logits"] = logits_check(cfg, params)

    launches = record["serve"]["launches"]
    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = record["kernels"]["float32"][name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches.get(name, 0),
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
