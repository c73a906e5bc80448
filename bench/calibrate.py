"""Set a cell's frozen numbers on the card; run by hand, never by a run.

    python3 bench/calibrate.py limits  --workload <cell>
    python3 bench/calibrate.py sweep   --workload <cell> --rates 8,10,12 --seconds 20
    python3 bench/calibrate.py control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 10

`limits`: the unloaded prefill of the cell's p90 prompt and the unloaded
decode step at batch 64 with its median context (prompt median plus half
the output median), the TTFT and TPOT limits they give under the repo's
stringency rule for summarisation (`SLO_MULTS["longbench"]`, copied
here), and the decode page pool a deployment would size: 90% of the
card's memory less the weights, the prefill engine's peak at the
longest prompt and `blob_reserve` parked prompt caches.

`sweep`: the traffic at each rate (the limits taken from `limits` in
the same process when `--with-limits`), with attainment and the backlog
at the window's start and end: the knee is the highest rate at which at
least 90% meet both limits and the backlog does not grow.

`control`: per seed, the program's widest gap on a short window at the
cell's load, and on `--control-seeds` the float8 control's on the same
sample: the readings each check limit is set from.

`freeze`: from a file of `limits` and `sweep` readings (`--from`), write
the limits, the page pool and the knee into the cell's traffic file. The
knee is the highest rate of the sweep below which every rate met both
limits for 90% of its requests without a growing backlog (growth of at
most 2 requests plus 5% of the window's); where no rate met the limits,
the highest rate sustained without a growing backlog, noted in the file.

Each prints one JSON line per reading; `--out` appends them to a file.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    # one process serves many runs, each with a page pool of most of the
    # card: segments that grow and shrink keep the next pool placeable
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

# the repo's stringency rule (repro_torch/core/workload.py::SLO_MULTS):
# (TTFT x the p90 prompt's prefill, TPOT x the loaded decode step)
SLO_MULTS = {"longbench": (6.0, 1.6)}


def _emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def limits(cell, device, seed: int = 0) -> dict:
    import numpy as np
    import torch
    from repro_torch.serving.engine import Engine, Sequence

    from bench import traffic as tr
    from bench.model import DTYPES
    M = cell.model
    T, C = cell.traffic, cell.traffic["cluster"]
    cfg = M.model_config(cell.config)
    dtype = DTYPES[cell.config["torch_dtype"]]
    V = cell.config["vocab_size"]
    cuda = torch.device(device).type == "cuda"
    params = M.draw_weights(cell.config, seed, device)
    w_alloc = torch.cuda.memory_allocated() if cuda else 0
    kw = dict(max_len=C["max_len"], page_size=C["page_size"], dtype=dtype,
              device=device)
    pre = Engine(cfg, params, max_batch=1, **kw)
    rid = [0]

    def seq(n, out_len=64):
        rid[0] += 1
        return Sequence(rid[0], tr.prompt_tokens(seed, rid[0], n, V),
                        out_len)

    def prefill_s(n, reps):
        ts = []
        for _ in range(reps):
            _, blob, dt = pre.prefill_request(seq(n))
            ts.append(dt)
            del blob
        return ts

    p90 = tr.quantile_len(T["prompt"], tr.Z90)
    longest = T["prompt"]["clip"][1]
    prefill_s(p90, 2)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prefill_s(longest, 2)
    prefill_peak = torch.cuda.max_memory_allocated() - w_alloc if cuda else 0
    t_pre = prefill_s(p90, 7)

    # decode at batch 64, each member at the median context
    ctx = int(np.exp(T["prompt"]["mu"])) + int(np.exp(T["output"]["mu"])) // 2
    n_dec = min(64, C["max_batch"])   # the rule's batch (tiny test cells: less)
    pages = n_dec * (-(-(ctx + 64) // C["page_size"])) + 1
    dec = Engine(cfg, params, max_batch=C["max_batch"], num_pages=pages, **kw)
    members = []
    for _ in range(n_dec):
        s = seq(ctx)
        first, blob, _ = pre.prefill_request(s)
        s.append_token(first)
        dec.insert_kv(s, blob)
        members.append(s)
        del blob
    for _ in range(3):
        dec.decode_step(members)
    t_dec = [dec.decode_step(members) for _ in range(20)]
    ttft_m, tpot_m = SLO_MULTS[T["slo_rule"]]
    total = torch.cuda.get_device_properties(device).total_memory \
        if cuda else 0
    kv_tok = cfg.kv_bytes_per_token(dtype.itemsize)
    page_bytes = kv_tok * C["page_size"]
    reserve = C["blob_reserve"] * longest * kv_tok
    pool = int(0.9 * total) - M.weight_bytes(cell.config) - prefill_peak \
        - reserve
    return {
        "kind": "limits", "cell": cell.name,
        "card": torch.cuda.get_device_name(device) if cuda else "cpu",
        "p90_prompt": p90, "prefill_p90_s": statistics.median(t_pre),
        "prefill_p90_runs": t_pre, "median_context": ctx,
        "decode_b64_s": statistics.median(t_dec), "decode_b64_runs": t_dec,
        "ttft_s": ttft_m * statistics.median(t_pre),
        "tpot_s": tpot_m * statistics.median(t_dec),
        "total_bytes": total, "weights_bytes": M.weight_bytes(cell.config),
        "weights_alloc": w_alloc, "prefill_peak_bytes": prefill_peak,
        "blob_reserve_bytes": reserve, "page_bytes": page_bytes,
        "decode_num_pages": max(pool // page_bytes, 0),
        "decode_pool_bytes": max(pool // page_bytes, 0) * page_bytes,
        "seconds": time.perf_counter() - T_START,
    }


def sweep(cell, device, rates, seconds, seed, out):
    from bench import serve
    from bench.reduce import attained, percentile, tokens_in_window, tpot, ttft
    for rate in rates:
        t0 = time.perf_counter()
        run = serve.serve(cell, seed, seconds, False, device, t0, rate=rate)
        w = run.window
        tt = [ttft(run, r) for r in w]
        tp = [x for x in (tpot(r) for r in w) if x is not None]
        span = run.w1 - run.w0
        _emit({"kind": "sweep", "cell": cell.name, "rate": rate,
               "requests": len(w), "virtual_s": span, "wall_s": run.wall_s,
               "attainment": sum(attained(run, r) for r in w) / max(len(w), 1),
               "ttft_p50": percentile(tt, .5), "ttft_p90": percentile(tt, .9),
               "tpot_p50": percentile(tp, .5), "tpot_p90": percentile(tp, .9),
               "tokens_per_s": sum(tokens_in_window(run)) / span,
               "backlog": run.backlog, "setup_s": run.setup_s,
               "finished": sum(r.finished for r in w),
               "seconds": time.perf_counter() - t0}, out)
        del run


def control(cell, device, seeds, control_seeds, seconds, out):
    from bench import check, serve
    for seed in seeds:
        t0 = time.perf_counter()
        run = serve.serve(cell, seed, seconds, False, device, t0)
        reqs = check.sample(run, int(cell.traffic["check"]["sample_tokens"]))
        t1 = time.perf_counter()
        g = check.gaps(run, reqs, control=seed in control_seeds)
        _emit({"kind": "control", "cell": cell.name, "seed": seed,
               "requests": len(reqs),
               "served_tokens": sum(len(r.served) for r in reqs),
               "longest": max((r.in_len + r.out_len for r in reqs),
                              default=0),
               "window_requests": len(run.window), **g,
               "reference_s": time.perf_counter() - t1,
               "seconds": time.perf_counter() - t0}, out)
        del run


def sustained(rec) -> bool:
    start, end = rec["backlog"]
    return end - start <= 2 + 0.05 * rec["requests"]


def freeze(cell, readings):
    from bench.cell import BENCH
    lim = [r for r in readings if r["kind"] == "limits"
           and r["cell"] == cell.name][-1]
    sw = sorted((r for r in readings if r["kind"] == "sweep"
                 and r["cell"] == cell.name), key=lambda r: r["rate"])
    knee, rule = None, "attainment >= 0.9 and a steady backlog"
    for r in sw:
        if r["attainment"] < 0.9 or not sustained(r):
            break
        knee = r["rate"]
    if knee is None:
        rule = "no rate met the limits for 90%: the highest rate sustained"
        for r in sw:
            if not sustained(r):
                break
            knee = r["rate"]
    path = BENCH / "traffic" / f"{cell.name}.json"
    t = json.loads(path.read_text())
    t["knee_rps"] = knee
    t["knee_rule"] = rule
    t["limits"].update(ttft_s=lim["ttft_s"], tpot_s=lim["tpot_s"],
                       prefill_p90_s=lim["prefill_p90_s"],
                       decode_b64_s=lim["decode_b64_s"])
    t["cluster"].update(decode_num_pages=lim["decode_num_pages"],
                        decode_pool_bytes=lim["decode_pool_bytes"])
    path.write_text(json.dumps(t, indent=2) + "\n")
    return {"kind": "freeze", "cell": cell.name, "knee_rps": knee,
            "rule": rule}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("limits", "sweep", "control", "freeze"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ramp", type=float, default=None,
                    help="virtual seconds of ramp in place of the file's")
    ap.add_argument("--with-limits", action="store_true",
                    help="sweep under limits measured first in this process")
    ap.add_argument("--out", default="")
    ap.add_argument("--from", dest="src", default="")
    a = ap.parse_args()
    from bench.cell import load_cell
    cell = load_cell(a.workload)
    if a.what == "freeze":
        with open(a.src) as f:
            _emit(freeze(cell, [json.loads(x) for x in f if x.strip()]),
                  a.out)
        return
    cell.traffic = copy.deepcopy(cell.traffic)
    if a.ramp is not None:
        cell.traffic["ramp_s"] = a.ramp
    device = "cuda"
    ints = lambda s: [int(x) for x in s.split(",") if x]
    if a.what == "limits" or a.with_limits:
        rec = limits(cell, device)
        _emit(rec, a.out)
        cell.traffic["limits"].update(ttft_s=rec["ttft_s"],
                                      tpot_s=rec["tpot_s"])
        cell.traffic["cluster"]["decode_num_pages"] = rec["decode_num_pages"]
        import gc

        import torch
        gc.collect()
        torch.cuda.empty_cache()
    if a.what == "sweep":
        sweep(cell, device, [float(x) for x in a.rates.split(",")],
              a.seconds, a.seed, a.out)
    if a.what == "control":
        control(cell, device, ints(a.seeds), set(ints(a.control_seeds)),
                a.seconds, a.out)


if __name__ == "__main__":
    main()
