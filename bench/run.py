"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic goes through the port's `DisaggCluster` (1 prefill +
1 decode engine on one card, bf16, greedy), see `serve.py`. With
`--trace 0` the result carries the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, read from the port's tracer and from
`torch.profiler` over part of the window. Every run checks what it
served against the plain reference (`check.py`) and prints each number
compared beside its limit, last on standard error and last in the line.

Exits 2 without a CUDA device or with fewer than the cell asks for, and 3
if JAX or the JAX package was loaded; neither prints a result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the repo root and the port's sources, in place of this folder
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `repro_torch` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result(cell, run, trace: bool, numbers, correct: bool) -> dict:
    import torch
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda
              else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes),
              # beside the memory in use: the allocator's peak, which
              # holds the whole reserved page pool, and the decode pages
              # the traffic took at most, of the pool's
              "memory_allocated_peak_bytes": int(run.memory_allocated_bytes),
              "kv_pages_peak": run.kv_pages[0], "kv_pages": run.kv_pages[1]}
    window = run.window
    out = {"correct": bool(correct), "attempted": len(window),
           "failed": sum(1 for r in window if not r.finished),
           "metrics": metrics, "device": device}
    if trace and run.profile is not None and run.profile.stopped:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        out["breakdown"] = run.profile.breakdown()
    out["check"] = numbers
    return out


def summary(run) -> str:
    """The served numbers of every cell, whichever it reports."""
    from bench.reduce import (attained, percentile, tokens_in_window, tpot,
                              ttft)
    w = run.window
    tt = [ttft(run, r) for r in w]
    tp = [t for t in (tpot(r) for r in w) if t is not None]
    pre, out = tokens_in_window(run)
    span = max(run.w1 - run.w0, 1e-9)
    return (f"[bench] window: {len(w)} requests in {span:.3f} virtual s "
            f"({run.wall_s:.3f} wall s; offered {len(w) / span:.4g}/s, "
            f"nominal {run.rate:.4g}/s), "
            f"finished {sum(r.finished for r in w)}; TTFT p50/p90 "
            f"{percentile(tt, .5):.4f}/{percentile(tt, .9):.4f} s, TPOT "
            f"p50/p90 {percentile(tp, .5):.4f}/{percentile(tp, .9):.4f} s, "
            f"attainment {sum(attained(run, r) for r in w) / max(len(w), 1):.4f}; "
            f"tokens/s {(pre + out) / span:.1f} (prompt {pre}, output "
            f"{out}); waiting at window start/end {run.backlog[0]}/"
            f"{run.backlog[1]}; drain {run.drain_wall_s:.3f} wall s; "
            f"memory in use {run.memory_peak_bytes}, allocated "
            f"{run.memory_allocated_bytes} B; decode pages "
            f"{run.kv_pages[0]} of {run.kv_pages[1]}")


def main(argv=None, device=None, bench=None, root=None) -> dict:
    """One run. `device`, `bench` and `root` are for the tests: a device
    other than the card skips the look for one; `bench` stands for
    BENCHMARK.json and `root` for this folder."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.cell import BENCH, load_cell
    cell = load_cell(args.workload, bench, root or BENCH)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"[bench] needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            sys.exit(2)
        device = "cuda"
    from bench import check, serve
    run = serve.serve(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START if bench is None else time.perf_counter())
    print(summary(run), file=sys.stderr)
    numbers = check.check(run)
    correct = check.passed(numbers)
    out = result(cell, run, bool(args.trace), numbers, correct)
    if run.device.type == "cuda":
        # the peaks (989e12 flop/s bf16, 3.35e12 B/s) assume 700 W
        out["device"]["card"] = power_limit()
    for line in check.describe(numbers):
        print(line, file=sys.stderr)
    return out


if __name__ == "__main__":
    result_line = main()
    bad = forbidden_modules()
    if bad:
        print(f"[bench] forbidden modules loaded: {bad}", file=sys.stderr)
        sys.exit(3)
    print(json.dumps(result_line))
