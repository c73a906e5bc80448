"""Rank a cell's collectives by wire bytes with the op and model line that
issued them (port of `repro/launch/diagnose.py`), or, with
``--serve-metrics``, dump Prometheus-style metrics snapshots from a
smoke serving run (queue depths, page-pool occupancy, transfer totals,
TTFT/TPOT histograms).

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch gemma3-1b \
      --shape decode_32k [--opt ...] [--top 15]
  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch yi-6b-smoke \
      --serve-metrics [--device cpu]

Where JAX reads the compiled HLO (each collective with its `op_name`),
the port reads the dry-run's collective records (`launch/costs.py`):
each with the DTensor-level op whose redistribution issued it and the
nearest line of the port's models or training code. The serving run
uses the card unless `--device` names another device.
"""
from __future__ import annotations

import argparse
from collections import defaultdict


def serve_metrics(arch: str, replicas: int = 2, device=None,
                  echo: bool = True) -> str:
    """Smoke fleet serving run with metrics registries attached; dumps the
    router's Prometheus snapshot (queue depth, shed count, per-replica
    inflight) followed by per-replica snapshots prefixed ``replicaN.`` and
    their ``fleet.``-summed totals (engine/queue/transfer pull-collectors
    plus the request counters and latency histograms). The replicas share
    one copy of the params. Returns the text (printed unless `echo` is
    off)."""
    import numpy as np
    import torch
    from ..configs import get_config
    from ..core.telemetry import MetricsRegistry
    from ..core.workload import Request
    from ..models.api import build_model
    from ..serving.cluster import DisaggCluster
    from ..serving.engine import resolve_device
    from ..serving.router import (FleetRouter, OverloadDetector,
                                  aggregate_snapshots)

    dev = resolve_device(device)
    cfg = get_config(arch)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), dev)
    regs = [MetricsRegistry() for _ in range(replicas)]
    backends = [DisaggCluster(cfg, params, n_prefill=1, n_decode=1,
                              max_batch=4, max_len=96, lm_tokens=64,
                              metrics=regs[i], seed=i, device=dev)
                for i in range(replicas)]
    router_metrics = MetricsRegistry()
    # tight gates so the smoke burst exercises router queueing + shedding
    router = FleetRouter(backends, policy="shortest_queue",
                         detector=OverloadDetector(max_inflight=2,
                                                   max_queue=4),
                         metrics=router_metrics)
    rng = np.random.default_rng(0)
    for i in range(10):
        router.submit(Request(i, i * 0.005, int(rng.integers(8, 40)),
                              int(rng.integers(4, 8))))
    router.drain()
    agg = aggregate_snapshots({f"replica{i}": regs[i].snapshot()
                               for i in range(replicas)})
    fleet = MetricsRegistry()
    for k, v in agg.items():
        fleet.gauge(k, v)
    text = router_metrics.prometheus() + fleet.prometheus()
    if echo:
        print(text, end="")
    return text


def collectives_report(rec, top: int = 15):
    """Rows (wire bytes, kind, count, op, source) of a dry-run record's
    collectives, the same (kind, op, source) summed, largest first."""
    acc = defaultdict(lambda: [0.0, 0])
    for op in rec.get("collective_ops", []):
        key = (op["kind"], op.get("issued_by", "?"), op.get("source", "?"))
        acc[key][0] += op["wire"]
        acc[key][1] += 1
    rows = sorted(((b, k, n, o, s) for (k, o, s), (b, n) in acc.items()),
                  reverse=True)
    return rows[:top]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default=None)
    ap.add_argument("--opt", default="")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--serve-metrics", action="store_true",
                    help="run a smoke fleet serving workload and dump "
                         "Prometheus-style metrics snapshots (router + "
                         "per-replica + fleet-summed) instead of the "
                         "collectives report")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size for --serve-metrics")
    ap.add_argument("--device", default=None,
                    help="device of the --serve-metrics run (default: the "
                         "card)")
    args = ap.parse_args(argv)

    if args.serve_metrics:
        serve_metrics(args.arch, replicas=args.replicas, device=args.device)
        return
    if not args.shape:
        ap.error("--shape is required unless --serve-metrics is given")

    from .dryrun import lower_cell
    opts = tuple(o for o in args.opt.split(",") if o)
    rec = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                     mode=args.mode, opts=opts)
    print(f"status={rec['status']} total_coll_ici="
          f"{rec['collectives_corrected']['ici_bytes']/1e9:.1f}GB "
          f"dcn={rec['collectives_corrected']['dcn_bytes']/1e9:.1f}GB")
    for b, kind, n, op, src in collectives_report(rec, args.top):
        print(f"{b/1e9:9.2f}GB x{n:5d} {kind:18s} {op} :: {src}")


if __name__ == "__main__":
    main()
