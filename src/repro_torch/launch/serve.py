"""Serving launcher (port of `repro/launch/serve.py`).

Runs the placement search for the target arch + workload with the latency
model of the H100 the port runs on (`core/h100.py`; the JAX launcher plans
with `hw.V5E`), prints the plan, and with `--live` serves a trace on the
port's `DisaggCluster` with the plan's instance counts (at most 2 of
each), on the smoke-scale config as the JAX launcher does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload sharegpt --rate 8 [--live] [--device cpu]

The cluster runs on the card unless `--device` names another device.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..configs import get_config
from ..core.h100 import H100
from ..core.latency_model import LatencyModel
from ..core.placement import algo1_high_affinity, algo2_low_affinity
from ..core.workload import WORKLOADS, Request, derive_slos, sample_requests
from ..models.api import build_model
from ..serving.cluster import DisaggCluster
from ..serving.engine import resolve_device


def plan(cfg, workload: str, rate: float, algo: str = "low",
         n_node: int = 2, m_per_node: int = 8, n_requests: int = 200,
         chip=H100):
    """Derive the workload's TTFT/TPOT limits from the latency model of
    `chip` and search a placement with Alg. 2 (`algo="low"`) or Alg. 1
    (`"high"`). Returns (latency model, workload spec, placement)."""
    lm = LatencyModel(cfg, chip)
    spec = derive_slos(WORKLOADS[workload], lm)
    search = algo2_low_affinity if algo == "low" else algo1_high_affinity
    placement = search(lm, spec, rate=rate, n_node=n_node,
                       m_per_node=m_per_node, n_requests=n_requests,
                       chip=chip)
    return lm, spec, placement


def live_trace(spec, n: int, rate: float, max_in: int, max_out: int):
    """`n` requests of `spec` arriving at `rate`, lengths clipped."""
    return [Request(r.rid, r.arrive, min(r.in_len, max_in),
                    min(r.out_len, max_out))
            for r in sample_requests(spec, rate, n, seed=0)]


def serve_live(cfg, placement, spec, *, params=None, device=None,
               max_batch: int = 4, max_len: int = 96, lm_tokens: int = 64,
               max_in: int = 48, max_out: int = 8, n: int = 12,
               rate: float = 20.0, seed: int = 0, chunk_tokens=None,
               charge=None):
    """Serve `live_trace(spec, n, rate, max_in, max_out)` on a
    `DisaggCluster` of `cfg` with min(count, 2) prefill and decode engines
    of `placement`. The engines share `params` (random f32 weights from
    `seed` when not given). Returns (results, cluster)."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = build_model(cfg).init(gen, dev)
    cluster = DisaggCluster(
        cfg, params, n_prefill=min(placement.n_prefill, 2),
        n_decode=min(placement.n_decode, 2), max_batch=max_batch,
        max_len=max_len, lm_tokens=lm_tokens, chunk_tokens=chunk_tokens,
        charge=charge, device=dev)
    res = cluster.run(live_trace(spec, n, rate, max_in, max_out))
    return res, cluster


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--workload", default="sharegpt",
                    choices=list(WORKLOADS))
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--algo", default="low", choices=["low", "high"])
    ap.add_argument("--n-node", type=int, default=2)
    ap.add_argument("--m-per-node", type=int, default=8)
    ap.add_argument("--n-requests", type=int, default=200)
    ap.add_argument("--live", action="store_true",
                    help="also serve a trace on the smoke-scale live cluster")
    ap.add_argument("--device", default=None,
                    help="device of the live cluster (default: the card)")
    args = ap.parse_args()

    _, spec, placement = plan(get_config(args.arch), args.workload,
                              args.rate, args.algo, args.n_node,
                              args.m_per_node, args.n_requests)
    print(json.dumps(placement.summary(), indent=1))

    if args.live:
        res, cluster = serve_live(get_config(args.arch + "-smoke"),
                                  placement, spec, device=args.device)
        ttfts = sorted(r.ttft for r in res.values())
        print(f"[live] served {len(res)} requests; "
              f"median ttft {ttfts[len(ttfts) // 2] * 1e3:.0f} ms; "
              f"KV migrated {cluster.tx.total_bytes / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
