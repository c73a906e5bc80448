# Copied unchanged from src/repro/core/placement.py.
"""Placement search — Algorithm 1 (high node-affinity) and Algorithm 2 (low
node-affinity), plus the vLLM++ ablation (best colocated parallelism).

TPU adaptation: the paper's "node" (NVLink island, M GPUs) maps to an ICI
slice of M chips; "cross-node" bandwidth maps to DCN. Alg. 2's constraint —
prefill/decode instance segments of the same pipeline stage colocated on one
node so KV flows over the fast fabric — becomes "same ICI slice".
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Dict, List, Optional, Tuple

from . import hw
from .goodput import GoodputResult, SLOReport, attainment_at_rate, max_goodput
from .latency_model import LatencyModel, Parallelism
from .simulator import (InstanceConfig, simulate_colocated,
                        simulate_disaggregated, simulate_roles)
from .workload import WorkloadSpec


@dataclasses.dataclass
class PhasePlan:
    par: Parallelism
    goodput_per_chip: float     # req/s per chip at the attainment target


@dataclasses.dataclass
class Placement:
    prefill: PhasePlan
    decode: PhasePlan
    n_prefill: int
    n_decode: int
    kv_bandwidth: float
    algo: str
    search_s: float = 0.0
    # unified metrics snapshot of the chosen fleet at the target rate
    # (same SLOReport object live benchmarks produce from SLOTracker,
    # scored from per-token timestamps by the same summarize path)
    slo: Optional[SLOReport] = None

    @property
    def chips(self) -> int:
        return (self.n_prefill * self.prefill.par.num_chips
                + self.n_decode * self.decode.par.num_chips)

    def summary(self) -> Dict:
        out = {
            "algo": self.algo,
            "prefill": {"tp": self.prefill.par.tp, "pp": self.prefill.par.pp,
                        "count": self.n_prefill,
                        "goodput_per_chip": round(self.prefill.goodput_per_chip, 4)},
            "decode": {"tp": self.decode.par.tp, "pp": self.decode.par.pp,
                       "count": self.n_decode,
                       "goodput_per_chip": round(self.decode.goodput_per_chip, 4)},
            "chips": self.chips,
            "search_s": round(self.search_s, 2),
        }
        if self.slo is not None:
            out["attain_at_rate"] = round(self.slo.attain, 4)
        return out


def _fleet_slo(lm: LatencyModel, spec: WorkloadSpec, pre: PhasePlan,
               dec: PhasePlan, n: int, m: int, rate: float,
               transfer_bw: float, n_requests: int, seed: int) -> SLOReport:
    """One closing simulation of the *whole* chosen fleet at the target
    rate; the report (fed by per-token timestamps through SLOTracker) is
    attached to the Placement so operators see projected attainment, not
    just the per-phase goodputs the search optimized."""
    def run(reqs):
        return simulate_disaggregated(
            reqs, lm, InstanceConfig(pre.par, n), InstanceConfig(dec.par, m),
            transfer_bw=transfer_bw)
    res = attainment_at_rate(run, spec, rate, n_requests=n_requests,
                             seed=seed)
    return res.slo


def _fits(lm: LatencyModel, par: Parallelism, chip: hw.Chip,
          headroom: float = 0.8) -> bool:
    return lm.param_bytes() / par.num_chips <= chip.hbm_bytes * headroom


def _phase_goodput(lm: LatencyModel, par: Parallelism, spec: WorkloadSpec,
                   phase: str, *, target: float, n_requests: int,
                   transfer_bw: float, seed: int = 0) -> float:
    """Per-chip goodput of a single phase instance (simu_prefill/simu_decode)."""
    if phase == "prefill":
        def run(reqs):
            return simulate_disaggregated(
                reqs, lm, InstanceConfig(par, 1),
                InstanceConfig(par, 1),
                transfer_bw=1e15, phase="prefill")
    else:
        def run(reqs):
            return simulate_disaggregated(
                reqs, lm, InstanceConfig(par, 1),
                InstanceConfig(par, 1),
                transfer_bw=1e15, phase="decode")
    g = max_goodput(run, spec, par.num_chips, target=target,
                    n_requests=n_requests, seed=seed)
    return g.per_chip


def algo1_high_affinity(lm: LatencyModel, spec: WorkloadSpec, *,
                        rate: float,
                        n_node: int = 4, m_per_node: int = 8,
                        chip: hw.Chip = hw.DEFAULT,
                        target: float = 0.9, n_requests: int = 300,
                        seed: int = 0, final_slo: bool = True) -> Placement:
    """Paper Alg. 1: independent per-phase config search + replication.
    High cross-node bandwidth -> KV transfer over the full fabric.
    final_slo=False skips the closing fleet-level attainment sim (callers
    that only need the config, e.g. search-time benchmarks)."""
    t0 = time.time()
    transfer_bw = chip.ici_bw  # high-affinity: fast fabric everywhere
    best: Dict[str, Optional[PhasePlan]] = {"prefill": None, "decode": None}
    for intra in [2 ** i for i in range(int(math.log2(m_per_node)) + 1)]:
        max_pp = max(n_node * m_per_node // intra, 1)
        for inter in range(1, max_pp + 1):
            par = Parallelism(tp=intra, pp=inter)
            if not _fits(lm, par, chip):
                continue
            for phase in ("prefill", "decode"):
                g = _phase_goodput(lm, par, spec, phase, target=target,
                                   n_requests=n_requests,
                                   transfer_bw=transfer_bw, seed=seed)
                cur = best[phase]
                if cur is None or g > cur.goodput_per_chip:
                    best[phase] = PhasePlan(par, g)
    pre, dec = best["prefill"], best["decode"]
    assert pre is not None and dec is not None, "no feasible config"

    def _count(plan):
        g = plan.goodput_per_chip * plan.par.num_chips
        if g <= 1e-9:
            return 1          # infeasible at this SLO; report 1x honestly
        return max(math.ceil(rate / g), 1)
    n, m = _count(pre), _count(dec)
    search_s = time.time() - t0     # search work only: the closing SLO
                                    # sim below is validation, not search
    slo = _fleet_slo(lm, spec, pre, dec, n, m, rate, transfer_bw,
                     n_requests, seed) if final_slo else None
    return Placement(pre, dec, n, m, transfer_bw, "high-affinity",
                     search_s, slo=slo)


def algo2_low_affinity(lm: LatencyModel, spec: WorkloadSpec, *,
                       rate: float,
                       n_node: int = 4, m_per_node: int = 8,
                       chip: hw.Chip = hw.DEFAULT,
                       target: float = 0.9, n_requests: int = 300,
                       seed: int = 0, final_slo: bool = True) -> Placement:
    """Paper Alg. 2: prefill+decode segments of the same stage share a node;
    KV flows over intra-node fabric only. Searches (inter_op, intra-node
    split) jointly. final_slo as in algo1_high_affinity."""
    t0 = time.time()
    transfer_bw = chip.ici_bw * chip.ici_links  # intra-slice fabric
    best: Optional[Tuple[float, PhasePlan, PhasePlan]] = None
    for inter in range(1, n_node + 1):
        # per-node split: prefill_tp + decode_tp <= m_per_node (any ints,
        # the paper's OPT-175B placement uses tp=3)
        opts = list(range(1, m_per_node + 1))
        for ptp in opts:
            for dtp in opts:
                if ptp + dtp > m_per_node:
                    continue
                p_par = Parallelism(tp=ptp, pp=inter)
                d_par = Parallelism(tp=dtp, pp=inter)
                if not (_fits(lm, p_par, chip) and _fits(lm, d_par, chip)):
                    continue

                def run(reqs, p_par=p_par, d_par=d_par):
                    return simulate_disaggregated(
                        reqs, lm, InstanceConfig(p_par, 1),
                        InstanceConfig(d_par, 1),
                        transfer_bw=transfer_bw)
                chips = p_par.num_chips + d_par.num_chips
                g = max_goodput(run, spec, chips, target=target,
                                n_requests=n_requests, seed=seed)
                if best is None or g.per_chip > best[0]:
                    best = (g.per_chip,
                            PhasePlan(p_par, g.per_chip),
                            PhasePlan(d_par, g.per_chip))
    assert best is not None, "no feasible config"
    per_chip, pre, dec = best
    pair_chips = pre.par.num_chips + dec.par.num_chips
    if per_chip * pair_chips <= 1e-9:
        n = 1                 # infeasible at this SLO; report 1x honestly
    else:
        n = max(math.ceil(rate / (per_chip * pair_chips)), 1)
    search_s = time.time() - t0
    slo = _fleet_slo(lm, spec, pre, dec, n, n, rate, transfer_bw,
                     n_requests, seed) if final_slo else None
    return Placement(pre, dec, n, n, transfer_bw, "low-affinity",
                     search_s, slo=slo)


@dataclasses.dataclass
class ModePlacement:
    """Result of `mode_search`: the per-instance role vector for a fixed
    fleet of `len(roles)` identical instances, plus the attainment the
    closing simulation measured for it at the target rate."""
    roles: List[str]
    par: Parallelism
    mode: str                   # "disagg" | "colocated" | "mixed-k"
    attain: float
    slo: Optional[SLOReport] = None
    search_s: float = 0.0

    @property
    def chips(self) -> int:
        return len(self.roles) * self.par.num_chips

    def summary(self) -> Dict:
        return {"mode": self.mode, "roles": list(self.roles),
                "tp": self.par.tp, "pp": self.par.pp,
                "chips": self.chips, "attain": round(self.attain, 4),
                "search_s": round(self.search_s, 2)}


def mode_candidates(n_instances: int) -> List[Tuple[str, List[str]]]:
    """Candidate ``(mode, roles)`` vectors for a fleet of N identical
    instances: every pure disaggregated split, every mixed-k hybrid
    (k colocated instances riding with a disaggregated remainder), and
    fully colocated. Disaggregated splits come first so attainment ties
    resolve toward the paper's baseline architecture."""
    assert n_instances >= 1
    out: List[Tuple[str, List[str]]] = []
    for n_p in range(1, n_instances):
        out.append(("disagg", ["prefill"] * n_p
                    + ["decode"] * (n_instances - n_p)))
    for k in range(1, n_instances - 1):
        for n_p in range(1, n_instances - k):
            n_d = n_instances - k - n_p
            out.append((f"mixed-{k}", ["prefill"] * n_p
                        + ["decode"] * n_d + ["mixed"] * k))
    out.append(("colocated", ["mixed"] * n_instances))
    return out


def mode_search(lm: LatencyModel, spec: WorkloadSpec, *, rate: float,
                par: Parallelism, n_instances: int,
                chip: hw.Chip = hw.DEFAULT,
                transfer_bw: Optional[float] = None,
                chunk_tokens=None, absorb_tokens: Optional[int] = None,
                n_requests: int = 200, seed: int = 0) -> ModePlacement:
    """Mode-per-instance placement search: with roles as runtime state,
    the deployment mode itself becomes a placement axis. For a fixed
    fleet of `n_instances` identical instances, simulate every candidate
    role vector (`mode_candidates`) at the target rate and keep the one
    with the highest SLO attainment. The winning vector feeds
    `apply_roles` on a live fleet — re-roling existing replicas instead
    of rebuilding them (`serving.router.fleet_search`)."""
    t0 = time.time()
    bw = chip.ici_bw if transfer_bw is None else transfer_bw
    best: Optional[ModePlacement] = None
    for mode, roles in mode_candidates(n_instances):
        def run(reqs, roles=roles):
            return simulate_roles(reqs, lm, par, roles, transfer_bw=bw,
                                  chunk_tokens=chunk_tokens,
                                  absorb_tokens=absorb_tokens)
        res = attainment_at_rate(run, spec, rate, n_requests=n_requests,
                                 seed=seed)
        if best is None or res.slo.attain > best.attain:
            best = ModePlacement(list(roles), par, mode, res.slo.attain,
                                 slo=res.slo)
    assert best is not None
    best.search_s = time.time() - t0
    return best


def ratio_counts(prefill_gp: float, decode_gp: float,
                 p_chips: int, d_chips: int, max_total: int = 8):
    """Smallest (n_prefill, n_decode) replication matching per-phase
    instance goodputs (Alg. 1's n/m, normalized for simulation)."""
    gp = max(prefill_gp * p_chips, 1e-9)   # per prefill instance
    gd = max(decode_gp * d_chips, 1e-9)
    best = (1, 1, 1e18)
    for n in range(1, max_total):
        for m in range(1, max_total):
            if n + m > max_total:
                continue
            waste = abs(n * gp - m * gd) / max(n * gp, m * gd)
            if waste < best[2]:
                best = (n, m, waste)
    return best[0], best[1]


def vllm_pp_search(lm: LatencyModel, spec: WorkloadSpec, *,
                   rate: float, n_node: int = 4, m_per_node: int = 8,
                   chip: hw.Chip = hw.DEFAULT, target: float = 0.9,
                   n_requests: int = 300, seed: int = 0,
                   fixed: Optional[Parallelism] = None
                   ) -> Tuple[Parallelism, float]:
    """vLLM++ ablation: best colocated parallelism by the same simulator."""
    best: Optional[Tuple[float, Parallelism]] = None
    cands = ([fixed] if fixed else
             [Parallelism(tp, pp)
              for tp in [2 ** i for i in range(int(math.log2(m_per_node)) + 1)]
              for pp in range(1, n_node + 1)])
    for par in cands:
        if not _fits(lm, par, chip):
            continue

        def run(reqs, par=par):
            return simulate_colocated(reqs, lm, InstanceConfig(par, 1))
        g = max_goodput(run, spec, par.num_chips, target=target,
                        n_requests=n_requests, seed=seed)
        if best is None or g.per_chip > best[0]:
            best = (g.per_chip, par)
    assert best is not None
    return best[1], best[0]
