# Copied unchanged from src/repro/core/goodput.py.
"""Goodput = max request rate served within SLOs at the attainment target,
per chip provisioned (the paper's objective) — plus the online
`SLOTracker` every `ServingBackend` (live cluster or simulator) can feed
token events into, so attainment is one metrics object whether it comes
from a goodput binary search or a live streaming run."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from .simulator import SimResult, summarize
from .workload import WorkloadSpec, sample_requests


@dataclasses.dataclass
class GoodputResult:
    rate: float                 # max sustainable total rate (req/s)
    per_chip: float             # rate / chips
    attain_at_rate: float
    chips: int


@dataclasses.dataclass
class SLOViolation:
    """One request that missed its TTFT and/or TPOT SLO, with the latency
    attribution (when the backend carried a `Tracer`) naming the dominant
    cause of the miss."""
    rid: int
    ttft: float
    tpot: float
    ttft_over: float            # ttft / slo_ttft (1.0 = exactly at SLO)
    tpot_over: float
    attribution: Optional[object] = None    # telemetry.Attribution

    @property
    def severity(self) -> float:
        return max(self.ttft_over, self.tpot_over)

    def format(self) -> str:
        head = (f"rid={self.rid} ttft={self.ttft:.4f}s "
                f"({self.ttft_over:.2f}x slo) tpot={self.tpot:.4f}s "
                f"({self.tpot_over:.2f}x slo)")
        if self.attribution is None:
            return head
        return head + "\n    " + self.attribution.format()


@dataclasses.dataclass
class SLOReport:
    """Attainment snapshot (the unified metrics object: `summarize` embeds
    it in `SimResult.slo`; live benchmarks print it from the tracker)."""
    total: int = 0              # requests in the denominator
    finished: int = 0
    cancelled: int = 0
    failed: int = 0
    shed: int = 0               # router load-shed (finish_reason "shed")
    ttft_ok: int = 0
    tpot_ok: int = 0
    both_ok: int = 0
    worst_itl: float = 0.0      # max inter-token latency seen anywhere

    @property
    def ttft_attain(self) -> float:
        return self.ttft_ok / max(self.total, 1)

    @property
    def tpot_attain(self) -> float:
        return self.tpot_ok / max(self.total, 1)

    @property
    def attain(self) -> float:
        return self.both_ok / max(self.total, 1)


class SLOTracker:
    """Online per-token SLO attainment (paper §2: TTFT + TPOT per request).

    Backends feed it as tokens stream (`observe_event` on every
    `TokenEvent`, `observe_finish` when a request goes terminal) — pass
    one as `tracker=` to any `ServingBackend` — or in bulk from recorded
    latencies (`observe_result`, the path `simulator.summarize` uses).
    Cancelled/failed requests are counted but never enter the attainment
    numerator or denominator (an abandoned request has no SLO to meet).
    """

    def __init__(self, spec: WorkloadSpec, slo_scale: float = 1.0,
                 tracer=None):
        self.spec = spec
        self.slo_ttft = spec.slo_ttft * slo_scale
        self.slo_tpot = spec.slo_tpot * slo_scale
        self.tracer = tracer        # optional telemetry.Tracer: violations
                                    # get a per-request latency attribution
        self.violations: List[SLOViolation] = []
        self._ttft: Dict[int, float] = {}       # in-flight: rid -> ttft
        self._last_t: Dict[int, float] = {}
        self._itl_sum: Dict[int, float] = {}
        self._itl_n: Dict[int, int] = {}
        self._report = SLOReport()

    # -- streaming path (live backends and simulators) -------------------
    def observe_event(self, state, ev):
        rid = state.rid
        if ev.index == 0:
            self._ttft[rid] = ev.t - state.request.arrive
        else:
            itl = ev.t - self._last_t[rid]
            self._itl_sum[rid] = self._itl_sum.get(rid, 0.0) + itl
            self._itl_n[rid] = self._itl_n.get(rid, 0) + 1
            self._report.worst_itl = max(self._report.worst_itl, itl)
        self._last_t[rid] = ev.t

    def observe_finish(self, state):
        rid = state.rid
        ttft = self._ttft.pop(rid, None)
        n = self._itl_n.pop(rid, 0)
        tpot = self._itl_sum.pop(rid, 0.0) / n if n else 0.0
        self._last_t.pop(rid, None)
        from ..serving.api import FINISH_SHED, RequestStatus
        if state.status is RequestStatus.CANCELLED:
            # shed requests never entered service; count them apart from
            # user cancels so a router sweep can report shed rate directly
            if state.finish_reason == FINISH_SHED:
                self._report.shed += 1
            else:
                self._report.cancelled += 1
            return
        if state.status is RequestStatus.FAILED:
            self._report.failed += 1
            return
        ttft = ttft if ttft is not None else float("inf")
        self.observe_result(ttft, tpot)
        if ttft > self.slo_ttft or tpot > self.slo_tpot:
            att = None
            if self.tracer is not None and getattr(self.tracer, "enabled",
                                                   False):
                from .telemetry import attribute_request
                att = attribute_request(self.tracer, rid)
            self.violations.append(SLOViolation(
                rid, ttft, tpot, ttft / self.slo_ttft,
                tpot / self.slo_tpot, att))

    def top_violations(self, n: int = 3) -> List[SLOViolation]:
        """Worst SLO misses by severity (max of the TTFT/TPOT overrun)."""
        return sorted(self.violations, key=lambda v: -v.severity)[:n]

    # -- bulk path (summarize over recorded traces) ----------------------
    def observe_result(self, ttft: float, tpot: float):
        self._report.total += 1
        self._report.finished += 1
        ttft_ok = ttft <= self.slo_ttft
        tpot_ok = tpot <= self.slo_tpot
        self._report.ttft_ok += ttft_ok
        self._report.tpot_ok += tpot_ok
        self._report.both_ok += ttft_ok and tpot_ok

    # -- reporting -------------------------------------------------------
    def report(self, total: Optional[int] = None) -> SLOReport:
        """Snapshot; `total` overrides the denominator (e.g. to count
        still-unfinished requests against attainment, as `summarize`
        does for its steady-state window)."""
        rep = dataclasses.replace(self._report)
        if total is not None:
            rep.total = total
        return rep

    def summary(self) -> Dict[str, float]:
        rep = self.report()
        return {"finished": rep.finished, "cancelled": rep.cancelled,
                "failed": rep.failed, "shed": rep.shed,
                "ttft_attain": round(rep.ttft_attain, 4),
                "tpot_attain": round(rep.tpot_attain, 4),
                "attain": round(rep.attain, 4),
                "worst_itl": rep.worst_itl,
                "slo_ttft": self.slo_ttft, "slo_tpot": self.slo_tpot}


def attainment_at_rate(run_sim: Callable, spec: WorkloadSpec, rate: float,
                       n_requests: int = 400, seed: int = 0,
                       slo_scale: float = 1.0, min_duration_s: float = 45.0,
                       max_requests: int = 4000) -> SimResult:
    """Sample enough traffic to reach steady state at this rate: at least
    `min_duration_s` of arrivals (capped), measured past a warmup window."""
    n = int(min(max(n_requests, rate * min_duration_s), max_requests))
    reqs = sample_requests(spec, rate, n, seed=seed)
    reqs, extras = run_sim(reqs)
    return summarize(reqs, spec, slo_scale=slo_scale, extra=extras)


def max_goodput(run_sim: Callable, spec: WorkloadSpec, chips: int, *,
                target: float = 0.9, n_requests: int = 400, seed: int = 0,
                slo_scale: float = 1.0, lo: float = 0.05, hi: float = 512.0,
                iters: int = 12) -> GoodputResult:
    """Binary search the max rate with attainment >= target (paper §4.1)."""
    def attain(rate: float) -> float:
        return attainment_at_rate(run_sim, spec, rate, n_requests, seed,
                                  slo_scale).attain

    if attain(lo) < target:
        return GoodputResult(0.0, 0.0, attain(lo), chips)
    if attain(hi) >= target:   # saturates the search cap
        return GoodputResult(hi, hi / chips, target, chips)
    best = lo
    for _ in range(iters):
        mid = (lo + hi) / 2
        if attain(mid) >= target:
            best, lo = mid, mid
        else:
            hi = mid
        if hi - lo < 0.02 * max(lo, 0.1):
            break
    return GoodputResult(best, best / chips, attain(best), chips)


def min_slo_scale(run_sim: Callable, spec: WorkloadSpec, rate: float, *,
                  target: float = 0.9, n_requests: int = 400, seed: int = 0,
                  lo: float = 0.05, hi: float = 8.0, iters: int = 12) -> float:
    """Most stringent SLO scale sustainable at a fixed rate (Fig. 8 row 2)."""
    def ok(scale: float) -> bool:
        return attainment_at_rate(run_sim, spec, rate, n_requests, seed,
                                  scale).attain >= target

    if not ok(hi):
        return float("inf")
    best = hi
    for _ in range(iters):
        mid = (lo + hi) / 2
        if ok(mid):
            best, hi = mid, mid
        else:
            lo = mid
    return best
