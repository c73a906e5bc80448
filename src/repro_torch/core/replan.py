# Copied unchanged from src/repro/core/replan.py.
"""Periodic replanning (paper §4.3): a workload profiler watches arrival
rate and length distributions; on significant drift it re-runs the
placement algorithm on recent history. Weight reloads take minutes vs the
hourly timescale of drift, so replanning is treated as cheap.

`RoleController` is the fast inner loop the paper's replanner doesn't
have: on a role-unified backend (`SimServingBackend` /
`serving.cluster.ServingCluster`) an instance's prefill/decode/mixed role
is runtime state, so shifting capacity between phases needs no weight
reload at all — just a drain-and-flip. The controller watches the
backend's `pressure()` signal and flips one instance at a time with
hysteresis and a cooldown, seconds-scale rebalancing between the
minutes-scale replans."""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .workload import Request, WorkloadSpec, fit_spec


@dataclasses.dataclass
class WorkloadStats:
    rate: float
    mean_in: float
    mean_out: float
    n: int


class WorkloadProfiler:
    def __init__(self, window: int = 512):
        self.window: Deque[Request] = deque(maxlen=window)

    def observe(self, req: Request):
        self.window.append(req)

    def stats(self) -> Optional[WorkloadStats]:
        if len(self.window) < 16:
            return None
        rs = list(self.window)
        span = max(rs[-1].arrive - rs[0].arrive, 1e-6)
        return WorkloadStats(
            rate=(len(rs) - 1) / span,
            mean_in=sum(r.in_len for r in rs) / len(rs),
            mean_out=sum(r.out_len for r in rs) / len(rs),
            n=len(rs))


def drifted(old: WorkloadStats, new: WorkloadStats,
            rel_threshold: float = 0.3) -> bool:
    """Significant pattern shift -> trigger replan."""
    def rel(a, b):
        return abs(a - b) / max(abs(a), 1e-9)
    return (rel(old.rate, new.rate) > rel_threshold
            or rel(old.mean_in, new.mean_in) > rel_threshold
            or rel(old.mean_out, new.mean_out) > rel_threshold)


class RoleController:
    """Overload-driven runtime re-roling over a role-unified backend.

    The backend contract is the role-unified serving surface both worlds
    share: a ``roles`` property (per-instance role vector, birth order),
    ``pressure()`` (prefill queue depth / decode KV occupancy / loads) and
    ``set_role(g, role, now=...)``. Policy:

    * prefill backlog — queued prefill tokens per routable prefill
      instance above `prefill_high` while decode KV occupancy is below
      `kv_low` — flips one decode (or mixed) instance to prefill. The
      flip drains in place: the donor's resident KV finishes decoding
      where it sits, so no pages move.
    * KV pressure — decode page occupancy above `kv_high` while the
      prefill side is idle (queued tokens per instance under
      `prefill_low`) — flips one prefill (or mixed) instance to decode;
      prefill drains within a batch, there is no KV to move.

    One flip per `cooldown_s` (drains take time to pay off; flapping is
    worse than either static mode), floors on the surviving per-role
    counts, and the donor is always the highest-index instance of the
    donor role, so decisions are deterministic and replayable. Flips the
    backend rejects (they would strand arrivals or prefill output) are
    skipped. `flips` records ``(t, instance, role, reason)``.
    """

    def __init__(self, backend, *,
                 prefill_high: float = 2048.0,
                 prefill_low: float = 256.0,
                 kv_high: float = 0.85,
                 kv_low: float = 0.5,
                 cooldown_s: float = 1.0,
                 min_prefill: int = 1,
                 min_decode: int = 1):
        assert prefill_low <= prefill_high and kv_low <= kv_high
        self.backend = backend
        self.prefill_high = prefill_high
        self.prefill_low = prefill_low
        self.kv_high = kv_high
        self.kv_low = kv_low
        self.cooldown_s = cooldown_s
        self.min_prefill = min_prefill
        self.min_decode = min_decode
        self.flips: List[Tuple[float, int, str, str]] = []
        self._pending: Dict[int, str] = {}      # flips still draining
        self._last_flip = -math.inf

    def _roles(self) -> List[str]:
        """Effective per-instance roles: the backend's vector with
        still-draining flips applied (a draining instance already left
        the routing views; counting it as its old role would double-flip
        during long drains)."""
        roles = list(self.backend.roles)
        for g, r in list(self._pending.items()):
            if roles[g] == r:
                del self._pending[g]            # drain completed
            else:
                roles[g] = r
        return roles

    def _donor(self, roles: List[str], want: str) -> Optional[int]:
        for role in ("decode", "mixed") if want == "prefill" \
                else ("prefill", "mixed"):
            cand = [g for g, r in enumerate(roles)
                    if r == role and g not in self._pending]
            if cand:
                return cand[-1]
        return None

    def tick(self, now: float) -> Optional[Tuple[int, str]]:
        """Inspect pressure; start at most one role flip. Returns the
        ``(instance, new_role)`` it initiated, else None."""
        if now - self._last_flip < self.cooldown_s:
            return None
        p = self.backend.pressure()
        roles = self._roles()
        n_p = sum(r == "prefill" for r in roles)
        n_d = sum(r == "decode" for r in roles)
        queued = p["prefill_queued_tokens"] / max(n_p, 1)
        if (queued > self.prefill_high and p["decode_kv_util"] < self.kv_low
                and n_d > self.min_decode):
            g, role, reason = self._donor(roles, "prefill"), "prefill", \
                "prefill_backlog"
        elif (p["decode_kv_util"] > self.kv_high
                and queued < self.prefill_low and n_p > self.min_prefill):
            g, role, reason = self._donor(roles, "decode"), "decode", \
                "kv_pressure"
        else:
            return None
        if g is None or roles[g] == role:
            return None
        try:
            self.backend.set_role(g, role, now=now)
        except ValueError:
            return None                 # backend guard: flip would strand
        self._pending[g] = role
        self._last_flip = now
        self.flips.append((now, g, role, reason))
        return (g, role)


class Replanner:
    """Glue: profiler -> drift check -> placement search callback."""

    def __init__(self, search: Callable[[WorkloadSpec, float], object],
                 slo_ttft: float, slo_tpot: float,
                 check_every: int = 256):
        self.search = search
        self.profiler = WorkloadProfiler()
        self.baseline: Optional[WorkloadStats] = None
        self.slo = (slo_ttft, slo_tpot)
        self.check_every = check_every
        self._since_check = 0
        self.replans = 0
        self.current_placement = None

    def observe(self, req: Request):
        self.profiler.observe(req)
        self._since_check += 1
        if self._since_check >= self.check_every:
            self._since_check = 0
            self.maybe_replan()

    def maybe_replan(self) -> bool:
        stats = self.profiler.stats()
        if stats is None:
            return False
        if self.baseline is None:
            self.baseline = stats
            return False
        if not drifted(self.baseline, stats):
            return False
        spec = fit_spec(list(self.profiler.window), "drift",
                        self.slo[0], self.slo[1])
        self.current_placement = self.search(spec, stats.rate)
        self.baseline = stats
        self.replans += 1
        return True
