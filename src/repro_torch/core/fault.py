# Copied unchanged from src/repro/core/fault.py.
"""Fault tolerance — the paper explicitly leaves this to future work (§4.3);
we implement it, since disaggregation *introduces* the failure coupling the
paper warns about (one decode instance serves many prefill instances).

Mechanisms:
  - heartbeat tracking with a miss threshold -> instance marked dead;
  - prefill-instance failure: queued requests re-dispatched to healthy
    peers (idempotent — no generation state lost);
  - decode-instance failure: running requests lose their KV; they are
    re-queued for *re-prefill* with their already-generated tokens appended
    (exactly-once token delivery preserved by the controller's dedup);
  - parked-KV loss on prefill failure: requests whose KV was parked but not
    yet pulled are also re-prefilled;
  - scheduler-state checkpoint/restore for controller restarts.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class InstanceHealth:
    iid: str
    last_beat: float
    alive: bool = True
    failures: int = 0


class HeartbeatMonitor:
    def __init__(self, timeout: float = 3.0, now: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.now = now
        self.instances: Dict[str, InstanceHealth] = {}

    def register(self, iid: str):
        self.instances[iid] = InstanceHealth(iid, self.now())

    def beat(self, iid: str):
        h = self.instances[iid]
        h.last_beat = self.now()
        if not h.alive:
            h.alive = True          # instance rejoined (elastic scale-up)

    def mark_failed(self, iid: str):
        h = self.instances[iid]
        h.alive = False
        h.failures += 1

    def sweep(self) -> List[str]:
        """Returns newly-dead instance ids."""
        dead = []
        t = self.now()
        for h in self.instances.values():
            if h.alive and t - h.last_beat > self.timeout:
                h.alive = False
                h.failures += 1
                dead.append(h.iid)
        return dead

    def alive_ids(self) -> Set[str]:
        return {h.iid for h in self.instances.values() if h.alive}


@dataclasses.dataclass
class FailoverPlan:
    reprefill: List[int]        # request ids needing prefill again
    redispatch: List[int]       # queued requests to move to healthy peers


def plan_failover(kind: str, queued: List[int], running: List[int],
                  parked: List[int]) -> FailoverPlan:
    """Policy table for an instance failure."""
    if kind == "prefill":
        # queued requests never started: move them; parked KV is lost.
        return FailoverPlan(reprefill=list(parked), redispatch=list(queued))
    # decode: running requests lost their KV mid-generation.
    return FailoverPlan(reprefill=list(running), redispatch=[])


class SchedulerCheckpoint:
    """Controller-state snapshot (request table + dispatch maps)."""

    @staticmethod
    def dump(state: Dict) -> bytes:
        return json.dumps(state, sort_keys=True).encode()

    @staticmethod
    def load(raw: bytes) -> Dict:
        return json.loads(raw.decode())
