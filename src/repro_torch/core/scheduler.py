# Copied unchanged from src/repro/core/scheduler.py.
"""Runtime scheduling core (paper §4.3), shared by the discrete-event
simulator (`core.simulator`) and the live cluster runtime
(`serving.cluster`). One implementation of:

- FCFS central queue, dispatch to the prefill instance with the shortest
  queue (by queued tokens).
- Prefill batch formation up to the L_m saturation budget: batch short
  prompts together, schedule longer-than-L_m prompts alone (reduces
  pipeline bubbles from non-uniform lengths).
- Decode dispatch to the least-loaded decode instance.
- Pull-based admission against *page* availability (`PagePool`): finished
  prefills stay parked on the prefill side until the decode instance has
  free KV pages, so bursts never overload decode memory (§4.3 "combat
  burstiness").

`DisaggDispatcher` records every dispatch decision, so tests can assert
that the simulator and the live cluster make identical choices on the same
arrival trace. `EventLoop` is the shared heapq event queue both drivers
run on.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import (Any, Callable, Dict, Generic, List, Optional, Sequence,
                    Tuple, TypeVar)

T = TypeVar("T")


@dataclasses.dataclass
class FCFSQueue(Generic[T]):
    token_of: Callable[[T], int]
    items: List[T] = dataclasses.field(default_factory=list)
    _tokens: int = 0                    # incremental sum over items

    def push(self, item: T):
        self.items.append(item)
        self._tokens += self.token_of(item)

    @property
    def queued_tokens(self) -> int:
        return self._tokens

    def __len__(self):
        return len(self.items)

    def remove(self, item: T) -> bool:
        """Drop a queued item (request cancellation while QUEUED). Returns
        False when the item already left the queue (e.g. batched)."""
        for i, it in enumerate(self.items):
            if it is item:
                del self.items[i]
                self._tokens -= self.token_of(item)
                return True
        return False

    def form_batch(self, budget: int, max_batch: Optional[int] = None,
                   can_take: Optional[Callable[[T], bool]] = None,
                   chunk_tokens: Optional[int] = None,
                   resumable: Optional[Callable[[T], bool]] = None
                   ) -> List[T]:
        """Paper §4.3: total new tokens per batch ~ L_m; oversized prompts
        go alone; FCFS order preserved (no reordering — convoy effects are
        accepted, preemption is future work per the paper).

        `can_take` gates admission per item (e.g. KV-page availability);
        it is consulted exactly once per accepted item, in FCFS order, so
        stateful predicates that reserve capacity on True are safe.

        With `chunk_tokens`, an item charges the batch budget only
        ``min(token_of(item), chunk_tokens)`` — the caller runs at most one
        chunk per item and re-pushes unfinished items (with a smaller
        `token_of`), so a long prompt no longer monopolizes the batch.

        `resumable` marks items whose capacity is *already reserved*
        (chunked partial prefills re-queued between chunks). When the head
        of the queue fails `can_take`, the batch may start from the first
        resumable item behind it instead of returning empty: those items
        free their reservation only by finishing, so draining them past a
        blocked head is the difference between progress and deadlock. New
        (non-resumable) items are never taken out of FCFS order.
        """
        if not self.items:
            return []
        start = 0
        if can_take is not None and not can_take(self.items[0]):
            if resumable is None:
                return []
            start = next((j for j, it in enumerate(self.items)
                          if resumable(it)), -1)
            if start < 0:
                return []

        def charge(item: T) -> int:
            t = self.token_of(item)
            return min(t, chunk_tokens) if chunk_tokens else t

        batch = [self.items.pop(start)]
        tok = charge(batch[0])
        taken = self.token_of(batch[0])
        while self.items and tok + charge(self.items[0]) <= budget:
            if max_batch and len(batch) >= max_batch:
                break
            if can_take is not None and not can_take(self.items[0]):
                break
            nxt = self.items.pop(0)
            tok += charge(nxt)
            taken += self.token_of(nxt)
            batch.append(nxt)
        self._tokens -= taken
        return batch


def shortest_queue(queues: Sequence[FCFSQueue],
                   alive: Optional[Sequence[int]] = None) -> int:
    """Index of the prefill queue with the fewest queued tokens (ties break
    to the lowest index, deterministically)."""
    cand = range(len(queues)) if alive is None else alive
    return min(cand, key=lambda i: queues[i].queued_tokens)


def least_loaded(loads: Sequence[float],
                 alive: Optional[Sequence[int]] = None) -> int:
    cand = range(len(loads)) if alive is None else alive
    return min(cand, key=lambda i: loads[i])


@dataclasses.dataclass
class DisaggDispatcher:
    """Records the dispatch decisions of the shared policies.

    Both the simulator and the live cluster route arrivals and KV handoffs
    through one dispatcher, so a test can replay the same trace on both and
    diff `decisions` entry-by-entry. Decisions are
    ``(kind, rid, instance, prefix_hit_tokens)`` — the hit length the
    chosen instance's radix tree reported at decision time (0 when prefix
    caching is off).

    Prefix-affinity prefill routing: when any instance holds a cached
    prefix of the request, route to the longest match *unless* that
    instance's queue is more than `affinity_slack` tokens deeper than the
    least-loaded queue — beyond that load gap, locality stops paying for
    the queueing delay and the policy falls back to shortest-queue.
    """
    affinity_slack: int = 1024          # tokens of queue imbalance tolerated
    decisions: List[Tuple[str, int, int, int]] = dataclasses.field(
        default_factory=list)
    tracer: Any = None                  # backends swap in their Tracer

    def _record(self, kind: str, rid: int, idx: int, hit: int,
                now: Optional[float]):
        self.decisions.append((kind, rid, idx, hit))
        if self.tracer is not None and now is not None:
            self.tracer.event(f"route_{kind}", now, rid=rid,
                              instance=idx, hit=hit)

    def pick_prefill(self, rid: int, queues: Sequence[FCFSQueue],
                     alive: Optional[Sequence[int]] = None,
                     hits: Optional[Sequence[int]] = None,
                     now: Optional[float] = None) -> int:
        cand = list(range(len(queues)) if alive is None else alive)
        if hits is not None and max(hits[i] for i in cand) > 0:
            # longest match; ties -> shortest queue -> lowest index
            best = min(cand, key=lambda i: (-hits[i],
                                            queues[i].queued_tokens, i))
            qmin = min(queues[i].queued_tokens for i in cand)
            if queues[best].queued_tokens - qmin <= self.affinity_slack:
                self._record("prefill", rid, best, hits[best], now)
                return best
        idx = shortest_queue(queues, alive)
        self._record("prefill", rid, idx,
                     hits[idx] if hits is not None else 0, now)
        return idx

    def pick_decode(self, rid: int, loads: Sequence[float],
                    alive: Optional[Sequence[int]] = None,
                    hits: Optional[Sequence[int]] = None,
                    now: Optional[float] = None) -> int:
        idx = least_loaded(loads, alive)
        self._record("decode", rid, idx,
                     hits[idx] if hits is not None else 0, now)
        return idx

    def pick_absorb(self, rid: int, loads: Sequence[float],
                    alive: Optional[Sequence[int]] = None,
                    now: Optional[float] = None) -> int:
        """Prefill-saturation spill: route a *whole prompt* to a
        decode/mixed instance that will chunk-prefill it locally
        (intra-instance aggregation). Recorded apart from normal decode
        dispatch so parity tests and benchmarks can count absorbed work."""
        idx = least_loaded(loads, alive)
        self._record("absorb", rid, idx, 0, now)
        return idx

    def by_rid(self) -> Dict[int, Dict[str, int]]:
        out: Dict[int, Dict[str, int]] = {}
        for kind, rid, idx, _hit in self.decisions:
            out.setdefault(rid, {})[kind] = idx
        return out


class EventLoop:
    """Heapq event queue with a monotone tie-breaking counter (insertion
    order wins among same-time events — arrivals dispatch before pokes)."""

    def __init__(self):
        self._q: List[Tuple[float, int, str, Any]] = []
        self._ctr = itertools.count()
        self.now = 0.0

    def push(self, t: float, kind: str, payload: Any = None):
        heapq.heappush(self._q, (t, next(self._ctr), kind, payload))

    def pop(self) -> Tuple[float, str, Any]:
        t, _, kind, payload = heapq.heappop(self._q)
        self.now = t
        return t, kind, payload

    def peek_time(self) -> Optional[float]:
        """Timestamp of the next event, or None when the loop is idle
        (lets `run_until(t)` stop without consuming future events)."""
        return self._q[0][0] if self._q else None

    def __bool__(self) -> bool:
        return bool(self._q)

    def __len__(self) -> int:
        return len(self._q)


class PagePool:
    """Block-granular KV capacity accounting (the scheduler-side view of a
    paged KV cache: capacity is a page count, admission is page-granular).

    `unit` is the token (or byte) capacity of one page; `pages_for`
    converts a demand in those units to whole pages (ceil).
    """

    def __init__(self, num_pages: int, unit: float = 1.0):
        assert num_pages >= 0 and unit > 0
        self.num_pages = int(num_pages)
        self.unit = float(unit)
        self._alloc: Dict[int, int] = {}
        self.used = 0
        self.peak_used = 0

    def pages_for(self, demand: float) -> int:
        return max(int(-(-demand // self.unit)), 1)

    @property
    def free_pages(self) -> int:
        return self.num_pages - self.used

    def can_alloc(self, n_pages: int) -> bool:
        return n_pages <= self.free_pages

    def alloc(self, rid: int, n_pages: int):
        assert rid not in self._alloc, rid
        assert self.can_alloc(n_pages), (rid, n_pages, self.free_pages)
        self._alloc[rid] = n_pages
        self.used += n_pages
        self.peak_used = max(self.peak_used, self.used)

    def free(self, rid: int) -> int:
        n = self._alloc.pop(rid)
        self.used -= n
        return n
