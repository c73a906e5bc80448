# Copied unchanged from src/repro/serving/router.py.
"""Fleet-scale router: N `ServingBackend` replicas behind one backend.

The paper's goodput story ends at one disaggregated cluster; a
millions-of-users deployment is many replicas behind a router that must
preserve the per-phase SLO guarantees each cluster buys. `FleetRouter`
fronts N `ServingBackend` instances — live `DisaggCluster`s or
`SimDisaggBackend`s, freely mixed — and itself implements the
`ServingBackend` protocol, so a fleet composes anywhere a single backend
does (benchmarks, goodput search, `ServeHandle` streaming).

Routing is pluggable (`RoutingPolicy`):

  prefix_affinity  router-side token-hash trie (`TokenHashTrie`):
                   page-granular like `RadixPrefixCache`, but allocator-
                   less — nodes hold page *hashes* and the set of replicas
                   believed to hold that prefix, never pages. Longest
                   match wins unless that replica's outstanding-token load
                   exceeds the least-loaded replica's by more than
                   `affinity_slack` (the same locality-vs-queueing
                   tradeoff `DisaggDispatcher` applies inside a cluster).
  session          sticky map keyed on the prompt head (first page of
                   token ids — consecutive turns of one conversation share
                   it), falling back to least-loaded on first sight.
  shortest_queue   fewest outstanding prompt tokens.
  least_loaded     fewest outstanding requests.

Load signals are router-side bookkeeping (requests routed minus requests
finished, per replica), not replica introspection: the router's view
changes only at its own dispatch and harvest times, which makes routing
decisions reproducible — a sim fleet and a live fleet replay the same
trace into the identical `decisions` list (the discipline
`DisaggDispatcher` pins for intra-cluster dispatch). The same counts are
what `_collect_metrics` exports to a `MetricsRegistry`.

`OverloadDetector` drives router-side queuing and shedding: a replica
past `max_inflight` outstanding requests (or, optionally, past
`max_replica_queue` requests sitting QUEUED inside it — the queue-depth
signal the replica's own metrics collector exports) stops receiving
work; when every routable replica is overloaded, arrivals wait in the
router's FCFS queue (traced as a ``router_queued`` phase, so TTFT
attribution shows router wait as its own term). A request that would
wait past `shed_after_s` (TTFT headroom) — or that arrives with the
router queue at `max_queue` — is *shed*: a leak-free cancel with
``finish_reason="shed"``, counted separately by `SLOTracker` so admitted
-request attainment can be compared against a no-shed baseline.

Elastic replanning closes the loop: attach a `core.replan.Replanner`
(its `WorkloadProfiler` watches the arrival stream through the router)
and an `on_replan` callback — `elastic_callback` resizes the fleet to
the plan's replica count via `add_replica` / `drain_replica` (draining
replicas finish their in-flight work, take nothing new, and go dead at
zero inflight). `fleet_search` is a ready-made `Replanner` search:
per-replica goodput from the simulator at the refitted spec, fleet size
= ceil(rate / replica goodput).

Clocks: each replica owns its event loop; the router interleaves them by
`next_time()` (earliest event wins, router events first on ties, then
replica index), so one global virtual clock emerges and `run_until` /
`drain` / `ServeHandle` semantics are exactly those of a single backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.scheduler import FCFSQueue
from .api import (FINISH_CANCELLED, FINISH_SHED, BackendBase, RequestState,
                  RequestStatus, ServedResult)

__all__ = [
    "TokenHashTrie", "RoutingPolicy", "PrefixAffinityPolicy",
    "SessionAffinityPolicy", "ShortestQueuePolicy", "LeastLoadedPolicy",
    "make_policy", "POLICIES", "OverloadDetector", "ReplicaHandle",
    "FleetRouter", "aggregate_snapshots", "elastic_callback", "fleet_search",
    "FleetPlan", "replica_kv_utilization",
]


# ---------------------------------------------------------------------------
# router-side prefix index
# ---------------------------------------------------------------------------

class _TrieNode:
    __slots__ = ("children", "replicas")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.replicas: Dict[int, int] = {}      # replica idx -> last touch


class TokenHashTrie:
    """Page-granular prefix index over page *hashes*, mirroring
    `RadixPrefixCache.match` semantics without owning pages: `match`
    reports, per replica, the deepest prefix the router has previously
    routed there; `insert` records a routing decision. Entries are hints
    (replicas evict their real trees independently), so hash collisions
    and staleness cost only a suboptimal route, never correctness."""

    def __init__(self, page_tokens: int = 16, max_nodes: int = 1 << 16):
        assert page_tokens > 0 and max_nodes > 0
        self.page_tokens = int(page_tokens)
        self.max_nodes = int(max_nodes)
        self.root = _TrieNode()
        self.nodes = 0
        self.tick = 0

    def _pages(self, tokens: Sequence[int]) -> List[int]:
        pt = self.page_tokens
        return [hash(tuple(tokens[i * pt:(i + 1) * pt]))
                for i in range(len(tokens) // pt)]

    def match(self, tokens: Sequence[int]) -> Dict[int, int]:
        """{replica: deepest known prefix in tokens} (page-granular)."""
        hits: Dict[int, int] = {}
        node, depth = self.root, 0
        for h in self._pages(tokens):
            node = node.children.get(h)
            if node is None:
                break
            depth += self.page_tokens
            for rep in node.replicas:
                hits[rep] = depth
        return hits

    def insert(self, tokens: Sequence[int], replica: int):
        self.tick += 1
        node = self.root
        for h in self._pages(tokens):
            nxt = node.children.get(h)
            if nxt is None:
                nxt = node.children[h] = _TrieNode()
                self.nodes += 1
            node = nxt
            node.replicas[replica] = self.tick
        if self.nodes > self.max_nodes:
            self._evict()

    def drop_replica(self, replica: int):
        """Forget a removed replica (replan shrink)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            node.replicas.pop(replica, None)
            stack.extend(node.children.values())

    def _evict(self):
        """LRU-ish: prune the least-recently-touched leaves until the
        node count is back under 3/4 of the cap."""
        target = self.max_nodes * 3 // 4
        while self.nodes > target:
            leaves: List[Tuple[int, _TrieNode, int]] = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                for k, ch in node.children.items():
                    if ch.children:
                        stack.append(ch)
                    else:
                        leaves.append(
                            (max(ch.replicas.values(), default=0), node, k))
            if not leaves:
                return
            leaves.sort(key=lambda x: x[0])
            for _, parent, k in leaves[:max(len(leaves) // 4, 1)]:
                ch = parent.children.get(k)
                if ch is not None and not ch.children:
                    del parent.children[k]
                    self.nodes -= 1
                if self.nodes <= target:
                    break


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------

class RoutingPolicy:
    """Picks a replica for each request. `choose` sees only routable,
    non-overloaded candidates (never empty) and returns
    ``(replica_idx, hit_tokens)`` — the hit length recorded in the
    decision tuple, mirroring `DisaggDispatcher`. `on_route` runs after
    the dispatch commits (trie inserts, sticky-map updates)."""
    name = "policy"

    def choose(self, router: "FleetRouter", req,
               cand: List[int]) -> Tuple[int, int]:
        raise NotImplementedError

    def on_route(self, router: "FleetRouter", req, idx: int):
        pass

    def on_replica_removed(self, router: "FleetRouter", idx: int):
        pass


class ShortestQueuePolicy(RoutingPolicy):
    name = "shortest_queue"

    def choose(self, router, req, cand):
        idx = min(cand, key=lambda i: (router.replicas[i].inflight_tokens, i))
        return idx, 0


class LeastLoadedPolicy(RoutingPolicy):
    name = "least_loaded"

    def choose(self, router, req, cand):
        idx = min(cand, key=lambda i: (router.replicas[i].inflight, i))
        return idx, 0


class PrefixAffinityPolicy(RoutingPolicy):
    """Longest trie match unless the matched replica's outstanding-token
    load is more than `affinity_slack` tokens past the lightest candidate
    (beyond that gap locality stops paying for queueing delay); falls
    back to shortest-queue. Ties: longer hit, lighter load, lower index."""
    name = "prefix_affinity"

    def __init__(self, page_tokens: int = 16, affinity_slack: int = 1024,
                 max_nodes: int = 1 << 16):
        self.trie = TokenHashTrie(page_tokens, max_nodes)
        self.affinity_slack = affinity_slack

    def choose(self, router, req, cand):
        toks = req.tokens
        hits = self.trie.match(toks) if toks else {}
        load = lambda i: router.replicas[i].inflight_tokens  # noqa: E731
        hcand = [i for i in cand if hits.get(i, 0) > 0]
        if hcand:
            best = min(hcand, key=lambda i: (-hits[i], load(i), i))
            if load(best) - min(load(i) for i in cand) <= self.affinity_slack:
                return best, hits[best]
        idx = min(cand, key=lambda i: (load(i), i))
        return idx, hits.get(idx, 0)

    def on_route(self, router, req, idx):
        if req.tokens:
            self.trie.insert(req.tokens, idx)

    def on_replica_removed(self, router, idx):
        self.trie.drop_replica(idx)


class SessionAffinityPolicy(RoutingPolicy):
    """Sticky per-session routing. The session key defaults to the first
    page of prompt token ids — consecutive turns of one conversation
    share their head — with least-loaded assignment on first sight. A
    sticky replica that is dead/draining/overloaded gets re-picked (and
    the stickiness moves with it)."""
    name = "session"

    def __init__(self, key: Optional[Callable[[Any], Any]] = None,
                 page_tokens: int = 16):
        self._key = key
        self.page_tokens = page_tokens
        self.sticky: Dict[Any, int] = {}

    def session_key(self, req):
        if self._key is not None:
            return self._key(req)
        if req.tokens:
            return tuple(req.tokens[:self.page_tokens])
        return req.rid

    def choose(self, router, req, cand):
        idx = self.sticky.get(self.session_key(req))
        if idx is not None and idx in cand:
            return idx, 1
        idx = min(cand, key=lambda i: (router.replicas[i].inflight, i))
        return idx, 0

    def on_route(self, router, req, idx):
        self.sticky[self.session_key(req)] = idx

    def on_replica_removed(self, router, idx):
        self.sticky = {k: v for k, v in self.sticky.items() if v != idx}


POLICIES = {p.name: p for p in (PrefixAffinityPolicy, SessionAffinityPolicy,
                                ShortestQueuePolicy, LeastLoadedPolicy)}


def make_policy(name: str, **kwargs) -> RoutingPolicy:
    return POLICIES[name](**kwargs)


# ---------------------------------------------------------------------------
# overload detection + replicas
# ---------------------------------------------------------------------------

def replica_kv_utilization(backend) -> float:
    """Decode KV page-pool occupancy of a replica, in [0, 1].

    Prefers the replica's `MetricsRegistry`: every paged engine/pool
    collector exports ``<instance>.kv.used_pages`` / ``.kv.num_pages``
    pairs, and the replica's occupancy is the max over its instances —
    the same signal an external autoscaler would scrape. Falls back to
    the backend's own `kv_utilization()` when no registry is attached
    (the common in-process case), 0.0 when neither exists."""
    reg = getattr(backend, "metrics", None)
    if reg is not None:
        snap = reg.snapshot()
        best, found = 0.0, False
        for k, v in snap.items():
            if k.endswith(".kv.num_pages") and v > 0:
                used = snap.get(k[:-len("num_pages")] + "used_pages")
                if used is not None:
                    found = True
                    best = max(best, used / v)
        if found:
            return best
    fn = getattr(backend, "kv_utilization", None)
    return float(fn()) if fn is not None else 0.0


@dataclasses.dataclass
class OverloadDetector:
    """Per-replica admission gate + router-queue shedding policy.

    A replica is overloaded at `max_inflight` outstanding requests
    (router-side count, deterministic in both worlds), or — when
    `max_replica_queue` is set — when that many of its requests still sit
    QUEUED inside it (the queue-depth signal its metrics collector
    exports; re-evaluated at arrival/dispatch boundaries), or — when
    `max_kv_util` is set — when its decode KV page-pool occupancy
    (`replica_kv_utilization`) reaches that fraction: queue depth misses
    memory-bound overload, where a few long-context requests fill the
    page pool while the queues look empty. The router queue sheds
    arrivals past `max_queue` outright, and sheds a queued request once
    it has waited `shed_after_s` (`from_slo` derives that deadline as a
    fraction of the TTFT SLO: past it the request could not meet its SLO
    even with an instant prefill, so shedding it protects the admitted
    requests' attainment instead of cascading the overload).
    """
    max_inflight: int = 64
    max_queue: int = 4096
    shed_after_s: Optional[float] = None
    max_replica_queue: Optional[int] = None
    max_kv_util: Optional[float] = None

    @classmethod
    def from_slo(cls, slo_ttft: float, *, headroom: float = 0.5,
                 max_inflight: int = 64, max_queue: int = 4096,
                 max_kv_util: Optional[float] = None
                 ) -> "OverloadDetector":
        return cls(max_inflight=max_inflight, max_queue=max_queue,
                   shed_after_s=slo_ttft * headroom,
                   max_kv_util=max_kv_util)

    def overloaded(self, rep: "ReplicaHandle") -> bool:
        if rep.inflight >= self.max_inflight:
            return True
        if self.max_replica_queue is not None:
            queued = sum(1 for rid in rep.rids
                         if rep.backend.states[rid].status
                         is RequestStatus.QUEUED)
            if queued >= self.max_replica_queue:
                return True
        if self.max_kv_util is not None and \
                replica_kv_utilization(rep.backend) >= self.max_kv_util:
            return True
        return False


@dataclasses.dataclass
class ReplicaHandle:
    """Router-side view of one replica: the backend plus the outstanding
    work the router has routed there and not yet harvested back."""
    backend: Any
    name: str
    alive: bool = True              # routable and steppable
    draining: bool = False          # finish in-flight, accept nothing new
    inflight: int = 0
    inflight_tokens: int = 0        # prompt tokens outstanding
    routed: int = 0
    finished: int = 0
    rids: set = dataclasses.field(default_factory=set)

    @property
    def routable(self) -> bool:
        return self.alive and not self.draining


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class FleetRouter(BackendBase):
    """`ServingBackend` over N child backends (see module docstring).

    Requests submitted to the router arrive in its own event loop, get
    routed (or router-queued, or shed) by the policy + detector, and are
    mirrored back as they stream: the child backend's per-token callback
    feeds the router's `RequestState`, tracker, and tracer, and the
    terminal result is harvested into `router.results` at the replica's
    finish time. Decision tuples land in `router.decisions` as
    ``("route", rid, replica, hit)`` / ``("shed", rid, -1, 0)``.
    """

    def __init__(self, backends: Sequence[Any], *,
                 policy: Any = "prefix_affinity",
                 detector: Optional[OverloadDetector] = None,
                 tracker=None, tracer=None, metrics=None,
                 replanner=None, on_replan: Optional[Callable] = None,
                 record_events: bool = True,
                 names: Optional[Sequence[str]] = None):
        self._init_backend(tracker=tracker, tracer=tracer, metrics=metrics)
        self._record_tokens = record_events
        self.replicas: List[ReplicaHandle] = []
        for i, be in enumerate(backends):
            self.add_replica(be, name=names[i] if names else None)
        self.policy: RoutingPolicy = (make_policy(policy)
                                      if isinstance(policy, str) else policy)
        self.detector = detector or OverloadDetector()
        self.decisions: List[Tuple[str, int, int, int]] = []
        self._rqueue: FCFSQueue = FCFSQueue(token_of=lambda r: r.in_len)
        self._routed: Dict[int, int] = {}       # rid -> replica idx
        self.shed_count = 0
        self.replanner = replanner
        self.on_replan = on_replan
        if metrics is not None:
            metrics.register(self._collect_metrics)

    # -- fleet membership ----------------------------------------------
    def add_replica(self, backend, name: Optional[str] = None) -> int:
        idx = len(self.replicas)
        self.replicas.append(ReplicaHandle(backend, name or f"replica{idx}"))
        return idx

    def drain_replica(self, idx: int):
        """Stop routing to a replica; it finishes its in-flight requests
        and goes dead at zero inflight (replan shrink path)."""
        rep = self.replicas[idx]
        rep.draining = True
        self.policy.on_replica_removed(self, idx)
        if rep.inflight == 0:
            rep.alive = False

    @property
    def fleet_size(self) -> int:
        return sum(1 for r in self.replicas if r.routable)

    # -- clock: interleave replicas by next event time ------------------
    def next_time(self) -> Optional[float]:
        best = self._ev.peek_time()
        for rep in self.replicas:
            if not rep.alive:
                continue
            nt = rep.backend.next_time()
            if nt is not None and (best is None or nt < best):
                best = nt
        return best

    def step(self) -> bool:
        src, best = -1, self._ev.peek_time()
        for i, rep in enumerate(self.replicas):
            if not rep.alive:
                continue
            nt = rep.backend.next_time()
            if nt is not None and (best is None or nt < best):
                src, best = i, nt
        if best is None:
            return False
        if src < 0:
            return super().step()           # router's own event is earliest
        if not self.replicas[src].backend.step():
            return False                    # defensive: replica refused
        self._ev.now = max(self._ev.now, best)
        self._harvest(src, best)
        return True

    def run_until(self, t: float) -> None:
        while True:
            nxt = self.next_time()
            if nxt is None or nxt > t:
                return
            if not self.step():
                return

    # -- router events --------------------------------------------------
    def _do_submit(self, state: RequestState, t: float):
        self._ev.push(t, "arrive", state)

    def _handle(self, t: float, kind: str, payload: Any):
        if kind == "arrive":
            self._on_arrive(payload, t)
        elif kind == "shed_check":
            if not payload.done and payload.rid not in self._routed:
                self._shed(payload, t)
        else:                               # pragma: no cover
            raise AssertionError(f"unknown router event {kind}")

    def _on_arrive(self, state: RequestState, t: float):
        req = state.request
        if self.replanner is not None:
            before = self.replanner.replans
            self.replanner.observe(req)     # profiler + drift-gated search
            if self.replanner.replans != before and self.on_replan is not None:
                self.on_replan(self, self.replanner.current_placement)
        if self.tracer.enabled:
            self.tracer.phase(state.rid, "router_queued", t, "router")
        if len(self._rqueue) >= self.detector.max_queue:
            self._rqueue.push(req)          # _shed pops it back out
            self._shed(state, t)
            return
        self._rqueue.push(req)
        self._dispatch_queued(t)
        if (not state.done and state.rid not in self._routed
                and self.detector.shed_after_s is not None):
            self._ev.push(t + self.detector.shed_after_s, "shed_check", state)

    # -- dispatch -------------------------------------------------------
    def _dispatch_queued(self, t: float) -> int:
        """Drain the router queue head-first while some routable replica
        is under its overload gates. Returns dispatches made."""
        n = 0
        while self._rqueue.items:
            cand = [i for i, rep in enumerate(self.replicas)
                    if rep.routable and not self.detector.overloaded(rep)]
            if not cand:
                break
            req = self._rqueue.items[0]
            state = self._states[req.rid]
            idx, hit = self.policy.choose(self, req, cand)
            self._rqueue.remove(req)
            self._dispatch(state, idx, hit, t)
            n += 1
        return n

    def _dispatch(self, state: RequestState, idx: int, hit: int, t: float):
        rep, req = self.replicas[idx], state.request
        self.decisions.append(("route", req.rid, idx, hit))
        if self.tracer.enabled:
            self.tracer.event("route_replica", t, rid=req.rid,
                              replica=idx, hit=hit)
        shared = getattr(rep.backend, "tracer", None) is self.tracer
        if self.tracer.enabled and not shared:
            # replica traces elsewhere (or not at all): close the router
            # phase here so router_queued stays an honest wait measure
            self.tracer.phase(req.rid, "dispatched", t, rep.name)
        mirror = None
        if (self._record_tokens or self.tracker is not None
                or state.on_token is not None or self.tracer.enabled):
            mirror = (lambda _rs, ev, s=state, sh=shared:
                      self._mirror_token(s, ev, sh))
        # the child re-stamps arrive/cancel_at on submit; arrive must stay
        # the user-facing arrival (TTFT spans router wait) and cancellation
        # is driven from the router loop only, so stash and restore both
        orig_arrive, orig_cancel = req.arrive, req.cancel_at
        req.cancel_at = None
        rep.backend.submit(req, t, sampling=state.sampling, on_token=mirror)
        req.arrive, req.cancel_at = orig_arrive, orig_cancel
        self._routed[req.rid] = idx
        rep.rids.add(req.rid)
        rep.inflight += 1
        rep.inflight_tokens += req.in_len
        rep.routed += 1
        self.policy.on_route(self, req, idx)

    def _mirror_token(self, state: RequestState, ev, shared: bool):
        if state.done:
            return
        state.record_token(ev.token, ev.t)
        if self.tracer.enabled and not shared:
            self.tracer.event("token", ev.t, rid=state.rid,
                              i=len(state.events) - 1)
        if self.tracker is not None:
            self.tracker.observe_event(state, state.events[-1])

    # -- harvest: replica terminals mirror onto router states -----------
    def _harvest(self, src: int, t: float):
        rep = self.replicas[src]
        done = sorted(rid for rid in rep.rids if rid in rep.backend.results)
        for rid in done:
            self._finish_routed(rid, src)
        if done:
            if rep.draining and rep.inflight == 0:
                rep.alive = False
            self._dispatch_queued(t)

    def _finish_routed(self, rid: int, src: int):
        rep = self.replicas[src]
        state = self._states[rid]
        res: ServedResult = rep.backend.results[rid]
        rep.rids.discard(rid)
        rep.inflight -= 1
        rep.inflight_tokens -= state.request.in_len
        rep.finished += 1
        self._routed.pop(rid, None)
        if state.done:
            return
        if res.finish_reason == FINISH_CANCELLED:
            # the replica trimmed pre-stamped future tokens; mirror that
            state.events = [e for e in state.events if e.t <= res.finish]
        state.finish(res.finish, res.finish_reason)
        self.results[rid] = res             # replica result: real tokens
        self._forget(rid)
        if self.tracer.enabled and \
                getattr(rep.backend, "tracer", None) is not self.tracer:
            self.tracer.finish_phase(rid, res.finish, state.status.name)
        if self.metrics is not None:
            self._observe_metrics(state)
        if self.tracker is not None:
            self.tracker.observe_finish(state)

    # -- cancellation / shedding ----------------------------------------
    def _apply_cancel(self, state: RequestState, t: float):
        if state.done:
            return
        src = self._routed.get(state.rid)
        if src is not None:
            # delegate: the replica releases everything it holds at t and
            # the terminal mirrors back through _harvest
            self.replicas[src].backend.cancel(state.rid, t)
            return
        self._rqueue.remove(state.request)  # held nothing but a queue slot
        state.events = [e for e in state.events if e.t <= t]
        state.finish(t, FINISH_CANCELLED)
        self._store_result(state)

    def _do_cancel(self, state: RequestState, t: float):
        raise AssertionError("unreachable: router overrides _apply_cancel")

    def _shed(self, state: RequestState, t: float):
        self.decisions.append(("shed", state.rid, -1, 0))
        self.shed_count += 1
        if self.tracer.enabled:
            self.tracer.event("shed", t, rid=state.rid)
        self._rqueue.remove(state.request)
        self._finish_state(state, t, FINISH_SHED)

    # -- metrics ---------------------------------------------------------
    def _collect_metrics(self) -> Dict[str, float]:
        out = {"router.queue_depth": float(len(self._rqueue)),
               "router.queue_tokens": float(self._rqueue.queued_tokens),
               "router.shed_total": float(self.shed_count),
               "router.replicas_alive": float(
                   sum(r.alive for r in self.replicas)),
               "router.replicas_routable": float(self.fleet_size)}
        for rep in self.replicas:
            pre = f"router.{rep.name}"
            out[f"{pre}.inflight"] = float(rep.inflight)
            out[f"{pre}.inflight_tokens"] = float(rep.inflight_tokens)
            out[f"{pre}.routed"] = float(rep.routed)
            out[f"{pre}.finished"] = float(rep.finished)
        return out


# ---------------------------------------------------------------------------
# fleet metrics aggregation + elastic replanning glue
# ---------------------------------------------------------------------------

def aggregate_snapshots(named: Dict[str, Dict[str, float]]
                        ) -> Dict[str, float]:
    """Fold per-replica metric snapshots into one namespace: every metric
    appears replica-prefixed (``replica0.queue0.depth``) and summed under
    ``fleet.`` — the multi-replica form `launch.diagnose --serve-metrics`
    prints."""
    out: Dict[str, float] = {}
    sums: Dict[str, float] = {}
    for rname, snap in named.items():
        for k, v in snap.items():
            out[f"{rname}.{k}"] = float(v)
            sums[k] = sums.get(k, 0.0) + float(v)
    for k, v in sums.items():
        out[f"fleet.{k}"] = v
    return out


@dataclasses.dataclass
class FleetPlan:
    """What `fleet_search` hands back to the `Replanner`: how many
    replicas the refitted workload needs at the observed rate, plus —
    when the search also ran the mode axis — the per-instance role
    vector each replica should reconcile to (`apply_roles`)."""
    replicas: int
    rate: float
    per_replica: float          # one replica's goodput (req/s)
    roles: Optional[List[str]] = None


def elastic_callback(make_backend: Callable[[int], Any],
                     size_of: Optional[Callable[[Any], int]] = None,
                     max_replicas: int = 64) -> Callable:
    """Build a `FleetRouter(on_replan=...)` callback that resizes the
    fleet to the plan's replica count: grows with `make_backend(idx)`,
    shrinks by draining the newest routable replicas first. A plan that
    carries a role vector (`FleetPlan.roles`) additionally *re-roles*
    every routable role-unified replica in place via `apply_roles` —
    capacity moves between prefill and decode without tearing a replica
    down (new replicas from `make_backend` are expected to be born with
    the planned roles)."""
    def cb(router: FleetRouter, plan):
        want = size_of(plan) if size_of is not None else (
            plan.replicas if isinstance(plan, FleetPlan) else int(plan))
        want = max(1, min(int(want), max_replicas))
        routable = [i for i, r in enumerate(router.replicas) if r.routable]
        if want > len(routable):
            for _ in range(want - len(routable)):
                router.add_replica(make_backend(len(router.replicas)))
        elif want < len(routable):
            for i in reversed(routable[want:]):
                router.drain_replica(i)
        roles = getattr(plan, "roles", None)
        if roles:
            for rep in router.replicas:
                apply = getattr(rep.backend, "apply_roles", None)
                if rep.routable and apply is not None:
                    apply(roles)
    return cb


def fleet_search(lm, prefill, decode, *, target: float = 0.9,
                 n_requests: int = 200, slo_scale: float = 1.0,
                 max_replicas: int = 64, search_modes: bool = False,
                 **sim_kwargs) -> Callable:
    """`Replanner` search callback for a fleet of identical replicas:
    per-replica goodput via the simulator (`max_goodput`, the paper's
    placement-search primitive) at the refitted spec, fleet size =
    ceil(observed rate / per-replica goodput).

    With ``search_modes=True`` the per-replica deployment *mode* becomes
    a search axis too (`core.placement.mode_search`): the replica's
    instances keep their count and parallelism but the prefill/decode/
    mixed role vector is re-chosen for the refitted workload, and the
    winning vector rides on the plan — `elastic_callback` then re-roles
    the existing replicas in place instead of rebuilding them."""
    from ..core.goodput import max_goodput
    from ..core.simulator import simulate_disaggregated, simulate_roles

    def search(spec, rate: float) -> FleetPlan:
        roles = None
        if search_modes:
            from ..core.placement import mode_search
            mp = mode_search(
                lm, spec, rate=rate, par=prefill.par,
                n_instances=prefill.count + decode.count,
                transfer_bw=sim_kwargs.get("transfer_bw", 50e9),
                chunk_tokens=sim_kwargs.get("chunk_tokens"),
                absorb_tokens=sim_kwargs.get("absorb_tokens"),
                n_requests=n_requests, seed=0)
            roles = mp.roles

            def run(reqs):
                return simulate_roles(reqs, lm, prefill.par, roles,
                                      **sim_kwargs)
        else:
            def run(reqs):
                return simulate_disaggregated(reqs, lm, prefill, decode,
                                              **sim_kwargs)
        chips = (prefill.count * prefill.par.num_chips
                 + decode.count * decode.par.num_chips)
        gp = max_goodput(run, spec, chips, target=target,
                         n_requests=n_requests, slo_scale=slo_scale)
        per = max(gp.rate, 1e-9)
        return FleetPlan(min(max(math.ceil(rate / per), 1), max_replicas),
                         rate, per, roles=roles)
    return search
