# Copied unchanged from src/repro/serving/api.py.
"""First-class request lifecycle for online serving.

DistServe's headline metric is per-request SLO attainment — TTFT and TPOT
measured per token, online — so the serving surface is built around a
request lifecycle instead of closed-world trace replay:

  * `SamplingParams` — generation controls (max_tokens, stop token ids,
    greedy/temperature sampling).
  * `RequestStatus` — the state machine every request walks:
    QUEUED -> PREFILLING -> MIGRATING -> PENDING_ADMIT -> DECODING ->
    FINISHED | CANCELLED | FAILED.  (Backends may skip MIGRATING /
    PENDING_ADMIT when a hop is instantaneous — e.g. the colocated
    engines never migrate.)
  * `TokenEvent` — one generated token with its virtual-clock timestamp;
    the events list is the ground truth TTFT / inter-token-latency
    distribution (max/p99, not just the mean).
  * `RequestState` — the shared lifecycle record both the live clusters
    and the discrete-event simulator maintain; `ServedResult` is built
    from it.
  * `ServeHandle` — what `submit` returns: `.cancel()`, `.result()`, and
    a token iterator that drives the backend's virtual clock just far
    enough to yield the next token.
  * `ServingBackend` — the protocol all four drivers implement
    (`DisaggCluster`, `ColocatedCluster`, `SimDisaggBackend`,
    `SimColocatedBackend`): `submit(request, t)` / `step()` /
    `run_until(t)` / `drain()` / `cancel(rid)`, plus `on_token`
    callbacks, so live and simulated serving are driven through one API.

The legacy closed-world entrypoints (`DisaggCluster.run(requests)`,
`simulate_disaggregated(reqs, ...)`) remain as thin
submit-all-then-drain shims over this API.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import (Any, Callable, Dict, Iterator, List, Optional, Protocol,
                    Tuple, runtime_checkable)


class RequestStatus(enum.Enum):
    QUEUED = "queued"                # waiting in a prefill FCFS queue
    PREFILLING = "prefilling"       # prompt running through a prefill engine
    MIGRATING = "migrating"         # KV parked / on the wire to decode
    PENDING_ADMIT = "pending_admit"  # waiting for free decode KV pages
    DECODING = "decoding"           # in a decode instance's running batch
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL


_TERMINAL = (RequestStatus.FINISHED, RequestStatus.CANCELLED,
             RequestStatus.FAILED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Generation controls carried by a request.

    max_tokens caps the request's out_len (None -> use the request's);
    stop token ids end generation early with finish_reason "stop";
    temperature 0.0 is greedy argmax (the default, and the only mode the
    token-equality tests pin), > 0 samples the softmax with a rng seeded
    per request from `seed`.
    """
    max_tokens: Optional[int] = None
    stop: Tuple[int, ...] = ()
    temperature: float = 0.0
    seed: int = 0

    def out_len(self, requested: int) -> int:
        if self.max_tokens is None:
            return requested
        return max(min(requested, self.max_tokens), 1)


GREEDY = SamplingParams()

# finish reasons surfaced in ServedResult
FINISH_LENGTH = "length"        # produced out_len tokens
FINISH_STOP = "stop"            # hit a SamplingParams.stop token id
FINISH_CANCELLED = "cancelled"  # cancel() mid-flight
FINISH_FAILED = "failed"        # instance failure with no recovery
FINISH_SHED = "shed"            # load-shed by a router before any work ran


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile (numpy's default 'linear' method) —
    the one implementation every latency distribution in the repo uses
    (`simulator.summarize`, `ServedResult.tpot_p99`, benchmarks)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    index: int                  # 0-based position in the generated stream
    token: int                  # token id (simulated backends emit -1)
    t: float                    # virtual-clock emission time


@dataclasses.dataclass
class RequestState:
    """Shared per-request lifecycle record (live cluster and simulator)."""
    request: Any                            # core.workload.Request
    sampling: SamplingParams = GREEDY
    status: RequestStatus = RequestStatus.QUEUED
    events: List[TokenEvent] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    seq: Any = None                         # live backends: engine.Sequence
    on_token: Optional[Callable[["RequestState", TokenEvent], None]] = None
    # backend-private routing bookkeeping (which queue/instance holds it)
    where: Any = None
    # PREFILLING-with-progress: prompt tokens whose KV is already resident
    # (chunked prefill updates this after every chunk)
    progress: int = 0

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self.status.terminal

    def record_token(self, token: int, t: float):
        ev = TokenEvent(len(self.events), int(token), t)
        self.events.append(ev)
        if self.on_token is not None:
            self.on_token(self, ev)

    @property
    def token_times(self) -> Tuple[float, ...]:
        return tuple(e.t for e in self.events)

    def itl(self) -> List[float]:
        """Inter-token latencies (the real TPOT distribution)."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def ttft(self) -> float:
        return self.request.first_token - self.request.arrive

    @property
    def tpot(self) -> float:
        """Mean inter-token latency over the tokens actually produced
        (equals the legacy (finish-first)/(out_len-1) on full runs)."""
        n = len(self.events)
        if n <= 1:
            return 0.0
        return (self.request.finish - self.request.first_token) / (n - 1)

    def to_status(self, status: RequestStatus):
        if not self.status.terminal:        # terminal states are sticky
            self.status = status

    def finish(self, t: float, reason: str = FINISH_LENGTH):
        if self.status.terminal:
            return
        self.request.finish = t
        self.request.finish_reason = reason
        self.finish_reason = reason
        self.status = (RequestStatus.CANCELLED
                       if reason in (FINISH_CANCELLED, FINISH_SHED)
                       else RequestStatus.FAILED if reason == FINISH_FAILED
                       else RequestStatus.FINISHED)


@dataclasses.dataclass
class ServedResult:
    """Per-request serving outcome, built from the RequestState.

    The first seven fields match the pre-lifecycle ServedResult exactly
    (the legacy `run(requests)` shims reproduce them byte-for-byte on
    no-cancel traces); the lifecycle redesign adds the finish reason and
    the full per-token timestamp vector, so TPOT is a distribution
    (`itl()`, `tpot_max`, `tpot_p99`), not just a mean.
    """
    rid: int
    tokens: List[int]
    ttft: float
    tpot: float
    finish: float
    prefix_hit: int = 0        # prompt tokens served from the prefill-side
                               # radix tree (prefill compute skipped)
    decode_hit: int = 0        # prompt tokens already resident on the
                               # decode side (transfer bytes skipped)
    finish_reason: str = FINISH_LENGTH
    token_times: Tuple[float, ...] = ()

    def itl(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    @property
    def n_generated(self) -> int:
        return len(self.token_times)

    @property
    def tpot_max(self) -> float:
        itl = self.itl()
        return max(itl) if itl else 0.0

    @property
    def tpot_p99(self) -> float:
        return percentile(self.itl(), 0.99)

    @classmethod
    def from_state(cls, state: RequestState) -> "ServedResult":
        req, seq = state.request, state.seq
        n = len(state.events)
        ttft = req.first_token - req.arrive
        tpot = ((req.finish - req.first_token) / max(n - 1, 1)
                if n else 0.0)
        return cls(req.rid, list(seq.tokens) if seq is not None else [],
                   ttft, tpot, req.finish,
                   getattr(seq, "prefix_hit", req.prefix_hit),
                   getattr(seq, "decode_hit", req.decode_hit),
                   state.finish_reason or FINISH_LENGTH,
                   state.token_times)


class ServeHandle:
    """Live view of one submitted request.

    Iterating yields `TokenEvent`s, driving the backend's virtual clock
    just far enough to produce each next token; `result()` drives it to
    this request's completion; `cancel()` frees everything it holds
    (pages, pins, parked transfer bytes) at the backend's current time.
    """

    def __init__(self, backend: "ServingBackend", state: RequestState):
        self._backend = backend
        self.state = state

    @property
    def rid(self) -> int:
        return self.state.rid

    @property
    def status(self) -> RequestStatus:
        return self.state.status

    @property
    def done(self) -> bool:
        return self.state.done

    def cancel(self, t: Optional[float] = None):
        self._backend.cancel(self.state.rid, t)

    def tokens(self) -> Iterator[TokenEvent]:
        i = 0
        while True:
            while i < len(self.state.events):
                yield self.state.events[i]
                i += 1
            if self.state.done or not self._backend.step():
                while i < len(self.state.events):   # events from last step
                    yield self.state.events[i]
                    i += 1
                return

    __iter__ = tokens

    def result(self) -> ServedResult:
        while not self.state.done and self._backend.step():
            pass
        stored = self._backend.results.get(self.state.rid)
        if stored is not None:
            return stored
        # backend went idle (horizon hit, failed instance, ...) with the
        # request unfinished: surface a snapshot instead of crashing
        return ServedResult.from_state(self.state)


@runtime_checkable
class ServingBackend(Protocol):
    """One protocol for live clusters and discrete-event simulators.

    `submit` enqueues a request at virtual time `t` (default: the
    request's `arrive`) and returns a `ServeHandle`; `step` processes one
    event (False when idle); `run_until(t)` processes events up to and
    including time `t`; `drain()` runs to quiescence and returns the
    accumulated `{rid: ServedResult}`; `cancel(rid, t)` aborts a request
    at any lifecycle stage, releasing pages/pins/parked bytes.
    """
    results: Dict[int, ServedResult]

    def submit(self, request: Any, t: Optional[float] = None, *,
               sampling: SamplingParams = GREEDY,
               on_token: Optional[Callable] = None) -> ServeHandle: ...
    def step(self) -> bool: ...
    def run_until(self, t: float) -> None: ...
    def drain(self) -> Dict[int, ServedResult]: ...
    def cancel(self, rid: int, t: Optional[float] = None) -> bool: ...


class BackendBase:
    """Event-loop plumbing shared by every `ServingBackend`: lifecycle
    records, submit/cancel event scheduling, step/run_until/drain, token
    emission (on_token callbacks + the online `SLOTracker`), and the
    leak-free cancellation frame.

    Subclasses implement `_do_submit(state, t)` (build backend-side state
    and push the arrive event), `_handle(t, kind, payload)` (the event
    handlers), and `_do_cancel(state, t)` (release whatever the request
    holds at its current lifecycle stage).
    """

    def _init_backend(self, tracker=None, tracer=None, metrics=None):
        from ..core.scheduler import EventLoop
        from ..core.telemetry import NULL_TRACER
        self._ev = EventLoop()
        self._states: Dict[int, RequestState] = {}
        self.results: Dict[int, ServedResult] = {}
        self.tracker = tracker
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        # per-token TokenEvent recording; simulator shims turn this off
        # for bulk goodput sweeps (millions of simulated tokens) — a
        # tracker or a per-request on_token callback still records
        self._record_tokens = True
        self._ontoken_rids: set = set()

    @property
    def now(self) -> float:
        return self._ev.now

    def next_time(self) -> Optional[float]:
        """Timestamp of the next event this backend would process, or None
        when idle (simulator backends clamp this to their horizon). A
        fleet router interleaves replicas by this clock."""
        return self._ev.peek_time()

    @property
    def states(self) -> Dict[int, RequestState]:
        return self._states

    # -- submission ----------------------------------------------------
    def submit(self, request: Any, t: Optional[float] = None, *,
               sampling: SamplingParams = GREEDY,
               on_token: Optional[Callable] = None) -> ServeHandle:
        """Enqueue one request at virtual time `t` (default: its own
        `arrive`; passing `t` re-stamps the arrival, so open-loop callers
        can submit "now" while the loop is running)."""
        if t is None:
            t = request.arrive
        else:
            request.arrive = t
        assert request.rid not in self._states, request.rid
        state = RequestState(request, sampling or GREEDY, on_token=on_token)
        self._states[request.rid] = state
        if on_token is not None:
            self._ontoken_rids.add(request.rid)
        self._do_submit(state, t)
        cancel_at = getattr(request, "cancel_at", None)
        if cancel_at is not None:       # trace-driven cancellation
            self._ev.push(max(cancel_at, t), "cancel", state)
        return ServeHandle(self, state)

    # -- clock ---------------------------------------------------------
    def step(self) -> bool:
        """Process one event; False when the loop is idle."""
        if not self._ev:
            return False
        t, kind, payload = self._ev.pop()
        if kind == "cancel":
            self._apply_cancel(payload, t)
        else:
            self._handle(t, kind, payload)
        return True

    def run_until(self, t: float) -> None:
        while True:
            nxt = self._ev.peek_time()
            if nxt is None or nxt > t:
                return
            if not self.step():     # backend refused (e.g. sim horizon)
                return

    def drain(self) -> Dict[int, ServedResult]:
        while self.step():
            pass
        return self.results

    # -- cancellation --------------------------------------------------
    def cancel(self, rid: int, t: Optional[float] = None) -> bool:
        """Abort a request at any lifecycle stage. `t=None` applies at
        the loop's current time; otherwise a cancel event is scheduled.
        Returns False if the request is unknown or already terminal."""
        state = self._states.get(rid)
        if state is None or state.done:
            return False
        if t is None:
            self._apply_cancel(state, self._ev.now)
        else:
            self._ev.push(t, "cancel", state)
        return True

    def _apply_cancel(self, state: RequestState, t: float):
        if state.done:
            return
        self._do_cancel(state, t)
        # tokens stamped beyond the cancel point never happened
        state.events = [e for e in state.events if e.t <= t]
        seq = state.seq
        if seq is not None:
            drop = seq.produced - len(state.events)
            if drop > 0:
                del seq.tokens[-drop:]
                seq.produced = len(state.events)
            seq.done = True
        state.finish(t, FINISH_CANCELLED)
        self._store_result(state)

    # -- lifecycle plumbing for subclasses -----------------------------
    @property
    def _recording(self) -> bool:
        return (self._record_tokens or self.tracker is not None
                or self.tracer.enabled)

    def _emit_token(self, state: RequestState, token: int, t: float):
        if not self._record_tokens and self.tracker is None \
                and state.on_token is None and not self.tracer.enabled:
            return
        state.record_token(token, t)
        if self.tracer.enabled:
            self.tracer.event("token", t, rid=state.rid,
                              i=len(state.events) - 1)
        if self.tracker is not None:
            self.tracker.observe_event(state, state.events[-1])

    def _finish_state(self, state: RequestState, t: float,
                      reason: Optional[str] = None):
        if state.done:
            return
        if reason is None:
            reason = (state.seq.finish_reason if state.seq is not None
                      else FINISH_LENGTH)
        state.finish(t, reason)
        self._store_result(state)

    def _store_result(self, state: RequestState):
        seq = state.seq
        if seq is not None:     # sync cache hits back onto the Request
            state.request.prefix_hit = seq.prefix_hit
            state.request.decode_hit = seq.decode_hit
            # decode iterations that ran (sim backends maintain this
            # themselves); keeps Request.tpot meaningful on early stops
            state.request.tokens_done = max(len(state.events) - 1, 0)
        self.results[state.rid] = ServedResult.from_state(state)
        self._forget(state.rid)
        if self.tracer.enabled:
            self.tracer.finish_phase(state.rid, state.request.finish,
                                     state.status.name)
        if self.metrics is not None:
            self._observe_metrics(state)
        if self.tracker is not None:
            self.tracker.observe_finish(state)

    def _observe_metrics(self, state: RequestState):
        m, req, n = self.metrics, state.request, len(state.events)
        if state.status is RequestStatus.CANCELLED:
            m.counter("requests_shed" if state.finish_reason == FINISH_SHED
                      else "requests_cancelled")
        elif state.status is RequestStatus.FAILED:
            m.counter("requests_failed")
        else:
            m.counter("requests_finished")
            if n:
                m.observe("ttft_s", req.first_token - req.arrive)
                m.observe("e2e_s", req.finish - req.arrive)
            if n > 1:
                m.observe("tpot_s", (req.finish - req.first_token) / (n - 1))
        m.counter("tokens_emitted", n)

    def _forget(self, rid: int):
        """Drop per-request hot-loop bookkeeping once a request goes
        terminal (keeps fast paths enabled and containers bounded in
        long-running open-loop use)."""
        self._ontoken_rids.discard(rid)

    # subclass responsibilities
    def _do_submit(self, state: RequestState, t: float):
        raise NotImplementedError

    def _handle(self, t: float, kind: str, payload: Any):
        raise NotImplementedError

    def _do_cancel(self, state: RequestState, t: float):
        raise NotImplementedError


def sequence_tokens(cfg, request, rng) -> List[int]:
    """One place that turns a workload Request into engine token ids.

    Shared-prefix traces carry explicit ids (`request.tokens`); plain
    length-only requests draw them from `rng` — previously copied (with a
    hardcoded default_rng(0)) between `DisaggCluster.run` and
    `ColocatedCluster.run`.  The rng is owned by the backend and seeded
    by its explicit `seed` parameter; draws happen in submission order,
    so the legacy submit-all shims reproduce the historical streams.
    """
    if request.tokens is not None:
        return [int(t) % cfg.vocab_size for t in request.tokens]
    return rng.integers(1, cfg.vocab_size, size=request.in_len).tolist()
