# From src/repro/core/telemetry.py, less its rid-hash sampling and its
# wall-clock stamps (the port's profiler ranges give the shared clock), and
# with the `host` span category of the port's engine steps.
"""Unified request-lifecycle tracing + metrics for live and simulated serving.

Every `ServingBackend` (live cluster or discrete-event simulator) can carry a
`Tracer`: a virtual-clock span recorder with one lane per engine instance and
a per-request *phase* state machine mirroring `RequestStatus`.  Both worlds
emit the same span schema at the same lifecycle points, so a pinned trace
replayed on the simulator and on the live cluster (with an `EngineCharge`
virtual step-time model) produces span sequences a test can diff
timestamp-for-timestamp — the tracing twin of the dispatch-decision and
transfer-charge parity the repo already pins.

Span schema (categories):

  phase   one span per `RequestStatus` residence of a request: ``queued``,
          ``prefilling``, ``migrating``, ``pending_admit``, ``decoding``.
          The terminal transition appends a span event named ``FINISHED`` /
          ``CANCELLED`` / ``FAILED``.  Lane = the instance holding the
          request (``prefill0``, ``decode1``, ``engine0``).
  compute one span per prefill kernel dispatch: ``prefill_batch`` (whole
          prompt) or ``chunk`` (chunked prefill, args ``tokens``/``ctx``).
  step    one span per decode iteration on an instance lane (args
          ``batch``, ``compute`` = pure step seconds before any KV-stream
          pipelining stall).
  wire    one span per KV migration pull on a ``wire:src->dst`` lane
          (args ``bytes``; streamed pulls also carry ``t_first``).
  host    the live cluster's host time, on a real clock, while tracing:
          each engine step's phases, children of its step span (arg
          ``step`` = the parent's index in `Tracer.spans`) at the step's
          virtual start plus their host offsets -- ``decode.launch`` /
          ``prefill.launch`` (the model's calls until they return),
          ``.sync`` (the wait for the device; launch + sync is the charged
          step) and ``.sample`` (the token's readback) -- and ``admit``, a
          migration's page write on the decode instance (args ``host_s``,
          ``pages``, ``device_s``). None under an `EngineCharge`. The same
          names are `torch.profiler.record_function` ranges, inside the
          umbrella ranges ``decode_step`` / ``prefill_batch`` / ``chunk``
          and the event loop's ``cluster.<event>`` ranges.

Instant events: ``token`` (per emitted token, args ``i``), ``route_prefill``
/ ``route_decode`` (dispatcher decisions, args ``instance``/``hit``),
``park`` / ``park_chunk`` / ``grant`` (transfer-manager landings).

The disabled path is `NULL_TRACER` (the default everywhere): every method is
a no-op and backends keep their token-emission fast paths, so tracing off is
behavior-identical to not having this module at all.

`MetricsRegistry` is the counters/gauges/histograms side: push (`counter`,
`gauge`, `observe`) plus pull (`register` a collector callable sampled at
`snapshot()` time — page-pool occupancy, refcounts, queue depths cost
nothing until somebody asks).  `prometheus()` renders the text exposition
format; `to_chrome_trace` / `save_chrome_trace` render Perfetto-loadable
Chrome trace JSON, and `validate_chrome_trace` is the schema checker CI runs
against exported traces.

`attribute_request` decomposes one request's latency from its spans: TTFT
into queue + prefill-compute + prefill-stall (chunk round-robin waits), the
decode-startup path into migration + admission, and TPOT into batch-wait +
step-compute.  `goodput.SLOTracker` attaches this to SLO violations so a
miss comes annotated with its dominant cause.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Span", "SpanEvent", "Instant", "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry", "Attribution", "attribute_request",
    "to_chrome_trace", "save_chrome_trace", "validate_chrome_trace",
]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpanEvent:
    """Typed event attached inside a span (e.g. the terminal status)."""
    name: str
    t: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Instant:
    """Global instant event (token emission, routing decision, ...)."""
    name: str
    t: float
    rid: Optional[int] = None
    lane: Optional[str] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Span:
    cat: str
    name: str
    lane: str
    t0: float
    rid: Optional[int] = None
    t1: Optional[float] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events: List[SpanEvent] = dataclasses.field(default_factory=list)

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class NullTracer:
    """Disabled tracer: every hook is a constant-time no-op.  Backends
    check only `enabled` on hot paths; everything else may call through
    unconditionally."""
    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    def begin(self, *a, **k):
        return None

    def end(self, *a, **k):
        return None

    def complete(self, *a, **k):
        return None

    def event(self, *a, **k):
        return None

    def phase(self, *a, **k):
        return None

    def finish_phase(self, *a, **k):
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Virtual-clock span recorder.

    `begin`/`end` manage explicit spans (every opened span must close
    exactly once — double closes and time-travel raise); `complete` records
    an already-finished span; `phase` drives the per-request phase state
    machine (ends the previous phase span at the transition time, opens the
    next; re-entering the same phase+lane is a no-op, which is what chunked
    prefill's re-queue does); `finish_phase` closes the open phase with a
    terminal `SpanEvent` (``FINISHED`` / ``CANCELLED`` / ``FAILED``).
    """
    enabled = True

    def __init__(self):
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self.terminals: Dict[int, Tuple[str, float]] = {}
        self._open_phase: Dict[int, Span] = {}

    # -- explicit spans -------------------------------------------------
    def begin(self, cat: str, name: str, t: float, lane: str,
              rid: Optional[int] = None, **args) -> Span:
        sp = Span(cat, name, lane, t, rid=rid, args=args)
        self.spans.append(sp)
        return sp

    def end(self, span: Span, t: float, **args):
        if span.t1 is not None:
            raise ValueError(f"span closed twice: {span.cat}/{span.name} "
                             f"rid={span.rid}")
        if t < span.t0:
            raise ValueError(f"span ends before it starts: {span.name} "
                             f"{t} < {span.t0}")
        span.t1 = t
        if args:
            span.args.update(args)

    def complete(self, cat: str, name: str, t0: float, t1: float, lane: str,
                 rid: Optional[int] = None, **args) -> Span:
        sp = self.begin(cat, name, t0, lane, rid=rid, **args)
        self.end(sp, t1)
        return sp

    def event(self, name: str, t: float, rid: Optional[int] = None,
              lane: Optional[str] = None, **args):
        self.instants.append(Instant(name, t, rid=rid, lane=lane, args=args))

    # -- per-request phase state machine --------------------------------
    def phase(self, rid: int, name: str, t: float, lane: str, **args):
        cur = self._open_phase.get(rid)
        if cur is not None:
            if cur.name == name and cur.lane == lane:
                return                          # chunked re-entry: no-op
            self.end(cur, t)
        self._open_phase[rid] = self.begin("phase", name, t, lane,
                                           rid=rid, **args)

    def finish_phase(self, rid: int, t: float, terminal: str):
        self.terminals[rid] = (terminal, t)
        cur = self._open_phase.pop(rid, None)
        if cur is None:                         # e.g. cancel pre-arrival
            self.event(terminal, t, rid=rid)
            return
        cur.events.append(SpanEvent(terminal, t))
        self.end(cur, max(t, cur.t0))

    # -- queries --------------------------------------------------------
    def open_spans(self) -> List[Span]:
        return [s for s in self.spans if s.open]

    def for_rid(self, rid: int) -> List[Span]:
        return [s for s in self.spans if s.rid == rid]

    def tokens_for(self, rid: int) -> List[Instant]:
        return [i for i in self.instants
                if i.rid == rid and i.name == "token"]

    def lanes(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.lane)
        for i in self.instants:
            if i.lane is not None:
                seen.setdefault(i.lane)
        return sorted(seen, key=_lane_sort_key)


def _lane_sort_key(lane: str) -> Tuple[int, str]:
    for rank, prefix in enumerate(("prefill", "engine", "decode", "wire")):
        if lane.startswith(prefix):
            return (rank, lane)
    return (9, lane)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Counters / gauges / histograms with a pull-collector side channel.

    Push: `counter(name, inc)`, `gauge(name, value)`, `observe(name, v)`
    (histogram sample).  Pull: `register(fn)` where `fn() -> {name: value}`
    is sampled at `snapshot()` time — components expose page occupancy,
    refcounts, and queue depths without any hot-path bookkeeping.
    """

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}
        self._collectors: List[Callable[[], Dict[str, float]]] = []

    def counter(self, name: str, inc: float = 1.0):
        self._counters[name] = self._counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float):
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float):
        self._hists.setdefault(name, []).append(float(value))

    def register(self, fn: Callable[[], Dict[str, float]]):
        self._collectors.append(fn)

    def snapshot(self) -> Dict[str, float]:
        from ..serving.api import percentile
        out: Dict[str, float] = dict(self._counters)
        out.update(self._gauges)
        for name, xs in self._hists.items():
            out[f"{name}_count"] = float(len(xs))
            out[f"{name}_sum"] = float(sum(xs))
            out[f"{name}_min"] = min(xs) if xs else 0.0
            out[f"{name}_max"] = max(xs) if xs else 0.0
            out[f"{name}_p50"] = percentile(xs, 0.5)
            out[f"{name}_p99"] = percentile(xs, 0.99)
        for fn in self._collectors:
            for k, v in fn().items():
                out[k] = float(v)
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition format snapshot."""
        snap = self.snapshot()
        counters = set(self._counters)
        lines: List[str] = []
        for name in sorted(snap):
            metric = _prom_name(name)
            kind = "counter" if name in counters else "gauge"
            lines.append(f"# TYPE {metric} {kind}")
            lines.append(f"{metric} {snap[name]:.9g}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", n):
        n = "_" + n
    return "repro_" + n


# ---------------------------------------------------------------------------
# latency attribution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Attribution:
    """Where one request's latency went, decomposed from its spans.

    TTFT = router_queue + queue + prefill_compute + prefill_stall (chunk
    round-robin waits between this prompt's chunks); router_queue is the
    time a fleet router held the request before dispatching it to a
    replica (0 when no router is in the path).  Decode startup
    (first-token -> first decode iteration) = migrate + admit.  TPOT
    decomposes each inter-token gap into the emitting decode step's pure
    compute vs batch-wait (queueing behind other members' steps, KV-stream
    pipelining stalls, and — on colocated engines — prefill interference).
    """
    rid: int
    arrive: float
    ttft: float
    tpot: float
    n_tokens: int
    queue_s: float
    prefill_compute_s: float
    prefill_stall_s: float
    migrate_s: float
    admit_s: float
    decode_compute_s: float
    decode_wait_s: float
    terminal: str = "FINISHED"
    router_queue_s: float = 0.0

    def ttft_parts(self) -> Dict[str, float]:
        return {"router_queue": self.router_queue_s,
                "queue": self.queue_s,
                "prefill_compute": self.prefill_compute_s,
                "prefill_stall": self.prefill_stall_s}

    def tpot_parts(self) -> Dict[str, float]:
        return {"step_compute": self.decode_compute_s,
                "batch_wait": self.decode_wait_s}

    @property
    def dominant_ttft(self) -> str:
        parts = self.ttft_parts()
        return max(parts, key=lambda k: parts[k])

    @property
    def dominant_tpot(self) -> str:
        parts = self.tpot_parts()
        return max(parts, key=lambda k: parts[k])

    def format(self) -> str:
        return (f"rid={self.rid} ttft={self.ttft:.4f}s "
                f"(router={self.router_queue_s:.4f} "
                f"queue={self.queue_s:.4f} "
                f"prefill={self.prefill_compute_s:.4f} "
                f"stall={self.prefill_stall_s:.4f}) "
                f"startup(migrate={self.migrate_s:.4f} "
                f"admit={self.admit_s:.4f}) "
                f"tpot={self.tpot:.4f}s "
                f"(compute={self.decode_compute_s:.4f} "
                f"wait={self.decode_wait_s:.4f}) "
                f"dominant={self.dominant_ttft}/{self.dominant_tpot}")


def attribute_request(tracer: Tracer, rid: int) -> Optional[Attribution]:
    """Decompose one request's TTFT/TPOT from its recorded spans; None if
    the tracer never saw the request."""
    phases = [s for s in tracer.for_rid(rid) if s.cat == "phase"]
    if not phases:
        return None
    arrive = min(s.t0 for s in phases)
    tokens = tracer.tokens_for(rid)
    first_t = tokens[0].t if tokens else None
    last_t = tokens[-1].t if tokens else None

    def phase_dur(name: str) -> float:
        return sum(s.dur for s in phases if s.name == name and not s.open)

    router_queue_s = phase_dur("router_queued")
    queue_s = phase_dur("queued")
    prefill_s = phase_dur("prefilling")
    compute_s = sum(s.dur for s in tracer.for_rid(rid)
                    if s.cat == "compute" and not s.open)
    stall_s = max(prefill_s - compute_s, 0.0)
    migrate_s = phase_dur("migrating")
    admit_s = phase_dur("pending_admit")

    ttft = (first_t - arrive) if first_t is not None else 0.0
    n = len(tokens)
    tpot = (last_t - first_t) / (n - 1) if n > 1 else 0.0

    # per-gap wait/compute split against the decode lane's step spans
    decode_lanes = {s.lane for s in phases
                    if s.name in ("decoding", "prefilling")}
    steps: Dict[Tuple[str, float], Span] = {}
    for s in tracer.spans:
        if s.cat == "step" and s.lane in decode_lanes and not s.open:
            steps[(s.lane, s.t1)] = s
    compute = wait = 0.0
    for a, b in zip(tokens, tokens[1:]):
        gap = b.t - a.t
        sp = None
        for lane in decode_lanes:
            sp = steps.get((lane, b.t))
            if sp is not None:
                break
        if sp is None:
            compute += gap              # untracked step: assume compute
            continue
        c = min(float(sp.args.get("compute", sp.dur)), gap)
        compute += c
        wait += gap - c
    terminal, _ = tracer.terminals.get(rid, ("FINISHED", 0.0))
    return Attribution(rid, arrive, ttft, tpot, n, queue_s, compute_s,
                       stall_s, migrate_s, admit_s, compute, wait, terminal,
                       router_queue_s=router_queue_s)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

_US = 1e6


def to_chrome_trace(tracer: Tracer,
                    metrics: Optional[MetricsRegistry] = None) -> Dict:
    """Render the tracer as Chrome-trace JSON (Perfetto-loadable).

    One process (pid) per lane, complete ("X") events for spans, instant
    ("i") events for tokens/decisions/landings, and flow arrows ("s"/"f")
    following each request across lanes (prefill -> decode migration).
    Events are globally sorted by timestamp; open spans (crashed runs)
    export with dur=0 and ``"open": true``.
    """
    lanes = tracer.lanes()
    pid_of = {lane: i + 1 for i, lane in enumerate(lanes)}

    # instants without a lane (tokens, routes) attach to the lane of the
    # request's phase span covering their timestamp
    by_rid: Dict[int, List[Span]] = {}
    for s in tracer.spans:
        if s.cat == "phase" and s.rid is not None:
            by_rid.setdefault(s.rid, []).append(s)
    for spans in by_rid.values():
        spans.sort(key=lambda s: s.t0)

    def lane_at(rid: Optional[int], t: float) -> Optional[str]:
        best = None
        for s in by_rid.get(rid, ()):
            if s.t0 <= t and (s.t1 is None or t <= s.t1):
                best = s.lane
            elif s.t0 > t:
                break
        return best

    meta: List[Dict] = []
    for lane in lanes:
        meta.append({"name": "process_name", "ph": "M", "pid": pid_of[lane],
                     "tid": 0, "args": {"name": lane}})
        meta.append({"name": "process_sort_index", "ph": "M",
                     "pid": pid_of[lane], "tid": 0,
                     "args": {"sort_index": pid_of[lane]}})

    events: List[Dict] = []
    for s in tracer.spans:
        args = {k: v for k, v in s.args.items()}
        if s.rid is not None:
            args["rid"] = s.rid
        ev = {"name": s.name, "cat": s.cat, "ph": "X", "ts": s.t0 * _US,
              "dur": (s.dur if not s.open else 0.0) * _US,
              "pid": pid_of[s.lane], "tid": 0, "args": args}
        if s.open:
            ev["args"]["open"] = True
        events.append(ev)
        for se in s.events:
            events.append({"name": se.name, "cat": s.cat, "ph": "i",
                           "s": "t", "ts": se.t * _US, "pid": pid_of[s.lane],
                           "tid": 0, "args": dict(se.args, rid=s.rid)})
    for i in tracer.instants:
        lane = i.lane or lane_at(i.rid, i.t)
        if lane is None:
            lane = lanes[0] if lanes else "global"
            if lane not in pid_of:
                pid_of[lane] = len(pid_of) + 1
                meta.append({"name": "process_name", "ph": "M",
                             "pid": pid_of[lane], "tid": 0,
                             "args": {"name": lane}})
        args = dict(i.args)
        if i.rid is not None:
            args["rid"] = i.rid
        events.append({"name": i.name, "cat": "instant", "ph": "i",
                       "s": "t", "ts": i.t * _US, "pid": pid_of[lane],
                       "tid": 0, "args": args})
    # flow arrows: a request hopping lanes between consecutive phase spans
    for rid, spans in by_rid.items():
        for a, b in zip(spans, spans[1:]):
            if a.lane == b.lane or a.t1 is None:
                continue
            events.append({"name": "request", "cat": "flow", "ph": "s",
                           "id": rid, "ts": a.t1 * _US, "pid": pid_of[a.lane],
                           "tid": 0, "args": {"rid": rid}})
            events.append({"name": "request", "cat": "flow", "ph": "f",
                           "bp": "e", "id": rid, "ts": b.t0 * _US,
                           "pid": pid_of[b.lane], "tid": 0,
                           "args": {"rid": rid}})
    events.sort(key=lambda e: e["ts"])
    out: Dict[str, Any] = {"traceEvents": meta + events,
                           "displayTimeUnit": "ms"}
    if metrics is not None:
        out["otherData"] = {"metrics": metrics.snapshot()}
    return out


def save_chrome_trace(path: str, tracer: Tracer,
                      metrics: Optional[MetricsRegistry] = None) -> Dict:
    doc = to_chrome_trace(tracer, metrics)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


_PHASES = set("XBEisfM")


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema checker for exported traces: well-formed events, globally
    monotone timestamps, matched begin/end, non-negative durations, and
    flow arrows whose finish has a matching start.  Returns a list of
    error strings (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a Chrome-trace object (missing traceEvents)"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    last_ts = None
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    flow_started = set()
    for n, ev in enumerate(evs):
        where = f"event[{n}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing name")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"{where}: missing/non-numeric ts")
            continue
        if ts < 0:
            errors.append(f"{where}: negative ts {ts}")
        if last_ts is not None and ts < last_ts:
            errors.append(f"{where}: non-monotone ts {ts} < {last_ts}")
        last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"{where}: E without matching B on {key}")
            else:
                stack.pop()
        elif ph == "s":
            flow_started.add((ev.get("id"), ev.get("name")))
        elif ph == "f":
            if (ev.get("id"), ev.get("name")) not in flow_started:
                errors.append(f"{where}: flow finish without start "
                              f"id={ev.get('id')!r}")
    for key, stack in stacks.items():
        if stack:
            errors.append(f"unclosed B events on {key}: {stack}")
    return errors


def _main(argv: List[str]) -> int:
    """CLI: ``python -m repro_torch.core.telemetry trace.json [...]``
    validates exported traces against the schema checker (CI uses this)."""
    if not argv:
        print("usage: python -m repro_torch.core.telemetry TRACE.json [...]")
        return 2
    rc = 0
    for path in argv:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable: {e}")
            rc = 1
            continue
        errs = validate_chrome_trace(doc)
        n = len([e for e in doc.get("traceEvents", [])
                 if isinstance(e, dict)]) if isinstance(doc, dict) else 0
        if errs:
            print(f"{path}: INVALID ({len(errs)} errors, {n} events)")
            for e in errs[:20]:
                print(f"  {e}")
            rc = 1
        else:
            print(f"{path}: ok ({n} events)")
    return rc


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
