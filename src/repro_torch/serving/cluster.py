# Copied from src/repro/serving/cluster.py; `.engine` is the port's engine,
# every cluster takes a `device` that it hands to its engines, and
# `ServingCluster` / `DisaggCluster` a storage `dtype` for them. It stamps
# `Request.prefill_start` as `core/simulator.py` does, and while it traces
# it records each engine step's host phases and each admission's page
# write as `host` spans and `torch.profiler.record_function` ranges; its
# `decode_step` spans carry `graph`, 1 where the step replayed the decode
# engine's CUDA graph.
"""Role-unified live serving cluster on the port's PyTorch engines with
virtual-clock concurrency emulation (DistServe runtime, Fig. 6, extended
with runtime aggregation<->disaggregation).

`ServingCluster` holds N engine-backed instances, each carrying a *role*
-- ``"prefill"``, ``"decode"`` or ``"mixed"`` -- instead of the role
being baked into the class. A disaggregated deployment is a
prefill+decode role vector; the colocated (vLLM-like) baseline is the
degenerate "all instances mixed" case. `DisaggCluster` /
`ColocatedCluster` remain as thin shims that translate their legacy
constructor signatures into role vectors and produce byte-identical
schedules, token streams and dispatch decisions.

On top of the static roles (mirroring `core.simulator.SimServingBackend`,
the discrete-event twin of this class):

* `set_role(g, role)` flips an instance at runtime. The instance leaves
  the routing views immediately; queued-but-unstarted work is re-routed
  through the shared dispatcher; resident work (running decodes,
  granted/streaming KV, partial chunks) drains in place and the flip
  completes when the instance is idle -- a decode->prefill flip never
  strands or leaks KV pages; a prefill->decode flip drains within one
  batch/chunk time.
* chunked-prefill *absorption*: when every routable prefill queue is
  deeper than ``absorb_tokens``, new prompts spill to a decode/mixed
  instance which prefills them locally in bounded chunks between decode
  iterations (`Engine.prefill_chunk` in-place page writes; the KV never
  crosses the wire).

Both paths implement the `serving.api.ServingBackend` protocol: arrivals
are external submissions (`submit` returns a `ServeHandle`), the event
loop advances via `step` / `run_until(t)` / `drain()`, and every request
walks the `RequestStatus` state machine.  Controller: FCFS arrival queue
-> shortest-queue prefill dispatch -> pull-based, page-granular KV
migration -> least-loaded decode dispatch, all through the shared
scheduler core in `core.scheduler` (the same code the simulator runs).
Cancellation at any stage releases pages, prefix pins, and parked
transfer bytes without leaking.  Fault injection hooks exercise the
failover paths in core.fault.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from ..core.fault import HeartbeatMonitor
from ..core.kv_transfer import TransferManager, kv_bytes, pipelined_finish
from ..core.scheduler import DisaggDispatcher, FCFSQueue, least_loaded
from ..core.workload import Request
from .api import (FINISH_FAILED, GREEDY, BackendBase, RequestState,
                  RequestStatus, ServedResult, sequence_tokens)
from .engine import Engine, KVBlob, Sequence, release_blob

__all__ = ["ServingCluster", "DisaggCluster", "ColocatedCluster",
           "ServedResult"]


def _page_bytes(cfg, page_size: int, dtype_bytes: int = 2) -> Optional[int]:
    per_tok = cfg.kv_bytes_per_token(dtype_bytes)
    return per_tok * page_size if per_tok else None


def _slice_blob(blob, skip_tokens: int):
    """Drop the first `skip_tokens` positions from a migration blob — the
    decode side already holds that prefix, so only the suffix ships."""
    cache, n_tok = blob
    if not skip_tokens:
        return blob
    sliced = {k: ({"k": v["k"][:, :, skip_tokens:],
                   "v": v["v"][:, :, skip_tokens:]}
                  if k.startswith("seg") else v)
              for k, v in cache.items()}
    return sliced, n_tok


def _splice(e: Engine, seq: Sequence, blob, skip: int,
            pinned: List[int]) -> int:
    """The migration's page write: the wire payload into the decode
    engine's pages. A page-backed blob's payload is stitched by its
    prefill engine from its page pool (which drops its pins). Returns the
    payload's token count."""
    if isinstance(blob, KVBlob):
        wire = blob.owner.materialize_wire(blob, skip)
    else:
        wire = _slice_blob(blob, skip)
    e.insert_kv(seq, wire, shared=pinned, skip_tokens=skip)
    return wire[1]


class _LiveBackend(BackendBase):
    """Sequence construction shared with pre-unification code paths."""

    def _init_live(self, cfg, seed: int, tracker=None, tracer=None,
                   metrics=None):
        self.cfg = cfg
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._init_backend(tracker=tracker, tracer=tracer, metrics=metrics)

    def _reset_loop(self):
        """Fresh event loop, virtual clocks, and token rng (the legacy
        `run` contract: every replay of the same trace restarts at t=0
        and derives identical token streams)."""
        self._rng = np.random.default_rng(self.seed)
        self._init_backend(tracker=self.tracker,
                           tracer=self.tracer or None, metrics=self.metrics)
        self._reset_clocks()

    def _reset_clocks(self):
        raise NotImplementedError

    def _make_sequence(self, state: RequestState) -> Sequence:
        r, sp = state.request, state.sampling
        seq = Sequence(r.rid, sequence_tokens(self.cfg, r, self._rng),
                       sp.out_len(r.out_len),
                       sampling=None if sp == GREEDY else sp)
        state.seq = seq
        return seq


def _prefill_tok(s: Sequence) -> int:
    # queue load = tokens still to prefill (partial prompts re-queue
    # with their remaining suffix only)
    return max(len(s.tokens) - s.prefilled, 0)


def _mixed_tok(s: Sequence) -> int:
    return len(s.tokens)


class _LiveInstance:
    """Per-instance runtime state; `role` decides which containers are
    live. The engine and the birth `label` survive role flips (tracer
    lanes stay stable); the role-local `iid` is reassigned per flip (it
    keys transfer links and fresh metric rows, mirroring the simulator's
    twin-object iids)."""

    def __init__(self, gid: int, role: str, iid: int, engine: Engine,
                 label: str):
        self.gid = gid
        self.role = role
        self.iid = iid
        self.engine = engine
        self.label = label
        self.draining = False
        self.target: Optional[str] = None
        self.failed = False
        self.free_at = 0.0                  # virtual busy-until clock
        # prefill-role
        self.queue: FCFSQueue = FCFSQueue(token_of=_prefill_tok)
        # decode-role
        self.active: List[Sequence] = []
        # (state, skip_tokens, pinned_pages) awaiting decode admission
        self.pending: List[Tuple[RequestState, int, List[int]]] = []
        # (state, skip, pinned, reserved_pages): streamed chunked prefills
        # whose residency is granted, waiting for the final chunk to land
        self.granted: List[Tuple[RequestState, int, List[int], int]] = []
        # mixed-role
        self.waiting: FCFSQueue = FCFSQueue(token_of=_mixed_tok)
        # chunked-prefill absorption (decode-role intra-instance
        # aggregation): whole prompts spilled here under prefill bursts
        self.absorb: FCFSQueue = FCFSQueue(token_of=_prefill_tok)
        self.absorbing: set = set()         # rids mid-absorption

    @property
    def load(self) -> int:
        if self.role == "mixed":
            return len(self.waiting) + len(self.active)
        n = len(self.active) + len(self.pending) + len(self.granted)
        if self.absorb.items or self.absorbing:
            n += len(self.absorbing | {s.rid for s in self.absorb.items})
        return n

    def clear(self):
        self.free_at = 0.0
        self.active = []
        self.pending = []
        self.granted = []
        self.queue = FCFSQueue(token_of=_prefill_tok)
        self.waiting = FCFSQueue(token_of=_mixed_tok)
        self.absorb = FCFSQueue(token_of=_prefill_tok)
        self.absorbing = set()


class ServingCluster(_LiveBackend):
    """N role-carrying live engines behind one virtual-clock event loop
    (see the module docstring for semantics)."""

    def __init__(self, cfg, params, roles: Seq[str], *,
                 max_batch: int = 8, max_len: int = 256,
                 transfer_bandwidth: float = 50e9, lm_tokens: int = 256,
                 max_prefill_tokens: int = 512,
                 attn_blocks=(64, 64), page_size: int = 16,
                 decode_num_pages: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 paged: Optional[bool] = None,
                 prefix_cache: bool = False,
                 prefill_num_pages: Optional[int] = None,
                 fused_prefix: Optional[bool] = None,
                 chunk_tokens=None,
                 absorb_tokens: Optional[int] = None,
                 seed: int = 0, tracker=None, tracer=None,
                 charge=None, metrics=None, device=None, dtype=None):
        self._init_live(cfg, seed, tracker=tracker, tracer=tracer,
                        metrics=metrics)
        # optional deterministic charge model: replace measured kernel
        # times with `core.latency_model.EngineCharge` analytic times, so
        # the live event timeline (and trace) is float-identical to the
        # simulator's on the same request trace
        self.charge = charge
        if (prefix_cache or chunk_tokens) and prefill_num_pages is None:
            # a prefill engine's default pool (one resident sequence) has
            # no room to retain prefixes or to hold several chunked
            # prompts' reserved residencies; keep a few sequences' worth
            prefill_num_pages = 8 * -(-max_len // page_size) + 1
        self.prefix_cache = prefix_cache
        # device=None: the card (an engine raises when there is none);
        # dtype=None: the engines' default (f32)
        base = dict(max_len=max_len, attn_blocks=attn_blocks, paged=paged,
                    page_size=page_size, device=device)
        if dtype is not None:
            base["dtype"] = dtype
        # engines are shaped by their *birth* role (legacy-identical
        # configs for the shims); a flipped instance keeps its engine, so
        # dynamic deployments should size pools for both roles
        self._engine_kw = {
            "prefill": dict(base, max_batch=1, num_pages=prefill_num_pages,
                            prefix_cache=prefix_cache,
                            fused_prefix=fused_prefix),
            "decode": dict(base, max_batch=max_batch,
                           num_pages=decode_num_pages,
                           prefix_cache=prefix_cache),
            "mixed": dict(base, max_batch=max_batch, num_pages=num_pages),
        }
        self._params = params
        self.inst: List[_LiveInstance] = []
        self._iid_next = {"prefill": 0, "decode": 0, "mixed": 0}
        self.monitor = HeartbeatMonitor(timeout=1e9)
        for role in roles:
            self.inst.append(self._make_instance(role))
        # chunked prefill needs the paged runtime (in-place page writes);
        # chunk_tokens="auto" sizes the chunk from the latency model (the
        # live cluster reaches the model through its EngineCharge)
        if chunk_tokens == "auto":
            if charge is None:
                raise ValueError("chunk_tokens='auto' needs a "
                                 "charge=EngineCharge(lm, par) model")
            chunk_tokens = charge.lm.auto_chunk_tokens(
                charge.par, page_tokens=page_size)
        p0 = next((x for x in self.inst if x.role == "prefill"), None)
        self.chunk_tokens = (chunk_tokens if chunk_tokens and p0 is not None
                             and p0.engine.paged else None)
        # absorption: spill whole prompts to decode/mixed instances when
        # every routable prefill queue is deeper than absorb_tokens
        self.absorb_tokens = absorb_tokens
        self._absorb_chunk = self.chunk_tokens or chunk_tokens
        if absorb_tokens is not None and not self._absorb_chunk \
                and charge is not None:
            self._absorb_chunk = charge.lm.auto_chunk_tokens(
                charge.par, page_tokens=page_size)
        self.dispatcher = DisaggDispatcher()
        self.tx = TransferManager(transfer_bandwidth,
                                  page_bytes=_page_bytes(cfg, page_size),
                                  n_layers=cfg.num_layers)
        self.lm_tokens = lm_tokens
        self.max_prefill_tokens = max_prefill_tokens
        self.failed_prefill: set = set()
        self.failed_decode: set = set()
        # rid -> (decode_inst, src_inst, skip): streamed-migration route
        # chosen at first-chunk completion
        self._stream: Dict[int, Tuple[_LiveInstance, _LiveInstance,
                                      int]] = {}
        self._backlog: List[RequestState] = []  # arrivals held mid-re-role
        self._role_events: List[Tuple[float, str, str]] = []
        self.absorbed = 0
        self.busy_absorb = 0.0
        if self.tracer.enabled:
            self.tx.tracer = self.tracer
            self.dispatcher.tracer = self.tracer
        if metrics is not None:
            metrics.register(self._collect_metrics)

    # -- instance construction / role views ------------------------------
    def _make_instance(self, role: str) -> _LiveInstance:
        if role not in self._engine_kw:
            raise ValueError(f"unknown role {role!r}")
        iid = self._iid_next[role]
        self._iid_next[role] += 1
        label = f"engine{iid}" if role == "mixed" else f"{role}{iid}"
        engine = Engine(self.cfg, self._params, **self._engine_kw[role])
        engine.trace = self.tracer.enabled
        x = _LiveInstance(len(self.inst), role, iid, engine, label)
        self.monitor.register(label)
        return x

    def _role(self, role: str) -> List[_LiveInstance]:
        return [x for x in self.inst if x.role == role]

    @property
    def roles(self) -> List[str]:
        return [x.role for x in self.inst]

    # engine-list views (legacy attribute compatibility)
    @property
    def prefill(self) -> List[Engine]:
        return [x.engine for x in self._role("prefill")]

    @property
    def decode(self) -> List[Engine]:
        return [x.engine for x in self._role("decode")]

    @property
    def engines(self) -> List[Engine]:
        return [x.engine for x in self._role("mixed")]

    @property
    def queues(self) -> List[FCFSQueue]:
        return [x.queue for x in self._role("prefill")]

    def _collect_metrics(self) -> Dict[str, float]:
        """Pull-collector for a `MetricsRegistry`: per-engine dispatch and
        page-pool stats, queue depths, transfer-manager totals. Key names
        stay byte-identical to the legacy per-class collectors for static
        role vectors."""
        out: Dict[str, float] = {}
        P, D, E = (self._role("prefill"), self._role("decode"),
                   self._role("mixed"))
        for side, lst in (("prefill", P), ("decode", D)):
            for i, x in enumerate(lst):
                for k, v in x.engine.stats().items():
                    out[f"{side}{i}.{k}"] = v
        for i, x in enumerate(P):
            out[f"queue{i}.depth"] = len(x.queue)
            out[f"queue{i}.tokens"] = x.queue.queued_tokens
        if P or D:
            for k, v in self.tx.stats().items():
                out[f"tx.{k}"] = v
            out["decode_pending"] = sum(len(x.pending) for x in D)
            out["decode_granted"] = sum(len(x.granted) for x in D)
            out["decode_active"] = sum(len(x.active) for x in D)
        for i, x in enumerate(E):
            for k, v in x.engine.stats().items():
                out[f"engine{i}.{k}"] = v
            # pure-colocated fleets keep the legacy queue{i} keys; mixed
            # fleets with a prefill tier would collide, so nest them
            qk = f"engine{i}.queue" if (P or D) else f"queue{i}"
            out[f"{qk}.depth"] = len(x.waiting)
            out[f"{qk}.tokens"] = x.waiting.queued_tokens
            out[f"engine{i}.active"] = len(x.active)
        if self._role_events:        # dynamic fleets: expose role ids
            ids = {"prefill": 0.0, "decode": 1.0, "mixed": 2.0}
            for x in self.inst:
                out[f"{x.label}.role_id"] = ids[x.role]
                out[f"{x.label}.draining"] = float(x.draining)
            out["role_changes"] = float(len(self._role_events))
            out["absorbed"] = float(self.absorbed)
        return out

    # -- fault injection ------------------------------------------------
    def fail_decode(self, idx: int) -> List[int]:
        """Kill a decode instance; returns rids needing re-prefill."""
        d = self._role("decode")[idx]
        self.monitor.mark_failed(d.label)
        self.failed_decode.add(idx)
        d.failed = True
        # `_active` may predate the latest iteration's completion filter —
        # sequences that already finished are not lost
        lost = [s.rid for s in getattr(d.engine, "_active", [])
                if not s.done]
        return lost

    def fail_prefill(self, idx: int) -> List[int]:
        p = self._role("prefill")[idx]
        self.monitor.mark_failed(p.label)
        self.failed_prefill.add(idx)
        p.failed = True
        return [s.rid for s in p.queue.items]

    def _reset_clocks(self):
        for x in self.inst:
            x.clear()
        self._stream = {}
        self._backlog = []

    def _prefill_hits(self, tokens):
        if not self.prefix_cache:
            return None
        return [x.engine.prefix_peek(tokens) for x in self._role("prefill")]

    # -- ServingBackend hooks -------------------------------------------
    def _do_submit(self, state: RequestState, t: float):
        self._make_sequence(state)
        self._ev.push(t, "arrive", state)

    def _handle(self, t: float, kind: str, payload: Any):
        if self.tracer.enabled:
            # the event's host work, as a range on the profiler's clock
            with torch.profiler.record_function("cluster." + kind):
                self._dispatch(t, kind, payload)
        else:
            self._dispatch(t, kind, payload)

    def _dispatch(self, t: float, kind: str, payload: Any):
        if kind == "arrive":
            self._on_arrive(payload, t)
        elif kind == "poke_prefill":
            self._poke_prefill(payload, t)
        elif kind == "dispatch_decode":
            self._on_dispatch_decode(payload, t)
        elif kind == "predispatch_decode":
            self._on_predispatch(payload, t)
        elif kind == "finalize_stream":
            self._on_finalize_stream(payload, t)
        elif kind == "poke_decode":
            self._poke_decode(payload, t)
        elif kind == "poke":
            self._step_engine(payload, t)
        elif kind == "fail_decode":
            self._on_fail_decode(payload, t)

    # -- arrival routing -------------------------------------------------
    def _on_arrive(self, state: RequestState, t: float):
        if state.done:                      # cancelled before arrival
            return
        seq = state.seq
        P = self._role("prefill")
        alive = [j for j, x in enumerate(P)
                 if not x.failed and not x.draining]
        if not alive:
            # no routable prefill tier: colocated (all-mixed) deployment,
            # or a transient all-decode fleet -> absorb everywhere
            E = [x for x in self._role("mixed") if not x.draining]
            D_abs = [x for x in self._absorb_targets()
                     if x.role == "decode"]
            if E and not (self.absorb_tokens is not None and D_abs):
                self._mixed_arrive(state, t)
            elif not self._route_absorb(state, t):
                if any(x.target is not None for x in self.inst):
                    # mid-re-role transient: every sink is draining. Hold
                    # the arrival; `_complete_flip` re-dispatches it.
                    self._backlog.append(state)
                    state.where = ("backlog", None)
                    if self.tracer.enabled:
                        self.tracer.phase(state.rid, "queued", t, "backlog")
                    return
                raise RuntimeError(
                    "no routable prefill/mixed instance and absorption "
                    "is unavailable")
            return
        if (self.absorb_tokens is not None
                and min(P[j].queue.queued_tokens for j in alive)
                > self.absorb_tokens
                and self._route_absorb(state, t)):
            return
        qi = self.dispatcher.pick_prefill(state.rid, [x.queue for x in P],
                                          alive,
                                          hits=self._prefill_hits(seq.tokens),
                                          now=t)
        p = P[qi]
        p.queue.push(seq)
        state.where = ("prefill", p)
        if self.tracer.enabled:
            self.tracer.phase(state.rid, "queued", t, p.label)
        self._ev.push(t, "poke_prefill", p)

    def _absorb_targets(self) -> List[_LiveInstance]:
        """Instances that can take a whole prompt when the prefill tier is
        saturated: paged decode instances with chunk machinery, mixed
        engines."""
        out: List[_LiveInstance] = []
        for x in self.inst:
            if x.draining or x.failed:
                continue
            if x.role == "decode" and self._absorb_chunk \
                    and x.engine.paged:
                out.append(x)
            elif x.role == "mixed":
                out.append(x)
        return out

    def _route_absorb(self, state: RequestState, t: float) -> bool:
        targets = self._absorb_targets()
        if not targets:
            return False
        seq = state.seq
        loads = [float(x.load) for x in targets]
        ai = self.dispatcher.pick_absorb(state.rid, loads, now=t)
        x = targets[ai]
        self.absorbed += 1
        if x.role == "mixed":
            x.waiting.push(seq)
            state.where = ("engine", x)
            if self.tracer.enabled:
                self.tracer.phase(state.rid, "queued", t, x.label)
            self._ev.push(t, "poke", x)
        else:
            x.absorb.push(seq)
            state.where = ("absorb", x)
            if self.tracer.enabled:
                self.tracer.phase(state.rid, "queued", t, x.label)
            self._ev.push(t, "poke_decode", x)
        return True

    def _mixed_arrive(self, state: RequestState, t: float):
        E = [x for x in self._role("mixed") if not x.draining]
        e = E[least_loaded([x.load for x in E])]
        e.waiting.push(state.seq)
        state.where = ("engine", e)
        if self.tracer.enabled:
            self.tracer.phase(state.rid, "queued", t, e.label)
        self._ev.push(t, "poke", e)

    # -- prefill role -----------------------------------------------------
    def _poke_prefill(self, p: _LiveInstance, now: float):
        if p.role != "prefill" or p.failed:
            return
        if not p.queue.items:
            self._check_flip(p, now)
            return
        if p.free_at > now:                 # busy: come back when free
            self._ev.push(p.free_at, "poke_prefill", p)
            return
        if self.chunk_tokens:
            self._prefill_chunk_step(p, now)
            return
        batch = p.queue.form_batch(self.lm_tokens, max_batch=1)
        for seq in batch:
            state = self._states[seq.rid]
            state.to_status(RequestStatus.PREFILLING)
            req = state.request
            req.prefill_start = now
            first, blob, dt = p.engine.prefill_request(seq)
            if self.charge is not None:
                dt = self.charge.prefill([len(seq.tokens) - seq.prefix_hit])
            if self.tracer.enabled:
                self.tracer.phase(seq.rid, "prefilling", now, p.label)
                self.tracer.complete(
                    "compute", "prefill_batch", now, now + dt,
                    p.label, rid=seq.rid,
                    tokens=len(seq.tokens) - seq.prefix_hit,
                    hit=seq.prefix_hit)
                self._host_spans(p, now)
            seq.append_token(first)
            req.first_token = now + dt
            self._emit_token(state, first, now + dt)
            if seq.done:
                release_blob(blob)      # nothing will migrate: drop pins
                self._finish_state(state, now + dt)
            else:
                # decode target (and hence shipped bytes) is chosen at
                # dispatch time, where the decode-side prefix is known
                self._ev.push(now + dt, "dispatch_decode", (state, blob, p))
            p.free_at = now + dt
            self._ev.push(now + dt, "poke_prefill", p)

    def _prefill_chunk_step(self, p: _LiveInstance, now: float):
        """One chunk of the head-of-queue prompt. Unfinished prompts
        re-queue at the tail (chunk-granular round-robin), each finished
        chunk's KV is parked as a shippable segment, and the decode
        target is chosen at *first*-chunk completion so the wire can
        overlap the remaining chunks' compute."""
        e = p.engine
        # a page-blocked *new* head must not strand the resumable partials
        # queued behind it: their reservations free only by finishing, so
        # form_batch may drain them past the head (retry for the head
        # arrives via the poke each pull/finish schedules)
        batch = p.queue.form_batch(
            self.lm_tokens, max_batch=1, can_take=e.can_start_chunked,
            chunk_tokens=self.chunk_tokens, resumable=e.has_partial)
        if not batch:
            return
        seq = batch[0]
        state = self._states[seq.rid]
        req = state.request
        state.to_status(RequestStatus.PREFILLING)
        if not e.has_partial(seq):          # the first chunk
            req.prefill_start = now
        prev = seq.prefilled
        done, first, blob, dt, _c = e.prefill_chunk(seq, self.chunk_tokens)
        if self.charge is not None:
            dt = self.charge.chunk(_c, prev)
        t_end = now + dt
        if self.tracer.enabled:
            self.tracer.phase(seq.rid, "prefilling", now, p.label)
            self.tracer.complete("compute", "chunk", now, t_end,
                                 p.label, rid=seq.rid,
                                 tokens=_c, ctx=prev)
            self._host_spans(p, now)
        state.progress = seq.prefilled
        seg_bytes = kv_bytes(self.cfg, seq.prefilled) - \
            (kv_bytes(self.cfg, prev) if prev else 0)
        self.tx.park_partial(seq.rid, max(seg_bytes, 0), t_end)
        if not done:
            p.queue.push(seq)
            state.where = ("prefill", p)
            if seq.rid not in self._stream:
                self._ev.push(t_end, "predispatch_decode", (state, p))
        else:
            seq.append_token(first)
            req.first_token = t_end
            self._emit_token(state, first, t_end)
            if seq.done:                    # out_len == 1 / instant stop
                release_blob(blob)
                self._drop_stream(state, t_end)
                self.tx.drop_partial(seq.rid)
                self._finish_state(state, t_end)
            elif seq.rid in self._stream:
                self._ev.push(t_end, "finalize_stream", (state, blob))
            else:                           # single-chunk prompt
                self._ev.push(t_end, "dispatch_decode", (state, blob, p))
        p.free_at = t_end
        self._ev.push(t_end, "poke_prefill", p)

    # -- prefill -> decode handoff ----------------------------------------
    def _decode_cands(self, D: List[_LiveInstance]) -> List[int]:
        """Routable decode indices. Draining instances still accept work
        finished on a prefill instance when nothing else can (their flip
        waits for load to reach zero)."""
        cand = [j for j, x in enumerate(D)
                if not x.failed and not x.draining]
        return cand or [j for j, x in enumerate(D) if not x.failed]

    def _on_predispatch(self, payload, t: float):
        """First chunk landed: pick the decode target now so segments can
        be granted pages and start crossing the wire while later chunks
        are still computing."""
        state, src = payload
        if state.done or state.rid in self._stream:
            return
        seq, req = state.seq, state.request
        n_tok = len(seq.tokens)
        D = self._role("decode")
        cand = self._decode_cands(D)
        if not cand:        # aggregation drain: adopt at the final chunk
            return
        loads = [x.load for x in D]
        d_hits = None
        if self.prefix_cache:
            d_hits = [x.engine.prefix_peek(seq.tokens[:n_tok]) for x in D]
        di = self.dispatcher.pick_decode(req.rid, loads, cand, hits=d_hits,
                                         now=t)
        d = D[di]
        skip, pinned = d.engine.pin_prefix(seq.tokens[:n_tok])
        self._stream[state.rid] = (d, src, skip)
        d.pending.append((state, skip, pinned))
        self._ev.push(t, "poke_decode", d)

    def _on_finalize_stream(self, payload, t: float):
        """Final chunk landed: close the stream — park the page-backed
        blob with the decode-side ship size; admission (or the earlier
        grant) pulls the per-segment schedule."""
        state, blob = payload
        if state.done:                      # cancelled mid-final-chunk
            release_blob(blob)
            self.tx.drop_partial(state.rid)
            return
        if state.rid not in self._stream:
            # a decode-failure re-route (_on_fail_decode) reclaimed the
            # stream at this same timestamp and queued a fresh
            # predispatch behind this event; defer until that lands and
            # re-establishes the route
            self._ev.push(t, "finalize_stream", (state, blob))
            return
        d, src, skip = self._stream.pop(state.rid)
        seq = state.seq
        ship = blob.n_tok - skip
        nbytes = kv_bytes(self.cfg, ship) if ship else 0
        self.tx.park(seq.rid, blob, nbytes, t, src=src.iid)
        state.where = ("decode", d)
        state.to_status(RequestStatus.MIGRATING)
        if self.tracer.enabled:
            self.tracer.phase(seq.rid, "migrating", t, d.label)
        self._ev.push(t, "poke_decode", d)

    def _drop_stream(self, state: RequestState, t: float):
        """Remove every trace of a streamed chunked migration: the chosen
        route, the pending/granted decode-side entry (pins + page
        reservation), and the parked chunk segments."""
        rid = state.rid
        self.tx.drop_partial(rid)
        info = self._stream.pop(rid, None)
        if info is None:
            return
        d, _src, _skip = info
        for j, entry in enumerate(d.pending):
            if entry[0] is state:
                del d.pending[j]
                d.engine.unpin(entry[2])
                break
        for j, entry in enumerate(d.granted):
            if entry[0] is state:
                del d.granted[j]
                d.engine.unpin(entry[2])
                if not d.failed:
                    d.engine.unreserve(entry[3])
                break
        self._ev.push(t, "poke_decode", d)

    def _poke_src(self, src_iid: int, now: float):
        """The pull released prefill-side pages: a stalled chunked
        prefill may be able to start its next prompt now. Transfer links
        key on role-local iids; a source that has since flipped away
        needs no poke."""
        pk = next((x for x in self._role("prefill") if x.iid == src_iid),
                  None)
        if pk is not None:
            self._ev.push(now, "poke_prefill", pk)

    def _engine_adopt(self, state: RequestState, blob, now: float):
        """No decode-role instance remains (an aggregation re-role
        overlapped in-flight prefill work): hand the finished prefill
        straight to a mixed engine's batch. The KV is spliced locally;
        wire time is charged as zero — this only occurs in the drain
        transient."""
        E = [x for x in self._role("mixed") if not x.draining] \
            or self._role("mixed")
        seq, req = state.seq, state.request
        e = E[least_loaded([x.load for x in E])]
        wire = blob.owner.materialize_wire(blob, 0) \
            if isinstance(blob, KVBlob) else blob
        e.engine.insert_kv(seq, wire)
        self.tx.drop_partial(seq.rid)
        req.decode_admit = now
        req.transfer_done = now
        state.where = ("engine", e)
        state.to_status(RequestStatus.DECODING)
        if self.tracer.enabled:
            self.tracer.phase(seq.rid, "decoding", now, e.label)
        e.active.append(seq)
        self._ev.push(now, "poke", e)

    def _on_dispatch_decode(self, payload, t: float):
        state, blob, src = payload
        if state.done:                      # cancelled mid-prefill: the
            release_blob(blob)              # blob is dropped (fused blobs
            return                          # release their prefix pins)
        seq, req = state.seq, state.request
        D = self._role("decode")
        if not D:                           # aggregation drain transient
            self._engine_adopt(state, blob, t)
            return
        cand = self._decode_cands(D)
        loads = [x.load for x in D]
        n_tok = blob[1]
        d_hits = None
        if self.prefix_cache:
            d_hits = [x.engine.prefix_peek(seq.tokens[:n_tok]) for x in D]
        di = self.dispatcher.pick_decode(req.rid, loads, cand, hits=d_hits,
                                         now=t)
        d = D[di]
        # pin the decode-resident prefix and ship only the rest
        skip, pinned = d.engine.pin_prefix(seq.tokens[:n_tok])
        ship = n_tok - skip
        nbytes = kv_bytes(self.cfg, ship) if ship else 0
        src_iid = src.iid if isinstance(src, _LiveInstance) else src
        self.tx.park(seq.rid, blob, nbytes, t, src=src_iid)
        d.pending.append((state, skip, pinned))
        state.where = ("decode", d)
        state.to_status(RequestStatus.MIGRATING)
        if self.tracer.enabled:
            self.tracer.phase(seq.rid, "migrating", t, d.label)
        self._ev.push(t, "poke_decode", d)

    # -- decode role ------------------------------------------------------
    def _admit_one(self, d: _LiveInstance, state: RequestState, skip: int,
                   pinned: List[int], now: float):
        """Pull one parked request's KV over the wire and splice it in.
        `pull_streamed` charges the per-segment schedule for chunked
        streams and degenerates to the per-layer schedule for whole-blob
        parks."""
        seq, req = state.seq, state.request
        src = self.tx.parked[seq.rid].src
        blob, t_first, t_full = self.tx.pull_streamed(seq.rid, now,
                                                      dst=d.iid)
        if self.tracer.enabled and self.charge is None:
            self._traced_splice(d, seq, blob, skip, pinned, now)
        else:
            _splice(d.engine, seq, blob, skip, pinned)
        d.engine.unpin(pinned)
        # per-layer streaming: decode starts attending once the first
        # layer of the last chunk lands, not at blob-complete; a granted
        # stream's wire may have finished during prefill (t_full < now),
        # so both marks clamp forward to keep the timeline monotone
        seq.kv_first = max(now, t_first)
        seq.kv_full = max(t_full, seq.kv_first)
        req.decode_admit = seq.kv_first
        req.transfer_done = seq.kv_full
        state.to_status(RequestStatus.DECODING)
        if self.tracer.enabled:
            # decode starts attending at first-layer-landed, the same
            # instant the simulator stamps `decode_admit`
            self.tracer.phase(seq.rid, "decoding", seq.kv_first, d.label)
        d.active.append(seq)
        self._poke_src(src, now)

    def _traced_splice(self, d: _LiveInstance, seq: Sequence, blob,
                       skip: int, pinned: List[int], now: float):
        """`_splice` inside an `admit` range, recorded as an `admit` span
        (category host, at the admission's virtual instant plus its host
        seconds) with args `host_s` and the `pages` written. Its device
        time is the device trace's, of the operations the range launches:
        two CUDA events around the write would time the host's launches
        too, since the device waits idle for them."""
        e = d.engine
        with torch.profiler.record_function("admit"):
            h0 = time.perf_counter()
            n_tok = _splice(e, seq, blob, skip, pinned)
            host_s = time.perf_counter() - h0
        pages = -(-n_tok // e._kv.page_size) - len(pinned) if e.paged else 0
        self.tracer.complete("host", "admit", now, now + host_s, d.label,
                             rid=seq.rid, host_s=host_s, pages=pages)

    def _host_spans(self, x: _LiveInstance, now: float):
        """The engine's last step phases (`Engine.phases`) as `host` spans,
        children of the step span just recorded (arg `step`: its index in
        `tracer.spans`), at the step's virtual start plus their host
        offsets. Under a charge the virtual step is the model's time, not
        the host's, so there are none."""
        if self.charge is not None:
            return
        parent = len(self.tracer.spans) - 1
        for name, a, b in x.engine.phases:
            self.tracer.complete("host", name, now + a, now + b, x.label,
                                 step=parent)

    def _poke_decode(self, d: _LiveInstance, now: float):
        if d.role != "decode" or d.failed:
            return
        if d.free_at > now:
            self._ev.push(d.free_at, "poke_decode", d)
            return
        e = d.engine
        pending = d.pending
        granted = d.granted

        # pull-based admission against free KV pages (paper §4.3);
        # shared prefix pages are already resident, so only the
        # suffix needs fresh pages
        def admit_ready():
            # granted streams whose final chunk has landed insert first
            # (their pages are already held; the wire has been moving
            # since the grant)
            progress = True
            while progress:
                progress = False
                for j, (state, skip, pinned, n_res) in enumerate(granted):
                    if self.tx.has_parked(state.rid):
                        del granted[j]
                        e.unreserve(n_res)
                        self._admit_one(d, state, skip, pinned, now)
                        progress = True
                        break
            while pending:
                state, skip, pinned = pending[0]
                if d.absorbing and len(d.active) + len(d.absorbing) \
                        >= e.max_batch:
                    break       # absorbed residents hold future slots
                if not e.can_admit(state.seq, len(pinned)):
                    break
                pending.pop(0)
                if not self.tx.has_parked(state.rid):
                    # streamed chunked prefill still computing: grant its
                    # residency so parked segments start crossing now
                    n_res = e.reserve_for(state.seq, len(pinned))
                    self.tx.grant(state.rid, now)
                    granted.append((state, skip, pinned, n_res))
                    continue
                self._admit_one(d, state, skip, pinned, now)

        admit_ready()
        if pending and not d.active and not granted:
            # liveness fallback: nothing is running (so no future poke
            # will fire) and the head still can't admit — its eviction
            # is blocked by pages pinned for *later* pending requests.
            # Drop every pin (those requests fall back to a full-blob
            # transfer); with no pins and nothing running, the head's
            # residency always fits after LRU eviction.
            for j, (state, _skip, pinned) in enumerate(pending):
                e.unpin(pinned)
                pending[j] = (state, 0, [])
            admit_ready()
        # amortized marking: entries append at the tail, marked ones
        # accumulate at the front (see the simulator twin); streamed
        # entries stay PREFILLING-with-progress until their final chunk
        for state, _skip, _pinned in reversed(pending):
            if state.status is RequestStatus.PENDING_ADMIT:
                break
            if state.status is RequestStatus.MIGRATING:
                state.to_status(RequestStatus.PENDING_ADMIT)
                if self.tracer.enabled:
                    self.tracer.phase(state.rid, "pending_admit", now,
                                      d.label)
        # absorbed prompts chunk-prefill between decode iterations
        # (prefill-priority, like a mixed engine; the chunk size bounds
        # the decode stall)
        if d.absorb.items and self._absorb_chunk:
            if self._absorb_step(d, now):
                return
        e._active = d.active
        if not d.active:
            self._check_flip(d, now)
            return
        # Under a virtual clock, streamed migrants join the batch only
        # once their first layer has landed (the simulator admits at
        # `transfer_first`); until then they hold pages but must not
        # stall batchmates. Without a charge the engine's KV is
        # physically resident the moment `_admit_one` spliced it, so
        # membership stays immediate (anything else would change batch
        # groupings and thus the token stream) and the modeled landing
        # time is charged through `pipelined_finish` below instead.
        batch = d.active
        landing: List = []
        if self.charge is not None:
            batch = [s for s in d.active if s.kv_first <= now]
            if not batch:
                self._ev.push(min(s.kv_first for s in d.active),
                              "poke_decode", d)
                return
            landing = [s for s in d.active if s.kv_first > now]
        ctx_tokens = sum(len(s.tokens) - 1 for s in batch)
        dt = e.decode_step(batch)
        if self.charge is not None:
            dt = self.charge.decode(len(batch), ctx_tokens)
        done_t = now + dt
        for seq in batch:
            if seq.kv_full > now:
                # a member's later layers are still crossing the wire:
                # layer l's attention runs only after layer l lands, so
                # the iteration drains at the pipelined finish time
                done_t = max(done_t, pipelined_finish(
                    now, dt, seq.kv_full, self.tx.n_layers))
            seq.kv_first = seq.kv_full = 0.0
        d.free_at = done_t
        if self.tracer.enabled:
            self.tracer.complete("step", "decode_step", now, done_t,
                                 d.label, batch=len(batch), compute=dt,
                                 graph=int(e.replayed))
            self._host_spans(d, now)
        still = []
        for seq in batch:
            state = self._states[seq.rid]
            self._emit_token(state, seq.tokens[-1], done_t)
            if seq.done:
                self._finish_state(state, done_t)
                e.release(seq)
            else:
                still.append(seq)
        # late joiners append at the tail, as the simulator's `arrived`
        # entries extend `running`
        d.active = still + landing
        self._ev.push(done_t, "poke_decode", d)

    # -- chunked-prefill absorption (intra-instance aggregation) ---------
    def _absorb_step(self, d: _LiveInstance, now: float) -> bool:
        """One bounded prefill chunk on a decode instance, between its
        decode iterations (prefill-priority, like a mixed engine). The
        chunk's fresh KV is written in place into the decode engine's own
        page pool — nothing ever crosses the wire; the final chunk's
        page-backed blob is spliced locally."""
        e = d.engine

        def can_take(seq):
            if e.has_partial(seq):
                return True
            return (len(d.active) + len(d.absorbing) < e.max_batch
                    and e.can_admit(seq) and e.can_start_chunked(seq))

        batch = d.absorb.form_batch(
            self.lm_tokens, max_batch=1, can_take=can_take,
            chunk_tokens=self._absorb_chunk, resumable=e.has_partial)
        if not batch:
            return False
        seq = batch[0]
        state = self._states[seq.rid]
        req = state.request
        state.to_status(RequestStatus.PREFILLING)
        state.where = ("absorb", d)
        if seq.rid not in d.absorbing:      # the first chunk
            req.prefill_start = now
        d.absorbing.add(seq.rid)
        prev = seq.prefilled
        done, first, blob, dt, _c = e.prefill_chunk(seq, self._absorb_chunk)
        if self.charge is not None:
            dt = self.charge.chunk(_c, prev)
        t_end = now + dt
        self.busy_absorb += dt
        if self.tracer.enabled:
            self.tracer.phase(seq.rid, "prefilling", now, d.label)
            self.tracer.complete("compute", "absorb_chunk", now, t_end,
                                 d.label, rid=seq.rid, tokens=_c, ctx=prev)
            self._host_spans(d, now)
        if not done:
            d.absorb.push(seq)
        else:
            d.absorbing.discard(seq.rid)
            seq.append_token(first)
            req.first_token = t_end
            self._emit_token(state, first, t_end)
            if seq.done:                    # out_len == 1 / instant stop
                release_blob(blob)
                self._finish_state(state, t_end)
            else:
                # KV is already local: splice the page-backed blob into
                # this engine's own tables (no wire, no migration states)
                wire = e.materialize_wire(blob, 0) \
                    if isinstance(blob, KVBlob) else blob
                e.insert_kv(seq, wire)
                req.decode_admit = t_end
                req.transfer_done = t_end
                state.to_status(RequestStatus.DECODING)
                if self.tracer.enabled:
                    self.tracer.phase(seq.rid, "decoding", t_end, d.label)
                d.active.append(seq)
        d.free_at = t_end
        self._ev.push(t_end, "poke_decode", d)
        return True

    # -- mixed role (colocated semantics) ---------------------------------
    def _step_engine(self, x: _LiveInstance, now: float):
        if x.role != "mixed":
            return
        if x.free_at > now:
            self._ev.push(x.free_at, "poke", x)
            return
        e = x.engine
        # prefill priority; page-aware admission via the shared core
        batch = x.waiting.form_batch(self.max_prefill_tokens,
                                     max_batch=1, can_take=e.can_admit)
        if batch:
            seq = batch[0]
            state = self._states[seq.rid]
            state.to_status(RequestStatus.PREFILLING)
            req = state.request
            req.prefill_start = now
            first, blob, dt = e.prefill_request(seq)
            if self.charge is not None:
                dt = self.charge.prefill([len(seq.tokens) - seq.prefix_hit])
            if self.tracer.enabled:
                self.tracer.phase(seq.rid, "prefilling", now, x.label)
                self.tracer.complete(
                    "compute", "prefill_batch", now, now + dt,
                    x.label, rid=seq.rid,
                    tokens=len(seq.tokens) - seq.prefix_hit,
                    hit=seq.prefix_hit)
                self._host_spans(x, now)
            seq.append_token(first)
            req.first_token = now + dt
            self._emit_token(state, first, now + dt)
            e.insert_kv(seq, blob)
            if seq.done:
                e.release(seq)
                self._finish_state(state, now + dt)
            else:
                state.to_status(RequestStatus.DECODING)
                if self.tracer.enabled:
                    self.tracer.phase(seq.rid, "decoding", now + dt,
                                      x.label)
                x.active.append(seq)
            x.free_at = now + dt
            self._ev.push(now + dt, "poke", x)
            return
        if x.active:
            batch2 = x.active
            ctx_tokens = sum(len(s.tokens) - 1 for s in batch2)
            dt = e.decode_step(batch2)
            if self.charge is not None:
                dt = self.charge.decode(len(batch2), ctx_tokens)
            done_t = now + dt
            if self.tracer.enabled:
                self.tracer.complete("step", "decode_step", now, done_t,
                                     x.label, batch=len(batch2),
                                     compute=dt, graph=int(e.replayed))
                self._host_spans(x, now)
            still = []
            for seq in batch2:
                state = self._states[seq.rid]
                self._emit_token(state, seq.tokens[-1], done_t)
                if seq.done:
                    e.release(seq)
                    self._finish_state(state, done_t)
                else:
                    still.append(seq)
            x.active = still
            x.free_at = done_t
            self._ev.push(done_t, "poke", x)
            return
        self._check_flip(x, now)

    # -- failover ---------------------------------------------------------
    def _on_fail_decode(self, idx, t: float):
        D = self._role("decode")
        # idx: role-local index from the fail_decode event, or the
        # instance record itself (tests inject failures by record)
        d = idx if isinstance(idx, _LiveInstance) else D[idx]
        lost = self.fail_decode(D.index(d))
        P = self._role("prefill")
        alive_p = [j for j, x in enumerate(P) if not x.failed]
        # failover: re-prefill lost requests (keep generated tokens)
        for rid in lost:
            state = self._states[rid]
            if state.done:
                continue
            seq = state.seq
            d.engine.release(seq)
            seq.done = False
            if not alive_p:                 # nowhere to recover to
                self._finish_state(state, t, FINISH_FAILED)
                continue
            qi = self.dispatcher.pick_prefill(
                rid, [x.queue for x in P], alive_p,
                hits=self._prefill_hits(seq.tokens), now=t)
            p = P[qi]
            p.queue.push(seq)
            state.where = ("prefill", p)
            state.to_status(RequestStatus.QUEUED)
            if self.tracer.enabled:
                self.tracer.phase(rid, "queued", t, p.label)
            self._ev.push(t, "poke_prefill", p)
        d.active = []
        # also re-route ready-but-unpulled requests (drop the dead
        # instance's prefix pin; the new target re-pins its own)
        moved = [(st, pinned) for st, _skip, pinned in d.pending]
        moved += [(st, pinned) for st, _skip, pinned, _n in d.granted]
        d.pending = []
        d.granted = []
        for state, pinned in moved:
            d.engine.unpin(pinned)
            if self.tx.has_parked(state.rid):
                parked = self.tx.parked.pop(state.rid)
                self.tx._granted.pop(state.rid, None)
                self._ev.push(t, "dispatch_decode",
                              (state, parked.blob, parked.src))
            else:
                # streamed chunked prefill mid-flight: re-route the stream
                _d, src, _skip = self._stream.pop(state.rid)
                self.tx._granted.pop(state.rid, None)
                self._ev.push(t, "predispatch_decode", (state, src))

    # -- runtime re-roling ------------------------------------------------
    def set_role(self, g: int, role: str, now: Optional[float] = None):
        """Flip instance ``g`` to ``role`` ("prefill"/"decode"/"mixed").

        The instance leaves the routing views immediately. Queued-but-
        unstarted work is re-routed through the shared dispatcher;
        resident work — running decodes, granted/streaming KV, partial
        chunks — drains in place, and the flip completes when the
        instance is idle. The engine (and its page pool) survives the
        flip; a decode→prefill flip completes only once no sequence
        tables or reservations remain, so it never strands or leaks KV."""
        assert role in ("prefill", "decode", "mixed"), role
        now = self._ev.now if now is None else now
        inst = self.inst[g]
        if inst.role == role:
            inst.target = None          # flip-back cancels a pending drain
            inst.draining = False
            return
        if inst.target == role:
            return
        # validate the fleet *after* every pending drain completes:
        # somebody must accept arrivals, and prefill output needs a
        # decode target (draining instances count as their target role)
        after = [x.target or x.role for x in self.inst if x is not inst] \
            + [role]
        if not any(r2 in ("prefill", "mixed")
                   or (r2 == "decode" and self._absorb_chunk)
                   for r2 in after):
            raise ValueError("re-roling would leave no instance able to "
                             "accept arrivals")
        if "prefill" in after and "decode" not in after:
            raise ValueError("re-roling would leave prefill instances "
                             "with no decode target")
        inst.draining = True
        inst.target = role
        if self.tracer.enabled:
            self.tracer.event("role_drain", now, lane=inst.label, role=role)
        self._reroute_unstarted(inst, now)
        self._check_flip(inst, now)

    def apply_roles(self, roles: Seq[str], now: Optional[float] = None):
        """Reconcile the fleet's per-instance roles with a plan vector
        (`FleetRouter.elastic_callback` / placement `mode_search`).
        Decode-creating flips run first so a later prefill-creating flip
        never transits through a prefill-without-decode-target fleet."""
        order = {"decode": 0, "mixed": 1, "prefill": 2}
        for g in sorted(range(min(len(roles), len(self.inst))),
                        key=lambda g: order.get(roles[g], 3)):
            self.set_role(g, roles[g], now=now)

    def pressure(self) -> Dict[str, float]:
        """Load signals for role controllers and routers: prefill queue
        depth and decode KV-page occupancy (the memory-bound overload
        signal queue depth misses). Same keys as the simulator twin."""
        P = [x for x in self._role("prefill")
             if not x.draining and not x.failed]
        D = [x for x in self._role("decode")
             if not x.draining and not x.failed]
        E = [x for x in self._role("mixed") if not x.draining]
        now = self._ev.now
        util = 0.0
        for d in D:
            s = d.engine.stats()
            if s.get("kv.num_pages"):
                util = max(util, s["kv.used_pages"] / s["kv.num_pages"])
        return {
            "prefill_queued_tokens": float(sum(x.queue.queued_tokens
                                               for x in P)),
            "prefill_inflight": float(sum(1 for x in P
                                          if x.free_at > now)),
            "decode_kv_util": float(util),
            "decode_load": float(sum(x.load for x in D)),
            "mixed_load": float(sum(x.load for x in E)),
            "n_prefill": float(len(P)), "n_decode": float(len(D)),
            "n_mixed": float(len(E)),
        }

    def kv_utilization(self) -> float:
        """Decode page-pool occupancy in [0, 1] (router-side KV-pressure
        overload signal)."""
        return self.pressure()["decode_kv_util"]

    def _reroute_unstarted(self, x: _LiveInstance, now: float):
        if x.role == "prefill":
            for seq in list(x.queue.items):
                if x.engine.has_partial(seq) or seq.rid in self._stream:
                    continue        # mid-chunk: finish here
                x.queue.remove(seq)
                st = self._states[seq.rid]
                st.where = None
                self._ev.push(now, "arrive", st)
            self._ev.push(now, "poke_prefill", x)
        elif x.role == "decode":
            others = [d for d in self._role("decode")
                      if d is not x and not d.draining and not d.failed]
            if others:
                for entry in list(x.pending):
                    state, _skip, pinned = entry
                    x.pending.remove(entry)
                    x.engine.unpin(pinned)
                    # the parked wire bytes were fixed at park time, so
                    # the re-pick skips prefix hits and pins (full blob)
                    di = self.dispatcher.pick_decode(
                        state.rid, [d.load for d in others], now=now)
                    nd = others[di]
                    if state.rid in self._stream:
                        _d, src, _s = self._stream[state.rid]
                        self._stream[state.rid] = (nd, src, 0)
                    nd.pending.append((state, 0, []))
                    state.where = ("decode", nd)
                    self._ev.push(now, "poke_decode", nd)
            for seq in list(x.absorb.items):
                if seq.rid in x.absorbing:
                    continue        # partial chunks: finish here
                x.absorb.remove(seq)
                st = self._states[seq.rid]
                st.where = None
                self._ev.push(now, "arrive", st)
            self._ev.push(now, "poke_decode", x)
        else:
            for seq in list(x.waiting.items):
                x.waiting.remove(seq)
                st = self._states[seq.rid]
                st.where = None
                self._ev.push(now, "arrive", st)
            self._ev.push(now, "poke", x)

    def _check_flip(self, x: _LiveInstance, now: float):
        if x.target is None:
            return
        if x.role == "prefill":
            if x.queue.items or x.engine._partial:
                return
        elif x.role == "decode":
            if (x.active or x.pending or x.granted or x.absorb.items
                    or x.absorbing):
                return
            s = x.engine.stats()
            assert not s.get("kv.tables", 0) \
                and not s.get("kv.reserved_pages", 0), \
                "role flip with resident sequences or reservations"
        else:
            if x.waiting.items or x.active:
                return
        if x.free_at > now:
            kind = {"prefill": "poke_prefill", "decode": "poke_decode",
                    "mixed": "poke"}[x.role]
            self._ev.push(x.free_at, kind, x)
            return
        self._complete_flip(x, now)

    def _complete_flip(self, x: _LiveInstance, now: float):
        role = x.target
        x.target = None
        x.draining = False
        x.role = role
        x.iid = self._iid_next[role]
        self._iid_next[role] += 1
        self._role_events.append((now, x.label, role))
        if self.tracer.enabled:
            self.tracer.event("role_change", now, lane=x.label, role=role)
        # fresh capacity: poke so blocked global work can move
        kind = {"prefill": "poke_prefill", "decode": "poke_decode",
                "mixed": "poke"}[role]
        self._ev.push(now, kind, x)
        if self._backlog:
            held, self._backlog = self._backlog, []
            for st in held:
                st.where = None
                self._ev.push(now, "arrive", st)

    # -- cancellation ----------------------------------------------------
    def _do_cancel(self, state: RequestState, t: float):
        """Release whatever this request holds at its current stage:
        QUEUED -> leave the FCFS/absorb/waiting queue; PREFILLING -> the
        in-flight dispatch event drops the blob (chunked: abort the
        partial + reclaim the stream); MIGRATING / PENDING_ADMIT ->
        unpark the transfer + drop the decode-side prefix pins;
        DECODING -> free the batch slot and every KV page."""
        seq = state.seq
        if state.where is None:
            return
        stage, loc = state.where
        if stage == "backlog":              # held during a re-role drain
            self._backlog = [st for st in self._backlog
                             if st.rid != state.rid]
            return
        if state.status is RequestStatus.QUEUED:
            if stage == "prefill":
                loc.queue.remove(seq)
            elif stage == "engine":
                loc.waiting.remove(seq)
            elif stage == "absorb":
                loc.absorb.remove(seq)
        elif state.status is RequestStatus.PREFILLING:
            if stage == "prefill":
                # chunked prefill: the request may sit re-queued between
                # chunks with a reserved residency and a predispatched
                # stream
                loc.queue.remove(seq)
                loc.engine.abort_partial(seq)
                self._drop_stream(state, t)
                self._ev.push(t, "poke_prefill", loc)
            elif stage == "absorb":
                loc.absorb.remove(seq)
                if seq.rid in loc.absorbing:
                    loc.absorbing.discard(seq.rid)
                    loc.engine.abort_partial(seq)
                self._ev.push(t, "poke_decode", loc)
        elif state.status in (RequestStatus.MIGRATING,
                              RequestStatus.PENDING_ADMIT):
            d = loc
            for j, (st, _skip, pinned) in enumerate(d.pending):
                if st is state:
                    del d.pending[j]
                    d.engine.cancel(seq, pinned)
                    break
            for j, (st, _skip, pinned, n_res) in enumerate(d.granted):
                if st is state:
                    del d.granted[j]
                    d.engine.unreserve(n_res)
                    d.engine.cancel(seq, pinned)
                    break
            self._stream.pop(state.rid, None)
            p = self.tx.cancel(state.rid)   # drops chunk segments too
            if p is not None:
                release_blob(p.blob)        # drop prefill-side prefix pins
                self._poke_src(p.src, t)
            self._ev.push(t, "poke_decode", d)  # head may admit now
        elif state.status is RequestStatus.DECODING:
            x = loc
            for j, s in enumerate(x.active):
                if s is seq:
                    del x.active[j]
                    break
            x.engine.cancel(seq)
            kind = "poke" if stage == "engine" else "poke_decode"
            self._ev.push(t, kind, x)       # freed pages may admit

    # -- legacy closed-world shim ----------------------------------------
    def run(self, requests: List[Request],
            fail_decode_at: Optional[Tuple[float, int]] = None
            ) -> Dict[int, ServedResult]:
        """Submit-all-then-drain compatibility shim: drive a whole trace
        to completion on the virtual clock (pre-lifecycle behavior,
        byte-identical results on no-cancel traces)."""
        self._reset_loop()
        for r in requests:
            self.submit(r)
        if fail_decode_at is not None:
            self._ev.push(fail_decode_at[0], "fail_decode",
                          fail_decode_at[1])
        return self.drain()

    # -- prefix-cache stats ----------------------------------------------
    def prefix_stats(self) -> Dict[str, Any]:
        """Aggregate radix-tree stats across the fleet (per-side)."""
        def agg(engines):
            out: Dict[str, float] = {}
            for e in engines:
                if not e.prefix_caching:
                    continue
                for k, v in e.prefix_cache.stats.as_dict().items():
                    out[k] = out.get(k, 0) + v
            return out
        out = {"prefill": agg(self.prefill), "decode": agg(self.decode)}
        if self.engines:
            out["mixed"] = agg(self.engines)
        return out

    def extras(self) -> Dict[str, Any]:
        """Dynamic-deployment counters (role flips, absorption)."""
        out: Dict[str, Any] = {"decisions": self.dispatcher.decisions,
                               "states": dict(self._states)}
        if self.busy_absorb or self.absorbed:
            out["absorb_busy_s"] = self.busy_absorb
            out["absorbed"] = self.absorbed
        if self._role_events:
            out["role_events"] = list(self._role_events)
        return out


class DisaggCluster(ServingCluster):
    """Legacy disaggregated entrypoint: ``n_prefill + n_decode`` live
    engines, translated to a prefill+decode role vector over the
    role-unified `ServingCluster`. Schedules, token streams, dispatch
    decisions and metric keys are byte-identical to the pre-unification
    class."""

    def __init__(self, cfg, params, *, n_prefill: int = 1, n_decode: int = 1,
                 max_batch: int = 8, max_len: int = 256,
                 transfer_bandwidth: float = 50e9, lm_tokens: int = 256,
                 attn_blocks=(64, 64), page_size: int = 16,
                 decode_num_pages: Optional[int] = None,
                 paged: Optional[bool] = None,
                 prefix_cache: bool = False,
                 prefill_num_pages: Optional[int] = None,
                 fused_prefix: Optional[bool] = None,
                 chunk_tokens: Optional[int] = None,
                 seed: int = 0, tracker=None, tracer=None,
                 charge=None, metrics=None, device=None, dtype=None):
        super().__init__(
            cfg, params,
            ["prefill"] * n_prefill + ["decode"] * n_decode,
            max_batch=max_batch, max_len=max_len,
            transfer_bandwidth=transfer_bandwidth, lm_tokens=lm_tokens,
            attn_blocks=attn_blocks, page_size=page_size,
            decode_num_pages=decode_num_pages, paged=paged,
            prefix_cache=prefix_cache,
            prefill_num_pages=prefill_num_pages,
            fused_prefix=fused_prefix, chunk_tokens=chunk_tokens,
            seed=seed, tracker=tracker, tracer=tracer,
            charge=charge, metrics=metrics, device=device, dtype=dtype)


class ColocatedCluster(ServingCluster):
    """vLLM-like baseline: each engine runs prefill + decode interleaved
    with prefill priority (iteration-level batching) — the degenerate
    "all instances mixed" case of the role-unified `ServingCluster`.
    Statuses skip MIGRATING / PENDING_ADMIT (nothing migrates)."""

    def __init__(self, cfg, params, *, n_engines: int = 1, max_batch: int = 8,
                 max_len: int = 256, max_prefill_tokens: int = 512,
                 attn_blocks=(64, 64), page_size: int = 16,
                 num_pages: Optional[int] = None,
                 paged: Optional[bool] = None,
                 seed: int = 0, tracker=None, tracer=None,
                 charge=None, metrics=None, device=None):
        super().__init__(
            cfg, params, ["mixed"] * n_engines,
            max_batch=max_batch, max_len=max_len,
            max_prefill_tokens=max_prefill_tokens,
            attn_blocks=attn_blocks, page_size=page_size,
            num_pages=num_pages, paged=paged,
            seed=seed, tracker=tracker, tracer=tracer,
            charge=charge, metrics=metrics, device=device)

    def run(self, requests: List[Request]) -> Dict[int, ServedResult]:
        return super().run(requests)
