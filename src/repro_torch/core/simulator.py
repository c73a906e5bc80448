# Copied unchanged from src/repro/core/simulator.py.
"""Discrete-event simulator for disaggregated and colocated LLM serving.

Iteration-level fidelity, mirroring the runtime in repro/serving — batch
formation, dispatch, and pull-based admission all come from the shared
scheduler core in `core.scheduler` (the live cluster runs the same code),
and both simulators implement the same `serving.api.ServingBackend`
protocol as the live clusters (`SimDisaggBackend` / `SimColocatedBackend`:
`submit` / `step` / `run_until` / `drain` / `cancel`), so one driver can
swap live engines for the analytical latency model without changing the
serving code around it.  The classic `simulate_disaggregated` /
`simulate_colocated` functions remain as submit-all-then-drain shims.

  * prefill instances: FCFS queues (`FCFSQueue.form_batch` up to the L_m
    token budget, paper §4.3), PP admission every T/pp with full-T latency
    (M/D/1-consistent), shortest-queue dispatch at arrival.
  * decode instances: continuous batching; per-iteration time from the
    analytical latency model; *page-granular* KV admission via `PagePool` —
    finished prefills stay parked on the prefill side (`TransferManager`)
    until the decode instance has free pages, then transfer over the
    per-link wire (paper §4.3 "combat burstiness").
  * colocated engine (vLLM-like baseline): prefill-priority iteration-level
    scheduling, decode stalls during prefill iterations (the interference
    the paper measures in Fig. 1/2).

Token ids are not modeled (the latency model has no logits), so simulated
`TokenEvent`s carry token id -1 and `SamplingParams.stop` cannot trigger;
`max_tokens` and cancellation are honored exactly as in the live runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .kv_transfer import TransferManager, kv_bytes, pipelined_finish
from .latency_model import LatencyModel, Parallelism
from .scheduler import (DisaggDispatcher, FCFSQueue, PagePool,
                        least_loaded)
from .workload import Request, WorkloadSpec
from ..serving.api import (FINISH_CANCELLED, BackendBase, RequestState,
                           RequestStatus, percentile)
from ..serving.prefix_cache import RadixPrefixCache


@dataclasses.dataclass
class InstanceConfig:
    par: Parallelism
    count: int = 1


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    ttft_attain: float
    tpot_attain: float
    attain: float
    p50_ttft: float
    p90_ttft: float
    p50_tpot: float
    p90_tpot: float
    kv_transfer_total_s: float = 0.0
    kv_transfer_p95_s: float = 0.0
    breakdown: Optional[Dict[str, float]] = None
    # real inter-token-latency distribution (pooled over finished
    # requests' per-token timestamps), available when the backend kept
    # lifecycle states; 0.0 otherwise
    p99_itl: float = 0.0
    max_itl: float = 0.0
    n_cancelled: int = 0
    slo: Optional[Any] = None   # goodput.SLOReport — the unified metrics
                                # object live benchmarks also produce


# the repo-wide linear-interpolated percentile (kept under the historic
# name; tests pin its behavior through this import path)
_percentile = percentile


def summarize(reqs: List[Request], spec: WorkloadSpec,
              slo_scale: float = 1.0,
              extra: Optional[Dict] = None,
              warmup_frac: float = 0.25) -> SimResult:
    """Attainment over the steady-state window (arrivals after warmup).

    SLO scoring goes through `goodput.SLOTracker` — the same object the
    live backends feed online — so placement search and live benchmarks
    consume one metrics type.  Cancelled requests are excluded from the
    latency distributions and the attainment denominator.
    """
    from .goodput import SLOTracker      # deferred: goodput imports us
    if reqs:
        t_end = max(r.arrive for r in reqs)
        t_warm = t_end * warmup_frac
        reqs = [r for r in reqs if r.arrive >= t_warm] or reqs
    n_cancelled = sum(r.finish_reason == FINISH_CANCELLED for r in reqs)
    live = [r for r in reqs if r.finish_reason != FINISH_CANCELLED]
    done = [r for r in live if r.finish >= 0]
    tracker = SLOTracker(spec, slo_scale=slo_scale)
    for r in done:
        tracker.observe_result(r.ttft, r.tpot)
    n = max(len(live), 1)
    slo = tracker.report(total=n)
    ttfts = [r.ttft for r in done]
    tpots = [r.tpot for r in done]
    res = SimResult(
        requests=reqs,
        ttft_attain=slo.ttft_attain,
        tpot_attain=slo.tpot_attain,
        attain=slo.attain,
        p50_ttft=_percentile(ttfts, 0.5), p90_ttft=_percentile(ttfts, 0.9),
        p50_tpot=_percentile(tpots, 0.5), p90_tpot=_percentile(tpots, 0.9),
        n_cancelled=n_cancelled,
        slo=slo,
    )
    if extra:
        res.kv_transfer_total_s = extra.get("kv_total", 0.0)
        res.kv_transfer_p95_s = extra.get("kv_p95", 0.0)
        res.breakdown = extra.get("breakdown")
        states = extra.get("states")
        if states:
            keep = {r.rid for r in done}
            itl = [d for rid, st in states.items() if rid in keep
                   for d in st.itl()]
            res.p99_itl = _percentile(itl, 0.99)
            res.max_itl = max(itl) if itl else 0.0
    return res


# ---------------------------------------------------------------------------
# Disaggregated simulation
# ---------------------------------------------------------------------------

class _PrefillInstance:
    def __init__(self, iid, lm: LatencyModel, par: Parallelism, lm_tokens: int,
                 tree: Optional[RadixPrefixCache] = None):
        self.iid = iid
        self.lm = lm
        self.par = par
        self.budget = lm_tokens
        self.queue: FCFSQueue = FCFSQueue(token_of=lambda r: r.in_len)
        self.inflight = 0            # batches in the pipeline
        self.next_admit = 0.0
        self.tree = tree             # prefix cache model (matches the live
                                     # engine's radix tree decisions)

    @property
    def queued_tokens(self) -> int:
        return self.queue.queued_tokens

    def can_admit(self) -> bool:
        return bool(self.queue.items) and self.inflight < self.par.pp

    def form_batch(self) -> List[Request]:
        return self.queue.form_batch(self.budget)


def _req_kv_bytes(lm: LatencyModel, r: Request) -> float:
    c = lm.cfg
    if c.family == "ssm":
        return lm.kv_read_bytes(0)
    n = r.in_len + r.out_len
    if c.sliding_window:
        n = min(n, c.sliding_window)
    return c.kv_bytes_per_token(lm.dtype_bytes) * n


class _DecodeInstance:
    def __init__(self, iid, lm: LatencyModel, par: Parallelism,
                 pool: PagePool, max_batch: int,
                 tree: Optional[RadixPrefixCache] = None):
        self.iid = iid
        self.lm = lm
        self.par = par
        self.pool = pool                 # page-granular KV admission
        self.max_batch = max_batch
        self.running: List[Request] = []
        self.pending: List[Request] = []  # parked on prefill side, assigned
        self.arrived: List[Request] = []  # transferred, joins at iter start
        # rid -> request: chunked-prefill streams whose residency (pages)
        # is already allocated, waiting for the final chunk to land
        self.granted: Dict[int, Request] = {}
        self.in_transfer = 0
        # rid -> last-layer-landed time for requests admitted while their
        # KV is still streaming layer-by-layer (consumed by the first
        # iteration they join; see `pipelined_finish`)
        self.kv_full: Dict[int, float] = {}
        self.busy = False
        self.tree = tree                 # decode-side shared-prefix model
        # chunked-prefill absorption (role-unified backend): whole prompts
        # spilled here when the prefill tier saturates. None on legacy
        # static-disagg instances — absorb paths never run there.
        self.absorb: Optional[FCFSQueue] = None
        self.absorbing: set = set()      # rids mid-absorption (resident)

    @property
    def load(self) -> int:
        n = (len(self.running) + len(self.pending) + len(self.arrived)
             + len(self.granted) + self.in_transfer)
        if self.absorb is not None and (self.absorb.items or self.absorbing):
            n += len(self.absorbing | {r.rid for r in self.absorb.items})
        return n

    def charge_pages(self, r: Request) -> int:
        """Fresh pages a request needs: full residency minus the pages its
        decode-side shared prefix already holds.

        Approximation: tree-*retained* pages (prefixes kept after their
        sequences finish) are not charged to the pool. The live engine
        does keep them resident, but reclaims them LRU on admission
        pressure (`Engine.can_admit`), so for admission purposes they
        behave as free; the residual error is the floor of pages actively
        shared by concurrent sequences (counted once live, zero here)."""
        full = self.pool.pages_for(_req_kv_bytes(self.lm, r))
        if self.tree is None or not r.decode_hit:
            return full
        page_tokens = self.tree.page_size
        return max(full - r.decode_hit // page_tokens, 0)

    def can_admit(self, r: Request) -> bool:
        resident = (len(self.running) + len(self.arrived) + self.in_transfer
                    + len(self.absorbing))
        return (resident < self.max_batch
                and self.pool.can_alloc(self.charge_pages(r)))

    def ctx_tokens(self) -> float:
        return float(sum(r.in_len + r.tokens_done for r in self.running))


class _SimBackend(BackendBase):
    """Plumbing shared by both simulator backends: horizon-guarded
    stepping, `SamplingParams.max_tokens` caps, and per-request cleanup
    (token ids are not modeled, so stop tokens cannot trigger here)."""

    def _init_sim(self, horizon: float, record_events: bool, tracker,
                  tracer=None, metrics=None):
        self._init_backend(tracker=tracker, tracer=tracer, metrics=metrics)
        # bulk goodput sweeps simulate millions of tokens: the closed-world
        # shims disable per-token TokenEvent recording (a tracker or
        # on_token callback re-enables it per consumer)
        self._record_tokens = record_events
        self.horizon = horizon
        self._out_cap: Dict[int, int] = {}      # rid -> max_tokens cap

    def step(self) -> bool:
        nxt = self._ev.peek_time()
        if nxt is None or nxt > self.horizon:
            return False
        return super().step()

    def next_time(self):
        nxt = self._ev.peek_time()
        return None if nxt is None or nxt > self.horizon else nxt

    def _forget(self, rid: int):
        super()._forget(rid)
        self._out_cap.pop(rid, None)

    def _cap_out(self, state: RequestState):
        if state.sampling.max_tokens is not None:
            self._out_cap[state.rid] = \
                state.sampling.out_len(state.request.out_len)


class SimServingBackend(_SimBackend):
    """Role-unified discrete-event serving simulator (the twin of
    `serving.cluster.ServingCluster`).

    Every instance carries a *role* — ``"prefill"``, ``"decode"`` or
    ``"mixed"`` — instead of the role being baked into the class. A
    disaggregated deployment is a prefill+decode role vector; a colocated
    (vLLM-like) deployment is the degenerate "all instances mixed" case.
    `SimDisaggBackend` / `SimColocatedBackend` remain as thin shims that
    translate their legacy constructor signatures into role vectors and
    produce byte-identical schedules.

    On top of the static roles:

    * `set_role(g, role)` flips an instance at runtime. The instance
      leaves the routing views immediately; queued-but-unstarted work is
      re-routed through the shared dispatcher; resident work (running
      decodes, granted/streaming KV, partial chunks) drains in place, and
      the flip completes when the instance is idle — so a decode→prefill
      flip never strands or leaks KV pages (`PagePool.used == 0` is
      asserted at completion). A prefill→decode flip drains in one batch
      time; there is no KV to move.
    * chunked-prefill *absorption*: when every routable prefill queue is
      deeper than ``absorb_tokens``, new prompts spill to a decode/mixed
      instance which prefills them locally in bounded chunks
      (`prefill_chunk_time` per chunk, serialized with its decode
      iterations) — intra-instance aggregation under prefill bursts.

    phase="prefill": requests finish at first token (simu_prefill, Alg. 1);
    phase="decode": prefill is instantaneous (simu_decode, Alg. 1).

    prefix_cache: model per-instance radix-tree prefix caches — matched
    prefixes skip prefill compute (suffix-only prefill time) and
    prefill->decode transfer ships only the suffix the decode instance is
    missing. Default (None) auto-enables when submitted requests carry
    token ids (see `workload.sample_multi_turn`) and the model has
    per-token KV. The trees and routing policy are the exact classes the
    live cluster runs, so both report the same prefix-hit routing
    decisions on one trace.
    """

    def __init__(self, lm: LatencyModel,
                 instances: Sequence[Tuple[str, Parallelism]], *,
                 transfer_bw: float = 50e9,
                 lm_tokens: Optional[int] = None,
                 max_decode_batch: Optional[int] = None,
                 kv_reserve: float = 0.1,
                 page_tokens: int = 16,
                 num_decode_pages: Optional[int] = None,
                 dispatcher: Optional[DisaggDispatcher] = None,
                 phase: str = "both",
                 prefix_cache: Optional[bool] = None,
                 chunk_tokens=None,
                 max_prefill_tokens: int = 2048,
                 max_mixed_batch: Optional[int] = None,
                 absorb_tokens: Optional[int] = None,
                 horizon: float = 1e9,
                 tracker=None,
                 record_events: bool = True,
                 tracer=None, metrics=None):
        self._init_sim(horizon, record_events, tracker, tracer=tracer,
                       metrics=metrics)
        self.lm = lm
        self.phase = phase
        self.transfer_bw = transfer_bw
        self.page_tokens = page_tokens
        self.max_prefill_tokens = max_prefill_tokens
        roles = [r for r, _ in instances]
        self._pars = [par for _, par in instances]
        ref_par = next((par for r, par in instances if r == "prefill"),
                       self._pars[0] if self._pars else Parallelism())
        lm_tok = lm_tokens or lm.saturation_tokens(ref_par)
        self._lm_tok = lm_tok
        self._kv_reserve = kv_reserve
        max_b = max_decode_batch or 4096
        self._max_b = max_b
        self._max_mb = max_mixed_batch or 4096
        # page-granular capacity: one page = page_tokens worth of KV bytes
        # (SSM archs: one page per constant-size state)
        per_tok = lm.cfg.kv_bytes_per_token(lm.dtype_bytes)
        page_bytes = per_tok * page_tokens if per_tok else lm.kv_read_bytes(0)
        page_bytes = max(page_bytes, 1.0)
        self._page_bytes = page_bytes
        self._num_decode_pages = num_decode_pages
        self._per_tok = per_tok
        has_pd = any(r in ("prefill", "decode") for r in roles)
        self._auto_prefix = prefix_cache is None and has_pd
        self.prefix_on = bool(prefix_cache) and per_tok > 0
        # birth-order construction; role-local iids give the legacy
        # labels/metric keys ("prefill0", "decode1", "engine0", ...)
        self.inst: List[Any] = []
        self._iid_next = {"prefill": 0, "decode": 0, "mixed": 0}
        for role, par in instances:
            self.inst.append(self._make_instance(role, par))
        if self.prefix_on:
            self._grow_trees()
        self.disp = dispatcher or DisaggDispatcher()
        self.tx = TransferManager(transfer_bw, page_bytes=int(page_bytes),
                                  n_layers=lm.cfg.num_layers)
        # chunked prefill mirror: same chunk-splitting policy and charge
        # structure as the live cluster (per-chunk `prefill_chunk_time`,
        # per-chunk `park_partial`, streamed admission). Needs per-token
        # KV (SSM state is constant-size; nothing to chunk-ship).
        # chunk_tokens="auto" sizes the chunk from the latency model: the
        # smallest page-multiple whose chunking overhead stays under the
        # model's budget fraction (the knob remains as an override).
        if chunk_tokens == "auto":
            chunk_tokens = lm.auto_chunk_tokens(ref_par,
                                                page_tokens=page_tokens)
        self.chunk_tokens = (chunk_tokens if chunk_tokens and per_tok > 0
                             and phase != "decode" else None)
        self._chunk_ctx: Dict[int, int] = {}    # rid -> tokens prefilled
        self._sim_stream: Dict[int, Any] = {}   # rid -> decode instance
        if self.chunk_tokens:
            for p in self.inst:
                if isinstance(p, _PrefillInstance):
                    # queue load = tokens still to prefill (matches the
                    # live re-queue-with-remaining-suffix accounting)
                    p.queue.token_of = self._remaining_tokens
        # absorption: spill whole prompts to decode/mixed instances when
        # every routable prefill queue is deeper than absorb_tokens
        self.absorb_tokens = absorb_tokens
        self._absorb_chunk = self.chunk_tokens
        if absorb_tokens is not None and not self._absorb_chunk \
                and per_tok > 0 and phase != "decode":
            self._absorb_chunk = lm.auto_chunk_tokens(
                ref_par, page_tokens=page_tokens)
        self.busy_prefill = 0.0
        self.busy_decode = 0.0
        self.busy_absorb = 0.0
        self.absorbed = 0
        self._role_events: List[Tuple[float, str, str]] = []
        self._twins: Dict[Tuple[int, str], Any] = {}
        self._backlog: List[RequestState] = []  # arrivals held mid-re-role
        d0 = next((x for x in self.inst
                   if isinstance(x, _DecodeInstance)), None)
        self._breakdown = {"lm_tokens": lm_tok, "max_decode_batch": max_b,
                           "decode_pages": d0.pool.num_pages if d0 else 0}
        if self.tracer.enabled:
            self.tx.tracer = self.tracer
            self.disp.tracer = self.tracer
        if metrics is not None:
            metrics.register(self._collect_metrics)

    # -- instance construction / role views ------------------------------
    def _remaining_tokens(self, r: Request) -> int:
        return max(r.in_len - self._chunk_ctx.get(r.rid, 0), 0)

    def _decode_cap(self, par: Parallelism) -> float:
        lm = self.lm
        cap = (lm.chip.hbm_bytes * par.num_chips * (1 - self._kv_reserve)
               - lm.param_bytes())
        return max(cap, lm.chip.hbm_bytes * 0.05 * par.num_chips)

    def _make_instance(self, role: str, par: Parallelism,
                       label: Optional[str] = None):
        iid = self._iid_next[role]
        self._iid_next[role] += 1
        if role == "prefill":
            x = _PrefillInstance(iid, self.lm, par, self._lm_tok)
            x.label = label or f"prefill{iid}"
            if getattr(self, "chunk_tokens", None):
                x.queue.token_of = self._remaining_tokens
        elif role == "decode":
            cap = self._decode_cap(par)
            n_pages = self._num_decode_pages \
                if self._num_decode_pages is not None \
                else max(int(cap // self._page_bytes), 1)
            x = _DecodeInstance(iid, self.lm, par,
                                PagePool(n_pages, self._page_bytes),
                                self._max_b)
            x.label = label or f"decode{iid}"
            x.absorb = FCFSQueue(token_of=self._remaining_tokens)
            x.absorbing = set()
        elif role == "mixed":
            x = _ColoEngine(iid, self._max_mb, self._decode_cap(par), par)
            x.label = label or f"engine{iid}"
        else:
            raise ValueError(f"unknown role {role!r}")
        x.par = par
        x.draining = False
        x.target = None
        if self.prefix_on and not isinstance(x, _ColoEngine):
            x.tree = RadixPrefixCache(self.page_tokens)
        return x

    @staticmethod
    def _role_of(inst) -> str:
        if isinstance(inst, _PrefillInstance):
            return "prefill"
        if isinstance(inst, _DecodeInstance):
            return "decode"
        return "mixed"

    @property
    def P(self) -> List["_PrefillInstance"]:
        return [x for x in self.inst if isinstance(x, _PrefillInstance)]

    @property
    def D(self) -> List["_DecodeInstance"]:
        return [x for x in self.inst if isinstance(x, _DecodeInstance)]

    @property
    def engines(self) -> List["_ColoEngine"]:
        return [x for x in self.inst if isinstance(x, _ColoEngine)]

    @property
    def roles(self) -> List[str]:
        return [self._role_of(x) for x in self.inst]

    def _p_route(self) -> List["_PrefillInstance"]:
        return [x for x in self.P if not x.draining]

    def _d_route(self) -> List["_DecodeInstance"]:
        return [x for x in self.D if not x.draining]

    def _e_route(self) -> List["_ColoEngine"]:
        return [x for x in self.engines if not x.draining]

    def _collect_metrics(self) -> Dict[str, float]:
        """Pull-collector for a `MetricsRegistry` (the simulator twin of
        `ServingCluster._collect_metrics`). Key names stay byte-identical
        to the legacy per-class collectors for static role vectors."""
        out: Dict[str, float] = {}
        P, D, E = self.P, self.D, self.engines
        if P or D:
            out["busy_prefill_s"] = self.busy_prefill
            out["busy_decode_s"] = self.busy_decode
        for p in P:
            out[f"queue{p.iid}.depth"] = len(p.queue)
            out[f"queue{p.iid}.tokens"] = p.queued_tokens
            out[f"prefill{p.iid}.inflight"] = p.inflight
        for d in D:
            pre = d.label
            out[f"{pre}.kv.num_pages"] = d.pool.num_pages
            out[f"{pre}.kv.used_pages"] = d.pool.used
            out[f"{pre}.kv.free_pages"] = d.pool.free_pages
            out[f"{pre}.kv.peak_used_pages"] = d.pool.peak_used
            out[f"{pre}.running"] = len(d.running)
            out[f"{pre}.pending"] = len(d.pending)
            out[f"{pre}.arrived"] = len(d.arrived)
            out[f"{pre}.granted"] = len(d.granted)
            out[f"{pre}.in_transfer"] = d.in_transfer
        for e in E:
            out[f"{e.label}.queue.depth"] = float(len(e.waiting))
            out[f"{e.label}.running"] = float(len(e.running))
            out[f"{e.label}.kv_used_bytes"] = float(e.kv_used)
        if P or D:
            for k, v in self.tx.stats().items():
                out[f"tx.{k}"] = v
        if self.prefix_on:
            for inst in (*P, *D):
                if inst.tree is None:
                    continue
                side = "prefill" if isinstance(inst, _PrefillInstance) \
                    else "decode"
                for k, v in inst.tree.metrics().items():
                    out[f"{side}{inst.iid}.prefix.{k}"] = v
        if self._role_events:        # dynamic fleets: expose role ids
            ids = {"prefill": 0.0, "decode": 1.0, "mixed": 2.0}
            for x in self.inst:
                out[f"{x.label}.role_id"] = ids[self._role_of(x)]
                out[f"{x.label}.draining"] = float(x.draining)
            out["role_changes"] = float(len(self._role_events))
            out["absorbed"] = float(self.absorbed)
        return out

    def _grow_trees(self):
        for inst in (*self.P, *self.D):
            if inst.tree is None:
                inst.tree = RadixPrefixCache(self.page_tokens)

    # -- ServingBackend hooks -------------------------------------------
    def _do_submit(self, state: RequestState, t: float):
        r = state.request
        self._cap_out(state)
        if (self._auto_prefix and not self.prefix_on
                and r.tokens is not None and self._per_tok > 0):
            self.prefix_on = True
            self._grow_trees()
        self._ev.push(t, "arrive", state)

    def _handle(self, t: float, kind: str, payload: Any):
        if kind == "arrive":
            self._on_arrive(payload, t)
        elif kind == "prefill_poke":
            self._try_start_prefill(payload, t)
        elif kind == "prefill_done":
            self._on_prefill_done(payload, t)
        elif kind == "chunk_done":
            self._on_chunk_done(payload, t)
        elif kind == "decode_poke":
            self._try_start_decode(payload, t)
        elif kind == "transfer_first":
            self._on_transfer_first(payload, t)
        elif kind == "decode_iter":
            self._on_decode_iter(payload, t)
        elif kind == "absorb_done":
            self._on_absorb_done(payload, t)
        elif kind == "poke":
            self._step_engine(payload, t)
        elif kind == "m_prefill_done":
            self._on_mixed_prefill_done(payload, t)
        elif kind == "m_decode_iter":
            self._on_mixed_decode_iter(payload, t)

    # -- event handlers --------------------------------------------------
    def _on_arrive(self, state: RequestState, t: float):
        if state.done:
            return
        r = state.request
        if self.phase == "decode":
            r.prefill_start = t
            r.first_token = t
            self._emit_token(state, -1, t)
            self._assign_decode(state, t, src=0)
            return
        P = self._p_route()
        if not P:
            # no routable prefill tier: colocated (all-mixed) deployment,
            # or a transient all-decode fleet -> absorb everywhere
            if self._e_route() and not (self.absorb_tokens is not None
                                        and self._d_route()):
                self._mixed_arrive(state, t)
            elif not self._route_absorb(state, t):
                if any(x.target is not None for x in self.inst):
                    # mid-re-role transient: every sink is draining. Hold
                    # the arrival; `_complete_flip` re-dispatches it.
                    self._backlog.append(state)
                    state.where = ("backlog", None)
                    if self.tracer.enabled:
                        self.tracer.phase(r.rid, "queued", t, "backlog")
                    return
                raise RuntimeError(
                    "no routable prefill/mixed instance and absorption "
                    "is unavailable")
            return
        if (self.absorb_tokens is not None
                and min(p.queued_tokens for p in P) > self.absorb_tokens
                and self._route_absorb(state, t)):
            return
        hits = None
        if self.prefix_on and r.tokens is not None:
            hits = [p.tree.peek(r.tokens) for p in P]
        pi = self.disp.pick_prefill(r.rid, [p.queue for p in P],
                                    hits=hits, now=t)
        p = P[pi]
        p.queue.push(r)
        state.where = ("prefill", p)
        if self.tracer.enabled:
            self.tracer.phase(r.rid, "queued", t, p.label)
        self._ev.push(t, "prefill_poke", p)

    def _absorb_targets(self) -> List[Any]:
        """Instances that can take a whole prompt when the prefill tier is
        saturated: decode instances with chunk machinery, mixed engines."""
        out: List[Any] = []
        for x in self.inst:
            if x.draining:
                continue
            if isinstance(x, _DecodeInstance) and self._absorb_chunk:
                out.append(x)
            elif isinstance(x, _ColoEngine):
                out.append(x)
        return out

    def _route_absorb(self, state: RequestState, t: float) -> bool:
        targets = self._absorb_targets()
        if not targets:
            return False
        r = state.request
        loads = [float(x.load) for x in targets]
        ai = self.disp.pick_absorb(r.rid, loads, now=t)
        x = targets[ai]
        self.absorbed += 1
        if isinstance(x, _ColoEngine):
            x.waiting.push(r)
            state.where = ("queued", x)
            if self.tracer.enabled:
                self.tracer.phase(r.rid, "queued", t, x.label)
            self._step_engine(x, t)
        else:
            x.absorb.push(r)
            state.where = ("absorb", x)
            if self.tracer.enabled:
                self.tracer.phase(r.rid, "queued", t, x.label)
            self._ev.push(t, "decode_poke", x)
        return True

    def _mixed_arrive(self, state: RequestState, t: float):
        E = self._e_route()
        e = E[least_loaded([x.load for x in E])]
        e.waiting.push(state.request)
        state.where = ("queued", e)
        if self.tracer.enabled:
            self.tracer.phase(state.rid, "queued", t, e.label)
        self._step_engine(e, t)

    def _try_start_prefill(self, p: _PrefillInstance, now: float):
        if self.chunk_tokens:
            self._chunk_step(p, now)
            self._check_flip(p, now)
            return
        while p.can_admit():
            start = max(now, p.next_admit)
            if start > now:
                self._ev.push(start, "prefill_poke", p)
                return
            batch = p.form_batch()
            # prefix hits: only the uncached suffix runs through prefill
            # (match + insert at prefill start, mirroring the live engine,
            # which matches inside prefill_request and publishes the new
            # prompt pages before the next request runs)
            suffix = []
            for r in batch:
                if p.tree is not None and r.tokens is not None:
                    h, _ = p.tree.match(r.tokens)
                    # live engines keep >= 1 suffix token for the logits
                    h = min(h, ((r.in_len - 1) // self.page_tokens)
                            * self.page_tokens)
                    r.prefix_hit = h
                    n_full = (r.in_len // self.page_tokens) * self.page_tokens
                    p.tree.insert(r.tokens[:n_full])
                suffix.append(r.in_len - r.prefix_hit)
            T = self.lm.prefill_time(suffix, p.par)
            p.next_admit = now + T / p.par.pp
            p.inflight += 1
            for r in batch:
                r.prefill_start = now
                st = self._states[r.rid]
                st.where = ("prefill_run", p)
                st.to_status(RequestStatus.PREFILLING)
                if self.tracer.enabled:
                    lane = p.label
                    self.tracer.phase(r.rid, "prefilling", now, lane)
                    self.tracer.complete(
                        "compute", "prefill_batch", now, now + T, lane,
                        rid=r.rid, tokens=r.in_len - r.prefix_hit,
                        hit=r.prefix_hit)
            self._ev.push(now + T, "prefill_done", (p, batch, T))
        self._check_flip(p, now)

    def _on_prefill_done(self, payload, t: float):
        p, batch, T = payload
        p.inflight -= 1
        self.busy_prefill += T
        for r in batch:
            state = self._states[r.rid]
            if state.done:              # cancelled mid-prefill
                continue
            r.first_token = t
            self._emit_token(state, -1, t)
            if self.phase == "prefill":
                self._finish_state(state, t)
                continue
            self._assign_decode(state, t, src=p.iid)
        self._try_start_prefill(p, t)

    # -- chunked prefill (simulator twin of `_prefill_chunk_step`) -------
    def _chunk_step(self, p: _PrefillInstance, now: float):
        """One chunk of the head-of-queue prompt; unfinished prompts
        re-queue at the tail. Chunk policy is byte-identical to the live
        engine: non-final chunks round down to whole pages (>= 1 page) so
        in-place page writes never straddle a partial page; the final
        chunk takes the ragged tail."""
        if p.inflight or not p.queue.items:
            return
        batch = p.queue.form_batch(p.budget, max_batch=1,
                                   chunk_tokens=self.chunk_tokens)
        if not batch:
            return
        r = batch[0]
        state = self._states[r.rid]
        state.to_status(RequestStatus.PREFILLING)
        state.where = ("prefill_run", p)
        ps = self.page_tokens
        S = r.in_len
        if r.rid not in self._chunk_ctx:        # first chunk: prefix match
            r.prefill_start = now
            if p.tree is not None and r.tokens is not None:
                h, _ = p.tree.match(r.tokens)
                h = min(h, ((S - 1) // ps) * ps)
                r.prefix_hit = h
                # publish happens at the FINAL chunk (_on_chunk_done),
                # matching the live engine's prefill_chunk: a prompt
                # cancelled mid-prefill never enters the tree
            self._chunk_ctx[r.rid] = r.prefix_hit
        ctx = self._chunk_ctx[r.rid]
        c = min(self.chunk_tokens, S - ctx)
        if ctx + c < S:
            c = min(max((c // ps) * ps, ps), S - ctx)
        T = self.lm.prefill_chunk_time([(c, ctx)], p.par)
        p.inflight += 1
        if self.tracer.enabled:
            lane = p.label
            self.tracer.phase(r.rid, "prefilling", now, lane)
            self.tracer.complete("compute", "chunk", now, now + T, lane,
                                 rid=r.rid, tokens=c, ctx=ctx)
        self._ev.push(now + T, "chunk_done", (p, r, T, ctx, c))

    def _on_chunk_done(self, payload, t: float):
        p, r, T, ctx, c = payload
        p.inflight -= 1
        self.busy_prefill += T
        state = self._states[r.rid]
        if state.done:                  # cancelled mid-chunk
            self._drop_sim_stream(r, t)
            self._chunk_ctx.pop(r.rid, None)
            self._try_start_prefill(p, t)
            return
        done_tok = ctx + c
        # park this chunk's KV as a shippable segment (same byte charge as
        # the live cluster: prefill-resident KV delta, incl. the prefix
        # hit — the decode-side skip is trimmed at pull time)
        prev = state.progress
        seg = kv_bytes(self.lm.cfg, done_tok, self.lm.dtype_bytes) - \
            (kv_bytes(self.lm.cfg, prev, self.lm.dtype_bytes) if prev else 0)
        self.tx.park_partial(r.rid, max(seg, 0), t)
        state.progress = done_tok
        self._chunk_ctx[r.rid] = done_tok
        if done_tok < r.in_len:
            p.queue.push(r)
            state.where = ("prefill", p)
            if r.rid not in self._sim_stream:
                # first chunk landed: pick the decode target now so the
                # wire can overlap the remaining chunks' compute
                self._predispatch_decode(state, t)
        else:
            if p.tree is not None and r.tokens is not None:
                # final chunk: publish the whole prompt into the prefix
                # tree, the same point the live engine inserts (never
                # earlier — concurrent arrivals must not hit a prompt
                # whose KV is still being computed)
                ps = self.page_tokens
                p.tree.insert(r.tokens[:(r.in_len // ps) * ps])
            r.first_token = t
            self._emit_token(state, -1, t)
            self._chunk_ctx.pop(r.rid, None)
            if self.phase == "prefill":
                self._drop_sim_stream(r, t)
                self._finish_state(state, t)
            elif r.rid in self._sim_stream:
                self._finalize_stream(state, t, src=p.iid)
            else:                       # single-chunk prompt
                self._assign_decode(state, t, src=p.iid)
        self._try_start_prefill(p, t)

    def _engine_adopt(self, state: RequestState, now: float):
        """No decode-role instance remains (an aggregation re-role overlapped
        in-flight prefill work): hand the finished prefill straight to a
        mixed engine's running batch. The KV moves with it; wire time is
        charged as zero — this only occurs in the drain transient."""
        E = self._e_route() or self.engines
        r = state.request
        e = E[least_loaded([x.load for x in E])]
        r.decode_admit = now
        r.transfer_done = now
        e.kv_used += _req_kv_bytes(self.lm, r)
        state.where = ("running", e)
        state.to_status(RequestStatus.DECODING)
        if self.tracer.enabled:
            self.tracer.phase(r.rid, "decoding", now, e.label)
        e.running.append(r)
        self._ev.push(now, "poke", e)

    def _predispatch_decode(self, state: RequestState, now: float):
        r = state.request
        D = self._d_route() or self.D
        if not D:       # aggregation drain: adopt at the final chunk
            return
        d_hits = None
        if self.prefix_on and r.tokens is not None:
            d_hits = [d.tree.peek(r.tokens) for d in D]
        di = self.disp.pick_decode(r.rid, [d.load for d in D],
                                   hits=d_hits, now=now)
        d = D[di]
        r.decode_hit = d_hits[di] if d_hits else 0
        self._sim_stream[r.rid] = d
        d.pending.append(r)
        self._ev.push(now, "decode_poke", d)

    def _finalize_stream(self, state: RequestState, now: float, src: int):
        """Final chunk landed: close the stream with the decode-side ship
        size; admission (or the earlier grant) pulls the per-segment
        schedule."""
        r = state.request
        d = self._sim_stream.pop(r.rid)
        ship = r.in_len - r.decode_hit
        nbytes = kv_bytes(self.lm.cfg, ship, self.lm.dtype_bytes) \
            if ship else 0.0
        self.tx.park(r.rid, r, nbytes, now, src=src)
        state.where = ("pending", d)
        state.to_status(RequestStatus.MIGRATING)
        if self.tracer.enabled:
            self.tracer.phase(r.rid, "migrating", now, d.label)
        self._ev.push(now, "decode_poke", d)

    def _drop_sim_stream(self, r: Request, t: float):
        """Remove every trace of a streamed chunked migration (cancel):
        parked segments, the route, and the granted pages."""
        self.tx.drop_partial(r.rid)
        d = self._sim_stream.pop(r.rid, None)
        if d is None:
            return
        if r in d.pending:
            d.pending.remove(r)
        if r.rid in d.granted:
            del d.granted[r.rid]
            d.pool.free(r.rid)
        self._ev.push(t, "decode_poke", d)

    def _assign_decode(self, state: RequestState, now: float, src: int):
        """Least-loaded decode dispatch + park on the prefill side.
        Draining decode instances still accept work finished on a prefill
        instance (their flip waits for load to reach zero); with no
        decode-typed instance left at all, a mixed engine adopts it."""
        r = state.request
        D = self._d_route() or self.D
        if not D:
            self._engine_adopt(state, now)
            return
        d_hits = None
        if self.prefix_on and r.tokens is not None and self.phase != "decode":
            d_hits = [d.tree.peek(r.tokens) for d in D]
        di = self.disp.pick_decode(r.rid, [d.load for d in D],
                                   hits=d_hits, now=now)
        d = D[di]
        # wire bytes = prompt KV the decode side is missing (decode
        # positions are produced there; a shared prefix already resides
        # there); page reservation below covers the full residency. wire
        # time comes from the latency model so calibrated overrides
        # (benchmarks/table2) take effect.
        if self.phase == "decode":
            nbytes, wire_s = 0.0, 0.0
        else:
            r.decode_hit = d_hits[di] if d_hits else 0
            ship = r.in_len - r.decode_hit
            nbytes = kv_bytes(self.lm.cfg, ship, self.lm.dtype_bytes) \
                if ship else 0.0
            wire_s = self.lm.kv_transfer_time(ship, self.transfer_bw) \
                if ship else 0.0
        self.tx.park(r.rid, r, nbytes, now, src=src, wire_s=wire_s)
        d.pending.append(r)
        state.where = ("pending", d)
        state.to_status(RequestStatus.MIGRATING)
        if self.tracer.enabled:
            self.tracer.phase(r.rid, "migrating", now, d.label)
        self._ev.push(now, "decode_poke", d)

    def _try_admit(self, d: _DecodeInstance, now: float):
        """Pull-based admission: reserve pages, then pull over the link."""
        if self.chunk_tokens:
            # granted streams whose final chunk has landed pull first
            # (their pages are already held; the wire has been moving
            # since the grant)
            progress = True
            while progress:
                progress = False
                for rid, r in list(d.granted.items()):
                    if self.tx.has_parked(rid):
                        del d.granted[rid]
                        self._start_pull(d, r, now)
                        progress = True
                        break
        while d.pending and d.can_admit(d.pending[0]):
            r = d.pending.pop(0)
            d.pool.alloc(r.rid, d.charge_pages(r))
            if self.chunk_tokens and not self.tx.has_parked(r.rid):
                # streamed chunked prefill still computing: grant its
                # residency so parked segments start crossing now
                self.tx.grant(r.rid, now)
                d.granted[r.rid] = r
                continue
            self._start_pull(d, r, now)
        # blocked entries: amortized O(1) marking — entries only append at
        # the tail, so once we hit an already-marked one the rest are too
        # (goodput sweeps run deliberately overloaded; an O(pending) pass
        # per decode event would go quadratic there); streamed entries
        # stay PREFILLING-with-progress until their final chunk
        for r in reversed(d.pending):
            st = self._states[r.rid]
            if st.status is RequestStatus.PENDING_ADMIT:
                break
            if st.status is RequestStatus.MIGRATING:
                st.to_status(RequestStatus.PENDING_ADMIT)
                if self.tracer.enabled:
                    self.tracer.phase(r.rid, "pending_admit", now,
                                      d.label)

    def _start_pull(self, d: _DecodeInstance, r: Request, now: float):
        """Start a request's wire transfer (pages already allocated)."""
        state = self._states[r.rid]
        d.in_transfer += 1
        if d.tree is not None and r.tokens is not None:
            d.tree.match(r.tokens)      # LRU bump, mirrors insert_kv
            n_full = (r.in_len // self.page_tokens) * self.page_tokens
            d.tree.insert(r.tokens[:n_full])
        if self.chunk_tokens:
            _, t_first, t_full = self.tx.pull_streamed(r.rid, now, dst=d.iid)
        else:
            _, t_first, t_full = self.tx.pull_layered(r.rid, now, dst=d.iid)
        state.where = ("transfer", d)
        # per-layer streaming: the request becomes joinable once the
        # first layer lands; the last layer's arrival only gates the
        # drain of the first iteration it joins (pipelined_finish); a
        # granted stream's wire may have finished during prefill, so the
        # joinable time never precedes the pull
        self._ev.push(max(t_first, now), "transfer_first", (d, r, t_full))

    def _on_transfer_first(self, payload, t: float):
        d, r, t_full = payload
        state = self._states[r.rid]
        if state.done:      # cancelled on the wire: pages already freed
            return
        # a granted stream's wire may have finished during prefill
        # (t_full < t): clamp forward so the recorded timeline stays
        # monotone (decode_admit <= transfer_done), as in the live twin
        r.transfer_done = max(t_full, t)
        r.decode_admit = t
        d.in_transfer -= 1
        if self.tracer.enabled:
            # decode starts attending once the first layer lands — the
            # same instant the live cluster stamps in `_admit_one`
            self.tracer.phase(r.rid, "decoding", t, d.label)
        d.arrived.append(r)
        d.kv_full[r.rid] = r.transfer_done
        state.where = ("arrived", d)
        self._try_start_decode(d, t)

    def _try_start_decode(self, d: _DecodeInstance, now: float):
        self._try_admit(d, now)
        if d.busy:
            return
        # absorbed prompts chunk-prefill between decode iterations
        # (prefill-priority, like a mixed engine; the chunk size bounds
        # the decode stall — the interference the chunk charge models)
        if d.absorb is not None and d.absorb.items and self._absorb_chunk \
                and self.phase == "both":
            if self._absorb_step(d, now):
                return
        # transferred requests join the batch at an iteration boundary only
        # (mirrors the live cluster, which admits between decode steps)
        for r in d.arrived:
            st = self._states[r.rid]
            st.where = ("running", d)
            st.to_status(RequestStatus.DECODING)
        d.running.extend(d.arrived)
        d.arrived.clear()
        if not d.running:
            self._check_flip(d, now)
            return
        d.busy = True
        eff_b = max(len(d.running) / d.par.pp, 1.0)
        tau = self.lm.decode_time(eff_b, d.ctx_tokens() / d.par.pp,
                                  Parallelism(d.par.tp, 1))
        end = now + tau
        if d.kv_full:
            for r in d.running:
                kf = d.kv_full.pop(r.rid, None)
                if kf is not None and kf > now:
                    # layer l's attention waits on layer l's pages — the
                    # same charge the live cluster applies
                    end = max(end, pipelined_finish(now, tau, kf,
                                                    self.tx.n_layers))
        if self.tracer.enabled:
            self.tracer.complete("step", "decode_step", now, end,
                                 d.label, batch=len(d.running),
                                 compute=tau)
        self._ev.push(end, "decode_iter", (d, tau))

    def _on_decode_iter(self, payload, t: float):
        d, tau = payload
        self.busy_decode += tau
        d.busy = False
        # hot loop (one pass per simulated decode iteration): when nothing
        # consumes token events and no max_tokens caps are set, skip every
        # per-request flag check and state lookup until finish time
        plain = (not self._recording and not self._ontoken_rids
                 and not self._out_cap)
        cap = self._out_cap
        still = []
        if plain:
            for r in d.running:
                r.tokens_done += 1
                if r.tokens_done >= r.out_len - 1 or r.out_len <= 1:
                    self._finish_state(self._states[r.rid], t)
                    d.pool.free(r.rid)
                else:
                    still.append(r)
        else:
            rec = self._recording
            ontoken = self._ontoken_rids
            for r in d.running:
                r.tokens_done += 1
                out_eff = cap[r.rid] if r.rid in cap else r.out_len
                if rec or r.rid in ontoken:
                    self._emit_token(self._states[r.rid], -1, t)
                if r.tokens_done >= out_eff - 1 or out_eff <= 1:
                    self._finish_state(self._states[r.rid], t)
                    d.pool.free(r.rid)
                else:
                    still.append(r)
        d.running = still
        self._try_start_decode(d, t)

    # -- chunked-prefill absorption (intra-instance aggregation) ---------
    def _absorb_step(self, d: _DecodeInstance, now: float) -> bool:
        """One bounded prefill chunk on a decode instance, between its
        decode iterations (prefill-priority, like a mixed engine). The
        chunk size caps the decode stall; the per-chunk charge is the
        same `prefill_chunk_time` the live engine is billed."""
        def can_take(r):
            if r.rid in d.absorbing:
                return True
            resident = (len(d.running) + len(d.arrived) + d.in_transfer
                        + len(d.absorbing))
            return (resident < d.max_batch
                    and d.pool.can_alloc(d.charge_pages(r)))

        batch = d.absorb.form_batch(
            self._lm_tok, max_batch=1, can_take=can_take,
            chunk_tokens=self._absorb_chunk,
            resumable=lambda r: r.rid in d.absorbing)
        if not batch:
            return False
        r = batch[0]
        state = self._states[r.rid]
        state.to_status(RequestStatus.PREFILLING)
        state.where = ("absorb_run", d)
        ps = self.page_tokens
        S = r.in_len
        if r.rid not in d.absorbing:    # first chunk: reserve residency
            d.absorbing.add(r.rid)
            d.pool.alloc(r.rid, d.charge_pages(r))
            r.prefill_start = now
            if d.tree is not None and r.tokens is not None:
                h, _ = d.tree.match(r.tokens)
                h = min(h, ((S - 1) // ps) * ps)
                r.prefix_hit = h
            self._chunk_ctx[r.rid] = r.prefix_hit
        ctx = self._chunk_ctx[r.rid]
        c = min(self._absorb_chunk, S - ctx)
        if ctx + c < S:
            c = min(max((c // ps) * ps, ps), S - ctx)
        T = self.lm.prefill_chunk_time([(c, ctx)], d.par)
        d.busy = True
        if self.tracer.enabled:
            self.tracer.phase(r.rid, "prefilling", now, d.label)
            self.tracer.complete("compute", "absorb_chunk", now, now + T,
                                 d.label, rid=r.rid, tokens=c, ctx=ctx)
        self._ev.push(now + T, "absorb_done", (d, r, T, ctx, c))
        return True

    def _on_absorb_done(self, payload, t: float):
        d, r, T, ctx, c = payload
        d.busy = False
        self.busy_absorb += T
        state = self._states[r.rid]
        if state.done:                  # cancelled mid-chunk
            if r.rid in d.absorbing:
                d.absorbing.discard(r.rid)
                d.pool.free(r.rid)
            self._chunk_ctx.pop(r.rid, None)
            self._try_start_decode(d, t)
            return
        done_tok = ctx + c
        self._chunk_ctx[r.rid] = done_tok
        if done_tok < r.in_len:
            d.absorb.push(r)
            state.where = ("absorb", d)
        else:
            if d.tree is not None and r.tokens is not None:
                d.tree.insert(r.tokens[:(r.in_len // self.page_tokens)
                                       * self.page_tokens])
            d.absorbing.discard(r.rid)
            self._chunk_ctx.pop(r.rid, None)
            r.first_token = t
            self._emit_token(state, -1, t)
            # KV is already local: no wire, joins at the next boundary
            r.decode_admit = t
            r.transfer_done = t
            d.arrived.append(r)
            state.where = ("arrived", d)
            if self.tracer.enabled:
                self.tracer.phase(r.rid, "decoding", t, d.label)
        self._try_start_decode(d, t)

    # -- mixed-role engine (colocated semantics) --------------------------
    def _step_engine(self, e: "_ColoEngine", now: float):
        if e.busy:
            return
        # prefill first (vLLM prioritizes waiting prefills), batch formed
        # by the shared core; the stateful can_take reserves KV as it admits
        taken = [0, 0.0]

        def can_take(r):
            if (len(e.running) + taken[0] < e.max_b
                    and e.kv_used + taken[1]
                    + _req_kv_bytes(self.lm, r) <= e.cap):
                taken[0] += 1
                taken[1] += _req_kv_bytes(self.lm, r)
                return True
            return False

        batch = e.waiting.form_batch(self.max_prefill_tokens,
                                     can_take=can_take)
        if batch:
            e.kv_used += taken[1]
            e.busy = True
            T = self.lm.prefill_time([r.in_len for r in batch], e.par)
            for r in batch:
                r.prefill_start = now
                st = self._states[r.rid]
                st.where = ("prefill_run", e)
                st.to_status(RequestStatus.PREFILLING)
                if self.tracer.enabled:
                    lane = e.label
                    self.tracer.phase(r.rid, "prefilling", now, lane)
                    self.tracer.complete(
                        "compute", "prefill_batch", now, now + T, lane,
                        rid=r.rid, tokens=r.in_len, hit=0)
            self._ev.push(now + T, "m_prefill_done", (e, batch))
            return
        if e.running:
            e.busy = True
            eff_b = max(len(e.running) / e.par.pp, 1.0)
            ctx = sum(r.in_len + r.tokens_done for r in e.running)
            tau = self.lm.decode_time(eff_b, ctx / e.par.pp,
                                      Parallelism(e.par.tp, 1))
            if self.tracer.enabled:
                self.tracer.complete("step", "decode_step", now, now + tau,
                                     e.label,
                                     batch=len(e.running), compute=tau)
            self._ev.push(now + tau, "m_decode_iter", (e, tau))
            return
        self._check_flip(e, now)

    def _on_mixed_prefill_done(self, payload, t: float):
        e, batch = payload
        e.busy = False
        for r in batch:
            state = self._states[r.rid]
            if state.done:              # cancelled mid-prefill
                e.kv_used -= _req_kv_bytes(self.lm, r)
                continue
            r.first_token = t
            r.decode_admit = t
            self._emit_token(state, -1, t)
            state.where = ("running", e)
            state.to_status(RequestStatus.DECODING)
            if self.tracer.enabled:
                self.tracer.phase(r.rid, "decoding", t, e.label)
            e.running.append(r)
        self._step_engine(e, t)

    def _on_mixed_decode_iter(self, payload, t: float):
        e, tau = payload
        e.busy = False
        rec = self._recording
        ontoken = self._ontoken_rids
        cap = self._out_cap
        still = []
        for r in e.running:
            r.tokens_done += 1
            out_eff = cap[r.rid] if r.rid in cap else r.out_len
            if rec or r.rid in ontoken:
                self._emit_token(self._states[r.rid], -1, t)
            if r.tokens_done >= out_eff - 1 or out_eff <= 1:
                self._finish_state(self._states[r.rid], t)
                e.kv_used -= _req_kv_bytes(self.lm, r)
            else:
                still.append(r)
        e.running = still
        self._step_engine(e, t)

    # -- runtime re-roling ------------------------------------------------
    def set_role(self, g: int, role: str, now: Optional[float] = None):
        """Flip instance ``g`` to ``role`` ("prefill"/"decode"/"mixed").

        The instance leaves the routing views immediately. Queued-but-
        unstarted work is re-routed through the shared dispatcher (so the
        decision log stays comparable across worlds); resident work —
        running decodes, granted/streaming KV, partial chunks — drains in
        place, and the swap to the new-role twin happens when the
        instance is idle. A decode→prefill flip therefore never moves or
        leaks pages (`pool.used == 0` is asserted at completion); a
        prefill→decode flip drains within one batch/chunk time."""
        assert role in ("prefill", "decode", "mixed"), role
        now = self._ev.now if now is None else now
        inst = self.inst[g]
        if self._role_of(inst) == role:
            inst.target = None          # flip-back cancels a pending drain
            inst.draining = False
            return
        if inst.target == role:
            return
        # validate the fleet *after* every pending drain completes:
        # somebody must accept arrivals, and prefill output needs a
        # decode target (draining instances count as their target role)
        after = [x.target or self._role_of(x)
                 for x in self.inst if x is not inst] + [role]
        if not any(r2 in ("prefill", "mixed")
                   or (r2 == "decode" and self._absorb_chunk)
                   for r2 in after):
            raise ValueError("re-roling would leave no instance able to "
                             "accept arrivals")
        if self.phase == "both" and "prefill" in after \
                and "decode" not in after:
            raise ValueError("re-roling would leave prefill instances "
                             "with no decode target")
        inst.draining = True
        inst.target = role
        if self.tracer.enabled:
            self.tracer.event("role_drain", now, lane=inst.label,
                              role=role)
        self._reroute_unstarted(inst, now)
        self._check_flip(inst, now)

    def apply_roles(self, roles: Sequence[str],
                    now: Optional[float] = None):
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
        signal queue depth misses)."""
        P, D, E = self._p_route(), self._d_route(), self._e_route()
        util = max((d.pool.used / max(d.pool.num_pages, 1) for d in D),
                   default=0.0)
        return {
            "prefill_queued_tokens": float(sum(p.queued_tokens
                                               for p in P)),
            "prefill_inflight": float(sum(p.inflight for p in P)),
            "decode_kv_util": float(util),
            "decode_load": float(sum(d.load for d in D)),
            "mixed_load": float(sum(e.load for e in E)),
            "n_prefill": float(len(P)), "n_decode": float(len(D)),
            "n_mixed": float(len(E)),
        }

    def kv_utilization(self) -> float:
        """Peak decode page-pool occupancy in [0, 1] (router-side
        KV-pressure overload signal)."""
        return self.pressure()["decode_kv_util"]

    def _reroute_unstarted(self, inst, now: float):
        if isinstance(inst, _PrefillInstance):
            for r in list(inst.queue.items):
                if r.rid in self._chunk_ctx or r.rid in self._sim_stream:
                    continue        # mid-chunk: finish here
                inst.queue.remove(r)
                self._ev.push(now, "arrive", self._states[r.rid])
            self._ev.push(now, "prefill_poke", inst)
        elif isinstance(inst, _DecodeInstance):
            D = [d for d in self._d_route() if d is not inst]
            for r in list(inst.pending):
                if r.rid in inst.granted or not D:
                    continue        # pages/wire committed: drain here
                inst.pending.remove(r)
                # the parked wire bytes were fixed at park time, so the
                # re-pick skips prefix hits (hit=0 in the decision log)
                di = self.disp.pick_decode(r.rid, [d.load for d in D],
                                           now=now)
                nd = D[di]
                if r.rid in self._sim_stream:
                    self._sim_stream[r.rid] = nd
                nd.pending.append(r)
                self._states[r.rid].where = ("pending", nd)
                self._ev.push(now, "decode_poke", nd)
            if inst.absorb is not None:
                for r in list(inst.absorb.items):
                    if r.rid in inst.absorbing:
                        continue    # partial chunks: finish here
                    inst.absorb.remove(r)
                    self._ev.push(now, "arrive", self._states[r.rid])
            self._ev.push(now, "decode_poke", inst)
        else:
            for r in list(inst.waiting.items):
                inst.waiting.remove(r)
                self._ev.push(now, "arrive", self._states[r.rid])
            self._ev.push(now, "poke", inst)

    def _check_flip(self, inst, now: float):
        if inst.target is None:
            return
        if isinstance(inst, _PrefillInstance):
            if inst.queue.items or inst.inflight:
                return
        elif isinstance(inst, _DecodeInstance):
            if (inst.busy or inst.load or inst.absorb.items
                    or inst.absorbing):
                return
            assert inst.pool.used == 0, \
                f"role flip with {inst.pool.used} pages resident"
        else:
            if inst.busy or inst.waiting.items or inst.running:
                return
        self._complete_flip(inst, now)

    def _complete_flip(self, inst, now: float):
        g = self.inst.index(inst)
        role = inst.target
        inst.target = None
        inst.draining = False
        twin = self._twins.pop((g, role), None)
        if twin is None:
            twin = self._make_instance(role, self._pars[g],
                                       label=inst.label)
        twin.draining = False
        twin.target = None
        self._twins[(g, self._role_of(inst))] = inst
        self.inst[g] = twin
        self._role_events.append((now, inst.label, role))
        if self.tracer.enabled:
            self.tracer.event("role_change", now, lane=inst.label,
                              role=role)
        # fresh capacity: poke so blocked global work can move
        if isinstance(twin, _PrefillInstance):
            self._ev.push(now, "prefill_poke", twin)
        elif isinstance(twin, _DecodeInstance):
            self._ev.push(now, "decode_poke", twin)
        else:
            self._ev.push(now, "poke", twin)
        if self._backlog:
            held, self._backlog = self._backlog, []
            for st in held:
                st.where = None
                self._ev.push(now, "arrive", st)

    # -- cancellation ----------------------------------------------------
    def _do_cancel(self, state: RequestState, t: float):
        r = state.request
        if state.where is None:
            return
        stage, loc = state.where
        if stage == "prefill":              # queued (incl. between chunks)
            loc.queue.remove(r)
            if self.chunk_tokens:
                self._drop_sim_stream(r, t)
                self._chunk_ctx.pop(r.rid, None)
                self._ev.push(t, "prefill_poke", loc)
        elif stage == "prefill_run":        # in-flight prefill batch / chunk:
            pass                            # the done handler drops it
        elif stage == "backlog":            # held during a re-role drain
            self._backlog = [st for st in self._backlog
                             if st.rid != r.rid]
        elif stage == "queued":             # mixed-engine waiting queue
            loc.waiting.remove(r)
        elif stage == "absorb":             # absorb queue (incl. partials)
            loc.absorb.remove(r)
            if r.rid in loc.absorbing:
                loc.absorbing.discard(r.rid)
                loc.pool.free(r.rid)
            self._chunk_ctx.pop(r.rid, None)
            self._ev.push(t, "decode_poke", loc)
        elif stage == "absorb_run":         # mid-chunk: handler cleans up
            pass
        elif stage == "pending":            # parked, unassigned pages
            d = loc
            if r in d.pending:
                d.pending.remove(r)
            if r.rid in d.granted:          # finalized after a grant
                del d.granted[r.rid]
                d.pool.free(r.rid)
            self.tx.cancel(r.rid)           # drops chunk segments too
            self._ev.push(t, "decode_poke", d)  # head may admit now
        elif stage == "transfer":           # on the wire: pages reserved
            d = loc
            d.pool.free(r.rid)
            d.in_transfer -= 1
            self._ev.push(t, "decode_poke", d)
        elif stage == "arrived":
            d = loc
            if r in d.arrived:
                d.arrived.remove(r)
            d.kv_full.pop(r.rid, None)
            d.pool.free(r.rid)
            self._ev.push(t, "decode_poke", d)
        elif stage == "running":
            if isinstance(loc, _ColoEngine):
                if r in loc.running:
                    loc.running.remove(r)
                loc.kv_used -= _req_kv_bytes(self.lm, r)
                self._ev.push(t, "poke", loc)
            else:
                d = loc
                if r in d.running:
                    d.running.remove(r)
                d.kv_full.pop(r.rid, None)
                d.pool.free(r.rid)
                self._ev.push(t, "decode_poke", d)

    # -- metrics ---------------------------------------------------------
    def extras(self) -> Dict:
        reqs = [s.request for s in self._states.values()]
        extras = {
            "kv_total": self.tx.total_time,
            "kv_p95": _percentile(self.tx.times, 0.95),
            "kv_chunks": self.tx.total_chunks,
            "kv_bytes": self.tx.total_bytes,
            "parked_bytes_peak": self.tx.peak_parked_bytes,
            "kv_stream_saved_s": self.tx.stream_saved_s,
            "streamed_pulls": self.tx.streamed_pulls,
            "decisions": self.disp.decisions,
            "states": dict(self._states),
            "breakdown": {"prefill_busy_s": self.busy_prefill,
                          "decode_busy_s": self.busy_decode,
                          **self._breakdown},
        }
        if self.busy_absorb or self.absorbed:
            extras["breakdown"]["absorb_busy_s"] = self.busy_absorb
            extras["absorbed"] = self.absorbed
        if self._role_events:
            extras["role_events"] = list(self._role_events)
        if self.prefix_on:
            extras["prefix"] = {
                "hit_tokens": sum(r.prefix_hit for r in reqs),
                "decode_hit_tokens": sum(r.decode_hit for r in reqs),
                "prompt_tokens": sum(r.in_len for r in reqs),
                "prefill_trees": [p.tree.stats.as_dict() for p in self.P],
                "decode_trees": [d.tree.stats.as_dict() for d in self.D],
            }
        return extras


def simulate_disaggregated(
        reqs: List[Request],
        lm: LatencyModel,
        prefill: InstanceConfig,
        decode: InstanceConfig,
        **kwargs) -> Tuple[List[Request], Dict]:
    """Closed-world shim over `SimDisaggBackend`: submit-all-then-drain.
    Returns (requests with timestamps, extras) — see the backend class
    for the keyword knobs (transfer_bw, lm_tokens, phase, prefix_cache,
    num_decode_pages, dispatcher, horizon, tracker, ...).  Per-token
    event recording defaults OFF here (bulk sweeps); pass
    record_events=True (or a tracker) for ITL distributions."""
    kwargs.setdefault("record_events", False)
    backend = SimDisaggBackend(lm, prefill, decode, **kwargs)
    for r in reqs:
        backend.submit(r)
    backend.drain()
    return reqs, backend.extras()


# ---------------------------------------------------------------------------
# Mixed-role engine state + legacy shims
# ---------------------------------------------------------------------------

class _ColoEngine:
    """Continuous-batching engine state for a ``"mixed"``-role instance
    (vLLM-like prefill-priority; the degenerate colocated deployment is
    every instance carrying this role)."""

    def __init__(self, iid, max_b: float, cap: float,
                 par: Optional[Parallelism] = None):
        self.iid = iid
        self.max_b = max_b
        self.cap = cap
        self.par = par or Parallelism()
        self.waiting: FCFSQueue = FCFSQueue(token_of=lambda r: r.in_len)
        self.running: List[Request] = []
        self.kv_used = 0.0
        self.busy = False

    @property
    def load(self):
        return len(self.waiting) + len(self.running)


class SimDisaggBackend(SimServingBackend):
    """Legacy disaggregated entrypoint: ``(lm, prefill_cfg, decode_cfg)``
    translated to a prefill+decode role vector over the role-unified
    `SimServingBackend`. Schedules, token timestamps, dispatch decisions
    and metric keys are byte-identical to the pre-unification class."""

    def __init__(self, lm: LatencyModel, prefill: InstanceConfig,
                 decode: InstanceConfig, **kwargs):
        roles = ([("prefill", prefill.par)] * prefill.count
                 + [("decode", decode.par)] * decode.count)
        super().__init__(lm, roles, **kwargs)


class SimColocatedBackend(SimServingBackend):
    """Continuous batching with prefill-priority (vLLM v0 default),
    behind the ServingBackend protocol — the degenerate "all instances
    mixed" case of the role-unified `SimServingBackend`."""

    def __init__(self, lm: LatencyModel, inst: InstanceConfig, *,
                 max_batch: Optional[int] = None,
                 max_prefill_tokens: int = 2048,
                 kv_reserve: float = 0.1,
                 horizon: float = 1e9,
                 tracker=None,
                 record_events: bool = True,
                 tracer=None,
                 metrics=None):
        super().__init__(lm, [("mixed", inst.par)] * inst.count,
                         max_mixed_batch=max_batch,
                         max_prefill_tokens=max_prefill_tokens,
                         kv_reserve=kv_reserve,
                         prefix_cache=False,
                         horizon=horizon, tracker=tracker,
                         record_events=record_events,
                         tracer=tracer, metrics=metrics)
        self.par = inst.par

    def extras(self) -> Dict:
        return {"kv_total": 0.0, "kv_p95": 0.0, "breakdown": {},
                "states": dict(self._states)}


def simulate_colocated(
        reqs: List[Request],
        lm: LatencyModel,
        inst: InstanceConfig,
        **kwargs) -> Tuple[List[Request], Dict]:
    """Closed-world shim over `SimColocatedBackend` (see that class).
    Per-token event recording defaults OFF here, as in
    `simulate_disaggregated`."""
    kwargs.setdefault("record_events", False)
    backend = SimColocatedBackend(lm, inst, **kwargs)
    for r in reqs:
        backend.submit(r)
    backend.drain()
    return reqs, backend.extras()


def simulate_roles(
        reqs: List[Request],
        lm: LatencyModel,
        par: Parallelism,
        roles: Sequence[str],
        **kwargs) -> Tuple[List[Request], Dict]:
    """Closed-world shim over the role-unified backend for an arbitrary
    per-instance role vector (placement `mode_search` evaluates candidate
    vectors through this). Keyword knobs as in `SimServingBackend`."""
    kwargs.setdefault("record_events", False)
    backend = SimServingBackend(lm, [(r, par) for r in roles], **kwargs)
    for r in reqs:
        backend.submit(r)
    backend.drain()
    return reqs, backend.extras()
