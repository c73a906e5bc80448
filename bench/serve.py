"""Drive one cell's traffic through the port's `DisaggCluster`.

The cluster runs 1 prefill + 1 decode engine on one card behind its
virtual-clock event loop; each engine step is timed on the host clock
after a device synchronise and charged to that engine's own clock, so
the card emulates DistServe's two-instance deployment. Arrival times,
TTFT and TPOT are virtual seconds; the window is wall seconds.

Phases (one process, one copy of the weights):
  set-up   weights from the seed, the cluster, one warm-up request per
           prompt length the traffic file lists (every prefill shape and
           the decode step run once), then the traffic itself for
           `ramp_s` virtual seconds, until the decode batch is steady;
  window   `--seconds` of wall time: arrivals keep coming on schedule
           (open loop); every request arriving in it counts;
  drain    no more arrivals; requests in flight finish, up to
           `drain_cap_s` virtual (and `drain_wall_s` wall) seconds.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import traffic as tr
from .model import DTYPES

WARM_OFFSET = 1 << 40          # warm-up requests' ids, apart from the traffic's


@dataclasses.dataclass
class Req:
    rid: int
    arrive: float               # virtual, since the first traffic arrival
    in_len: int
    out_len: int
    prompt: List[int]
    state: Any = None           # serving.api.RequestState
    first: float = -1.0         # virtual time of the first token
    times: Tuple[float, ...] = ()
    served: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers and the check."""
    cell: Any
    seed: int
    device: torch.device
    rate: float
    params: Dict[str, Any]
    setup_s: float = 0.0
    w0: float = 0.0             # virtual window, since the first arrival
    w1: float = 0.0
    wall_s: float = 0.0         # the window's wall seconds
    drain_wall_s: float = 0.0
    requests: List[Req] = dataclasses.field(default_factory=list)
    spans: Optional[list] = None            # tracer spans (traced runs)
    span_t0: float = 0.0                    # tracer time of arrival 0
    profile: Any = None                     # devtrace.Profile (traced runs)
    profiled: Tuple[int, int] = (0, 0)      # spans recorded while profiled
    memory_peak_bytes: int = 0              # in use (see `_memory`)
    memory_allocated_bytes: int = 0         # the allocator's peak
    kv_pages: Tuple[int, int] = (0, 0)      # decode pages: peak used, pool
    backlog: Tuple[int, int] = (0, 0)       # waiting at w0 and at w1

    @property
    def dims(self) -> Dict[str, int]:
        return self.cell.model.dims(self.cell.config)

    @property
    def window(self) -> List[Req]:
        return [r for r in self.requests if self.w0 < r.arrive <= self.w1]


def build_cluster(cell, params, device, tracer=None):
    from repro_torch.serving.cluster import DisaggCluster
    c = cell.traffic["cluster"]
    return DisaggCluster(
        cell.model.model_config(cell.config), params, n_prefill=c["n_prefill"],
        n_decode=c["n_decode"], max_batch=c["max_batch"],
        max_len=c["max_len"], transfer_bandwidth=float(
            c["transfer_bandwidth"]), page_size=c["page_size"],
        decode_num_pages=c["decode_num_pages"], prefix_cache=False,
        chunk_tokens=None, tracer=tracer, device=device,
        dtype=DTYPES[cell.config["torch_dtype"]])


def _warm_up(cluster, cell, seed: int):
    from repro_torch.core.workload import Request
    V = cell.config["vocab_size"]
    reqs = [Request(WARM_OFFSET + i, 0.0, n, 2,
                    tokens=tuple(tr.prompt_tokens(seed, WARM_OFFSET + i, n,
                                                  V)))
            for i, n in enumerate(cell.traffic["warmup_prompts"])]
    cluster.run(reqs)


class _Driver:
    """Feeds the open-loop schedule to the cluster: an arrival is submitted
    as soon as no event earlier than it remains, so the event loop always
    sees it before anything later happens."""

    def __init__(self, cluster, run: Run, t_off: float):
        self.cluster = cluster
        self.run = run
        self.t_off = t_off
        self.sched = tr.arrivals(run.cell.traffic, run.rate)
        self.nxt = next(self.sched)
        self.V = run.cell.config["vocab_size"]

    def _submit(self):
        from repro_torch.core.workload import Request
        a = self.nxt
        prompt = tr.prompt_tokens(self.run.seed, a.rid, a.in_len, self.V)
        req = Req(a.rid, a.t, a.in_len, a.out_len, prompt)
        req.state = self.cluster.submit(Request(
            a.rid, self.t_off + a.t, a.in_len, a.out_len,
            tokens=tuple(prompt))).state
        self.run.requests.append(req)
        self.nxt = next(self.sched)

    def advance(self, until: float = None, deadline: float = None,
                submit: bool = True, hook=None) -> None:
        """Process arrivals and events up to virtual time `until` (since
        the first arrival) or wall time `deadline`, whichever comes first;
        `hook()` runs between events."""
        c = self.cluster
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            if hook is not None:
                hook()
            t_ev = c.next_time()
            if submit and (t_ev is None or self.t_off + self.nxt.t <= t_ev):
                # the arrival comes first: nothing at or before it is left
                if until is not None and self.nxt.t > until:
                    return
                self._submit()
                continue
            if t_ev is None or (until is not None
                                and t_ev - self.t_off > until):
                return
            c.step()

    def waiting(self) -> int:
        """Requests that arrived and have no first token yet."""
        return sum(1 for r in self.run.requests
                   if not r.state.events and not r.state.done)


def _memory(run: Run, cluster) -> None:
    """The peak memory in use: the allocator's peak less the decode pages
    the traffic never took. The page pool is allocated whole at set-up
    (sized as a deployment sizes it, from the memory left over), so its
    untouched pages are a reservation, not state the cell holds."""
    kv = cluster.decode[0].stats()
    used, pool = int(kv["kv.peak_used_pages"]), int(kv["kv.num_pages"])
    run.kv_pages = (used, pool)
    if run.device.type != "cuda":
        return
    torch.cuda.synchronize(run.device)
    cfg = run.cell.model.model_config(run.cell.config)
    page = cfg.kv_bytes_per_token(DTYPES[run.cell.config["torch_dtype"]]
                                  .itemsize) \
        * run.cell.traffic["cluster"]["page_size"]
    run.memory_allocated_bytes = torch.cuda.max_memory_allocated(run.device)
    # page 0 is the pool's trash page, never handed out
    run.memory_peak_bytes = run.memory_allocated_bytes \
        - (pool - 1 - used) * page


def serve(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, rate: float = None) -> Run:
    """One run of `cell`; returns the run with the cluster freed."""
    from repro_torch.core.telemetry import Tracer
    device = torch.device(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    params = cell.model.draw_weights(cell.config, seed, device)
    run = Run(cell, seed, device,
              tr.rate_of(cell.traffic) if rate is None else rate, params)
    tracer = Tracer() if trace else None
    cluster = build_cluster(cell, params, device, tracer)
    marks.append(("weights+cluster", time.perf_counter()))
    _warm_up(cluster, cell, seed)
    marks.append(("warm-up", time.perf_counter()))
    t_off = cluster.now
    if tracer is not None:
        # the warm-up's spans are no part of the run
        tracer.spans.clear()
        tracer.instants.clear()
    drv = _Driver(cluster, run, t_off)
    T = cell.traffic
    if trace:
        from .devtrace import Profile
        prof = Profile(device)
        prof.warm()
    drv.advance(until=float(T["ramp_s"]))
    run.w0 = cluster.now - t_off
    run.backlog = (drv.waiting(), 0)
    run.setup_s = time.perf_counter() - t_start
    marks.append(("ramp", t_start + run.setup_s))
    parts = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                      for a, b in zip(marks, marks[1:]))
    print(f"[bench] set-up {run.setup_s:.3f} s ({parts}), ramp to "
          f"{run.w0:.3f} virtual s, {len(run.requests)} requests",
          file=sys.stderr)

    # the window
    t0 = time.perf_counter()
    deadline = t0 + seconds
    hook = None
    if trace:
        p_on = t0 + min(float(T["profile"]["delay_s"]), seconds / 2)
        p_len = float(T["profile"]["seconds"])

        def hook():
            now = time.perf_counter()
            if not prof.started and now >= p_on:
                run.profiled = (len(tracer.spans), len(tracer.spans))
                prof.start()
            elif (prof.started and not prof.stopped
                  and now - prof.t_start >= p_len):
                prof.stop()
                run.profiled = (run.profiled[0], len(tracer.spans))
    drv.advance(deadline=deadline, hook=hook)
    if trace and prof.started and not prof.stopped:
        prof.stop()
        run.profiled = (run.profiled[0], len(tracer.spans))
    run.wall_s = time.perf_counter() - t0
    run.w1 = cluster.now - t_off
    run.backlog = (run.backlog[0], drv.waiting())

    # the drain
    t1 = time.perf_counter()
    drv.advance(until=run.w1 + float(T["drain_cap_s"]),
                deadline=t1 + float(T["drain_wall_s"]), submit=False)
    run.drain_wall_s = time.perf_counter() - t1
    _memory(run, cluster)
    if trace:
        run.profile = prof
        run.spans = list(tracer.spans)
        run.span_t0 = t_off
        run.profile.read()

    for r in run.requests:
        st = r.state
        r.times = tuple(e.t - t_off for e in st.events)
        if r.times:
            r.first = r.times[0]
        r.finished = st.status.name == "FINISHED"
        if st.seq is not None:
            r.served = list(st.seq.tokens[r.in_len:])
        r.state = None
    # the program's state goes before the reference runs
    del cluster, drv, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run
