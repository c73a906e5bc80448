# Copied unchanged from src/repro/core/kv_transfer.py.
"""Pull-based, block-granular KV-cache migration (paper §4.3 "combat
burstiness" + §3.3).

The prefill instance's HBM acts as the queuing buffer: finished prefills
park there; the decode instance *pulls* a request's KV only when it has
free pages, so bursts never overload decode memory. Transfers move in
page-sized chunks over a dedicated link per prefill→decode pair (each pair
has its own `_link_free_at` serialization point; different pairs proceed in
parallel). Per-request wire time is accounted layer-wise: the last layer's
chunk completes at `start + nbytes/bw`, and the *exposed* latency before
decode can start attending is one layer's worth less when layer transfers
overlap the decode engine's per-layer compute (tracked in
`layer_overlap_s`). Sizes come from the model config (GQA-aware; SSM archs
move a constant-size state instead of per-token KV).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from .telemetry import NULL_TRACER


def kv_bytes(cfg, prompt_len: int, dtype_bytes: int = 2) -> int:
    """Bytes migrated for one request (the paper's 1.13 GB/512-tok OPT-66B
    analogue, adjusted for GQA / SWA / SSM)."""
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        nh = d_in // s.head_dim
        return cfg.num_layers * nh * s.head_dim * s.state_dim * 4
    eff = min(prompt_len, cfg.sliding_window) if cfg.sliding_window else prompt_len
    b = cfg.kv_bytes_per_token(dtype_bytes) * eff
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        nh = d_in // s.head_dim
        b += cfg.num_layers * nh * s.head_dim * s.state_dim * 4
    return b


def layered_times(start: float, wire_s: float,
                  n_layers: int) -> Tuple[float, float]:
    """Per-layer streaming schedule of one KV transfer: layers cross the
    wire back-to-back, so layer 1 lands at start + wire/L and the last at
    start + wire. Decode may start attending at first-layer-landed; only
    wire/L of the transfer is exposed when per-layer compute covers the
    rest."""
    L = max(n_layers, 1)
    return start + wire_s / L, start + wire_s


def pipelined_finish(iter_start: float, step_s: float, kv_full_at: float,
                     n_layers: int) -> float:
    """Finish time of a decode iteration whose member KV is still landing
    layer-by-layer: layer i's compute can only run after layer i's pages
    arrive, so the iteration drains at the later of plain compute and the
    last layer's arrival plus that layer's compute slice."""
    L = max(n_layers, 1)
    return max(iter_start + step_s, kv_full_at + step_s / L)


@dataclasses.dataclass
class ParkedKV:
    rid: int
    blob: Any
    nbytes: int
    parked_at: float
    src: int = 0                    # prefill instance holding the pages
    wire_s: Optional[float] = None  # override nbytes/bandwidth (e.g. an
                                    # empirically calibrated transfer time)


@dataclasses.dataclass
class KVSegment:
    """One chunk's worth of KV, ready to ship the moment its prefill chunk
    finished (chunked prefill parks per chunk, not per request)."""
    ready: float
    nbytes: int
    wire_s: Optional[float] = None  # override nbytes/bandwidth


class TransferManager:
    """Parked KV on the prefill side + per-link wire-time model.

    One serialization point per (src prefill, dst decode) link; transfers
    are chunked into `page_bytes` blocks and `n_layers` layer slices for
    accounting.
    """

    def __init__(self, bandwidth: float, *, page_bytes: Optional[int] = None,
                 n_layers: int = 1, track_wall: bool = False):
        self.bandwidth = bandwidth
        self.page_bytes = page_bytes
        self.n_layers = max(n_layers, 1)
        self.track_wall = track_wall
        self.parked: Dict[int, ParkedKV] = {}
        self.total_bytes = 0
        self.total_chunks = 0
        self.total_time = 0.0
        self.layer_overlap_s = 0.0      # wire time hidable under per-layer
                                        # decode compute (all but one layer)
        self.times: List[float] = []
        self.peak_parked_bytes = 0
        self.cancelled_bytes = 0        # parked bytes dropped by cancel()
        self.stream_saved_s = 0.0       # wire time hidden under later prefill
                                        # chunks (vs park-at-prefill-done)
        self.streamed_pulls = 0
        self.partial: Dict[int, List[KVSegment]] = {}
        self._granted: Dict[int, float] = {}
        self._link_free_at: Dict[Tuple[int, int], float] = {}
        self.tracer = NULL_TRACER       # backends swap in their Tracer

    def park(self, rid: int, blob: Any, nbytes: int, now: float, src: int = 0,
             wire_s: Optional[float] = None):
        self.parked[rid] = ParkedKV(rid, blob, nbytes, now, src, wire_s)
        self.peak_parked_bytes = max(self.peak_parked_bytes,
                                     self.parked_bytes())
        if self.tracer.enabled:
            self.tracer.event("park", now, rid=rid, bytes=int(nbytes),
                              src=src)

    def park_partial(self, rid: int, nbytes: int, now: float,
                     wire_s: Optional[float] = None):
        """Record one finished prefill chunk's KV as shippable from `now`.

        Chunked prefill calls this once per chunk; the final `park` (with
        the blob and the decode-side ship size) closes the stream and
        `pull_streamed` charges the per-segment wire schedule."""
        self.partial.setdefault(rid, []).append(
            KVSegment(now, int(nbytes), wire_s))
        self.peak_parked_bytes = max(self.peak_parked_bytes,
                                     self.parked_bytes())
        if self.tracer.enabled:
            self.tracer.event("park_chunk", now, rid=rid, bytes=int(nbytes))

    def grant(self, rid: int, now: float):
        """Decode side reserved pages for a still-prefilling request: the
        wire may start moving already-parked segments from `now` on, so the
        stream's start floor is the grant time, not the final-park time."""
        if rid not in self._granted and self.tracer.enabled:
            self.tracer.event("grant", now, rid=rid)
        self._granted.setdefault(rid, now)

    def has_parked(self, rid: int) -> bool:
        """True once the final `park` closed the request's stream."""
        return rid in self.parked

    def drop_partial(self, rid: int) -> int:
        """Forget a cancelled request's parked chunk segments (and any
        grant). Returns the number of bytes dropped."""
        segs = self.partial.pop(rid, None)
        self._granted.pop(rid, None)
        if not segs:
            return 0
        n = sum(s.nbytes for s in segs)
        self.cancelled_bytes += n
        return n

    def parked_bytes(self) -> int:
        return (sum(p.nbytes for p in self.parked.values())
                + sum(s.nbytes for segs in self.partial.values()
                      for s in segs))

    def stats(self) -> Dict[str, float]:
        """Pull-collector snapshot for a `MetricsRegistry`."""
        return {"parked_bytes": self.parked_bytes(),
                "parked_requests": len(self.parked),
                "partial_streams": len(self.partial),
                "peak_parked_bytes": self.peak_parked_bytes,
                "total_bytes": self.total_bytes,
                "total_chunks": self.total_chunks,
                "total_time_s": self.total_time,
                "layer_overlap_s": self.layer_overlap_s,
                "stream_saved_s": self.stream_saved_s,
                "streamed_pulls": self.streamed_pulls,
                "cancelled_bytes": self.cancelled_bytes}

    def cancel(self, rid: int) -> Optional[ParkedKV]:
        """Unpark a request whose transfer will never be pulled (request
        cancelled while MIGRATING / PENDING_ADMIT): the prefill-side HBM
        buffer is released, nothing crosses the wire. Returns the popped
        entry (truthy) so callers can release blob-held resources, or
        None if nothing was parked."""
        self.drop_partial(rid)
        p = self.parked.pop(rid, None)
        if p is None:
            return None
        self.cancelled_bytes += p.nbytes
        return p

    def chunks_for(self, nbytes: int) -> int:
        if nbytes <= 0:
            return 0
        if not self.page_bytes:
            return 1
        return math.ceil(nbytes / self.page_bytes)

    def pull(self, rid: int, now: float, dst: int = 0) -> Tuple[Any, float]:
        """Decode side pulls; returns (blob, completion_time). The wire is
        occupied per (src, dst) link; other links proceed in parallel."""
        blob, _, t_full = self.pull_layered(rid, now, dst)
        return blob, t_full

    def pull_layered(self, rid: int, now: float,
                     dst: int = 0) -> Tuple[Any, float, float]:
        """Pull with the per-layer streaming schedule exposed: returns
        (blob, first_layer_landed, last_layer_landed). Decode admission
        can start attending at the first time; the iteration that includes
        the request only drains past the second (see `pipelined_finish`).
        """
        p = self.parked.pop(rid)
        link = (p.src, dst)
        start = max(now, self._link_free_at.get(link, 0.0))
        dt = p.wire_s if p.wire_s is not None else p.nbytes / self.bandwidth
        self._link_free_at[link] = start + dt
        self.total_bytes += p.nbytes
        self.total_chunks += self.chunks_for(p.nbytes)
        self.total_time += dt
        self.layer_overlap_s += dt * (self.n_layers - 1) / self.n_layers
        self.times.append(dt)
        t_first, t_full = layered_times(start, dt, self.n_layers)
        if self.tracer.enabled:
            self.tracer.complete("wire", "kv_pull", start, t_full,
                                 f"wire:{p.src}->{dst}", rid=rid,
                                 bytes=int(p.nbytes), t_first=t_first)
        return p.blob, t_first, t_full

    def pull_streamed(self, rid: int, now: float,
                      dst: int = 0) -> Tuple[Any, float, float]:
        """Pull a request whose KV was parked chunk-by-chunk
        (`park_partial`) while later prefill chunks were still computing.

        Segments cross the (src, dst) link back-to-back in chunk order,
        each no earlier than its prefill chunk finished (`ready`) and no
        earlier than the decode side reserved pages (`grant`). The
        decode-side prefix hit is trimmed off the *front* of the stream
        (prefix pages ship first; the final `park`'s `nbytes` is the
        authoritative ship size). Returns (blob, t_first, t_full) where
        `t_first` is first-layer-of-last-chunk-landed — every earlier
        chunk has fully landed by then, so decode may start attending —
        and `t_full` is the last layer of the last chunk.

        With no parked segments this degenerates to `pull_layered`'s
        single-segment schedule."""
        p = self.parked.pop(rid)
        segs = self.partial.pop(rid, None)
        granted = self._granted.pop(rid, None)
        if not segs:
            segs = [KVSegment(p.parked_at, p.nbytes, p.wire_s)]
        # trim the decode-side hit off the front of the stream
        trim = max(sum(s.nbytes for s in segs) - p.nbytes, 0)
        keep: List[KVSegment] = []
        for s in segs:
            if trim >= s.nbytes:
                trim -= s.nbytes
                continue
            if trim > 0:
                frac = (s.nbytes - trim) / s.nbytes
                w = s.wire_s * frac if s.wire_s is not None else None
                keep.append(KVSegment(s.ready, s.nbytes - trim, w))
                trim = 0
            else:
                keep.append(s)
        link = (p.src, dst)
        floor = max(granted if granted is not None else now,
                    self._link_free_at.get(link, 0.0))
        if not keep:
            self._link_free_at[link] = floor
            self.times.append(0.0)
            if self.tracer.enabled:
                self.tracer.complete("wire", "kv_stream", floor, floor,
                                     f"wire:{p.src}->{dst}", rid=rid,
                                     bytes=0, segs=0)
            return p.blob, floor, floor
        t = floor
        t_start = max(floor, keep[0].ready)
        wire_total = 0.0
        w_last = 0.0
        for s in keep:
            w = s.wire_s if s.wire_s is not None else s.nbytes / self.bandwidth
            t = max(t, s.ready) + w
            wire_total += w
            w_last = w
        t_full = t
        t_first = t_full - w_last + w_last / self.n_layers
        self._link_free_at[link] = t_full
        nbytes = sum(s.nbytes for s in keep)
        self.total_bytes += nbytes
        self.total_chunks += sum(self.chunks_for(s.nbytes) for s in keep)
        self.total_time += wire_total
        self.layer_overlap_s += w_last * (self.n_layers - 1) / self.n_layers
        self.times.append(wire_total)
        # vs park-at-prefill-done (serial): start everything at the last
        # chunk's ready time
        last_ready = keep[-1].ready
        self.stream_saved_s += max(last_ready + wire_total - t_full, 0.0)
        self.streamed_pulls += 1
        if self.tracer.enabled:
            self.tracer.complete("wire", "kv_stream", t_start, t_full,
                                 f"wire:{p.src}->{dst}", rid=rid,
                                 bytes=int(nbytes), segs=len(keep),
                                 t_first=t_first)
        return p.blob, t_first, t_full
