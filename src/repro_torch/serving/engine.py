"""Live single-instance inference engine (port of
`repro/serving/engine.py`).

On the paged KV runtime (the dense decoder), KV storage is a pool of
fixed-size pages plus per-sequence block tables, managed by
`KVCacheManager`. Prefill caches are spliced in at page granularity (a
block-table update plus an O(pages) in-place write into the pools) and
decode runs through `paged_insert` + `paged_decode`, fused into one
kernel on the card.
Prefill runs per request, right-padded to the JAX engine's length buckets
and page buckets, so blob shapes and trash-padded tables match the JAX
engine's.

Every other engine runs on the dense slab: a `max_batch` cache of
`Model.cache_specs`, one slot per resident sequence, and
`Model.decode_step`. The slab prefill returns caches already at the
slab's lengths (padded to `max_len`, windowed segments ring-packed), so
the insert is a slot write. The transformer takes it with `paged=False`
and for sliding-window and local-global archs, with bucketed prefill
(`last_pos` picks the first token's row) unless the arch is
exact-length; its decode runs `paged_decode` over the slab viewed as
pages. The SSM family prefills at exact length (its scan through the
`ssd_scan` kernel) and migrates its constant-size state.

Step times are measured on the host clock after a device synchronise and
accumulated on a virtual clock, so one host can emulate N concurrent
instances.

The engine runs on the card (`device=None` means "cuda"; with no CUDA
device it raises). `device="cpu"` runs every kernel's plain version, as
the tests do. The dense-gather `fused_prefix=False` fallback is ROADMAP
A8.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.api import build_model, supports_paged
from .api import FINISH_LENGTH, FINISH_STOP, SamplingParams
from .kv_cache import KVCacheManager, TRASH_PAGE
from .prefix_cache import RadixPrefixCache

_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port's plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _seg_names(tree) -> List[str]:
    return [k for k in tree if k.startswith("seg")]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


@dataclasses.dataclass
class KVBlob:
    """Migration payload handed to the transfer layer.

    On the fused prefix path `cache` carries only the *suffix* KV: the
    prefix tokens stay in the owning prefill engine's page pool, pinned
    via `prefix_pages` until `Engine.materialize_wire` stitches the wire
    payload or `release_blob` drops the claim. Unpacks like the legacy
    `(cache, n_tok)` tuple for non-prefix consumers."""
    cache: Any
    n_tok: int
    prefix_tokens: int = 0
    prefix_pages: List[int] = dataclasses.field(default_factory=list)
    owner: Optional["Engine"] = None

    def __iter__(self):
        return iter((self.cache, self.n_tok))

    def __getitem__(self, i):
        return (self.cache, self.n_tok)[i]


def release_blob(blob):
    """Drop a blob's claim on its owner's prefix pages (no-op for legacy
    tuple blobs and for blobs already materialized)."""
    if isinstance(blob, KVBlob) and blob.prefix_pages:
        blob.owner.unpin(blob.prefix_pages)
        blob.prefix_pages = []


@dataclasses.dataclass
class PartialPrefill:
    """Resumable chunked-prefill state: the prompt's full block table is
    reserved at chunk 0; `done` tracks how many prompt tokens have KV
    resident in pool pages (cached prefix included)."""
    table: List[int]
    hit: int                    # cached-prefix tokens (page-aligned)
    done: int                   # resident prompt tokens (>= hit)
    chunks: int = 0             # chunks computed so far


@dataclasses.dataclass
class Sequence:
    rid: int
    tokens: List[int]
    out_len: int
    slot: int = -1
    produced: int = 0
    done: bool = False
    prefilled: int = 0          # resident prompt tokens (chunked prefill)
    prefix_hit: int = 0         # prefill-side cached-prefix tokens
    decode_hit: int = 0         # decode-side shared-prefix tokens
    kv_first: float = 0.0       # when the first layer's KV landed (stream)
    kv_full: float = 0.0        # when the last layer's KV lands (stream)
    sampling: Optional[SamplingParams] = None
    finish_reason: str = FINISH_LENGTH
    _rng: Any = None            # lazy, only for temperature > 0

    def append_token(self, tok: int):
        """Append one generated token and apply the stop conditions:
        a SamplingParams.stop id ends generation early (finish_reason
        "stop"); otherwise the out_len budget ends it ("length")."""
        self.tokens.append(tok)
        self.produced += 1
        sp = self.sampling
        if sp is not None and sp.stop and tok in sp.stop:
            self.done = True
            self.finish_reason = FINISH_STOP
        elif self.produced >= self.out_len:
            self.done = True

    def rng(self):
        if self._rng is None:
            sp = self.sampling or SamplingParams()
            self._rng = np.random.default_rng((sp.seed, self.rid))
        return self._rng


class Engine:
    def __init__(self, cfg, params=None, *, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0, attn_blocks=(128, 128),
                 dtype=torch.float32, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 paged: Optional[bool] = None,
                 prefix_cache: bool = False,
                 fused_prefix: Optional[bool] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.dtype = dtype
        # exact-length prefill for state-carrying families
        self.exact_len = (cfg.family in ("ssm", "hybrid", "encdec")
                          or cfg.sliding_window > 0)
        self.paged = supports_paged(cfg) if paged is None \
            else (paged and supports_paged(cfg))
        self.prefix_caching = bool(prefix_cache and self.paged)
        if self.prefix_caching and fused_prefix is not None \
                and not fused_prefix:
            raise NotImplementedError(
                "the dense-gather fused_prefix=False fallback is not ported "
                "yet (ROADMAP A8)")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        # `.to` makes no copy of a leaf already in dtype on the device
        self.params = self.model.cast(params, dtype, self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.attn_blocks = attn_blocks
        self.clock = 0.0                      # virtual seconds
        self.steps = 0
        self.prefill_tokens = 0               # tokens actually computed
        self.prefix_hit_tokens = 0            # tokens served from the tree
        self.decode_tokens = 0
        self.fused_dispatches = 0             # prefix_prefill kernel calls
        self.chunk_dispatches = 0             # chunked-prefill kernel calls
        self._kv = None
        if self.paged:
            pps = -(-max_len // page_size)
            # default pool: dense-slab-equivalent capacity + trash page 0
            num_pages = num_pages or (max_batch * pps + 1)
            assert num_pages >= pps + 1, \
                "page pool must fit at least one max_len sequence"
            self._kv = KVCacheManager(num_pages, page_size, max_len)
        self.prefix_cache = (RadixPrefixCache(page_size, allocator=self._kv)
                             if self.prefix_caching else None)
        # the fused paged-prefix prefill (prefix_prefill kernel) is the
        # only prefix path of the port
        self.fused_prefix = self.prefix_caching
        self._cache = self._empty_cache()
        self._partial: Dict[int, PartialPrefill] = {}
        self._slot_free = list(range(max_batch))

    def stats(self) -> Dict[str, float]:
        """Pull-collector snapshot for a `MetricsRegistry`: cumulative
        dispatch counters plus page-pool occupancy and prefix-tree state."""
        out: Dict[str, float] = {
            "clock_s": self.clock, "steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "decode_tokens": self.decode_tokens,
            "fused_dispatches": self.fused_dispatches,
            "chunk_dispatches": self.chunk_dispatches,
            "slots_free": len(self._slot_free),
            "partial_prefills": len(self._partial),
        }
        if self._kv is not None:
            out.update(self._kv.stats())
        if self.prefix_caching:
            for k, v in self.prefix_cache.metrics().items():
                out[f"prefix.{k}"] = v
        return out

    # ---- cache plumbing ------------------------------------------------
    def _empty_cache(self):
        if self.paged:
            specs = self.model.paged_cache_specs(
                self.max_batch, self._kv.num_pages, self._kv.page_size,
                self.dtype, max_len=self.max_len)
        else:
            specs = self.model.cache_specs(self.max_batch, self.max_len,
                                           self.dtype)

        def alloc(s):
            if isinstance(s, dict):
                return {k: alloc(v) for k, v in s.items()}
            return torch.zeros(s.shape, dtype=s.dtype, device=self.device)
        return alloc(specs)

    def _sync(self):
        """Wait for the device (the JAX engine's block_until_ready): step
        times are read on the host clock after it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_pages(self, n: int) -> int:
        """Power-of-two page-count bucket (capped at a full sequence), the
        JAX engine's, so gathers and tables have the same shapes."""
        pps = -(-self.max_len // self._kv.page_size)
        return min(1 << max(n - 1, 0).bit_length(), pps) if n else 0

    def _padded_page_ids(self, pages: List[int], n_bucket: int):
        return torch.as_tensor(
            list(pages) + [TRASH_PAGE] * (n_bucket - len(pages)),
            dtype=torch.int32, device=self.device)

    def _gather(self, ids: torch.Tensor):
        """Gather pool pages into a dense (layers, 1, n*ps, Hkv, hd) blob
        per segment (the migration payload of a page-backed blob)."""
        ps = self._kv.page_size
        n_pages = ids.shape[0]
        out = {}
        for name in _seg_names(self._cache):
            o = {}
            for part in ("k", "v"):
                pool = self._cache[name][part]  # (L, num_pages, ps, H, hd)
                sel = pool[:, ids.long()]
                o[part] = sel.reshape(pool.shape[0], n_pages * ps,
                                      *pool.shape[3:])[:, None]
            out[name] = o
        return out

    def _write_pages(self, src_segs, splice_ids: List[int]):
        """Write a dense (layers, 1, src_len, Hkv, hd) blob per segment
        into pool pages `splice_ids`, in place (JAX donated the pools to a
        jitted scatter)."""
        ps = self._kv.page_size
        n_splice = len(splice_ids)
        span = n_splice * ps
        ids = torch.as_tensor(list(splice_ids), dtype=torch.long,
                              device=self.device)
        for name, seg in src_segs.items():
            for part in ("k", "v"):
                src = seg[part][:, 0]
                src_len = src.shape[1]
                if src_len > span:
                    src = src[:, :span]
                elif src_len < span:
                    src = torch.nn.functional.pad(
                        src, (0, 0, 0, 0, 0, span - src_len))
                dst = self._cache[name][part]
                dst[:, ids] = src.reshape(
                    (src.shape[0], n_splice, ps) + tuple(src.shape[2:])
                ).to(dst.dtype)

    # ---- public API -----------------------------------------------------
    def has_slot(self) -> bool:
        return bool(self._slot_free)

    @property
    def free_slots(self) -> int:
        return len(self._slot_free)

    @property
    def free_pages(self) -> int:
        return self._kv.free_pages if self.paged else self.free_slots

    @staticmethod
    def tokens_needed(seq: Sequence) -> int:
        """KV positions for the sequence's full residency: cached prompt +
        every remaining decode write."""
        return len(seq.tokens) - 1 + seq.out_len - seq.produced

    def can_admit(self, seq: Sequence, n_shared_pages: int = 0) -> bool:
        """Pull-based admission signal: a free batch slot AND enough free
        KV pages for the whole residency (paper §4.3). Under pressure,
        cached-but-unreferenced prefix subtrees are reclaimed (LRU)
        before rejecting."""
        if not self._slot_free:
            return False
        if not self.paged:
            return True
        need = self._kv.pages_for(self.tokens_needed(seq)) - n_shared_pages
        if need > self._kv.free_pages and self.prefix_caching:
            self.prefix_cache.evict(need - self._kv.free_pages)
        return self._kv.can_admit(self.tokens_needed(seq), n_shared_pages)

    def reserve_for(self, seq: Sequence, n_shared: int = 0) -> int:
        """Hold the sequence's full residency ahead of its insert
        (streamed chunked admission). Returns the page count for
        `unreserve`."""
        n = max(self._kv.pages_for(self.tokens_needed(seq)) - n_shared, 0)
        self._kv.reserve(n)
        return n

    def unreserve(self, n_pages: int):
        if n_pages:
            self._kv.unreserve(n_pages)

    # ---- prefix-cache surface ------------------------------------------
    def prefix_peek(self, tokens) -> int:
        """Routing probe: longest cached prefix (tokens), no LRU bump."""
        return self.prefix_cache.peek(tokens) if self.prefix_caching else 0

    def pin_prefix(self, tokens) -> Tuple[int, List[int]]:
        """Match + take a reference on the hit pages so they survive until
        `insert_kv`. Returns (hit_tokens, page_ids); release with
        `unpin`."""
        if not self.prefix_caching:
            return 0, []
        hit, pages = self.prefix_cache.match(tokens)
        if pages:
            self._kv.acquire(pages)
        return hit, pages

    def unpin(self, pages: List[int]):
        if pages:
            self._kv.release(pages)

    def _bucket(self, n: int) -> int:
        b = next((b for b in _BUCKETS if n <= b), n)
        return min(max(b, n), self.max_len)

    def _forward_chunk(self, padded, ctx_pages: List[int], ctx_len: int,
                       last_pos: int):
        """One bounded prefill pass: `padded` right-padded tokens attend
        over `ctx_len` tokens resident in `ctx_pages` (none: a prefill
        from scratch through `flash_prefill`) plus themselves under the
        offset causal mask (`prefix_prefill`, straight from the pools).
        `last_pos` is the last real query position; `logits[0, 0]` is its
        row. Returns (logits, cache)."""
        toks = torch.as_tensor(padded, device=self.device)
        kw = dict(attn_blocks=self.attn_blocks, return_cache=True,
                  max_len=None, last_pos=last_pos)
        if not ctx_len:
            logits, cache, _ = self.model.forward(self.params, toks, **kw)
            return logits, cache
        self.fused_dispatches += 1
        npb = self._bucket_pages(len(ctx_pages))
        table = self._padded_page_ids(ctx_pages, npb)[None]
        pools = {k: self._cache[k] for k in _seg_names(self._cache)}
        logits, cache, _ = self.model.forward(
            self.params, toks, prefix_pages=pools, prefix_table=table,
            prefix_len=ctx_len, pos_offset=ctx_len, **kw)
        return logits, cache

    def prefill_request(self, seq: Sequence) -> Tuple[int, Any, float]:
        """Run prefill; returns (first_token, kv_blob, step_time).

        With the prefix cache on, only the uncached suffix is computed:
        it attends over the longest page-aligned cached prefix straight
        from the pools (capped so at least one suffix token remains)."""
        toks = np.asarray(seq.tokens, np.int32)
        S = len(toks)
        assert S < self.max_len, (S, self.max_len)
        if self.prefix_caching:
            return self._prefill_with_prefix(seq, toks)
        bucket = S if self.exact_len else self._bucket(S)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :S] = toks                                  # right-pad
        t0 = time.perf_counter()
        if self.paged:
            logits, cache = self._forward_chunk(padded, [], 0, S - 1)
        else:
            # the cache comes at the slab's lengths (the insert is a slot
            # write); exact-length families take the last position's
            # logits, the others the last real one's
            kw = {} if self.exact_len else {"last_pos": S - 1}
            logits, cache, _ = self.model.forward(
                self.params, torch.as_tensor(padded, device=self.device),
                attn_blocks=self.attn_blocks, return_cache=True,
                max_len=self.max_len, **kw)
        self._sync()
        dt = time.perf_counter() - t0
        self.clock += dt
        self.steps += 1
        self.prefill_tokens += S
        first = self._sample_token(seq, logits[0, 0])
        return first, (cache, S), dt

    def _prefill_with_prefix(self, seq: Sequence, toks
                             ) -> Tuple[int, Any, float]:
        ps = self._kv.page_size
        S = len(toks)
        token_list = [int(t) for t in toks]
        hit, hit_pages = self.prefix_cache.match(token_list)
        # keep >= 1 suffix token: the first output comes from its logits
        hit = min(hit, ((S - 1) // ps) * ps)
        hit_pages = hit_pages[:hit // ps]
        if hit_pages:
            self._kv.acquire(hit_pages)     # pin across compute + eviction
        suffix = toks[hit:]
        Ssuf = len(suffix)
        bucket = self._bucket(Ssuf)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :Ssuf] = suffix
        t0 = time.perf_counter()
        fused = bool(hit)
        logits, cache = self._forward_chunk(padded, hit_pages, hit, Ssuf - 1)
        first = self._sample_token(seq, logits[0, 0])

        # the migration blob carries only the suffix KV; the prefix stays
        # pinned in the page pool until the wire payload is materialized
        blob_cache = {name: {p: cache[name][p] for p in ("k", "v")}
                      for name in _seg_names(cache)}

        # write the fresh suffix pages back into the pools and publish the
        # new full prompt pages in the radix tree (on pool exhaustion the
        # request simply isn't retained; the blob above is still complete)
        total_pages = -(-S // ps)
        fresh_needed = total_pages - len(hit_pages)
        if fresh_needed > self._kv.free_pages:
            self.prefix_cache.evict(fresh_needed - self._kv.free_pages)
        if fresh_needed <= self._kv.free_pages:
            table = self._kv.alloc(seq.rid, S, shared=hit_pages)
            self._write_pages(blob_cache, table[len(hit_pages):])
            self.prefix_cache.insert(token_list[:(S // ps) * ps],
                                     table[:S // ps])
            self._kv.free(seq.rid)          # tree refs keep shared pages
        self._sync()
        dt = time.perf_counter() - t0
        self.clock += dt
        self.steps += 1
        self.prefill_tokens += Ssuf
        self.prefix_hit_tokens += hit
        seq.prefix_hit = hit
        if fused:
            # the blob keeps the pin: pages must survive tree eviction
            # until materialize_wire/release_blob
            return first, KVBlob(blob_cache, S, prefix_tokens=hit,
                                 prefix_pages=hit_pages, owner=self), dt
        return first, (blob_cache, S), dt

    # ---- chunked prefill (incremental state machine) --------------------
    def has_partial(self, seq: Sequence) -> bool:
        """True for a sequence mid-chunked-prefill on this engine."""
        return seq.rid in self._partial

    def can_start_chunked(self, seq: Sequence) -> bool:
        """Admission gate for starting a chunked prefill: the whole
        prompt's pages are reserved at chunk 0 (minus the cached prefix).
        Already-started sequences always resume."""
        if seq.rid in self._partial:
            return True
        S = len(seq.tokens)
        ps = self._kv.page_size
        hit = min(self.prefix_peek(seq.tokens), ((S - 1) // ps) * ps)
        need = -(-S // ps) - hit // ps
        if need > self._kv.free_pages and self.prefix_caching:
            self.prefix_cache.evict(need - self._kv.free_pages)
        return need <= self._kv.free_pages

    def prefill_chunk(self, seq: Sequence,
                      chunk_tokens: int) -> Tuple[bool, Optional[int],
                                                  Any, float, int]:
        """Run (at most) one more chunk of the sequence's prefill.

        Chunk k's queries attend over chunks 0..k-1's KV in pool pages
        through the `prefix_prefill` kernel, and the chunk's fresh KV is
        written straight into pool pages. Non-final chunks are rounded
        down to whole pages (>= 1 page); the final chunk takes the ragged
        tail. Returns ``(done, first_token, blob, dt, new_tokens)``;
        `first_token`/`blob` are None until the final chunk, whose blob is
        fully page-backed."""
        assert self.paged, "chunked prefill needs the paged runtime"
        toks = np.asarray(seq.tokens, np.int32)
        S = len(toks)
        assert S < self.max_len, (S, self.max_len)
        ps = self._kv.page_size
        t0 = time.perf_counter()
        st = self._partial.get(seq.rid)
        if st is None:
            token_list = [int(t) for t in toks]
            hit, hit_pages = (self.prefix_cache.match(token_list)
                              if self.prefix_caching else (0, []))
            # keep >= 1 suffix token: the first output needs its logits
            hit = min(hit, ((S - 1) // ps) * ps)
            hit_pages = hit_pages[:hit // ps]
            if hit_pages:
                self._kv.acquire(hit_pages)  # pin across eviction
            need = -(-S // ps) - len(hit_pages)
            if need > self._kv.free_pages and self.prefix_caching:
                self.prefix_cache.evict(need - self._kv.free_pages)
            table = self._kv.alloc(seq.rid, S, shared=hit_pages)
            if hit_pages:
                self._kv.release(hit_pages)  # table refs hold them now
            st = PartialPrefill(list(table), hit, hit)
            self._partial[seq.rid] = st
        ctx = st.done
        c = min(chunk_tokens, S - ctx)
        if ctx + c < S:
            # non-final chunks end on a page boundary
            c = min(max((c // ps) * ps, ps), S - ctx)
        final = ctx + c == S
        padded = np.zeros((1, self._bucket(c)), np.int32)
        padded[0, :c] = toks[ctx:ctx + c]
        logits, cache = self._forward_chunk(padded, st.table[:ctx // ps],
                                            ctx, c - 1)
        first = self._sample_token(seq, logits[0, 0]) if final else None
        # in-place paged write of the chunk's fresh KV
        first_page = ctx // ps
        n_chunk_pages = -(-(ctx + c) // ps) - first_page
        self._write_pages({k: cache[k] for k in _seg_names(cache)},
                          st.table[first_page:first_page + n_chunk_pages])
        self._sync()
        dt = time.perf_counter() - t0
        self.clock += dt
        self.steps += 1
        self.prefill_tokens += c
        self.chunk_dispatches += 1
        st.done = ctx + c
        st.chunks += 1
        seq.prefilled = st.done
        if not final:
            return False, None, None, dt, c
        # close out: the blob is the page set itself -- pin every page,
        # publish the full-page prefix in the radix tree, drop the table
        self._kv.acquire(st.table)
        if self.prefix_caching:
            self.prefix_cache.insert([int(t) for t in toks[:(S // ps) * ps]],
                                     st.table[:S // ps])
        self._kv.free(seq.rid)              # blob pins + tree refs remain
        blob = KVBlob({}, S, prefix_tokens=S,
                      prefix_pages=list(st.table), owner=self)
        del self._partial[seq.rid]
        self.prefix_hit_tokens += st.hit
        seq.prefix_hit = st.hit
        return True, first, blob, dt, c

    def abort_partial(self, seq: Sequence):
        """Cancel a mid-chunk prefill without leaking: drop the resumable
        state and release the whole reserved residency."""
        st = self._partial.pop(seq.rid, None)
        if st is not None:
            self._kv.free(seq.rid)
            seq.prefilled = 0

    def materialize_wire(self, blob, skip_tokens: int = 0):
        """Stitch the wire payload actually shipped to the decode side.

        For a page-backed `KVBlob`, gathers only the prefix pages beyond
        `skip_tokens` (positions the decode side already holds) and
        concatenates the suffix KV. Drops the blob's page pins. For
        legacy tuple blobs, slices the dense cache at `skip_tokens`.
        Returns the (cache, n_tok) tuple `insert_kv` consumes."""
        if not isinstance(blob, KVBlob):
            cache, n_tok = blob
            if skip_tokens:
                cache = {k: ({p: v[p][:, :, skip_tokens:] for p in ("k", "v")}
                             if k.startswith("seg") else v)
                         for k, v in cache.items()}
            return cache, n_tok
        ps = self._kv.page_size
        hit = blob.prefix_tokens
        Ssuf = blob.n_tok - hit
        out = {}
        if skip_tokens < hit:
            assert skip_tokens % ps == 0
            ship_pages = blob.prefix_pages[skip_tokens // ps:]
            npb = self._bucket_pages(len(ship_pages))
            pk = self._gather(self._padded_page_ids(ship_pages, npb))
            # the paged span may end ragged (chunked blobs carry the whole
            # prompt in pages, incl. an un-page-aligned tail)
            span = hit - skip_tokens
            for name in pk:
                pieces = {p: [pk[name][p][:, :, :span]] for p in ("k", "v")}
                if name in blob.cache:      # fused path: fresh suffix KV
                    for p in ("k", "v"):
                        pieces[p].append(blob.cache[name][p][:, :, :Ssuf])
                out[name] = {p: (pieces[p][0] if len(pieces[p]) == 1 else
                                 torch.cat(pieces[p], dim=2))
                             for p in ("k", "v")}
        else:
            cut = skip_tokens - hit
            for name, seg in blob.cache.items():
                out[name] = {p: seg[p][:, :, cut:Ssuf] for p in ("k", "v")}
        release_blob(blob)
        return out, blob.n_tok

    def kv_blob_bytes(self, kv_blob) -> int:
        cache, _ = kv_blob
        return _tree_bytes(cache)

    # ---- insert: block-table splice (paged) or slot write (slab) --------
    def insert_kv(self, seq: Sequence, kv_blob, shared: List[int] = (),
                  skip_tokens: int = 0) -> int:
        """Install a transferred prefill cache.

        Paged: allocate the block table for the sequence's residency --
        `shared` pages (pinned via `pin_prefix`) head the table, covering
        the first `skip_tokens` positions -- and write the blob (the KV
        beyond `skip_tokens`) into the fresh pages, touching O(suffix
        pages) of device memory. Slab: write the blob into a free slot."""
        cache, n_tok = kv_blob
        if not self.paged:
            assert not shared and not skip_tokens
            return self._insert_kv_slab(seq, cache, n_tok)
        ps = self._kv.page_size
        assert skip_tokens % ps == 0 and skip_tokens // ps == len(shared)
        need = self._kv.pages_for(max(self.tokens_needed(seq), n_tok))
        if need - len(shared) > self._kv.free_pages and self.prefix_caching:
            self.prefix_cache.evict(need - len(shared) - self._kv.free_pages)
        slot = self._slot_free.pop(0)
        seq.slot = slot
        # same residency formula the admission check approved
        page_ids = self._kv.alloc(seq.rid, max(self.tokens_needed(seq), n_tok),
                                  shared=shared)
        n_prompt = min(-(-n_tok // ps), len(page_ids))
        if n_prompt - len(shared) > 0:
            self._write_pages({k: cache[k] for k in _seg_names(cache)},
                              page_ids[len(shared):n_prompt])
        self._cache["block_tables"][slot] = torch.as_tensor(
            self._kv.padded_table(seq.rid), dtype=torch.int32,
            device=self.device)
        self._cache["pos"][slot] = n_tok
        if self.prefix_caching:
            # publish the full prompt pages for future shared-prefix hits
            n_full = n_tok // ps
            self.prefix_cache.insert(seq.tokens[:n_full * ps],
                                     page_ids[:n_full])
            seq.decode_hit = skip_tokens
        return slot

    def _insert_kv_slab(self, seq: Sequence, cache, n_tok: int) -> int:
        """Write a batch-1 prefill cache into a free slot, in place: every
        leaf but `pos` has its batch on axis 1, after the layer axis (the
        JAX engine finds the same axis from the shapes). A leaf whose
        other axes are shorter than the slab's (a KV cache shorter than
        `max_len`) fills their leading positions, as the JAX `merge`."""
        slot = self._slot_free.pop(0)
        seq.slot = slot

        def write(dst, src):
            for k, d in dst.items():
                if isinstance(d, dict):
                    write(d, src[k])
                elif k != "pos":
                    s = src[k][:, 0]
                    lead = tuple(slice(0, n) for n in s.shape[1:])
                    d[(slice(None), slot) + lead] = s.to(d.dtype)
        write(self._cache, cache)
        self._cache["pos"][slot] = n_tok
        return slot

    def release(self, seq: Sequence):
        if seq.slot >= 0:
            if self.paged:
                self._kv.free(seq.rid)
                # repoint the slot at the trash page; later writes are inert
                self._cache["block_tables"][seq.slot] = TRASH_PAGE
                self._cache["pos"][seq.slot] = 0
            self._slot_free.append(seq.slot)
            seq.slot = -1

    def cancel(self, seq: Sequence, pinned: List[int] = ()):
        """Abort a sequence at any lifecycle stage without leaking: drop
        any prefix pins taken on its behalf and free its pages/slot if it
        was resident. Safe for sequences that never reached this engine."""
        if pinned:
            self.unpin(list(pinned))
        self.abort_partial(seq)
        self.release(seq)

    def _sample_token(self, seq: Sequence, logits_row) -> int:
        """Greedy argmax (default; the first maximum, as jnp.argmax) or
        temperature softmax sampling with the sequence's rng."""
        sp = seq.sampling
        if sp is None or sp.temperature <= 0.0:
            return int(torch.argmax(logits_row))
        x = logits_row.double().cpu().numpy() / sp.temperature
        x -= x.max()
        p = np.exp(x)
        p /= p.sum()
        return int(seq.rng().choice(p.shape[0], p=p))

    def decode_step(self, seqs: List[Sequence]) -> float:
        """One decode iteration for all active sequences."""
        if not seqs:
            return 0.0
        tokens = np.zeros((self.max_batch,), np.int32)
        for s in seqs:
            tokens[s.slot] = s.tokens[-1]
        t0 = time.perf_counter()
        step = self.model.decode_step_paged if self.paged \
            else self.model.decode_step
        logits, self._cache = step(self.params, self._cache,
                                   torch.as_tensor(tokens, device=self.device))
        self._sync()
        dt = time.perf_counter() - t0
        self.clock += dt
        self.steps += 1
        self.decode_tokens += len(seqs)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        sampled = any(s.sampling is not None and s.sampling.temperature > 0
                      for s in seqs)
        for s in seqs:
            if sampled and s.sampling is not None \
                    and s.sampling.temperature > 0:
                tok = self._sample_token(s, logits[s.slot])
            else:
                tok = int(nxt[s.slot])
            s.append_token(tok)
        return dt
