# Copied unchanged from src/repro/serving/kv_cache.py.
"""Block-granular, refcount-sharing KV-cache manager for the live engine
(vLLM-style paging + sglang-style prefix sharing, TetriInfer-style
disaggregated admission).

Page layout
-----------
The device cache owned by `Engine` holds, per attention segment, two pools
shaped ``(layers, num_pages, page_size, num_kv_heads, head_dim)``. A
*page* is ``page_size`` consecutive token positions of one sequence,
replicated across every layer: block tables are per-sequence, not
per-layer, so physical page ``p`` stores the same logical positions in all
layers' pools. Page 0 is reserved as a trash page — freed/idle batch slots
point every block-table entry at it, so their (masked, never attended)
decode writes land harmlessly.

Refcounted sharing
------------------
Every live page carries a reference count. A sequence's `alloc` may name
``shared`` pages (from a `serving.prefix_cache.RadixPrefixCache` match):
those get their refcount bumped instead of being taken off the free list,
so one physical page can appear in many block tables. `free`/`release`
only return a page to the free list when its refcount reaches zero — a
page is never reclaimed while any block table (or the prefix tree) still
references it. Writing into a shared page is forbidden; `cow` is the
copy-on-write escape hatch that gives a sequence a private replacement
page id (the caller copies the device bytes).

Admission semantics
-------------------
Admission reserves ``ceil(tokens / page_size)`` pages up front for the
sequence's full lifetime (prompt + all decode positions, clamped to the
engine's ``max_len``), minus any shared prefix pages — exactly the
pull-based admission signal the paper's burstiness argument assumes: a
decode instance admits a parked prefill iff `can_admit` says the whole
residency fits. Inserting a transferred prefill is a *splice*: the dense
(layers, 1, S, Hkv, hd) blob is chunked into pages and scattered into the
pools at the freshly allocated page ids — O(pages written), never a
full-cache rewrite — and the device block-table row for the sequence's
batch slot is overwritten with shared + fresh ids.

Follow-on work (see ROADMAP): preemption (page stealing with
re-prefill). Per-layer streaming admission landed with the fused
prefix-prefill PR (core/kv_transfer.pull_layered).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

TRASH_PAGE = 0


class KVCacheManager:
    """Free list + refcounts + per-sequence block tables over a fixed pool.

    The same counters the scheduler admits against (`free_pages`,
    `used_pages`, `peak_used_pages`) are maintained here; the simulator's
    decode instances use the byte-denominated `core.scheduler.PagePool`
    twin for the same accounting.
    """

    def __init__(self, num_pages: int, page_size: int, max_len: int):
        assert num_pages >= 2, "need at least the trash page + one real page"
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_len = max_len
        self.max_pages_per_seq = -(-max_len // page_size)
        # page 0 is the reserved trash page, never handed out
        self._free: List[int] = list(range(1, num_pages))
        self._refcnt: Dict[int, int] = {}        # page id -> count (> 0)
        self._tables: Dict[int, List[int]] = {}
        self.peak_used = 0
        self._reserved = 0                       # streaming-admission holds

    # ---- capacity ----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free) - self._reserved

    # ---- reservations -------------------------------------------------
    def reserve(self, n_pages: int):
        """Hold `n_pages` off the admission signal without naming page ids
        (streamed chunked-prefill admission: decode grants a still-
        prefilling request its residency so the wire can start early; the
        actual `alloc` happens at insert time, after `unreserve`)."""
        assert 0 <= n_pages <= self.free_pages, (n_pages, self.free_pages)
        self._reserved += n_pages

    def unreserve(self, n_pages: int):
        assert 0 <= n_pages <= self._reserved, (n_pages, self._reserved)
        self._reserved -= n_pages

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    @property
    def peak_used_pages(self) -> int:
        return self.peak_used

    def stats(self) -> Dict[str, float]:
        """Pull-collector snapshot for a `MetricsRegistry`: occupancy,
        reservations, and sharing (refcount > 1 means a page appears in
        several block tables / the prefix tree)."""
        shared = sum(1 for c in self._refcnt.values() if c > 1)
        return {"kv.num_pages": self.num_pages,
                "kv.used_pages": self.used_pages,
                "kv.free_pages": self.free_pages,
                "kv.peak_used_pages": self.peak_used,
                "kv.reserved_pages": self._reserved,
                "kv.shared_pages": shared,
                "kv.tables": len(self._tables)}

    def pages_for(self, n_tokens: int) -> int:
        """Whole pages covering `n_tokens` positions (clamped to max_len)."""
        n = min(max(n_tokens, 1), self.max_len)
        return max(-(-n // self.page_size), 1)

    def can_admit(self, n_tokens: int, n_shared: int = 0) -> bool:
        """True iff the residency fits: only the non-shared tail needs
        fresh pages."""
        return self.pages_for(n_tokens) - n_shared <= self.free_pages

    # ---- refcounts ----------------------------------------------------
    def ref(self, page: int) -> int:
        return self._refcnt.get(page, 0)

    def acquire(self, pages: Iterable[int]):
        """Take one reference on each (already-live) page."""
        for p in pages:
            assert self._refcnt.get(p, 0) > 0, f"acquire of dead page {p}"
            self._refcnt[p] += 1

    def release(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free list (never earlier). Returns the number of pages freed."""
        freed = 0
        for p in pages:
            c = self._refcnt[p] - 1
            if c == 0:
                del self._refcnt[p]
                self._free.append(p)
                freed += 1
            else:
                self._refcnt[p] = c
        return freed

    # ---- allocation ---------------------------------------------------
    def alloc(self, rid: int, n_tokens: int,
              shared: Sequence[int] = ()) -> List[int]:
        """Reserve the block table for a sequence's full residency.

        `shared` pages (a prefix-cache match, in prefix order) are
        acquired — refcount bumped, not taken from the free list; only the
        remainder comes off the free list with refcount 1."""
        assert rid not in self._tables, rid
        need = self.pages_for(n_tokens)
        assert len(shared) <= need, (rid, len(shared), need)
        fresh_n = need - len(shared)
        assert fresh_n <= self.free_pages, (rid, fresh_n, self.free_pages)
        self.acquire(shared)
        fresh = self._free[:fresh_n]
        del self._free[:fresh_n]
        for p in fresh:
            self._refcnt[p] = 1
        self._tables[rid] = list(shared) + fresh
        self.peak_used = max(self.peak_used, self.used_pages)
        return self._tables[rid]

    def block_table(self, rid: int) -> List[int]:
        return self._tables[rid]

    def free(self, rid: int) -> int:
        """Release one reference on each of a sequence's pages; only pages
        nobody else references return to the pool."""
        return self.release(self._tables.pop(rid))

    def cow(self, rid: int, idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give `rid` a private replacement for block-table
        entry `idx` if that page is shared. Returns (old, new) page ids —
        the caller must copy the device bytes old -> new — or None when
        the page was already private (write in place)."""
        table = self._tables[rid]
        old = table[idx]
        if self._refcnt[old] <= 1:
            return None
        assert self.free_pages >= 1, "cow needs a free page"
        new = self._free.pop(0)
        self._refcnt[new] = 1
        table[idx] = new
        self.release([old])
        self.peak_used = max(self.peak_used, self.used_pages)
        return old, new

    def padded_table(self, rid: int) -> List[int]:
        """Block table padded with the trash page to max_pages_per_seq."""
        t = self._tables[rid]
        return t + [TRASH_PAGE] * (self.max_pages_per_seq - len(t))
