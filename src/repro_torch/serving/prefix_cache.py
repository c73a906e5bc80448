# Copied unchanged from src/repro/serving/prefix_cache.py.
"""Shared-prefix KV reuse: a radix tree over token ids at page granularity.

Why a radix tree (sglang's RadixAttention, production-stack's prefix-aware
router): DistServe's goodput is bounded by prefill compute and by
prefill->decode transfer bytes, and both shrink in proportion to the
longest cached prefix when requests share prompt prefixes (system prompts,
multi-turn chat, few-shot templates).

Structure
---------
Each edge holds a run of tokens whose length is a whole number of pages
(``page_size`` tokens per page) plus the physical page ids backing that
run, so a node's path from the root spells out a page-aligned token prefix
and the pages that hold its KV. Children are keyed by their edge's first
*page* (a tuple of ``page_size`` tokens): matching and insertion compare
page-sized chunks, and edges split only at page boundaries. Only *full*
pages ever enter the tree — a partially filled tail page stays private to
its sequence (no reader may share a page whose later slots are still being
written; see `KVCacheManager.cow` for the copy-on-write escape hatch).

Ownership
---------
The tree owns one reference on every page it adopts (via the
``allocator`` — `serving.kv_cache.KVCacheManager` in the live engine).
Sequences using a matched prefix hold their own references through their
block tables, so a page's refcount is ``1 (tree) + #sequences``. Eviction
walks leaves in LRU order and drops only subtrees whose pages have no
references beyond the tree's own (refcount-0 from the outside), returning
the pages to the free list.

With ``allocator=None`` the tree manufactures synthetic page ids and skips
refcounting — this is the mode the discrete-event simulator runs in, so
the simulator and the live cluster share one matching/insertion
implementation and therefore report identical prefix-hit lengths and
routing decisions on the same trace.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0            # match() calls (routing peeks not counted)
    hits: int = 0               # match() calls with hit_tokens > 0
    lookup_tokens: int = 0      # tokens presented to match()
    hit_tokens: int = 0         # tokens served from the tree
    matched_pages: int = 0      # pages returned by match() (shared reuse)
    inserted_pages: int = 0     # pages adopted by the tree
    evicted_pages: int = 0      # pages released back by eviction

    @property
    def hit_rate(self) -> float:
        """Token-weighted hit rate over all lookups."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = round(self.hit_rate, 4)
        return d


class _Node:
    __slots__ = ("key", "pages", "children", "parent", "last_access")

    def __init__(self, key: Tuple[int, ...], pages: List[int],
                 parent: Optional["_Node"]):
        self.key = key          # tokens along the incoming edge (page multiple)
        self.pages = pages      # physical pages backing `key`
        self.children: Dict[Tuple[int, ...], _Node] = {}  # first page -> node
        self.parent = parent
        self.last_access = 0


class RadixPrefixCache:
    """Radix tree of page-aligned token prefixes over refcounted pages."""

    def __init__(self, page_size: int, allocator=None):
        assert page_size >= 1
        self.page_size = page_size
        self.allocator = allocator        # needs acquire/release/ref
        self.root = _Node((), [], None)
        self.stats = PrefixCacheStats()
        self._tick = itertools.count(1)
        self._synthetic = itertools.count(1)   # page ids when allocator=None

    # ---- lookup -------------------------------------------------------
    def _walk(self, tokens) -> Tuple[int, List[int], "_Node", int]:
        """Longest page-aligned match.

        Returns (hit_tokens, pages, node, within): `node` is the deepest
        node touched and `within` the number of tokens matched inside its
        edge (== len(node.key) when the whole edge matched)."""
        ps = self.page_size
        node = self.root
        pages: List[int] = []
        pos = 0
        while True:
            head = tuple(tokens[pos: pos + ps])
            nxt = node.children.get(head) if len(head) == ps else None
            if nxt is None:
                return pos, pages, node, len(node.key)
            k = 1   # `head` matched page 0 of the edge by construction
            while (k < len(nxt.pages)
                   and tuple(tokens[pos + k * ps: pos + (k + 1) * ps])
                   == nxt.key[k * ps: (k + 1) * ps]):
                k += 1
            pages.extend(nxt.pages[:k])
            pos += k * ps
            if k < len(nxt.pages):      # diverged mid-edge
                return pos, pages, nxt, k * ps
            node = nxt

    def peek(self, tokens) -> int:
        """Hit length for routing probes: no LRU bump, no stats."""
        hit, _, _, _ = self._walk(tokens)
        return hit

    def _bump(self, node: "_Node"):
        t = next(self._tick)
        while node is not None:
            node.last_access = t
            node = node.parent

    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of `tokens` -> (hit, pages).

        Bumps LRU recency along the matched path and records stats. The
        caller must acquire references on the returned pages before using
        them — they are only guaranteed alive until the next eviction."""
        hit, pages, node, _ = self._walk(tokens)
        self._bump(node)
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        self.stats.hit_tokens += hit
        self.stats.matched_pages += len(pages)
        if hit:
            self.stats.hits += 1
        return hit, pages

    # ---- insertion ----------------------------------------------------
    def insert(self, tokens, pages: Optional[List[int]] = None) -> int:
        """Adopt the full-page prefix of `tokens` backed by `pages`.

        `tokens` is truncated to whole pages; `pages` must cover them
        (page ids from the sequence's block table, in order). Regions
        already in the tree keep the tree's existing pages — a duplicate
        physical page stays private to the inserting sequence and dies
        with it. Newly adopted pages get one tree reference via
        ``allocator.acquire``. Returns the number of pages adopted."""
        ps = self.page_size
        n_full = len(tokens) // ps
        tokens = tuple(tokens[: n_full * ps])
        if pages is None:
            assert self.allocator is None, "live tree needs real page ids"
            pages = [next(self._synthetic) for _ in range(n_full)]
        assert len(pages) >= n_full, (len(pages), n_full)
        hit, _, node, within = self._walk(tokens)
        self._bump(node)
        if hit == len(tokens):
            return 0
        if within < len(node.key):      # stopped mid-edge: split at boundary
            node = self._split(node, within)
        new_toks = tokens[hit:]
        new_pages = list(pages[hit // ps: n_full])
        child = _Node(new_toks, new_pages, node)
        child.last_access = node.last_access
        node.children[new_toks[:ps]] = child
        if self.allocator is not None:
            self.allocator.acquire(new_pages)
        self.stats.inserted_pages += len(new_pages)
        return len(new_pages)

    def _split(self, node: _Node, keep_tokens: int) -> _Node:
        """Split `node`'s edge after `keep_tokens` (a page multiple);
        returns the new upper node."""
        ps = self.page_size
        kp = keep_tokens // ps
        assert 0 < kp < len(node.pages)
        upper = _Node(node.key[:keep_tokens], node.pages[:kp], node.parent)
        upper.last_access = node.last_access
        node.parent.children[upper.key[:ps]] = upper
        node.key = node.key[keep_tokens:]
        node.pages = node.pages[kp:]
        node.parent = upper
        upper.children[node.key[:ps]] = node
        return upper

    # ---- eviction -----------------------------------------------------
    def _evictable_leaves(self) -> List[_Node]:
        out = []

        def rec(n):
            for c in n.children.values():
                rec(c)
            if n is not self.root and not n.children:
                if self.allocator is None or all(
                        self.allocator.ref(p) <= 1 for p in n.pages):
                    out.append(n)
        rec(self.root)
        return sorted(out, key=lambda n: n.last_access)

    def evict(self, n_pages: int) -> List[int]:
        """Drop LRU leaf subtrees with no outside references until at
        least `n_pages` pages are released (or nothing evictable remains).
        Evicting a leaf can expose its parent; the loop re-collects until
        the target is met. Returns the released page ids."""
        freed: List[int] = []
        while len(freed) < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            for leaf in leaves:
                leaf.parent.children.pop(leaf.key[: self.page_size])
                if self.allocator is not None:
                    self.allocator.release(leaf.pages)
                freed.extend(leaf.pages)
                self.stats.evicted_pages += len(leaf.pages)
                if len(freed) >= n_pages:
                    break
        return freed

    # ---- introspection ------------------------------------------------
    def pages_in_tree(self) -> List[int]:
        out: List[int] = []

        def rec(n):
            out.extend(n.pages)
            for c in n.children.values():
                rec(c)
        rec(self.root)
        return out

    def num_pages(self) -> int:
        return len(self.pages_in_tree())

    def metrics(self) -> Dict[str, float]:
        """Pull-collector snapshot for a `MetricsRegistry`: cumulative
        hit/insert/evict counters plus the live tree footprint."""
        out = {k: float(v) for k, v in self.stats.as_dict().items()}
        out["pages_in_tree"] = float(self.num_pages())
        return out
