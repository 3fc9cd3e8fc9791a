"""Host-side paged-KV bookkeeping: page pool allocator + radix prefix cache.

The serving engine's dense layout reserves ``max_len`` cache rows per slot
the moment a request is admitted, so short requests strand HBM and the
slot count — not FLOPs — caps concurrency.  PagedAttention (vLLM) and
RadixAttention (SGLang) showed that block-granular KV lifts batch size
2-4x at equal HBM.  This module owns the HOST side of that design:

- :class:`PagePool` — a free-list allocator with per-page refcounts over
  the device page pool (``[num_pages, page_size, heads, head_dim]`` per
  layer).  Page 0 is reserved as the NULL page: page-table rows of
  inactive slots point at it, so the tick program's unconditional writes
  for empty batch rows land in scratch instead of another request's KV.
- :class:`PrefixCache` — a radix tree over page-granular token blocks.
  A finished (or still-prefilling) request registers its FULL prompt
  pages keyed by their token content; a later request whose prompt
  shares that prefix maps the same physical pages (refcount++) and skips
  re-prefilling them.  Shared pages are never written again: sharing is
  restricted to full pages strictly before a request's first write
  position, and the hit is capped at ``len(prompt) - 1`` tokens (the
  engine must re-prefill at least the last prompt token to produce
  logits), rounded DOWN to a page boundary — the dropped tail page is
  re-computed into a private page, which is the copy-on-write fork:
  "copy" by recompute, no device memcpy machinery.

Everything here is plain numpy/python under the engine lock; the device
side (pools, page tables, the gather/scatter attention) lives in
``models/gpt.py`` + ``incubate/nn/kernels/paged_attention.py``.
"""

from __future__ import annotations

import heapq
import zlib
from typing import List, Optional

import numpy as np

NULL_PAGE = 0


def pages_for(need: int, reserve: int, page_size: int) -> int:
    """Worst-case page footprint of a request needing ``need`` committed
    cache rows with a ``reserve``-token write window.

    The widest in-flight write starts at the last committed length
    (``need - 1``) and spans ``reserve`` tokens, so rows up to
    ``need + reserve - 2`` can be touched — and a window narrower than a
    page can still STRADDLE a page boundary, so the reservation must be
    computed on the final row index, not by summing token counts
    (reserving ``max(chunk, spec_k+1)`` tokens undercounts by one page
    exactly when the window straddles)."""
    last_row = need + reserve - 2
    return last_row // page_size + 1


def page_digests(prompt, page_size: int) -> List[int]:
    """Running crc32 digest per page-aligned prefix of ``prompt``: entry
    ``k-1`` covers tokens ``[0, k*page_size)``, capped at
    ``(len(prompt) - 1) // page_size`` full pages (the same cap
    :meth:`PrefixCache.match` applies — the engine must re-prefill at
    least the last prompt token).

    Bytes-identical to the chain digests :meth:`PrefixCache.digests`
    publishes through the ``/load`` report's ``prefix_digest`` block
    (each radix node's digest is the crc32 of the concatenated int32
    page-key bytes from the root), so set membership answers "does this
    replica already hold my prompt's first k pages" without shipping
    token content — the fleet router's cache-affinity signal
    (``inference/fleet.py``)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    P = int(page_size)
    limit = max(0, (len(prompt) - 1) // P)
    out, crc = [], 0
    for k in range(limit):
        crc = zlib.crc32(prompt[k * P:(k + 1) * P].tobytes(), crc)
        out.append(crc)
    return out


def tokens_admittable(free_pages: int, reserve: int, page_size: int) -> int:
    """Largest committed-row need (``prompt + max_new``) a SINGLE fresh
    request could reserve from ``free_pages`` — the exact inverse of
    :func:`pages_for`, published as the ``/load`` report's paged
    admission headroom so a router can answer "would THIS request fit
    here right now" without replaying the allocator.  0 when even a
    1-token request would not fit (the write window alone exceeds the
    free pool)."""
    return max(0, int(free_pages) * int(page_size) - int(reserve) + 1)


class PagePool:
    """Free-list page allocator with refcounts.

    ``num_pages`` counts the DEVICE pool's leading dim; page 0 is the
    reserved null/scratch page, so ``usable = num_pages - 1``."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._ref = np.zeros(self.num_pages, np.int32)
        # LIFO free list: recently-freed pages are re-used first (their
        # rows are hottest in cache-of-caches senses and it keeps the
        # pool's touched footprint small under light load)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self.usable - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None (caller may evict+retry)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages) -> None:
        for p in np.atleast_1d(pages):
            if self._ref[p] <= 0:
                raise ValueError(f"incref of unallocated page {int(p)}")
            self._ref[p] += 1

    def decref(self, pages) -> None:
        for p in np.atleast_1d(pages):
            p = int(p)
            if p == NULL_PAGE or self._ref[p] <= 0:
                raise ValueError(f"decref of unallocated page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def allocated_ids(self) -> List[int]:
        """Ascending ids of every allocated page (refcount > 0, null page
        excluded) — the compaction planner's input."""
        return [int(p) for p in np.nonzero(self._ref[1:])[0] + 1]

    def highest_allocated(self) -> int:
        """Highest allocated page id, or 0 when the pool is empty — the
        fragmentation signal: ``highest_allocated() + 1`` much larger
        than ``allocated`` means live pages are scattered across a
        mostly-free pool and a compaction would shrink the touched
        footprint."""
        ids = np.nonzero(self._ref[1:])[0]
        return int(ids[-1] + 1) if len(ids) else 0

    def compaction_plan(self) -> List[tuple]:
        """``[(src, dst), ...]`` moves that pack every allocated page
        into the lowest ids ``1..allocated`` (null page stays put).
        Sources and destinations are provably disjoint: dsts are the
        FREE ids among ``1..allocated`` and srcs are the allocated ids
        above ``allocated``, so applying the moves in any order is safe
        and the device copy can be one batched gather/scatter.  Empty
        when the pool is already packed."""
        ids = self.allocated_ids()
        n = len(ids)
        dsts = [p for p in range(1, n + 1) if self._ref[p] == 0]
        srcs = [p for p in ids if p > n]
        assert len(srcs) == len(dsts)
        return list(zip(srcs, dsts))

    def apply_moves(self, moves) -> List[tuple]:
        """Commit a :meth:`compaction_plan` to the host bookkeeping:
        refcounts move ``src -> dst`` and the free list is rebuilt.
        Each pair is re-validated (``src`` still allocated, ``dst``
        still free) so a page freed between planning and commit — e.g. a
        concurrent :meth:`PrefixCache.drop` from another thread — is
        skipped rather than corrupting the pool; the device copy wrote
        garbage into a free page, which is harmless.  Returns the pairs
        actually applied (the caller remaps its page tables from
        these)."""
        applied = []
        for src, dst in moves:
            src, dst = int(src), int(dst)
            if self._ref[src] <= 0 or self._ref[dst] != 0:
                continue
            self._ref[dst] = self._ref[src]
            self._ref[src] = 0
            applied.append((src, dst))
        # LIFO order with the lowest ids last keeps the packed tail of
        # the pool as the first pages handed out next
        self._free = [p for p in range(self.num_pages - 1, 0, -1)
                      if self._ref[p] == 0]
        return applied

    def cow(self, page: int):
        """Copy-on-write fork of ``page``: exclusively-owned pages are
        returned as-is; shared pages trade this caller's reference for a
        fresh private page.  Returns ``(page_id, forked)`` — ``forked``
        means the caller must (re)produce the page's contents — or
        ``None`` when the pool is exhausted (the original reference is
        kept).

        The serving engine's prefix path does NOT call this today: its
        fork is the match round-down + recompute (module docstring), so
        a slot's write window only ever maps exclusive pages (the tick
        tripwire asserts it).  ``cow`` is the allocator-level primitive
        for forking an in-place tail — what multi-turn suffix caching
        (ROADMAP item 1 follow-up) needs when a finished request's LAST
        page is shared and the next turn must extend it."""
        if self._ref[page] <= 0:
            raise ValueError(f"cow of unallocated page {int(page)}")
        if self._ref[page] == 1:
            return int(page), False
        fresh = self.alloc(1)
        if fresh is None:
            return None
        self.decref(page)
        return fresh[0], True


class _Node:
    __slots__ = ("key", "page", "parent", "children", "stamp", "digest")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = int(page)
        self.parent = parent
        self.children = {}
        self.stamp = 0
        # chain digest root->node: crc32 over the concatenated page-key
        # bytes, computed incrementally (crc32's running-start form) —
        # equals page_digests(prompt, P)[depth-1] for the prompt whose
        # pages this chain holds
        self.digest = zlib.crc32(key, parent.digest if parent else 0)


class PrefixCache:
    """Radix tree over page-granular prompt blocks -> physical page ids.

    The cache holds its OWN reference on every registered page, so a
    cached page outlives the request that wrote it; :meth:`evict` drops
    least-recently-matched leaves whose page nobody else references (so
    eviction can never free a page an active slot still maps)."""

    def __init__(self, pool: PagePool):
        self._pool = pool
        self._root: dict = {}          # key -> _Node (top level)
        self._nodes: List[_Node] = []  # all nodes, for LRU scans
        self._clock = 0
        self.hits = 0                  # pages matched (for tests)

    def __len__(self):
        return len(self._nodes)

    @property
    def pages(self):
        return [n.page for n in self._nodes]

    def cached_only(self) -> int:
        """Pages :meth:`evict` could free RIGHT NOW: nodes whose entire
        subtree nobody else references (eviction frees leaf-up, so a
        refcount-1 node pinned under a live descendant does not count —
        that shape arises when two slots prefill overlapping prompts
        concurrently and the longer one's insert hangs its novel tail
        page under the other's already-registered prefix nodes)."""
        def walk(children):
            total, clean = 0, True
            for nd in children.values():
                sub_total, sub_clean = walk(nd.children)
                nd_clean = (sub_clean
                            and self._pool.refcount(nd.page) == 1)
                total += sub_total + (1 if nd_clean else 0)
                clean = clean and nd_clean
            return total, clean
        return walk(self._root)[0]

    @staticmethod
    def _key(prompt, k, P):
        return np.asarray(prompt[k * P:(k + 1) * P], np.int32).tobytes()

    def match(self, prompt, allow_full: bool = False) -> List[int]:
        """Longest cached page-prefix of ``prompt``, capped at
        ``(len(prompt) - 1) // page_size`` full pages (the engine must
        re-prefill at least the last prompt token — see module
        docstring).  ``allow_full=True`` lifts that cap to
        ``len(prompt) // page_size``: a preempted stream re-admitting
        feeds its NEXT token from its last committed one, so every row
        of its replay source is consumable KV and a full-cover hit
        skips prefill entirely.  Matched pages are increffed for the
        caller; the caller owns releasing them (decref) when the slot
        frees."""
        P = self._pool.page_size
        limit = (len(prompt) // P if allow_full
                 else (len(prompt) - 1) // P)
        pages, children = [], self._root
        self._clock += 1
        for k in range(limit):
            node = children.get(self._key(prompt, k, P))
            if node is None:
                break
            node.stamp = self._clock
            pages.append(node.page)
            children = node.children
        if pages:
            self._pool.incref(pages)
            self.hits += len(pages)
        return pages

    def insert(self, prompt, page_row, n_full: int) -> None:
        """Register the first ``n_full`` FULL prompt pages of a slot
        (``page_row[k]`` holds the page with tokens ``[k*P, (k+1)*P)``).
        Pages already present keep the existing physical page (two slots
        that prefilled the same prompt concurrently both offer a page;
        the first wins, the loser's stays private to its slot)."""
        P = self._pool.page_size
        n_full = min(int(n_full), len(prompt) // P)
        children, parent = self._root, None
        self._clock += 1
        for k in range(n_full):
            key = self._key(prompt, k, P)
            node = children.get(key)
            if node is None:
                node = _Node(key, page_row[k], parent)
                self._pool.incref(node.page)   # the cache's own reference
                children[key] = node
                self._nodes.append(node)
            node.stamp = self._clock
            children, parent = node.children, node

    def digests(self, limit: int = 64) -> List[int]:
        """Chain digests (see :func:`page_digests`) of up to ``limit``
        most-recently-touched nodes — the bounded ``prefix_digest``
        block the engine's ``/load`` report publishes.  A router hashes
        a prompt's page-aligned prefixes the same way and matches the
        deepest digest present here: that replica already holds those
        KV pages, so dispatching the request to it skips re-prefilling
        them (cache-affinity).  Bounded so a huge cache never bloats the
        capacity document; recency order keeps the entries that are
        still likely resident when the routed request lands.  Runs
        under the engine lock on every load probe (the router polls per
        dispatch), so it selects the top ``limit`` by stamp in
        O(n log limit) instead of fully sorting the node list."""
        top = heapq.nlargest(int(limit), self._nodes,
                             key=lambda nd: nd.stamp)
        return [nd.digest for nd in top]

    def remap_pages(self, remap: dict) -> int:
        """Rewrite cached physical page ids after a pool compaction
        (``remap`` maps old id -> new id, from
        :meth:`PagePool.apply_moves`).  Refcounts already moved with the
        pool commit; this keeps the radix tree pointing at the pages'
        new homes.  Returns how many nodes were rewritten."""
        n = 0
        for node in self._nodes:
            new = remap.get(node.page)
            if new is not None:
                node.page = int(new)
                n += 1
        return n

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages by dropping LRU leaves nobody else
        references; returns how many were freed.  Dropping a leaf can
        expose its parent, so the scan loops until satisfied or stuck."""
        freed = 0
        while freed < n:
            victims = [nd for nd in self._nodes
                       if not nd.children
                       and self._pool.refcount(nd.page) == 1]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.stamp)
            self._drop_node(victim)
            freed += 1
        return freed

    def _drop_node(self, node: _Node) -> None:
        siblings = node.parent.children if node.parent else self._root
        del siblings[node.key]
        self._nodes.remove(node)
        self._pool.decref(node.page)

    def drop(self) -> int:
        """Release every cached page (HBM reclaim / leak checks).  Pages
        still mapped by live slots stay allocated until those slots
        free."""
        n = len(self._nodes)
        for node in self._nodes:
            self._pool.decref(node.page)
        self._nodes.clear()
        self._root.clear()
        return n
