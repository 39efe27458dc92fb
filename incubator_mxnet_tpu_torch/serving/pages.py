"""Host-side page allocator + prefix cache for the paged KV cache.

The device pool (`models.transformer.init_paged_kv_cache`) is
`(L, num_pages, page_size, H, Dh)`; this allocator owns the free list
over `num_pages` and hands out page ids. Page 0 is the RESERVED NULL
PAGE: it is never allocated, and dead decode slots / padded prefill rows
scatter their writes there, so an all-zero page-table row is always a
safe "empty" row. Allocation is all-or-nothing (a request either gets
every page it needs or stays in the queue — no mid-decode exhaustion),
and `free()` returns pages for immediate reuse without touching device
memory: stale K/V in a recycled page is dead data beyond every live
sequence's `n_valid` until overwritten.

Pages are REFCOUNTED (the vLLM/PagedAttention block-sharing design):
`alloc()` hands out pages at refcount 1, `share()` adds references so
several page tables can point at the same physical page read-only, and
`free()` decrements — a page only returns to the free list when its
last reference drops. `cow()` is the copy-on-write primitive: it turns
a shared reference into an exclusively-owned page id (the caller copies
the device bytes and rewrites its table row).

`PrefixCache` is the hash-trie prefix index over page-aligned token-id
chunks that makes sharing automatic: after a prompt prefills, its full
pages are inserted keyed by their token content (plus one "partial
leaf" for a non-page-aligned prompt tail); later prompts look up their
longest cached page-aligned prefix and map those pages instead of
recomputing them. The cache holds one reference per cached page, so
entries survive the inserting request's eviction; LRU eviction only
touches pages no live request references (refcount == the cache's own
single reference).

Pure host bookkeeping in numpy, safe to use from schedulers and tests
without a device. A copy of the JAX package's `serving/pages.py`: a page
sanitizer (`analysis.sanitizers.attach_page_sanitizer`) sees every
transition, and while one is attached each transition also logs a
`page_lifecycle` flight-recorder event.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..telemetry import recorder as _recorder

__all__ = ["PageAllocator", "PrefixCache", "NULL_PAGE"]

NULL_PAGE = 0


def _log_page_event(op, pages, owner, free):
    """`page_lifecycle` flight-recorder events (alloc/share/cow/free
    with owner provenance) so a post-mortem dump can reconstruct who
    leaked a page. Emitted only while a page sanitizer is attached
    (MXTPU_SANITIZERS=pages) — the default path does not spend ring
    capacity or event-encoding time on per-page bookkeeping."""
    _recorder.log_event("page_lifecycle", op=op, pages=list(pages),
                        owner=owner, free=free)


class PageAllocator:
    """Refcounting free-list allocator over a pool of `num_pages` KV
    pages of `page_size` tokens each (page 0 reserved)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the "
                             f"reserved null page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # FIFO recycling keeps page ids roughly round-robin, which makes
        # reuse-after-free bugs show up deterministically in tests
        self._free = deque(range(1, self.num_pages))
        self._refs: dict[int, int] = {}
        # armed by analysis.sanitizers.attach_page_sanitizer when the
        # pages sanitizer is on; every transition below feeds it
        self.sanitizer = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        """Physical pages with at least one reference — a page shared by
        N tables still counts ONCE (it occupies one pool slot)."""
        return len(self._refs)

    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page doesn't count)."""
        return self.num_pages - 1

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently owned, in [0, 1]."""
        return self.num_in_use / self.capacity

    def fragmentation(self) -> float:
        """Free-list fragmentation in [0, 1]: 1 minus the largest run of
        CONSECUTIVE page ids in the free list over the free count. 0 when
        the free pages form one contiguous id range (or none are free);
        approaches 1 as recycling interleaves the pool. Paged attention
        doesn't need contiguity — this is a health signal for the
        /debug/engine view, not an allocator constraint."""
        if not self._free:
            return 0.0
        ids = sorted(self._free)
        longest = run = 1
        for prev, cur in zip(ids, ids[1:]):
            run = run + 1 if cur == prev + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / len(ids)

    def pages_needed(self, n_tokens: int) -> int:
        """Pages required to hold `n_tokens` cache entries."""
        if n_tokens <= 0:
            return 0
        return -(-int(n_tokens) // self.page_size)

    def alloc(self, n_pages: int, owner=None):
        """Allocate `n_pages` pages at refcount 1; returns the page-id
        list, or None when the pool can't cover it (all-or-nothing —
        the caller keeps the request queued instead of half-admitting
        it). `owner` is provenance (request id, "prefix_cache") for the
        page_lifecycle event stream and the page sanitizer's mapping
        registry."""
        n_pages = int(n_pages)
        if n_pages < 0:
            raise ValueError(f"cannot alloc {n_pages} pages")
        if n_pages > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = 1
        if self.sanitizer is not None:
            self.sanitizer.on_alloc(pages, owner=owner)
            if pages:
                _log_page_event("alloc", pages, owner, len(self._free))
        return pages

    def extend(self, pages, old_tokens: int, new_tokens: int, owner=None):
        """Grow an allocation that covers `old_tokens` so it covers
        `new_tokens`: allocates only the delta pages and returns the new
        combined list (the input list is not mutated), or None when the
        pool can't cover the growth (nothing is allocated)."""
        need = self.pages_needed(new_tokens) - self.pages_needed(old_tokens)
        if need <= 0:
            return list(pages)
        extra = self.alloc(need, owner=owner)
        if extra is None:
            return None
        return list(pages) + extra

    def share(self, pages, owner=None):
        """Add one reference to each page — a second page table now maps
        it read-only. Sharing a page that isn't live raises (that table
        would read recycled garbage)."""
        pages = list(pages)
        bad = [p for p in pages if p not in self._refs]
        if bad:
            if self.sanitizer is not None:
                self.sanitizer.on_share(bad, owner=owner)
            raise ValueError(f"sharing pages not currently allocated: {bad}")
        if self.sanitizer is not None:
            self.sanitizer.on_share(pages, owner=owner)
        for p in pages:
            self._refs[p] += 1
        if self.sanitizer is not None and pages:
            _log_page_event("share", pages, owner, len(self._free))

    def refcount(self, page: int) -> int:
        """References currently held on `page` (0 = free/null)."""
        return self._refs.get(int(page), 0)

    def refcount_histogram(self) -> dict:
        """{refcount: number of pages} over live pages — the sharing
        shape of the pool for /debug/engine."""
        hist: dict[int, int] = {}
        for c in self._refs.values():
            hist[c] = hist.get(c, 0) + 1
        return hist

    def cow(self, page: int, owner=None):
        """Copy-on-write: turn one reference on a SHARED `page` into an
        exclusively-owned page id. Returns `page` unchanged when the
        caller already holds the only reference (no copy needed); else
        allocates a fresh page, moves the caller's reference onto it and
        returns the new id — the caller must then copy the device bytes
        and repoint its table row. Returns None when the pool has no
        free page for the copy (nothing changes; the caller can evict
        prefix-cache entries and retry)."""
        page = int(page)
        count = self._refs.get(page)
        if not count:
            if self.sanitizer is not None:
                self.sanitizer.on_cow(page, None, owner=owner)
            raise ValueError(f"cow on page {page} which is not allocated")
        if count == 1:
            return page
        fresh = self.alloc(1, owner=owner)
        if fresh is None:
            return None
        self._refs[page] = count - 1
        if self.sanitizer is not None:
            self.sanitizer.on_cow(page, fresh[0], owner=owner)
            _log_page_event("cow", [page, fresh[0]], owner, len(self._free))
        return fresh[0]

    def free(self, pages, owner=None):
        """Drop one reference per page; a page returns to the pool for
        immediate reuse when its LAST reference drops. Freeing a page
        that isn't currently allocated (double free, or the null page)
        raises — that's a scheduler bug corrupting another request's
        cache, not a condition to paper over."""
        pages = list(pages)
        bad = [p for p in pages if p not in self._refs]
        if bad:
            if self.sanitizer is not None:
                self.sanitizer.on_free(bad, owner=owner)
            raise ValueError(f"freeing pages not currently allocated: {bad}")
        if self.sanitizer is not None:
            self.sanitizer.on_free(pages, owner=owner)
        for p in pages:
            if self._refs[p] > 1:
                self._refs[p] -= 1
            else:
                del self._refs[p]
                self._free.append(p)
        if self.sanitizer is not None and pages:
            _log_page_event("free", pages, owner, len(self._free))

    def table_row(self, pages, width: int):
        """Pad a page list to a fixed-width page-table row (null-page
        padded) — the static shape decode_step_paged needs."""
        if len(pages) > width:
            raise ValueError(f"{len(pages)} pages exceed table width "
                             f"{width}")
        return list(pages) + [NULL_PAGE] * (width - len(pages))


class _Node:
    """One full-page trie node: `page` holds exactly the `page_size`
    tokens of its chunk key; `children` continue the prefix; `partials`
    map a shorter-than-a-page token tail (bytes key) to (page, tokens)
    leaves."""

    __slots__ = ("page", "children", "partials", "tick")

    def __init__(self, page, tick):
        self.page = page
        self.children: dict = {}
        self.partials: dict = {}
        self.tick = tick


class PrefixCache:
    """Hash-trie prefix index over page-aligned token-id chunks.

    Keys are the token ids of each `page_size` chunk of a prompt (as
    bytes), so two prompts share cached pages exactly as far as their
    page-aligned token prefixes agree. The cache holds ONE allocator
    reference per cached page; `evict()` walks leaves in LRU order and
    only drops pages whose refcount equals that single cache reference
    (no live request is mapped onto them) — the "LRU at refcount 0"
    rule counted in live-request references.

    `max_pages` caps the cached-page count (0 = unbounded, bounded only
    by pool pressure via the engine's on-demand eviction).
    """

    def __init__(self, allocator: PageAllocator, max_pages: int = 0):
        self.allocator = allocator
        self.max_pages = int(max_pages)
        self._children: dict = {}   # root level full-page nodes
        self._partials: dict = {}   # root level partial leaves
        self._pages: dict = {}      # page -> (container_dict, key)
        self._tick = 0
        self.evictions = 0

    # -- introspection ----------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return len(self._pages)

    def stats(self) -> dict:
        return {"cached_pages": self.cached_pages,
                "capacity": self.max_pages,
                "evictions": self.evictions}

    # -- core -------------------------------------------------------------

    def _touch(self):
        self._tick += 1
        return self._tick

    @staticmethod
    def _key(tokens) -> bytes:
        return tokens.tobytes()

    def lookup(self, prompt):
        """Longest cached page-aligned prefix of `prompt` (np.int32).

        Returns (pages, partial): `pages` is the list of full cached
        pages covering prompt[:len(pages)*page_size]; `partial` is
        (page, chunk_tokens) for a cached partial leaf stored directly
        under the last matched node whose tokens extend the match, or
        None. The caller decides how much of the partial chunk its
        prompt tail actually shares (and takes its own references via
        `allocator.share`)."""
        ps = self.allocator.page_size
        pages = []
        children, partials = self._children, self._partials
        i = 0
        tick = self._touch()
        while (i + 1) * ps <= prompt.size:
            node = children.get(self._key(prompt[i * ps:(i + 1) * ps]))
            if node is None:
                break
            node.tick = tick
            pages.append(node.page)
            children, partials = node.children, node.partials
            i += 1
        partial = None
        tail = prompt[i * ps:]
        if tail.size and partials:
            # a partial leaf matches when one is a prefix of the other:
            # walk the (few) leaves at this node and take the longest
            # shared length
            best = 0
            for ptoks, (page, _) in partials.items():
                n = min(len(ptoks) // 4, tail.size)  # int32 = 4 bytes
                chunk = np.frombuffer(ptoks, dtype=np.int32)
                if n and np.array_equal(chunk[:n], tail[:n]):
                    if n > best:
                        best = n
                        partial = (page, chunk)
        return pages, partial

    def insert(self, prompt, pages):
        """Register a freshly-prefilled prompt's pages: full chunks go
        into the trie, a non-aligned tail becomes a partial leaf. Only
        NEW entries take a cache reference (chunks already cached keep
        the original page — by construction the caller mapped that same
        page). Returns the set of `pages` indices the cache now also
        references (the engine marks the partial one copy-on-write)."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.allocator.page_size
        tick = self._touch()
        children, partials = self._children, self._partials
        newly_cached = set()
        i = 0
        while (i + 1) * ps <= prompt.size:
            key = self._key(prompt[i * ps:(i + 1) * ps])
            node = children.get(key)
            if node is None:
                page = pages[i]
                self.allocator.share([page], owner="prefix_cache")
                node = _Node(page, tick)
                children[key] = node
                self._pages[page] = (children, key)
                newly_cached.add(i)
            else:
                node.tick = tick
            children, partials = node.children, node.partials
            i += 1
        tail = prompt[i * ps:]
        if tail.size:
            key = self._key(tail)
            if key not in partials and i < len(pages):
                page = pages[i]
                if page not in self._pages:
                    self.allocator.share([page], owner="prefix_cache")
                    partials[key] = (page, tick)
                    self._pages[page] = (partials, key)
                    newly_cached.add(i)
        if self.max_pages:
            self.evict(self.cached_pages - self.max_pages)
        return newly_cached

    def release(self, page):
        """Targeted drop of the cache's reference on `page` (only held
        for leaf entries — partial leaves and childless full nodes).
        Returns True when released. The engine's COW fallback: when the
        pool has no page for the copy, stealing the cache's reference
        back makes the writer exclusive again."""
        entry = self._pages.get(page)
        if entry is None:
            return False
        container, key = entry
        node = container.get(key)
        if isinstance(node, _Node) and (node.children or node.partials):
            return False  # mid-trie: children key off this page's chunk
        del container[key]
        del self._pages[page]
        self.allocator.free([page], owner="prefix_cache")
        self.evictions += 1
        return True

    def evict(self, n_pages: int) -> int:
        """Evict up to `n_pages` cached pages in LRU order, touching
        only pages no live request references (refcount == the cache's
        single reference). Interior trie nodes become evictable once
        their subtree goes — the scan loops until it frees enough or a
        full pass makes no progress. Returns pages actually freed."""
        if n_pages <= 0:
            return 0
        freed = 0
        while freed < n_pages:
            candidates = []  # (tick, page, container, key)
            stack = [(self._children, self._partials)]
            while stack:
                children, partials = stack.pop()
                for key, (page, tick) in list(partials.items()):
                    if self.allocator.refcount(page) == 1:
                        candidates.append((tick, page, partials, key))
                for key, node in list(children.items()):
                    if not node.children and not node.partials:
                        if self.allocator.refcount(node.page) == 1:
                            candidates.append(
                                (node.tick, node.page, children, key))
                    else:
                        stack.append((node.children, node.partials))
            if not candidates:
                break
            candidates.sort(key=lambda c: c[0])
            progressed = False
            for _, page, container, key in candidates:
                if freed >= n_pages:
                    break
                if key in container and page in self._pages:
                    del container[key]
                    del self._pages[page]
                    self.allocator.free([page], owner="prefix_cache")
                    self.evictions += 1
                    freed += 1
                    progressed = True
            if not progressed:
                break
        return freed
