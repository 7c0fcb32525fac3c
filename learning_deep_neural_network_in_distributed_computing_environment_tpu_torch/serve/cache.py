"""Page pool bookkeeping for the serving engine's paged KV cache (a copy of
the JAX package's ``serve/cache.py``, with the speculative pair's
``paired_admit``).

The device-side cache layout and attention live in ``models/decode.py``;
this module is the HOST side: which pages belong to which sequence, and
the byte-exact occupancy accounting the telemetry/bench gate on.  Page id
0 is the trash page (``models.decode.TRASH_PAGE``): masked writes from
prefill padding and inactive decode slots land there, so the allocator
never hands it out.

Pages are content-addressed.  A page's key is the rolling hash of
the token prefix it CLOSES (``page_prefix_keys``), so two sequences that
share a page-aligned prompt prefix resolve to the same keys and can share
physical pages by reference.  The allocator grows refcounts plus a
hash → page index: ``alloc`` hands out fresh referenced pages, ``claim``
takes an extra reference on a cache hit, ``free`` drops a reference, and
a keyed page whose refcount reaches zero is RETAINED on an LRU instead of
returning to the free list — eviction happens lazily inside ``alloc``,
oldest refcount-0 page first, only when the free list runs short.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from ..models.decode import TRASH_PAGE


def pages_needed(total_tokens: int, page_size: int) -> int:
    """Pages a sequence reaching ``total_tokens`` positions needs."""
    return max(1, -(-int(total_tokens) // int(page_size)))


def page_prefix_keys(tokens, page_size: int) -> list[bytes]:
    """Content keys for a prompt's page-aligned prefix.

    ``keys[i]`` identifies the page holding tokens
    ``[i*page_size, (i+1)*page_size)`` — but the hash covers the WHOLE
    prefix up to and including that page (a rolling blake2b, updated one
    page at a time), so a page only matches when everything before it
    matches too.  Only full pages get a key: a partial trailing page is
    never shareable because its remaining rows will be filled by this
    sequence's own decode writes.
    """
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    ps = int(page_size)
    h = hashlib.blake2b(digest_size=16)
    keys: list[bytes] = []
    for i in range(arr.shape[0] // ps):
        h.update(arr[i * ps:(i + 1) * ps].tobytes())
        keys.append(h.digest())
    return keys


class PageAllocator:
    """Refcounted free-list allocator over the page pool (page 0 reserved).

    Allocation is all-or-nothing per request: a sequence gets every page
    its ``prompt + max_new_tokens`` span can reach up front, so a running
    decode can never die mid-generation from pool exhaustion — admission
    is the only place that blocks.  Freed ids return to the HEAD of the
    free list, so the recycle tests can assert an evicted sequence's
    pages are literally the next ones handed out.

    With the prefix cache in play a page has three states:

    * referenced (refcount >= 1): owned by live sequences; never evicted.
    * cached (refcount 0, has a content key): parked on the LRU, its KV
      bytes intact; a future ``claim`` resurrects it, or ``alloc``
      evicts it (oldest first) when the free list runs short.
    * free: on the free list, contents meaningless.

    ``in_use`` counts referenced pages only — cached pages are reported
    separately via ``cached_pages`` so the byte-exact occupancy identity
    ``in_use + cached_pages + free_pages == max_pages - 1`` always holds.
    """

    def __init__(self, max_pages: int):
        if max_pages < 2:
            raise ValueError(
                f"max_pages must be >= 2 (page {TRASH_PAGE} is the "
                f"reserved trash page), got {max_pages}")
        self.max_pages = int(max_pages)
        self._free = list(range(1, self.max_pages))
        self._ref: dict[int, int] = {}
        self._index: dict[bytes, int] = {}      # content key -> page
        self._key_of: dict[int, bytes] = {}     # page -> content key
        self._lru: OrderedDict[int, None] = OrderedDict()  # refcount-0 keyed
        self.peak_in_use = 0
        self.cache_evictions = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._lru)

    @property
    def in_use(self) -> int:
        return (self.max_pages - 1) - len(self._free) - len(self._lru)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, count: int) -> list[int] | None:
        """``count`` fresh page ids (each refcount 1), or None when the
        pool cannot cover them even after evicting every refcount-0
        cached page (the caller keeps the request queued — admission
        backpressure).  The free list is consumed first; cached pages
        are evicted oldest-first only to cover the shortfall."""
        if count > len(self._free) + len(self._lru):
            return None
        take = min(count, len(self._free))
        got, self._free = self._free[:take], self._free[take:]
        while len(got) < count:
            page, _ = self._lru.popitem(last=False)
            del self._index[self._key_of.pop(page)]
            self.cache_evictions += 1
            got.append(page)
        for p in got:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return got

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page.  A page reaching refcount 0 goes
        back to the HEAD of the free list — unless it carries a content
        key, in which case it is parked on the LRU with its KV intact."""
        for p in pages:
            if p == TRASH_PAGE or p >= self.max_pages:
                raise ValueError(f"freeing invalid page id {p}")
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"double free of page {p}")
        released: list[int] = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                if p in self._key_of:
                    self._lru[p] = None
                else:
                    released.append(p)
        self._free = released + self._free

    def claim(self, page: int) -> None:
        """Take one more reference on a page (prefix-cache hit).  Works
        on referenced pages (another live sequence shares it) and on
        cached refcount-0 pages (resurrected off the LRU)."""
        if page in self._lru:
            del self._lru[page]
            self._ref[page] = 1
        elif page in self._ref:
            self._ref[page] += 1
        else:
            raise ValueError(f"claiming page {page} that is neither "
                             f"referenced nor cached")
        self.peak_in_use = max(self.peak_in_use, self.in_use)

    def register(self, key: bytes, page: int) -> bool:
        """Publish a referenced page's content key so future admissions
        can hit it.  First writer wins: if the key is already indexed
        (a racing twin registered first) or the page already carries a
        key, this is a no-op and the page stays unkeyed / keeps its key.
        Returns True when the registration took."""
        if self._ref.get(page, 0) < 1:
            raise ValueError(
                f"registering page {page} with no live reference")
        if key in self._index or page in self._key_of:
            return False
        self._index[key] = page
        self._key_of[page] = key
        return True

    def lookup(self, keys: list[bytes]) -> list[int]:
        """Longest consecutive run of cached pages matching ``keys``
        from the start — the prompt's reusable page-aligned prefix.
        Pages are returned WITHOUT claiming them; the caller must
        ``claim`` each before any ``alloc`` could evict them."""
        hits: list[int] = []
        for k in keys:
            p = self._index.get(k)
            if p is None:
                break
            hits.append(p)
        return hits


def paired_admit(target: PageAllocator, draft: PageAllocator,
                 hits_t: list[int], hits_d: list[int], count: int
                 ) -> tuple[list[int], list[int]] | None:
    """All-or-nothing admission across a speculative pair's (target,
    draft) allocators (JAX ``serve/cache.py:192-234``).

    A speculating sequence needs its whole page span in BOTH pools before
    it starts: the draft writes ``C .. C+k-1`` and the verify ``C .. C+k``
    every tick, so a pair short of pages in one pool mid-decode would
    wait on sequences that wait on the other.  This claims the
    prefix-cache hits and allocates the fresh pages target first, and on
    any failure rolls BOTH pools back to their entry state (the request
    stays queued).  ``hits_t``/``hits_d`` cover the same token prefix
    (one shared filled offset); ``count`` is the span per pool.  Returns
    ``(target_pages, draft_pages)`` or None."""
    if len(hits_t) != len(hits_d):
        raise ValueError(
            f"paired admission needs hit runs of equal length (one "
            f"shared filled offset), got {len(hits_t)}/{len(hits_d)}")
    for p in hits_t:
        target.claim(p)
    fresh_t = target.alloc(count - len(hits_t))
    if fresh_t is None:
        if hits_t:
            target.free(hits_t)
        return None
    for p in hits_d:
        draft.claim(p)
    fresh_d = draft.alloc(count - len(hits_d))
    if fresh_d is None:
        if hits_d:
            draft.free(hits_d)
        target.free(hits_t + fresh_t)
        return None
    return hits_t + fresh_t, hits_d + fresh_d


def page_table_row(pages: list[int], pages_per_seq: int) -> np.ndarray:
    """A sequence's page-table row: its pages in position order, the
    unreachable tail pointed at the trash page."""
    if len(pages) > pages_per_seq:
        raise ValueError(
            f"{len(pages)} pages exceed the table width {pages_per_seq}")
    row = np.full(pages_per_seq, TRASH_PAGE, np.int32)
    row[:len(pages)] = pages
    return row
