"""Block-paged KV memory: allocator, page tables, and shared-prefix reuse.

A copy of ``repro/core/kv_pager.py`` (the port imports nothing of the JAX
package); only this docstring's module names differ.

The dense decode pool reserves ``max_len`` worth of KV per slot the moment
a request is admitted — device memory scales with worst-case context, not actual
context, and a preempted request pays a full recompute on resume.  This
module is the host-side half of the paged replacement (the device half is
``repro_torch.models.paged`` + the paged flash-decode kernel K3):

  * ``BlockAllocator`` — a pool of ``num_pages`` fixed-size KV pages with
    refcounts and a free list.  Page 0 is RESERVED as the "dump" page:
    page-table rows of empty slots point at it, so decode-step writes from
    vacant rows (and the padded lanes of a bucketed prefill scatter) land
    in a page nothing ever reads.  Allocation is O(1) per page.

  * ``PrefixCache`` — hash-based shared-prefix reuse.  Page ``i`` of a
    token stream is keyed by ``blake2b(key_{i-1} || tokens[i*ps:(i+1)*ps])``
    — a chain hash, so a page key commits to the ENTIRE prefix, which is
    exactly the dependency structure of causal KV.  Identical prompt
    prefixes therefore map to the same physical pages: the prefill runs
    once per distinct prefix and every follower attends to the shared,
    refcounted pages.  Only FULL pages are ever shared, and a request
    reuses at most ``floor((n-1)/page_size)`` of them, so it always
    prefills >= 1 suffix token (that forward produces its first-token
    logits, and decode never writes into a shared page).  Entries are
    LRU-evictable: when the allocator runs dry, cached pages held ONLY by
    the cache are released before admission fails.

  * ``KVPager`` — the facade the scheduler drives: match / allocate /
    register / release, plus the counters surfaced in /metrics (page
    utilization, prefix hit rate, evictions).

Everything here is plain host Python over numpy refcounts — the device
only ever sees the resulting ``(num_slots, max_pages)`` int32 page table.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DUMP_PAGE = 0       # reserved: absorbs writes from vacant rows, never read


class PagerOOM(RuntimeError):
    """No free page and nothing evictable; callers defer or preempt."""


class BlockAllocator:
    """Refcounted fixed-size page pool.  Page ids are ints in
    ``[1, num_pages)``; page ``DUMP_PAGE`` is never handed out."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.refcount = np.zeros((num_pages,), np.int32)
        self.refcount[DUMP_PAGE] = 1            # permanently pinned
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagerOOM(
                f"need {n} pages, {len(self._free)} free "
                f"of {self.num_pages - 1}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refcount[p] = 1
        return out

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert self.refcount[p] > 0, f"incref on free page {p}"
            self.refcount[p] += 1

    def decref(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; fully-released pages return to the
        free list.  Returns how many pages were freed."""
        freed = 0
        for p in pages:
            assert p != DUMP_PAGE and self.refcount[p] > 0, \
                f"decref on page {p} (rc={self.refcount[p]})"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed += 1
        return freed


def _chain_keys(tokens: Sequence[int], page_size: int,
                n_pages: int) -> List[bytes]:
    """Chain-hash keys for the first ``n_pages`` FULL pages of a stream."""
    keys: List[bytes] = []
    prev = b""
    for p in range(n_pages):
        chunk = tokens[p * page_size:(p + 1) * page_size]
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(np.asarray(chunk, np.int64).tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class PrefixCache:
    """key -> page_id with LRU order; holds ONE allocator reference per
    cached page (so a cached page survives its original request)."""

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self._by_key: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_key)

    def match(self, keys: Sequence[bytes]) -> List[int]:
        """Longest cached chain prefix of ``keys``; increfs every matched
        page FOR THE CALLER (the caller owns the returned references)."""
        pages: List[int] = []
        for key in keys:
            pid = self._by_key.get(key)
            if pid is None:
                self.misses += 1
                break
            self._by_key.move_to_end(key)
            self.alloc.incref([pid])
            pages.append(pid)
            self.hits += 1
        return pages

    def register(self, keys: Sequence[bytes],
                 pages: Sequence[int]) -> None:
        """Publish page ``pages[i]`` under ``keys[i]``.  Already-cached
        keys just refresh their LRU position (the later duplicate page
        stays private to its request)."""
        for key, pid in zip(keys, pages):
            if key in self._by_key:
                self._by_key.move_to_end(key)
                continue
            self.alloc.incref([pid])
            self._by_key[key] = pid

    def evict_lru(self) -> bool:
        """Release the least-recently-used entry whose page is held ONLY
        by the cache.  Returns False when nothing is evictable."""
        for key, pid in self._by_key.items():
            if self.alloc.refcount[pid] == 1:
                del self._by_key[key]
                self.alloc.decref([pid])
                self.evictions += 1
                return True
        return False


@dataclass
class PrefixMatch:
    pages: List[int]            # caller-owned references to shared pages
    ctx_tokens: int             # page-aligned token count they cover


class KVPager:
    """Allocator + prefix cache + the counters the scheduler exports."""

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.allocator = BlockAllocator(num_pages)
        self.prefix = PrefixCache(self.allocator)
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.pages_used_high_water = 0   # peak concurrent page residency
        self.oom_events = 0              # allocs that failed post-eviction

    # --- admission-side API ---------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest shared full-page prefix of ``tokens``, capped so the
        request always keeps >= 1 token of suffix to prefill."""
        n = len(tokens)
        cap = max(0, (n - 1) // self.page_size)
        keys = _chain_keys(tokens, self.page_size, cap)
        pages = self.prefix.match(keys)
        self.prefix_lookup_tokens += n
        self.prefix_hit_tokens += len(pages) * self.page_size
        return PrefixMatch(pages, len(pages) * self.page_size)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages, evicting cache-only pages LRU-first when
        the pool is dry.  Raises PagerOOM when eviction cannot help."""
        while self.allocator.free_pages < n:
            if not self.prefix.evict_lru():
                break
        try:
            out = self.allocator.alloc(n)
        except PagerOOM:
            self.oom_events += 1
            raise
        self.pages_used_high_water = max(self.pages_used_high_water,
                                         self.allocator.used_pages)
        return out

    def register_prefix(self, tokens: Sequence[int],
                        pages: Sequence[int]) -> None:
        """Publish every FULL page of ``tokens`` (page i is ``pages[i]``)
        into the prefix cache."""
        n_full = len(tokens) // self.page_size
        n_full = min(n_full, len(pages))
        if n_full:
            keys = _chain_keys(tokens, self.page_size, n_full)
            self.prefix.register(keys, list(pages)[:n_full])

    def release(self, pages: Sequence[int]) -> int:
        return self.allocator.decref(pages)

    # --- observability ----------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.allocator.num_pages - 1

    def utilization(self) -> float:
        return self.allocator.used_pages / max(1, self.usable_pages)

    def hit_rate(self) -> float:
        total = self.prefix.hits + self.prefix.misses
        return self.prefix.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "page_size": self.page_size,
            "pages_total": self.usable_pages,
            "pages_used": self.allocator.used_pages,
            "pages_free": self.allocator.free_pages,
            "pages_used_high_water": self.pages_used_high_water,
            "page_utilization": self.utilization(),
            "oom_events": self.oom_events,
            "prefix_cached_pages": len(self.prefix),
            "prefix_hits": self.prefix.hits,
            "prefix_misses": self.prefix.misses,
            "prefix_hit_rate": self.hit_rate(),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "prefix_evictions": self.prefix.evictions,
        }


def pages_for_budget(budget_bytes: int, page_bytes: int) -> int:
    """How many KV pages (incl. the reserved dump page) fit a byte budget."""
    return max(2, budget_bytes // max(1, page_bytes))
