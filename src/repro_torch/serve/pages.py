"""Host-side page pool for the paged KV cache.

The paged cache (``repro_torch.serve.cache`` with ``page_size`` set)
stores KV on a single global slot axis of ``n_pages * page_size``
physical slots; rows address it through a per-row
``page_table (B, max_pages) int32`` of pool page ids (-1 = unmapped).
``PagePool`` owns the allocation state for those pages: a free list and
a per-page reference count. It is deliberately
host-only — allocation decisions never need a device sync, and the device
never sees refcounts, only the page tables the scheduler publishes.

A copy of ``repro.serve.pages``. Refcount invariant:

    ref[p] == (# row page-table entries mapping p)
              + (1 if the radix prefix index holds p)

A page with ``ref > 1`` is *shared*: it is fully committed in every view
that maps it and is never written again (writers only touch private
``ref == 1`` pages — partial boundary pages are never published, so a
shared page can only ever be read). A page returns to the free list when
its last reference drops.

Eviction is not the pool's job: when ``alloc`` comes up short the caller
(the scheduler) reclaims pages from the radix index via
``RadixTree.evict_pages`` — least-recently-used pages held only by the
index — releases them here, and retries. ``evictions`` counts pages
reclaimed that way for telemetry/benchmarks.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry


class PagePool:
    """Fixed-size page allocator: free list + per-page refcounts.

    ``token_bytes`` is the KV cost of one token slot (codes + any
    quantization scale sidecar, summed over layers —
    ``repro_torch.serve.cache.kv_token_bytes``); the scheduler stamps it at
    construction so capacity questions have one answer in tokens
    (``capacity_tokens``) and one in bytes (``pool_bytes``). With int8 KV
    the sidecar is part of a page's footprint — a page moves with its
    scales — so the byte accounting stays honest across dtypes, which is
    what lets benchmarks size quantized and bf16 pools to *equal bytes*
    rather than equal page counts.
    """

    def __init__(self, n_pages: int, page_size: int,
                 *, token_bytes: float = 0.0,
                 metrics: Optional[MetricsRegistry] = None):
        assert n_pages > 0 and page_size > 0
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.token_bytes = float(token_bytes)
        self.ref = np.zeros(self.n_pages, np.int32)
        # stack: pop() hands out low page ids first
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        # counters live in a metrics registry (the scheduler passes its
        # own, so pool counters ride scheduler snapshots); the plain
        # attribute API (`pool.evictions`, `pool.evictions = 0`) is kept
        # as properties over the registry
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_evictions = self.metrics.counter("pool.evictions")
        self._c_alloc_total = self.metrics.counter("pool.alloc_total")

    @property
    def evictions(self) -> int:
        """Pages reclaimed from the prefix index."""
        return self._c_evictions.value

    @evictions.setter
    def evictions(self, v: int) -> None:
        self._c_evictions.set(int(v))

    @property
    def alloc_total(self) -> int:
        """Pages ever handed out."""
        return self._c_alloc_total.value

    @alloc_total.setter
    def alloc_total(self, v: int) -> None:
        self._c_alloc_total.set(int(v))

    def free_count(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def capacity_tokens(self) -> int:
        """Total token slots the pool can hold across all rows."""
        return self.n_pages * self.page_size

    def pool_bytes(self) -> int:
        """Total KV bytes backing the pool (0 when ``token_bytes`` was
        never stamped)."""
        return int(self.capacity_tokens() * self.token_bytes)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Hand out ``n`` pages with ``ref = 1`` each, or ``None`` (and no
        state change) if the free list is short — the caller evicts from
        the prefix index and retries."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            assert self.ref[p] == 0, f"page {p} on free list with ref set"
            self.ref[p] = 1
        self._c_alloc_total.inc(n)
        return out

    def incref(self, pages) -> None:
        for p in pages:
            assert self.ref[p] > 0, f"incref on unallocated page {p}"
            self.ref[p] += 1

    def decref(self, pages) -> None:
        """Drop one reference per page; pages reaching zero return to the
        free list."""
        for p in pages:
            assert self.ref[p] > 0, f"decref on unallocated page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(int(p))

    def note_evictions(self, n: int) -> None:
        self._c_evictions.inc(int(n))


__all__ = ["PagePool"]
