"""Paged KV-cache: fixed-size pages, per-sequence block tables, a
host-side allocator.

Counterpart of ``mxnet_tpu/serve2/kvcache.py``; host-only (numpy).

The device side is two flat pools per engine — ``(L, S, H, K)`` for K
and V, ``S = num_pages * page_size`` slots — whose shapes never change
for the life of the engine (the decode programs see one shape per batch
rung, and the pools are written in place). This module owns the *host*
side: which pages belong to which sequence.

- :class:`PageAllocator` — a free-list over page ids. Page 0 is
  reserved as the **null page**: block-table padding and dead batch
  rows point at it, so masked/garbage writes land in scratch memory
  instead of another sequence's history.
- :class:`BlockTable` — one sequence's page list plus its logical
  length, rendered on demand into the fixed-width int32 row the
  decode step takes.

Allocation happens on admit (prefill needs ``ceil(prompt/page_size)``
pages) and incrementally at page boundaries during decode; free happens
on finish and on preemption. The allocator never compacts — pages are
interchangeable by construction, which is exactly why fragmentation
cannot exist in this layout.

Pages are **refcounted** (serve3 prefix caching): ``alloc`` hands a
page out at refcount 1, ``incref`` lets another holder (a second
sequence sharing the same prompt prefix, or the
:class:`~mxnet_tpu_torch.serve2.prefix.PrefixCache` itself) pin it, and
``free`` is a *decrement* — the page only returns to the free list when
the last holder lets go. Shared pages are read-only by contract: a
write into a page with refcount > 1 must go through copy-on-write
(``passes/servelint`` audits this cross-checking refcounts against the
live block tables).

Occupancy telemetry (``mxserve2_pages_*`` gauges) feeds the metrics
registry so the router can see pool pressure. Locks are plain
``threading`` primitives (the JAX package's sanitizer wrapper waits for
ROADMAP Queue A item 8).
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Optional

import numpy as onp

from ..base import MXNetError
from ..telemetry import metrics as _metrics

__all__ = ["PageAllocator", "BlockTable", "PagePoolExhausted",
           "pages_needed"]


class PagePoolExhausted(MXNetError):
    """No free page in the pool — the scheduler's cue to preempt."""


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` cached positions."""
    return max(0, -(-int(n_tokens) // int(page_size)))


def _gauge_tag(name: str) -> str:
    """Metric-name-safe engine tag (shared by pool and scheduler
    gauges)."""
    return "".join(c if c.isalnum() else "_" for c in str(name))


class PageAllocator:
    """Free-list allocator over ``num_pages`` pages; page 0 reserved."""

    def __init__(self, num_pages: int, page_size: int,
                 name: str = "serve2"):
        if num_pages < 2:
            raise MXNetError("need at least 2 pages (page 0 is the "
                             "reserved null page)")
        if page_size < 1:
            raise MXNetError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.name = name
        self._lock = threading.Lock()
        # LIFO free list keeps recently-freed pages hot in cache; the
        # shadow set makes the double-free check O(1) per page
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        # refcount per LIVE page (absent = free). free() decrements;
        # the page re-enters the free list only at zero
        self._ref: Dict[int, int] = {}
        # per-engine gauge names: multiple engines in one process must
        # not last-writer-win each other's pool-pressure signal
        tag = _gauge_tag(name)
        self._g_total = _metrics.gauge(
            f"mxserve2_pages_total_{tag}",
            f"KV-cache pages in pool {name!r} (excluding the null page)")
        self._g_free = _metrics.gauge(
            f"mxserve2_pages_free_{tag}",
            f"KV-cache pages currently free in pool {name!r}")
        self._g_total.set(self.num_pages - 1)
        self._g_free.set(len(self._free))

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    def can_alloc(self, n: int) -> bool:
        return self.free_pages >= int(n)

    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` pages or raise :class:`PagePoolExhausted` taking
        none (all-or-nothing, so a failed admit leaks nothing)."""
        n = int(n)
        with self._lock:
            if len(self._free) < n:
                raise PagePoolExhausted(
                    f"pool {self.name!r}: need {n} pages, "
                    f"{len(self._free)} free of {self.num_pages - 1}")
            pages = [self._free.pop() for _ in range(n)]
            self._free_set.difference_update(pages)
            for p in pages:
                self._ref[p] = 1
            self._g_free.set(len(self._free))
        return pages

    def incref(self, pages: List[int]) -> None:
        """Pin already-live pages for an additional holder (prefix-
        cache sharing). All-or-nothing: every id must be live."""
        with self._lock:
            for p in pages:
                if self._ref.get(p, 0) < 1:
                    raise MXNetError(
                        f"incref of page {p} which is not allocated")
            for p in pages:
                self._ref[p] += 1

    def refcount(self, page: int) -> int:
        """Current holders of ``page`` (0 = free / never allocated)."""
        with self._lock:
            return self._ref.get(page, 0)

    def refcounts(self) -> Dict[int, int]:
        """Snapshot of every live page's refcount (servelint audit)."""
        with self._lock:
            return dict(self._ref)

    def free(self, pages: List[int]) -> None:
        """Drop one reference per listed page; pages whose refcount
        reaches zero return to the free list (LIFO). A page may appear
        K times in one call if the caller really holds K references."""
        with self._lock:
            # validate the WHOLE list before touching the free list:
            # free is all-or-nothing like alloc, so a bad id midway
            # (e.g. from an inconsistent block table during crash
            # cleanup) cannot leave the operation half-applied and
            # leak the remaining pages
            drops = Counter()
            for p in pages:
                if not 0 < p < self.num_pages:
                    raise MXNetError(f"freeing invalid page id {p}")
                drops[p] += 1
            for p, n in drops.items():
                if self._ref.get(p, 0) < n:
                    raise MXNetError(
                        f"double free of page {p} "
                        f"(refcount {self._ref.get(p, 0)}, dropping {n})")
            released = []
            for p, n in drops.items():
                self._ref[p] -= n
                if self._ref[p] == 0:
                    del self._ref[p]
                    released.append(p)
            self._free.extend(released)
            self._free_set.update(released)
            self._g_free.set(len(self._free))

    def shared_pages(self) -> int:
        """Live pages with more than one holder (prefix-cache wins)."""
        with self._lock:
            return sum(1 for n in self._ref.values() if n > 1)

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            shared = sum(1 for n in self._ref.values() if n > 1)
        return {"page_size": self.page_size,
                "pages_total": self.num_pages - 1,
                "pages_free": free,
                "pages_used": self.num_pages - 1 - free,
                "pages_shared": shared}

    def gauge_names(self) -> List[str]:
        """This pool's per-engine instrument names — the owning engine
        adopts them onto its owner token."""
        return [self._g_total.name, self._g_free.name]

    def retire_gauges(self) -> None:
        """Unregister this pool's per-engine gauges (engine close)."""
        _metrics.unregister(self._g_total.name)
        _metrics.unregister(self._g_free.name)


class BlockTable:
    """One sequence's page list + logical length.

    ``length`` counts cached positions (prompt + generated tokens whose
    K/V are in the pool). ``row(width)`` renders the fixed-width int32
    row the decode step consumes — unused entries point at the null
    page 0.
    """

    __slots__ = ("pages", "length", "page_size")

    def __init__(self, page_size: int):
        self.pages: List[int] = []
        self.length = 0
        self.page_size = int(page_size)

    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def needs_page(self, extra: int = 1) -> bool:
        """Would caching ``extra`` more positions overflow the pages?"""
        return self.length + int(extra) > self.capacity()

    def row(self, width: int,
            out: Optional[onp.ndarray] = None) -> onp.ndarray:
        if len(self.pages) > width:
            raise MXNetError(
                f"sequence spans {len(self.pages)} pages but the block "
                f"table is {width} wide — raise max_seq_len")
        if out is None:
            out = onp.zeros((width,), "int32")
        else:
            out.fill(0)
        out[:len(self.pages)] = self.pages
        return out

    def __repr__(self):
        return (f"BlockTable(len={self.length}, "
                f"pages={self.pages})")
