"""Prefix cache: content-addressed KV pages shared across sequences.

Counterpart of ``mxnet_tpu/serve2/prefix.py``; host-only (hashlib). The
keys are byte-equal to the JAX package's.

At "millions of users" scale most LM traffic shares templated system
prompts, so the dominant serving cost is re-prefilling (and re-storing)
identical prompt prefixes. This module makes FULL pages of the KV pool
content-addressed: a page holding positions ``[i*page_size,
(i+1)*page_size)`` of some token stream is keyed by the **chain hash**
of everything up to and including those tokens —

    key_0 = H(salt || tokens[0:page])
    key_i = H(key_{i-1} || tokens[i*page:(i+1)*page])

so a key identifies not just a page's own tokens but the whole prefix
that produced its K/V (attention makes page content depend on every
earlier position). Two requests whose prompts agree for ``k`` full
pages therefore map to the same ``k`` physical pages, and the second
request's prefill only computes the uncovered suffix
(:meth:`~mxnet_tpu_torch.serve2.decode.PagedLM.prefill_ext`).

Ownership protocol (the refcount discipline servelint audits):

- the cache itself holds ONE reference on every page it indexes, taken
  at :meth:`register` — so cached pages survive the sequence that
  created them;
- :meth:`lookup` increfs each hit on behalf of the requesting sequence
  before returning, so a hit can never race a concurrent release;
- :meth:`evict` walks LRU order dropping cache references until enough
  pages actually return to the free list — a page another sequence
  still holds leaves the index but frees nothing yet;
- shared pages are READ-ONLY: the scheduler copy-on-writes before any
  in-place write into a page with refcount > 1.

Only full pages are ever registered; the partial tail page of a prompt
is always private to its sequence, which is what makes the
"decode never writes a shared page" invariant structural rather than
checked (writes land at ``pos >= length >=`` the shared prefix, and the
shared prefix is whole pages).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from .kvcache import PageAllocator

__all__ = ["PrefixCache", "page_keys"]


def page_keys(tokens: Sequence[int], page_size: int,
              salt: bytes = b"mxserve3") -> List[bytes]:
    """Chain-hash keys for every FULL page of ``tokens``.

    ``salt`` namespaces the chain (one cache per engine already scopes
    keys to one model's params, but a salt keeps accidental cross-model
    reuse impossible if callers ever share a cache)."""
    page = int(page_size)
    n_full = len(tokens) // page
    keys: List[bytes] = []
    prev = salt
    for i in range(n_full):
        chunk = tokens[i * page:(i + 1) * page]
        h = hashlib.sha1(prev)
        h.update(b"|")
        h.update(",".join(str(int(t)) for t in chunk).encode())
        prev = h.digest()
        keys.append(prev)
    return keys


class PrefixCache:
    """key -> physical page index over one engine's PageAllocator.

    ``capacity_pages`` bounds how many pages the cache may pin
    (0 = no explicit cap; the pool itself still bounds it — eviction
    under pool pressure is driven by the scheduler via :meth:`evict`).
    """

    def __init__(self, alloc: PageAllocator,
                 capacity_pages: int = 0):
        self.alloc = alloc
        self.capacity_pages = int(capacity_pages)
        self._lock = threading.Lock()
        # insertion/LRU order: move_to_end on hit, popitem(last=False)
        # on eviction
        self._pages: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0          # lookups that reused >= 1 page
        self.misses = 0        # lookups that reused none
        self.pages_reused = 0  # total pages handed out by lookup
        self.tokens_avoided = 0  # prefill positions lookup saved
        self.evictions = 0

    # ------------------------------------------------------------------
    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Longest cached prefix of ``keys`` — returns the page ids,
        ALREADY increfed for the caller (the caller owns one reference
        per returned page and must ``alloc.free`` them like any other
        block-table page). Counts NO hit statistics — a lookup whose
        admission then fails on pool pressure is retried every
        scheduler tick, and phantom per-retry hits would swamp the
        stats; call :meth:`record_admission` once the admission
        actually lands."""
        with self._lock:
            hit: List[int] = []
            for k in keys:
                p = self._pages.get(k)
                if p is None:
                    break
                hit.append(p)
                self._pages.move_to_end(k)
            if hit:
                # incref BEFORE returning: between this lock release
                # and the caller threading the pages into its block
                # table, an evict() may drop the cache's own reference
                # — the caller's reference keeps the page alive
                self.alloc.incref(hit)
            return hit

    def record_admission(self, pages_reused: int,
                         tokens_avoided: Optional[int] = None) -> None:
        """Fold one SUCCESSFUL admission into the hit statistics.
        ``tokens_avoided`` lets the caller report the EXACT prefill
        positions saved (a fully-covered CoW admission recomputes one
        position, so pages * page_size would overcount by 1); default
        is the whole-pages estimate."""
        with self._lock:
            if pages_reused > 0:
                self.hits += 1
                self.pages_reused += int(pages_reused)
                self.tokens_avoided += int(
                    tokens_avoided if tokens_avoided is not None
                    else pages_reused * self.alloc.page_size)
            else:
                self.misses += 1

    def register(self, keys: Sequence[bytes],
                 pages: Sequence[int]) -> int:
        """Index ``pages[i]`` under ``keys[i]`` (one cache reference
        each). Keys already present keep their existing page — the
        caller's identical copy stays private. Returns how many new
        entries landed."""
        if len(keys) != len(pages):
            raise MXNetError(
                f"register: {len(keys)} keys vs {len(pages)} pages")
        added = 0
        with self._lock:
            for k, p in zip(keys, pages):
                if k in self._pages:
                    continue
                self.alloc.incref([p])
                self._pages[k] = p
                added += 1
            over = (len(self._pages) - self.capacity_pages
                    if self.capacity_pages else 0)
        if over > 0:
            # capacity is an ENTRY budget: drop exactly `over` LRU
            # entries. NOT evict() — that counts pages actually freed,
            # and with every cached page still shared by a live
            # sequence it would spin through (and flush) the whole
            # index without ever freeing one.
            self._drop_lru(over)
        return added

    def _drop_lru(self, n_entries: int) -> int:
        """Drop up to ``n_entries`` LRU index entries (one cache
        reference each); returns how many of their pages actually
        returned to the free list."""
        freed = 0
        for _ in range(int(n_entries)):
            with self._lock:
                if not self._pages:
                    break
                _, p = self._pages.popitem(last=False)
                self.evictions += 1
            before = self.alloc.refcount(p)
            self.alloc.free([p])
            if before == 1:
                freed += 1
        return freed

    def evict(self, n_pages: int) -> int:
        """Drop LRU entries until ``n_pages`` pages actually returned
        to the free list (or the cache is empty) — the POOL-pressure
        eviction path. Dropping an entry a live sequence still shares
        releases the cache's reference but frees nothing — those don't
        count toward ``n_pages``. Returns the number of pages actually
        freed."""
        freed = 0
        while freed < int(n_pages):
            with self._lock:
                if not self._pages:
                    break
            got = self._drop_lru(1)
            freed += got
        return freed

    def release_all(self) -> None:
        """Drop every cache reference (engine close)."""
        with self._lock:
            pages = list(self._pages.values())
            self._pages.clear()
        if pages:
            self.alloc.free(pages)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)

    def cached_pages(self) -> List[int]:
        """Page ids currently pinned by the cache (servelint audit)."""
        with self._lock:
            return list(self._pages.values())

    def find(self, key: bytes) -> Optional[int]:
        with self._lock:
            return self._pages.get(key)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            size = len(self._pages)
        return {"entries": size, "hits": self.hits,
                "misses": self.misses,
                "pages_reused": self.pages_reused,
                "tokens_avoided": self.tokens_avoided,
                "evictions": self.evictions}
