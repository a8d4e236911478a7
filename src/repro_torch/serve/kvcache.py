"""Paged KV-cache bookkeeping: host-side page allocation for the serving
engine (the port of ``repro.serve.kvcache``, full-attention tables).

- :class:`PageAllocator` — per-request page tables, refcounted shared
  pages, a *sorted* free list (lowest page id reused first, so tables are
  reproducible run to run), and a typed :class:`PoolExhausted` that the
  engine turns into admission backpressure.
- :class:`PrefixIndex` — chain-hash -> page id map for prefix caching:
  requests with a common prompt prefix attach the same *full* pages
  read-only.

Pure Python; the page arrays themselves live in the model's paged cache.
Ring tables for sliding windows, forks and speculative truncation are not
ported yet.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np


class PoolExhausted(MemoryError):
    """No free pages left.  The engine catches this and keeps the request
    queued (backpressure) instead of crashing the serving loop.  Carries
    the pool census at the raise: ``pool``, ``num_pages``, ``free_pages``,
    ``live_pages`` (excluding the reserved null page), and the requester
    ``rid`` / ``need_pages`` when the raise is tied to one request."""

    def __init__(self, msg: str = "", *, pool: str = "full",
                 num_pages: Optional[int] = None,
                 free_pages: Optional[int] = None,
                 live_pages: Optional[int] = None,
                 rid: Optional[int] = None,
                 need_pages: Optional[int] = None):
        self.pool = pool
        self.num_pages = num_pages
        self.free_pages = free_pages
        self.live_pages = live_pages
        self.rid = rid
        self.need_pages = need_pages
        bits = [f"pool={pool}"]
        for name, val in (("pages", num_pages), ("live", live_pages),
                          ("free", free_pages), ("rid", rid),
                          ("need", need_pages)):
            if val is not None:
                bits.append(f"{name}={val}")
        census = f"[{', '.join(bits)}]"
        super().__init__(f"{msg} {census}" if msg else census)


def page_hashes(tokens: np.ndarray, page_size: int) -> List[str]:
    """Chain hashes of the *full* pages of a prompt:
    ``h_i = sha1(h_{i-1} | tokens[i*page:(i+1)*page])``, so a page hash
    identifies the whole prefix up to and including that page and a flat
    dict lookup implements longest-prefix matching."""
    toks = np.asarray(tokens, np.int64)
    out: List[str] = []
    h = b""
    for i in range(len(toks) // page_size):
        chunk = toks[i * page_size:(i + 1) * page_size]
        h = hashlib.sha1(h + chunk.tobytes()).digest()
        out.append(h.hex())
    return out


class PageAllocator:
    """Host-side page bookkeeping shared by every layer's page pool.

    Page ids index the same slot in each layer's pool, so one table serves
    the whole stack.  ``reserved`` ids (0..reserved-1) are never allocated:
    the engine reserves page 0 as the *null page* that padded table entries
    point at, so masked writes can never corrupt live data."""

    kind = "full"

    def __init__(self, num_pages: int, page_size: int, reserved: int = 0):
        if reserved >= num_pages:
            raise ValueError("reserved pages exhaust the pool")
        self.num_pages = num_pages
        self.page_size = page_size
        self.reserved = reserved
        self.free: List[int] = list(range(reserved, num_pages))  # kept sorted
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.ref: Dict[int, int] = {}
        # pages holding a prefix-index reference, so eviction can tell "my
        # pin keeps this alive" from "the pool re-issued this id"
        self.pinned: set = set()

    def alloc(self, rid: int) -> None:
        if rid in self.tables:
            raise ValueError(f"rid {rid} already allocated")
        self.tables[rid] = []
        self.lengths[rid] = 0

    def exhausted(self, msg: str, rid: Optional[int] = None,
                  need: Optional[int] = None) -> PoolExhausted:
        """A :class:`PoolExhausted` pre-filled with this pool's census."""
        return PoolExhausted(msg, pool=self.kind, num_pages=self.num_pages,
                             free_pages=len(self.free),
                             live_pages=self.pages_in_use,
                             rid=rid, need_pages=need)

    def _take_page(self) -> int:
        if not self.free:
            raise self.exhausted(
                f"KV page pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} tokens)", need=1)
        pid = self.free.pop(0)  # lowest id first: deterministic reuse order
        self.ref[pid] = 1
        return pid

    def _free_page(self, pid: int) -> None:
        if pid in self.pinned:
            # reaching zero on a pinned page means a refcount underflow on a
            # shared prefix page; freeing it would hand an indexed page to
            # the next reserve and serve foreign KV rows
            raise RuntimeError(
                f"page {pid} freed while pinned by the prefix index "
                "(refcount underflow on a shared prefix page)")
        bisect.insort(self.free, pid)
        del self.ref[pid]

    def can_grow(self, rid: int, new_len: int) -> int:
        """Largest length <= ``new_len`` coverable without exhausting the
        pool (the engine's budget cap under pool pressure)."""
        cap = (len(self.tables[rid]) + len(self.free)) * self.page_size
        return min(new_len, cap)

    def reserve(self, rid: int, new_len: int) -> List[int]:
        """Ensure the table covers ``new_len`` tokens; returns the newly
        allocated page ids.  All-or-nothing: raises :class:`PoolExhausted`
        without partial allocation."""
        table = self.tables[rid]
        grow = -(-new_len // self.page_size) - len(table)
        if grow > len(self.free):
            raise self.exhausted(
                f"need {grow} pages for rid {rid}, only {len(self.free)} "
                "free", rid=rid, need=grow)
        fresh = [self._take_page() for _ in range(max(0, grow))]
        table.extend(fresh)
        self.lengths[rid] = max(self.lengths[rid], new_len)
        return fresh

    def attach(self, rid: int, pages: Sequence[int], length: int) -> None:
        """Share existing pages into ``rid``'s empty table (prefix-cache
        hit): refcount++ on each, no data copied."""
        table = self.tables[rid]
        if table:
            raise ValueError("attach only onto an empty table")
        for pid in pages:
            self.ref[pid] += 1
            table.append(pid)
        self.lengths[rid] = length

    def release(self, rid: int) -> None:
        """Drop the request's pages; a page returns to the sorted free list
        when its last reference goes.  Unknown or double release raises."""
        if rid not in self.tables:
            raise KeyError(f"release of unknown rid {rid} (double release?)")
        for pid in self.tables.pop(rid):
            self.ref[pid] -= 1
            if self.ref[pid] == 0:
                self._free_page(pid)
        del self.lengths[rid]

    # -- prefix-index pinning ------------------------------------------
    def pin(self, pid: int) -> None:
        """Extra reference held by the prefix index: the page outlives its
        owning request so later prompts can share it."""
        if pid not in self.ref:
            raise KeyError(f"pin of unallocated page {pid}")
        if pid in self.pinned:
            raise ValueError(f"page {pid} already pinned")
        self.ref[pid] += 1
        self.pinned.add(pid)

    def unpin(self, pid: int) -> None:
        if pid not in self.pinned:
            # a stale index entry whose page was freed and re-issued must
            # not decref the new owner's only reference
            raise KeyError(f"unpin of page {pid} that holds no pin")
        self.pinned.discard(pid)
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free_page(pid)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.reserved - len(self.free)


class PrefixIndex:
    """Chain-hash -> page id.  Policy lives in the engine: it pins pages on
    register and evicts unused entries under pool pressure."""

    def __init__(self):
        self._by_hash: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._by_hash)

    def lookup(self, hashes: Sequence[str],
               alloc: Optional[PageAllocator] = None) -> List[int]:
        """Longest run of leading hashes present; returns their page ids.
        With ``alloc`` an entry whose page lost its pin (freed, perhaps
        re-issued) is a miss and is dropped on the spot."""
        pages: List[int] = []
        for h in hashes:
            pid = self._by_hash.get(h)
            if pid is not None and alloc is not None \
                    and pid not in alloc.pinned:
                del self._by_hash[h]
                pid = None
            if pid is None:
                break
            pages.append(pid)
        return pages

    def register(self, h: str, pid: int) -> bool:
        """Idempotent: the first page registered for a hash wins (identical
        content by construction)."""
        if h in self._by_hash:
            return False
        self._by_hash[h] = pid
        return True

    def evict_unused(self, alloc: PageAllocator) -> int:
        """Drop every entry whose page only the index's pin keeps alive
        (pinned and ref == 1); entries whose page lost its pin are dropped
        without touching refcounts.  Returns the number of pages freed."""
        freed = 0
        for h, pid in list(self._by_hash.items()):
            if pid not in alloc.pinned:
                del self._by_hash[h]
                continue
            if alloc.ref.get(pid) == 1:
                del self._by_hash[h]
                alloc.unpin(pid)
                freed += 1
        return freed
