"""Paged KV-cache bookkeeping: host-side page allocation for the serving
engine (the port of ``repro.serve.kvcache``).

- :class:`PageAllocator` — per-request page tables, refcounted shared
  pages, a *sorted* free list (lowest page id reused first, so tables are
  reproducible run to run), and a typed :class:`PoolExhausted` that the
  engine turns into admission backpressure.  With ``window`` it keeps
  *ring* tables of ``ring_slots`` pages for sliding-window layers.
- :class:`PagedKVCache` — an allocator with one layer's page arrays on a
  device, copy-on-write ``append`` and the batch tables (``batch_view``).
- :class:`PrefixIndex` — chain-hash -> page id map for prefix caching:
  requests with a common prompt prefix attach the same *full* pages
  read-only.

The engine keeps one allocator per kind of layer; the model's paged cache
holds every layer's pools.  Speculative truncation is not ported yet.
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


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
    point at, so masked writes can never corrupt live data.

    ``window`` makes the allocator a *ring*: a request's table holds at
    most ``ring_slots = ceil(window / page_size) + 1`` pages, indexed by
    ``logical_page % ring_slots``, and growth past the ring *rotates*: the
    trailing page, wholly outside the window because ``ring_slots * page
    >= window + page``, is reused in place, so a windowed sequence's
    footprint is constant however long it runs.  A rotated-onto page that
    is shared (a fork) is split off into a fresh page instead."""

    def __init__(self, num_pages: int, page_size: int, reserved: int = 0,
                 window: Optional[int] = None):
        if reserved >= num_pages:
            raise ValueError("reserved pages exhaust the pool")
        self.num_pages = num_pages
        self.page_size = page_size
        self.reserved = reserved
        self.window = window
        self.kind = "full" if window is None else "ring"
        self.ring_slots = (None if window is None
                           else -(-window // page_size) + 1)
        self.reused = 0       # ring pages reused in place (rotations)
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

    def _ring_growth(self, rid: int, new_len: int) -> List[Tuple[int, int]]:
        """Ring bookkeeping for growing ``rid`` to ``new_len`` tokens:
        ``(logical_page, kind)`` steps, kind 0 = append a fresh page, 1 =
        rotate in place (free), 2 = rotate onto a *shared* page (costs one
        fresh page to split it off)."""
        page, r = self.page_size, self.ring_slots
        hi = (new_len - 1) // page if new_len > 0 else -1
        old = self.lengths[rid]
        old_hi = (old - 1) // page if old > 0 else -1
        table = self.tables[rid]
        nslots = len(table)
        private = set()       # slots whose page is private this round
        steps: List[Tuple[int, int]] = []
        for logical in range(old_hi + 1, hi + 1):
            slot = logical % r
            if slot >= nslots:
                steps.append((logical, 0))
                nslots += 1
            elif slot not in private and self.is_shared(table[slot]):
                steps.append((logical, 2))
            else:
                steps.append((logical, 1))
            private.add(slot)
        return steps

    def can_grow(self, rid: int, new_len: int) -> int:
        """Largest length <= ``new_len`` coverable without exhausting the
        pool (the engine's budget cap under pool pressure)."""
        if self.window is not None:
            old = self.lengths[rid]
            old_hi = (old - 1) // self.page_size if old > 0 else -1
            ok = (old_hi + 1) * self.page_size   # covered by existing pages
            free = len(self.free)
            for logical, kind in self._ring_growth(rid, new_len):
                if kind != 1:
                    if free == 0:
                        break
                    free -= 1
                ok = (logical + 1) * self.page_size
            return min(new_len, ok)
        cap = (len(self.tables[rid]) + len(self.free)) * self.page_size
        return min(new_len, cap)

    def reserve(self, rid: int, new_len: int) -> List[int]:
        """Ensure the table covers ``new_len`` tokens; returns the newly
        allocated page ids.  All-or-nothing: raises :class:`PoolExhausted`
        without partial allocation.  A ring rotates in place past
        ``ring_slots`` pages, reusing the trailing page once the window has
        slid past it."""
        table = self.tables[rid]
        if self.window is not None:
            steps = self._ring_growth(rid, new_len)
            cost = sum(1 for _, kind in steps if kind != 1)
            if cost > len(self.free):
                raise self.exhausted(
                    f"need {cost} ring pages for rid {rid}, only "
                    f"{len(self.free)} free", rid=rid, need=cost)
            fresh: List[int] = []
            for logical, kind in steps:
                slot = logical % self.ring_slots
                if kind == 0:
                    pid = self._take_page()
                    table.append(pid)
                    fresh.append(pid)
                elif kind == 2:     # shared: split off a private page
                    self.ref[table[slot]] -= 1   # shared: never reaches 0
                    pid = self._take_page()
                    table[slot] = pid
                    fresh.append(pid)
                else:           # kind 1: reused in place, no pool traffic
                    self.reused += 1
            self.lengths[rid] = max(self.lengths[rid], new_len)
            return fresh
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
        hit or fork): refcount++ on each, no data copied."""
        table = self.tables[rid]
        if table:
            raise ValueError("attach only onto an empty table")
        if self.ring_slots is not None and len(pages) > self.ring_slots:
            raise ValueError(
                f"attach of {len(pages)} pages exceeds the ring "
                f"({self.ring_slots} slots)")
        for pid in pages:
            self.ref[pid] += 1
            table.append(pid)
        self.lengths[rid] = length

    def fork(self, src: int, dst: int) -> None:
        """Clone ``src``'s table into a new request ``dst`` (parallel
        sampling, beam fork): every page becomes shared, and the first
        divergent write copies it (:meth:`PagedKVCache.append`) or a ring
        rotation splits it off (:meth:`reserve`)."""
        self.alloc(dst)
        self.attach(dst, list(self.tables[src]), self.lengths[src])

    def truncate(self, rid: int, new_len: int) -> List[int]:
        """Roll ``rid`` back to ``new_len`` tokens (speculative rejection):
        trailing pages wholly past the new length are dereferenced, freed
        only when this was their last reference (a shared page is detached,
        never mutated: its stale tail rows are masked by the valid length).
        A ring rotates in place, so only its length rewinds.  Returns the
        page ids returned to the free list."""
        old = self.lengths[rid]
        if new_len > old:
            raise ValueError(
                f"truncate of rid {rid} to {new_len} exceeds its current "
                f"length {old}")
        freed: List[int] = []
        if self.ring_slots is None:
            table = self.tables[rid]
            keep = -(-new_len // self.page_size)
            while len(table) > keep:
                pid = table.pop()
                self.ref[pid] -= 1
                if self.ref[pid] == 0:
                    self._free_page(pid)
                    freed.append(pid)
        self.lengths[rid] = new_len
        return freed

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

    def is_shared(self, pid: int) -> bool:
        return self.ref.get(pid, 0) > 1

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.reserved - len(self.free)

    @property
    def live_tokens(self) -> int:
        return sum(self.lengths.values())


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

    def match_len(self, hashes: Sequence[str],
                  alloc: Optional[PageAllocator] = None) -> int:
        """Length of the longest run of leading hashes this index would
        serve: a pure peek for routing, which drops no entry, so scoring
        a request against many replicas' indexes disturbs none of them.
        With ``alloc`` an entry whose page lost its pin is a miss (it
        could not be attached) and stays in place for :meth:`lookup` or
        :meth:`evict_unused` to reap on the owning engine's schedule."""
        n = 0
        for h in hashes:
            pid = self._by_hash.get(h)
            if pid is None or (alloc is not None and pid not in alloc.pinned):
                break
            n += 1
        return n

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


@dataclass
class PagedKVCache(PageAllocator):
    """One layer's page pool on a device, with its allocator: the
    self-contained variant that kernels and tests drive directly (the
    engine keeps one :class:`PageAllocator` per kind of layer and the model
    holds every layer's pools).  The pool sits on the card unless
    ``device`` names another, like every entry point of the port."""
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "float32"
    reserved: int = 0
    window: Optional[int] = None
    device: Optional[str] = None      # None: the card (resolve_device)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        PageAllocator.__init__(self, self.num_pages, self.page_size,
                               self.reserved, window=self.window)
        shape = (self.num_pages, self.page_size, self.num_kv_heads,
                 self.head_dim)
        dt = getattr(torch, self.dtype)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)

    def _slot(self, logical: int) -> int:
        """Table index of a logical page (itself, or its ring slot)."""
        return (logical if self.ring_slots is None
                else logical % self.ring_slots)

    def _cow(self, rid: int, logical: int) -> int:
        """Copy-on-write: give ``rid`` a private copy of a shared page
        before writing into it.  The shared original is never written."""
        old = self.tables[rid][self._slot(logical)]
        if not self.is_shared(old):
            return old
        new = self._take_page()
        self.k_pages[new] = self.k_pages[old]
        self.v_pages[new] = self.v_pages[old]
        self.ref[old] -= 1          # shared: never reaches 0 here
        self.tables[rid][self._slot(logical)] = new
        return new

    def append(self, rid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append (S, Hkv, D) keys/values for one request.  All-or-nothing:
        the pages it needs (fresh pages and copies of shared pages in the
        write range) are counted before any table or length changes, so
        :class:`PoolExhausted` never leaves a length claiming unwritten
        tokens."""
        s = k.shape[0]
        start = self.lengths[rid]
        table = self.tables[rid]
        end_li = (start + s - 1) // self.page_size
        if self.ring_slots is None:
            need_fresh = max(0, end_li + 1 - len(table))
            in_table = range(start // self.page_size,
                             min(len(table), end_li + 1))
            need_cow = sum(1 for li in in_table if self.is_shared(table[li]))
        else:
            steps = self._ring_growth(rid, start + s)
            need_fresh = sum(1 for _, kind in steps if kind != 1)
            touched = {lg % self.ring_slots for lg, _ in steps}
            old_hi = (start - 1) // self.page_size if start > 0 else -1
            need_cow = sum(
                1 for li in range(start // self.page_size, old_hi + 1)
                if (li % self.ring_slots) not in touched
                and self.is_shared(table[li % self.ring_slots]))
        if need_fresh + need_cow > len(self.free):
            raise self.exhausted(
                f"append of {s} tokens needs {need_fresh} fresh + "
                f"{need_cow} copy-on-write pages, only {len(self.free)} "
                "free", rid=rid, need=need_fresh + need_cow)
        self.reserve(rid, start + s)
        off = 0
        while off < s:
            logical = (start + off) // self.page_size
            slot = (start + off) % self.page_size
            n = min(self.page_size - slot, s - off)
            pid = self._cow(rid, logical)
            self.k_pages[pid, slot:slot + n] = k[off:off + n]
            self.v_pages[pid, slot:slot + n] = v[off:off + n]
            off += n
        self.lengths[rid] = start + s

    def batch_view(self, rids: List[int], width: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(page_table (B, N) int32, valid_len (B,) int32) on the pool's
        device, padded to ``width`` logical pages (default: the widest
        table).  Unused entries point at page 0: reserve it as a null page
        (``reserved=1``) where padded entries may be written through.  A
        ring table is exactly ``ring_slots`` wide, because the kernel maps
        logical page j to slot ``j % width``."""
        if self.ring_slots is not None:
            width = self.ring_slots
        n = width or max(1, max(len(self.tables[r]) for r in rids))
        table = np.zeros((len(rids), n), np.int32)
        for i, r in enumerate(rids):
            pages = self.tables[r]
            table[i, :len(pages)] = pages
        vlen = np.asarray([self.lengths[r] for r in rids], np.int32)
        return (torch.from_numpy(table).to(self.k_pages.device),
                torch.from_numpy(vlen).to(self.k_pages.device))

    @property
    def page_bytes(self) -> int:
        """Device bytes of one page (k + v)."""
        return (2 * self.page_size * self.num_kv_heads * self.head_dim
                * self.k_pages.element_size())
