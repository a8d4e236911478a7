"""Continuous-batching serving engine over a paged KV cache, greedy.

The port of ``repro.serve.engine.ServeEngine`` with its paged backend:
slot-based scheduling over a fixed decode batch, each slot one request at
its own position.  Prefill appends k/v into fixed-size pages in chunks (a
long prompt never stalls the decode tick), decode runs the
``paged_attention`` kernel against a device-resident (batch, max_pages)
table, and finished requests release their pages at once, so admission is
bounded by live tokens.  Prompts sharing a prefix share read-only pages
(chain-hashed prefix cache); pool exhaustion is backpressure (requests stay
queued), never a crash.

``decode_many(n)`` runs up to n decode ticks as one window: a Python loop
of device steps with per-slot budgets masked on the device (a masked slot
keeps its token and position, and writes ``-1`` into the window's output),
tokens and positions staying on the device, and one host sync per window
when the token block is read back.

Not ported yet: preemption and the host tier, speculative decoding,
sampling beyond greedy, tensor/data parallelism, the dense backend, ring
pages for sliding windows, int8 KV.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.registry import ModelBundle
from repro_torch.serve.kvcache import (PageAllocator, PoolExhausted,
                                       PrefixIndex, page_hashes)
from repro_torch.serve.sampling import select_greedy
from repro_torch.tune.plan import derive_paged_plan, next_pow2


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


@dataclass
class ServeStats:
    prefills: int = 0                # requests fully prefilled
    decode_steps: int = 0            # device decode ticks executed
    tokens_out: int = 0
    decode_dispatches: int = 0       # decode windows (one host sync each)
    prefill_chunks: int = 0          # chunked-prefill steps
    prompt_tokens: int = 0           # prompt tokens admitted
    prefix_hit_tokens: int = 0       # prompt tokens served from shared pages
    pages_peak: int = 0              # peak pages_in_use over the run
    pool_stalls: int = 0             # admissions deferred by PoolExhausted


class ServeEngine:
    """Continuous-batching engine over the paged KV cache, greedy.

    ``window`` is the decode window: ``run_to_completion`` advances every
    active slot up to ``window`` tokens per host sync.  Prefill chunks pad
    to the next power of two (right padding is masked in a full-attention
    stack).  ``page_size=None`` derives the page from
    the pool's dtype and head width (:func:`repro_torch.tune.
    derive_paged_plan`); ``num_pages=None`` sizes the pool at the dense
    footprint plus the reserved null page — shrink it to admit by live
    tokens and exercise backpressure.  ``prefill_chunk`` caps prompt tokens
    per prefill step.  ``device`` is ``cuda`` unless named; it must be the
    bundle's device."""

    def __init__(self, bundle: ModelBundle, params, batch_size: int,
                 max_len: int, *, window: int = 8,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: int = 32,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        if bundle.device != self.device:
            raise ValueError(f"the bundle runs on {bundle.device}, the "
                             f"engine on {self.device}")
        self.bundle = bundle
        self.params = params
        self.bsz = batch_size
        self.max_len = max_len
        self.window = max(1, window)
        cfg = bundle.cfg
        self.plan = derive_paged_plan(max_len=max_len,
                                      head_dim=cfg.resolved_head_dim,
                                      dtype=cfg.compute_dtype)
        self.page = int(page_size or self.plan.page_size)
        self.pages_per_seq = -(-max_len // self.page)
        self.num_pages = int(num_pages or 1 + batch_size * self.pages_per_seq)
        self.prefill_chunk = max(8, prefill_chunk)
        self._init_state()

    def _init_state(self) -> None:
        dev = self.device
        self.pos = torch.zeros((self.bsz,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((self.bsz, 1), dtype=torch.int64, device=dev)
        self._hpos = np.zeros((self.bsz,), np.int64)       # host mirror
        self.slots: List[Optional[Request]] = [None] * self.bsz
        self.queue: List[Request] = []
        self.stats = ServeStats()
        self.alloc = PageAllocator(self.num_pages, self.page, reserved=1)
        self.prefix = PrefixIndex()
        self.cache = self.bundle.init_paged_cache(self.num_pages, self.page)
        self._htable = np.zeros((self.bsz, self.pages_per_seq), np.int32)
        self._sync_table()
        self._pending: Dict[int, int] = {}       # slot -> next prefill offset
        self._hashes: Dict[int, List[str]] = {}  # rid -> full-page hashes

    def reset(self) -> None:
        """Clear all serving state: cache, pool, prefix index, slots, queue
        and stats (benchmarks drain once to warm up, reset, then time a
        steady-state drain)."""
        self._init_state()

    def _sync_table(self) -> None:
        """Publish the host table mirror as the device table."""
        self._table = torch.as_tensor(self._htable).to(self.device)
        self._table_dirty = False

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _track_peaks(self) -> None:
        self.stats.pages_peak = max(self.stats.pages_peak,
                                    self.alloc.pages_in_use)

    # ------------------------------------------------------------------
    # admission + chunked prefill
    # ------------------------------------------------------------------
    def _paged_admit_slot(self, slot: int, req: Request) -> None:
        """Attach the cached prompt prefix (shared read-only pages), then
        reserve pages for the whole prompt — all or nothing, so admission
        either sticks or backs off cleanly (:class:`PoolExhausted`)."""
        prompt = req.prompt
        s = int(prompt.shape[0])
        if s > self.max_len:
            raise ValueError(f"prompt ({s}) exceeds max_len ({self.max_len})")
        need = -(-s // self.page)
        if need > self.num_pages - 1:
            # no amount of backpressure can admit this one; waiting would
            # drop it silently and block the queue behind it
            raise ValueError(
                f"prompt needs {need} pages ({s} tokens) but the pool holds "
                f"only {self.num_pages - 1}; raise num_pages")
        hit_len = 0
        self.alloc.alloc(req.rid)
        hashes = page_hashes(prompt, self.page)
        # at most (s-1) tokens: the last token must be computed so the final
        # chunk yields the logits that seed decoding
        usable = (s - 1) // self.page
        pages = self.prefix.lookup(hashes[:usable], alloc=self.alloc)
        if pages:
            hit_len = len(pages) * self.page
            self.alloc.attach(req.rid, pages, hit_len)
        try:
            try:
                self.alloc.reserve(req.rid, s)
            except PoolExhausted:
                if not self.prefix.evict_unused(self.alloc):
                    raise
                self.alloc.reserve(req.rid, s)
        except PoolExhausted:
            self.alloc.release(req.rid)
            raise
        self._hashes[req.rid] = hashes
        self.slots[slot] = req
        self._pending[slot] = hit_len
        self._hpos[slot] = 0
        self.stats.prompt_tokens += s
        self.stats.prefix_hit_tokens += hit_len
        self._track_peaks()
        # the batch table row stays null until prefill completes: masked
        # decode ticks must not write through a half-built row

    def _prefill_tick(self, slot: int) -> None:
        """Advance one pending slot by ONE chunk (<= prefill_chunk tokens)."""
        req = self.slots[slot]
        prompt = req.prompt
        s = int(prompt.shape[0])
        off = self._pending[slot]
        c = min(self.prefill_chunk, s - off)
        cb = min(next_pow2(max(8, c)), self.prefill_chunk)
        chunk = np.zeros((1, cb), np.int64)
        chunk[0, :c] = prompt[off:off + c]
        row = self.alloc.tables[req.rid]
        trow = np.zeros((1, self.pages_per_seq), np.int32)
        trow[0, :len(row)] = row
        dev = self.device
        self.cache, logits = self.bundle.paged_prefill_chunk(
            self.params, self.cache, torch.as_tensor(chunk).to(dev),
            torch.tensor([off], dtype=torch.int32).to(dev),
            torch.as_tensor(trow).to(dev),
            torch.tensor([c], dtype=torch.int32).to(dev))
        self.stats.prefill_chunks += 1
        off += c
        if off < s:
            self._pending[slot] = off
            return
        # prompt complete: register its full pages, seed decoding, publish
        # the table row
        del self._pending[slot]
        for i, h in enumerate(self._hashes.pop(req.rid)):
            if self.prefix.register(h, row[i]):
                self.alloc.pin(row[i])
        self._htable[slot, :] = 0
        self._htable[slot, :len(row)] = row
        self._table_dirty = True
        self.pos[slot] = s
        self._hpos[slot] = s
        tok0 = int(select_greedy(logits)[0])
        req.out_tokens.append(tok0)
        self.stats.tokens_out += 1
        self.tokens[slot, 0] = tok0
        self.stats.prefills += 1

    def _admit(self) -> None:
        """FIFO admission into free slots (backpressure on a full pool),
        then one prefill chunk for every pending slot, lowest slot first."""
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            try:
                self._paged_admit_slot(slot, self.queue[0])
            except PoolExhausted:
                # backpressure: the request stays queued; pages free as
                # in-flight requests finish
                self.stats.pool_stalls += 1
                break
            self.queue.pop(0)
        for slot in sorted(self._pending):
            self._prefill_tick(slot)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _budgets(self, n: int) -> np.ndarray:
        """Per-slot token budget for an n-tick window: remaining request
        quota, capped by the cache length guard.  Pending-prefill slots sit
        at zero until their prompt completes."""
        budgets = np.zeros((self.bsz,), np.int64)
        for i, req in enumerate(self.slots):
            if req is None or i in self._pending:
                continue
            remaining = req.max_new_tokens - len(req.out_tokens)
            cap = self.max_len - 1 - self._hpos[i]
            budgets[i] = max(0, min(remaining, cap, n))
        return budgets

    def _reserve_window_pages(self, budgets: np.ndarray) -> np.ndarray:
        """Pre-allocate pages covering each slot's window budget (allocation
        is host-side; the decode loop must never need a page).  Pool
        pressure shrinks budgets, possibly to zero (the slot waits), after
        evicting prefix-cache pages nothing references.  Returns the slots
        the pool blocked outright."""
        blocked = np.zeros((self.bsz,), bool)
        for i, req in enumerate(self.slots):
            if req is None or budgets[i] == 0:
                continue
            target = int(self._hpos[i] + budgets[i])
            feasible = self.alloc.can_grow(req.rid, target)
            if feasible < target:
                self.prefix.evict_unused(self.alloc)
                feasible = self.alloc.can_grow(req.rid, target)
            grant = max(0, feasible - int(self._hpos[i]))
            if grant < budgets[i]:
                budgets[i] = grant
                blocked[i] = grant == 0
            if budgets[i] > 0:
                fresh = self.alloc.reserve(req.rid,
                                           int(self._hpos[i] + budgets[i]))
                if fresh:
                    row = self.alloc.tables[req.rid]
                    self._htable[i, :len(row)] = row
                    self._table_dirty = True
        self._track_peaks()
        return blocked

    def _decode_window(self, n: int, steps: torch.Tensor) -> torch.Tensor:
        """n decode ticks on the device.  ``steps`` (B,) caps each slot:
        past its budget a slot is masked — its token and position freeze,
        and its cache write re-stores the same k/v at the frozen position
        (or lands on the null page for a retired row).  Returns the (n, B)
        token block, -1 where masked."""
        out = torch.full((n, self.bsz), -1, dtype=torch.int64,
                         device=self.device)
        for i in range(n):
            act = steps > i
            logits, self.cache = self.bundle.paged_decode_step(
                self.params, self.cache, self.tokens, self.pos, self._table)
            nxt = select_greedy(logits)
            self.tokens = torch.where(act[:, None], nxt[:, None], self.tokens)
            self.pos = torch.where(act, self.pos + 1, self.pos)
            out[i] = torch.where(act, nxt, -1)
        return out

    def decode_many(self, n: int) -> int:
        """Run up to ``n`` decode ticks as one window (per-slot budgets
        masked on the device), then read the token block back with a single
        host sync.  Returns the number of tokens produced."""
        budgets = self._budgets(n)
        blocked = self._reserve_window_pages(budgets)
        retired = 0
        for i, req in enumerate(self.slots):
            if req is None or budgets[i] != 0 or blocked[i] \
                    or i in self._pending:
                continue
            # done already (a budget of 1 is met by prefill) or pinned at
            # the cache-length guard: retire now, or it never frees
            self._release_finished(i)
            retired += 1
        if retired and blocked.any():
            # retired slots returned pages: pool-blocked slots retry
            budgets = self._budgets(n)
            blocked = self._reserve_window_pages(budgets)
        top = int(budgets.max(initial=0))
        if top == 0:
            if blocked.any() and not self._pending:
                raise PoolExhausted(
                    "every active slot is pool-blocked and nothing can free "
                    "pages: the pool is smaller than the live working set",
                    pool="engine", num_pages=self.num_pages,
                    live_pages=self.alloc.pages_in_use,
                    free_pages=len(self.alloc.free))
            return 0
        n_run = min(n, next_pow2(top))
        if self._table_dirty:
            self._sync_table()
        steps = torch.as_tensor(np.minimum(budgets, n_run).astype(np.int32)
                                ).to(self.device)
        out = self._decode_window(n_run, steps)
        self.stats.decode_steps += n_run
        self.stats.decode_dispatches += 1

        out_np = out.cpu().numpy()  # (n_run, B): the window's one host sync
        produced = 0
        for i, req in enumerate(self.slots):
            if req is None or i in self._pending:
                continue
            adv = int(min(budgets[i], n_run))
            req.out_tokens.extend(int(t) for t in out_np[:adv, i])
            self._hpos[i] += adv
            produced += adv
            if req.done or self._hpos[i] >= self.max_len - 1:
                self._release_finished(i)
        self.stats.tokens_out += produced
        return produced

    def _release_finished(self, i: int) -> None:
        """Retire slot ``i``: its pages go back to the pool at once
        (prefix-pinned ones persist for future hits) and its table row
        reverts to the null page so masked writes stay harmless."""
        req = self.slots[i]
        self.slots[i] = None
        self.alloc.release(req.rid)
        self._hashes.pop(req.rid, None)
        self._htable[i, :] = 0
        self._table_dirty = True

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit queued requests and run one decode tick; False when idle."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return False
        self.decode_many(1)
        return True

    def run_to_completion(self, max_ticks: int = 10_000) -> ServeStats:
        """Serve until queue and slots drain; ``max_ticks`` bounds the
        decode ticks executed."""
        start = self.stats.decode_steps
        while self.stats.decode_steps - start < max_ticks:
            self._admit()
            if not any(s is not None for s in self.slots):
                break
            # every round makes progress: _admit advances each pending
            # prefill one chunk, decode_many produces tokens or retires
            # zero-budget slots
            self.decode_many(self.window)
        return self.stats
