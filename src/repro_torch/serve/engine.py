"""Continuous-batching serving engine over a dense or a paged KV cache,
greedy.

The port of ``repro.serve.engine.ServeEngine`` with its two backends:
slot-based scheduling over a fixed decode batch, each slot one request at
its own position.

- ``paged`` (the default): prefill appends k/v into fixed-size pages in
  chunks (a long prompt never stalls the decode tick), decode runs the
  ``paged_attention`` kernel against a device-resident (batch, max_pages)
  table, and finished requests release their pages at once, so admission
  is bounded by live tokens.  Prompts sharing a prefix share read-only
  pages (chain-hashed prefix cache); pool exhaustion is backpressure
  (requests stay queued), never a crash.
- ``dense``: the per-slot ``(batch, max_len)`` cache.  A request's whole
  prompt is prefilled in one step (right-padded to a power-of-two bucket;
  with ``attn_impl="pallas"`` through the ``flash_attention`` kernel) and
  its cache is written into the slot's rows; decode attends over the
  slot's rows up to its position.

``decode_many(n)`` runs up to n decode ticks as one window: a Python loop
of device steps with per-slot budgets masked on the device (a masked slot
keeps its token and position, and writes ``-1`` into the window's output),
tokens and positions staying on the device, and one host sync per window
when the token block is read back.

Sliding-window layers keep a *ring* of ``ceil(window/page)+1`` pages per
request in a pool of their own (a second allocator and a ring table that
K1 reads as ``logical % ring_slots``), rotating the trailing page in place
as the window slides past it; prefix sharing serves only stacks without
windowed layers, as in the reference.  ``kv_dtype="int8"`` stores int8
pools with float32 scale lanes, and its derived page holds as many tokens
as the int8 row width allows.

Not ported yet: preemption and the host tier, speculative decoding,
sampling beyond greedy, tensor/data parallelism, CUDA-graph capture of the
decode window.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN
from repro_torch.models.registry import ModelBundle
from repro_torch.models.transformer import SENTINEL
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
    prefill_retraces: int = 0        # distinct prefill shapes met
    prompt_tokens: int = 0           # prompt tokens admitted
    prefix_hit_tokens: int = 0       # prompt tokens served from shared pages
    pages_peak: int = 0              # peak full-pool pages_in_use
    ring_pages_peak: int = 0         # peak ring-pool pages_in_use (windowed)
    ring_pages_reused: int = 0       # ring pages rotated and reused in place
    pool_stalls: int = 0             # admissions deferred by PoolExhausted


class ServeEngine:
    """Continuous-batching engine over a dense or paged KV cache, greedy.

    ``window`` is the decode window: ``run_to_completion`` advances every
    active slot up to ``window`` tokens per host sync.  ``bucket_prompts``
    pads dense prompts / paged prefill chunks to the next power of two
    (default: on for full-attention stacks, where right padding is masked;
    every stack the port accepts is one).  ``cache_backend`` is
    ``"dense"``, ``"paged"``, or ``None`` (paged wherever
    :meth:`ModelBundle.paged_supported` allows).

    Paged knobs: ``page_size=None`` derives the page from the pool's dtype
    and head width (:func:`repro_torch.tune.derive_paged_plan`);
    ``num_pages=None`` sizes the full-attention pool at the dense
    footprint plus the reserved null page — shrink it to admit by live
    tokens and exercise backpressure.  ``num_ring_pages=None`` sizes the
    windowed layers' ring pool at ``batch x (ceil(window/page)+1)`` pages
    plus the null page, the bound however long windowed sequences run.
    ``prefill_chunk`` caps prompt tokens per prefill step.  ``device`` is
    ``cuda`` unless named; it must be the bundle's device."""

    def __init__(self, bundle: ModelBundle, params, batch_size: int,
                 max_len: int, *, window: int = 8,
                 bucket_prompts: Optional[bool] = None,
                 cache_backend: Optional[str] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 num_ring_pages: Optional[int] = None,
                 prefill_chunk: int = 32,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        if bundle.device != self.device:
            raise ValueError(f"the bundle runs on {bundle.device}, the "
                             f"engine on {self.device}")
        if cache_backend is None:
            cache_backend = "paged" if bundle.paged_supported() else "dense"
        elif cache_backend not in ("dense", "paged"):
            raise ValueError(f"unknown cache_backend {cache_backend!r}")
        elif cache_backend == "paged" and not bundle.paged_supported():
            raise ValueError(f"{bundle.cfg.name}: the paged KV backend does "
                             "not serve this stack")
        self.backend = cache_backend
        self.bundle = bundle
        self.params = params
        self.bsz = batch_size
        self.max_len = max_len
        self.window = max(1, window)
        cfg = bundle.cfg
        self.bucket_prompts = (self._bucketable(cfg) if bucket_prompts is None
                               else bucket_prompts)
        if self.backend == "paged":
            specs = tuple(cfg.layer_pattern) + tuple(cfg.remainder_specs)
            self.has_full = any(s.sliding_window is None for s in specs)
            windows = [s.sliding_window for s in specs
                       if s.sliding_window is not None]
            # the ring is sized by the largest window (smaller ones mask
            # more); a window past max_len holds everything
            self.attn_window = (min(max(windows), max_len) if windows
                                else None)
            # int8 pages halve the row, so the derived page (rows of at
            # least 512 bytes) holds more tokens: plan from the stored dtype
            self.plan = derive_paged_plan(max_len=max_len,
                                          head_dim=cfg.resolved_head_dim,
                                          dtype=self.kv_store_dtype)
            self.page = int(page_size or self.plan.page_size)
            self.pages_per_seq = (-(-max_len // self.page) if self.has_full
                                  else 0)
            self.ring_slots = (-(-self.attn_window // self.page) + 1
                               if self.attn_window is not None else 0)
            self.num_pages = int(num_pages
                                 or 1 + batch_size * self.pages_per_seq)
            self.num_ring_pages = int(num_ring_pages
                                      or 1 + batch_size * self.ring_slots)
            self.prefill_chunk = max(8, prefill_chunk)
            # prefix pages are reusable only when every layer reads them:
            # a ring rotates prefix tokens away
            self.prefix_sharing = self.has_full and not windows
        # prefill shapes met so far (dense prompt buckets, paged chunk
        # buckets); survives reset(), as the reference's compiled shapes do
        self._seen_prefill_shapes: set = set()
        self._init_state()

    def _init_state(self) -> None:
        dev = self.device
        self.pos = torch.zeros((self.bsz,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((self.bsz, 1), dtype=torch.int64, device=dev)
        self._hpos = np.zeros((self.bsz,), np.int64)       # host mirror
        self.slots: List[Optional[Request]] = [None] * self.bsz
        self.queue: List[Request] = []
        self.stats = ServeStats()
        self._pending: Dict[int, int] = {}   # slot -> next prefill offset
        if self.backend == "dense":
            self.cache = self.bundle.init_cache(self.bsz, self.max_len)
            return
        self.alloc = (PageAllocator(self.num_pages, self.page, reserved=1)
                      if self.has_full else None)
        self.ralloc = (PageAllocator(self.num_ring_pages, self.page,
                                     reserved=1, window=self.attn_window)
                       if self.attn_window is not None else None)
        self.prefix = PrefixIndex() if self.prefix_sharing else None
        self.cache = self.bundle.init_paged_cache(
            self.num_pages if self.has_full else 1, self.page,
            ring_pages=self.num_ring_pages)
        self._htable = np.zeros((self.bsz, max(1, self.pages_per_seq)),
                                np.int32)
        # a ring table is exactly ring_slots wide: K1 maps logical page j
        # to slot j % width
        self._hrtable = np.zeros((self.bsz, max(1, self.ring_slots)),
                                 np.int32)
        self._sync_table()
        self._hashes: Dict[int, List[str]] = {}  # rid -> full-page hashes

    def reset(self) -> None:
        """Clear all serving state: cache, pool, prefix index, slots, queue
        and stats (benchmarks drain once to warm up, reset, then time a
        steady-state drain).  The prefill shapes already met stay met, so
        a warm drain counts only new ones."""
        self._init_state()

    def _sync_table(self) -> None:
        """Publish the host table mirrors as the device tables."""
        self._table = dict(full=torch.as_tensor(self._htable).to(self.device),
                           ring=torch.as_tensor(self._hrtable).to(self.device))
        self._table_dirty = False

    @property
    def kv_store_dtype(self) -> str:
        """The dtype the KV cache stores: ``int8`` or the compute dtype."""
        return ("int8" if self.bundle.flags.kv_dtype == "int8"
                else self.bundle.cfg.compute_dtype)

    @staticmethod
    def _bucketable(cfg) -> bool:
        """Right padding is mask-safe only when every mixer is full causal
        attention: a windowed ring would evict real tokens for pad, and a
        recurrent state would absorb the pad tokens."""
        if cfg.enc_dec or cfg.frontend:
            return False
        specs = tuple(cfg.layer_pattern) + tuple(cfg.remainder_specs)
        return all(s.mixer == ATTN and s.sliding_window is None
                   for s in specs)

    def kv_bytes(self) -> int:
        """Allocated device bytes of the KV cache (both backends)."""
        def leaves(tree):
            for v in tree.values():
                yield from (leaves(v) if isinstance(v, dict) else (v,))
        return int(sum(t.numel() * t.element_size()
                       for t in leaves(self.cache)))

    def _page_bytes_by_kind(self):
        """(full, ring) device bytes of ONE page summed over every layer
        of that kind (k + v, plus the int8 scale lanes)."""
        cfg = self.bundle.cfg
        nb = cfg.num_pattern_blocks
        n_full = n_ring = 0
        for spec, mult in ([(s, nb) for s in cfg.layer_pattern]
                           + [(s, 1) for s in cfg.remainder_specs]):
            if spec.sliding_window is None:
                n_full += mult
            else:
                n_ring += mult
        int8 = self.bundle.flags.kv_dtype == "int8"
        itemsize = getattr(torch, self.kv_store_dtype).itemsize
        per_layer = (2 * self.page * cfg.num_kv_heads
                     * cfg.resolved_head_dim * itemsize
                     + (2 * self.page * 4 if int8 else 0))
        return n_full * per_layer, n_ring * per_layer

    @property
    def bytes_per_page(self) -> int:
        """One page across every layer pool of its kind (k + v)."""
        if self.backend != "paged":
            raise ValueError("bytes_per_page is a paged-backend figure")
        full_pb, ring_pb = self._page_bytes_by_kind()
        return full_pb or ring_pb

    def live_kv_bytes_peak(self) -> int:
        """Peak *live-token* device bytes: what the pools actually held
        (full-pool and ring-pool page peaks), against the ``batch x
        max_len`` footprint the dense backend commits up front (its
        :meth:`kv_bytes`)."""
        if self.backend == "paged":
            full_pb, ring_pb = self._page_bytes_by_kind()
            return (self.stats.pages_peak * full_pb
                    + self.stats.ring_pages_peak * ring_pb)
        return self.kv_bytes()

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _track_peaks(self) -> None:
        if self.alloc is not None:
            self.stats.pages_peak = max(self.stats.pages_peak,
                                        self.alloc.pages_in_use)
        if self.ralloc is not None:
            self.stats.ring_pages_peak = max(self.stats.ring_pages_peak,
                                             self.ralloc.pages_in_use)
            self.stats.ring_pages_reused = self.ralloc.reused

    # ------------------------------------------------------------------
    # dense prefill (whole prompt, one step)
    # ------------------------------------------------------------------
    @staticmethod
    def _scatter_slot_cache(cache, cache1, slot: int):
        """Write a single-request prefill cache into the batch cache at
        ``slot``, in place.  Stacked leaves (under ``blocks``) carry batch
        at axis 1, remainder leaves at axis 0; rows past the prompt's are
        cleared: k/v and scales to 0 (masked by the decode step's valid
        length), a ring's ``kpos`` to ``-10**9`` (empty).  Returns the
        batch cache."""
        for part, lead in (("blocks", (slice(None),)), ("rem", ())):
            for name, layer in cache[part].items():
                for n, tgt in layer.items():
                    upd = cache1[part][name][n][lead + (0,)]
                    row = tgt[lead + (slot,)]
                    s = upd.shape[len(lead)]
                    row[lead + (slice(0, s),)] = upd.to(tgt.dtype)
                    row[lead + (slice(s, None),)] = (
                        SENTINEL if tgt.dtype == torch.int32 else 0)
        return cache

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Prefill a request's whole prompt in one step (right-padded to a
        power-of-two bucket of at least 8, at most ``max_len``), write its
        cache into the slot's rows and seed decoding from its last logits.
        A windowed layer's rows hold the prompt's last ``window`` tokens
        from row 0, as in the reference."""
        prompt = req.prompt
        s = int(prompt.shape[0])
        if s > self.max_len:
            raise ValueError(f"prompt ({s}) exceeds max_len ({self.max_len})")
        width = (min(next_pow2(max(8, s)), self.max_len)
                 if self.bucket_prompts else s)
        if width not in self._seen_prefill_shapes:
            self._seen_prefill_shapes.add(width)
            self.stats.prefill_retraces += 1
        padded = np.zeros((1, width), np.int64)
        padded[0, :s] = prompt
        dev = self.device
        cache1, logits = self.bundle.prefill(
            self.params, dict(tokens=torch.as_tensor(padded).to(dev),
                              valid_len=s))
        self.cache = self._scatter_slot_cache(self.cache, cache1, slot)
        self.slots[slot] = req
        self.pos[slot] = s
        self._hpos[slot] = s
        tok0 = int(select_greedy(logits)[0])
        req.out_tokens.append(tok0)
        self.stats.prompt_tokens += s
        self.stats.tokens_out += 1
        self.tokens[slot, 0] = tok0
        self.stats.prefills += 1

    # ------------------------------------------------------------------
    # paged admission + chunked prefill
    # ------------------------------------------------------------------
    def _paged_admit_slot(self, slot: int, req: Request) -> None:
        """Attach the cached prompt prefix (shared read-only pages), then
        reserve pages for the whole prompt — all or nothing, so admission
        either sticks or backs off cleanly (:class:`PoolExhausted`)."""
        prompt = req.prompt
        s = int(prompt.shape[0])
        if s > self.max_len:
            raise ValueError(f"prompt ({s}) exceeds max_len ({self.max_len})")
        if self.alloc is not None:
            need = -(-s // self.page)
            if need > self.num_pages - 1:
                # no amount of backpressure can admit this one; waiting
                # would drop it silently and block the queue behind it
                raise ValueError(
                    f"prompt needs {need} pages ({s} tokens) but the pool "
                    f"holds only {self.num_pages - 1}; raise num_pages")
        if self.ralloc is not None:
            need = min(-(-s // self.page), self.ralloc.ring_slots)
            if need > self.num_ring_pages - 1:
                raise ValueError(
                    f"prompt needs {need} ring pages but the ring pool "
                    f"holds only {self.num_ring_pages - 1}; raise "
                    "num_ring_pages")
        hit_len = 0
        hashes: List[str] = []
        if self.alloc is not None:
            self.alloc.alloc(req.rid)
            if self.prefix is not None:
                hashes = page_hashes(prompt, self.page)
                # at most (s-1) tokens: the last token must be computed so
                # the final chunk yields the logits that seed decoding
                usable = (s - 1) // self.page
                pages = self.prefix.lookup(hashes[:usable], alloc=self.alloc)
                if pages:
                    hit_len = len(pages) * self.page
                    self.alloc.attach(req.rid, pages, hit_len)
        if self.ralloc is not None:
            self.ralloc.alloc(req.rid)
        try:
            if self.alloc is not None:
                try:
                    self.alloc.reserve(req.rid, s)
                except PoolExhausted:
                    if (self.prefix is None
                            or not self.prefix.evict_unused(self.alloc)):
                        raise
                    self.alloc.reserve(req.rid, s)
            if self.ralloc is not None:
                self.ralloc.reserve(req.rid, s)
        except PoolExhausted:
            for a in (self.alloc, self.ralloc):
                if a is not None:
                    a.release(req.rid)
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
        cb = (min(next_pow2(max(8, c)), self.prefill_chunk)
              if self.bucket_prompts else c)
        if ("chunk", cb) not in self._seen_prefill_shapes:
            self._seen_prefill_shapes.add(("chunk", cb))
            self.stats.prefill_retraces += 1
        chunk = np.zeros((1, cb), np.int64)
        chunk[0, :c] = prompt[off:off + c]
        row = self.alloc.tables[req.rid] if self.alloc is not None else []
        trow = np.zeros((1, max(1, self.pages_per_seq)), np.int32)
        trow[0, :len(row)] = row
        rrow = np.zeros((1, max(1, self.ring_slots)), np.int32)
        if self.ralloc is not None:
            rring = self.ralloc.tables[req.rid]
            rrow[0, :len(rring)] = rring
        dev = self.device
        self.cache, logits = self.bundle.paged_prefill_chunk(
            self.params, self.cache, torch.as_tensor(chunk).to(dev),
            torch.tensor([off], dtype=torch.int32).to(dev),
            dict(full=torch.as_tensor(trow).to(dev),
                 ring=torch.as_tensor(rrow).to(dev)),
            torch.tensor([c], dtype=torch.int32).to(dev))
        self.stats.prefill_chunks += 1
        off += c
        if off < s:
            self._pending[slot] = off
            return
        # prompt complete: register its full pages, seed decoding, publish
        # the table rows
        del self._pending[slot]
        for i, h in enumerate(self._hashes.pop(req.rid, [])):
            if self.prefix.register(h, row[i]):
                self.alloc.pin(row[i])
        self._htable[slot, :] = 0
        self._htable[slot, :len(row)] = row
        if self.ralloc is not None:
            rring = self.ralloc.tables[req.rid]
            self._hrtable[slot, :] = 0
            self._hrtable[slot, :len(rring)] = rring
        self._table_dirty = True
        self.pos[slot] = s
        self._hpos[slot] = s
        tok0 = int(select_greedy(logits)[0])
        req.out_tokens.append(tok0)
        self.stats.tokens_out += 1
        self.tokens[slot, 0] = tok0
        self.stats.prefills += 1

    def _admit(self) -> None:
        """FIFO admission into free slots.  Dense: each admitted prompt is
        prefilled at once.  Paged: backpressure on a full pool, then one
        prefill chunk for every pending slot, lowest slot first."""
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            if self.backend == "dense":
                self._prefill_into_slot(slot, self.queue.pop(0))
                continue
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
        """Pre-allocate pages covering each slot's window budget on every
        pool the stack uses (allocation is host-side; the decode loop must
        never need a page).  A ring rotates in place past its window, so
        windowed decode in steady state allocates nothing and its table
        row changes only where a shared page was split off.  Pool pressure
        shrinks budgets, possibly to zero (the slot waits), after evicting
        prefix-cache pages nothing references.  Returns the slots the pool
        blocked outright."""
        blocked = np.zeros((self.bsz,), bool)
        for i, req in enumerate(self.slots):
            if req is None or budgets[i] == 0:
                continue
            target = int(self._hpos[i] + budgets[i])
            feasible = target
            if self.alloc is not None:
                feasible = self.alloc.can_grow(req.rid, target)
                if feasible < target and self.prefix is not None:
                    self.prefix.evict_unused(self.alloc)
                    feasible = self.alloc.can_grow(req.rid, target)
            if self.ralloc is not None:
                feasible = min(feasible,
                               self.ralloc.can_grow(req.rid, target))
            grant = max(0, feasible - int(self._hpos[i]))
            if grant < budgets[i]:
                budgets[i] = grant
                blocked[i] = grant == 0
            if budgets[i] > 0:
                target = int(self._hpos[i] + budgets[i])
                for a, table in ((self.alloc, self._htable),
                                 (self.ralloc, self._hrtable)):
                    if a is not None and a.reserve(req.rid, target):
                        row = a.tables[req.rid]
                        table[i, :len(row)] = row
                        self._table_dirty = True
        self._track_peaks()
        return blocked

    def _decode_window(self, n: int, steps: torch.Tensor) -> torch.Tensor:
        """n decode ticks on the device.  ``steps`` (B,) caps each slot:
        past its budget a slot is masked — its token and position freeze,
        and its cache write re-stores the same k/v at the frozen position
        (or, paged, lands on the null page for a retired row).  Returns the
        (n, B) token block, -1 where masked."""
        out = torch.full((n, self.bsz), -1, dtype=torch.int64,
                         device=self.device)
        for i in range(n):
            act = steps > i
            if self.backend == "dense":
                logits, self.cache = self.bundle.decode_step(
                    self.params, self.cache, self.tokens, self.pos)
            else:
                logits, self.cache = self.bundle.paged_decode_step(
                    self.params, self.cache, self.tokens, self.pos,
                    self._table)
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
        blocked = (self._reserve_window_pages(budgets)
                   if self.backend == "paged"
                   else np.zeros((self.bsz,), bool))
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
                pools = [a for a in (self.alloc, self.ralloc)
                         if a is not None]
                raise PoolExhausted(
                    "every active slot is pool-blocked and nothing can free "
                    "pages: the pool is smaller than the live working set",
                    pool="engine",
                    num_pages=sum(a.num_pages for a in pools),
                    live_pages=sum(a.pages_in_use for a in pools),
                    free_pages=sum(len(a.free) for a in pools))
            return 0
        n_run = min(n, next_pow2(top))
        if self.backend == "paged" and self._table_dirty:
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
        """Retire slot ``i``.  Paged: its pages go back to the pool at once
        (prefix-pinned ones persist for future hits) and its table row
        reverts to the null page so masked writes stay harmless."""
        req = self.slots[i]
        self.slots[i] = None
        if self.backend == "dense":
            return
        for a in (self.alloc, self.ralloc):
            if a is not None:
                a.release(req.rid)
        self._hashes.pop(req.rid, None)
        self._htable[i, :] = 0
        self._hrtable[i, :] = 0
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
