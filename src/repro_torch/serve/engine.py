"""Continuous-batching serving engine over a dense or a paged KV cache,
greedy or sampled, with speculative draft->verify decoding.

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

Recurrent layers (RG-LRU, SSD) keep dense per-slot state beside the
pools, so a hybrid stack pages only its attention layers and a stack with
no attention layer (mamba2) runs the paged backend with no pool at all.
A prefill chunk continues its slot's state row (restarting it at offset
0); a decode tick advances only the active slots' rows, so a pending
prefill's partial state survives the masked ticks between its chunks.
Prefix sharing and speculative decoding stay off on such stacks, as in
the reference: recurrent state is neither cached by page nor rewound.

Token selection is greedy argmax by default, or temperature/top-k/top-p
sampling (``sampling``) with per-slot threefry keys bit-exact with JAX's
(:mod:`repro_torch.serve.prng`): a slot's key is ``fold_in(PRNGKey(seed),
rid)`` from admission and splits once per emitted token, on the engine's
device; masked slots keep their key, and a greedy engine touches none.

Speculative decoding (``draft_bundle``) rides the paged backend: a draft
model proposes ``spec_k`` tokens per round from a dense per-slot cache,
the target verifies all of them in one ``paged_verify`` pass over the page
tables, and each slot emits the longest prefix of proposals equal to the
target's own draws plus the target's next draw.  Both models draw with the
subkeys the vanilla loop would use (coupled sampling), so the emitted
tokens and the carried keys are those of vanilla decoding, greedy and
sampled; the draft changes only how many tokens a round emits.  Rejected
suffixes roll back the page reservations (:meth:`PageAllocator.truncate`).

Under pool pressure the engine preempts (:mod:`repro_torch.serve.
scheduler`): admission orders the queue by priority, then arrival, and a
request that finds no slot or no pages evicts a victim of a strictly
lower class; a decode window whose every slot the pool blocks sheds one
victim of any class before it gives up.  A victim resumes by
``recompute`` (its context ``prompt ++ emitted[:-1]`` is prefilled again
in chunks, the prefix cache serving the prompt's surviving pages) or by
``swap`` (its pages were copied to the host tier,
:class:`~repro_torch.serve.hosttier.HostKVTier`, and come back through
fresh page ids), as the cost model prices them; a mid-prefill victim
restarts.  Either way the resumed slot re-feeds its pending token and
replays its key chain (``fold_in(PRNGKey(seed), rid)`` split once per
emitted token), so a preempted drain gives the undisturbed drain's
tokens, greedy or sampled.  Swap needs a paged, pure full-attention
stack; a ring or a recurrent state is not in the full pool's pages.
``evacuate``/``adopt`` move unfinished requests between engines, and
``export_finished_prefill``/``import_prefill`` ship a finished prefill's
pages from one engine to another through a checksummed transfer entry.

Not ported yet: the cluster front end and disaggregated pools above these
hooks, tensor/data parallelism, CUDA-graph capture of the decode window.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN
from repro_torch.models.registry import ModelBundle
from repro_torch.models.transformer import SENTINEL
from repro_torch.serve.hosttier import (HostKVEntry, HostKVTier,
                                        make_transfer_entry, page_axis,
                                        tree_leaves, tree_map)
from repro_torch.serve.kvcache import (PageAllocator, PoolExhausted,
                                       PrefixIndex, page_hashes)
from repro_torch.serve import prng
from repro_torch.serve.sampling import (GREEDY, SamplingParams, sample_tokens,
                                        select_greedy, split_keys,
                                        subkey_chain)
from repro_torch.serve.scheduler import Scheduler, SwapCostModel, VictimInfo
from repro_torch.tune import plan_for
from repro_torch.tune.plan import derive_paged_plan, next_pow2


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    priority: int = 0                # scheduler class: higher admits first
    deadline: Optional[int] = None   # a cluster round to finish by; None =
                                     # no SLO (never shed)
    out_tokens: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


@dataclass
class _Resume:
    """What a preempted request needs to pick up where it left off.
    ``ctx`` is the KV context (``prompt ++ out_tokens[:-1]``) whose rows
    the resume restores, by prefilling it again (``recompute``) or by
    copying the swapped pages back (``swap``; the pages wait in the host
    tier).  ``pending`` is ``out_tokens[-1]``, already emitted: the next
    decode tick feeds it, so a resume never draws it again."""

    kind: str                        # "swap" | "recompute"
    ctx: np.ndarray                  # (hpos,) int32
    pending: int


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
    spec_steps: int = 0              # draft->verify rounds
    draft_tokens: int = 0            # draft tokens proposed to the verifier
    draft_accepted: int = 0          # proposals equal to the coupled draw
    # -- scheduler and preemption
    preemptions: int = 0             # mid-flight evictions (all modes)
    preempt_restarts: int = 0        # mid-prefill victims requeued afresh
    swap_outs: int = 0               # victims whose pages went to the host
    swap_ins: int = 0                # resumes copied back through the table
    swap_bytes: int = 0              # bytes through the host tier, both ways
    recompute_resumes: int = 0       # resumes that prefilled their context
    swap_fallbacks: int = 0          # checksum-failed swaps, recomputed
    prefill_burst_max: int = 0       # most prefill chunks between windows
    # -- prefill hand-off between engines
    prefill_exports: int = 0         # finished prefills shipped away
    prefill_imports: int = 0         # shipped prefills landed in a slot
    transfer_bytes: int = 0          # bytes of shipped prefills
    transfer_fallbacks: int = 0      # corrupted transfers, recomputed

    @property
    def accept_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        return self.draft_accepted / max(1, self.draft_tokens)

    @property
    def accepted_per_step(self) -> float:
        """Accepted draft tokens per verify round, summed over slots."""
        return self.draft_accepted / max(1, self.spec_steps)


class ServeEngine:
    """Continuous-batching engine over a dense or paged KV cache.

    ``window`` is the decode window: ``run_to_completion`` advances every
    active slot up to ``window`` tokens per host sync.  ``bucket_prompts``
    pads dense prompts / paged prefill chunks to the next power of two
    (default: on for full-attention stacks, where right padding is masked;
    off where a window or a recurrent state would take the pad in).
    ``cache_backend`` is ``"dense"``, ``"paged"``, or ``None`` (paged
    wherever :meth:`ModelBundle.paged_supported` allows).

    Paged knobs: ``page_size=None`` derives the page from the pool's dtype
    and head width (:func:`repro_torch.tune.derive_paged_plan`);
    ``num_pages=None`` sizes the full-attention pool at the dense
    footprint plus the reserved null page — shrink it to admit by live
    tokens and exercise backpressure.  ``num_ring_pages=None`` sizes the
    windowed layers' ring pool at ``batch x (ceil(window/page)+1)`` pages
    plus the null page, the bound however long windowed sequences run.
    ``prefill_chunk`` caps prompt tokens per prefill step.  ``device`` is
    ``cuda`` unless named; it must be the bundle's device.

    ``sampling`` (default greedy) picks tokens; ``seed`` roots the per-slot
    keys.  ``draft_bundle``/``draft_params`` (a pure full-attention decoder
    sharing the target's vocab, on the engine's device) switch the paged
    backend's ``decode_many`` to draft->verify rounds of ``spec_k``
    proposals each; the target must be a pure full-attention stack, since
    neither a ring nor a recurrent state can roll back a rejected
    suffix.

    ``scheduler`` (default :class:`~repro_torch.serve.scheduler.Scheduler`:
    FIFO on uniform priorities, preemption only of a lower class) orders
    admission and picks victims; ``host_tier`` is the swap target (made
    when the stack can swap and the scheduler allows it);
    ``prefix_cache=False`` turns prefix sharing off."""

    def __init__(self, bundle: ModelBundle, params, batch_size: int,
                 max_len: int, *, window: int = 8,
                 bucket_prompts: Optional[bool] = None,
                 cache_backend: Optional[str] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 num_ring_pages: Optional[int] = None,
                 prefill_chunk: int = 32,
                 prefix_cache: bool = True,
                 sampling: Optional[SamplingParams] = None,
                 seed: int = 0,
                 draft_bundle: Optional[ModelBundle] = None,
                 draft_params=None,
                 spec_k: int = 4,
                 scheduler: Optional[Scheduler] = None,
                 host_tier: Optional[HostKVTier] = None,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        if bundle.device != self.device:
            raise ValueError(f"the bundle runs on {bundle.device}, the "
                             f"engine on {self.device}")
        self.sampling = sampling or GREEDY
        self._base_key = prng.prng_key(seed, self.device)
        self.draft = draft_bundle
        self.draft_params = draft_params
        self.spec_k = max(1, spec_k)
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
            attn = [s for s in specs if s.mixer == ATTN]
            self.has_full = any(s.sliding_window is None for s in attn)
            windows = [s.sliding_window for s in attn
                       if s.sliding_window is not None]
            self.has_recurrent = any(s.mixer != ATTN for s in specs)
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
            # a ring rotates prefix tokens away, and recurrent state is
            # not cached by page
            self.prefix_sharing = (prefix_cache and self.has_full
                                   and not windows and not self.has_recurrent)
        if draft_bundle is not None:
            self._init_spec(draft_bundle)
        # swap resumes capture whole pages, which only a paged, pure
        # full-attention stack offers (a ring rotates, recurrent state is
        # not in the pool); every other stack resumes by recompute
        self.sched = scheduler or Scheduler()
        swappable = (self.backend == "paged" and self.has_full
                     and self.attn_window is None and not self.has_recurrent)
        self.host_tier: Optional[HostKVTier] = None
        if swappable and self.sched.config.swap:
            self.host_tier = host_tier or HostKVTier()
        # prefill shapes met so far (dense prompt buckets, paged chunk
        # buckets); survives reset(), as the reference's compiled shapes do
        self._seen_prefill_shapes: set = set()
        self._init_state()

    def _init_spec(self, draft: ModelBundle) -> None:
        """Validate the speculative draft and pin the verify step's plan."""
        cfg = self.bundle.cfg
        if self.draft_params is None:
            raise ValueError("draft_bundle needs draft_params")
        if self.backend != "paged":
            raise ValueError(
                "speculative decoding rides the paged fast path; "
                "cache_backend='paged' is required")
        if not (self.has_full and self.attn_window is None
                and not self.has_recurrent):
            raise ValueError(
                f"{cfg.name}: speculative verify needs suffix rollback, "
                "which only pure full-attention page tables support (ring "
                "rotation overwrites history and recurrent state cannot "
                "rewind)")
        if draft.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft.cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: proposals must share the token space")
        if not self._bucketable(draft.cfg):
            raise ValueError(
                f"{draft.cfg.name}: the draft must be a pure full-attention "
                "decoder: its rollback is a position rewind over a dense "
                "cache, which windows cannot mask")
        if draft.device != self.device:
            raise ValueError(f"the draft runs on {draft.device}, the engine "
                             f"on {self.device}")
        vplan = plan_for("paged_verify",
                         shape_sig=(self.spec_k + 1, self.max_len,
                                    cfg.resolved_head_dim),
                         dtype=self.kv_store_dtype)
        # the verify step reads the pool the engine laid out: an explicit
        # page_size must reach its plan too
        self.vplan = (vplan if vplan.page_size == self.page
                      else dataclasses.replace(vplan, bkv=self.page))

    def _init_state(self) -> None:
        dev = self.device
        self.pos = torch.zeros((self.bsz,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((self.bsz, 1), dtype=torch.int64, device=dev)
        # per-slot keys: set at admission from (seed, rid), split once per
        # emitted token; a greedy engine leaves them zero
        self.keys = torch.zeros((self.bsz, 2), dtype=torch.int64, device=dev)
        if self.draft is not None:
            self.draft_cache = self.draft.init_cache(self.bsz, self.max_len)
        self._hpos = np.zeros((self.bsz,), np.int64)       # host mirror
        self.slots: List[Optional[Request]] = [None] * self.bsz
        self.queue: List[Request] = []
        self.stats = ServeStats()
        self._pending: Dict[int, int] = {}   # slot -> next prefill offset
        # scheduler state: preempted requests' resume records, arrival
        # seats (priority ties admit FIFO), chunks since the last decode
        # window, and the rids whose swap resume is an imported prefill
        self._resume: Dict[int, _Resume] = {}
        self._arrival: Dict[int, int] = {}
        self._arrival_seq = 0
        self._chunks_since_decode = 0
        self._transfer_rids: set = set()
        if self.host_tier is not None:
            self.host_tier.clear()
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
            ring_pages=self.num_ring_pages, batch=self.bsz)
        self._htable = np.zeros((self.bsz, max(1, self.pages_per_seq)),
                                np.int32)
        # a ring table is exactly ring_slots wide: K1 maps logical page j
        # to slot j % width
        self._hrtable = np.zeros((self.bsz, max(1, self.ring_slots)),
                                 np.int32)
        self._sync_table()
        self._hashes: Dict[int, List[str]] = {}  # rid -> full-page hashes

    def reset(self) -> None:
        """Clear all serving state: cache, pool, prefix index, slots, queue,
        stats, keys, the draft's cache, resume records and the host tier
        (benchmarks drain once to warm up, reset, then time a steady-state
        drain).  The prefill shapes already met stay met, so a warm drain
        counts only new ones."""
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
        return int(sum(t.numel() * t.element_size()
                       for _, t in tree_leaves(self.cache)))

    def _page_bytes_by_kind(self):
        """(full, ring) device bytes of ONE page summed over every attention
        layer of that kind (k + v, plus the int8 scale lanes)."""
        cfg = self.bundle.cfg
        nb = cfg.num_pattern_blocks
        n_full = n_ring = 0
        for spec, mult in ([(s, nb) for s in cfg.layer_pattern]
                           + [(s, 1) for s in cfg.remainder_specs]):
            if spec.mixer != ATTN:
                continue
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

    def _recurrent_state_bytes(self) -> int:
        """The dense per-slot recurrent state (hybrid stacks): always live,
        so everything the cache holds beside the pools."""
        full_pb, ring_pb = self._page_bytes_by_kind()
        pools = ((self.num_pages * full_pb if self.has_full else 0)
                 + (self.num_ring_pages * ring_pb if self.ralloc else 0))
        return self.kv_bytes() - pools

    def live_kv_bytes_peak(self) -> int:
        """Peak *live-token* device bytes: what the pools actually held
        (full-pool and ring-pool page peaks) plus the recurrent state,
        against the ``batch x max_len`` footprint the dense backend commits
        up front (its :meth:`kv_bytes`)."""
        if self.backend == "paged":
            full_pb, ring_pb = self._page_bytes_by_kind()
            return (self.stats.pages_peak * full_pb
                    + self.stats.ring_pages_peak * ring_pb
                    + self._recurrent_state_bytes())
        return self.kv_bytes()

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        if req.rid not in self._arrival:
            self._arrival[req.rid] = self._arrival_seq
            self._arrival_seq += 1
        self.queue.append(req)

    def adopt(self, req: Request) -> None:
        """Admit a request that may be mid-stream: the failover path.  A
        request evacuated from another engine carries its emitted tokens;
        adoption leaves the recompute resume record a preemption here
        would have left (prefill ``prompt ++ emitted[:-1]`` again, feed
        the pending last token, replay the ``(seed, rid)`` key chain past
        the emitted tokens).  That chain depends only on the request and
        the engine's seed, so a drain finished here is the one the first
        engine would have given.  A fresh request is simply queued."""
        if req.done:
            # at its budget already: nothing is left to run, and the
            # caller keeps the finished request
            return
        if req.out_tokens:
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.out_tokens[:-1], np.int32)])
            self._resume[req.rid] = _Resume("recompute", ctx,
                                            int(req.out_tokens[-1]))
        self.add_request(req)

    def evacuate(self) -> List[Request]:
        """Take every unfinished request off this engine, queued and in
        flight, for :meth:`adopt` on another one (failover after a crash).
        In-flight slots preempt by recompute; the resume records and host
        entries held here are dropped, since no device or host state
        follows a request to another engine (:meth:`adopt` derives its
        resume from the request alone).  Finished slots retire.  The
        engine is left idle with every request's pages released (pages
        the prefix cache pins stay)."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.done:
                self._release_finished(i)
            else:
                self.preempt(i, mode="recompute")
        moved = list(self.queue)
        self.queue.clear()
        for r in moved:
            res = self._resume.pop(r.rid, None)
            if (res is not None and res.kind == "swap"
                    and self.host_tier is not None
                    and r.rid in self.host_tier):
                self.host_tier.pop(r.rid)
            self._transfer_rids.discard(r.rid)
            self._arrival.pop(r.rid, None)
        return moved

    # ------------------------------------------------------------------
    # prefill hand-off between engines
    # ------------------------------------------------------------------
    def export_finished_prefill(self, slot: int):
        """Ship a freshly prefilled request off this engine: gather its
        pages (k/v and the int8 scale lanes) into a checksummed transfer
        entry, release everything it held here, and return ``(request,
        entry)`` for another engine's :meth:`import_prefill`.

        This is the swap-out of a request that has emitted only its first
        token.  The pending token rides on ``request.out_tokens``; the key
        chain needs no shipping, being a function of ``(seed, rid)`` and
        the emitted count.  Needs the host tier (paged, pure full
        attention) and a finished prefill."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"export of empty slot {slot}")
        if self.host_tier is None:
            raise ValueError(
                "export requires the host swap tier (paged backend, pure "
                "full-attention stack, scheduler swap enabled)")
        if slot in self._pending:
            raise ValueError(
                f"slot {slot} is mid-prefill: only a completed prefill "
                "(seed token emitted) can be exported")
        if len(req.out_tokens) != 1:
            raise ValueError(
                f"rid {req.rid} has emitted {len(req.out_tokens)} tokens; "
                "export is a prefill hand-off — decode must not have begun")
        hpos = int(self._hpos[slot])
        # drop any reservation past the live rows, then gather the table
        # (shared prefix pages are only read)
        self.alloc.truncate(req.rid, hpos)
        pids = list(self.alloc.tables[req.rid])
        entry = make_transfer_entry(req.rid, self._gather_to_host(pids),
                                    len(pids), length=hpos)
        self.stats.prefill_exports += 1
        self.stats.transfer_bytes += entry.nbytes
        self._release_finished(slot)
        self._arrival.pop(req.rid, None)
        return req, entry

    def import_prefill(self, req: Request, entry: HostKVEntry) -> None:
        """Land a shipped prefill here: install the transfer entry in the
        host tier as it is (its original checksum included) and queue the
        request behind a swap resume record.  Admission then takes the
        swap-in path: reserve pages, copy the entry through the page
        table, restore position and pending token, replay the key chain.
        A checksum mismatch (damage anywhere in transit) resumes by
        recompute instead: the prompt is prefilled here, in chunks, which
        gives the same tokens."""
        if self.host_tier is None:
            raise ValueError(
                "import requires the host swap tier on the decode engine "
                "(paged backend, pure full-attention stack, swap enabled)")
        if len(req.out_tokens) != 1:
            raise ValueError(
                f"rid {req.rid} has emitted {len(req.out_tokens)} tokens; "
                "import expects a prefill hand-off (exactly the seed token)")
        ctx = np.asarray(req.prompt, np.int32)
        if int(entry.length) != len(ctx):
            raise ValueError(
                f"transfer entry covers {entry.length} rows but rid "
                f"{req.rid}'s prompt holds {len(ctx)} tokens")
        self.host_tier.put_entry(entry)
        self._transfer_rids.add(req.rid)
        self._resume[req.rid] = _Resume("swap", ctx, int(req.out_tokens[-1]))
        self.add_request(req)

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
    # sampling state
    # ------------------------------------------------------------------
    def _assign_key(self, slot: int, req: Request) -> None:
        """Pin the slot's key to the request: ``fold_in(PRNGKey(seed),
        rid)``, whatever slot it landed in or what ran there before."""
        if self.sampling.greedy:
            return                    # greedy never touches a key
        self.keys[slot] = prng.fold_in(self._base_key, req.rid)

    def _seed_token(self, slot: int, logits) -> int:
        """The first decode token from the prefill's (1, V) logits, drawn
        with the same one-split-per-token chain the decode loop
        continues."""
        if self.sampling.greedy:
            return int(select_greedy(logits)[0])
        nk, sub = split_keys(self.keys[slot:slot + 1])
        tok = sample_tokens(sub, logits, self.sampling)
        self.keys[slot] = nk[0]
        return int(tok[0])

    def _replay_key(self, slot: int, req: Request) -> None:
        """Restore a resumed slot's key: the admission key ``fold_in(
        PRNGKey(seed), rid)`` split once per token the request has already
        emitted, which is the key an undisturbed run would hold now."""
        if self.sampling.greedy:
            return                    # greedy holds no key
        n = len(req.out_tokens)
        key = prng.fold_in(self._base_key, req.rid)
        if n:
            _, carried = subkey_chain(key[None], n)
            key = carried[0, n]
        self.keys[slot] = key

    def _select_next(self, logits, act):
        """One in-window token selection: greedy argmax (keys untouched)
        or one split and draw per slot, where masked slots keep their key,
        so a frozen slot replays identically however many masked ticks
        pass over it."""
        if self.sampling.greedy:
            return select_greedy(logits)
        nk, sub = split_keys(self.keys)
        nxt = sample_tokens(sub, logits, self.sampling)
        self.keys = torch.where(act[:, None], nk, self.keys)
        return nxt

    # ------------------------------------------------------------------
    # preemption: victim choice, page swap, resume
    # ------------------------------------------------------------------
    def _cost_model(self) -> SwapCostModel:
        """The scheduler's swap-or-recompute pricer, derived from this
        engine's geometry when the caller gave none: the weight bytes
        (each prefill chunk streams them) and the KV bytes a token holds
        (what a swap moves per context row), on the H100's spec."""
        if self.sched.cost_model is None:
            wb = sum(t.numel() * t.element_size()
                     for _, t in tree_leaves(self.params))
            if self.backend == "paged":
                kv_tok = self.bytes_per_page / self.page
                chunk = self.prefill_chunk
            else:
                kv_tok = self.kv_bytes() / (self.bsz * self.max_len)
                chunk = self.max_len        # a dense prefill is one step
            self.sched.cost_model = SwapCostModel(
                weight_bytes=wb, kv_bytes_per_token=kv_tok,
                prefill_chunk=chunk,
                host_link_bw=self.sched.config.host_link_bw)
        return self.sched.cost_model

    def _victims(self) -> List[VictimInfo]:
        """Every active slot's candidacy as the policy sees it.  A
        mid-prefill slot counts the tokens already chunked in as its
        resume cost (a restart redoes them) and can only restart."""
        cands = []
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            pages = 0
            if self.backend == "paged":
                for a in (self.alloc, self.ralloc):
                    if a is not None:
                        pages += len(a.tables.get(req.rid, ()))
            ctx = self._pending.get(i, int(self._hpos[i]))
            cands.append(VictimInfo(
                slot=i, rid=req.rid, priority=req.priority, ctx_tokens=ctx,
                pages=pages, swappable=(self.host_tier is not None
                                        and i not in self._pending)))
        return cands

    def _pick_victim(self, below: Optional[int] = None) -> Optional[int]:
        v = self.sched.pick_victim(self._victims(), below=below)
        if v is None:
            return None
        self._cost_model()   # in place before preempt() prices the resume
        return v.slot

    def preempt(self, slot: int, mode: Optional[str] = None) -> str:
        """Evict the request in ``slot`` mid-flight and queue it again.

        Returns the mode used: ``"restart"`` (mid-prefill: the partial
        pages go and the prompt is admitted afresh, less what the prefix
        cache kept), ``"recompute"`` (the resume prefills ``prompt ++
        emitted[:-1]`` again) or ``"swap"`` (the pages go to the host tier
        and come back on resume).  ``mode`` forces the choice; None asks
        the cost model; ``"swap"`` without a host tier recomputes.  The
        resumed request drains as an undisturbed one would: its KV rows
        come back exactly (swap) or row for row (chunked prefill works by
        position), its pending token is fed again, not drawn, and its key
        chain is replayed."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"preempt of empty slot {slot}")
        self.stats.preemptions += 1
        if slot in self._pending:
            # the prompt is still building: nothing emitted, no resume
            # state; drop the partial pages and let admission redo it
            del self._pending[slot]
            self._release_finished(slot)
            self.stats.preempt_restarts += 1
            self.queue.append(req)
            return "restart"
        hpos = int(self._hpos[slot])
        ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                              np.asarray(req.out_tokens[:-1], np.int32)])
        assert len(ctx) == hpos, "context/KV length drift"
        if mode is None:
            mode = self._cost_model().choose(hpos, self.host_tier is not None)
        elif mode == "swap" and self.host_tier is None:
            mode = "recompute"
        if mode == "swap":
            # exactly the live rows: drop reservation pages past hpos, then
            # gather the table (shared prefix pages are only read, and the
            # resume owns private copies)
            self.alloc.truncate(req.rid, hpos)
            pids = list(self.alloc.tables[req.rid])
            entry = self.host_tier.put(req.rid, self._gather_to_host(pids),
                                       len(pids), length=hpos)
            self.stats.swap_outs += 1
            self.stats.swap_bytes += entry.nbytes
        self._resume[req.rid] = _Resume(mode, ctx, int(req.out_tokens[-1]))
        self._release_finished(slot)
        self.queue.append(req)
        return mode

    def _page_ids(self, pids: List[int]) -> torch.Tensor:
        """``pids`` padded to a power of two with the null page's id, as a
        device index: the gather and scatter see few distinct lengths, and
        the padding lanes only touch the null page."""
        m = next_pow2(max(1, len(pids)))
        return torch.tensor(list(pids) + [0] * (m - len(pids)),
                            dtype=torch.int64, device=self.device)

    def _gather_to_host(self, pids: List[int]):
        """Device -> host page gather: ``index_select`` of the padded page
        list along every pool leaf's page axis (k/v pages and int8 scale
        lanes), copied into pinned host memory when the pools are on the
        card.  The null page's padding lanes fall outside the checksum."""
        idx = self._page_ids(pids)

        def take(path, leaf):
            got = leaf.index_select(page_axis(path, leaf), idx)
            if got.device.type == "cpu":
                return got
            host = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
            return host.copy_(got, non_blocking=True)

        data = tree_map(take, self.cache)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return data

    def _scatter_from_host(self, pids: List[int], data) -> None:
        """Host -> device page scatter, the gather's inverse: each leaf of
        ``data`` (padded to the power of two of ``pids``) is copied to the
        card and ``index_copy_``-ed along the pool's page axis.  Padding
        lanes all land on the null page, a duplicate index whose final
        value nothing reads."""
        idx = self._page_ids(pids)
        for (path, leaf), (hpath, host) in zip(tree_leaves(self.cache),
                                               tree_leaves(data)):
            assert path == hpath, (path, hpath)
            leaf.index_copy_(page_axis(path, leaf), idx,
                             host.to(self.device, non_blocking=True))

    def _swap_in_slot(self, slot: int, req: Request, res: _Resume) -> bool:
        """Copy a swapped-out request's pages back through the page table:
        reserve fresh pages (their ids may differ: the table's
        indirection makes that free), ``index_copy_`` the host bytes into
        every pool leaf, publish the row, and restore position, pending
        token and key.  False when the checksum no longer matches: the
        entry is dropped and the caller resumes by recompute (chaos
        corruption lands here)."""
        entry, ok = self.host_tier.get(req.rid)
        if not ok:
            self.host_tier.pop(req.rid)
            if req.rid in self._transfer_rids:
                self._transfer_rids.discard(req.rid)
                self.stats.transfer_fallbacks += 1
            else:
                self.stats.swap_fallbacks += 1
            res.kind = "recompute"
            return False
        s = len(res.ctx)
        self.alloc.alloc(req.rid)
        try:
            try:
                self.alloc.reserve(req.rid, s)
            except PoolExhausted:
                if (self.prefix is None
                        or not self.prefix.evict_unused(self.alloc)):
                    raise
                self.alloc.reserve(req.rid, s)
        except PoolExhausted:
            self.alloc.release(req.rid)
            raise
        pids = self.alloc.tables[req.rid]
        assert len(pids) == entry.n_pages, "swap-in page count drift"
        self._scatter_from_host(pids, entry.data)
        self.host_tier.pop(req.rid)
        self._resume.pop(req.rid)
        self.slots[slot] = req
        self._htable[slot, :] = 0
        self._htable[slot, :len(pids)] = pids
        self._table_dirty = True
        self.pos[slot] = s
        self._hpos[slot] = s
        self._replay_key(slot, req)
        self.tokens[slot, 0] = res.pending
        if self.draft is not None:
            # the draft's dense cache is derived state: a prefill over the
            # context rebuilds it (and coupled sampling means the draft
            # changes only how many tokens a round emits)
            self._draft_prefill_slot(slot, req, tokens=res.ctx)
        if req.rid in self._transfer_rids:
            self._transfer_rids.discard(req.rid)
            self.stats.prefill_imports += 1
            self.stats.transfer_bytes += entry.nbytes
        else:
            self.stats.swap_ins += 1
            self.stats.swap_bytes += entry.nbytes
        self._track_peaks()
        return True

    # ------------------------------------------------------------------
    # dense prefill (whole prompt, one step)
    # ------------------------------------------------------------------
    @staticmethod
    def _scatter_slot_cache(cache, cache1, slot: int):
        """Write a single-request prefill cache into the batch cache at
        ``slot``, in place, by the reference's rule: stacked leaves (under
        ``blocks``) carry batch at axis 1, remainder leaves at axis 0, and
        every other axis the prompt's leaf is shorter on is padded at its
        end: k/v and scales with 0 (masked by the decode step's valid
        length), a ring's ``kpos`` with ``-10**9`` (empty).  A recurrent
        state leaf is written whole (a prompt shorter than the conv's
        context gives a shorter ``conv`` leaf, padded at its end as the
        reference pads it).  Returns the batch cache."""
        for part, bax in (("blocks", 1), ("rem", 0)):
            for name, layer in cache[part].items():
                for n, tgt in layer.items():
                    upd = cache1[part][name][n].select(bax, 0)
                    row = tgt.select(bax, slot)
                    row.fill_(SENTINEL if tgt.dtype == torch.int32 else 0)
                    row[tuple(slice(0, m) for m in upd.shape)] = \
                        upd.to(tgt.dtype)
        return cache

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Prefill a request's whole prompt in one step (right-padded to a
        power-of-two bucket of at least 8, at most ``max_len``), write its
        cache into the slot's rows and seed decoding from its last logits.
        A windowed layer's rows hold the prompt's last ``window`` tokens
        from row 0, as in the reference.  A preempted request resumes here
        by prefilling its recorded context and feeding its pending token
        again (never drawing it anew)."""
        res = self._resume.get(req.rid)
        prompt = req.prompt if res is None else res.ctx
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
        if res is None:
            self._assign_key(slot, req)
            tok0 = self._seed_token(slot, logits)
            req.out_tokens.append(tok0)
            self.stats.prompt_tokens += s
            self.stats.tokens_out += 1
        else:
            self._resume.pop(req.rid)
            self._replay_key(slot, req)
            tok0 = int(res.pending)
            self.stats.recompute_resumes += 1
        self.tokens[slot, 0] = tok0
        self.stats.prefills += 1

    # ------------------------------------------------------------------
    # paged admission + chunked prefill
    # ------------------------------------------------------------------
    def _paged_admit_slot(self, slot: int, req: Request) -> None:
        """Attach the cached prompt prefix (shared read-only pages), then
        reserve pages for the whole prompt — all or nothing, so admission
        either sticks or backs off cleanly (:class:`PoolExhausted`).

        A preempted request comes back here: a swap resume copies its
        pages back (or, when the host copy fails its checksum, recomputes),
        a recompute resume takes the chunked-prefill path over its
        recorded context, whose prompt pages the prefix cache usually
        still holds."""
        res = self._resume.get(req.rid)
        if res is not None and res.kind == "swap" \
                and self._swap_in_slot(slot, req, res):
            return
        prompt = req.prompt if res is None else res.ctx
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
        if res is None:      # a resume's context was counted at admission
            self.stats.prompt_tokens += s
            self.stats.prefix_hit_tokens += hit_len
        self._track_peaks()
        # the batch table row stays null until prefill completes: masked
        # decode ticks must not write through a half-built row

    def _prefill_tick(self, slot: int) -> None:
        """Advance one pending slot by ONE chunk (<= prefill_chunk tokens)."""
        req = self.slots[slot]
        res = self._resume.get(req.rid)
        prompt = req.prompt if res is None else res.ctx
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
            torch.tensor([c], dtype=torch.int32).to(dev), slot)
        self.stats.prefill_chunks += 1
        self._chunks_since_decode += 1
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
        if res is None:
            self._assign_key(slot, req)
            tok0 = self._seed_token(slot, logits)
            req.out_tokens.append(tok0)
            self.stats.tokens_out += 1
        else:
            # a recompute resume: the context's last logits give a token
            # already emitted; feed it again and replay the key chain
            self._resume.pop(req.rid)
            self._replay_key(slot, req)
            tok0 = int(res.pending)
            self.stats.recompute_resumes += 1
        self.tokens[slot, 0] = tok0
        if self.draft is not None:
            self._draft_prefill_slot(slot, req,
                                     tokens=None if res is None else res.ctx)
        self.stats.prefills += 1

    def _draft_prefill_slot(self, slot: int, req: Request,
                            tokens: Optional[np.ndarray] = None) -> None:
        """Build the draft's dense cache rows for a freshly prefilled slot
        (or, with ``tokens``, over a resumed request's context).  The
        draft is pure full attention, so the prompt pads to a power of two
        (the padded tail is masked by ``valid_len``)."""
        toks = req.prompt if tokens is None else tokens
        s = int(toks.shape[0])
        bucket = min(next_pow2(max(8, s)), self.max_len)
        if ("draft", bucket) not in self._seen_prefill_shapes:
            self._seen_prefill_shapes.add(("draft", bucket))
            self.stats.prefill_retraces += 1
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :s] = toks
        dcache1, _ = self.draft.prefill(
            self.draft_params, dict(tokens=torch.as_tensor(padded).to(
                self.device), valid_len=s))
        self.draft_cache = self._scatter_slot_cache(self.draft_cache,
                                                    dcache1, slot)

    def _admit(self) -> None:
        """Admission in the scheduler's order (priority, then arrival).
        With no free slot, or (paged) no pages, the head of the queue
        preempts a victim of a strictly lower class, or waits
        (backpressure: on uniform priorities nothing is preempted).
        Dense: each admitted prompt is prefilled at once.  Paged: then one
        prefill chunk for each pending slot the scheduler picks."""
        while self.queue:
            if len(self.queue) > 1:
                self.sched.order_queue(self.queue, self._arrival)
            req = self.queue[0]
            slot = self._free_slot()
            if slot is None:
                victim = self._pick_victim(below=req.priority)
                if victim is None:
                    break
                self.preempt(victim)
                continue
            if self.backend == "dense":
                self._prefill_into_slot(slot, self.queue.pop(0))
                continue
            try:
                self._paged_admit_slot(slot, req)
            except PoolExhausted:
                victim = self._pick_victim(below=req.priority)
                if victim is None:
                    # backpressure: the request stays queued; pages free
                    # as in-flight requests finish
                    self.stats.pool_stalls += 1
                    break
                self.preempt(victim)
                continue
            self.queue.pop(0)
        for slot in self.sched.prefill_order(
                list(self._pending), lambda i: self.slots[i].priority):
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
        (or, paged, lands on the null page for a retired row); paged, its
        recurrent state rows keep their values, while the dense backend
        advances every row, as the reference does.  Returns the (n, B)
        token block, -1 where masked."""
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
                    self._table, act)
            nxt = self._select_next(logits, act)
            self.tokens = torch.where(act[:, None], nxt[:, None], self.tokens)
            self.pos = torch.where(act, self.pos + 1, self.pos)
            out[i] = torch.where(act, nxt, -1)
        return out

    def decode_many(self, n: int) -> int:
        """Run up to ``n`` decode ticks as one window (per-slot budgets
        masked on the device), then read the token block back with a single
        host sync.  With a draft model the window is one speculative
        draft->verify round instead, emitting up to ``spec_k + 1`` tokens a
        slot.  Returns the number of tokens produced."""
        if self.draft is not None:
            n = min(n, self.spec_k + 1)
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
        if top == 0 and blocked.any() and not self._pending:
            # shed one victim (of any class: every slot is blocked) before
            # the hard stop, so the others inherit its pages; a lone
            # blocked slot has nobody to yield to
            active = [i for i, r in enumerate(self.slots) if r is not None]
            victim = self._pick_victim() if len(active) > 1 else None
            if victim is not None:
                self.preempt(victim)
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
        self.stats.prefill_burst_max = max(self.stats.prefill_burst_max,
                                           self._chunks_since_decode)
        self._chunks_since_decode = 0
        if self.draft is not None:
            return self._spec_dispatch(budgets)
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

    def _spec_dispatch(self, budgets: np.ndarray) -> int:
        """One speculative round (:meth:`_spec_decode_many`), read back with
        one host sync; each slot advances by its emitted count, and its
        page reservation, which ran ahead to ``hpos + budget``, is
        truncated to what it emitted (pages holding only rejected rows
        return to the pool; shared prefix pages are only dereferenced)."""
        if self._table_dirty:
            self._sync_table()
        steps = torch.as_tensor(budgets.astype(np.int32)).to(self.device)
        out, meta = self._spec_decode_many(steps)
        # a round advances every unblocked slot by at least one token, so a
        # round counts as one tick for progress accounting
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 1
        self.stats.spec_steps += 1

        host = torch.cat([out, meta.T], dim=1).cpu().numpy()  # one sync
        k1 = self.spec_k + 1
        produced = 0
        for i, req in enumerate(self.slots):
            if req is None or i in self._pending or budgets[i] == 0:
                continue
            emitted, accepted, proposed = (int(x) for x in host[i, k1:])
            req.out_tokens.extend(int(t) for t in host[i, :emitted])
            self._hpos[i] += emitted
            produced += emitted
            self.stats.draft_tokens += proposed
            self.stats.draft_accepted += accepted
            self.alloc.truncate(req.rid, int(self._hpos[i]))
            if req.done or self._hpos[i] >= self.max_len - 1:
                self._release_finished(i)
        self.stats.tokens_out += produced
        return produced

    def _spec_decode_many(self, steps: torch.Tensor):
        """One speculative round on the device.

        The draft proposes ``k`` tokens from its dense cache, plus one step
        that only lands ``d_{k-1}``'s row; the target verifies ``[pending,
        d_0 .. d_{k-1}]`` in one ``paged_verify`` pass (logits at every
        position).  Both draw with the subkeys the vanilla loop would use
        (one split per emitted token), a proposal is accepted while it
        equals the target's draw, and the emitted tokens are always the
        target's: the longest matching prefix, then the target's next
        draw.  Keys advance to ``carried[:, m]`` after m tokens, as m
        vanilla ticks would leave them.

        steps (B,) budgets each slot's emission (0 = frozen).  Returns
        (out (B, k+1) int64, emitted tokens left-packed and -1 past the
        count; meta (3, B) int64: emitted, accepted drafts, proposed)."""
        k, bsz, sp = self.spec_k, self.bsz, self.sampling
        cv = torch.clamp(steps, 0, k + 1)          # verify width per slot
        act = steps > 0
        if not sp.greedy:
            subs, carried = subkey_chain(self.keys, k + 1)

        # the draft's positions stop at the last cache row: a step past it
        # only proposes for positions no budget reaches, and its write lands
        # on a row nothing reachable reads
        tok, drafts = self.tokens, []
        for i in range(k + 1):
            dpos = torch.clamp(self.pos + i, max=self.max_len - 1)
            dlogits, self.draft_cache = self.draft.decode_step(
                self.draft_params, self.draft_cache, tok, dpos)
            if i == k:
                break
            d = (select_greedy(dlogits) if sp.greedy
                 else sample_tokens(subs[:, i], dlogits, sp))
            drafts.append(d)
            tok = d[:, None]
        drafts = torch.stack(drafts, dim=1)         # (B, k)

        verify = torch.cat([self.tokens, drafts], dim=1)     # (B, k+1)
        self.cache, logits = self.bundle.paged_verify(
            self.params, self.cache, verify, self.pos, self._table, cv,
            self.vplan)                                      # (B, k+1, V)
        if sp.greedy:
            tsamp = select_greedy(logits)
        else:
            tsamp = sample_tokens(subs.reshape(-1, 2),
                                  logits.reshape(bsz * (k + 1), -1),
                                  sp).reshape(bsz, k + 1)

        # the matching prefix's length: the first miss, or k
        j = torch.cumprod((drafts == tsamp[:, :k]).to(torch.int64),
                          dim=1).sum(dim=1)
        m = torch.where(act, torch.minimum(j + 1, cv.to(torch.int64)), 0)
        emit = (torch.arange(k + 1, device=self.device)[None, :]
                < m[:, None])
        out = torch.where(emit, tsamp, -1)
        last = torch.gather(tsamp, 1, torch.clamp(m - 1, min=0)[:, None])
        self.tokens = torch.where((m > 0)[:, None], last, self.tokens)
        self.pos = self.pos + m.to(self.pos.dtype)
        if not sp.greedy:
            nk = torch.gather(carried, 1,
                              m[:, None, None].expand(bsz, 1, 2))[:, 0]
            self.keys = torch.where(act[:, None], nk, self.keys)
        acc = torch.minimum(m, j)                  # the bonus isn't a draft
        prop = torch.where(act, k, 0)
        return out, torch.stack([m, acc, prop])

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
