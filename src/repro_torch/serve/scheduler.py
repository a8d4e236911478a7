"""SLO-aware scheduling policy for the serving engine: priority classes,
the prefill/decode interleave bound, and mid-flight preemption (the port
of ``repro.serve.scheduler``).

Under pool pressure the engine does not only hold the queue back: it
picks a *victim* by (priority, resume cost, page footprint), releases the
victim's pages through the refcounted
:class:`~repro_torch.serve.kvcache.PageAllocator`, and brings the request
back later by whichever move the memory hierarchy prices cheaper:

- **recompute**: re-prefill ``prompt ++ emitted[:-1]`` in chunks (the
  prefix cache serves the prompt's pages where they survived), at the
  cost of streaming the weights once a chunk; or
- **swap**: copy the victim's whole pages (and int8 scale lanes) to a
  host-memory :class:`~repro_torch.serve.hosttier.HostKVTier` and back
  through the page table on resume, at the cost of two crossings of the
  card's host link.

:class:`SwapCostModel` prices both against the card's
:class:`~repro_torch.core.memmodel.HopperSpec` (the H100 unless a
calibration's fitted spec is given), so a calibrated run moves this
decision as it moves kernel tiles.  Everything here is policy; the
mechanism (page gather and scatter, key replay, table republication)
lives in :class:`~repro_torch.serve.engine.ServeEngine`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.memmodel import H100, HopperSpec

# priority classes: a higher class admits (and holds its slot) first under
# pressure.  Plain ints, so callers may use finer grades.
PRIORITY_LOW = 0
PRIORITY_HIGH = 1

# the H100 SXM's host link: PCIe Gen5 x16, 64 GB/s per direction (NVIDIA's
# H100 data sheet).  A swap crosses it once each way.
HOST_LINK_BW = 64e9


@dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs.  The defaults keep the engine's behaviour on uniform
    priorities: FIFO admission (ties break by arrival), no preemption
    (admission preempts only victims of a strictly lower class), and
    every pending prefill advances one chunk per admission round."""

    preempt: bool = True
    swap: bool = True                 # allow host-tier swap resumes
    # SLO bound: at most this many prefill chunks between two decode
    # windows (None = unbounded).  Under a prefill-heavy mix this caps the
    # gap between decode ticks at a known number of chunks.
    prefill_chunks_per_tick: Optional[int] = None
    # the card's host link rate for the swap path (the HBM side comes
    # from the, possibly calibrated, HopperSpec)
    host_link_bw: float = HOST_LINK_BW

    def __post_init__(self) -> None:
        cap = self.prefill_chunks_per_tick
        if cap is not None and cap < 1:
            raise ValueError(
                f"prefill_chunks_per_tick={cap}: the cap must be >= 1 (every "
                "admit round must be able to advance at least one pending "
                "prefill chunk, or pending prompts would stall forever) — "
                "use None for the unbounded legacy behavior")


@dataclass(frozen=True)
class VictimInfo:
    """One active slot's preemption candidacy, as the engine sees it."""

    slot: int
    rid: int
    priority: int
    ctx_tokens: int        # live KV rows a resume must restore
    pages: int             # pages across pools (freed on eviction)
    # whether THIS victim can resume by swap: a mid-prefill slot can only
    # restart, and a ring or recurrent stack holds no host tier, so
    # pricing such a victim at min(recompute, swap) evicts the wrong slot
    swappable: bool = False


class SwapCostModel:
    """Price a recompute resume against a swap resume for a victim with
    ``ctx`` live tokens.

    Recompute re-runs chunked prefill over the context: each chunk streams
    the weights from device memory once and rewrites the context's KV
    rows.  Swap moves the victim's KV bytes across the host link twice
    (out and back).  The device side reads ``spec``, which a calibration
    fits, so a measured run moves the break-even too.
    """

    def __init__(self, *, weight_bytes: float, kv_bytes_per_token: float,
                 prefill_chunk: int, spec: HopperSpec = H100,
                 host_link_bw: float = HOST_LINK_BW, calibration=None,
                 link_scale: Optional[float] = None):
        if calibration is not None:
            # a bench CalibrationResult: its fitted spec prices the device
            # side only.  Its bandwidth scale was fitted to HBM curves; the
            # host link is another interface, and rescaling it by an HBM
            # fit would move the break-even for the wrong reason.
            spec = calibration.spec
        if link_scale is not None:
            # a separately measured host-link ratio
            host_link_bw *= link_scale
        self.weight_bytes = float(weight_bytes)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.spec = spec
        self.host_link_bw = float(host_link_bw)

    def recompute_s(self, ctx_tokens: int) -> float:
        """Modelled chunked-prefill time for ``ctx_tokens``: one weight
        stream per chunk plus one KV-row write per token."""
        chunks = -(-max(1, ctx_tokens) // self.prefill_chunk)
        return (chunks * self.weight_bytes
                + ctx_tokens * self.kv_bytes_per_token) / self.spec.hbm_bw

    def swap_s(self, ctx_tokens: int) -> float:
        """Modelled swap time: the victim's KV bytes cross the host link
        twice (out, then back)."""
        return 2.0 * ctx_tokens * self.kv_bytes_per_token / self.host_link_bw

    def resume_s(self, ctx_tokens: int, swappable: bool) -> float:
        """The cheapest resume this victim has."""
        r = self.recompute_s(ctx_tokens)
        return min(r, self.swap_s(ctx_tokens)) if swappable else r

    def choose(self, ctx_tokens: int, swappable: bool) -> str:
        """``"swap"`` or ``"recompute"`` for a victim with ``ctx`` live
        tokens.  Ring and recurrent victims never swap: rotation and
        recurrent state are not in the full pool's pages."""
        if swappable and self.swap_s(ctx_tokens) < self.recompute_s(ctx_tokens):
            return "swap"
        return "recompute"


@dataclass
class Scheduler:
    """Priority order and victim choice.  Mutable, so the engine can
    attach a cost model derived from its own geometry (weight bytes, page
    bytes) when the caller gave none."""

    config: SchedulerConfig = field(default_factory=SchedulerConfig)
    cost_model: Optional[SwapCostModel] = None

    def order_queue(self, queue: List, arrival) -> None:
        """Stable priority order: higher class first, FIFO within a class
        (``arrival`` maps rid -> admission sequence number, which a
        preempted request keeps: it resumes ahead of later arrivals of its
        class, behind whatever displaced it)."""
        queue.sort(key=lambda r: (-r.priority, arrival.get(r.rid, 0)))

    def prefill_order(self, slots: Sequence[int], priorities) -> List[int]:
        """Which pending-prefill slots advance a chunk this admission
        round: high-priority prompts first, at most
        ``prefill_chunks_per_tick`` of them, so decode windows keep their
        cadence under prefill load."""
        order = sorted(slots, key=lambda i: (-priorities(i), i))
        cap = self.config.prefill_chunks_per_tick
        return order if cap is None else order[:cap]

    def pick_victim(self, cands: Sequence[VictimInfo], *,
                    below: Optional[int] = None) -> Optional[VictimInfo]:
        """Lowest priority class first, then the cheapest modelled resume,
        then the most pages (the most pool freed per eviction).  ``below``
        keeps only victims of a strictly lower class (admission never
        preempts a peer); shedding under window pressure passes None."""
        if not self.config.preempt:
            return None
        pool = [v for v in cands if below is None or v.priority < below]
        if not pool:
            return None
        cm = self.cost_model

        def key(v: VictimInfo):
            cost = (cm.resume_s(v.ctx_tokens, v.swappable)
                    if cm is not None else v.ctx_tokens)
            return (v.priority, cost, -v.pages, v.slot)

        return min(pool, key=key)
