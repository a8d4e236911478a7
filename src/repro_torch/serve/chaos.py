"""Deterministic fault injection for the serving engine (the port of
``repro.serve.chaos``'s engine half).

The scheduler's claim, that any preemption, swap and resume schedule
drains with the undisturbed run's tokens, is worth stating only if
something adversarial tries to break it.  :class:`ChaosEngine` wraps a
live :class:`~repro_torch.serve.engine.ServeEngine` and, from seeded
``numpy`` generators (the reference's schedules, seed for seed), injects
per round:

- **preemption storms**: every active slot is evicted with
  ``preempt_prob``, in a forced mode or the cost model's;
- **forced pool exhaustion**: a *phantom* request (a negative rid, never
  real traffic) holds a random slice of each pool's free list for one
  round, driving admission into its backpressure and victim paths and
  decode into its shedding path;
- **swap-tier faults**: extra host-link latency (``swap_latency_s``) and
  in-place corruption of swapped entries (``corrupt_prob``), which the
  tier's checksum must catch and the engine survive by recomputing.

After every round the wrapper asserts that the allocators conserve pages
(live + free == pool, every refcount >= 1, every table page live): faults
may slow a drain, never leak a page.

:class:`ClusterChaos` is the replica-scale sibling: whole-replica crashes,
brownouts (stalled rounds and slow health probes) and transient admission
refusals, injected into a
:class:`~repro_torch.serve.cluster.ClusterFrontEnd` each virtual-clock
round; :class:`DisaggChaos` corrupts the transfer buffers a
:class:`~repro_torch.serve.cluster.DisaggPool` has in flight.  Every kind
draws from its own seed-derived stream (:func:`fault_rng`), so kinds
compose without moving each other's schedules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.hosttier import corrupt_entry
from repro_torch.serve.kvcache import PoolExhausted

# Stable fault-kind ids, the reference's: each kind draws from its own
# sub-stream keyed (seed, kind id) through a SeedSequence, so a new kind
# never moves an existing kind's schedule.  Only append.
_FAULT_KIND_IDS = {
    "storm": 0,       # per-slot preemption storms   (ChaosEngine)
    "exhaust": 1,     # phantom free-list grabs      (ChaosEngine)
    "corrupt": 2,     # host-tier byte flips         (ChaosEngine)
    "crash": 3,       # whole-replica crash          (ClusterChaos)
    "brownout": 4,    # replica stall / slow probes  (ClusterChaos)
    "admit": 5,       # transient admission refusals (ClusterChaos)
    "transfer": 6,    # in-transit buffer corruption (DisaggChaos)
}


def fault_rng(seed: int, kind: str) -> np.random.Generator:
    """The generator of one fault kind under one chaos seed."""
    return np.random.default_rng(
        np.random.SeedSequence((seed, _FAULT_KIND_IDS[kind])))


@dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    preempt_prob: float = 0.25    # per active slot, per round
    exhaust_prob: float = 0.2     # phantom free-list grab, per round
    corrupt_prob: float = 0.0     # per swapped host entry, per round
    swap_latency_s: float = 0.0   # injected host-link stall per put/get
    mode: Optional[str] = None    # force "swap"/"recompute"; None = cost model


class ChaosEngine:
    """Drives ``eng`` to completion while injecting faults.  Use it as
    ``run_to_completion``: queue requests on the engine (or through
    :meth:`add_request`), then :meth:`run_to_completion`."""

    def __init__(self, eng, cfg: ChaosConfig = ChaosConfig()):
        self.eng = eng
        self.cfg = cfg
        self.rngs = {k: fault_rng(cfg.seed, k)
                     for k in ("storm", "exhaust", "corrupt")}
        self.faults = 0               # injected preemptions
        self.exhausts = 0             # phantom grabs
        self.corruptions = 0          # host-tier bytes flipped
        self._phantoms: List = []     # [(allocator, rid)] held this round
        self._next_phantom = -1
        if eng.host_tier is not None and cfg.swap_latency_s > 0:
            eng.host_tier.latency_s = cfg.swap_latency_s

    def add_request(self, req) -> None:
        self.eng.add_request(req)

    @property
    def stats(self):
        return self.eng.stats

    def _pools(self):
        if self.eng.backend != "paged":
            return []
        return [a for a in (self.eng.alloc, self.eng.ralloc) if a is not None]

    def _release_phantoms(self) -> None:
        for alloc, rid in self._phantoms:
            alloc.release(rid)
        self._phantoms = []

    def _grab_phantom(self) -> None:
        """Take a random slice of each pool's free list for one round:
        someone else is using the device memory."""
        for alloc in self._pools():
            free = len(alloc.free)
            cap = (free if alloc.ring_slots is None
                   else min(free, alloc.ring_slots))
            if cap < 1:
                continue
            k = int(self.rngs["exhaust"].integers(1, cap + 1))
            rid = self._next_phantom
            self._next_phantom -= 1
            alloc.alloc(rid)
            alloc.reserve(rid, k * alloc.page_size)
            self._phantoms.append((alloc, rid))
            self.exhausts += 1

    def _storm(self) -> None:
        eng = self.eng
        for i, req in enumerate(eng.slots):
            if req is None or req.done:
                continue
            if self.rngs["storm"].random() < self.cfg.preempt_prob:
                eng.preempt(i, mode=self.cfg.mode)
                self.faults += 1

    def _corrupt(self) -> None:
        tier = self.eng.host_tier
        if tier is None or self.cfg.corrupt_prob <= 0:
            return
        for rid in tier.rids():
            if self.rngs["corrupt"].random() < self.cfg.corrupt_prob:
                tier.corrupt(rid)
                self.corruptions += 1

    def check_invariants(self) -> None:
        """Page conservation after a fault round: live + free == pool
        (less the reserved null page), every live page holds >= 1
        reference, and every table entry points at a live page."""
        for a in self._pools():
            live = a.num_pages - a.reserved - len(a.free)
            assert live == len(a.ref), (
                f"{a.kind} pool leak: {live} unaccounted vs {len(a.ref)} "
                "refcounted")
            assert all(c >= 1 for c in a.ref.values()), (
                f"{a.kind} pool holds a zero refcount")
            assert not set(a.free) & set(a.ref), (
                f"{a.kind} pool has pages both free and referenced")
            for rid, table in a.tables.items():
                for pid in table:
                    assert pid in a.ref, (
                        f"{a.kind} pool: rid {rid} maps freed page {pid}")

    def step(self) -> bool:
        """One round: release last round's phantom pages, inject (storm,
        corruption, exhaustion), then advance the engine one admission
        and decode-window round.  False once drained."""
        eng = self.eng
        self._release_phantoms()
        self._storm()
        self._corrupt()
        if self.rngs["exhaust"].random() < self.cfg.exhaust_prob:
            self._grab_phantom()
        eng._admit()
        if not any(s is not None for s in eng.slots):
            # drained, or everything stalled behind phantom pages: free
            # them either way so the next round can admit
            self._release_phantoms()
            self.check_invariants()
            return bool(eng.queue)
        try:
            eng.decode_many(eng.window)
        except PoolExhausted:
            if not self._phantoms:
                raise  # a pool too small for its load: surface it
            self._release_phantoms()  # caused by the chaos: recover
        self.check_invariants()
        return True

    def run_to_completion(self, max_rounds: int = 10_000):
        """Drain under fire.  Raises if the drain does not converge: the
        faults may slow completion, never prevent it."""
        for _ in range(max_rounds):
            if not self.step():
                self._release_phantoms()
                return self.eng.stats
        raise AssertionError(
            f"chaos drain did not converge in {max_rounds} rounds "
            f"(faults={self.faults}, exhausts={self.exhausts}, "
            f"queue={len(self.eng.queue)})")


# ----------------------------------------------------------------------
# cluster-scale faults
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ClusterChaosConfig:
    """The cluster fault mix of :class:`ClusterChaos`.  Probabilities are
    per replica, per round; ``kill_at`` pins faults to rounds as
    ``(round, replica_index, kind)``, kind one of ``"crash"``,
    ``"brownout"`` or ``"admit"``, for kill schedules a gate replays."""
    seed: int = 0
    crash_prob: float = 0.0        # replica goes dark (device state lost)
    crash_rounds: int = 6          # rounds a crashed replica stays dark
    brownout_prob: float = 0.0     # replica stalls, probes turn slow
    brownout_rounds: int = 4
    brownout_latency_s: float = 1.0   # what the health probe observes
    admit_prob: float = 0.0        # transient admission refusal queued
    kill_at: Tuple[Tuple[int, int, str], ...] = ()
    max_down: Optional[int] = None    # fault budget; default n_replicas - 1


class ClusterChaos:
    """Seeded replica-scale fault injector for a cluster front end.

    Pass it as ``chaos=`` to :meth:`ClusterFrontEnd.run`: :meth:`inject`
    fires at the top of every virtual-clock round and arms faults on the
    :class:`~repro_torch.serve.cluster.Replica` wrappers (crash and stall
    timers, queued admission refusals).  Each kind draws from its own
    ``(seed, kind)`` stream (:func:`fault_rng`), and every per-replica
    draw happens whether or not the fault fires, so a fault schedule is a
    function of the config alone, whatever the cluster's state.
    ``max_down`` keeps at least one replica standing: chaos may slow the
    drain, never wedge it."""

    def __init__(self, cfg: ClusterChaosConfig = ClusterChaosConfig()):
        self.cfg = cfg
        self.rngs = {k: fault_rng(cfg.seed, k)
                     for k in ("crash", "brownout", "admit")}
        self.crashes = 0
        self.brownouts = 0
        self.admit_faults = 0

    def _down(self, front) -> int:
        return sum(1 for r in front.replicas
                   if r.crash_rounds > 0 or r.stall_rounds > 0
                   or r.state == "quarantined")

    def _budget(self, front) -> int:
        cap = self.cfg.max_down
        if cap is None:
            cap = len(front.replicas) - 1
        return cap - self._down(front)

    def fire(self, rep, kind: str) -> None:
        if kind == "crash":
            rep.crash_rounds = self.cfg.crash_rounds
            self.crashes += 1
        elif kind == "brownout":
            rep.stall_rounds = self.cfg.brownout_rounds
            rep.probe_latency_s = self.cfg.brownout_latency_s
            self.brownouts += 1
        elif kind == "admit":
            rep.admit_faults += 1
            self.admit_faults += 1
        else:
            raise ValueError(f"unknown cluster fault kind {kind!r}")

    def inject(self, front) -> None:
        now = front.round
        for rnd, idx, kind in self.cfg.kill_at:
            if rnd == now:
                self.fire(front.replicas[idx], kind)
        for rep in front.replicas:
            # draw before the gate: the streams advance alike whatever fires
            if (self.rngs["crash"].random() < self.cfg.crash_prob
                    and rep.crash_rounds == 0 and self._budget(front) > 0):
                self.fire(rep, "crash")
            if (self.rngs["brownout"].random() < self.cfg.brownout_prob
                    and rep.stall_rounds == 0 and rep.crash_rounds == 0
                    and self._budget(front) > 0):
                self.fire(rep, "brownout")
            if self.rngs["admit"].random() < self.cfg.admit_prob:
                self.fire(rep, "admit")


# ----------------------------------------------------------------------
# faults of the disaggregated hand-off
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class DisaggChaosConfig:
    """The fault mix of :class:`DisaggChaos`: per buffer in transit, per
    round, flip a byte inside the checksummed span.  The decode pool's
    import must catch every hit at swap-in (the checksum) and recover by
    recompute."""
    seed: int = 0
    corrupt_prob: float = 0.0


class DisaggChaos:
    """Seeded fault injector for a
    :class:`~repro_torch.serve.cluster.DisaggPool`.

    Pass it as ``chaos=`` to :meth:`DisaggPool.run`: :meth:`inject` fires
    at the top of every round, while shipped prefill pages are in flight
    between the pools.  It draws from the ``(seed, "transfer")`` stream,
    one draw per buffer in transit per round, fired or not, so its
    schedule moves no other kind's."""

    def __init__(self, cfg: DisaggChaosConfig = DisaggChaosConfig()):
        self.cfg = cfg
        self.rng = fault_rng(cfg.seed, "transfer")
        self.corruptions = 0

    def inject(self, pool) -> None:
        if self.cfg.corrupt_prob <= 0:
            return
        for t in pool._transit:
            if self.rng.random() < self.cfg.corrupt_prob:
                corrupt_entry(t.entry)
                self.corruptions += 1
