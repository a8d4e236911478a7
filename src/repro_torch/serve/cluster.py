"""Fault-tolerant cluster front end and disaggregated prefill/decode
pools: the host-side arbiter over engine replicas (the port of
``repro.serve.cluster``).

In the paper's framing tensor parallelism adds memory channels behind one
request stream while data parallelism adds whole *ports*, and sustained
throughput is set by how the arbitration layer behaves under contention
and pathological mixes, not by peak bandwidth per port.
:class:`ClusterFrontEnd` is that arbiter, and it survives the ports
failing:

- **health probes and a circuit breaker**: every round each replica is
  probed; consecutive failed probes (a crash) or slow ones (a brownout)
  trip it into ``QUARANTINED``, its queued and in-flight requests are
  evacuated and routed to survivors, and consecutive healthy probes close
  the circuit again;
- **lossless failover**: evacuation is the engine's preemption
  (``ServeEngine.evacuate`` / ``ServeEngine.adopt``): a failed-over
  request resumes on a survivor by recompute, and the ``(seed, rid)`` key
  chains depend only on the request, so the drain gives the undisturbed
  tokens wherever a recomputed row equals the decoded one (float32);
- **cache-aware routing**: replicas are scored by their predicted
  prefix-cache hit (``PrefixIndex.match_len`` over the request's chain
  hashes) less a committed-load term, suspect replicas penalised;
- **deadline-aware admission**: requests carry a ``deadline`` (virtual
  rounds) and a class (``priority``); when the predicted queue delay
  blows the deadline the router degrades (``max_new_tokens`` shrunk to
  fit, above a floor) or sheds a low-priority request.  High-priority
  requests are never shed: they route at risk, counted in ``slo_risk``;
- **a virtual clock**: one round is probe, route, and one admission and
  decode window per healthy replica.  Scheduling reads only lengths and
  budgets, never token values, so the TTFT/TPOT percentiles in rounds
  are the reference's on any host and any device.

Transient admission refusals (:class:`TransientAdmitError`) retry a
bounded number of times with exponential backoff per replica; a request
that exhausts its retries is shed, never silently dropped.

:class:`DisaggPool` splits prefill from decode: the prefill pool ships
each finished prompt's pages to the decode pool as a checksummed transfer
entry, priced against a decode-side re-prefill by the shared
:class:`~repro_torch.serve.scheduler.SwapCostModel`.

Engines of one front end or pool may share one device and one parameter
tree; the rounds run them one after another on the device's current
stream, which is what lets them share K1's arrival counters
(:func:`repro_torch.kernels.decode_core.arrival_counters`, one buffer per
device and stream).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Request, ServeEngine, ServeStats
from repro_torch.serve.hosttier import HostKVEntry
from repro_torch.serve.kvcache import page_hashes
from repro_torch.serve.scheduler import PRIORITY_HIGH, SwapCostModel

# replica health states (the circuit breaker)
HEALTHY = "healthy"
SUSPECT = "suspect"          # strikes accumulating; routed only as last resort
QUARANTINED = "quarantined"  # circuit open: evacuated, probing for recovery


class TransientAdmitError(RuntimeError):
    """A replica refused an admission transiently (an RPC blip, an
    admission hiccup).  The router retries with bounded backoff: never an
    outage, never a silent drop."""


def aggregate_stats(engines: Iterable[ServeEngine]) -> ServeStats:
    """Every ServeStats field summed across engines (peaks sum too: the
    pool's total live-page commitment)."""
    agg = ServeStats()
    for eng in engines:
        for f in dataclasses.fields(ServeStats):
            setattr(agg, f.name,
                    getattr(agg, f.name) + getattr(eng.stats, f.name))
    return agg


@dataclass(frozen=True)
class ProbeResult:
    ok: bool
    latency_s: float = 0.0


@dataclass(frozen=True)
class ClusterConfig:
    # -- health / circuit breaker ---------------------------------------
    fail_threshold: int = 2      # consecutive failed probes -> quarantine
    slow_threshold: int = 3      # consecutive slow probes   -> quarantine
    slow_probe_s: float = 0.1    # probe latency beyond this is a strike
    recovery_probes: int = 2     # consecutive clean probes close the circuit
    # -- cache-aware routing --------------------------------------------
    cache_weight: float = 4.0    # per predicted prefix-hit token
    load_weight: float = 1.0     # per committed pending token-unit
    suspect_penalty: float = 1e5  # added cost while a replica is SUSPECT
    max_replica_queue: int = 4   # routed-but-unadmitted requests per replica
    # -- transient-admission retry policy -------------------------------
    max_retries: int = 8         # per request, across replicas
    backoff_base: int = 1        # rounds; doubles per consecutive refusal
    backoff_cap: int = 8
    # -- deadline admission ---------------------------------------------
    degrade: bool = True         # shrink max_new_tokens to fit a deadline
    degrade_floor: int = 1       # never degrade below this many tokens


@dataclass
class ClusterStats:
    """Router counters (the engines' counters stay in ServeStats)."""
    submitted: int = 0
    routed: int = 0           # successful dispatches (failovers re-count)
    completed: int = 0
    shed: int = 0             # deadline- or retry-shed, never served
    degraded: int = 0         # max_new_tokens shrunk to fit a deadline
    slo_risk: int = 0         # high-priority routed despite predicted miss
    failovers: int = 0        # requests moved off a quarantined replica
    quarantines: int = 0
    recoveries: int = 0
    probe_failures: int = 0
    slow_probes: int = 0
    retries: int = 0          # transient-admission refusals absorbed
    rounds: int = 0           # virtual clock at drain


@dataclass
class _Lat:
    """One request's latency record in virtual rounds."""
    arrival: int
    first: Optional[int] = None    # round the first token appeared (TTFT)
    finish: Optional[int] = None
    tokens: int = 0


class Replica:
    """One engine port behind the router: health and backoff bookkeeping
    plus the fault surface :class:`~repro_torch.serve.chaos.ClusterChaos`
    arms (crash and stall timers, queued admission refusals).  A crashed
    replica loses its device state but keeps the host's bookkeeping, the
    split that makes recompute failover lossless."""

    def __init__(self, index: int, engine: ServeEngine):
        self.index = index
        self.engine = engine
        self.reset()

    def reset(self) -> None:
        self.state = HEALTHY
        self.failed_probes = 0
        self.slow_streak = 0
        self.ok_probes = 0
        self.admit_streak = 0       # consecutive transient refusals
        self.backoff_until = 0      # router round before which no routing
        self.routed = 0             # requests dispatched here
        # the fault surface (ClusterChaos writes these)
        self.crash_rounds = 0
        self.stall_rounds = 0
        self.probe_latency_s = 0.0
        self.admit_faults = 0

    # -- fault surface --------------------------------------------------
    @property
    def crashed(self) -> bool:
        return self.crash_rounds > 0

    def tick_faults(self) -> None:
        if self.crash_rounds > 0:
            self.crash_rounds -= 1
        if self.stall_rounds > 0:
            self.stall_rounds -= 1
            if self.stall_rounds == 0:
                self.probe_latency_s = 0.0

    # -- the router's view ----------------------------------------------
    def probe(self) -> ProbeResult:
        if self.crashed:
            return ProbeResult(False, float("inf"))
        return ProbeResult(True, self.probe_latency_s)

    def submit(self, req: Request) -> None:
        if self.admit_faults > 0:
            self.admit_faults -= 1
            raise TransientAdmitError(
                f"replica {self.index} refused rid {req.rid}")
        self.engine.adopt(req)
        self.routed += 1

    def step_round(self) -> None:
        """One admission and decode-window round, unless dark or
        stalled."""
        if self.crashed or self.stall_rounds > 0:
            return
        eng = self.engine
        eng._admit()
        if any(s is not None for s in eng.slots):
            eng.decode_many(eng.window)

    def load(self) -> int:
        eng = self.engine
        return len(eng.queue) + sum(s is not None for s in eng.slots)

    def pending_units(self) -> int:
        """Token-units of work committed here: remaining new tokens plus
        the prefill chunks still owed, over queue and slots.  The router's
        queue-delay currency, which reads lengths and budgets only."""
        eng = self.engine
        chunk = getattr(eng, "prefill_chunk", None) or eng.max_len
        units = 0
        for req in list(eng.queue) + [s for s in eng.slots if s is not None]:
            units += max(0, req.max_new_tokens - len(req.out_tokens))
            units += -(-len(req.prompt) // chunk)
        return units

    def predicted_hit_tokens(self, prompt: np.ndarray) -> int:
        """Prefix-cache tokens this replica would serve for ``prompt``,
        priced from the chain hashes admission uses (full pages only, and
        never the final page: the engine feeds the last prompt token
        again)."""
        eng = self.engine
        prefix = getattr(eng, "prefix", None)
        if prefix is None:
            return 0
        usable = (len(prompt) - 1) // eng.page
        if usable < 1:
            return 0
        hashes = page_hashes(np.asarray(prompt, np.int32), eng.page)
        return prefix.match_len(hashes[:usable], eng.alloc) * eng.page


class ClusterFrontEnd:
    """The data-parallel arbiter: submit requests (or an open-loop
    arrival schedule), :meth:`run` the virtual clock until drained, read
    :meth:`stats` and :meth:`percentiles`.  All replicas share the
    sampling seed: per-``(seed, rid)`` key chains are what make failover
    across replicas lossless."""

    def __init__(self, engines: Sequence[ServeEngine],
                 config: Optional[ClusterConfig] = None):
        if not engines:
            raise ValueError("ClusterFrontEnd needs at least one engine")
        if len({e.seed for e in engines}) > 1:
            raise ValueError(
                "replicas must share the sampling seed: per-(seed, rid) "
                "PRNG streams are what make failover lossless")
        self.cfg = config or ClusterConfig()
        self.replicas = [Replica(i, e) for i, e in enumerate(engines)]
        self._init_state()

    def _init_state(self) -> None:
        self.round = 0
        self.backlog: Deque[Request] = deque()
        self.cstats = ClusterStats()
        self.owner: Dict[int, int] = {}      # rid -> replica index (last)
        self.shed_requests: List[Request] = []
        self._live: Dict[int, Request] = {}  # rid -> unfinished, tracked
        self._lat: Dict[int, _Lat] = {}
        self._retries: Dict[int, int] = {}

    def reset(self) -> None:
        """A fresh run over the same engines."""
        for rep in self.replicas:
            rep.engine.reset()
            rep.reset()
        self._init_state()

    @property
    def engines(self) -> List[ServeEngine]:
        return [rep.engine for rep in self.replicas]

    def stats(self) -> ServeStats:
        return aggregate_stats(self.engines)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.cstats.submitted += 1
        self._lat[req.rid] = _Lat(arrival=self.round)
        self._live[req.rid] = req
        self.backlog.append(req)

    # -- health ---------------------------------------------------------
    def _quarantine(self, rep: Replica, *, crash: bool) -> None:
        """Open the circuit: evacuate everything (queued and in flight)
        for routing again.  After a *crash* the device memory is gone, so
        the prefix index drops its pins too, and a recovered replica never
        serves ghost pages."""
        rep.state = QUARANTINED
        rep.ok_probes = 0
        self.cstats.quarantines += 1
        moved = rep.engine.evacuate()
        prefix = getattr(rep.engine, "prefix", None)
        if crash and prefix is not None and rep.engine.alloc is not None:
            prefix.evict_unused(rep.engine.alloc)
        live = [r for r in moved if not r.done and r.rid in self._live]
        self.cstats.failovers += len(live)
        for r in reversed(live):      # failovers route ahead of the backlog
            self.backlog.appendleft(r)

    def _probe_round(self) -> None:
        cfg = self.cfg
        for rep in self.replicas:
            pr = rep.probe()
            if not pr.ok:
                self.cstats.probe_failures += 1
                rep.slow_streak = rep.ok_probes = 0
                rep.failed_probes += 1
                if rep.state == QUARANTINED:
                    continue
                if rep.failed_probes >= cfg.fail_threshold:
                    self._quarantine(rep, crash=True)
                else:
                    rep.state = SUSPECT
            elif pr.latency_s > cfg.slow_probe_s:
                self.cstats.slow_probes += 1
                rep.failed_probes = rep.ok_probes = 0
                rep.slow_streak += 1
                if rep.state == QUARANTINED:
                    continue
                if rep.slow_streak >= cfg.slow_threshold:
                    self._quarantine(rep, crash=False)
                else:
                    rep.state = SUSPECT
            else:
                rep.failed_probes = rep.slow_streak = 0
                if rep.state == QUARANTINED:
                    rep.ok_probes += 1
                    if rep.ok_probes >= cfg.recovery_probes:
                        rep.state = HEALTHY
                        self.cstats.recoveries += 1
                elif rep.state == SUSPECT:
                    rep.state = HEALTHY

    # -- routing --------------------------------------------------------
    def _routable(self, rep: Replica) -> bool:
        return (rep.state != QUARANTINED
                and self.round >= rep.backoff_until
                and rep.load() < rep.engine.bsz + self.cfg.max_replica_queue)

    def _score(self, rep: Replica, req: Request) -> float:
        s = (self.cfg.cache_weight * rep.predicted_hit_tokens(req.prompt)
             - self.cfg.load_weight * rep.pending_units())
        if rep.state == SUSPECT:
            s -= self.cfg.suspect_penalty
        return s

    def _shed(self, req: Request) -> None:
        self.cstats.shed += 1
        self.shed_requests.append(req)
        self._live.pop(req.rid, None)

    def _admit_deadline(self, req: Request, rep: Replica) -> bool:
        """The deadline check against the chosen replica's predicted queue
        delay.  False when the request was shed instead."""
        if req.deadline is None:
            return True
        if req.out_tokens:
            return True   # a failover mid-stream holds delivered tokens:
                          # routing it again must never shed it
        eng = rep.engine
        cap = max(1, eng.bsz * eng.window)       # token-units per round
        chunk = getattr(eng, "prefill_chunk", None) or eng.max_len
        prompt_cost = -(-len(req.prompt) // chunk)
        slack = ((req.deadline - self.round) * cap
                 - rep.pending_units() - prompt_cost)
        if slack >= req.max_new_tokens:
            return True
        if self.cfg.degrade and slack >= self.cfg.degrade_floor:
            req.max_new_tokens = int(slack)      # graceful degradation
            self.cstats.degraded += 1
            return True
        if req.priority >= PRIORITY_HIGH:
            self.cstats.slo_risk += 1            # never shed the high class
            return True
        self._shed(req)
        return False

    def _route_round(self) -> None:
        deferred: Deque[Request] = deque()
        while self.backlog:
            req = self.backlog.popleft()
            cands = [r for r in self.replicas if self._routable(r)]
            if not cands:
                deferred.append(req)
                deferred.extend(self.backlog)
                self.backlog.clear()
                break
            rep = max(cands, key=lambda r: (self._score(r, req), -r.index))
            if not self._admit_deadline(req, rep):
                continue
            try:
                rep.submit(req)
            except TransientAdmitError:
                self.cstats.retries += 1
                rep.admit_streak += 1
                rep.backoff_until = self.round + min(
                    self.cfg.backoff_base * (2 ** (rep.admit_streak - 1)),
                    self.cfg.backoff_cap)
                n = self._retries.get(req.rid, 0) + 1
                self._retries[req.rid] = n
                if n > self.cfg.max_retries:
                    self._shed(req)
                else:
                    deferred.append(req)
                continue
            rep.admit_streak = 0
            self.owner[req.rid] = rep.index
            self.cstats.routed += 1
        self.backlog = deferred

    # -- latency accounting ---------------------------------------------
    def _harvest(self) -> None:
        for rid in list(self._live):
            req = self._live[rid]
            lat = self._lat[rid]
            if lat.first is None and req.out_tokens:
                lat.first = self.round
            if req.done:
                lat.finish = self.round
                lat.tokens = len(req.out_tokens)
                self.cstats.completed += 1
                del self._live[rid]

    # ------------------------------------------------------------------
    def step(self, arrivals: Optional[Deque[Tuple[int, Request]]] = None
             ) -> bool:
        """One virtual-clock round.  False once fully drained.

        The replicas' windows run one after another from this thread, so
        replicas on one card queue their kernels on one stream, in order:
        K1's arrival counters (one buffer per device and stream) are
        never in use by two launches at once."""
        if arrivals is not None:
            while arrivals and arrivals[0][0] <= self.round:
                self.submit(arrivals.popleft()[1])
        self._probe_round()
        self._route_round()
        for rep in self.replicas:
            if rep.state != QUARANTINED:
                rep.step_round()
        self._harvest()
        for rep in self.replicas:
            rep.tick_faults()
        self.round += 1
        self.cstats.rounds = self.round
        return bool(self.backlog or self._live or arrivals)

    def run(self, schedule: Sequence[Tuple[int, Request]] = (),
            chaos=None, max_rounds: int = 100_000) -> ServeStats:
        """Drain an open-loop arrival schedule (``(round, request)``
        pairs) under optional :class:`ClusterChaos` injection."""
        arrivals = deque(sorted(schedule, key=lambda t: (t[0], t[1].rid)))
        for _ in range(max_rounds):
            if chaos is not None:
                chaos.inject(self)
            if not self.step(arrivals):
                return self.stats()
        agg = self.stats()
        raise RuntimeError(
            f"cluster failed to drain in {max_rounds} rounds: "
            f"{len(self._live)} live, {len(self.backlog)} backlogged, "
            f"states={[r.state for r in self.replicas]}, "
            f"aggregate tokens_out={agg.tokens_out}, "
            f"prefills={agg.prefills}")

    def percentiles(self) -> Dict[str, float]:
        """TTFT / TPOT p50/p99 in virtual rounds over completed requests,
        the same on any host (the clock never sees token values).  TTFT
        is 1-based: a request whose first token lands in its arrival round
        scores 1.  Shed requests are left out; their rate is
        ``cstats.shed / cstats.submitted``."""
        return latency_percentiles(self._lat.values())


def latency_percentiles(lats: Iterable[_Lat]) -> Dict[str, float]:
    """TTFT/TPOT p50/p99 in virtual rounds (1-based TTFT; see
    :meth:`ClusterFrontEnd.percentiles`), shared by both topologies."""
    lats = list(lats)
    ttft = [lat.first - lat.arrival + 1 for lat in lats
            if lat.first is not None]
    done = [lat for lat in lats if lat.finish is not None]
    tpot = [(lat.finish - lat.first) / max(1, lat.tokens - 1)
            for lat in done]

    def pct(xs: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs, np.float64), q)) \
            if xs else 0.0

    return dict(ttft_p50=pct(ttft, 50), ttft_p99=pct(ttft, 99),
                tpot_p50=pct(tpot, 50), tpot_p99=pct(tpot, 99))


# ----------------------------------------------------------------------
# disaggregated prefill/decode topology
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class DisaggConfig:
    """Knobs for :class:`DisaggPool`.

    ``link_bw`` prices the prefill -> decode page shipment in the
    :class:`~repro_torch.serve.scheduler.SwapCostModel`: a transfer costs
    one gather off the prefill engine and one scatter into the decode
    engine, the two link crossings a swap makes, so ``choose(prompt_len,
    swappable=True)`` is the router's disagg-or-colocated break-even.  It
    is the pool's configured link (the reference's 32 GB/s by default),
    not the card's host link.  ``transit_rounds`` is how many rounds of
    the virtual clock a transfer spends in flight (the chaos harness
    corrupts buffers only in transit)."""

    link_bw: float = 32e9
    transit_rounds: int = 1
    # "disagg" / "colocated" pins the route of every request (tests and
    # the sweep's gates); None leaves it to the cost model per prompt
    force: Optional[str] = None


@dataclass
class DisaggStats:
    """Router counters of the disaggregated topology (the engines'
    counters, exports, imports, transfer bytes and fallbacks included,
    stay in the aggregated :class:`~repro_torch.serve.engine.ServeStats`)."""
    submitted: int = 0
    disagg_routed: int = 0       # sent to the prefill pool (will transfer)
    colocated_routed: int = 0    # the cost model kept prefill and decode
    transfers: int = 0           # buffers delivered to the decode pool
    completed: int = 0
    rounds: int = 0


@dataclass
class _Transfer:
    """One finished prefill in flight between the pools."""
    req: Request
    entry: HostKVEntry
    due: int                     # round at which it lands


class DisaggPool:
    """Disaggregated prefill/decode serving over two pools of engines.

    The prefill pool runs chunked prefill only: when a request's prompt
    completes (its seed token emitted) its pages, k/v and the int8 scale
    lanes (gathered per shard and assembled whole on the host under TP),
    leave as a checksummed transfer entry
    (:meth:`ServeEngine.export_finished_prefill`) and travel
    ``transit_rounds`` of the virtual clock.  The decode pool lands each
    entry (:meth:`ServeEngine.import_prefill`) through the swap-in path:
    reserve pages, scatter through the page table, replay the ``(seed,
    rid)`` key chain, feed the pending token.  Every piece of carried
    state is shipped exactly (pages, under a checksum) or derived again
    from ``(seed, rid)`` (keys), so the drain gives a colocated drain's
    tokens; a corrupted transfer falls back to a decode-side recompute of
    the prompt, which gives them too where a recomputed row equals the
    decoded one (float32).

    Routing: the shared :class:`SwapCostModel` (its link at ``link_bw``)
    prices the shipment against a decode-side prefill; when the link is
    the bottleneck the request goes *colocated* to the decode pool, which
    prefills it itself.  ``force`` pins the decision.
    """

    def __init__(self, prefill_engines: Sequence[ServeEngine],
                 decode_engines: Sequence[ServeEngine],
                 config: Optional[DisaggConfig] = None):
        if not prefill_engines or not decode_engines:
            raise ValueError("DisaggPool needs >= 1 prefill and >= 1 decode "
                             "engine")
        self.cfg = config or DisaggConfig()
        if self.cfg.force not in (None, "disagg", "colocated"):
            raise ValueError(f"unknown force policy {self.cfg.force!r}")
        engines = list(prefill_engines) + list(decode_engines)
        if len({e.seed for e in engines}) > 1:
            raise ValueError(
                "pools must share the sampling seed: per-(seed, rid) PRNG "
                "streams are what make the hand-off lossless")
        if len({e.max_len for e in engines}) > 1:
            raise ValueError("pools must share max_len")
        for eng in engines:
            if eng.backend != "paged" or eng.host_tier is None:
                raise ValueError(
                    "disaggregation requires paged engines with the host "
                    "swap tier (pure full-attention stack, swap enabled) "
                    "on both pools")
        if len({e.page for e in engines}) > 1:
            raise ValueError(
                "pools must share the page size: the transfer buffer is "
                "scattered page-for-page into the decode pool's table")
        self.prefill_engines = list(prefill_engines)
        self.decode_engines = list(decode_engines)
        # the shipment's price, from the decode pool's geometry: each
        # decode-side prefill chunk streams the weights again; each
        # shipped context row crosses the link twice (gather and scatter)
        eng = self.decode_engines[0]
        self.cost_model = SwapCostModel(
            weight_bytes=eng.weight_bytes, kv_bytes_per_token=eng.bytes_per_page / eng.page,
            prefill_chunk=eng.prefill_chunk, host_link_bw=self.cfg.link_bw)
        self._init_state()

    def _init_state(self) -> None:
        self.round = 0
        self.dstats = DisaggStats()
        self._transit: List[_Transfer] = []
        self._live: Dict[int, Request] = {}
        self._lat: Dict[int, _Lat] = {}

    def reset(self) -> None:
        """A fresh run over the same engines."""
        for eng in self.engines:
            eng.reset()
        self._init_state()

    @property
    def engines(self) -> List[ServeEngine]:
        return self.prefill_engines + self.decode_engines

    def stats(self) -> ServeStats:
        return aggregate_stats(self.engines)

    def percentiles(self) -> Dict[str, float]:
        return latency_percentiles(self._lat.values())

    # ------------------------------------------------------------------
    @staticmethod
    def _least_loaded(engines: List[ServeEngine]) -> ServeEngine:
        return min(engines, key=lambda e: (
            len(e.queue) + sum(s is not None for s in e.slots)))

    def route(self, req: Request) -> str:
        """``"disagg"`` or ``"colocated"`` for this request."""
        if self.cfg.force is not None:
            return self.cfg.force
        choice = self.cost_model.choose(len(req.prompt), swappable=True)
        return "disagg" if choice == "swap" else "colocated"

    def submit(self, req: Request) -> None:
        self.dstats.submitted += 1
        self._lat[req.rid] = _Lat(arrival=self.round)
        self._live[req.rid] = req
        if self.route(req) == "disagg":
            self._least_loaded(self.prefill_engines).add_request(req)
            self.dstats.disagg_routed += 1
        else:
            self._least_loaded(self.decode_engines).add_request(req)
            self.dstats.colocated_routed += 1

    # ------------------------------------------------------------------
    def _deliver(self) -> None:
        landed = [t for t in self._transit if t.due <= self.round]
        if not landed:
            return
        self._transit = [t for t in self._transit if t.due > self.round]
        for t in landed:
            self._least_loaded(self.decode_engines).import_prefill(
                t.req, t.entry)
            self.dstats.transfers += 1

    def _prefill_round(self) -> None:
        for eng in self.prefill_engines:
            eng._admit()
            for i, req in enumerate(eng.slots):
                if req is None or i in eng._pending:
                    continue
                if req.done:
                    # met by the prefill alone (max_new_tokens == 1):
                    # retire in place, nothing to ship
                    eng._release_finished(i)
                    continue
                shipped, entry = eng.export_finished_prefill(i)
                self._transit.append(_Transfer(
                    shipped, entry, due=self.round + self.cfg.transit_rounds))

    def _decode_round(self) -> None:
        for eng in self.decode_engines:
            eng._admit()
            if any(s is not None for s in eng.slots):
                eng.decode_many(eng.window)

    def _harvest(self) -> None:
        for rid in list(self._live):
            req = self._live[rid]
            lat = self._lat[rid]
            if lat.first is None and req.out_tokens:
                lat.first = self.round
            if req.done:
                lat.finish = self.round
                lat.tokens = len(req.out_tokens)
                self.dstats.completed += 1
                del self._live[rid]

    def step(self, chaos=None) -> bool:
        """One virtual-clock round: chaos fires on buffers in transit, due
        transfers land on the decode pool, the prefill pool advances one
        admission round and exports what finished, the decode pool runs
        one admission and decode window.  False once drained.

        Both pools' engines run one after another from this thread, so on
        one card their kernels queue on one stream in order, and K1's
        arrival counters (one buffer per device and stream) are never in
        use by two launches at once."""
        if chaos is not None:
            chaos.inject(self)
        self._deliver()
        self._prefill_round()
        self._decode_round()
        self._harvest()
        self.round += 1
        self.dstats.rounds = self.round
        return bool(self._live or self._transit)

    def run(self, chaos=None, max_rounds: int = 10_000) -> ServeStats:
        """Drain everything submitted (under optional
        :class:`~repro_torch.serve.chaos.DisaggChaos` injection)."""
        for _ in range(max_rounds):
            if not self.step(chaos=chaos):
                return self.stats()
        raise RuntimeError(
            f"disagg pool failed to drain in {max_rounds} rounds: "
            f"{len(self._live)} live, {len(self._transit)} in transit")
