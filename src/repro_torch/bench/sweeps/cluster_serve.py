"""Fault-tolerant cluster front-end sweep: the data-parallel arbiter under
open-loop traffic and replica-kill schedules (the port of
``repro.bench.sweeps.cluster_serve``).

Replicas are whole memory *ports* and the host-side router is the port
arbiter: sustained throughput is set by how the arbiter behaves under
contention and faults, not by peak bandwidth per port.  The sweep drives
a 2-replica :class:`~repro_torch.serve.cluster.ClusterFrontEnd` with a
seeded open-loop workload (Poisson and bursty arrivals, Zipf-shared
prefixes, mixed lengths, on the virtual clock) and emits:

- a timed row: warm tokens/s of the undisturbed open-loop drain;
- deterministic rows the comparator's structural gate trusts on any
  host: TTFT/TPOT p50/p99 in virtual rounds (scheduling reads lengths
  and budgets, never token values), the failover count under a pinned
  replica-kill, brownout and admission-fault schedule, the equality of
  that chaos drain's tokens with the undisturbed drain's (1.0, or the
  sweep raises: a failover resumes by recompute on a survivor and replays
  the ``(seed, rid)`` key chain), and the shed rate of a workload with
  deadlines.

At ``fast`` the rows keep the reference's sizes and smoke gemma-2b in
float32, and every deterministic column equals the reference's.  On the
card the sweep runs full-width gemma-2b in float32 at the reference's
larger mix (16 requests) with two trials, not three: float32, because
the chaos gate is bitwise and in bfloat16 a recomputed row (from a
prefill chunk) rounds differently from the decode step that first wrote
it (``preempt_serve``'s rule).  Both replicas share one weight tree on
the card.  Walls are the host's clock around a drain that ends in a
device synchronise.
"""
import time

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.bench.sweeps.serve import _sync, float32_gemma


@register("cluster_serve",
          "§6 port arbiter: fault-tolerant DP front end, open-loop SLOs")
def run_cluster_serve(ctx: SweepContext) -> None:
    from repro_torch.serve import (ClusterChaos, ClusterChaosConfig,
                                   ClusterFrontEnd, ServeEngine,
                                   TrafficConfig, generate_traffic)

    cfg, bundle, params = float32_gemma(ctx)
    n_req = 8 if ctx.fast else 16
    trials = 2
    kw = dict(batch_size=2, max_len=64, cache_backend="paged",
              prefill_chunk=8, window=4, seed=0, device=ctx.device)
    front = ClusterFrontEnd([ServeEngine(bundle, params, **kw),
                             ServeEngine(bundle, params, **kw)])

    # out_lo > window, so every request spans >= 2 decode rounds and the
    # TPOT percentiles stay positive (zero would gate nothing)
    tcfg = TrafficConfig(seed=23, n_requests=n_req, rate=1.2,
                         burst_rate_mult=3.0, phase_rounds=4.0,
                         n_prefixes=3, prefix_len=16, tail_lo=3, tail_hi=9,
                         out_lo=6, out_hi=12)

    def drain(traffic, chaos=None):
        """A fresh schedule (serving mutates requests) over reset
        engines; returns (rid -> tokens, wall seconds)."""
        front.reset()
        sched = generate_traffic(traffic, cfg.vocab_size)
        _sync(ctx.device)
        t0 = time.perf_counter()
        front.run(sched, chaos=chaos)
        _sync(ctx.device)
        wall = time.perf_counter() - t0
        return {r.rid: list(r.out_tokens) for _, r in sched}, wall

    # -- the undisturbed open-loop drain: timed, and SLO percentiles ------
    want = None
    walls = []
    for i in range(trials + 1):            # +1 cold drain: meets the shapes
        want, wall = drain(tcfg)
        if i > 0:
            walls.append(wall)
    stats = front.stats()
    pct = front.percentiles()
    rounds = front.cstats.rounds
    timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                    trials=trials)
    ctx.emit("cluster_serve_open_loop", timing=timing,
             us=timing.best_s / max(1, stats.tokens_out) * 1e6,
             tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
             tokens_out=stats.tokens_out, rounds=rounds,
             replicas=len(front.replicas))
    if front.cstats.completed != n_req:
        raise AssertionError(
            f"undisturbed open-loop drain completed "
            f"{front.cstats.completed}/{n_req} requests")
    for mname, val in sorted(pct.items()):
        if val <= 0:
            raise AssertionError(f"{mname} = {val}: virtual-clock "
                                 "percentiles must be positive")
        ctx.emit(f"cluster_serve_{mname}",
                 gbps_measured=val, gbps_predicted=val,
                 deterministic=True, rounds=rounds,
                 metric=f"{mname} in virtual rounds under the open-loop "
                        "Poisson/Zipf workload (deterministic: the clock "
                        "never sees token values)")

    # -- replica kill, brownout and admission faults ---------------------
    # crash replica 1 early (its queued and in-flight work fails over),
    # brown out replica 0 later (slow probes -> quarantine), and arm one
    # transient admission refusal per replica (bounded retry and backoff)
    chaos = ClusterChaos(ClusterChaosConfig(
        seed=5, crash_rounds=4, brownout_rounds=4, brownout_latency_s=1.0,
        kill_at=((0, 0, "admit"), (0, 1, "admit"),
                 (2, 1, "crash"), (12, 0, "brownout"))))
    got, _ = drain(tcfg, chaos=chaos)
    c = front.cstats
    if got != want:
        diverged = sorted(r for r in want if got.get(r) != want[r])
        raise AssertionError(
            f"chaos drain diverged from the undisturbed run on rids "
            f"{diverged}: failover must replay the per-(seed, rid) "
            "PRNG chain bitwise")
    if c.failovers < 1 or c.quarantines < 1:
        raise AssertionError(
            f"kill schedule injected no failovers (failovers="
            f"{c.failovers}, quarantines={c.quarantines}): the gate "
            "proved nothing")
    if c.retries < 1:
        raise AssertionError("armed admission faults were never consumed")
    ctx.emit("cluster_serve_chaos_match",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             crashes=chaos.crashes, brownouts=chaos.brownouts,
             retries=c.retries, quarantines=c.quarantines,
             recoveries=c.recoveries,
             metric="replica-kill + brownout + admission-fault drain is "
                    "bitwise identical to the undisturbed run "
                    "(1.0 = exact)")
    ctx.emit("cluster_serve_failover_count",
             gbps_measured=float(c.failovers),
             gbps_predicted=float(c.failovers), deterministic=True,
             metric="requests failed over off quarantined replicas under "
                    "the pinned kill schedule (deterministic)")

    # -- deadlines: the shed rate under congestion -----------------------
    # a hotter arrival rate and tight deadlines make the router shed low-
    # priority requests and degrade borderline ones instead of wedging;
    # high-priority requests are never shed (slo_risk counts their routes
    # at risk)
    dcfg = TrafficConfig(seed=29, n_requests=max(12, n_req), rate=6.0,
                         burst_rate_mult=2.0, phase_rounds=4.0,
                         n_prefixes=3, prefix_len=16, tail_lo=3, tail_hi=9,
                         out_lo=6, out_hi=12, deadline_rounds=(2, 10),
                         high_priority_frac=0.25)
    drain(dcfg)
    d = front.cstats
    n_sub = d.submitted
    shed_rate = d.shed / max(1, n_sub)
    if not 0.0 < shed_rate < 1.0:
        raise AssertionError(
            f"deadline workload shed {d.shed}/{n_sub}: the shed-rate "
            "gate needs congestion that sheds some but not all requests")
    if d.completed + d.shed != n_sub:
        raise AssertionError(
            f"request conservation broke: {d.completed} completed + "
            f"{d.shed} shed != {n_sub} submitted")
    ctx.emit("cluster_serve_shed_rate",
             gbps_measured=shed_rate, gbps_predicted=shed_rate,
             deterministic=True, shed=d.shed, submitted=n_sub,
             degraded=d.degraded, slo_risk=d.slo_risk,
             metric="deadline-shed fraction under the congested workload "
                    "(deterministic: low-priority blown-deadline requests "
                    "shed, borderline ones degrade)")
