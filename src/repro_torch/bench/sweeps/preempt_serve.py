"""Preemptive-scheduling serving sweep: the memory hierarchy's tier
movement applied to whole requests (the port of
``repro.bench.sweeps.preempt_serve``).

Under pool pressure the scheduler evicts a victim's pages and brings the
request back by whichever move the hierarchy prices cheaper: recompute
(stream the weights once per prefill chunk) or a swap through the host
tier (the KV bytes cross the card's host link twice).  The sweep shows
the machinery holds end to end and prices the swap:

- timed rows: warm tokens/s of the undisturbed drain and of the same
  drain under seeded chaos, one row per resume mode (advisory: wall
  clock);
- deterministic rows the comparator's structural gate trusts: the chaos
  drains (storms, forced exhaustion, corrupted swaps) give the
  undisturbed drain's tokens (1.0, or the sweep raises), forced-swap and
  forced-recompute fault coverage, the cost model's recompute/swap ratio
  at an 8192-token context (above 1.0, or the sweep raises), the prefill
  burst under a one-chunk cap, and a late high-priority request finishing
  first under a pool too small for the load;
- advisory rows: the p99 round wall under the capped scheduler, and the
  measured walls of a swap resume and a recompute resume of a long-prompt
  victim.

At ``fast`` every row keeps the reference's sizes and smoke gemma-2b in
float32, and the deterministic columns equal the reference's, save the
swap-advantage value: it prices with the context's spec (the H100's, or a
calibrated one) and the card's host link (64 GB/s), not a TPU's.  On the
card the sweep runs full-width gemma-2b in float32 at the reference's
larger mix (8 requests, 16 new tokens, max_len 128) with two trials, not
three.  Float32, because its gates are bitwise, and in bfloat16 a
recomputed row (from a prefill chunk) rounds differently from the decode
step that first wrote it, as the verify pass does (``spec_serve``'s
rule).  The priority block's pool holds one low request's pages and two
more: 9 pages at ``fast``, as in the reference, whose 9 pages cannot hold
one low request of 48 new tokens at the larger mix.  Walls are the
host's clock around a drain that ends in a device synchronise.
"""
import dataclasses
import time

import numpy as np

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.bench.sweeps.serve import _sync, float32_gemma
from repro_torch.core.patterns import Knobs, Pattern


def _mix(cfg, n_req: int, max_new: int, priorities=False):
    """Deterministic request mix: even rids share a 16-token prefix."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(8)
    common = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    reqs = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).astype(np.int32)
        prompt = (np.concatenate([common, tail]) if i % 2 == 0
                  else np.concatenate([tail, tail]))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new,
                            priority=(i % 2) if priorities else 0))
    return reqs


def _drain(eng, cfg, n_req, max_new, chaos_cfg=None):
    from repro_torch.serve import ChaosEngine

    reqs = _mix(cfg, n_req, max_new)
    for r in reqs:
        eng.add_request(r)
    _sync(eng.device)
    t0 = time.perf_counter()
    if chaos_cfg is None:
        stats = eng.run_to_completion()
    else:
        stats = ChaosEngine(eng, chaos_cfg).run_to_completion()
    _sync(eng.device)
    wall = time.perf_counter() - t0
    return stats, wall, {r.rid: list(r.out_tokens) for r in reqs}


@register("preempt_serve", "§2 memory hierarchy: KV tier movement")
def run_preempt_serve(ctx: SweepContext) -> None:
    from repro_torch.serve import (ChaosConfig, Request, Scheduler,
                                   SchedulerConfig, ServeEngine, ServeStats,
                                   SwapCostModel)

    cfg, bundle, params = float32_gemma(ctx)
    n_req, max_new = (4, 8) if ctx.fast else (8, 16)
    max_len = 64 if ctx.fast else 128
    trials = 2

    def engine(batch_size=2, **kw):
        return ServeEngine(bundle, params, batch_size=batch_size,
                           max_len=max_len, window=4, prefill_chunk=8,
                           cache_backend="paged", device=ctx.device, **kw)

    eng = engine()
    page = eng.page

    # -- the undisturbed drain, timed ------------------------------------
    _drain(eng, cfg, n_req, max_new)       # cold: meets every shape
    walls = []
    for _ in range(trials):
        eng.reset()
        ref_stats, wall, ref_outs = _drain(eng, cfg, n_req, max_new)
        walls.append(wall)
    timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                    trials=trials)
    ctx.emit("preempt_serve_undisturbed", pattern=Pattern.R_ACC,
             knobs=Knobs(burst_bytes=eng.bytes_per_page), timing=timing,
             us=timing.best_s / max(1, ref_stats.tokens_out) * 1e6,
             tok_s=f"{ref_stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
             tokens_out=ref_stats.tokens_out)

    # -- chaos drains (storms, forced exhaustion, corruption) in each
    #    resume mode, every one held to the undisturbed tokens.  Coverage
    #    is the sum over trials: a seed whose only storm lands mid-prefill
    #    (a restart, no swap) is fair chaos --------------------------------
    fault_counts = {}
    for mode in (None, "swap", "recompute"):
        tag = mode or "costmodel"
        walls = []
        totals = ServeStats()
        for t in range(trials):
            eng.reset()
            ccfg = ChaosConfig(seed=13 + t, preempt_prob=0.4,
                               exhaust_prob=0.3, corrupt_prob=0.3, mode=mode)
            stats, wall, outs = _drain(eng, cfg, n_req, max_new, ccfg)
            walls.append(wall)
            for f in dataclasses.fields(ServeStats):
                setattr(totals, f.name,
                        getattr(totals, f.name) + getattr(stats, f.name))
            if outs != ref_outs:
                bad = [rid for rid in ref_outs if outs.get(rid)
                       != ref_outs[rid]]
                raise AssertionError(
                    f"preempted drain (mode={tag}) diverged from the "
                    f"undisturbed drain on rids {bad}: recovery lost "
                    "bitwise equivalence")
        fault_counts[tag] = totals
        timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                        trials=trials)
        ctx.emit(f"preempt_serve_chaos_{tag}", pattern=Pattern.R_ACC,
                 knobs=Knobs(burst_bytes=eng.bytes_per_page), timing=timing,
                 us=timing.best_s / max(1, stats.tokens_out) * 1e6,
                 tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
                 preemptions=totals.preemptions,
                 swap_outs=totals.swap_outs,
                 recompute_resumes=totals.recompute_resumes)

    ctx.emit("preempt_serve_tokens_match",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             tokens_out=ref_stats.tokens_out,
             metric="chaos drains (storm + forced exhaustion + swap "
                    "corruption, all resume modes) == undisturbed drain, "
                    "bitwise (1.0 or the sweep raises)")

    swap_stats = fault_counts["swap"]
    rec_stats = fault_counts["recompute"]
    if swap_stats.preemptions == 0 or rec_stats.preemptions == 0:
        raise AssertionError("chaos storm never preempted a request")
    if swap_stats.swap_outs == 0 or swap_stats.swap_ins == 0:
        raise AssertionError(
            f"forced-swap chaos moved no pages through the host tier "
            f"(outs={swap_stats.swap_outs}, ins={swap_stats.swap_ins})")
    if rec_stats.recompute_resumes == 0:
        raise AssertionError("forced-recompute chaos never resumed a victim")
    ctx.emit("preempt_serve_fault_coverage",
             gbps_measured=float(swap_stats.swap_ins
                                 + rec_stats.recompute_resumes),
             gbps_predicted=1.0, deterministic=True,
             swap_outs=swap_stats.swap_outs,
             swap_ins=swap_stats.swap_ins,
             swap_fallbacks=swap_stats.swap_fallbacks,
             recompute_resumes=rec_stats.recompute_resumes,
             swap_bytes=swap_stats.swap_bytes,
             metric="swap-ins + recompute-resumes exercised by the final "
                    "chaos trials (hard-gated >= 1 of each in-sweep)")

    # -- the cost model: swap beats recompute on long contexts, priced at
    #    production scale (2.5B bf16 weights, gemma-2b KV rows) on the
    #    context's spec and the card's host link -------------------------
    cm = SwapCostModel(weight_bytes=5e9, kv_bytes_per_token=18_432,
                       prefill_chunk=256, spec=ctx.spec)
    long_ctx = 8192
    advantage = cm.recompute_s(long_ctx) / max(cm.swap_s(long_ctx), 1e-12)
    if advantage <= 1.0:
        raise AssertionError(
            f"swap-resume does not beat recompute-resume at ctx="
            f"{long_ctx} (advantage {advantage:.2f}x <= 1.0)")
    ctx.emit("preempt_serve_swap_advantage",
             gbps_measured=advantage, gbps_predicted=1.0, deterministic=True,
             recompute_ms=cm.recompute_s(long_ctx) * 1e3,
             swap_ms=cm.swap_s(long_ctx) * 1e3,
             choice=cm.choose(long_ctx, swappable=True),
             metric=f"modeled recompute/swap resume-time ratio at "
                    f"ctx={long_ctx} (hard-gated > 1.0: swap-resume beats "
                    "recompute-resume on long prompts)")

    # advisory: measured resume walls of a long-prompt victim (smoke
    # weights are tiny at fast, so recompute may win there)
    long_prompt = np.arange(1, 49, dtype=np.int32) % cfg.vocab_size
    measured = {}
    for mode in ("swap", "recompute"):
        eng.reset()
        victim = Request(rid=0, prompt=long_prompt,
                         max_new_tokens=max_new + 4)
        eng.add_request(victim)
        while not victim.out_tokens:
            eng.step()
        eng.preempt(0, mode=mode)
        _sync(eng.device)
        t0 = time.perf_counter()
        eng.run_to_completion()
        _sync(eng.device)
        measured[mode] = time.perf_counter() - t0
    ctx.emit("preempt_serve_resume_walls",
             us=measured["swap"] * 1e6,
             swap_resume_ms=f"{measured['swap'] * 1e3:.2f}",
             recompute_resume_ms=f"{measured['recompute'] * 1e3:.2f}",
             metric="measured drain-after-preemption walls (advisory; "
                    "at fast the smoke weights are KB-scale, so the "
                    "production break-even does not apply)")
    del eng

    # -- SLO: the prefill burst bound, and the p99 round wall -------------
    capped = engine(batch_size=3, scheduler=Scheduler(
        SchedulerConfig(prefill_chunks_per_tick=1)))
    rng = np.random.default_rng(9)
    decode_req = Request(rid=0, prompt=rng.integers(
        1, cfg.vocab_size, size=8).astype(np.int32),
        max_new_tokens=max_len - 24)
    capped.add_request(decode_req)
    while capped._pending:
        capped.step()
    for rid in (1, 2):
        capped.add_request(Request(rid=rid, prompt=rng.integers(
            1, cfg.vocab_size, size=32).astype(np.int32), max_new_tokens=2))
    tick_walls = []
    while any(s is not None for s in capped.slots) or capped.queue:
        t0 = time.perf_counter()
        capped._admit()
        if not any(s is not None for s in capped.slots):
            break
        capped.decode_many(capped.window)
        _sync(capped.device)
        tick_walls.append(time.perf_counter() - t0)
    burst = capped.stats.prefill_burst_max
    if burst > 1:
        raise AssertionError(
            f"prefill burst {burst} exceeded the 1-chunk-per-tick SLO cap "
            "while a decode slot was active")
    ctx.emit("preempt_serve_burst_bound",
             gbps_measured=float(burst), gbps_predicted=1.0,
             deterministic=True,
             prefill_chunks=capped.stats.prefill_chunks,
             metric="max prefill chunks between decode windows under "
                    "prefill_chunks_per_tick=1 (hard-gated <= 1: the "
                    "decode-tick gap — the TPOT tail — is bounded)")
    p99 = float(np.percentile(tick_walls, 99)) if tick_walls else 0.0
    ctx.emit("preempt_serve_p99_tick",
             us=p99 * 1e6,
             p50_us=f"{np.percentile(tick_walls, 50) * 1e6:.0f}",
             ticks=len(tick_walls),
             metric="p99 admit+decode round wall under the capped "
                    "scheduler (advisory: wall clock)")
    del capped

    # -- priorities: high finishes first under an undersized pool: the
    #    null page, one low request's pages and two more ------------------
    tight = engine(num_pages=3 + -(-(20 + 3 * max_new) // page))
    rng = np.random.default_rng(10)
    low = [Request(rid=i, prompt=rng.integers(
        1, cfg.vocab_size, size=20).astype(np.int32),
        max_new_tokens=max_new * 3, priority=0) for i in range(2)]
    hi = Request(rid=99, prompt=rng.integers(
        1, cfg.vocab_size, size=20).astype(np.int32),
        max_new_tokens=4, priority=1)
    for r in low:
        tight.add_request(r)
    for _ in range(4):
        tight.step()
    tight.add_request(hi)
    finish_order = []
    seen = set()
    while any(s is not None for s in tight.slots) or tight.queue:
        tight.step()
        for r in (hi, *low):
            if r.done and r.rid not in seen:
                seen.add(r.rid)
                finish_order.append(r.rid)
    if not (hi.done and all(r.done for r in low)):
        raise AssertionError("priority drain did not complete")
    if finish_order[0] != hi.rid:
        raise AssertionError(
            f"high-priority request finished {finish_order.index(hi.rid)} "
            f"places late (order {finish_order}): preemption failed to "
            "clear its path")
    if tight.stats.preemptions == 0:
        raise AssertionError(
            "high-priority admission never preempted under pool pressure")
    ctx.emit("preempt_serve_priority_first",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             preemptions=tight.stats.preemptions,
             pool_stalls=tight.stats.pool_stalls,
             metric="late-arriving high-priority request preempts and "
                    "finishes before the low-priority drains it displaced "
                    "(1.0 or the sweep raises)")
