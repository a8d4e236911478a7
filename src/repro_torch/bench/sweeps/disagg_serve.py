"""Disaggregated prefill/decode sweep: tier movement between engine pools
(the port of ``repro.bench.sweeps.disagg_serve``).

The paper's achievable-bandwidth story is about which tier data lives in
and how it moves.  This sweep ships whole finished-prefill page sets from
a prefill engine to a decode engine (the host-tier swap, between engines)
and gates that the move costs no correctness:

- timed rows: warm tokens/s of the colocated drain and of the same mix
  through the prefill -> decode hand-off (advisory: wall clock);
- deterministic rows the comparator's structural gate trusts: the
  disaggregated drain gives the colocated drain's tokens for greedy,
  sampled and int8 pages (1.0, or the sweep raises), and over a device
  group of two a TP=2 prefill engine shipping to a TP=2 decode engine
  gives the TP=2 colocated engine's (per-shard gathers assembling whole
  pages, per-shard scatters landing the stripes); the transfer ledger
  equals the page geometry; TTFT/TPOT percentiles in virtual rounds; a
  drain whose every transfer is corrupted in transit recovers by
  decode-side recompute with the same tokens; and the
  :class:`~repro_torch.serve.scheduler.SwapCostModel` ships long prompts
  on a healthy link and keeps them colocated when the link is the
  bottleneck.

At ``fast`` the rows keep the reference's sizes and smoke gemma-2b in
float32, and the deterministic columns equal the reference's, save the
break-even row's ``reprefill_ms``: it prices with the context's spec (the
H100's, or a calibrated one).  On the card the sweep runs full-width
gemma-2b in float32 at the reference's larger mix (8 requests, 16 new
tokens) with two trials, not three: float32 because the recompute after
a corrupted transfer is held bitwise (``preempt_serve``'s rule).  The
int8 drains serve the same weight tree through an int8-page bundle.  The
TP=2 row takes the device group as ``dist_serve`` does (the context's,
else the visible cards; a group may repeat a device, two shards on one
card) and is emitted only when it has two devices, as the reference's on
one device; it runs the reference's config at every scale (smoke
gemma-2b with 2 kv heads in float32).  Walls are the host's clock around
a drain that ends in a device synchronise.
"""
import time

import numpy as np

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.bench.sweeps.dist_serve import group
from repro_torch.bench.sweeps.serve import _sync, float32_gemma, model_for
from repro_torch.tune.plan import next_pow2


def _mix(cfg, n_req: int, max_new: int):
    """Seeded request mix: even rids share a 16-token prefix."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(12)
    common = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    reqs = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).astype(np.int32)
        prompt = (np.concatenate([common, tail]) if i % 2 == 0
                  else np.concatenate([tail, tail, tail]))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    return reqs


def _drain(target, cfg, n_req, max_new, chaos=None):
    """Drain the mix through an engine or a DisaggPool; returns
    (rid -> tokens, stats, wall seconds)."""
    reqs = _mix(cfg, n_req, max_new)
    submit = getattr(target, "submit", None) or target.add_request
    for r in reqs:
        submit(r)
    device = (target.engines[0] if hasattr(target, "engines")
              else target).device
    _sync(device)
    t0 = time.perf_counter()
    if hasattr(target, "run"):
        stats = target.run(chaos=chaos)
    else:
        stats = target.run_to_completion()
    _sync(device)
    wall = time.perf_counter() - t0
    return {r.rid: list(r.out_tokens) for r in reqs}, stats, wall


def _timed(ctx, name, target, cfg, n_req, max_new, trials):
    streams = stats = None
    walls = []
    for i in range(trials + 1):               # +1 cold drain: the shapes
        target.reset()
        streams, stats, wall = _drain(target, cfg, n_req, max_new)
        if i > 0:
            walls.append(wall)
    timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                    trials=trials)
    ctx.emit(name, timing=timing,
             us=timing.best_s / max(1, stats.tokens_out) * 1e6,
             tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
             tokens_out=stats.tokens_out)
    return streams, stats


@register("disagg_serve", "§2 memory hierarchy: cross-mesh page shipment")
def run_disagg_serve(ctx: SweepContext) -> None:
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import (DisaggChaos, DisaggChaosConfig,
                                   DisaggConfig, DisaggPool, SamplingParams,
                                   ServeEngine, SwapCostModel)

    cfg, bundle, params = float32_gemma(ctx)
    n_req, max_new = (4, 8) if ctx.fast else (8, 16)
    trials = 2
    kw = dict(batch_size=2, max_len=64, window=4, prefill_chunk=8,
              cache_backend="paged", seed=0, device=ctx.device)

    def pool_of(b, **extra):
        return DisaggPool([ServeEngine(b, params, **kw, **extra)],
                          [ServeEngine(b, params, **kw, **extra)],
                          DisaggConfig(force="disagg"))

    # -- timed: colocated against disaggregated, the same mix ------------
    single = ServeEngine(bundle, params, **kw)
    pool = pool_of(bundle)
    want, ref_stats = _timed(ctx, "disagg_serve_colocated", single, cfg,
                             n_req, max_new, trials)
    got, dstats = _timed(ctx, "disagg_serve_disagg", pool, cfg,
                         n_req, max_new, trials)

    # -- the headline gate: equal tokens, greedy, sampled and int8 --------
    if got != want:
        raise AssertionError(
            f"disaggregated greedy drain diverged from colocated: "
            f"{got} != {want}")
    samp = SamplingParams(temperature=0.9, top_k=11)
    want_s, _, _ = _drain(ServeEngine(bundle, params, **kw, sampling=samp),
                          cfg, n_req, max_new)
    got_s, sstats, _ = _drain(pool_of(bundle, sampling=samp),
                              cfg, n_req, max_new)
    if got_s != want_s:
        raise AssertionError(
            "disaggregated sampled drain diverged: the (seed, rid) PRNG "
            "chain must replay identically after the hand-off")
    bundle8 = build(cfg, RuntimeFlags(attn_impl="chunked", attn_bq=16,
                                      attn_bkv=16, kv_dtype="int8"),
                    device=ctx.device)
    want8, _, _ = _drain(ServeEngine(bundle8, params, **kw),
                         cfg, n_req, max_new)
    got8, stats8, _ = _drain(pool_of(bundle8), cfg, n_req, max_new)
    if got8 != want8:
        raise AssertionError(
            "disaggregated int8-KV drain diverged: the transfer buffer "
            "must carry the scale lanes with the pages")
    if min(sstats.prefill_imports, stats8.prefill_imports) < 1:
        raise AssertionError("a gated drain shipped no prefill at all")
    ctx.emit("disagg_serve_bitwise_match",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             backends="greedy+sampled+int8",
             metric="prefill-pool -> decode-pool drain == colocated drain, "
                    "bitwise, across backends (1.0 or the sweep raises)")

    # -- the transfer ledger equals the page geometry --------------------
    # each hand-off counts twice (export gather, import scatter) over the
    # power-of-two padded page list: the two link crossings the cost
    # model prices
    per_tok = single.bytes_per_page / single.page
    predicted = 2 * sum(
        next_pow2(max(1, -(-len(r.prompt) // single.page)))
        * single.bytes_per_page for r in _mix(cfg, n_req, max_new))
    if dstats.transfer_bytes != predicted:
        raise AssertionError(
            f"transfer ledger {dstats.transfer_bytes} != predicted "
            f"{predicted} from page geometry")
    ctx.emit("disagg_serve_transfer_bytes",
             gbps_measured=float(dstats.transfer_bytes),
             gbps_predicted=float(predicted), deterministic=True,
             transfers=dstats.prefill_imports,
             kv_bytes_per_token=per_tok,
             metric="bytes across the prefill->decode link (gather + "
                    "scatter of pow2-padded pages; hard-gated == geometry)")

    # -- TTFT/TPOT in virtual rounds -------------------------------------
    pool.reset()
    _drain(pool, cfg, n_req, max_new)
    pct = pool.percentiles()
    for mname in ("ttft_p50", "ttft_p99", "tpot_p50"):
        val = pct[mname]
        if val <= 0:
            raise AssertionError(f"{mname} = {val}: virtual-clock "
                                 "percentiles must be positive")
        ctx.emit(f"disagg_serve_{mname}",
                 gbps_measured=val, gbps_predicted=val, deterministic=True,
                 rounds=pool.dstats.rounds,
                 metric=f"{mname} in virtual rounds under the disaggregated "
                        "topology (deterministic: the clock never sees "
                        "token values)")

    # -- chaos: every buffer in transit corrupted ------------------------
    pool.reset()
    chaos = DisaggChaos(DisaggChaosConfig(seed=5, corrupt_prob=1.0))
    got_c, cstats, _ = _drain(pool, cfg, n_req, max_new, chaos=chaos)
    if got_c != want:
        raise AssertionError(
            "corrupted-transfer drain diverged from colocated: decode-side "
            f"recompute lost bitwise equivalence ({got_c} != {want})")
    if cstats.transfer_fallbacks < 1 or chaos.corruptions < 1:
        raise AssertionError(
            f"transfer chaos injected nothing (corruptions="
            f"{chaos.corruptions}, fallbacks={cstats.transfer_fallbacks})")
    ctx.emit("disagg_serve_chaos_recovery",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             corruptions=chaos.corruptions,
             transfer_fallbacks=cstats.transfer_fallbacks,
             recompute_resumes=cstats.recompute_resumes,
             metric="every transfer corrupted in transit -> checksum "
                    "catches it at import, decode-side recompute drains "
                    "bitwise (1.0 or the sweep raises)")

    # -- routing: the cost model's disagg-or-colocated break-even --------
    # production-scale numbers (2.5B bf16 weights, gemma-2b KV rows) on
    # the context's spec: shipping 8k rows of KV beats streaming the
    # weights once a chunk on a healthy 32 GB/s link, and a 32 MB/s link
    # sends the router back to colocated prefill
    cm_fast = SwapCostModel(weight_bytes=5e9, kv_bytes_per_token=18_432,
                            prefill_chunk=256, spec=ctx.spec,
                            host_link_bw=32e9)
    cm_slow = SwapCostModel(weight_bytes=5e9, kv_bytes_per_token=18_432,
                            prefill_chunk=256, spec=ctx.spec,
                            host_link_bw=32e6)
    long_ctx = 8192
    if cm_fast.choose(long_ctx, swappable=True) != "swap":
        raise AssertionError(
            "healthy link must route long prompts to the prefill pool")
    if cm_slow.choose(long_ctx, swappable=True) != "recompute":
        raise AssertionError(
            "bottleneck link must fall back to colocated prefill")
    ctx.emit("disagg_serve_routing_break_even",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             ship_ms=cm_fast.swap_s(long_ctx) * 1e3,
             reprefill_ms=cm_fast.recompute_s(long_ctx) * 1e3,
             metric="router ships on a healthy link, colocates on a "
                    "bottleneck link at ctx=8192 (1.0 or the sweep raises)")

    # -- TP=2: per-shard gathers assemble whole pages --------------------
    devs = group(ctx)
    if len(devs) < 2:
        return  # one device: no TP group to shard over
    from repro_torch.configs import ARCHS, override, smoke_config
    from repro_torch.dist import ServeMesh

    # gemma-2b smoke is MQA; TP=2 needs both head counts divisible by 2
    cfg2, bundle2, params2 = model_for(
        ctx, override(smoke_config(ARCHS["gemma-2b"]), num_kv_heads=2))
    kw2 = {k: v for k, v in kw.items() if k != "device"}

    def tp2():
        return ServeEngine(bundle2, params2, **kw2,
                           dist=ServeMesh.tp(2, devices=devs[:2]))

    want_tp, _, _ = _drain(tp2(), cfg2, n_req, max_new)
    pool_tp = DisaggPool([tp2()], [tp2()], DisaggConfig(force="disagg"))
    got_tp, tstats, _ = _drain(pool_tp, cfg2, n_req, max_new)
    if got_tp != want_tp:
        raise AssertionError(
            "TP=2 disaggregated drain diverged from the TP=2 colocated "
            f"engine: {got_tp} != {want_tp}")
    if tstats.prefill_imports < 1:
        raise AssertionError("TP=2 disagg drain shipped no prefill")
    ctx.emit("disagg_serve_tp2_bitwise",
             gbps_measured=1.0, gbps_predicted=1.0, deterministic=True,
             transfers=tstats.prefill_imports,
             metric="TP=2 prefill mesh -> TP=2 decode mesh drain == TP=2 "
                    "colocated drain (per-shard gathers and scatters of "
                    "the hand-off; 1.0 or the sweep raises)")
