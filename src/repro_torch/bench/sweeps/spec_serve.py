"""Speculative-decoding serving sweep: burst length on r_acc (the port of
``repro.bench.sweeps.spec_serve``).

The paged decode tick dereferences the page table once per token (`r_acc`
at page granularity).  Speculative decoding widens that burst: a draft
proposes ``k`` tokens a round and the target verifies all ``k + 1``
positions in one ``paged_verify`` pass, touching the pool's pages once a
burst instead of once a token.  The sweep drains the same deterministic
mix through the vanilla paged engine and a self-draft speculative engine
(every proposal accepted: the upper bound) and emits:

- timed rows: warm tokens/s per engine;
- deterministic rows the comparator's structural gate trusts on any host:
  accepted draft tokens per verify round (at least 1.0, or the sweep
  raises), the accept rate, decode tokens per round (the burst, ``k + 1``
  for a full self-draft slot), ticks per dispatch, and speculative ==
  vanilla tokens (1.0, or the sweep raises).

At ``fast`` it keeps the reference's sizes and smoke config in float32.
On the card it drains the reference's larger mix (8 requests, 16 new
tokens, max_len 128) through full-width gemma-2b, drafting with itself,
in float32: the verify pass (gathered pages) and the decode kernel round
differently in bfloat16, so only float32 holds speculative tokens to
vanilla ones bit for bit.  The timed rows take two trials everywhere (the
reference: three off ``fast``), for the smoke run's time.  Walls are the
host's clock around a drain that ends in a device synchronise.
"""
import time

import numpy as np

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.bench.sweeps.serve import _sync, float32_gemma
from repro_torch.core.patterns import Knobs, Pattern

SPEC_K = 3


def _mix(cfg, n_req: int, max_new: int):
    """Deterministic request mix: even rids share a 16-token prefix."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(6)
    common = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    reqs = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).astype(np.int32)
        prompt = (np.concatenate([common, tail]) if i % 2 == 0
                  else np.concatenate([tail, tail]))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    return reqs


def _drain(eng, cfg, n_req, max_new):
    outs = {}
    for r in _mix(cfg, n_req, max_new):
        eng.add_request(r)
        outs[r.rid] = r
    _sync(eng.device)
    t0 = time.perf_counter()
    stats = eng.run_to_completion()
    _sync(eng.device)
    wall = time.perf_counter() - t0
    return stats, wall, {rid: list(r.out_tokens) for rid, r in outs.items()}


@register("spec_serve", "§6 burst length applied: speculative verify")
def run_spec_serve(ctx: SweepContext) -> None:
    from repro_torch.serve import ServeEngine

    cfg, bundle, params = float32_gemma(ctx)
    n_req, max_new = (4, 8) if ctx.fast else (8, 16)
    max_len = 64 if ctx.fast else 128
    trials = 2

    def mk(spec: bool) -> ServeEngine:
        kw = (dict(draft_bundle=bundle, draft_params=params, spec_k=SPEC_K)
              if spec else {})
        return ServeEngine(bundle, params, batch_size=2, max_len=max_len,
                           window=SPEC_K + 1, cache_backend="paged",
                           device=ctx.device, **kw)

    engines = {"spec_serve_vanilla": mk(False), "spec_serve_spec": mk(True)}
    stats_by = {}
    for name, eng in engines.items():
        _drain(eng, cfg, n_req, max_new)   # cold: meets every shape
        walls = []
        for _ in range(trials):
            eng.reset()
            stats, wall, outs = _drain(eng, cfg, n_req, max_new)
            walls.append(wall)
        stats_by[name] = (stats, outs)
        timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                        trials=trials)
        # one verify pass reads each live page once for a k+1 burst: burst
        # bytes = page bytes, reuse = verify width
        ctx.emit(name, pattern=Pattern.R_ACC,
                 knobs=Knobs(burst_bytes=eng.bytes_per_page,
                             outstanding=SPEC_K + 1),
                 timing=timing,
                 us=timing.best_s / max(1, stats.tokens_out) * 1e6,
                 tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
                 tokens_out=stats.tokens_out,
                 decode_dispatches=stats.decode_dispatches,
                 spec_steps=stats.spec_steps)

    vstats, vouts = stats_by["spec_serve_vanilla"]
    sstats, souts = stats_by["spec_serve_spec"]
    # deterministic rows (scheduling does not depend on the host)
    if sstats.spec_steps == 0:
        raise AssertionError("speculative engine never dispatched a "
                             "draft->verify round")
    aps = sstats.accepted_per_step
    if aps < 1.0:
        raise AssertionError(
            f"accepted draft tokens per verify round {aps:.2f} < 1.0: "
            "speculation emits no more than plain decode per round")
    ctx.emit("spec_serve_accept_per_step",
             gbps_measured=aps,
             gbps_predicted=float(SPEC_K),
             deterministic=True,
             spec_steps=sstats.spec_steps,
             draft_accepted=sstats.draft_accepted,
             metric="accepted draft tokens per verify dispatch, summed "
                    "across batch slots (hard-gated >= 1.0; a full "
                    "self-draft slot contributes k)")
    ctx.emit("spec_serve_accept_rate",
             gbps_measured=sstats.accept_rate,
             gbps_predicted=1.0,
             deterministic=True,
             draft_accepted=sstats.draft_accepted,
             draft_tokens=sstats.draft_tokens,
             metric="accepted/proposed draft tokens (self-draft greedy "
                    "must accept everything)")
    seeds = n_req  # one prefill-seeded token per request, per drain
    ctx.emit("spec_serve_verify_tokens_per_dispatch",
             gbps_measured=(sstats.tokens_out - seeds)
             / max(1, sstats.spec_steps),
             gbps_predicted=float(SPEC_K + 1),
             deterministic=True,
             metric="decode tokens emitted per verify dispatch, summed "
                    "across batch slots — the burst the paper's r_acc "
                    "lever widens (a full slot contributes k+1)")
    ctx.emit("spec_serve_ticks_per_dispatch",
             gbps_measured=sstats.decode_steps
             / max(1, sstats.decode_dispatches),
             gbps_predicted=1.0,
             deterministic=True,
             metric="host->device dispatches per verify step (one fused "
                    "draft+verify launch per tick)")
    match = float(souts == vouts)
    if match != 1.0:
        bad = [rid for rid in vouts if souts.get(rid) != vouts[rid]]
        raise AssertionError(
            f"speculative drain diverged from vanilla on rids {bad}: "
            "rollback/verify lost bitwise equivalence")
    ctx.emit("spec_serve_tokens_match",
             gbps_measured=match,
             gbps_predicted=1.0,
             deterministic=True,
             tokens_out=sstats.tokens_out,
             metric="speculative == vanilla drained tokens, bitwise "
                    "(1.0 or the sweep raises)")
