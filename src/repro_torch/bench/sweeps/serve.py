"""Tune -> execute proof sweeps: serve throughput and applied kernel plans
(the port of ``repro.bench.sweeps.serve``).

- ``serve``: tokens/s of the continuous-batching engine with the per-token
  host loop (one decode tick and one host sync per token, exact-length
  prefill) against fused windows of 8 ticks with prompt buckets.  The
  decode regime is `rs_tra` (every tick streams the KV cache once), so
  GB/s is cache bytes x ticks / wall.  Two deterministic rows follow:
  decode ticks per window and the distinct prefill shapes of a cold drain
  (the port's ``prefill_retraces``).
- ``kernel_plan``: the blocked attention loop (``chunked_attention``) at
  fixed 128x128 blocks against the :class:`repro_torch.tune.KernelPlan`
  blocks for the same shape (`nest`), and the plan's predicted GB/s as a
  deterministic row.

At ``fast`` both keep the reference's sizes and smoke config in float32.
On the card ``serve`` drains the reference's larger mix (12 requests, 24
new tokens, max_len 128) through full-width gemma-2b in bfloat16, and
``kernel_plan`` runs the reference's 2048-token shape.  The timed rows
take two trials everywhere (the reference: three off ``fast``), for the
smoke run's time.  Walls are the host's clock around a drain that ends in
a device synchronise.
"""
import time

import numpy as np
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.core.patterns import Knobs, Pattern


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_model(ctx: SweepContext, arch: str, kv_dtype: str = "native",
                seed: int = 0):
    """(cfg, bundle, params) for a serving sweep: the smoke config in
    float32 at ``fast``, the published widths in bfloat16 on the card;
    weights drawn from a generator seeded with ``seed`` on the sweep's
    device.  Prefill attention is the reference sweeps' (``chunked``,
    16x16 blocks)."""
    from repro_torch.configs import ARCHS, smoke_config

    cfg = smoke_config(ARCHS[arch]) if ctx.fast else ARCHS[arch]
    return model_for(ctx, cfg, kv_dtype, seed)


def model_for(ctx: SweepContext, cfg, kv_dtype: str = "native",
              seed: int = 0):
    """(cfg, bundle, params) for ``cfg`` as :func:`serve_model` builds
    them."""
    from repro_torch.models import RuntimeFlags, build

    flags = RuntimeFlags(attn_impl="chunked", attn_bq=16, attn_bkv=16,
                         kv_dtype=kv_dtype)
    bundle = build(cfg, flags, device=ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    return cfg, bundle, bundle.init(gen)


def float32_gemma(ctx: SweepContext):
    """(cfg, bundle, params) of a serving sweep whose gates are bitwise:
    smoke gemma-2b in float32 at ``fast``, full-width gemma-2b in float32
    on the card.  In bfloat16 a row computed again (a verify pass, or a
    prefill chunk of a recompute) rounds differently from the decode step
    that first wrote it."""
    if ctx.fast:
        return serve_model(ctx, "gemma-2b")
    from repro_torch.configs import ARCHS, override
    return model_for(ctx, override(ARCHS["gemma-2b"], param_dtype="float32",
                                   compute_dtype="float32"))


def _drain(eng, n_req, max_new):
    """Enqueue the deterministic request mix and serve it to completion."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    for i in range(n_req):
        prompt = rng.integers(
            0, eng.bundle.cfg.vocab_size, size=int(rng.integers(4, 17))
        ).astype(np.int32)
        eng.add_request(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    _sync(eng.device)
    t0 = time.perf_counter()
    stats = eng.run_to_completion()
    _sync(eng.device)
    return stats, time.perf_counter() - t0


@register("serve", "§5 pointer-chase fix: device-resident decode")
def run_serve(ctx: SweepContext) -> None:
    from repro_torch.serve import ServeEngine

    cfg, bundle, params = serve_model(ctx, "gemma-2b")
    n_req, max_new = (4, 8) if ctx.fast else (12, 24)
    max_len = 64 if ctx.fast else 128
    trials = 2

    variants = {
        # window=1 + exact-length prefill == the per-token host loop
        "serve_default": dict(window=1, bucket_prompts=False),
        # fused windows + pow2 prompt buckets == the fast path
        "serve_fastpath": dict(window=8, bucket_prompts=True),
    }
    for name, kw in variants.items():
        eng = ServeEngine(bundle, params, batch_size=2, max_len=max_len,
                          device=ctx.device, **kw)
        # the cold drain meets every prefill shape; reset() keeps them met,
        # so the timed drains count none
        cold_stats, _ = _drain(eng, n_req, max_new)
        walls = []
        for _ in range(trials):
            eng.reset()
            stats, wall = _drain(eng, n_req, max_new)
            walls.append(wall)
        timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                        trials=trials)
        # rs_tra: each decode tick streams the whole batch KV cache once
        bytes_moved = eng.kv_bytes() * max(1, stats.decode_steps)
        knobs = Knobs(burst_bytes=eng.kv_bytes() // max(1, cfg.num_layers),
                      outstanding=kw["window"])
        ctx.emit(name, pattern=Pattern.RS_TRA, knobs=knobs, timing=timing,
                 us=timing.best_s / max(1, stats.tokens_out) * 1e6,
                 gbps_measured=bytes_moved / max(timing.best_s, 1e-9) / 1e9,
                 tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
                 tokens_out=stats.tokens_out,
                 decode_dispatches=stats.decode_dispatches,
                 ticks_per_dispatch=f"{stats.decode_steps / max(1, stats.decode_dispatches):.2f}",
                 prefill_compiles_cold=cold_stats.prefill_retraces)
        if name == "serve_fastpath":
            # deterministic rows (no timing: the comparator's structural
            # gate trusts them on any host): ticks per window falling to 1
            # means the fast path fell back to per-token dispatch; more
            # cold prefill shapes mean bucketing stopped deduplicating
            ctx.emit("serve_ticks_per_dispatch",
                     gbps_measured=stats.decode_steps
                     / max(1, stats.decode_dispatches),
                     gbps_predicted=float(kw["window"]),
                     deterministic=True,
                     metric="decode ticks per fused dispatch (higher=better)")
            ctx.emit("serve_prefill_compiles",
                     us=float(cold_stats.prefill_retraces),
                     deterministic=True,
                     metric="distinct prefill shapes compiled cold "
                            "(lower=better)")


@register("kernel_plan", "§5 knobs applied: tuned vs default blocks")
def run_kernel_plan(ctx: SweepContext) -> None:
    from repro_torch.models.attention import AttnParams, chunked_attention
    from repro_torch.tune import plan_for
    from repro_torch.tune.plan import dtype_name

    b, hq, hkv, d = (1, 4, 2, 64)
    s = 512 if ctx.fast else 2048
    rng = np.random.default_rng(1)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(ctx.device)

    q, k, v = arr(b, s, hq, d), arr(b, s, hkv, d), arr(b, s, hkv, d)
    nbytes = (q.numel() + 2 * k.numel() + q.numel()) * 4  # q+k+v in, o out

    plan = plan_for("flash_attention", shape_sig=(s, s, d),
                    dtype=dtype_name(q.dtype), spec=ctx.spec)
    variants = {
        "kernel_plan_default": AttnParams(bq=128, bkv=128),
        # pin the ctx.spec plan's blocks so the timed variant executes
        # exactly what the row reports
        "kernel_plan_tuned": AttnParams(bq=plan.bq, bkv=plan.bkv),
    }
    for name, p in variants.items():
        t = ctx.timeit(lambda q, k, v, p=p: chunked_attention(q, k, v, p),
                       q, k, v)
        bq, bkv = (p.bq or plan.bq), (p.bkv or plan.bkv)
        knobs = Knobs(unit_bytes=d * 4, burst_bytes=min(bkv, s) * d * 4,
                      outstanding=plan.pipeline_depth)
        ctx.emit(name, pattern=Pattern.NEST, knobs=knobs, timing=t,
                 bytes_moved=nbytes, bq=min(bq, s), bkv=min(bkv, s),
                 plan_source=plan.source,
                 plan_predicted_gbps=f"{plan.predicted_gbps:.1f}")
    # deterministic: the tuner's predicted bandwidth for the applied plan
    ctx.emit("kernel_plan_predicted", gbps_measured=plan.predicted_gbps,
             gbps_predicted=plan.predicted_gbps,
             bq=plan.bq, bkv=plan.bkv, plan_source=plan.source,
             deterministic=True,
             metric="model-predicted GB/s of the applied plan")
