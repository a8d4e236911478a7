"""Sharded paged serving sweep: TP shards as memory channels (the port of
``repro.bench.sweeps.dist_serve``).

The paper scales bandwidth by spreading one buffer over several banks
behind independent ports; the serving twin splits the KV page pools (and
the attention heads) of ONE engine over a TP group, while DP adds whole
engine replicas behind a shared admission queue.  The sweep drains the
same deterministic request mix through a single-device paged engine, a
TP=2 engine and a DP=2 replica pool, and emits:

- timed rows: warm tokens/s per layout (tp1 / tp2 / dp2) and the
  per-axis scaling ratios (advisory: two shards on one device, or two
  CPU "devices", time-slice rather than scale);
- deterministic gate rows the comparator's structural gate trusts on any
  host: TP=2 drains give the single-device engine's tokens (greedy and
  sampled: logits are gathered before selection, so the per-slot key
  chains never see the mesh), the DP pool reproduces the single engine's
  streams per request, and one shard's live-KV bytes are exactly half the
  whole (pools split on kv-heads: the per-channel footprint).

The device group comes from the context (``run_sweeps(devices=...)``,
which may repeat a device: ``["cpu", "cpu"]`` on the CPU, two shards on
one card); without one it is the visible cards, and with fewer than two
devices the sweep emits nothing, as the reference's does on one device.
It runs the reference's config everywhere (smoke gemma-2b with 2 kv
heads, float32, chunked prefill attention in 16x16 blocks), with the
reference's mix at ``fast`` (4 requests, 8 new tokens) and its larger
mix otherwise (8 requests, 16); the timed rows take two trials
everywhere (the reference: three off ``fast``), for the smoke run's
time.  Walls are the host's clock around a drain that ends in a device
synchronise.
"""
import time

import numpy as np

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.bench.sweeps.serve import _sync, model_for


def _mix(cfg, n_req: int, max_new: int):
    """Even rids share a two-page prefix, odd rids are distinct (the
    paged_serve mix's shape, so the prefix machinery stays exercised)."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(7)
    common = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    reqs = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).astype(np.int32)
        prompt = (np.concatenate([common, tail]) if i % 2 == 0
                  else np.concatenate([tail, tail, tail]))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    return reqs


def _drain(target, cfg, n_req, max_new):
    """Drain the mix through an engine or a ReplicaPool; returns (per-rid
    token streams, stats, wall seconds)."""
    reqs = _mix(cfg, n_req, max_new)
    submit = getattr(target, "submit", None) or target.add_request
    for r in reqs:
        submit(r)
    engines = getattr(target, "engines", [target])
    for e in engines:
        _sync(e.device)
    t0 = time.perf_counter()
    if hasattr(target, "drain"):
        stats = target.drain()
    else:
        stats = target.run_to_completion()
    for e in engines:
        _sync(e.device)
    return [r.out_tokens for r in reqs], stats, time.perf_counter() - t0


def _timed(ctx, name, target, cfg, n_req, max_new, trials):
    """A cold drain, then ``trials`` warm ones (each after a reset); emits
    a timed tok/s row and returns (streams, stats, timing)."""
    engines = getattr(target, "engines", [target])
    streams = stats = None
    walls = []
    for i in range(trials + 1):
        for e in engines:
            e.reset()
        streams, stats, wall = _drain(target, cfg, n_req, max_new)
        if i > 0:
            walls.append(wall)
    timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                    trials=trials)
    ctx.emit(name, timing=timing,
             us=timing.best_s / max(1, stats.tokens_out) * 1e6,
             tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
             tokens_out=stats.tokens_out,
             decode_dispatches=stats.decode_dispatches)
    return streams, stats, timing


def group(ctx: SweepContext) -> list:
    """The sweep's device group: the context's, else the visible cards
    (each once) on a card, else the context's one device."""
    import torch

    from repro_torch.launch.mesh import visible_devices

    if ctx.devices is not None:
        return [torch.device(d) for d in ctx.devices]
    return visible_devices() if ctx.device.type == "cuda" else [ctx.device]


@register("dist_serve", "§6 multi-channel: TP x DP sharded paged serving")
def run_dist_serve(ctx: SweepContext) -> None:
    devs = group(ctx)
    if len(devs) < 2:
        return  # one device: nothing to shard or replicate over

    from repro_torch.configs import ARCHS, override, smoke_config
    from repro_torch.dist import ServeMesh
    from repro_torch.launch.serve import build_pool
    from repro_torch.serve import SamplingParams, ServeEngine

    # gemma-2b smoke is MQA; TP=2 needs both head counts divisible by 2
    cfg = override(smoke_config(ARCHS["gemma-2b"]), num_kv_heads=2)
    cfg, bundle, params = model_for(ctx, cfg)
    n_req, max_new = (4, 8) if ctx.fast else (8, 16)
    trials = 2
    kw = dict(batch_size=2, max_len=64, cache_backend="paged",
              prefill_chunk=8, seed=0)
    mesh = ServeMesh.tp(2, devices=devs[:2])

    single = ServeEngine(bundle, params, **kw, device=ctx.device)
    tp2 = ServeEngine(bundle, params, **kw, dist=mesh)
    want, sstats, stiming = _timed(ctx, "dist_serve_tp1", single, cfg,
                                   n_req, max_new, trials)
    got, tstats, ttiming = _timed(ctx, "dist_serve_tp2", tp2, cfg,
                                  n_req, max_new, trials)

    # ---- determinism gates ---------------------------------------------
    if got != want:
        raise AssertionError(
            "TP=2 greedy drain diverged from the single-device paged "
            f"engine: {got} != {want}")
    samp = SamplingParams(temperature=0.9, top_k=11)
    kw_s = dict(kw, sampling=samp)
    want_s, _, _ = _drain(ServeEngine(bundle, params, **kw_s,
                                      device=ctx.device),
                          cfg, n_req, max_new)
    got_s, _, _ = _drain(ServeEngine(bundle, params, **kw_s, dist=mesh),
                         cfg, n_req, max_new)
    if got_s != want_s:
        raise AssertionError(
            "TP=2 sampled drain diverged: the per-slot key chains must "
            "never see the mesh (logits gathered before selection)")
    ctx.emit("dist_serve_tp2_token_parity",
             gbps_measured=1.0, gbps_predicted=1.0,
             deterministic=True,
             metric="TP=2 drains token-identical to single-device "
                    "(greedy and sampled; 1.0 = bitwise match)")

    # one shard holds exactly half the live KV bytes: the pools split on
    # their kv-heads dim, and this config has no replicated recurrent
    # state or scale lanes to dilute the ratio
    g = tp2.live_kv_bytes_peak()
    p = tp2.live_kv_bytes_peak(per_shard=True)
    if g != 2 * p:
        raise AssertionError(
            f"per-shard live-KV bytes {p} must be exactly half the "
            f"global {g}: the page pools stopped splitting on kv-heads")
    ctx.emit("dist_serve_per_shard_live_bytes_ratio",
             gbps_measured=g / max(1, p), gbps_predicted=2.0,
             deterministic=True,
             live_bytes_global=g, live_bytes_per_shard=p,
             metric="global / per-shard live-KV peak bytes (must equal "
                    "the TP width: each shard is one memory channel)")

    # ---- DP axis: a replica pool behind the shared admission queue ------
    pool = build_pool(bundle, params, tp=1, dp=2, devices=devs[:2], **kw)
    got_dp, dstats, dtiming = _timed(ctx, "dist_serve_dp2", pool, cfg,
                                     n_req, max_new, trials)
    if got_dp != want:
        raise AssertionError(
            "DP=2 pool drain diverged from the single-engine streams: "
            "replicas share params and greedy decode is "
            f"schedule-invariant: {got_dp} != {want}")
    if len({id(e.cache) for e in pool.engines}) != len(pool.engines):
        raise AssertionError("DP replicas must not share cache state")
    ctx.emit("dist_serve_dp2_token_parity",
             gbps_measured=1.0, gbps_predicted=1.0,
             deterministic=True,
             replicas=len(pool.engines),
             metric="DP=2 replica-pool drain reproduces the single-engine "
                    "streams per request (1.0 = exact)")

    # ---- per-axis scaling (advisory) -----------------------------------
    base = sstats.tokens_out / max(stiming.best_s, 1e-9)
    for name, st, tm in (("tp", tstats, ttiming), ("dp", dstats, dtiming)):
        ctx.emit(f"dist_serve_{name}_scaling",
                 gbps_measured=(st.tokens_out / max(tm.best_s, 1e-9)),
                 gbps_predicted=base,
                 metric=f"{name}=2 warm tok/s vs single-device (advisory: "
                        "shards that share a device time-slice it)")
