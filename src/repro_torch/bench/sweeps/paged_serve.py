"""Paged-KV serving sweep: the page pool as the r_acc engine (the port of
``repro.bench.sweeps.paged_serve``).

Dense per-slot serving commits ``batch x max_len`` KV bytes up front and
streams them every tick (`rs_tra`); the paged backend allocates pages on
demand and dereferences a per-sequence table inside the
``paged_attention`` kernel (`r_acc` over page-sized units).  The sweep
drains the same deterministic request mix (half the prompts share a
two-page prefix) through both backends and emits:

- timed rows: warm tokens/s per backend;
- deterministic rows the comparator's structural gate trusts on any host:
  live-token bytes against the dense footprint (must stay > 1x), the
  prefix-cache hit rate, and decode ticks per fused window;
- windowed rows (gemma2's local/global pairs on ring pages): the
  live-bytes ratio must *beat* the full-attention one, and the peak ring
  pages must stay within batch x (ceil(window/page)+1);
- int8-KV rows: the live-bytes ratio of int8 pages, and the derived page's
  tokens against the native page's.

At ``fast`` every row keeps the reference's sizes and smoke configs in
float32.  On the card (bfloat16, published widths): the full-attention,
prefix and int8 rows drain the reference's larger mix (10 requests, 16 new
tokens, max_len 128) through gemma-2b; the windowed rows run one (local,
global) pair of gemma2-27b (window 4096) at max_len 8192, where the first
request's prompt runs past the window (its ring turns) and the rest are
the reference's mix (a second long prompt would share the batch with the
first and hold two full rings: the ratio would then measure the mix).
The timed rows take two trials everywhere (the reference: three off
``fast``), for the smoke run's time.
"""
import time

import numpy as np
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.bench.sweeps.serve import _sync, model_for, serve_model
from repro_torch.core.patterns import Knobs, Pattern


def _mix(cfg, n_req: int, max_new: int, long_len: int = 0):
    """Deterministic request mix: even rids share a 16-token (2-page)
    prefix, odd rids are fully distinct.  With ``long_len`` the first
    request grows to ``long_len`` tokens (the reference mix's prompt, then
    fresh tokens)."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    common = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    reqs = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).astype(np.int32)
        prompt = (np.concatenate([common, tail]) if i % 2 == 0
                  else np.concatenate([tail, tail, tail]))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    if long_len:
        r = reqs[0]
        more = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=long_len - r.prompt.shape[0])
        r.prompt = np.concatenate([r.prompt, more.astype(np.int32)])
    return reqs


def _drain(eng, cfg, n_req, max_new, long_len=0):
    for r in _mix(cfg, n_req, max_new, long_len):
        eng.add_request(r)
    _sync(eng.device)
    t0 = time.perf_counter()
    stats = eng.run_to_completion()
    _sync(eng.device)
    return stats, time.perf_counter() - t0


def windowed_model(ctx: SweepContext):
    """(cfg, bundle, params, max_len, long_len) of the windowed rows: the
    reference's smoke gemma2-27b at max_len 128 at ``fast``; on the card
    one (local, global) pair at gemma2-27b's published widths (window
    4096), max_len 8192, a long prompt of window + 64 tokens."""
    from repro_torch.configs import ARCHS, override, smoke_config

    if ctx.fast:
        cfg = smoke_config(ARCHS["gemma2-27b"])
        return model_for(ctx, cfg, seed=1) + (128, 0)
    base = ARCHS["gemma2-27b"]
    cfg = override(base, num_layers=len(base.layer_pattern))
    window = max(s.sliding_window for s in cfg.layer_pattern
                 if s.sliding_window is not None)
    return model_for(ctx, cfg, seed=1) + (8192, window + 64)


@register("paged_serve", "§6 r_acc applied: paged-KV continuous batching")
def run_paged_serve(ctx: SweepContext) -> None:
    from repro_torch.serve import ServeEngine

    cfg, bundle, params = serve_model(ctx, "gemma-2b")
    n_req, max_new = (4, 8) if ctx.fast else (10, 16)
    max_len = 64 if ctx.fast else 128
    window = 8
    trials = 2

    def engine(bundle, params, max_len, backend):
        return ServeEngine(bundle, params, batch_size=2, max_len=max_len,
                           window=window, cache_backend=backend,
                           device=ctx.device)

    engines = {
        "paged_serve_dense": engine(bundle, params, max_len, "dense"),
        "paged_serve_paged": engine(bundle, params, max_len, "paged"),
    }
    stats_by = {}
    for name, eng in engines.items():
        _drain(eng, cfg, n_req, max_new)    # cold: meets every shape
        walls = []
        for _ in range(trials):
            eng.reset()
            stats, wall = _drain(eng, cfg, n_req, max_new)
            walls.append(wall)
        stats_by[name] = (eng, stats)
        timing = Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                        trials=trials)
        paged = name.endswith("paged")
        pattern = Pattern.R_ACC if paged else Pattern.RS_TRA
        burst = (eng.bytes_per_page if paged
                 else eng.kv_bytes() // max(1, cfg.num_layers))
        # per tick the dense path streams its full commitment; the paged
        # path touches only live pages
        bytes_moved = eng.live_kv_bytes_peak() * max(1, stats.decode_steps)
        ctx.emit(name, pattern=pattern,
                 knobs=Knobs(burst_bytes=burst, outstanding=window),
                 timing=timing,
                 us=timing.best_s / max(1, stats.tokens_out) * 1e6,
                 gbps_measured=bytes_moved / max(timing.best_s, 1e-9) / 1e9,
                 tok_s=f"{stats.tokens_out / max(timing.best_s, 1e-9):.1f}",
                 tokens_out=stats.tokens_out,
                 decode_dispatches=stats.decode_dispatches,
                 kv_bytes=eng.kv_bytes(),
                 live_bytes_peak=eng.live_kv_bytes_peak())

    dense_eng, _ = stats_by["paged_serve_dense"]
    paged_eng, pstats = stats_by["paged_serve_paged"]
    # deterministic rows (scheduling does not depend on the host)
    ctx.emit("paged_serve_live_bytes_ratio",
             gbps_measured=dense_eng.kv_bytes()
             / max(1, paged_eng.live_kv_bytes_peak()),
             gbps_predicted=1.0,
             deterministic=True,
             pages_peak=pstats.pages_peak,
             page_size=paged_eng.page,
             pool_pages=paged_eng.num_pages,
             metric="dense batch*max_len bytes / paged live-token peak "
                    "bytes (must stay > 1)")
    ctx.emit("paged_serve_prefix_hit_rate",
             gbps_measured=pstats.prefix_hit_tokens
             / max(1, pstats.prompt_tokens),
             deterministic=True,
             hit_tokens=pstats.prefix_hit_tokens,
             prompt_tokens=pstats.prompt_tokens,
             metric="prompt tokens served from shared prefix pages "
                    "(higher=better)")
    ctx.emit("paged_serve_ticks_per_dispatch",
             gbps_measured=pstats.decode_steps
             / max(1, pstats.decode_dispatches),
             gbps_predicted=float(window),
             deterministic=True,
             metric="paged decode ticks per fused dispatch (parity with "
                    "the serve sweep's fast path)")
    full_ratio = (dense_eng.kv_bytes()
                  / max(1, paged_eng.live_kv_bytes_peak()))
    del engines, stats_by, dense_eng

    # ----------------------------------------------------------------
    # windowed stack (gemma2's local/global pairs): ring pages bound the
    # windowed layers at ceil(window/page)+1 live pages per slot, so the
    # live-bytes win must beat the full-attention baseline above
    # ----------------------------------------------------------------
    cfg_w, bundle_w, params_w, win_len, long_len = windowed_model(ctx)
    dense_w = engine(bundle_w, params_w, win_len, "dense")
    paged_w = engine(bundle_w, params_w, win_len, "paged")
    wstats, _ = _drain(paged_w, cfg_w, n_req, max_new, long_len)
    ratio_w = dense_w.kv_bytes() / max(1, paged_w.live_kv_bytes_peak())
    # the dense engine still commits batch x max_len on its global layers
    # while the ring and the paged global layers hold live tokens only
    if ratio_w <= full_ratio:
        raise AssertionError(
            f"windowed live-bytes ratio {ratio_w:.2f} must beat the "
            f"full-attention baseline {full_ratio:.2f}: ring paging lost "
            "its eager-release win")
    # eager release, bound against the window itself (not ring_slots,
    # which is code under test): live ring tokens per slot may never
    # exceed window tokens + 2 pages of slack
    win_tokens = max(s.sliding_window for s in cfg_w.layer_pattern
                     if s.sliding_window is not None)
    ring_cap_tokens = 2 * (win_tokens + 2 * paged_w.page)   # batch_size=2
    if wstats.ring_pages_peak * paged_w.page > ring_cap_tokens:
        raise AssertionError(
            f"peak ring pages {wstats.ring_pages_peak} x page "
            f"{paged_w.page} exceed the window bound {ring_cap_tokens} "
            "tokens: the ring stopped releasing the trailing page")
    ctx.emit("paged_serve_windowed_live_bytes_ratio",
             gbps_measured=ratio_w,
             gbps_predicted=full_ratio,
             deterministic=True,
             ring_slots=paged_w.ring_slots,
             ring_pages_peak=wstats.ring_pages_peak,
             pages_peak=wstats.pages_peak,
             page_size=paged_w.page,
             metric="windowed-stack dense footprint / paged live peak "
                    "(must stay above the full-attention baseline ratio)")
    ctx.emit("paged_serve_windowed_ring_bound",
             gbps_measured=float(wstats.ring_pages_peak),
             gbps_predicted=float(2 * paged_w.ring_slots),
             deterministic=True,
             metric="peak live ring pages (must stay <= "
                    "batch x (ceil(window/page)+1))")
    del dense_w, paged_w, params_w, bundle_w

    # ----------------------------------------------------------------
    # int8 KV pages: a narrower row -> a derived page of more tokens, and
    # fewer live bytes per token
    # ----------------------------------------------------------------
    _, bundle8, params8 = serve_model(ctx, "gemma-2b", kv_dtype="int8")
    dense8 = engine(bundle8, params8, max_len, "dense")
    paged8 = engine(bundle8, params8, max_len, "paged")
    s8, _ = _drain(paged8, cfg, n_req, max_new)
    ctx.emit("paged_serve_int8_live_bytes_ratio",
             gbps_measured=dense8.kv_bytes()
             / max(1, paged8.live_kv_bytes_peak()),
             gbps_predicted=1.0,
             deterministic=True,
             pages_peak=s8.pages_peak,
             page_size=paged8.page,
             native_page_size=paged_eng.page,
             metric="int8-KV dense footprint / paged live peak (must stay "
                    "> 1); int8 pages hold more tokens per transaction")
    ctx.emit("paged_serve_int8_page_tokens_ratio",
             gbps_measured=paged8.page / max(1, paged_eng.page),
             gbps_predicted=float(getattr(torch, cfg.compute_dtype).itemsize),
             deterministic=True,
             metric="int8 page tokens / native page tokens: the paper's "
                    "data-width lever widens the r_acc transaction unit by "
                    "the dtype-bytes ratio")
