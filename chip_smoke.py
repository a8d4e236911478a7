#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself and
builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels``.  Phases, one ``[tag]`` line each:

1. card: the card's name and power limit, torch and CUDA versions;
2. build: every kernel, one ``nvcc`` each, all started together;
3. K1: the ``paged_attention`` kernel against its plain PyTorch version on
   the card: gemma-2b's decode geometry with ragged lengths, GQA, softcap,
   a ring window, int8 lanes, rows with no live token and the main path's
   own shape, each in
   float32 (tolerance 1e-4) and bfloat16 (3e-2; and, held against the
   plain version run in float32 on the same inputs, within one bfloat16
   rounding of its output);
4. K1 time at the main path's shape (B 8, 128 pages of 8 tokens), beside
   its plain version, one PyTorch call on the gathered K/V, and its bound;
5. serve: full-width gemma-2b (bf16, random weights from a seeded
   generator) through the paged ``ServeEngine``: 16 requests, batch 8,
   four sharing a 256-token prefix, 32 new tokens each, drained twice.
   Every decode tick must launch K1 once per layer;
6. parity: a full-width 2-layer float32 model drains the same requests on
   the card (K1) and on the CPU (plain path); the tokens must agree;
7. K2: the ``flash_attention`` kernel against its plain version: phi4-mini's
   geometry (24/8 heads, D 128), gemma-2b's (8/1, D 256), a ragged length,
   window 96, softcap 30 and a non-causal cross length, in float32
   (tolerance 2e-4) and bfloat16 (3e-2, and within one bfloat16 rounding
   of the float32 plain version);
8. K2 time at the dense phase's largest prefill (B 1, 24/8 heads, S 512,
   D 128, bf16, causal), beside its plain version, SDPA and its bound;
9. dense serve: full-width phi4-mini-3.8b (bf16, random weights from a
   seeded generator) through ``ServeEngine(cache_backend="dense")`` with
   ``attn_impl="pallas"``: the same 16 requests, batch 8, max_len 1024, 32
   new tokens each, drained twice.  Every prefill must launch K2 once per
   layer;
10. dense parity: a full-width 2-layer float32 phi4-mini drains the parity
   requests densely on the card (K2) and on the CPU (plain path); the
   tokens must agree;
11. K4-K7 (``stream_copy``, ``strided_copy``, ``random_gather``,
   ``pointer_chase``) against their plain versions on the card, exactly
   (they copy): K4 in float32, bfloat16 and int8, copy and x2, several
   tiles; K5 at strides coprime and not coprime with the block count; K6
   with repeated LFSR indices, units of 2 B to 4 KiB and block_rows 4; K7
   on chains sized for L1 (16 KiB), L2 (16 MiB) and HBM (256 MiB), one
   chain and 64;
12. K4-K7 time at the memory sweeps' card-scale shapes (1 GiB working
   sets), each also checked exactly there, beside the plain version, one
   PyTorch call where one computes the same function, and the bound; K7
   as ns per hop in L1, L2 and HBM;
13. memory: the seven ported sweeps (latency, outstanding, unit_size,
   stride, burst, num_kernels, random) at card scale through
   ``repro_torch.bench.run_sweeps``, every row printed.  The pointer chase
   must be the slowest random-access row, no row may read above 105% of
   3.35 TB/s, and each of K4-K7 must have launched;
14. calibrate: the memory model's latency and bandwidth fitted to those
   rows, beside the spec's.

It ends with the kernels' JSON line, the card line and the result line.
Any failure exits non-zero before the result line; so does a host without
a card, or a directory without the package.
"""
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor rate
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
BF16_ROUNDING = 2.0 ** -8          # bfloat16 unit roundoff
L2_BYTES = 50 * 2**20


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# K1: paged_attention
# ---------------------------------------------------------------------------

def k1_inputs(torch, gen, b, hq, hkv, d, page, n, vlens, dtype, int8=False,
              copies=1):
    """Pools with a null page 0, a shuffled table of distinct pages per row,
    ragged lengths; ``copies`` independent pool pairs (for cold timing)."""
    dev = torch.device("cuda")
    pool = 1 + b * n
    q = torch.randn((b, hq, d), generator=gen).to(dev, dtype)
    pools = []
    for _ in range(copies):
        if int8:
            kv = [torch.randint(-127, 128, (pool, page, hkv, d),
                                generator=gen, dtype=torch.int8).to(dev)
                  for _ in range(2)]
            sc = [(torch.rand((pool, page), generator=gen) * 0.05).to(dev)
                  for _ in range(2)]
        else:
            kv = [torch.randn((pool, page, hkv, d), generator=gen
                              ).to(dev, dtype) for _ in range(2)]
            sc = [None, None]
        pools.append((kv[0], kv[1], sc[0], sc[1]))
    table = (1 + torch.randperm(b * n, generator=gen)).reshape(b, n)
    table = table.to(dev, torch.int32)
    valid = torch.tensor(vlens, dtype=torch.int32, device=dev)
    return q, pools, table, valid


def k1_cases():
    """(name, B, Hq, Hkv, D, page, N, valid lengths, kwargs)."""
    return [
        # gemma-2b decode geometry: 1, 7, 9, a multiple of the page, full
        ("gemma-2b", 5, 8, 1, 256, 8, 16, [1, 7, 9, 64, 128], {}),
        ("gqa", 3, 8, 2, 128, 8, 12, [3, 50, 96], {}),
        ("softcap", 3, 8, 2, 128, 8, 12, [1, 40, 96], dict(softcap=30.0)),
        ("ring-window", 4, 8, 1, 256, 8, 4, [5, 30, 61, 200],
         dict(window=24)),
        ("int8-lanes", 3, 8, 1, 256, 8, 12, [2, 57, 96], dict(int8=True)),
        ("empty-rows", 3, 8, 1, 256, 8, 16, [0, 0, 40], {}),
        ("main-path", 8, 8, 1, 256, 8, 128, [1024] * 8, {}),
    ]


def k1_check(torch, pa, ref):
    """Every case in both dtypes against the plain version; returns the
    largest absolute error seen."""
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for name, b, hq, hkv, d, page, n, vlens, kw in k1_cases():
        kw = dict(kw)
        int8 = kw.pop("int8", False)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, pools, table, valid = k1_inputs(torch, gen, b, hq, hkv, d,
                                               page, n, vlens, dtype, int8)
            kp, vp, ks, vs = pools[0]
            got = pa.paged_attention(q, kp, vp, table, valid, k_scale=ks,
                                     v_scale=vs, **kw)
            torch.cuda.synchronize()
            want = ref.paged_attention(q, kp, vp, table, valid, k_scale=ks,
                                       v_scale=vs, **kw)
            g, w = got.float(), want.float()
            check(bool(torch.isfinite(g).all()), f"K1 {name} {dname}: "
                  "non-finite output")
            err = float((g - w).abs().max())
            tol = TOL[dname]
            ok = bool(((g - w).abs() <= tol + tol * w.abs()).all())
            tight = ""
            if dname == "bfloat16":
                # the kernel computes in float32 and rounds its output once
                w32 = ref.paged_attention(
                    q.float(), kp if int8 else kp.float(),
                    vp if int8 else vp.float(), table, valid, k_scale=ks,
                    v_scale=vs, **kw)
                lim = TOL["float32"] + BF16_ROUNDING * w32.abs()
                err32 = float((g - w32).abs().max())
                ok32 = bool(((g - w32).abs() <= lim).all())
                tight = (f" err_vs_f32_plain={err32:.3e} "
                         f"tol_f32_plus_one_rounding=1e-4+2^-8*|w| "
                         f"ok_f32_plain={ok32}")
                ok = ok and ok32
            print(f"[K1] case={name} dtype={dname} B={b} Hq={hq} Hkv={hkv} "
                  f"D={d} page={page} N={n} max_abs_err={err:.3e} "
                  f"tol={tol}{tight} ok={ok}", flush=True)
            check(ok, f"K1 {name} {dname}: max_abs_err {err} over {tol}, "
                  "or more than one bfloat16 rounding from the float32 "
                  "plain version")
            worst = max(worst, err)
    return worst


def time_ms(torch, fn, sets, iters=50, warmup=5):
    """CUDA-event time per call, cycling through ``sets`` of inputs whose
    total exceeds the L2 cache, so every call reads device memory."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def k1_time(torch, pa, ref, card):
    import torch.nn.functional as F
    b, hq, hkv, d, page, n = 8, 8, 1, 256, 8, 128
    vlens = [n * page] * b
    dtype = torch.bfloat16
    itemsize = 2
    kv_bytes = sum(vlens) * hkv * d * itemsize * 2
    copies = -(-3 * L2_BYTES // kv_bytes)
    gen = torch.Generator().manual_seed(1)
    q, pools, table, valid = k1_inputs(torch, gen, b, hq, hkv, d, page, n,
                                       vlens, dtype, copies=copies)
    sets = [(q, kp, vp, table, valid) for kp, vp, _, _ in pools]
    ms = time_ms(torch, lambda *a: pa.paged_attention(*a), sets)
    plain_ms = time_ms(torch, lambda *a: ref.paged_attention(*a), sets)
    # yardstick: one SDPA call over K/V already gathered out of the pages
    tbl = table.long()
    gathered = [(q[:, :, None, :],
                 kp[tbl].reshape(b, n * page, hkv, d).transpose(1, 2)
                 .contiguous(),
                 vp[tbl].reshape(b, n * page, hkv, d).transpose(1, 2)
                 .contiguous())
                for _, kp, vp, _, _ in sets]
    library_ms = time_ms(torch, lambda qq, kk, vv:
                         F.scaled_dot_product_attention(qq, kk, vv,
                                                        enable_gqa=True),
                         gathered)
    # bound: each input read once, the output written once (bytes), or the
    # q.k and p.v products at the bf16 peak (operations); the larger
    moved = (kv_bytes + 2 * q.numel() * itemsize + table.numel() * 4
             + valid.numel() * 4)
    ops = 4 * sum(vlens) * hq * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[K1 time] shape=B{b} Hq{hq} Hkv{hkv} D{d} page{page} N{n} "
          f"valid={vlens[0]} bf16 pool_copies={copies} card='{card}' "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} bound_by={bound_by} "
          f"achieved_GBps={moved / ms / 1e6:.1f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# K2: flash_attention
# ---------------------------------------------------------------------------

def k2_cases():
    """(name, B, Hq, Hkv, Sq, Skv, D, kwargs); every row sees a key."""
    return [
        ("phi4-mini", 1, 24, 8, 512, 512, 128, {}),
        ("gemma-2b", 1, 8, 1, 512, 512, 256, {}),
        ("ragged", 2, 24, 8, 333, 333, 128, {}),
        ("window-96", 1, 8, 2, 300, 300, 128, dict(window=96)),
        ("softcap-30", 1, 8, 1, 200, 200, 256, dict(softcap=30.0)),
        ("cross-noncausal", 2, 24, 8, 100, 356, 128, dict(causal=False)),
    ]


def k2_check(torch, fa, ref):
    """Every case in both dtypes against the plain version; returns the
    largest absolute error seen."""
    gen = torch.Generator().manual_seed(2)
    dev = torch.device("cuda")
    worst = 0.0
    for name, b, hq, hkv, sq, skv, d, kw in k2_cases():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q = torch.randn((b, hq, sq, d), generator=gen).to(dev, dtype)
            k, v = (torch.randn((b, hkv, skv, d), generator=gen
                                ).to(dev, dtype) for _ in range(2))
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, **kw)
            g, w = got.float(), want.float()
            check(bool(torch.isfinite(g).all()), f"K2 {name} {dname}: "
                  "non-finite output")
            err = float((g - w).abs().max())
            tol = FLASH_TOL[dname]
            ok = bool(((g - w).abs() <= tol + tol * w.abs()).all())
            tight = ""
            if dname == "bfloat16":
                w32 = ref.flash_attention(q.float(), k.float(), v.float(),
                                          **kw)
                err32 = float((g - w32).abs().max())
                ok32 = bool(((g - w32).abs()
                             <= TOL["float32"] + BF16_ROUNDING * w32.abs()
                             ).all())
                tight = (f" err_vs_f32_plain={err32:.3e} "
                         f"tol_f32_plus_one_rounding=1e-4+2^-8*|w| "
                         f"ok_f32_plain={ok32}")
                ok = ok and ok32
            print(f"[K2] case={name} dtype={dname} B={b} Hq={hq} Hkv={hkv} "
                  f"Sq={sq} Skv={skv} D={d} {kw or ''} max_abs_err={err:.3e} "
                  f"tol={tol}{tight} ok={ok}", flush=True)
            check(ok, f"K2 {name} {dname}: max_abs_err {err} over {tol}, "
                  "or more than one bfloat16 rounding from the float32 "
                  "plain version")
            worst = max(worst, err)
    return worst


def k2_time(torch, fa, ref, card):
    import torch.nn.functional as F
    b, hq, hkv, s, d = 1, 24, 8, 512, 128
    itemsize = 2
    moved = (2 * hq + 2 * hkv) * b * s * d * itemsize    # q, k, v, o
    copies = -(-3 * L2_BYTES // moved)
    gen = torch.Generator().manual_seed(3)
    dev = torch.device("cuda")
    sets = [tuple(torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                  for shape in ((b, hq, s, d), (b, hkv, s, d),
                                (b, hkv, s, d)))
            for _ in range(copies)]
    ms = time_ms(torch, lambda *a: fa.flash_attention(*a), sets)
    plain_ms = time_ms(torch, lambda *a: ref.flash_attention(*a), sets)
    library_ms = time_ms(torch, lambda qq, kk, vv:
                         F.scaled_dot_product_attention(
                             qq, kk, vv, is_causal=True, enable_gqa=True),
                         sets)
    # bound: q, k, v read once and o written once (bytes), or the causal
    # q.k and p.v products at the bf16 peak (operations); the larger
    ops = 2 * b * hq * s * s * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[K2 time] shape=B{b} Hq{hq} Hkv{hkv} S{s} D{d} bf16 causal "
          f"input_copies={copies} card='{card}' ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} bound_by={bound_by} "
          f"achieved_TFLOPs={ops / ms / 1e9:.2f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_requests(np, Request, vocab, seed, n, lens, shared_len, shared_at,
                  max_new):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len).astype(np.int32)
    reqs = []
    for rid in range(n):
        s = int(rng.integers(*lens))
        if rid in shared_at:
            s = max(s, shared_len + 1)
            tail = rng.integers(0, vocab, size=s - shared_len)
            prompt = np.concatenate([shared, tail.astype(np.int32)])
        else:
            prompt = rng.integers(0, vocab, size=s).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    return reqs


def timed_engine_class(torch, ServeEngine):
    class TimedEngine(ServeEngine):
        """Accumulates wall time of prefills (paged chunks or whole dense
        prompts) and decode windows, each closed by a device
        synchronise."""

        def _init_state(self):
            super()._init_state()
            self.prefill_s = 0.0
            self.decode_s = 0.0

        def _prefill_tick(self, slot):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._prefill_tick(slot)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0

        def _prefill_into_slot(self, slot, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._prefill_into_slot(slot, req)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0

        def decode_many(self, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().decode_many(n)
            torch.cuda.synchronize()
            self.decode_s += time.perf_counter() - t0
            return out
    return TimedEngine


def drain(torch, eng, reqs):
    eng.reset()
    for r in reqs:
        r.out_tokens.clear()
        eng.add_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _prepare_decode(eng, reqs):
    """A full batch with every prompt prefilled, ready for one window."""
    eng.reset()
    for r in reqs[:eng.bsz]:
        r.out_tokens.clear()
        eng.add_request(r)
    while eng.queue or eng._pending:
        eng._admit()
    return lambda: eng.decode_many(eng.window)


def _prepare_prefill(eng, reqs):
    """One request admitted with its first chunk run; the next chunk next."""
    eng.reset()
    reqs[0].out_tokens.clear()
    eng.add_request(reqs[0])
    eng._admit()
    check(0 in eng._pending, "profiled prompt fits one chunk")
    return lambda: eng._prefill_tick(0)


def _prepare_dense_prefill(eng, reqs):
    """The longest prompt, prefilled whole into slot 0 of an empty batch."""
    eng.reset()
    req = max(reqs, key=lambda r: r.prompt.shape[0])
    req.out_tokens.clear()
    return lambda: eng._prefill_into_slot(0, req)


def profile_window(torch, eng, reqs, steps=(("decode window", _prepare_decode),
                                            ("prefill chunk",
                                             _prepare_prefill))):
    """Device busy share of each profiled step: by default one decode
    window and one prefill chunk."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    lines = []
    for label, prepare in steps:
        fn = prepare(eng, reqs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels only: an aten op's own device time repeats its kernels'
        evs = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in evs) / 1e3   # ms
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:4]
        desc = "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}"
                         f"ms x{e.count}" for e in top)
        lines.append(f"[profile] step='{label}' wall_ms={wall * 1e3:.3f} "
                     f"device_busy_ms={busy:.3f} "
                     f"device_busy_share={busy / (wall * 1e3):.3f} "
                     f"top='{desc}'")
    return lines


def serve_phase(torch, np, card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["gemma-2b"]
    n_attn = cfg.num_layers
    t0 = time.perf_counter()
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] arch={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.param_dtype} "
          f"params={n_params} init_s={time.perf_counter() - t0:.2f}",
          flush=True)
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 8, 1024)
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)
    results = {}
    for run in ("first", "warm"):
        pa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        dt = drain(torch, eng, reqs)
        launches = pa.LAUNCHES
        st = eng.stats
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              f"{run} drain: a request missed its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens), f"{run} drain: token out of range")
        check(launches == n_attn * st.decode_steps,
              f"{run} drain: K1 launches {launches} != {n_attn} x "
              f"{st.decode_steps} decode ticks")
        check(launches > 0, "the main path never launched K1")
        results[run] = launches
        print(f"[serve] run={run} card='{card}' requests={len(reqs)} "
              f"batch={eng.bsz} max_len={eng.max_len} page={eng.page} "
              f"prefill_chunk={eng.prefill_chunk} tokens_out={st.tokens_out} "
              f"seconds={dt:.3f} tok_s={st.tokens_out / dt:.1f} "
              f"decode_steps={st.decode_steps} "
              f"decode_dispatches={st.decode_dispatches} "
              f"ms_per_decode_tick={1e3 * eng.decode_s / st.decode_steps:.3f} "
              f"prefill_chunks={st.prefill_chunks} "
              f"ms_per_prefill_chunk="
              f"{1e3 * eng.prefill_s / st.prefill_chunks:.3f} "
              f"prompt_tokens={st.prompt_tokens} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"pages_peak={st.pages_peak} k1_launches={launches} "
              f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}",
              flush=True)
    check(eng.stats.prefix_hit_tokens > 0, "no prefix hit on shared prompts")
    for line in profile_window(torch, eng, reqs):
        print(line, flush=True)
    return results["warm"]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def parity_phase(torch, np):
    from repro_torch.configs import ARCHS, override
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    cpu = build(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", "cuda"):
        bundle = cpu if dev == "cpu" else build(cfg, device="cuda")
        p = params if dev == "cpu" else _to(params, "cuda")
        eng = ServeEngine(bundle, p, 4, 128, device=dev)
        reqs = make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                             (0, 4), 8)
        before = pa.LAUNCHES
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion()
        outs[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            check(pa.LAUNCHES - before == 2 * eng.stats.decode_steps,
                  "parity drain on the card did not run K1 every tick")
        check(all(len(t) == 8 for t in outs[dev]), f"{dev}: budget missed")
    same = outs["cpu"] == outs["cuda"]
    print(f"[parity] arch=gemma-2b full width, 2 layers, float32 "
          f"requests={len(outs['cpu'])} tokens_each=8 "
          f"cuda_equals_cpu={same}", flush=True)
    check(same, f"greedy tokens differ: cpu {outs['cpu']} cuda "
          f"{outs['cuda']}")


def dense_serve_phase(torch, np, card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tune.plan import next_pow2

    cfg = ARCHS["phi4-mini-3.8b"]
    n_attn = cfg.num_layers
    t0 = time.perf_counter()
    bundle = build(cfg, RuntimeFlags(attn_impl="pallas"))
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] arch={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.param_dtype} "
          f"params={n_params} init_s={time.perf_counter() - t0:.2f}",
          flush=True)
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 8, 1024,
                                                 cache_backend="dense")
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)
    buckets = sorted({min(next_pow2(max(8, r.prompt.shape[0])), 1024)
                      for r in reqs})
    launches = 0
    for run in ("first", "warm"):
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        dt = drain(torch, eng, reqs)
        launches = fa.LAUNCHES
        st = eng.stats
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              f"dense {run} drain: a request missed its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens),
              f"dense {run} drain: token out of range")
        check(st.prefills == len(reqs), f"dense {run} drain: {st.prefills} "
              f"prefills for {len(reqs)} requests")
        check(launches == n_attn * st.prefills,
              f"dense {run} drain: K2 launches {launches} != {n_attn} x "
              f"{st.prefills} prefills")
        print(f"[dense serve] run={run} card='{card}' requests={len(reqs)} "
              f"batch={eng.bsz} max_len={eng.max_len} "
              f"tokens_out={st.tokens_out} seconds={dt:.3f} "
              f"tok_s={st.tokens_out / dt:.1f} prefills={st.prefills} "
              f"ms_per_prefill={1e3 * eng.prefill_s / st.prefills:.3f} "
              f"prefill_buckets={buckets} "
              f"prefill_retraces={st.prefill_retraces} "
              f"decode_steps={st.decode_steps} "
              f"decode_dispatches={st.decode_dispatches} "
              f"ms_per_decode_tick={1e3 * eng.decode_s / st.decode_steps:.3f} "
              f"prompt_tokens={st.prompt_tokens} "
              f"kv_cache_GiB={eng.kv_bytes() / 2**30:.3f} "
              f"k2_launches={launches} "
              f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}",
              flush=True)
    for line in profile_window(torch, eng, reqs, steps=(
            ("dense decode window", _prepare_decode),
            ("dense prefill S512", _prepare_dense_prefill))):
        print(line, flush=True)
    return launches


def dense_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, override
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = override(ARCHS["phi4-mini-3.8b"], num_layers=2,
                   param_dtype="float32", compute_dtype="float32")
    flags = RuntimeFlags(attn_impl="pallas")
    cpu = build(cfg, flags, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", "cuda"):
        bundle = cpu if dev == "cpu" else build(cfg, flags, device="cuda")
        p = params if dev == "cpu" else _to(params, "cuda")
        eng = ServeEngine(bundle, p, 4, 128, cache_backend="dense",
                          device=dev)
        reqs = make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                             (0, 4), 8)
        before = fa.LAUNCHES
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion()
        outs[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            check(fa.LAUNCHES - before == 2 * eng.stats.prefills,
                  "dense parity drain on the card did not run K2 in every "
                  "prefill layer")
        check(all(len(t) == 8 for t in outs[dev]), f"{dev}: budget missed")
        del eng, p
    same = outs["cpu"] == outs["cuda"]
    print(f"[dense parity] arch=phi4-mini-3.8b full width, 2 layers, "
          f"float32, dense cache, attn_impl=pallas "
          f"requests={len(outs['cpu'])} tokens_each=8 "
          f"cuda_equals_cpu={same}", flush=True)
    check(same, f"greedy tokens differ: cpu {outs['cpu']} cuda "
          f"{outs['cuda']}")


# ---------------------------------------------------------------------------
# K4-K7: the memory engines
# ---------------------------------------------------------------------------

MEMORY_SWEEPS = ("latency", "outstanding", "unit_size", "stride", "burst",
                 "num_kernels", "random")
PEAK_SHARE_LIMIT = 1.05            # no row may read above 105% of 3.35 TB/s


def exact(torch, tag, desc, got, want):
    """Copies: the kernel must equal its plain version bit for bit."""
    torch.cuda.synchronize()
    same = (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got, want))
    err = (float((got.float() - want.float()).abs().max())
           if got.shape == want.shape and got.numel() else 0.0)
    print(f"[{tag}] {desc} max_abs_err={err:.3e} exact={same}", flush=True)
    check(same, f"{tag} {desc}: the kernel differs from its plain version")
    return err


def k4_check(torch, ops, ref):
    gen = torch.Generator().manual_seed(4)
    dev = torch.device("cuda")
    worst = 0.0
    tiles = [((128, 128), 8, 0), ((256, 512), 64, 0), ((64, 384), 8, 128),
             ((96, 7), 32, 0), ((4096, 1024), 256, 0)]
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for shape, br, bc in tiles:
            if dtype == torch.int8:
                x = torch.randint(-128, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev)
            else:
                x = (torch.randn(shape, generator=gen) * 40).to(dev, dtype)
            for mode in ("copy", "rw"):
                worst = max(worst, exact(
                    torch, "K4", f"dtype={str(dtype)[6:]} shape={shape} "
                    f"tile=({br},{bc}) mode={mode}",
                    ops.stream_copy(x, block_rows=br, block_cols=bc,
                                    mode=mode), ref.stream_copy(x, mode)))
    return worst


def k5_check(torch, ops, ref):
    gen = torch.Generator().manual_seed(5)
    dev = torch.device("cuda")
    worst = 0.0
    cases = [(torch.float32, (256, 64), br, s) for br in (4, 16)
             for s in (1, 2, 3, 7, 15, 64)]       # 64 and 16 blocks
    cases += [(torch.bfloat16, (96, 40), 8, 5), (torch.int8, (60, 3), 1, 6)]
    for dtype, shape, br, stride in cases:
        x = torch.randn(shape, generator=gen).mul(40).clamp(-127, 127)
        x = x.to(dev, dtype)
        nblocks = shape[0] // br
        worst = max(worst, exact(
            torch, "K5", f"dtype={str(dtype)[6:]} shape={shape} "
            f"block_rows={br} nblocks={nblocks} stride={stride} "
            f"coprime={math.gcd(stride, nblocks) == 1}",
            ops.strided_copy(x, block_rows=br, stride=stride),
            ref.strided_copy(x, block_rows=br, stride=stride)))
    return worst


def k6_check(torch, ops, ref):
    gen = torch.Generator().manual_seed(6)
    dev = torch.device("cuda")
    worst = 0.0
    # 1000 LFSR indices over 512 rows: duplicates by construction
    idx = ops.lfsr_indices(1000, bits=16, device=dev) % 512
    check(torch.unique(idx).numel() < idx.numel(), "K6 indices repeat")
    for dtype, cols, br in ((torch.float32, 1, 1), (torch.float32, 16, 1),
                            (torch.float32, 1024, 1), (torch.float32, 16, 4),
                            (torch.bfloat16, 1, 1), (torch.int8, 3, 1),
                            (torch.int8, 3, 4)):
        x = torch.randn((512, cols), generator=gen).mul(40).clamp(-127, 127)
        x = x.to(dev, dtype)
        i = idx % (512 // br)
        worst = max(worst, exact(
            torch, "K6", f"dtype={str(dtype)[6:]} rows=512 unit_bytes="
            f"{br * cols * x.element_size()} block_rows={br} "
            f"indices={i.numel()} distinct={torch.unique(i).numel()}",
            ops.random_gather(x, i, block_rows=br),
            ref.random_gather(x, i, block_rows=br)))
    return worst


K7_LEVELS = (("L1", 1 << 12), ("L2", 1 << 22), ("HBM", 1 << 26))


def k7_check(torch, ops, ref, pc):
    dev = torch.device("cuda")
    worst = 0.0
    for level, n in K7_LEVELS:
        table, builder = pc.chain(n, 7, dev)
        worst = max(worst, exact(
            torch, "K7", f"level={level} n={n} table_bytes={4 * n} "
            f"chains=1 steps=8192 chain={builder}",
            ops.pointer_chase(table, steps=8192),
            ref.pointer_chase(table, 8192)))
        del table
    for level, n in ((lvl, n >> 6) for lvl, n in K7_LEVELS):
        tables = torch.stack([pc.make_chain_randperm(n, c, dev)
                              for c in range(64)])
        worst = max(worst, exact(
            torch, "K7", f"level={level} n={n} per chain, 64 chains "
            f"({4 * 64 * n} bytes) steps=1024",
            ops.pointer_chase(tables, steps=1024),
            ref.pointer_chase(tables, 1024)))
        del tables
    return worst


def best_ms(torch, engines, fn, *args, trials=5, flush=True):
    """Best CUDA-event time of ``trials`` calls after one warm-up, the L2
    flushed before each call unless ``flush`` is False."""
    return 1e3 * min(engines.trial_walls(
        fn, *args, device=torch.device("cuda"), trials=trials, flush=flush))


def bound(moved):
    return 1e3 * moved / HBM_BYTES_PER_S


def k4_time(torch, ops, ref, engines, card):
    x = torch.randn((1 << 18, 1024), device="cuda")
    exact(torch, "K4", "dtype=float32 shape=(262144, 1024) tile=(256,1024) "
          "mode=copy (timed shape)", ops.stream_copy(x), ref.stream_copy(x))
    out = torch.empty_like(x)
    ms = best_ms(torch, engines, lambda a: ops.stream_copy(a), x)
    plain_ms = best_ms(torch, engines, lambda a: ref.stream_copy(a), x)
    library_ms = best_ms(torch, engines, lambda a: out.copy_(a), x)
    moved = 2 * x.numel() * 4
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound(moved), bound_by="bytes")
    print(f"[K4 time] shape=262144x1024 float32 copy tile=256 rows (1 MiB) "
          f"card='{card}' ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (Tensor.copy_) "
          f"bound_ms={t['bound_ms']:.4f} bound_by=bytes "
          f"achieved_GBps={moved / ms / 1e6:.1f}", flush=True)
    return t


def k5_time(torch, ops, ref, engines, card):
    nblocks, br, cols, stride = (1 << 15) + 1, 8, 1024, 4
    x = torch.randn((nblocks * br, cols), device="cuda")
    exact(torch, "K5", f"dtype=float32 shape=({nblocks * br}, {cols}) "
          f"block_rows={br} stride={stride} (timed shape)",
          ops.strided_copy(x, block_rows=br, stride=stride),
          ref.strided_copy(x, block_rows=br, stride=stride))
    xf = x.reshape(nblocks, br * cols)
    src = (torch.arange(nblocks, device="cuda") * stride) % nblocks
    ms = best_ms(torch, engines, lambda a: ops.strided_copy(
        a, block_rows=br, stride=stride), x)
    plain_ms = best_ms(torch, engines, lambda a: ref.strided_copy(
        a, block_rows=br, stride=stride), x)
    library_ms = best_ms(torch, engines, lambda a: a.index_select(0, src), xf)
    moved = 2 * x.numel() * 4
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound(moved), bound_by="bytes")
    print(f"[K5 time] shape={nblocks * br}x{cols} float32 block_rows={br} "
          f"stride={stride} card='{card}' ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"(index_select on the block view) bound_ms={t['bound_ms']:.4f} "
          f"bound_by=bytes achieved_GBps={moved / ms / 1e6:.1f}", flush=True)
    return t


def k6_time(torch, ops, ref, engines, card):
    rows, cols, n_idx = 1 << 24, 16, 1 << 20
    x = torch.randn((rows, cols), device="cuda")
    idx = ops.lfsr_indices(n_idx, bits=24, device="cuda") % rows
    exact(torch, "K6", f"dtype=float32 rows={rows} unit_bytes=64 "
          f"indices={n_idx} (timed shape)", ops.random_gather(x, idx),
          ref.random_gather(x, idx))
    ms = best_ms(torch, engines, lambda a, i: ops.random_gather(a, i), x, idx)
    plain_ms = best_ms(torch, engines, lambda a, i: ref.random_gather(a, i),
                       x, idx)
    library_ms = best_ms(torch, engines, lambda a, i: a.index_select(0, i),
                         x, idx)
    unit = cols * 4
    # each index: its 4 bytes, the unit read in whole 32-byte sectors, the
    # unit written
    moved = n_idx * (4 + max(unit, 32) + unit)
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound(moved), bound_by="bytes")
    print(f"[K6 time] table={rows}x{cols} float32 (1 GiB) unit_bytes={unit} "
          f"indices={n_idx} (24-bit LFSR) card='{card}' ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"(index_select) bound_ms={t['bound_ms']:.4f} bound_by=bytes "
          f"useful_GBps={2 * n_idx * unit / ms / 1e6:.1f}", flush=True)
    return t


def k7_time(torch, ops, ref, pc, engines, card):
    steps = 1 << 13
    levels = {}
    for level, n in K7_LEVELS:
        table, builder = pc.chain(n, 0, "cuda")
        hbm = level == "HBM"
        # L1 and L2: the warm-up leaves the chain's lines in the cache; HBM:
        # the L2 is flushed before each call
        levels[level] = best_ms(torch, engines, lambda t: ops.pointer_chase(
            t, steps=steps), table, flush=hbm)
        if hbm:
            plain_ms = best_ms(torch, engines, lambda t: ref.pointer_chase(
                t, steps), table, trials=2)
        del table
    ms = levels["HBM"]
    # steps x (one 32-byte sector read + 4 bytes of trace written): not
    # what bounds a chain of dependent loads, which is latency
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
             bound_ms=bound(steps * (32 + 4)), bound_by="bytes")
    ns = " ".join(f"ns_per_hop_{lvl}={levels[lvl] * 1e6 / steps:.1f}"
                  for lvl, _ in K7_LEVELS)
    print(f"[K7 time] steps={steps} chains=1 levels=L1 16 KiB, L2 16 MiB, "
          f"HBM 256 MiB card='{card}' {ns} ms={ms:.4f} (HBM) "
          f"plain_ms={plain_ms:.4f} library_ms=null (no single torch call "
          f"chases pointers) bound_ms={t['bound_ms']:.6f} bound_by=bytes "
          f"(not meaningful: latency-bound by construction)", flush=True)
    return t


def memory_phase(torch, card, mods):
    """The seven ported sweeps at card scale: the memory engines' main
    path.  Returns the run and K4-K7's launches in it."""
    from repro_torch.bench import run_sweeps
    for m in mods.values():
        m.reset_launches()
    t0 = time.perf_counter()
    run = run_sweeps(names=MEMORY_SWEEPS, device="cuda", out_dir=None)
    seconds = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    check(not run.failures, f"memory sweeps failed: {run.failures}")
    rows = {r.name: r for r in run.results}
    rnd = [r for r in run.results if r.sweep == "random"]
    slowest = min(rnd, key=lambda r: r.gbps_measured)
    check(slowest.name == "random_pointer_chase",
          f"the chase is not the slowest random row: {slowest.name}")
    limit = PEAK_SHARE_LIMIT * HBM_BYTES_PER_S / 1e9
    over = [(r.name, r.gbps_measured) for r in run.results
            if r.gbps_measured > limit]
    check(not over, f"rows above {limit:.0f} GB/s: {over}")
    for name, n in launches.items():
        check(n > 0, f"the memory path never launched {name}")
    hops = sorted(float(r.extras["ns_per_hop"]) for r in run.results
                  if r.name.startswith("latency_region_"))
    print(f"[memory] card='{card}' sweeps={','.join(MEMORY_SWEEPS)} "
          f"rows={len(run.results)} seconds={seconds:.2f} "
          f"seq_GBps={rows['seq'].gbps_measured:.1f} "
          f"random_lfsr_GBps={rows['random_lfsr'].gbps_measured:.1f} "
          f"random_prng_GBps={rows['random_prng'].gbps_measured:.1f} "
          f"chase_GBps={rows['random_pointer_chase'].gbps_measured:.4f} "
          f"chase_slowest=True hbm_ns_per_hop_median={hops[len(hops) // 2]} "
          f"max_row_GBps={max(r.gbps_measured for r in run.results):.1f} "
          f"limit_GBps={limit:.0f} launches={launches}", flush=True)
    return run, launches


def calibrate_phase(run):
    from repro_torch.bench import calibrate
    from repro_torch.core.memmodel import H100
    cal = calibrate(run=run)
    print(f"[calibrate] samples={cal.n_samples} "
          f"fitted_latency_ns={cal.spec.latency_s * 1e9:.1f} "
          f"spec_latency_ns={H100.latency_s * 1e9:.1f} "
          f"fitted_hbm_GBps={cal.spec.hbm_bw / 1e9:.1f} "
          f"spec_hbm_GBps={H100.hbm_bw / 1e9:.1f} "
          f"rms_log_error={cal.rms_log_error:.3f} "
          f"measured_over_model={ {k: round(v, 3) for k, v in cal.ratios.items()} }",
          flush=True)


# ---------------------------------------------------------------------------

def main():
    try:
        import numpy as np
        import torch
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.core import engines
        from repro_torch.kernels import ops
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import pointer_chase as pc
        from repro_torch.kernels import random_gather as rg
        from repro_torch.kernels import ref
        from repro_torch.kernels import stream_copy as sc
        from repro_torch.kernels import strided_copy as st
    except ImportError as e:
        print(f"[FAIL] the port does not import ({e}); run chip_smoke.py "
              "from the root of a checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[FAIL] no CUDA card is visible: this smoke run needs one",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"[card] card='{card}' torch={torch.__version__} "
              f"cuda={torch.version.cuda} python={sys.version.split()[0]}",
              flush=True)
        t0 = time.perf_counter()
        built = kbuild.build()
        print(f"[build] seconds={time.perf_counter() - t0:.2f} "
              f"built={sorted(built)} dir={kbuild.BUILD_DIR}", flush=True)
        for name in kbuild.sources():
            for line in kbuild.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas] {name}: {line.strip()}", flush=True)
        err = k1_check(torch, pa, ref)
        timing = k1_time(torch, pa, ref, card)
        launches = serve_phase(torch, np, card)
        parity_phase(torch, np)
        gc.collect()                 # the gemma-2b engine and weights go
        torch.cuda.empty_cache()
        k2_err = k2_check(torch, fa, ref)
        k2_timing = k2_time(torch, fa, ref, card)
        k2_launches = dense_serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        dense_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        mem_err = dict(stream_copy=k4_check(torch, ops, ref),
                       strided_copy=k5_check(torch, ops, ref),
                       random_gather=k6_check(torch, ops, ref),
                       pointer_chase=k7_check(torch, ops, ref, pc))
        mem_time = dict(
            stream_copy=k4_time(torch, ops, ref, engines, card),
            strided_copy=k5_time(torch, ops, ref, engines, card),
            random_gather=k6_time(torch, ops, ref, engines, card),
            pointer_chase=k7_time(torch, ops, ref, pc, engines, card))
        gc.collect()
        torch.cuda.empty_cache()
        run, mem_launches = memory_phase(torch, card, dict(
            stream_copy=sc, strided_copy=st, random_gather=rg,
            pointer_chase=pc))
        calibrate_phase(run)
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr)
        return 1
    k1 = dict(name="paged_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/paged_attention.cu",
              replaces="src/repro/kernels/paged_attention.py:100",
              launches=launches, max_abs_err=err, ms=timing["ms"],
              plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
              bound_by=timing["bound_by"], library_ms=timing["library_ms"])
    k2 = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/flash_attention.cu",
              replaces="src/repro/kernels/flash_attention.py:128",
              launches=k2_launches, max_abs_err=k2_err, ms=k2_timing["ms"],
              plain_ms=k2_timing["plain_ms"], bound_ms=k2_timing["bound_ms"],
              bound_by=k2_timing["bound_by"],
              library_ms=k2_timing["library_ms"])
    replaces = dict(stream_copy="src/repro/kernels/stream_copy.py:29",
                    strided_copy="src/repro/kernels/strided_copy.py:22",
                    random_gather="src/repro/kernels/random_gather.py:46",
                    pointer_chase="src/repro/kernels/pointer_chase.py:32")
    mem = [dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{name}.cu",
                replaces=replaces[name], launches=mem_launches[name],
                max_abs_err=mem_err[name], **mem_time[name])
           for name in replaces]
    print(json.dumps({"kernels": [k1, k2] + mem}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
