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
   tokens must agree.

It ends with the kernels' JSON line, the card line and the result line.
Any failure exits non-zero before the result line; so does a host without
a card, or a directory without the package.
"""
import gc
import json
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

def main():
    try:
        import numpy as np
        import torch
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import ref
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
    print(json.dumps({"kernels": [k1, k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
