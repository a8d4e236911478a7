#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself and
builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels``.  Phases, one ``[tag]`` line each:

1. card: the card's name and power limit, torch and CUDA versions;
2. build: every kernel, one ``nvcc`` each, all started together; the
   compiler's registers and spills (``[ptxas]``), and a ``[sass]`` line per
   kernel counting its tensor-core and bulk-copy instructions in the built
   machine code (``HGMMA``: warpgroup ``wgmma``; ``HMMA``: warp
   ``mma.sync``; ``UBLKCP``: a TMA bulk copy), which fails unless K8 has
   ``HGMMA``, K1, K2 and K3 ``HMMA`` or ``HGMMA``, and K4 ``UBLKCP``;
3. K1: the ``paged_attention`` kernel against its plain PyTorch version on
   the card: gemma-2b's decode geometry with ragged lengths, GQA, softcap,
   a ring window, int8 lanes, rows with no live token, the main path's
   own shape, gemma2-27b's ring and global layers at 8192 tokens (B 4,
   32/16 heads, D 128, softcap 50, window 4096 on a table of 513 ring
   slots), gemma-2b's int8 pages of 16 tokens, and int8 pages at D 64,
   128 and 256 (GQA 8/2, pages of 8 and 16, softcap, a ring window, rows
   with no token, a cluster merge of 4 splits, and one row over 4096 pages
   whose 64 splits merge through the counter), each in
   float32 (tolerance 1e-4) and bfloat16 (3e-2; and, held against the
   plain version run in float32 on the same inputs, within one bfloat16
   rounding of its output), each line naming its configuration, split
   count and merge (bfloat16 q with bfloat16 or int8 pages at D 64, 128
   and 256 on the tensor cores);
4. K1 time at the main path's shape (B 8, 128 pages of 8 tokens), full
   and at the serve drain's ragged lengths (its first 8 prompts plus 16
   decoded tokens), then at gemma2-27b's ring and global geometry and at
   gemma-2b's int8 pages (the drain's lengths and full rows of 1024
   tokens), each beside its plain version, one SDPA call on the gathered
   (dequantized) K/V, and its bound, with the configuration run;
5. serve: full-width gemma-2b (bf16, random weights from a seeded
   generator) through the paged ``ServeEngine``: 16 requests, batch 8,
   four sharing a 256-token prefix, 32 new tokens each, drained twice.
   Every decode tick must launch K1 once per layer;
6. parity: a full-width 2-layer float32 model drains the same requests on
   the card (K1) and on the CPU (plain path); the tokens must agree;
7. K2: the ``flash_attention`` kernel against its plain version: phi4-mini's
   geometry (24/8 heads, D 128), gemma-2b's (8/1, D 256), a ragged length,
   window 96, softcap 30 and a non-causal cross length, in float32
   (tolerance 2e-4, the CUDA cores) and bfloat16 (3e-2, and within one
   bfloat16 rounding of the float32 plain version; the tensor cores), each
   line naming its route; and a window with Sq > Skv, whose rows without a
   key must be exactly 0;
8. K2 time at the dense phase's largest prefill (B 1, 24/8 heads, S 512,
   D 128, bf16, causal), beside its plain version, SDPA and its bound,
   with its route, design (tiles, P V precision) and resident blocks per
   SM;
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
   (they copy): K4 in float32, bfloat16 and int8, copy and x2, each line
   naming its route (bulk or element): whole-row and narrow tiles, tiles
   larger than the bulk ring and narrow tiles wider than a ring stage, rows
   of 7 elements, a base one element into a buffer and an array split into
   32 parts (one call each); K5 at strides coprime and not coprime with the
   block count; K6 with repeated LFSR indices, units of 2 B to 4 KiB and
   block_rows 4; K7 on chains sized for L1 (16 KiB), L2 (16 MiB) and HBM
   (256 MiB), one chain and 64;
12. K4-K7 time at the memory sweeps' card-scale shapes (1 GiB working
   sets), each also checked exactly there, beside the plain version, one
   PyTorch call where one computes the same function, and the bound: K4
   three times (1 MiB and 8 KiB tiles copied, beside ``Tensor.copy_``; 1
   MiB tiles doubled, beside ``torch.mul``), each with its route and
   configuration; K7 as ns per hop in L1, L2 and HBM, beside its latency
   bound (hops x the HBM latency this chase measured);
13. memory: the seven ported sweeps (latency, outstanding, unit_size,
   stride, burst, num_kernels, random) at card scale through
   ``repro_torch.bench.run_sweeps``, every row printed.  The pointer chase
   must be the slowest random-access row, no row may read above 105% of
   3.35 TB/s, and each of K4-K7 must have launched;
14. calibrate: the memory model's latency and bandwidth fitted to those
   rows, beside the spec's;
15. tune: the closed tune -> plan -> execute loop.  Plans for K3
   (``decode_attention``) at phi4-mini's and gemma-2b's dense-decode
   geometry (T 1024, D 128 and 256, bf16) and for K8 (``matmul``) at its
   two timed shapes, derived twice: under the H100's spec and under the
   spec that calibrate fitted (the fingerprints must differ).  Each plan's
   tiles, pipeline depth, predicted GB/s, fingerprint and source are
   printed, and K3 and K8 run through ``kernels.ops`` with their tiles left
   to the plan, from both caches; every launch must count, and every
   output must match the plain version.  bf16 K8 maps every plan onto one
   of three fixed tiles (by M and the plan's bn), so its two caches check
   the plumbing, not a choice of tiles;
16. K3: ``decode_attention`` against its plain version: phi4-mini's (24/8,
   D 128), gemma-2b's (8/1, D 256) and the reference test's (4/2, at D 64)
   geometry, T 100, 255 and 256, tiles of 32, 96 and 256 rows and the
   plan's, softcap 10, a valid length of 1, in float32 (1e-4) and bfloat16
   (3e-2, and within one bfloat16 rounding of the float32 plain version),
   each line naming the kernel configuration the plan's tiles map to
   (``kernel_config``); rows with a valid length of 0 must be exactly 0;
17. K3 time at B 8, T 1024, bf16, the plan's tiles, at phi4-mini's 24/8
   heads (D 128) and gemma-2b's 8/1 (D 256), each beside its plain
   version, SDPA on the cache's transposed views with a boolean mask, and
   the roofline bound;
18. K8: ``matmul`` against its plain version (TF32 off): the reference's
   (m, k, n) triples with blocks of 64 and 128, the plan's tiles at (96,
   100, 64), and the two timed shapes, in float32 (1e-4, the CUDA cores)
   and bfloat16 (2e-2, the tensor cores; at the timed shapes within one
   bfloat16 rounding of the float32 plain version plus the float32
   summation bound), each line naming the route and configuration it ran
   (tile, stages, staging by TMA or element by element);
19. K8 time at 4096^3 and at (M, N, K) = (8, 8192, 3072), bf16, the plan's
   tiles and the kernel's configuration, beside its plain version,
   ``torch.matmul`` and the roofline bound;
20. ring serve: full-width gemma2-27b (46 layers, 54.5 GB of bf16 weights
   drawn on the card) through the paged engine, batch 4, max_len 8192,
   prefill chunks of 256: 8 requests (prompts of 4160 and 5120 tokens past
   the 4096 window, six of 64-512 with three sharing a 256-token prefix),
   32 new tokens each, drained twice.  Every decode tick must launch K1
   once per layer (ring tables on the local layers, full tables on the
   global ones), the ring must turn (a ring page reused) and its peak stay
   within batch x ring_slots; prefix sharing stays off on a windowed
   stack, as in the reference.  A profiled decode window and prefill chunk
   follow;
21. int8 serve: full-width gemma-2b with ``kv_dtype="int8"`` (pages of 16
   tokens, the bf16 page's bytes), the serve phase's 16 requests drained
   twice; every tick launches K1 once per layer on its tensor-core route
   with int8 pages;
22. ring parity and int8 parity: gemma2-27b's (local, global) pair at its
   published widths (window narrowed to 32 so the ring turns in a short
   drain) and 2-layer gemma-2b with int8 KV, float32, drained on the card
   (K1) and on the CPU (plain path); the tokens must agree;
23. prng: JAX's threefry keys and bits (``repro_torch.serve.prng``) at
   (8, 256000) on the card exactly equal to the CPU's (bits, ``split``,
   ``fold_in``, ``subkey_chain``, ``uniform``), ``gumbel`` within 2 ulp;
   the sampler at gemma-2b's vocab for (temperature 0.9, top_p 0.95) and
   (temperature 0.8, top_k 50): masks, draws and times;
24. sampled serve: full-width gemma-2b (bf16) through the paged engine
   with each sampling setting (keys seeded with 3), then the first on
   int8 pages: the serve phase's 16 requests drained twice with identical
   tokens, K1 once a layer on every tick, the warm tick beside the greedy
   tick of phase 5;
25. sampled parity: the parity phase's model and requests sampled with
   (temperature 0.9, top_p 0.95) on the card and on the CPU: tokens and
   final keys must agree;
26. spec serve: full-width gemma-2b in float32, the serve phase's first 8
   requests through the vanilla engine and speculative engines (spec_k 3),
   greedy and sampled, drafting with the target itself and with weights
   from another seed (the draft's dense prefill through K2): tokens equal
   to vanilla, the self-draft's accept rate 1.0, the other draft's
   sampled proposals partly rejected, the pools conserve pages; rounds,
   accepted drafts per round and ms per round printed;
27. bench serve: the ``serve``, ``kernel_plan``, ``paged_serve`` and
   ``spec_serve`` sweeps at card scale, twice, persisted under
   ``build/bench_serve``, then ``repro_torch.bench.compare`` between the
   two runs: every row and verdict printed, and ``--gate structural``
   (deterministic rows equal, no vanished metric) must pass; wall-clock
   verdicts are advisory.

Kernel times are CUDA-event times over back-to-back calls behind a spin
of the card, so they time the card's work, not the host's enqueueing.

It ends with a ``[previous]`` line (K1's, K2's, K3's, K4's and K8's times
before their redesign, and K1's int8 pages on the CUDA cores, as PERF.md
records them: not measured in this run),
the kernels' JSON line (K1, K2, K3, K4 and K8 also carry their design, K7
its latency bound; K1 its launches on each serving path, the sampled ones
included, and its times at the new geometries), the card line and the
result line.
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
COVER_CYCLES = 2_000_000           # about 1 ms of spin on the card
# K1's and K2's kernels on the serving paths, by the words their names hold
# in the profiler (K1 merges its splits inside its one launch)
PORT_KERNELS = ("paged_attention", "flash_attention")
# times at the first timed shapes before each kernel's redesign, as PERF.md
# records them: K2 and K8 on the CUDA cores, K1 and K3 with their first
# CUDA bodies, K4 with one block per tile; printed on a line of their own,
# never in the kernels' line, which holds this run's numbers
PREVIOUS_MS = {"paged_attention": 0.0389, "flash_attention": 0.2287,
               "decode_attention": 0.1717, "matmul": 20.78,
               "stream_copy": 0.7588, "paged_attention_int8_drain": 0.0368}


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


def sass_phase(kbuild):
    """Tensor-core and bulk-copy instructions in each built kernel's machine
    code (from ``cuobjdump --dump-sass``): ``HGMMA`` is a warpgroup
    ``wgmma``, ``HMMA`` a warp ``mma.sync``, ``UBLKCP`` a TMA bulk copy
    (``cp.async.bulk``).  K8's bfloat16 route must issue ``wgmma``, K1's,
    K2's and K3's one or the other, and K4's bulk route bulk copies."""
    counts = {name: kbuild.sass_counts(name, ("HGMMA", "HMMA", "UBLKCP"))
              for name in kbuild.sources()}
    for name, c in counts.items():
        print(f"[sass] {name}: HGMMA={c['HGMMA']} HMMA={c['HMMA']} "
              f"UBLKCP={c['UBLKCP']}", flush=True)
    check(counts["matmul"]["HGMMA"] > 0,
          "matmul's machine code has no HGMMA (wgmma) instruction")
    for name in ("paged_attention", "flash_attention", "decode_attention"):
        check(counts[name]["HGMMA"] + counts[name]["HMMA"] > 0,
              f"{name}'s machine code has no HMMA or HGMMA instruction")
    check(counts["stream_copy"]["UBLKCP"] > 0,
          "stream_copy's machine code has no UBLKCP (cp.async.bulk) "
          "instruction")


# ---------------------------------------------------------------------------
# K1: paged_attention
# ---------------------------------------------------------------------------

# geometries K1 is timed at: gemma-2b's main path, and those of its other
# model paths (gemma2-27b's ring and global layers at batch 4 and 8192
# tokens; gemma-2b with int8 pages of 16 tokens)
GEMMA2_SCALE = 144.0 ** -0.5        # query_pre_attn_scalar 144
MAIN_GEOMETRY = dict(b=8, hq=8, hkv=1, d=256, page=8, n=128, int8=False,
                     kw={})
RING_GEOMETRY = dict(b=4, hq=32, hkv=16, d=128, page=8, n=513, int8=False,
                     kw=dict(window=4096, softcap=50.0, scale=GEMMA2_SCALE))
GLOBAL_GEOMETRY = dict(b=4, hq=32, hkv=16, d=128, page=8, n=1024,
                       int8=False,
                       kw=dict(softcap=50.0, scale=GEMMA2_SCALE))
INT8_GEOMETRY = dict(b=8, hq=8, hkv=1, d=256, page=16, n=64, int8=True,
                     kw={})
# the ring serve's decode lengths at its longest: the two prompts past the
# window and two short ones, 16 tokens decoded
RING_LENS = [4160 + 16, 5120 + 16, 300, 8000]


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


def k1_cases(drain):
    """(name, B, Hq, Hkv, D, page, N, valid lengths, kwargs); ``drain``
    holds the serve drain's ragged lengths (:func:`drain_lens`)."""
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
        # the main path's shape at a decode tick's lengths: short and empty
        # splits reach the split merge
        ("main-path-drain", 8, 8, 1, 256, 8, 128, drain, {}),
        # gemma2-27b's decode geometry: a local layer's ring table of
        # ring_slots pages and a global layer's full table, at 8192 tokens
        ("gemma2-27b-ring", 4, 32, 16, 128, 8, 513, RING_LENS,
         dict(window=4096, softcap=50.0, scale=GEMMA2_SCALE)),
        ("gemma2-27b-global", 4, 32, 16, 128, 8, 1024, RING_LENS[:3] + [8192],
         dict(softcap=50.0, scale=GEMMA2_SCALE)),
        # gemma-2b with int8 pages of 16 tokens at the drain's lengths (8
        # splits, a cluster merge)
        ("gemma-2b-int8", 8, 8, 1, 256, 16, 64, drain, dict(int8=True)),
        # int8 pages (bfloat16 q: the tensor cores) at D 64, 128 and 256,
        # GQA 8/2, pages of 8 and 16, softcap, a ring window, rows with no
        # token, a cluster merge of 4 splits, and one row over 4096 pages
        # of 8 (past the whole-table limit): 64 splits, the counter merge
        ("int8-d64-gqa", 3, 8, 2, 64, 8, 12, [3, 50, 96], dict(int8=True)),
        ("int8-d128-gqa-page16", 3, 8, 2, 128, 16, 6, [5, 50, 96],
         dict(int8=True)),
        ("int8-d256-gqa-page16", 3, 8, 2, 256, 16, 6, [7, 70, 96],
         dict(int8=True)),
        ("int8-softcap", 3, 8, 2, 128, 8, 12, [1, 40, 96],
         dict(int8=True, softcap=30.0)),
        ("int8-ring-window", 4, 8, 1, 256, 16, 4, [5, 30, 61, 200],
         dict(int8=True, window=40)),
        ("int8-empty-rows", 3, 8, 1, 256, 8, 16, [0, 0, 40],
         dict(int8=True)),
        ("int8-cluster-4", 4, 8, 2, 128, 16, 32, [100, 512, 300, 0],
         dict(int8=True)),
        ("int8-counter-64", 1, 8, 1, 256, 8, 4096, [30001],
         dict(int8=True)),
    ]


def k1_check(torch, pa, ref, drain):
    """Every case in both dtypes against the plain version; returns the
    largest absolute error seen."""
    from repro_torch.kernels import decode_core as core
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for name, b, hq, hkv, d, page, n, vlens, kw in k1_cases(drain):
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
            route = pa.route(q.dtype, kp.dtype, d)
            splits = pa.split_count(route, b, hkv, page, n, sms)
            cfg = pa.kernel_config(q.dtype, kp.dtype, d, page, n, splits)
            print(f"[K1] case={name} dtype={dname} B={b} Hq={hq} Hkv={hkv} "
                  f"D={d} page={page} N={n} pages="
                  f"{str(kp.dtype).replace('torch.', '')} config='{cfg}' "
                  f"splits={splits} merge={core.merge_kind(route, splits)} "
                  f"max_abs_err={err:.3e} tol={tol}{tight} ok={ok}",
                  flush=True)
            check(ok, f"K1 {name} {dname}: max_abs_err {err} over {tol}, "
                  "or more than one bfloat16 rounding from the float32 "
                  "plain version")
            worst = max(worst, err)
    return worst


def time_ms(torch, fn, sets, iters=50, warmup=5):
    """CUDA-event time per call, cycling through ``sets`` of inputs whose
    total exceeds the L2 cache, so every call reads device memory.  The
    card first spins about 1 ms per timed call, while the host enqueues
    them, so the events time the card's work and not the host's enqueueing
    (a wrapper's checks, a plan lookup, ctypes): as core/engines.py times
    the memory engines."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(COVER_CYCLES * iters)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def drain_lens(np):
    """The serve drain's ragged decode lengths: its first 8 prompts (the
    batch's first slots) plus 16 decoded tokens each."""
    from repro_torch.serve import Request
    reqs = make_requests(np, Request, 256000, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)
    return [r.prompt.shape[0] + 16 for r in reqs[:8]]


def k1_live_mask(torch, table, valid, page, window):
    """(B, N*page) bool: the rows a query reads, by the plain version's
    rule (ring slot j holds logical page ``cur - ((cur - j) mod N)``)."""
    b, n = table.shape
    vl = valid.long()
    j = torch.arange(n, device=table.device)[None, :]
    if window is None:
        base = (j * page).expand(b, n)
    else:
        cur = torch.clamp(vl - 1, min=0)[:, None] // page
        base = (cur - torch.remainder(cur - j, n)) * page
    pos = base[:, :, None] + torch.arange(page, device=table.device)
    live = (pos < vl[:, None, None]) & (pos >= 0)
    if window is not None:
        live &= pos > vl[:, None, None] - 1 - window
    return live.reshape(b, n * page)


def k1_time(torch, pa, ref, card, vlens, label, geometry=MAIN_GEOMETRY):
    """K1 at one geometry (bf16 q; bf16 or int8 pages) with the given
    lengths, beside its plain version, SDPA on the K/V gathered (and
    dequantized) out of the pages with a boolean mask of the live rows
    (SDPA then still reads every gathered row, where the kernel and the
    bound read only the live ones; it has no softcap, so at a softcap it
    is a yardstick of the same bytes) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_core as core
    g = geometry
    b, hq, hkv, d, page, n = (g[k] for k in ("b", "hq", "hkv", "d", "page",
                                             "n"))
    kw, int8 = g["kw"], g["int8"]
    window = kw.get("window")
    dtype = torch.bfloat16
    itemsize = 1 if int8 else 2
    live = [min(v, window) if window else v for v in vlens]
    kv_bytes = sum(live) * hkv * d * itemsize * 2 + (
        sum(live) * 4 * 2 if int8 else 0)
    copies = -(-3 * L2_BYTES // kv_bytes)
    gen = torch.Generator().manual_seed(1)
    q, pools, table, valid = k1_inputs(torch, gen, b, hq, hkv, d, page, n,
                                       vlens, dtype, int8, copies=copies)
    sets = [(q, kp, vp, table, valid, ks, vs) for kp, vp, ks, vs in pools]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kv_dtype = torch.int8 if int8 else dtype
    route = pa.route(q.dtype, kv_dtype, d)
    splits = pa.split_count(route, b, hkv, page, n, sms)
    cfg = pa.kernel_config(q.dtype, kv_dtype, d, page, n, splits)
    blocks = (pa.occupancy(d, cfg.warps, cfg.stages, page, n, splits,
                           kv_dtype)
              if route == "mma.sync" else None)

    def call(mod):
        return lambda qq, kp, vp, t, vl, ks, vs: mod.paged_attention(
            qq, kp, vp, t, vl, k_scale=ks, v_scale=vs, **kw)

    ms = time_ms(torch, call(pa), sets)
    plain_ms = time_ms(torch, call(ref), sets)
    # yardstick: one SDPA call over K/V already gathered out of the pages
    tbl = table.long()
    mask = k1_live_mask(torch, table, valid, page, window)
    full = bool(mask.all())

    def gathered(pool, scale):
        x = pool[tbl]
        if scale is not None:
            x = (x.float() * scale[tbl][..., None, None]).to(dtype)
        return x.reshape(b, n * page, hkv, d).transpose(1, 2).contiguous()

    lib_sets = [(q[:, :, None, :], gathered(kp, ks), gathered(vp, vs))
                for _, kp, vp, _, _, ks, vs in sets]
    amask = None if full else mask[:, None, None, :]
    library_ms = time_ms(torch, lambda qq, kk, vv:
                         F.scaled_dot_product_attention(
                             qq, kk, vv, attn_mask=amask, enable_gqa=True,
                             scale=kw.get("scale")),
                         lib_sets)
    # bound: each input read once (the live K/V rows and their scales,
    # their page ids, q, valid_len), the output written once (bytes), or
    # the q.k and p.v products at the bf16 peak (operations); the larger
    moved = (kv_bytes + 2 * q.numel() * 2
             + sum(-(-v // page) for v in live) * 4 + valid.numel() * 4)
    ops = 4 * sum(live) * hq * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    design = (f"{cfg} splits={splits} "
              f"merge={core.merge_kind(cfg.route, splits)}")
    extra = "".join(f" {k}={v:.6g}" if isinstance(v, float) else f" {k}={v}"
                    for k, v in kw.items())
    sdpa = ("SDPA, enable_gqa, gathered "
            + ("dequantized " if int8 else "") + "K/V"
            + ("" if full else f", bool mask: reads all {n * page} "
               "gathered tokens a row")
            + (", no softcap" if "softcap" in kw else ""))
    print(f"[K1 time] shape={label} B{b} Hq{hq} Hkv{hkv} D{d} page{page} "
          f"N{n} valid={vlens} q=bf16 pages="
          f"{'int8' if int8 else 'bf16'}{extra} design='{design}' "
          f"grid_blocks={b * hkv * splits} resident_blocks_per_sm={blocks} "
          f"pool_copies={copies} card='{card}' ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} ({sdpa}) "
          f"bound_ms={bound_ms:.4f} bound_by={bound_by} "
          f"moved_MB={moved / 1e6:.2f} ratio_to_library="
          f"{ms / library_ms:.2f} ratio_to_bound={ms / bound_ms:.2f} "
          f"achieved_GBps={moved / ms / 1e6:.1f}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, design=design)


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
            print(f"[K2] case={name} dtype={dname} route={fa.route(dtype)} "
                  f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
                  f"{kw or ''} max_abs_err={err:.3e} tol={tol}{tight} "
                  f"ok={ok}", flush=True)
            check(ok, f"K2 {name} {dname}: max_abs_err {err} over {tol}, "
                  "or more than one bfloat16 rounding from the float32 "
                  "plain version")
            worst = max(worst, err)
    # window 64 with Sq 300 > Skv 128: rows from 128 + 64 - 1 on see no key
    # and must be exactly 0; the rest hold the tolerance
    b, hq, hkv, sq, skv, d, window = 1, 8, 2, 300, 128, 128, 64
    first = skv + window - 1
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        q = torch.randn((b, hq, sq, d), generator=gen).to(dev, dtype)
        k, v = (torch.randn((b, hkv, skv, d), generator=gen).to(dev, dtype)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, window=window)
        nonzero = int(torch.count_nonzero(got[:, :, first:]))
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        tol = FLASH_TOL[dname]
        ok = nonzero == 0 and bool(((g - w).abs() <= tol + tol * w.abs()
                                    ).all())
        print(f"[K2] case=rows-without-a-key dtype={dname} "
              f"route={fa.route(dtype)} B={b} Hq={hq} Hkv={hkv} Sq={sq} "
              f"Skv={skv} D={d} window={window} rows_without_key={sq - first}"
              f" nonzero_in_them={nonzero} max_abs_err={err:.3e} tol={tol} "
              f"ok={ok}", flush=True)
        check(ok, f"K2 rows without a key {dname}: {nonzero} nonzero "
              f"values, or max_abs_err {err} over {tol}")
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
    route = fa.route(torch.bfloat16)
    blocks = fa.occupancy(d)
    print(f"[K2 time] shape=B{b} Hq{hq} Hkv{hkv} S{s} D{d} bf16 causal "
          f"route={route} design='{fa.DESIGN}' "
          f"resident_blocks_per_sm={blocks} grid_blocks={-(-s // 64) * hq * b}"
          f" input_copies={copies} card='{card}' ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} bound_by={bound_by} "
          f"achieved_TFLOPs={ops / ms / 1e9:.2f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                design=f"{route} {fa.DESIGN}", resident_blocks_per_sm=blocks)


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
        # the port's own kernels, by the names of their entry functions
        ours = {}
        for e in evs:
            for name in PORT_KERNELS:
                if name in e.key:
                    ms, n = ours.get(name, (0.0, 0))
                    ours[name] = (ms + e.self_device_time_total / 1e3,
                                  n + e.count)
        own = " ".join(f"{name}_ms={ms:.3f}x{n}"
                       for name, (ms, n) in sorted(ours.items()))
        lines.append(f"[profile] step='{label}' wall_ms={wall * 1e3:.3f} "
                     f"device_busy_ms={busy:.3f} "
                     f"device_busy_share={busy / (wall * 1e3):.3f} "
                     f"{own} top='{desc}'")
    return lines


def serve_phase(torch, np, card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg)
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 8, 1024)
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)

    def checks(run):
        check(eng.stats.prefix_hit_tokens > 0,
              f"serve {run}: no prefix hit on shared prompts")
        return ""

    launches, warm = serve_runs(torch, eng, reqs, "serve", card,
                                cfg.num_layers, pa, checks)
    for line in profile_window(torch, eng, reqs):
        print(line, flush=True)
    return launches, warm


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
    from repro_torch.serve import Request

    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    card_cpu_parity(
        torch, np, cfg, None,
        lambda: make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                              (0, 4), 8),
        "parity", "arch=gemma-2b full width, 2 layers, float32")


def dense_serve_phase(torch, np, card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tune.plan import next_pow2

    cfg = ARCHS["phi4-mini-3.8b"]
    n_attn = cfg.num_layers
    bundle, params = load_model(torch, cfg, RuntimeFlags(attn_impl="pallas"))
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
# ring pages, softcaps and int8 pages on model paths
# ---------------------------------------------------------------------------

def ring_requests(np, Request, vocab):
    """8 requests, 32 new tokens each: the first two prompts run past the
    4096-token window (4160 and 5120 tokens), the other six hold 64-512
    tokens, three of them sharing a 256-token prefix."""
    reqs = make_requests(np, Request, vocab, 0, 8, (64, 513), 256, (2, 5, 7),
                         32)
    rng = np.random.default_rng(5)
    for r, n in zip(reqs[:2], (4160, 5120)):
        more = rng.integers(0, vocab, size=n - r.prompt.shape[0])
        r.prompt = np.concatenate([r.prompt, more.astype(np.int32)])
    return reqs


def load_model(torch, cfg, flags=None, seed=0):
    """A bundle on the card and its random weights, drawn there from a
    seeded generator; prints the ``[model]`` line."""
    from repro_torch.models import build
    t0 = time.perf_counter()
    bundle = build(cfg, flags)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[model] arch={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.param_dtype} "
          f"kv_dtype={bundle.flags.kv_dtype} params={n_params} "
          f"param_GB={n_bytes / 1e9:.2f} "
          f"init_s={time.perf_counter() - t0:.2f}", flush=True)
    return bundle, params


def serve_runs(torch, eng, reqs, tag, card, n_attn, pa, extra_checks):
    """Drain ``reqs`` twice (first, warm) with K1's count set to 0 just
    before each drain and read just after; checks budgets, token range and
    K1 launches = layers x decode ticks, then ``extra_checks(run)``.
    Prints one ``[tag]`` line a run; returns the warm run's launches and
    its ms per decode tick and tokens per second."""
    cfg = eng.bundle.cfg
    launches = 0
    warm = {}
    for run in ("first", "warm"):
        torch.cuda.reset_peak_memory_stats()
        pa.reset_launches()
        dt = drain(torch, eng, reqs)
        launches = pa.LAUNCHES
        st = eng.stats
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              f"{tag} {run} drain: a request missed its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens), f"{tag} {run} drain: token out "
              "of range")
        check(launches == n_attn * st.decode_steps > 0,
              f"{tag} {run} drain: K1 launches {launches} != {n_attn} x "
              f"{st.decode_steps} decode ticks")
        extra = extra_checks(run)
        print(f"[{tag}] run={run} card='{card}' arch={cfg.name} "
              f"requests={len(reqs)} batch={eng.bsz} max_len={eng.max_len} "
              f"page={eng.page} prefill_chunk={eng.prefill_chunk} "
              f"kv_dtype={eng.kv_store_dtype} tokens_out={st.tokens_out} "
              f"seconds={dt:.3f} tok_s={st.tokens_out / dt:.1f} "
              f"decode_steps={st.decode_steps} "
              f"decode_dispatches={st.decode_dispatches} "
              f"ms_per_decode_tick={1e3 * eng.decode_s / st.decode_steps:.3f} "
              f"prefill_chunks={st.prefill_chunks} "
              f"ms_per_prefill_chunk="
              f"{1e3 * eng.prefill_s / st.prefill_chunks:.3f} "
              f"prompt_tokens={st.prompt_tokens} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"pages_peak={st.pages_peak} "
              f"ring_pages_peak={st.ring_pages_peak} "
              f"ring_pages_reused={st.ring_pages_reused} "
              f"k1_launches={launches} kv_pool_GiB="
              f"{eng.kv_bytes() / 2**30:.3f} "
              f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f"{extra}", flush=True)
        warm = dict(tick_ms=1e3 * eng.decode_s / st.decode_steps,
                    tok_s=st.tokens_out / dt)
    return launches, warm


def ring_serve_phase(torch, np, card):
    """Full-width gemma2-27b on the paged engine: K1 on the ring tables of
    the 23 local layers (window 4096) and the full tables of the 23 global
    ones, softcap 50 and scale 144^-0.5 on every decode tick."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_core as core
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["gemma2-27b"]
    bundle, params = load_model(torch, cfg)
    # 256-token prefill chunks keep the two long prompts at 37 chunks
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 4, 8192,
                                                 prefill_chunk=256)
    reqs = ring_requests(np, Request, cfg.vocab_size)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = pa.route(torch.bfloat16, torch.bfloat16, cfg.resolved_head_dim)
    split_desc = []
    for kind, n in (("global", eng.pages_per_seq), ("ring", eng.ring_slots)):
        splits = pa.split_count(route, eng.bsz, cfg.num_kv_heads, eng.page,
                                n, sms)
        split_desc.append(f"{kind}: N={n} splits={splits} merge="
                          f"{core.merge_kind(route, splits)}")
    print(f"[ring serve] pools: full {eng.num_pages} pages, ring "
          f"{eng.num_ring_pages} pages (ring_slots={eng.ring_slots}, "
          f"window={eng.attn_window}) of {eng.page} tokens, "
          f"{eng.kv_bytes() / 2**30:.3f} GiB beside "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"K1 route={route}; at the longest length ({eng.max_len} tokens) "
          f"{'; '.join(split_desc)}", flush=True)

    def checks(run):
        st = eng.stats
        check(st.ring_pages_reused > 0, f"ring serve {run}: the ring never "
              "turned (no ring page reused)")
        check(st.ring_pages_peak <= eng.bsz * eng.ring_slots,
              f"ring serve {run}: ring_pages_peak {st.ring_pages_peak} > "
              f"batch x ring_slots {eng.bsz * eng.ring_slots}")
        # as in the reference, prefix pages are shared only where every
        # layer reads them; a ring rotates prefix tokens away
        check(eng.prefix is None and st.prefix_hit_tokens == 0,
              f"ring serve {run}: prefix sharing on a windowed stack")
        return (f" ring_bound={eng.bsz * eng.ring_slots} "
                f"prefix_sharing=off (windowed stack, as in the reference)")

    launches, _ = serve_runs(torch, eng, reqs, "ring serve", card,
                             cfg.num_layers, pa, checks)
    for line in profile_window(torch, eng, reqs):
        print(line.replace("[profile]", "[profile] arch=gemma2-27b"),
              flush=True)
    return launches


def int8_serve_phase(torch, np, card):
    """Full-width gemma-2b with int8 KV pages: K1's int8 route on every
    decode tick, the serve phase's 16 requests."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tune import derive_paged_plan

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg, RuntimeFlags(kv_dtype="int8"))
    bf16_page = derive_paged_plan(max_len=1024,
                                  head_dim=cfg.resolved_head_dim,
                                  dtype=cfg.compute_dtype).page_size
    int8_page = derive_paged_plan(max_len=1024,
                                  head_dim=cfg.resolved_head_dim,
                                  dtype="int8").page_size
    # the page that holds the bf16 page's bytes: twice its tokens (the
    # derived rule's 8-token floor gives both dtypes 8 at D 256)
    page = 2 * bf16_page
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 8, 1024,
                                                 page_size=page)
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = pa.route(torch.bfloat16, torch.int8, cfg.resolved_head_dim)
    splits = pa.split_count(route, eng.bsz, cfg.num_kv_heads, page,
                            eng.pages_per_seq, sms)
    kcfg = pa.kernel_config(torch.bfloat16, torch.int8,
                            cfg.resolved_head_dim, page, eng.pages_per_seq,
                            splits)
    check(route == "mma.sync" and kcfg.pages == "int8",
          f"int8 pages with bf16 q on route {route} ({kcfg})")
    check(eng.page == 2 * bf16_page, "int8 page is not twice the bf16 one")

    def checks(run):
        check(eng.stats.prefix_hit_tokens > 0,
              f"int8 serve {run}: no prefix hit on shared prompts")
        scales = eng.cache["blocks"]["p0"]["k_scale"]
        check(scales.dtype == torch.float32
              and tuple(scales.shape[1:]) == (eng.num_pages, eng.page),
              f"int8 serve: scale lanes {scales.dtype} "
              f"{tuple(scales.shape)}")
        return (f" route=int8 ({route}) config='{kcfg}' splits={splits} "
                f"page_tokens={eng.page} "
                f"bf16_page_tokens={bf16_page} derived_int8_page={int8_page}")

    launches, _ = serve_runs(torch, eng, reqs, "int8 serve", card,
                             cfg.num_layers, pa, checks)
    for line in profile_window(torch, eng, reqs, steps=(
            ("decode window", _prepare_decode),)):
        print(line.replace("[profile]", "[profile] arch=gemma-2b kv=int8"),
              flush=True)
    return launches


def card_cpu_parity(torch, np, cfg, flags, reqs_of, tag, desc,
                    sampling=None):
    """The same float32 weights (drawn on the card, copied to the CPU)
    drain the same requests on the card (K1) and on the CPU (the plain
    path); tokens must agree (greedy, or drawn with ``sampling`` from keys
    seeded with 3, whose final values must agree too), every card tick
    must launch K1 once a layer, and a windowed stack's ring must turn on
    both."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_bundle = build(cfg, flags, device="cuda")
    card_params = card_bundle.init(
        torch.Generator(device="cuda").manual_seed(1))
    outs, reused, keys = {}, {}, {}
    for dev in ("cuda", "cpu"):
        bundle = card_bundle if dev == "cuda" else build(cfg, flags,
                                                         device="cpu")
        p = card_params if dev == "cuda" else _to(card_params, "cpu")
        eng = ServeEngine(bundle, p, 4, 128, sampling=sampling, seed=3,
                          device=dev)
        reqs = reqs_of()
        pa.reset_launches()
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion()
        outs[dev] = [r.out_tokens for r in reqs]
        reused[dev] = eng.stats.ring_pages_reused
        keys[dev] = eng.keys.cpu()
        if dev == "cuda":
            check(pa.LAUNCHES == cfg.num_layers * eng.stats.decode_steps > 0,
                  f"{tag}: the drain on the card did not run K1 every tick")
        check(all(len(t) == r.max_new_tokens for t, r in zip(outs[dev],
                                                               reqs)),
              f"{tag} {dev}: budget missed")
        del eng, p
    if any(s.sliding_window for s in cfg.layer_pattern):
        check(reused["cuda"] > 0 and reused["cpu"] > 0,
              f"{tag}: the ring never turned")
    same = outs["cpu"] == outs["cuda"]
    same_keys = bool(torch.equal(keys["cpu"], keys["cuda"]))
    print(f"[{tag}] {desc} requests={len(outs['cpu'])} "
          f"ring_pages_reused={reused['cuda']} cuda_equals_cpu={same} "
          f"keys_equal={same_keys}", flush=True)
    check(same, f"{tag}: tokens differ: cpu {outs['cpu']} cuda "
          f"{outs['cuda']}")
    check(same_keys, f"{tag}: final keys differ: cpu {keys['cpu']} cuda "
          f"{keys['cuda']}")
    if sampling is not None and not sampling.greedy:
        check(bool(keys["cpu"].any()), f"{tag}: the sampled drain left "
              "every key zero")


def ring_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, LayerSpec, override
    from repro_torch.serve import Request

    # gemma2-27b's (local, global) pair at its published widths; the window
    # is narrowed from 4096 to 32 so the ring turns within a short drain
    cfg = override(ARCHS["gemma2-27b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32",
                   layer_pattern=(LayerSpec(sliding_window=32), LayerSpec()))
    card_cpu_parity(
        torch, np, cfg, None,
        lambda: make_requests(np, Request, cfg.vocab_size, 2, 6, (20, 72),
                              17, (0, 4), 8),
        "ring parity", "arch=gemma2-27b (local, global) pair, full width, "
        "float32, window narrowed 4096->32, softcap 50, scale 144^-0.5")


def int8_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, override
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import Request

    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    card_cpu_parity(
        torch, np, cfg, RuntimeFlags(kv_dtype="int8"),
        lambda: make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                              (0, 4), 8),
        "int8 parity", "arch=gemma-2b full width, 2 layers, float32, int8 KV")


# ---------------------------------------------------------------------------
# sampling and speculative decoding
# ---------------------------------------------------------------------------

# the sampled phases' settings, both with keys seeded by 3
SAMPLINGS = (dict(temperature=0.9, top_p=0.95),
             dict(temperature=0.8, top_k=50))
VOCAB = 256000                    # gemma-2b's


def _desc(params):
    return ",".join(f"{k}={v}" for k, v in params.items())


def prng_phase(torch, np, card):
    """Threefry keys and bits, ``split``, ``fold_in`` and ``subkey_chain``
    at (8, 256000) on the card exactly equal to the CPU's; ``uniform``
    exactly, ``gumbel`` within 2 ulp (counted at max(|g|, 1)); then the
    sampler at gemma-2b's vocab for both settings: top-k masks exactly
    equal, top-p masks' differing entries counted, draws equal.  Times
    (CUDA events behind a spin) of the bits and of one sampled draw."""
    from repro_torch.serve import prng
    from repro_torch.serve.sampling import (SamplingParams, mask_logits,
                                            sample_tokens, subkey_chain)

    keys = prng.split(prng.prng_key(3), 8)
    ck = keys.cuda()
    exact = {
        "bits": lambda k: prng.random_bits(k, (VOCAB,)),
        "split": lambda k: prng.split(k, 2),
        "fold_in": lambda k: prng.fold_in(k, 12345),
        "subkey_chain": lambda k: torch.cat(subkey_chain(k, 4), dim=1),
        "uniform": lambda k: prng.uniform(k, (VOCAB,)).view(torch.int32)}
    for name, fn in exact.items():
        check(torch.equal(fn(ck).cpu(), fn(keys)),
              f"[prng] {name} at (8, {VOCAB}): card != cpu")
    g_card = prng.gumbel(ck, (VOCAB,)).cpu().double()
    g_cpu = prng.gumbel(keys, (VOCAB,)).double()
    unit = torch.clamp(g_cpu.abs(), min=1.0) * 2.0 ** -23
    ulp = float(((g_card - g_cpu).abs() / unit).max())
    check(ulp <= 2.0, f"[prng] gumbel: card {ulp} ulp from cpu")
    bits_ms = time_ms(torch, lambda k: prng.random_bits(k, (VOCAB,)),
                      [(ck,)], iters=10, warmup=2)
    print(f"[prng] card='{card}' shape=(8, {VOCAB}) "
          f"{'/'.join(exact)}_card_equals_cpu=True gumbel_max_ulp={ulp:.2f} "
          f"bits_ms={bits_ms:.4f}", flush=True)
    logits = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (8, VOCAB)) * 4).astype(np.float32))
    cl = logits.cuda()
    for params in SAMPLINGS:
        sp = SamplingParams(**params)
        m_card = mask_logits(cl, sp).cpu()
        m_cpu = mask_logits(logits, sp)
        differ = int((m_card.view(torch.int32)
                      != m_cpu.view(torch.int32)).sum())
        if sp.top_p == 1.0:
            check(differ == 0, f"[prng] {_desc(params)}: top-k masks differ "
                  f"in {differ} entries")
        same = torch.equal(sample_tokens(ck, cl, sp).cpu(),
                           sample_tokens(keys, logits, sp))
        check(same, f"[prng] {_desc(params)}: card draws != cpu draws")
        ms = time_ms(torch, lambda k, l: sample_tokens(k, l, sp),
                     [(ck, cl)], iters=10, warmup=2)
        kept = int((m_cpu > -1e29).sum())
        print(f"[prng] sampler {_desc(params)} shape=(8, {VOCAB}) "
              f"kept={kept} mask_entries_differing={differ} "
              f"draws_card_equal_cpu={same} sample_ms={ms:.4f}", flush=True)


def sampled_serve_phase(torch, np, card, greedy):
    """Full-width gemma-2b (bf16) through the paged engine with sampling:
    the serve phase's 16 requests for each setting, then the first setting
    on int8 pages of 16 tokens; each drained twice with identical tokens,
    K1 once a layer on every tick, the warm tick beside the greedy one."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg)
    int8 = build(cfg, RuntimeFlags(kv_dtype="int8"))
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)
    launches = {}
    runs = [(b, p, {}, "bf16") for b, p in ((bundle, SAMPLINGS[0]),
                                            (bundle, SAMPLINGS[1]))]
    runs.append((int8, SAMPLINGS[0], dict(page_size=16), "int8"))
    for b, sp, kw, kv in runs:
        eng = timed_engine_class(torch, ServeEngine)(
            b, params, 8, 1024, sampling=SamplingParams(**sp), seed=3, **kw)
        toks = {}

        def checks(run, eng=eng, toks=toks, sp=sp):
            toks[run] = [list(r.out_tokens) for r in reqs]
            check(bool(eng.keys.any()), "sampled serve: no key was set")
            return (f" sampling='{_desc(sp)}' seed=3 "
                    f"greedy_ms_per_decode_tick={greedy['tick_ms']:.3f} "
                    f"greedy_tok_s={greedy['tok_s']:.1f}")

        n, warm = serve_runs(torch, eng, reqs, "sampled serve", card,
                             cfg.num_layers, pa, checks)
        check(toks["first"] == toks["warm"], f"sampled serve {_desc(sp)} "
              f"{kv}: two drains gave different tokens")
        launches[f"sampled serve {kv} {_desc(sp)}"] = n
        print(f"[sampled serve] kv={kv} sampling='{_desc(sp)}' "
              f"first_equals_warm=True warm_ms_per_decode_tick="
              f"{warm['tick_ms']:.3f} greedy_ms_per_decode_tick="
              f"{greedy['tick_ms']:.3f} ratio="
              f"{warm['tick_ms'] / greedy['tick_ms']:.3f} warm_tok_s="
              f"{warm['tok_s']:.1f} greedy_tok_s={greedy['tok_s']:.1f}",
              flush=True)
        del eng
    return launches


def sampled_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, override
    from repro_torch.serve import Request
    from repro_torch.serve.sampling import SamplingParams

    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    card_cpu_parity(
        torch, np, cfg, None,
        lambda: make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                              (0, 4), 8),
        "sampled parity", "arch=gemma-2b full width, 2 layers, float32, "
        f"sampling='{_desc(SAMPLINGS[0])}' seed=3",
        sampling=SamplingParams(**SAMPLINGS[0]))


def spec_serve_phase(torch, np, card):
    """Full-width gemma-2b in float32 (the verify pass and K1 round
    differently in bf16, so only float32 can hold speculative tokens to
    vanilla ones bit for bit; TF32 is off): the serve phase's first 8
    requests (one batch) through the vanilla engine and speculative ones
    with ``spec_k`` 3, greedy and sampled, drafting with the target itself
    (every proposal accepted) and with weights from another seed (sampled,
    it rejects proposals, so ``truncate`` rolls reservations back; greedy
    random-weight models mostly repeat their input token and agree).
    Tokens must equal vanilla, the pools conserve pages, and the
    self-draft's accept rate is 1.0.  The draft's whole-prompt prefill
    runs K2 (``attn_impl="pallas"``); the target's paged prefill and
    verify gather pages as the reference does."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = override(ARCHS["gemma-2b"], param_dtype="float32",
                   compute_dtype="float32")
    bundle, params = load_model(torch, cfg, RuntimeFlags(attn_impl="pallas"))
    _, other = load_model(torch, cfg, seed=5)
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)[:8]
    timed = timed_engine_class(torch, ServeEngine)
    for label, sp in (("greedy", {}), ("sampled", SAMPLINGS[0])):
        sampling = SamplingParams(**sp)
        vanilla = timed(bundle, params, 8, 1024, sampling=sampling, seed=3)
        pa.reset_launches()
        dt = drain(torch, vanilla, reqs)
        want = [list(r.out_tokens) for r in reqs]
        vst = vanilla.stats
        check(pa.LAUNCHES == cfg.num_layers * vst.decode_steps > 0,
              f"spec serve vanilla {label}: K1 did not run every tick")
        print(f"[spec serve] card='{card}' engine=vanilla sampling="
              f"'{label}' tokens_out={vst.tokens_out} seconds={dt:.3f} "
              f"decode_steps={vst.decode_steps} ms_per_decode_tick="
              f"{1e3 * vanilla.decode_s / vst.decode_steps:.3f} "
              f"k1_launches={pa.LAUNCHES}", flush=True)
        del vanilla
        for draft, dparams in (("self", params), ("seed-5", other)):
            eng = timed(bundle, params, 8, 1024, sampling=sampling, seed=3,
                        draft_bundle=bundle, draft_params=dparams, spec_k=3)
            pa.reset_launches()
            fa.reset_launches()
            dt = drain(torch, eng, reqs)
            got = [list(r.out_tokens) for r in reqs]
            st, a = eng.stats, eng.alloc
            check(got == want, f"spec serve {label} draft={draft}: tokens "
                  "differ from vanilla")
            check(st.spec_steps > 0 and st.draft_tokens > 0,
                  f"spec serve {label} draft={draft}: no speculative round")
            check(fa.LAUNCHES == cfg.num_layers * st.prefills,
                  f"spec serve {label} draft={draft}: K2 launches "
                  f"{fa.LAUNCHES} != {cfg.num_layers} x {st.prefills} "
                  "draft prefills")
            if draft == "self":
                check(st.accept_rate == 1.0, f"spec serve {label}: the "
                      f"self-draft accepted {st.accept_rate}")
            elif label == "sampled":
                check(st.draft_accepted < st.draft_tokens,
                      f"spec serve {label} draft={draft}: no proposal was "
                      "rejected, so no rollback ran")
            check(not a.tables and a.pages_in_use + len(a.free)
                  == a.num_pages - a.reserved
                  and all(r >= 1 for r in a.ref.values()),
                  f"spec serve {label} draft={draft}: pages not conserved")
            print(f"[spec serve] card='{card}' engine=spec draft={draft} "
                  f"spec_k={eng.spec_k} sampling='{label}' "
                  f"tokens_equal_vanilla=True tokens_out={st.tokens_out} "
                  f"seconds={dt:.3f} spec_steps={st.spec_steps} "
                  f"draft_tokens={st.draft_tokens} "
                  f"draft_accepted={st.draft_accepted} "
                  f"rejected={st.draft_tokens - st.draft_accepted} "
                  f"accept_rate={st.accept_rate:.4f} "
                  f"accepted_per_step={st.accepted_per_step:.3f} "
                  f"ms_per_round={1e3 * eng.decode_s / st.spec_steps:.3f} "
                  f"ms_per_prefill_chunk="
                  f"{1e3 * eng.prefill_s / st.prefill_chunks:.3f} "
                  f"(draft prefills included) pages_conserved=True "
                  f"k1_launches={pa.LAUNCHES} k2_launches={fa.LAUNCHES}",
                  flush=True)
            del eng


BENCH_SWEEPS = ("serve", "kernel_plan", "paged_serve", "spec_serve")


def bench_serve_phase(torch, card):
    """The serving sweeps at card scale twice in one call, then the
    comparator between the two runs: every row and verdict printed; the
    structural gate (deterministic rows identical, no vanished metric)
    must pass; wall-clock verdicts are advisory."""
    from repro_torch.bench import compare, run_sweeps

    out = os.path.join(ROOT, "build", "bench_serve")
    paths = []
    for i in (1, 2):
        print(f"[bench serve] run={i} card='{card}' sweeps="
              f"{','.join(BENCH_SWEEPS)} scale=card", flush=True)
        t0 = time.perf_counter()
        run = run_sweeps(names=BENCH_SWEEPS, fast=False, out_dir=out,
                         device="cuda")
        check(not run.failures, f"bench serve run {i}: sweeps failed "
              f"{sorted(run.failures)}: {run.failures}")
        paths.append(run.env["path"])
        det = {r.name: r.gbps_measured for r in run.results
               if r.extras.get("deterministic")}
        print(f"[bench serve] run={i} rows={len(run.results)} "
              f"seconds={time.perf_counter() - t0:.2f} deterministic={det} "
              f"path={os.path.relpath(paths[-1], ROOT)}", flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print("[bench serve] compare gate=all (wall-clock verdicts advisory):",
          flush=True)
    rc_all = compare.main(paths)
    print("[bench serve] compare gate=structural:", flush=True)
    rc = compare.main(paths + ["--gate", "structural"])
    print(f"[bench serve] compare exit gate=all={rc_all} (advisory) "
          f"gate=structural={rc}", flush=True)
    check(rc == 0, "compare --gate structural failed between two runs of "
          "the same code")


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


# (case, shape, block_rows, block_cols, view): the view is the array
# itself, "offset" (a contiguous view one element into a buffer) or
# "split" (its rows // 32-row parts, one call each, as num_kernels runs;
# in float32 each part has more bulk requests than its grid, so every
# launch hands out requests from the counter)
K4_CASES = [
    ("whole-rows", (128, 128), 8, 0, None),
    ("whole-rows", (256, 512), 64, 0, None),
    ("narrow", (64, 384), 8, 128, None),
    ("rows-of-7", (96, 7), 32, 0, None),
    ("1mib-tile", (4096, 1024), 256, 0, None),
    ("tile-over-ring", (600, 1040), 300, 0, None),
    ("narrow-over-stage", (32, 12288), 4, 6144, None),
    ("offset-base", (64, 256), 16, 0, "offset"),
    ("split-32", (49152, 1024), 256, 0, "split"),
]


def k4_array(torch, gen, shape, dtype, view):
    rows, cols = shape
    n = rows * cols + (view == "offset")
    if dtype == torch.int8:
        flat = torch.randint(-128, 128, (n,), generator=gen,
                             dtype=torch.int8)
    else:
        flat = (torch.randn(n, generator=gen) * 40).to(dtype)
    return flat.to("cuda")[n - rows * cols:].view(rows, cols)


def k4_check(torch, ops, ref, sc):
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for case, shape, br, bc, view in K4_CASES:
            x = k4_array(torch, gen, shape, dtype, view)
            parts = x.split(shape[0] // 32) if view == "split" else [x]
            routes = sorted({sc.config(p, br, bc).route for p in parts})
            if view == "split" and dtype == torch.float32:
                check(all(sc.config(p, br, bc).requests
                          > sc.config(p, br, bc).grid for p in parts),
                      f"K4 case={case}: a part takes no ticket from the "
                      f"counter")
            for mode in ("copy", "rw"):
                got = torch.cat([ops.stream_copy(p, block_rows=br,
                                                 block_cols=bc, mode=mode)
                                 for p in parts])
                worst = max(worst, exact(
                    torch, "K4", f"case={case} dtype={str(dtype)[6:]} "
                    f"shape={shape} tile=({br},{bc}) calls={len(parts)} "
                    f"base_offset={x.data_ptr() % 16} mode={mode} "
                    f"route={','.join(routes)}", got,
                    ref.stream_copy(x, mode)))
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


def k4_time(torch, ops, ref, sc, engines, card):
    """K4 at the memory phase's 1 GiB float32 array: 1 MiB and 8 KiB tiles
    copied, 1 MiB tiles doubled, each beside its plain version and one
    PyTorch call.  Returns the 1 MiB copy's numbers."""
    x = torch.randn((1 << 18, 1024), device="cuda")
    out = torch.empty_like(x)
    moved = 2 * x.numel() * 4
    cases = (("1 MiB copy", 256, "copy", "Tensor.copy_",
              lambda a: out.copy_(a)),
             ("8 KiB copy", 2, "copy", "Tensor.copy_",
              lambda a: out.copy_(a)),
             ("1 MiB rw", 256, "rw", "torch.mul(a, 2, out=out)",
              lambda a: torch.mul(a, 2, out=out)))
    timed = []
    for label, br, mode, library, lib_fn in cases:
        cfg = sc.config(x, br)
        exact(torch, "K4", f"case={label} dtype=float32 shape=(262144, "
              f"1024) tile=({br},1024) mode={mode} route={cfg.route} "
              f"(timed shape)", ops.stream_copy(x, block_rows=br, mode=mode),
              ref.stream_copy(x, mode))
        ms = best_ms(torch, engines, lambda a: ops.stream_copy(
            a, block_rows=br, mode=mode), x)
        plain_ms = best_ms(torch, engines, lambda a: ref.stream_copy(a, mode),
                           x)
        library_ms = best_ms(torch, engines, lib_fn, x)
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound(moved), bound_by="bytes", design=str(cfg))
        print(f"[K4 time] {label} shape=262144x1024 float32 tile={br} rows "
              f"({br * 4} KiB) mode={mode} route={cfg.route} "
              f"config='{cfg}' card='{card}' ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"({library}) ratio={ms / library_ms:.3f} "
              f"bound_ms={t['bound_ms']:.4f} bound_by=bytes "
              f"share_of_bound={t['bound_ms'] / ms:.3f} "
              f"achieved_GBps={moved / ms / 1e6:.1f}", flush=True)
        timed.append(t)
    return timed[0]


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
    from repro_torch.core.memmodel import H100
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
    # the bound of a chain of dependent loads is latency: hops x one HBM
    # load's latency (H100.latency_s, which this chase measured in the
    # memory phase, so the chase sits near 100% of it by construction).
    # It is a constant, not this run's measurement, so it stays on this
    # line; the kernels' JSON keeps the bytes bound, steps x (one 32-byte
    # sector read + 4 bytes of trace written)
    latency_ms = 1e3 * steps * H100.latency_s
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
             bound_ms=bound(steps * (32 + 4)), bound_by="bytes")
    ns = " ".join(f"ns_per_hop_{lvl}={levels[lvl] * 1e6 / steps:.1f}"
                  for lvl, _ in K7_LEVELS)
    print(f"[K7 time] steps={steps} chains=1 levels=L1 16 KiB, L2 16 MiB, "
          f"HBM 256 MiB card='{card}' {ns} ms={ms:.4f} (HBM) "
          f"plain_ms={plain_ms:.4f} library_ms=null (no single torch call "
          f"chases pointers) latency_bound_ms={latency_ms:.4f} (hops x "
          f"{H100.latency_s * 1e9:.0f} ns, measured by this chase) "
          f"share_of_latency_bound={latency_ms / ms:.3f} "
          f"bytes_bound_ms={t['bound_ms']:.6f} (the JSON's bound_ms)",
          flush=True)
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
    """Fits the memory model to the memory phase's rows; returns the fit."""
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
    return cal


# ---------------------------------------------------------------------------
# the tune -> plan -> execute loop: K3 (decode_attention), K8 (matmul)
# ---------------------------------------------------------------------------

DECODE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
MATMUL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K3 on the dense-decode geometry of the two served models
K3_GEOMETRIES = (("phi4-mini", 24, 8, 128), ("gemma-2b", 8, 1, 256))
K3_T = 1024
K8_SHAPES = ((4096, 4096, 4096), (8, 8192, 3072))       # (M, N, K)


def close_report(torch, got, want, tol, w32=None, acc_bound=None):
    """(ok, max_abs_err, text): within ``tol`` (absolute + relative) of the
    plain version; bfloat16 outputs also within one bfloat16 rounding of
    the float32 plain version ``w32`` (plus ``acc_bound``, the float32
    summation-order bound where one is given)."""
    g, w = got.float(), want.float()
    ok = bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= tol + tol * w.abs()).all())
    err = float((g - w).abs().max())
    text = f"max_abs_err={err:.3e} tol={tol}"
    if w32 is not None:
        lim = TOL["float32"] + BF16_ROUNDING * w32.abs()
        if acc_bound is not None:
            lim = lim + acc_bound
        err32 = float((g - w32).abs().max())
        ok32 = bool(((g - w32).abs() <= lim).all())
        text += (f" err_vs_f32_plain={err32:.3e} tol_f32_plus_one_rounding="
                 f"1e-4+2^-8*|w|{'+2K*2^-24*(|x|@|y|)' if acc_bound is not None else ''}"
                 f" ok_f32_plain={ok32}")
        ok = ok and ok32
    return ok, err, text


def matmul_acc_bound(torch, x, y):
    """Twice the float32 bound on a K-term sum taken in another order:
    2 * K * 2^-24 * (|x| @ |y|)."""
    return 2 * x.shape[1] * 2.0 ** -24 * (x.float().abs() @ y.float().abs())


def k3_inputs(torch, gen, b, hq, hkv, d, t, vlens, dtype):
    dev = torch.device("cuda")
    q = torch.randn((b, hq, d), generator=gen).to(dev, dtype)
    k, v = (torch.randn((b, t, hkv, d), generator=gen).to(dev, dtype)
            for _ in range(2))
    return q, k, v, torch.tensor(vlens, dtype=torch.int32, device=dev)


def k3_holds(torch, ref, tag, desc, got, q, k, v, vl, **kw):
    """Checks one K3 output against the plain version; returns the error."""
    torch.cuda.synchronize()
    want = ref.decode_attention(q, k, v, vl, **kw)
    dname = str(q.dtype)[6:]
    w32 = (ref.decode_attention(q.float(), k.float(), v.float(), vl, **kw)
           if dname == "bfloat16" else None)
    ok, err, text = close_report(torch, got, want, DECODE_TOL[dname], w32)
    print(f"[{tag}] {desc} dtype={dname} {text} ok={ok}", flush=True)
    check(ok, f"{tag} {desc} {dname}: {text}")
    return err


def k8_holds(torch, ref, tag, desc, got, x, y, tight=False):
    """Checks one K8 output against the plain version (TF32 off)."""
    torch.cuda.synchronize()
    want = ref.matmul(x, y)
    dname = str(x.dtype)[6:]
    w32 = acc = None
    if dname == "bfloat16":
        w32 = ref.matmul(x.float(), y.float())
        acc = matmul_acc_bound(torch, x, y) if tight else None
    ok, err, text = close_report(torch, got, want, MATMUL_TOL[dname], w32,
                                 acc)
    print(f"[{tag}] {desc} dtype={dname} {text} ok={ok}", flush=True)
    check(ok, f"{tag} {desc} {dname}: {text}")
    return err


def tune_phase(torch, cal, card):
    """K3 and K8 with tiles left to plans derived under the H100's spec and
    under the calibrated one: the slice's main path.  Returns the launches
    of each kernel in it and the analytic plans."""
    from repro_torch.core.memmodel import H100
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref
    from repro_torch.tune import (PlanCache, plan_key, set_default_cache,
                                  spec_fingerprint)
    torch.backends.cuda.matmul.allow_tf32 = False
    fps = {"analytic": spec_fingerprint(H100),
           "calibrated": spec_fingerprint(cal.spec)}
    check(fps["analytic"] != fps["calibrated"],
          "the calibrated spec fingerprints like the analytic one")
    gen = torch.Generator().manual_seed(15)
    vlens = [K3_T, K3_T - 24, 517, 1, K3_T, 800, K3_T, 64]
    k3 = {name: k3_inputs(torch, gen, 8, hq, hkv, d, K3_T, vlens,
                          torch.bfloat16)
          for name, hq, hkv, d in K3_GEOMETRIES}
    k8 = {shape: (torch.randn((shape[0], shape[2]), generator=gen)
                  .to("cuda", torch.bfloat16),
                  torch.randn((shape[2], shape[1]), generator=gen)
                  .to("cuda", torch.bfloat16)) for shape in K8_SHAPES}
    caches = {"analytic": PlanCache(None), "calibrated": PlanCache(None)}
    plans, outs = {}, {}
    da.reset_launches()
    mm.reset_launches()
    try:
        for source, cache in caches.items():
            set_default_cache(cache)
            for name, hq, hkv, d in K3_GEOMETRIES:
                q, k, v, vl = k3[name]
                if source == "analytic":      # plan_for through ops
                    outs[source, name] = ops.decode_attention(q, k, v, vl)
                    plan = cache.get(plan_key("decode_attention", (K3_T, d),
                                              "bfloat16", H100))
                else:
                    plan = cache.get_or_derive(
                        "decode_attention", shape_sig=(K3_T, d),
                        dtype="bfloat16", calibration=cal)
                    outs[source, name] = ops.decode_attention(q, k, v, vl,
                                                              plan=plan)
                plans[source, name] = plan
            for shape in K8_SHAPES:
                x, y = k8[shape]
                if source == "analytic":
                    outs[source, shape] = ops.matmul(x, y)
                    plan = cache.get(plan_key("matmul", shape, "bfloat16",
                                              H100))
                else:
                    plan = cache.get_or_derive(
                        "matmul", shape_sig=shape, dtype="bfloat16",
                        calibration=cal)
                    outs[source, shape] = ops.matmul(x, y, plan=plan)
                plans[source, shape] = plan
        torch.cuda.synchronize()
    finally:
        set_default_cache(None)
    launches = {"decode_attention": da.LAUNCHES, "matmul": mm.LAUNCHES}
    check(launches == {"decode_attention": 4, "matmul": 4},
          f"the loop launched {launches}, not K3 and K8 four times each")
    for (source, key), plan in plans.items():
        check(plan is not None and plan.source == source,
              f"no {source} plan for {key}")
        if key in k3:
            q, k, v, vl = k3[key]
            run = da.tiles(q, k, plan.bkv, plan.pipeline_depth)
            desc = (f"kernel=decode_attention geometry={key} "
                    f"shape_sig={K3_T}x{q.shape[-1]} bkv={plan.bkv} "
                    f"pipeline_depth={plan.pipeline_depth} "
                    f"kernel_config='{run['config']}' "
                    f"splits={run['splits']}")
            err = k3_holds(torch, ref, "tune", f"source={source} {desc}",
                              outs[source, key], q, k, v, vl)
        else:
            x, y = k8[key]
            bm, bn, bk = ops.matmul_tiles(x, y, plan=plan)
            desc = (f"kernel=matmul MxNxK={'x'.join(map(str, key))} "
                    f"tile={plan.bq} plan_tiles=({bm},{bn},{bk}) "
                    f"kernel_config='{mm.configuration(x, y, bm, bn, bk)}'")
            err = k8_holds(torch, ref, "tune", f"source={source} {desc}",
                              outs[source, key], x, y, tight=True)
        print(f"[tune] plan source={plan.source} {desc} "
              f"predicted_gbps={plan.predicted_gbps:.1f} "
              f"fingerprint={fps[source]} max_abs_err={err:.3e}",
              flush=True)
    print(f"[tune] card='{card}' fingerprints analytic={fps['analytic']} "
          f"calibrated={fps['calibrated']} calibrated_spec: latency_ns="
          f"{cal.spec.latency_s * 1e9:.1f} hbm_GBps={cal.spec.hbm_bw / 1e9:.1f}"
          f" launches={launches}", flush=True)
    return launches, {key: p for (src, key), p in plans.items()
                      if src == "analytic"}


def k3_cases():
    """(name, Hq, Hkv, D, T, bkv — None is the plan's —, kwargs)."""
    cases = []
    for name, hq, hkv, d in K3_GEOMETRIES + (("ref-4/2", 4, 2, 64),):
        for t in (100, 255, 256):
            for bkv in (32, 96, 256, None):
                cases.append((name, hq, hkv, d, t, bkv, {}))
    cases.append(("softcap-10", 24, 8, 128, 255, None, dict(softcap=10.0)))
    cases.append(("softcap-10", 4, 2, 64, 100, 32, dict(softcap=10.0)))
    return cases


def k3_check(torch, ops, ref, da):
    """Every case in both dtypes against the plain version, and rows of
    valid length 0 exactly 0; returns the largest absolute error seen."""
    from repro_torch.tune import PlanCache, set_default_cache
    gen = torch.Generator().manual_seed(16)
    worst = 0.0
    set_default_cache(PlanCache(None))
    try:
        for name, hq, hkv, d, t, bkv, kw in k3_cases():
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                vlens = [1, t // 2 + 3, t]
                q, k, v, vl = k3_inputs(torch, gen, 3, hq, hkv, d, t, vlens,
                                        dtype)
                bkv_run, depth = ops.decode_tiles(q, k, bkv=bkv)
                stage = 2 * bkv_run * d * q.element_size()
                try:
                    run = da.tiles(q, k, bkv_run, depth)
                except ValueError:
                    # not one tile fits a block's 227 KiB: the wrapper must
                    # refuse it and launch nothing
                    before = da.LAUNCHES
                    try:
                        ops.decode_attention(q, k, v, vl, bkv=bkv, **kw)
                        refused = ""
                    except ValueError as e:
                        refused = str(e)
                    check("does not fit" in refused
                          and da.LAUNCHES == before,
                          f"K3 {name} T={t} bkv={bkv_run}: a tile of {stage} "
                          f"bytes was not refused")
                    print(f"[K3] case={name} D={d} T={t} bkv={bkv_run} "
                          f"dtype={dname} refused: one tile is {stage} bytes "
                          f"ok=True", flush=True)
                    continue
                got = ops.decode_attention(q, k, v, vl, bkv=bkv, **kw)
                desc = (f"case={name} B=3 Hq={hq} Hkv={hkv} D={d} T={t} "
                        f"valid={vlens} bkv={'plan:' if bkv is None else ''}"
                        f"{run['bkv']} kernel_config='{run['config']}' "
                        f"splits={run['splits']} {kw or ''}")
                worst = max(worst, k3_holds(torch, ref, "K3", desc, got, q,
                                            k, v, vl, **kw))
        for t in (1, 255, 1024):
            for dname in ("float32", "bfloat16"):
                q, k, v, vl = k3_inputs(torch, gen, 3, 24, 8, 128, t,
                                        [0, t, 0], getattr(torch, dname))
                got = ops.decode_attention(q, k, v, vl)
                torch.cuda.synchronize()
                zero = int(torch.count_nonzero(got[0::2]))
                print(f"[K3] case=valid-len-0 T={t} dtype={dname} rows 0 and "
                      f"2 nonzero={zero}", flush=True)
                check(zero == 0, "K3: a row with valid_len 0 is not 0")
                worst = max(worst, k3_holds(
                    torch, ref, "K3", f"case=valid-len-0 row 1 T={t}",
                    got[1:2], q[1:2], k[1:2], v[1:2], vl[1:2]))
    finally:
        set_default_cache(None)
    return worst


def roofline_bound(flops, moved):
    """(bound_ms, bound_by) from the port's memory model: one card, no
    collective bytes."""
    from repro_torch.core.memmodel import roofline
    terms = roofline(flops, moved, 0.0, 1)
    by = {"compute": "operations", "memory": "bytes"}[terms.dominant]
    return 1e3 * terms.bound_s, by, terms.dominant


def k3_time(torch, ops, ref, da, card, geometry):
    """K3 at a served model's batch-8 dense decode geometry (T 1024, bf16)
    with the plan's tiles."""
    import torch.nn.functional as F
    from repro_torch.tune import PlanCache, set_default_cache
    name, hq, hkv, d = geometry
    b, t = 8, K3_T
    vlens = [t] * b
    itemsize = 2
    moved = (sum(vlens) * hkv * d * itemsize * 2       # K and V read once
             + 2 * b * hq * d * itemsize + b * 4)      # q, o, valid_len
    copies = -(-3 * L2_BYTES // moved)
    gen = torch.Generator().manual_seed(17)
    sets = [k3_inputs(torch, gen, b, hq, hkv, d, t, vlens, torch.bfloat16)
            for _ in range(copies)]
    set_default_cache(PlanCache(None))
    try:
        q, k = sets[0][:2]
        bkv, depth = ops.decode_tiles(q, k)
        run = da.tiles(q, k, bkv, depth)
        k3_holds(torch, ref, "K3", f"case=timed-shape geometry={name} B={b} "
                 f"Hq={hq} Hkv={hkv} D={d} T={t} bkv=plan:{bkv} "
                 f"kernel_config='{run['config']}'",
                 ops.decode_attention(*sets[0]), *sets[0])
        ms = time_ms(torch, lambda *a: ops.decode_attention(*a), sets)
    finally:
        set_default_cache(None)
    plain_ms = time_ms(torch, lambda *a: ref.decode_attention(*a), sets)
    # yardstick: one SDPA call on the cache's transposed views, a boolean
    # mask from valid_len (whatever it copies is in its time)
    pos = torch.arange(t, device="cuda")
    lib = [(qq[:, :, None, :], kk.transpose(1, 2), vv.transpose(1, 2),
            (pos[None, :] < vl[:, None])[:, None, None, :])
           for qq, kk, vv, vl in sets]
    library_ms = time_ms(torch, lambda qq, kk, vv, mask:
                         F.scaled_dot_product_attention(
                             qq, kk, vv, attn_mask=mask, enable_gqa=True),
                         lib)
    flops = 4 * sum(vlens) * hq * d
    bound_ms, bound_by, dominant = roofline_bound(flops, moved)
    blocks = da.occupancy(d, run["warps"], run["stages"])
    print(f"[K3 time] geometry={name} shape=B{b} Hq{hq} Hkv{hkv} D{d} T{t} "
          f"bf16 valid={vlens[0]} tiles=bkv {bkv} x depth {depth} "
          f"kernel_config='{run['config']}' splits={run['splits']} "
          f"merge={run['merge']} grid_blocks={b * hkv * run['splits']} "
          f"resident_blocks_per_sm={blocks} input_copies={copies} "
          f"card='{card}' ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (SDPA, enable_gqa, bool mask) "
          f"bound_ms={bound_ms:.4f} bound_by={bound_by} "
          f"roofline_dominant={dominant} moved_MB={moved / 1e6:.1f} "
          f"ratio_to_library={ms / library_ms:.2f} ratio_to_bound="
          f"{ms / bound_ms:.2f} achieved_GBps={moved / ms / 1e6:.1f}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                design=f"{run['config']} splits={run['splits']} "
                       f"merge={run['merge']}",
                tiles=dict(bkv=bkv, pipeline_depth=depth,
                           stages=run["stages"], splits=run["splits"]))


def k8_check(torch, ops, ref, mm):
    """The reference's cases, the plan's tiles at (96, 100, 64), and the
    timed shapes, against the plain version with TF32 off; returns the
    largest absolute error seen."""
    from repro_torch.tune import PlanCache, set_default_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(18)
    dev = torch.device("cuda")
    worst = 0.0
    cases = [((m, k, n), blocks) for m, k, n in
             ((128, 128, 128), (256, 128, 384), (64, 256, 128))
             for blocks in ((64, 64, 64), (128, 128, 128))]
    cases.append(((96, 100, 64), None))
    set_default_cache(PlanCache(None))
    try:
        for (m, k, n), blocks in cases:
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                x = torch.randn((m, k), generator=gen).to(dev, dtype)
                y = torch.randn((k, n), generator=gen).to(dev, dtype)
                bm, bn, bk = blocks or (None, None, None)
                tiles = ops.matmul_tiles(x, y, bm=bm, bn=bn, bk=bk)
                got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk)
                desc = (f"case=(m,k,n)=({m},{k},{n}) "
                        f"tiles={'plan:' if blocks is None else ''}{tiles} "
                        f"kernel_config='{mm.configuration(x, y, *tiles)}'")
                worst = max(worst, k8_holds(torch, ref, "K8", desc, got, x,
                                            y))
        for m, n, k in K8_SHAPES:
            x = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
            y = torch.randn((k, n), generator=gen).to(dev, torch.bfloat16)
            tiles = ops.matmul_tiles(x, y)
            worst = max(worst, k8_holds(
                torch, ref, "K8", f"case=timed MxNxK={m}x{n}x{k} "
                f"tiles=plan:{tiles} "
                f"kernel_config='{mm.configuration(x, y, *tiles)}'",
                ops.matmul(x, y), x, y, tight=True))
    finally:
        set_default_cache(None)
    return worst


def k8_time(torch, ops, ref, mm, card):
    """K8 at its two timed shapes with the plan's tiles; the first shape's
    numbers lead the kernels line, both are listed there."""
    from repro_torch.tune import PlanCache, set_default_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(19)
    timed = []
    set_default_cache(PlanCache(None))
    try:
        for m, n, k in K8_SHAPES:
            itemsize = 2
            moved = (m * k + k * n + m * n) * itemsize
            copies = -(-3 * L2_BYTES // moved)
            sets = [(torch.randn((m, k), generator=gen).to("cuda",
                                                           torch.bfloat16),
                     torch.randn((k, n), generator=gen).to("cuda",
                                                           torch.bfloat16))
                    for _ in range(copies)]
            tiles = ops.matmul_tiles(*sets[0])
            slow = m * n * k > 1 << 30          # a few calls of milliseconds
            iters, warmup = (3, 1) if slow else (50, 5)
            ms = time_ms(torch, lambda a, b_: ops.matmul(a, b_), sets,
                         iters=iters, warmup=warmup)
            plain_ms = time_ms(torch, lambda a, b_: ref.matmul(a, b_), sets,
                               iters=iters, warmup=warmup)
            library_ms = time_ms(torch, lambda a, b_: torch.matmul(a, b_),
                                 sets)
            flops = 2 * m * n * k
            bound_ms, bound_by, dominant = roofline_bound(flops, moved)
            config = mm.configuration(*sets[0], *tiles)
            print(f"[K8 time] MxNxK={m}x{n}x{k} bf16 plan_tiles={tiles} "
                  f"kernel_config='{config}' input_copies={copies} "
                  f"iters={iters} card='{card}' ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"(torch.matmul) bound_ms={bound_ms:.4f} "
                  f"bound_by={bound_by} roofline_dominant={dominant} "
                  f"achieved_TFLOPs={flops / ms / 1e9:.2f} "
                  f"achieved_GBps={moved / ms / 1e6:.1f}", flush=True)
            timed.append(dict(shape_mnk=[m, n, k],
                              tiles=dict(bm=tiles[0], bn=tiles[1],
                                         bk=tiles[2]),
                              kernel_config=config,
                              ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by))
            del sets
    finally:
        set_default_cache(None)
    first = timed[0]
    return dict(ms=first["ms"], plain_ms=first["plain_ms"],
                library_ms=first["library_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], tiles=first["tiles"],
                design=" | ".join(t["kernel_config"] for t in timed),
                timed=timed)


# ---------------------------------------------------------------------------

def main():
    try:
        import numpy as np
        import torch
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import matmul as mm
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
    t_start = time.perf_counter()
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
        sass_phase(kbuild)
        drain = drain_lens(np)
        err = k1_check(torch, pa, ref, drain)
        timing = k1_time(torch, pa, ref, card, [1024] * 8, "full")
        k1_time(torch, pa, ref, card, drain, "drain")
        k1_timed = [
            dict(shape=label, **k1_time(torch, pa, ref, card, lens, label,
                                        geometry))
            for label, lens, geometry in (
                ("gemma2-27b-ring", RING_LENS, RING_GEOMETRY),
                ("gemma2-27b-global", RING_LENS[:3] + [8192],
                 GLOBAL_GEOMETRY),
                ("gemma-2b-int8-drain", drain, INT8_GEOMETRY),
                ("gemma-2b-int8-full", [1024] * 8, INT8_GEOMETRY))]
        launches, greedy = serve_phase(torch, np, card)
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
        mem_err = dict(stream_copy=k4_check(torch, ops, ref, sc),
                       strided_copy=k5_check(torch, ops, ref),
                       random_gather=k6_check(torch, ops, ref),
                       pointer_chase=k7_check(torch, ops, ref, pc))
        mem_time = dict(
            stream_copy=k4_time(torch, ops, ref, sc, engines, card),
            strided_copy=k5_time(torch, ops, ref, engines, card),
            random_gather=k6_time(torch, ops, ref, engines, card),
            pointer_chase=k7_time(torch, ops, ref, pc, engines, card))
        gc.collect()
        torch.cuda.empty_cache()
        run, mem_launches = memory_phase(torch, card, dict(
            stream_copy=sc, strided_copy=st, random_gather=rg,
            pointer_chase=pc))
        cal = calibrate_phase(run)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        tune_launches, _ = tune_phase(torch, cal, card)
        k3_err = k3_check(torch, ops, ref, da)
        k3_timing = k3_time(torch, ops, ref, da, card, K3_GEOMETRIES[0])
        k3_time(torch, ops, ref, da, card, K3_GEOMETRIES[1])
        gc.collect()
        torch.cuda.empty_cache()
        k8_err = k8_check(torch, ops, ref, mm)
        k8_timing = k8_time(torch, ops, ref, mm, card)
        gc.collect()
        torch.cuda.empty_cache()
        ring_launches = ring_serve_phase(torch, np, card)
        gc.collect()                 # the 54 GB of gemma2-27b go
        torch.cuda.empty_cache()
        int8_launches = int8_serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        ring_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        int8_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        prng_phase(torch, np, card)
        sampled_launches = sampled_serve_phase(torch, np, card, greedy)
        gc.collect()
        torch.cuda.empty_cache()
        sampled_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        spec_serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        bench_serve_phase(torch, card)
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr)
        return 1
    k1 = dict(name="paged_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/paged_attention.cu",
              replaces="src/repro/kernels/paged_attention.py:100",
              launches=launches, max_abs_err=err, **timing,
              launches_by_path={"serve": launches,
                                "ring serve": ring_launches,
                                "int8 serve": int8_launches,
                                **sampled_launches},
              timed=k1_timed)
    k2 = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/flash_attention.cu",
              replaces="src/repro/kernels/flash_attention.py:128",
              launches=k2_launches, max_abs_err=k2_err, **k2_timing)
    replaces = dict(stream_copy="src/repro/kernels/stream_copy.py:29",
                    strided_copy="src/repro/kernels/strided_copy.py:22",
                    random_gather="src/repro/kernels/random_gather.py:46",
                    pointer_chase="src/repro/kernels/pointer_chase.py:32")
    mem = [dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{name}.cu",
                replaces=replaces[name], launches=mem_launches[name],
                max_abs_err=mem_err[name], **mem_time[name])
           for name in replaces]
    k3 = dict(name="decode_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/decode_attention.cu",
              replaces="src/repro/kernels/decode_attention.py:106",
              launches=tune_launches["decode_attention"], max_abs_err=k3_err,
              **k3_timing)
    k8 = dict(name="matmul", route="cuda",
              source="src/repro_torch/kernels/csrc/matmul.cu",
              replaces="src/repro/kernels/matmul.py:58",
              launches=tune_launches["matmul"], max_abs_err=k8_err,
              **k8_timing)
    print(f"[elapsed] seconds={time.perf_counter() - t_start:.1f} "
          "(the whole run, the kernels' build included)", flush=True)
    print("[previous] not measured in this run: "
          + " ".join(f"{name}_ms={ms}" for name, ms in PREVIOUS_MS.items())
          + " (each kernel before its redesign, from PERF.md section 6: K2 "
          "and K8 on the CUDA cores, timed without a spin before the "
          "events; K1 and K3 with their first CUDA bodies; K4 with one "
          "block per tile; K1's int8 pages at the drain's lengths on the "
          "CUDA cores; NVIDIA H100 80GB HBM3, 700.00 W)")
    print(json.dumps({"kernels": [k1, k2, k3] + mem + [k8]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
