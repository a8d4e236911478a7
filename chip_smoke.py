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
   whose 64 splits merge through the counter), recurrentgemma-9b's local
   layers (B 8, 16 query heads over one kv head, D 256, a ring of 257
   pages, window 2048, two rows past the window), each in
   float32 (tolerance 1e-4) and bfloat16 (3e-2; and, held against the
   plain version run in float32 on the same inputs, within one bfloat16
   rounding of its output), each line naming its configuration, split
   count and merge (bfloat16 q with bfloat16 or int8 pages at D 64, 128
   and 256 on the tensor cores);
4. K1 time at the main path's shape (B 8, 128 pages of 8 tokens), full
   and at the serve drain's ragged lengths (its first 8 prompts plus 16
   decoded tokens), then at gemma2-27b's ring and global geometry and at
   gemma-2b's int8 pages (the drain's lengths and full rows of 1024
   tokens) and recurrentgemma-9b's ring (group 16, D 256, the hybrid
   serve's lengths at its longest), each beside its plain version, one SDPA call on the gathered
   (dequantized) K/V, and its bound, with the configuration run;
5. serve: full-width gemma-2b (bf16, random weights from a seeded
   generator) through the paged ``ServeEngine``: 16 requests, batch 8,
   four sharing a 256-token prefix, 32 new tokens each, drained twice
   with identical tokens.
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
   rows at the knobs the card ran (each row's kernel geometry: loads in
   flight on the whole card, 32-byte sectors, K5's stride of 1), beside
   the spec's and beside the fit at the rows' own knobs (the earlier fit);
   the fitted T_l must lie within 0.5-2x the median HBM ns/hop of the
   latency rows and the fitted bandwidth within 0.5-1.05x 3.35 TB/s;
15. paper tables: the ``database`` (Table 9), ``conv`` (Table 10) and
   ``roofline`` sweeps at card scale (a 1 GiB table, attention over 256
   MiB of K and of V, the paper's 1920x1080 image, the analytic roofline
   of all ten architectures): no sweep may fail, every row with memory
   traffic must read above 0 and at most 105% of 3.35 TB/s, and the fused
   convolution must match numpy's on a 64x64 tile (float32, 1e-4); each
   row's GB/s and working set against the 50 MiB L2 printed;
16. advisor: ``render_report(advise_model(...))`` for gemma-2b decode_32k
   and gemma2-27b train_4k under the H100's spec and under the fit: every
   site predicts a bandwidth, and in measured mode carries a meas/pred
   ratio;
17. tune: the closed tune -> plan -> execute loop.  Plans for K3
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
18. K3: ``decode_attention`` against its plain version: phi4-mini's (24/8,
   D 128), gemma-2b's (8/1, D 256) and the reference test's (4/2, at D 64)
   geometry, T 100, 255 and 256, tiles of 32, 96 and 256 rows and the
   plan's, softcap 10, a valid length of 1, in float32 (1e-4) and bfloat16
   (3e-2, and within one bfloat16 rounding of the float32 plain version),
   each line naming the kernel configuration the plan's tiles map to
   (``kernel_config``); rows with a valid length of 0 must be exactly 0;
19. K3 time at B 8, T 1024, bf16, the plan's tiles, at phi4-mini's 24/8
   heads (D 128) and gemma-2b's 8/1 (D 256), each beside its plain
   version, SDPA on the cache's transposed views with a boolean mask, and
   the roofline bound;
20. K8: ``matmul`` against its plain version (TF32 off): the reference's
   (m, k, n) triples with blocks of 64 and 128, the plan's tiles at (96,
   100, 64), and the two timed shapes, in float32 (1e-4, the CUDA cores)
   and bfloat16 (2e-2, the tensor cores; at the timed shapes within one
   bfloat16 rounding of the float32 plain version plus the float32
   summation bound), each line naming the route and configuration it ran
   (tile, stages, staging by TMA or element by element);
21. K8 time at 4096^3 and at (M, N, K) = (8, 8192, 3072), bf16, the plan's
   tiles and the kernel's configuration, beside its plain version,
   ``torch.matmul`` and the roofline bound;
22. ring serve: full-width gemma2-27b (46 layers, 54.5 GB of bf16 weights
   drawn on the card) through the paged engine, batch 4, max_len 8192,
   prefill chunks of 256: 8 requests (prompts of 4160 and 5120 tokens past
   the 4096 window, six of 64-512 with three sharing a 256-token prefix),
   32 new tokens each, drained twice with identical tokens.  Every decode
   tick must launch K1 once per layer (ring tables on the local layers,
   full tables on the global ones), the ring must turn (a ring page
   reused) and its peak stay within batch x ring_slots; prefix sharing
   stays off on a windowed stack, as in the reference.  A profiled decode window and prefill chunk
   follow;
23. int8 serve: full-width gemma-2b with ``kv_dtype="int8"`` (pages of 16
   tokens, the bf16 page's bytes), the serve phase's 16 requests drained
   twice with identical tokens; every tick launches K1 once per layer on its tensor-core route
   with int8 pages;
24. ring parity and int8 parity: gemma2-27b's (local, global) pair at its
   published widths (window narrowed to 32 so the ring turns in a short
   drain) and 2-layer gemma-2b with int8 KV, float32, drained on the card
   (K1) and on the CPU (plain path); the tokens must agree; then the
   pair preempted under chaos in recompute mode (``[preempt parity]``; a
   ring holds no host tier): tokens, keys and every counter card == CPU;
25. host link: device -> host and host -> device GB/s through pinned and
   pageable memory, over one full-width gemma-2b swap (a 300-token
   context, 38 pages of 147,456 B) and over 256 MiB;
26. preempt serve: full-width gemma-2b (bf16) on the serve phase's engine
   geometry and 16 requests, odd rids high priority: a pool-pressure drain
   over about half the serve phase's page peak must preempt and swap;
   its tokens equal the serve phase's when no victim was recomputed
   (the requests that parted are printed either way); chaos drains (seed
   13, preempt 0.25, exhaust 0.2) of the three shortest prompts of the
   first 8 requests with a decode window of 2: forced swap (tokens equal the
   serve phase's), forced recompute and the cost model with 30%
   corruption (requests that part from the serve phase's tokens counted:
   a recomputed bf16 row rounds as a prefill chunk does), forced swap on
   int8 pages of 16 tokens (tokens equal the int8 serve phase's); each
   drain completes, conserves pages and launches K1 once a layer a tick;
   then the resume walls of a 300-token context by swap and by recompute;
27. preempt parity: 2-layer full-width gemma-2b in float32 on the card
   and on the CPU, greedy and sampled, undisturbed and under chaos in the
   three modes (cost model with 30% corruption), and greedy through
   evacuate -> adopt mid-stream and export -> import between two
   engines: tokens, keys and every counter card == CPU, and every drive's
   tokens the undisturbed drain's;
28. hybrid serve: full-width recurrentgemma-9b (38 layers: 26 RG-LRU
   layers on dense per-slot state and 12 local-attention layers, 16 query
   heads over one kv head at D 256, window 2048; 17.3 GB of bf16 weights
   drawn on the card) through the paged engine, batch 8, max_len 4096,
   prefill chunks of 256: 8 requests (prompts of 2100 and 2600 tokens
   past the window, six of 64-512), 16 new tokens each, drained twice with
   identical tokens.  No full-attention pool; every decode tick must
   launch K1 once per attention layer (12) on the ring tables, the ring
   must turn and every ring page be back at the end; the warm tick, the ms
   per 256-token chunk and a profiled decode window follow;
29. ssm serve: full-width mamba2-130m (24 SSD layers, no attention)
   through the paged engine with no pool at all: six prompts of 64-512
   tokens and one of 600, 16 new tokens each, drained twice with identical
   tokens and no K1 launch;
30. hybrid parity: recurrentgemma-9b at published widths cut to 5 layers
   (one triple and both remainder RG-LRU layers), float32, window
   narrowed to 32, drained on the card and on the CPU through the paged
   backend (K1) and through the dense backend with ``attn_impl="pallas"``
   (K2 in every prefill's attention layer); the tokens must agree; the
   paged drain again under chaos in recompute mode (the resumed RG-LRU
   state comes from the prefill scan), card == CPU;
31. ssm parity: float32 mamba2-130m at full width, prompts of 300 and 517
   tokens in prefill chunks of 512 (whole and padded SSD chunks of 256),
   drained on the card and on the CPU; the tokens must agree;
32. prng: JAX's threefry keys and bits (``repro_torch.serve.prng``) at
   (8, 256000) on the card exactly equal to the CPU's (bits, ``split``,
   ``fold_in``, ``subkey_chain``, ``uniform``), ``gumbel`` within 2 ulp;
   the sampler at gemma-2b's vocab for (temperature 0.9, top_p 0.95) and
   (temperature 0.8, top_k 50): masks, draws and times;
33. sampled serve: full-width gemma-2b (bf16) through the paged engine
   with each sampling setting (keys seeded with 3), then the first on
   int8 pages: the serve phase's first 8 requests (one batch, the run's
   time), each drained twice with identical tokens, K1 once a layer on every tick, the warm tick
   beside the greedy tick of phase 5;
34. sampled parity: the parity phase's model and requests sampled with
   (temperature 0.9, top_p 0.95) on the card and on the CPU: tokens and
   final keys must agree;
35. spec serve: full-width gemma-2b in float32, the serve phase's first 8
   requests through the vanilla engine and speculative engines (spec_k 3),
   greedy and sampled, drafting with the target itself and with weights
   from another seed (the draft's dense prefill through K2): tokens equal
   to vanilla, the self-draft's accept rate 1.0, the other draft's
   sampled proposals partly rejected, the pools conserve pages; rounds,
   accepted drafts per round and ms per round printed;
36. bench serve: the ``serve``, ``kernel_plan``, ``paged_serve`` and
   ``spec_serve`` sweeps at card scale, twice, persisted under
   ``build/bench_serve``, then ``repro_torch.bench.compare`` between the
   two runs: every row and verdict printed, and ``--gate structural``
   (deterministic rows equal, no vanished metric) must pass; wall-clock
   verdicts are advisory; the ``preempt_serve`` sweep once at card scale
   (full-width gemma-2b in float32, the reference's larger mix), its
   gates in the sweep.

Kernel times are CUDA-event times over back-to-back calls behind a spin
of the card, so they time the card's work, not the host's enqueueing.
A ``[phase]`` line after each group of phases gives its seconds and the
run's elapsed time.

It ends with a ``[previous]`` line (K1's, K2's, K3's, K4's and K8's times
before their redesign, and K1's int8 pages on the CUDA cores, as PERF.md
records them: not measured in this run),
the kernels' JSON line (K1, K2, K3, K4 and K8 also carry their design, K7
its latency bound; K1 its launches on each serving path, the sampled,
hybrid and preempted ones included, and its times at the new geometries), the card line and the
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
# recurrentgemma-9b's local-attention layers: 16 query heads over one kv
# head (the mma's whole 16-row tile) at D 256, a ring of 2048/8 + 1 pages
RECURRENTGEMMA_GEOMETRY = dict(b=8, hq=16, hkv=1, d=256, page=8, n=257,
                               int8=False, kw=dict(window=2048))
# the ring serve's decode lengths at its longest: the two prompts past the
# window and two short ones, 16 tokens decoded
RING_LENS = [4160 + 16, 5120 + 16, 300, 8000]
# the hybrid serve's two prompts past the 2048-token window
HYBRID_LONG = (2100, 2600)


def hybrid_lens(np):
    """The hybrid serve's decode lengths at their longest: its 8 prompts
    plus 16 decoded tokens each."""
    from repro_torch.serve import Request
    return [r.prompt.shape[0] + 16
            for r in long_requests(np, Request, 256000, HYBRID_LONG, 16)]


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


def k1_cases(drain, hybrid):
    """(name, B, Hq, Hkv, D, page, N, valid lengths, kwargs); ``drain``
    holds the serve drain's ragged lengths (:func:`drain_lens`),
    ``hybrid`` the hybrid serve's (:func:`hybrid_lens`)."""
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
        # recurrentgemma-9b's local layers: group 16 at D 256 over a ring
        # of 257 pages, window 2048, two rows past the window
        ("recurrentgemma-9b-ring", 8, 16, 1, 256, 8, 257, hybrid,
         dict(window=2048)),
    ]


def k1_check(torch, pa, ref, drain, hybrid):
    """Every case in both dtypes against the plain version; returns the
    largest absolute error seen."""
    from repro_torch.kernels import decode_core as core
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for name, b, hq, hkv, d, page, n, vlens, kw in k1_cases(drain, hybrid):
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

def long_requests(np, Request, vocab, longs, max_new):
    """8 requests, ``max_new`` new tokens each: the first two prompts run
    to ``longs`` tokens, the other six hold 64-512 tokens, three of them
    sharing a 256-token prefix."""
    reqs = make_requests(np, Request, vocab, 0, 8, (64, 513), 256, (2, 5, 7),
                         max_new)
    rng = np.random.default_rng(5)
    for r, n in zip(reqs[:2], longs):
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
    K1 launches = attention layers x decode ticks (ticks > 0), then
    ``extra_checks(run)``, and that both drains gave the same tokens.
    Prints one ``[tag]`` line a run; returns the warm run's launches and
    its ms per decode tick, ms per prefill chunk, tokens per second, page
    peak and tokens."""
    cfg = eng.bundle.cfg
    launches = 0
    warm = {}
    tokens = []
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
        check(launches == n_attn * st.decode_steps and st.decode_steps > 0,
              f"{tag} {run} drain: K1 launches {launches} != {n_attn} x "
              f"{st.decode_steps} decode ticks")
        tokens.append([list(r.out_tokens) for r in reqs])
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
                    tok_s=st.tokens_out / dt,
                    chunk_ms=1e3 * eng.prefill_s / st.prefill_chunks,
                    pages_peak=st.pages_peak, tokens=tokens[-1])
    check(tokens[0] == tokens[1], f"{tag}: the two drains' tokens differ")
    print(f"[{tag}] drains_equal=True", flush=True)
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
    # two prompts past the 4096-token window
    reqs = long_requests(np, Request, cfg.vocab_size, (4160, 5120), 32)
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

    launches, warm = serve_runs(torch, eng, reqs, "int8 serve", card,
                                cfg.num_layers, pa, checks)
    for line in profile_window(torch, eng, reqs, steps=(
            ("decode window", _prepare_decode),)):
        print(line.replace("[profile]", "[profile] arch=gemma-2b kv=int8"),
              flush=True)
    return launches, warm


def attention_layers(cfg):
    from repro_torch.configs.base import ATTN
    return (sum(s.mixer == ATTN for s in cfg.layer_pattern)
            * cfg.num_pattern_blocks
            + sum(s.mixer == ATTN for s in cfg.remainder_specs))


def card_cpu_parity(torch, np, cfg, flags, reqs_of, tag, desc,
                    sampling=None, backend="paged", max_len=128,
                    prefill_chunk=32, params=None, drives=None, record=None,
                    window=8):
    """The same float32 weights (drawn on the card, or ``params`` there,
    copied to the CPU) drain the same requests on the card and on the CPU
    (the plain path); tokens must agree (greedy, or drawn with
    ``sampling`` from keys seeded with 3, whose final values must agree
    too).  Paged: every card tick must launch K1 once per attention layer,
    and a windowed stack's ring must turn on both.  Dense with
    ``attn_impl="pallas"``: every card prefill must launch K2 once per
    attention layer.

    ``drives`` maps a label to ``drive(eng, reqs, make_engine)``, which
    drains ``reqs`` its own way (under chaos, or through a second engine
    from ``make_engine()``) and returns the engines whose ticks ran; each
    drive runs on both devices after a reset (None: the plain drain), and
    its tokens, final keys and every ``ServeStats`` counter of those
    engines must agree.  ``record`` (a dict) receives each drive's tokens
    and counters.  ``window`` is the engines' decode window."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_bundle = build(cfg, flags, device="cuda")
    card_params = params or card_bundle.init(
        torch.Generator(device="cuda").manual_seed(1))
    n_attn = attention_layers(cfg)
    drives = drives or {"drain": None}
    outs, reused, keys, stats = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        bundle = card_bundle if dev == "cuda" else build(cfg, flags,
                                                         device="cpu")
        p = card_params if dev == "cuda" else _to(card_params, "cpu")

        def make(bundle=bundle, p=p, dev=dev):
            return ServeEngine(bundle, p, 4, max_len, window=window,
                               sampling=sampling, seed=3,
                               cache_backend=backend,
                               prefill_chunk=prefill_chunk, device=dev)

        eng = make()
        for label, drive in drives.items():
            eng.reset()
            reqs = reqs_of()
            pa.reset_launches()
            fa.reset_launches()
            if drive is None:
                for r in reqs:
                    eng.add_request(r)
                eng.run_to_completion()
                used = [eng]
            else:
                used = drive(eng, reqs, make)
            key = (dev, label)
            outs[key] = [list(r.out_tokens) for r in reqs]
            reused[key] = sum(e.stats.ring_pages_reused for e in used)
            keys[key] = torch.cat([e.keys.cpu() for e in used])
            stats[key] = [dataclasses.asdict(e.stats) for e in used]
            ticks = sum(e.stats.decode_steps for e in used)
            prefills = sum(e.stats.prefills for e in used)
            if dev == "cuda" and backend == "paged":
                check(pa.LAUNCHES == n_attn * ticks and ticks > 0,
                      f"{tag} {label}: the drain on the card did not run K1 "
                      f"on every attention layer of every tick "
                      f"({pa.LAUNCHES} launches, {n_attn} x {ticks})")
            if dev == "cuda" and backend == "dense" and bundle.flags.attn_impl \
                    == "pallas":
                check(fa.LAUNCHES == n_attn * prefills > 0,
                      f"{tag} {label}: the dense prefills on the card did "
                      f"not run K2 on every attention layer ({fa.LAUNCHES} "
                      f"launches, {n_attn} x {prefills})")
            check(all(len(t) == r.max_new_tokens
                      for t, r in zip(outs[key], reqs)),
                  f"{tag} {label} {dev}: budget missed")
            del used
        del eng, p
    for label in drives:
        c, g = ("cpu", label), ("cuda", label)
        if backend == "paged" and any(s.sliding_window
                                      for s in cfg.layer_pattern):
            check(reused[g] > 0 and reused[c] > 0,
                  f"{tag} {label}: the ring never turned")
        same = outs[c] == outs[g]
        same_keys = bool(torch.equal(keys[c], keys[g]))
        same_stats = stats[c] == stats[g]
        drive = "" if drives == {"drain": None} else f" drive='{label}'"
        print(f"[{tag}] {desc} backend={backend}{drive} "
              f"requests={len(outs[c])} ring_pages_reused={reused[g]} "
              f"cuda_equals_cpu={same} keys_equal={same_keys}"
              + ("" if drives == {"drain": None} else
                 f" stats_equal={same_stats} " + " ".join(
                     f"{k}={sum(st[k] for st in stats[g])}"
                     for k in PREEMPT_COUNTERS)), flush=True)
        check(same, f"{tag} {label}: tokens differ: cpu {outs[c]} cuda "
              f"{outs[g]}")
        check(same_keys, f"{tag} {label}: final keys differ: cpu {keys[c]} "
              f"cuda {keys[g]}")
        check(same_stats, f"{tag} {label}: counters differ: cpu {stats[c]} "
              f"cuda {stats[g]}")
        if sampling is not None and not sampling.greedy:
            check(bool(keys[c].any()), f"{tag} {label}: the sampled drain "
                  "left every key zero")
        if record is not None:
            record[label] = dict(tokens=outs[c], stats=stats[c])
    return card_params


def ring_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, LayerSpec, override
    from repro_torch.serve import Request

    # gemma2-27b's (local, global) pair at its published widths; the window
    # is narrowed from 4096 to 32 so the ring turns within a short drain
    cfg = override(ARCHS["gemma2-27b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32",
                   layer_pattern=(LayerSpec(sliding_window=32), LayerSpec()))

    def reqs():
        return make_requests(np, Request, cfg.vocab_size, 2, 6, (20, 72),
                             17, (0, 4), 8)

    desc = ("arch=gemma2-27b (local, global) pair, full width, float32, "
            "window narrowed 4096->32, softcap 50, scale 144^-0.5")
    params = card_cpu_parity(torch, np, cfg, None, reqs, "ring parity", desc)
    # preempted under chaos (the first 2 requests: each chunk of the pair
    # takes seconds on the CPU): a ring stack holds no host tier, so its
    # victims resume by recompute (prefill chunks over the ring)
    card_cpu_parity(torch, np, cfg, None, lambda: reqs()[:2],
                    "preempt parity", desc, params=params,
                    window=PARITY_WINDOW,
                    drives={"chaos recompute": _chaos_drive("recompute")})


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
# preemption: the host link, the host swap tier and chaos
# ---------------------------------------------------------------------------

# the counters a preempted drain's line prints
PREEMPT_COUNTERS = ("preemptions", "preempt_restarts", "swap_outs",
                    "swap_ins", "swap_bytes", "recompute_resumes",
                    "swap_fallbacks", "prefill_exports", "prefill_imports",
                    "transfer_bytes", "pool_stalls")
# gemma-2b's page across its 18 layers (k and v, one kv head, D 256, bf16,
# 8 tokens) and a 300-token context's pages
GEMMA_PAGE_BYTES = 18 * 2 * 8 * 256 * 2
SWAP_PAGES = 38
# the chaos of the preempt serve phase's drains, on the three shortest
# prompts of the first 8 requests with a decode window of 2: a storm
# restarts a mid-prefill slot, so an n-chunk prompt costs about
# ((4/3)^n - 1) / 0.25 chunks (all of the first 8, up to 13 chunks each,
# took 650-740 chunks a drain); a short window gives the storms more
# rounds of decoding slots to swap
PREEMPT_CHAOS = dict(seed=13, preempt_prob=0.25, exhaust_prob=0.2)
CHAOS_REQUESTS, CHAOS_WINDOW = 3, 2
# the parity drains' decode window: 8 new tokens take 4 rounds, so the
# storms between rounds find slots mid-stream
PARITY_WINDOW = 2


def host_link_phase(torch, card):
    """Device -> host and host -> device rates through pinned and pageable
    host memory: one full-width gemma-2b swap (a 300-token context, 38
    pages of 147,456 B) and 256 MiB; host clock around each copy, the
    device synchronised, best and median of the trials; the bytes must
    come back equal."""
    out = {}
    for label, n, trials in (("gemma-2b swap", SWAP_PAGES * GEMMA_PAGE_BYTES,
                              20),
                             ("256MiB", 256 * 2**20, 8)):
        dev = torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda")
        back = torch.empty_like(dev)
        for kind in ("pinned", "pageable"):
            host = torch.empty(n, dtype=torch.uint8,
                               pin_memory=kind == "pinned")
            rates = {}
            for direction, dst, src in (("d2h", host, dev),
                                        ("h2d", back, host)):
                walls = []
                for _ in range(trials + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dst.copy_(src, non_blocking=kind == "pinned")
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                walls = sorted(walls[1:])
                rates[direction] = (n / walls[0] / 1e9,
                                    n / walls[len(walls) // 2] / 1e9)
            check(torch.equal(back, dev), f"[host link] {label} {kind}: "
                  "the bytes did not come back equal")
            out[label, kind] = rates
            print(f"[host link] card='{card}' bytes={n} ({label}) "
                  f"host={kind} d2h_GBps={rates['d2h'][0]:.2f} "
                  f"(median {rates['d2h'][1]:.2f}) "
                  f"h2d_GBps={rates['h2d'][0]:.2f} "
                  f"(median {rates['h2d'][1]:.2f}) trials={trials}",
                  flush=True)
            del host
        del dev, back
    return out


def swap_timed_engine_class(torch, ServeEngine):
    """The timed engine, also timing its page gathers (device -> pinned
    host) and scatters (host -> device), each closed by a synchronise."""
    base = timed_engine_class(torch, ServeEngine)

    class SwapTimedEngine(base):
        def _init_state(self):
            super()._init_state()
            self.gather_s, self.gathers = 0.0, 0
            self.scatter_s, self.scatters = 0.0, 0

        def _gather_to_host(self, pids):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._gather_to_host(pids)
            self.gather_s += time.perf_counter() - t0
            self.gathers += 1
            return out

        def _scatter_from_host(self, pids, data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._scatter_from_host(pids, data)
            torch.cuda.synchronize()
            self.scatter_s += time.perf_counter() - t0
            self.scatters += 1
    return SwapTimedEngine


class CrcClock:
    """Times the host tier's checksums (every put and every get) while
    installed: ``hosttier.checksum_pages`` is looked up at call time."""

    def __init__(self, hosttier):
        self.mod, self.orig = hosttier, hosttier.checksum_pages
        self.s, self.n, self.bytes = 0.0, 0, 0

    def __enter__(self):
        def timed(data, n_pages):
            t0 = time.perf_counter()
            crc = self.orig(data, n_pages)
            self.s += time.perf_counter() - t0
            self.n += 1
            return crc
        self.mod.checksum_pages = timed
        return self

    def __exit__(self, *exc):
        self.mod.checksum_pages = self.orig


def pages_conserved(eng):
    a = eng.alloc
    return (not a.tables and a.pages_in_use + len(a.free)
            == a.num_pages - a.reserved and set(a.ref) == a.pinned
            and all(r == 1 for r in a.ref.values()))


def preempt_serve_phase(torch, np, card, greedy, int8_warm):
    """Full-width gemma-2b (bf16) on ``[serve]``'s engine geometry (batch
    8, max_len 1024, pages of 8, chunks of 32) and 16 requests, odd rids
    high priority.  A pool-pressure drain over about half ``[serve]``'s
    page peak (at least twice the largest request's pages) must preempt
    and swap; chaos drains of the ``CHAOS_REQUESTS`` shortest prompts of
    the first 8 requests (``PREEMPT_CHAOS``, a window of
    ``CHAOS_WINDOW``) force swap (no
    corruption), force recompute, leave it to the cost model with 30%
    corruption, and force swap on int8 pages of 16 tokens.
    Every drain completes with its pages conserved and K1 launched once a
    layer on every tick; the swap drains give ``[serve]``'s and
    ``[int8 serve]``'s tokens for the same rids (swap moves rows bit for
    bit), the recompute and cost-model drains print how many requests
    parted (a recomputed bf16 row comes from a prefill chunk, not a
    decode step).  Then the resume walls of a 300-token context, by swap
    and by recompute (no prefix cache)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import (ChaosConfig, ChaosEngine, Request,
                                   ServeEngine, hosttier)

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg)
    int8 = build(cfg, RuntimeFlags(kv_dtype="int8"))
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), 32)
    for r in reqs:
        r.priority = r.rid % 2
    most = max(-(-(r.prompt.shape[0] + r.max_new_tokens) // 8) for r in reqs)
    num_pages = 1 + max(greedy["pages_peak"] // 2, 2 * most)
    Timed = swap_timed_engine_class(torch, ServeEngine)
    launches = {}

    def run(eng, batch, label, chaos=None, want=None, counter=None):
        eng.reset()
        for r in batch:
            r.out_tokens.clear()
        pa.reset_launches()
        with CrcClock(hosttier) as crc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if chaos is None:
                for r in batch:
                    eng.add_request(r)
                eng.run_to_completion()
            else:
                ch = ChaosEngine(eng, ChaosConfig(**PREEMPT_CHAOS, **chaos))
                for r in batch:
                    ch.add_request(r)
                ch.run_to_completion()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        st = eng.stats
        check(all(len(r.out_tokens) == r.max_new_tokens for r in batch),
              f"preempt serve {label}: a request missed its budget")
        check(pages_conserved(eng), f"preempt serve {label}: pages not "
              "conserved")
        check(pa.LAUNCHES == cfg.num_layers * st.decode_steps
              and st.decode_steps > 0, f"preempt serve {label}: K1 launches "
              f"{pa.LAUNCHES} != {cfg.num_layers} x {st.decode_steps} ticks")
        check(st.preemptions > 0, f"preempt serve {label}: nothing was "
              "preempted")
        if counter is not None:
            check(getattr(st, counter) > 0, f"preempt serve {label}: "
                  f"{counter} = 0")
        got = [list(r.out_tokens) for r in batch]
        parted = (None if want is None
                  else sum(g != w for g, w in zip(got, want)))
        launches[f"preempt serve {label}"] = pa.LAUNCHES
        per = lambda s, n: f"{1e3 * s / n:.3f}" if n else "n/a"  # noqa: E731
        print(f"[preempt serve] card='{card}' drain='{label}' "
              f"kv_dtype={eng.kv_store_dtype} page={eng.page} "
              f"pool_pages={eng.num_pages} requests={len(batch)} "
              f"seconds={dt:.3f} tokens_out={st.tokens_out} "
              f"decode_steps={st.decode_steps} "
              f"ms_per_decode_tick={per(eng.decode_s, st.decode_steps)} "
              f"prefill_chunks={st.prefill_chunks} "
              f"ms_per_prefill_chunk={per(eng.prefill_s, st.prefill_chunks)} "
              + " ".join(f"{k}={getattr(st, k)}" for k in PREEMPT_COUNTERS)
              + f" swap_out_ms_per_request={per(eng.gather_s, eng.gathers)}"
              f" swap_in_ms_per_request={per(eng.scatter_s, eng.scatters)}"
              f" crc_ms={per(crc.s, crc.n)} crcs={crc.n} "
              f"pages_peak={st.pages_peak} k1_launches={pa.LAUNCHES} "
              f"requests_parted="
              f"{'not compared' if parted is None else parted}",
              flush=True)
        return got, st, parted

    eng = Timed(bundle, params, 8, 1024, num_pages=num_pages)
    print(f"[preempt serve] pool-pressure pool={num_pages} pages of 8 "
          f"([serve] peak {greedy['pages_peak']}, largest request {most} "
          f"pages) priorities=rid%2", flush=True)
    got, st, parted = run(eng, reqs, "pool-pressure", want=greedy["tokens"],
                          counter="swap_ins")
    check(st.preemptions == st.preempt_restarts + st.swap_ins
          + st.recompute_resumes, "preempt serve pool-pressure: a victim "
          "was never resumed")
    if st.recompute_resumes == 0:
        # every resume was a swap or a restart: the rows came back bit for
        # bit, or were decoded again from the prompt
        check(parted == 0, "preempt serve pool-pressure: tokens differ from "
              "[serve]'s")
    else:
        print(f"[preempt serve] pool-pressure: token comparison skipped, "
              f"{st.recompute_resumes} recompute resumes (a recomputed bf16 "
              f"row rounds as a prefill chunk); {parted} of {len(reqs)} "
              f"requests parted from [serve]'s", flush=True)
    del eng
    gc.collect()
    first = sorted(sorted(reqs[:8], key=lambda r: r.prompt.shape[0])
                   [:CHAOS_REQUESTS], key=lambda r: r.rid)
    rids = [r.rid for r in first]
    print(f"[preempt serve] chaos rids={rids} prompts="
          f"{[r.prompt.shape[0] for r in first]} window={CHAOS_WINDOW} "
          f"chaos={PREEMPT_CHAOS}", flush=True)
    bf16_want = [greedy["tokens"][i] for i in rids]
    eng = Timed(bundle, params, 8, 1024, window=CHAOS_WINDOW)
    got, _, _ = run(eng, first, "chaos swap", dict(mode="swap"),
                    counter="swap_ins")
    check(got == bf16_want, "preempt serve chaos swap: tokens differ from "
          "[serve]'s")
    run(eng, first, "chaos recompute", dict(mode="recompute"),
        want=bf16_want, counter="recompute_resumes")
    run(eng, first, "chaos cost model", dict(corrupt_prob=0.3),
        want=bf16_want, counter="swap_fallbacks")
    del eng
    eng = Timed(int8, params, 8, 1024, page_size=16, window=CHAOS_WINDOW)
    got, _, _ = run(eng, first, "chaos swap int8", dict(mode="swap"),
                    counter="swap_ins")
    check(got == [int8_warm["tokens"][i] for i in rids], "preempt serve "
          "chaos swap int8: tokens differ from [int8 serve]'s")
    scales = eng.cache["blocks"]["p0"]["k_scale"]
    check(scales.dtype == torch.float32, "int8 swap without scale lanes")
    del eng
    gc.collect()

    # resume walls: one request with a 300-token context (292 prompt tokens
    # and 9 emitted), preempted by swap and by recompute, no prefix cache
    eng = Timed(bundle, params, 8, 1024, prefix_cache=False)
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=292).astype(np.int32)
    walls, outs = {}, {}
    for mode in ("swap", "recompute"):
        eng.reset()
        req = Request(rid=0, prompt=prompt, max_new_tokens=24)
        eng.add_request(req)
        while len(req.out_tokens) < 9:
            eng._admit()
            if not eng._pending:
                eng.decode_many(8)
        ctx = int(eng._hpos[0])
        with CrcClock(hosttier) as crc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(eng.preempt(0, mode=mode) == mode, f"resume {mode}: "
                  "preempted another way")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chunks = eng.stats.prefill_chunks
            eng._admit()
            while eng._pending:
                eng._admit()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        eng.run_to_completion()
        outs[mode] = list(req.out_tokens)
        walls[mode] = (1e3 * (t1 - t0), 1e3 * (t2 - t1),
                       eng.stats.prefill_chunks - chunks, crc.s * 1e3)
    sw, rc = walls["swap"], walls["recompute"]
    print(f"[preempt serve] resume card='{card}' ctx_tokens={ctx} "
          f"pages={-(-ctx // 8)} page_bytes={eng.bytes_per_page} "
          f"swap_out_ms={sw[0]:.3f} swap_in_ms={sw[1]:.3f} "
          f"swap_crc_ms={sw[3]:.3f} recompute_out_ms={rc[0]:.3f} "
          f"recompute_in_ms={rc[1]:.3f} recompute_chunks={rc[2]} "
          f"recompute_over_swap={rc[1] / sw[1]:.1f} "
          f"swap_equals_recompute_tokens={outs['swap'] == outs['recompute']}",
          flush=True)
    check(sw[2] == 0 and rc[2] >= -(-ctx // 32), "resume walls: the swap "
          "prefilled, or the recompute did not prefill its context")
    return launches


def _chaos_drive(mode, corrupt=0.0, seed=13):
    """A drive that drains under chaos (storms of 0.5 a slot a round,
    phantom grabs of 0.3 a round) in ``mode``; something must be
    preempted."""
    def drive(eng, reqs, make):
        from repro_torch.serve import ChaosConfig, ChaosEngine
        ch = ChaosEngine(eng, ChaosConfig(seed=seed, preempt_prob=0.5,
                                          exhaust_prob=0.3,
                                          corrupt_prob=corrupt, mode=mode))
        for r in reqs:
            ch.add_request(r)
        ch.run_to_completion()
        check(eng.stats.preemptions > 0, f"chaos {mode}: nothing was "
              "preempted")
        return [eng]
    return drive


def _evacuate_drive(eng, reqs, make):
    """Three rounds on one engine, then every unfinished request evacuated
    and adopted by a second engine mid-stream."""
    for r in reqs:
        eng.add_request(r)
    for _ in range(3):
        eng.step()
    check(any(r.out_tokens for r in reqs), "evacuate: no token out yet")
    other = make()
    for r in eng.evacuate():
        other.adopt(r)
    other.run_to_completion()
    check(other.stats.recompute_resumes > 0, "adopt: nothing resumed "
          "mid-stream")
    return [eng, other]


def _export_drive(eng, reqs, make):
    """One engine prefills, a second decodes: each finished prefill is
    exported (its pages in a checksummed transfer entry) and imported."""
    other = make()
    for r in reqs:
        eng.add_request(r)
    while eng.queue or any(s is not None for s in eng.slots):
        eng._admit()
        for i, r in enumerate(eng.slots):
            if r is not None and i not in eng._pending:
                other.import_prefill(*eng.export_finished_prefill(i))
    other.run_to_completion()
    check(other.stats.prefill_imports == len(reqs), "import: not every "
          "prefill landed")
    return [eng, other]


def preempt_parity_phase(torch, np):
    """2-layer full-width gemma-2b in float32, card == CPU through
    ``card_cpu_parity`` with chaos drives in all three modes, greedy and
    sampled (top-p, keys seeded 3), then evacuate -> adopt mid-stream and
    export -> import: tokens, final keys and every counter agree, and the
    tokens equal the undisturbed drain's."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.serve import Request
    from repro_torch.serve.sampling import SamplingParams

    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")

    def reqs():
        # the parity phases' requests, the first 4 (the run's time)
        return make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                             (0, 4), 8)[:4]

    params = None
    for label, sp, extra in (
            ("greedy", None, {"evacuate -> adopt": _evacuate_drive,
                              "export -> import": _export_drive}),
            ("sampled", SamplingParams(**SAMPLINGS[0]), {})):
        drives = {"undisturbed": None,
                  "chaos cost model": _chaos_drive(None, corrupt=0.3),
                  "chaos swap": _chaos_drive("swap"),
                  "chaos recompute": _chaos_drive("recompute"), **extra}
        record = {}
        params = card_cpu_parity(
            torch, np, cfg, None, reqs, "preempt parity",
            f"arch=gemma-2b full width, 2 layers, float32, {label}",
            sampling=sp, params=params, drives=drives, record=record,
            window=PARITY_WINDOW)
        want = record["undisturbed"]["tokens"]
        for drive in drives:
            check(record[drive]["tokens"] == want, f"preempt parity {label} "
                  f"{drive}: tokens differ from the undisturbed drain's")
        print(f"[preempt parity] {label}: every drive equals the "
              f"undisturbed drain ({len(drives) - 1} drives)", flush=True)


# ---------------------------------------------------------------------------
# hybrid recurrent stacks: RG-LRU + local attention, and SSD alone
# ---------------------------------------------------------------------------

def hybrid_serve_phase(torch, np, card):
    """Full-width recurrentgemma-9b on the paged engine: 26 RG-LRU layers
    on dense per-slot state, K1 on the ring tables of the 12 local
    attention layers (16 query heads over one kv head, D 256, window
    2048) on every decode tick."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_core as core
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["recurrentgemma-9b"]
    n_attn = attention_layers(cfg)
    bundle, params = load_model(torch, cfg)
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 8, 4096,
                                                 prefill_chunk=256)
    reqs = long_requests(np, Request, cfg.vocab_size, HYBRID_LONG, 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = pa.route(torch.bfloat16, torch.bfloat16, cfg.resolved_head_dim)
    splits = pa.split_count(route, eng.bsz, cfg.num_kv_heads, eng.page,
                            eng.ring_slots, sms)
    check(eng.pages_per_seq == 0 and eng.alloc is None,
          "hybrid serve: a full-attention pool on a stack without a "
          "full-attention layer")
    print(f"[hybrid serve] attention_layers={n_attn} recurrent_layers="
          f"{cfg.num_layers - n_attn} pools: ring {eng.num_ring_pages} "
          f"pages (ring_slots={eng.ring_slots}, window={eng.attn_window}) "
          f"of {eng.page} tokens, no full pool; kv_pool_GiB="
          f"{(eng.kv_bytes() - eng._recurrent_state_bytes()) / 2**30:.3f} "
          f"recurrent_state_MiB={eng._recurrent_state_bytes() / 2**20:.2f} beside "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; K1 "
          f"route={route} group={cfg.num_heads // cfg.num_kv_heads} "
          f"splits={splits} merge={core.merge_kind(route, splits)}",
          flush=True)

    def checks(run):
        st = eng.stats
        check(st.ring_pages_reused > 0, f"hybrid serve {run}: the ring "
              "never turned (no ring page reused)")
        check(st.ring_pages_peak <= eng.bsz * eng.ring_slots,
              f"hybrid serve {run}: ring_pages_peak {st.ring_pages_peak} > "
              f"batch x ring_slots {eng.bsz * eng.ring_slots}")
        a = eng.ralloc
        check(not a.tables and a.pages_in_use == 0
              and len(a.free) == a.num_pages - a.reserved,
              f"hybrid serve {run}: pages not all back at the end")
        check(eng.prefix is None and st.prefix_hit_tokens == 0,
              f"hybrid serve {run}: prefix sharing on a hybrid stack")
        return (f" live_kv_MiB={eng.live_kv_bytes_peak() / 2**20:.2f} "
                f"pages_back=True prefix_sharing=off")

    launches, warm = serve_runs(torch, eng, reqs, "hybrid serve", card,
                                n_attn, pa, checks)
    print(f"[hybrid serve] warm ms_per_decode_tick={warm['tick_ms']:.3f} "
          f"ms_per_256_token_chunk={warm['chunk_ms']:.3f} card='{card}'",
          flush=True)
    for line in profile_window(torch, eng, reqs, steps=(
            ("decode window", _prepare_decode),)):
        print(line.replace("[profile]", "[profile] arch=recurrentgemma-9b"),
              flush=True)
    return launches


def ssm_serve_phase(torch, np, card):
    """Full-width mamba2-130m on the paged engine: 24 SSD layers, no
    attention layer, so no pool and no K1 launch."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["mamba2-130m"]
    bundle, params = load_model(torch, cfg)
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 8, 1024,
                                                 prefill_chunk=256)
    check(eng.backend == "paged" and eng.alloc is None
          and eng.ralloc is None and eng.kv_bytes() == eng._recurrent_state_bytes(),
          "ssm serve: a page pool on a stack without attention")
    reqs = long_requests(np, Request, cfg.vocab_size, (600,), 16)[:7]
    print(f"[ssm serve] attention_layers=0 ssd_layers={cfg.num_layers} "
          f"ssm_chunk={cfg.ssm_chunk} recurrent_state_MiB="
          f"{eng._recurrent_state_bytes() / 2**20:.2f} prompts="
          f"{[r.prompt.shape[0] for r in reqs]}", flush=True)
    _, warm = serve_runs(torch, eng, reqs, "ssm serve", card, 0, pa,
                         lambda run: "")
    print(f"[ssm serve] warm ms_per_decode_tick={warm['tick_ms']:.3f} "
          f"ms_per_256_token_chunk={warm['chunk_ms']:.3f} card='{card}'",
          flush=True)


def hybrid_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, LayerSpec, override
    from repro_torch.configs.base import ATTN, RGLRU
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import Request

    # one (rglru, rglru, attn) triple and both remainder RG-LRU layers at
    # published widths; the window is narrowed from 2048 to 32 so the ring
    # turns within a short drain
    cfg = override(ARCHS["recurrentgemma-9b"], num_layers=5,
                   param_dtype="float32", compute_dtype="float32",
                   layer_pattern=(LayerSpec(mixer=RGLRU),
                                  LayerSpec(mixer=RGLRU),
                                  LayerSpec(mixer=ATTN, sliding_window=32)))

    def reqs():
        return make_requests(np, Request, cfg.vocab_size, 2, 6, (20, 72),
                             17, (0, 4), 8)

    desc = ("arch=recurrentgemma-9b full width, 5 layers (a triple and two "
            "remainder RG-LRU layers), float32, window narrowed 2048->32")
    params = card_cpu_parity(torch, np, cfg, None, reqs, "hybrid parity",
                             desc)
    # preempted under chaos (as the ring pair's): the resumed RG-LRU
    # state comes from the prefill scan over the context, so card == CPU
    # is the check here
    card_cpu_parity(torch, np, cfg, None, lambda: reqs()[:2],
                    "preempt parity", desc, params=params,
                    window=PARITY_WINDOW,
                    drives={"chaos recompute": _chaos_drive("recompute")})
    card_cpu_parity(torch, np, cfg, RuntimeFlags(attn_impl="pallas"), reqs,
                    "hybrid parity", desc + ", attn_impl=pallas",
                    backend="dense", params=params)


def ssm_parity_phase(torch, np):
    from repro_torch.configs import ARCHS, override
    from repro_torch.serve import Request

    cfg = override(ARCHS["mamba2-130m"], param_dtype="float32",
                   compute_dtype="float32")

    def reqs():
        # two prompts past an SSD chunk of 256 and four short ones: the
        # 300-token prompt is one prefill chunk of a whole SSD chunk and a
        # padded one, the 517-token one two whole SSD chunks, then 5 tokens
        out = make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                            (0, 4), 8)
        rng = np.random.default_rng(6)
        for r, n in zip(out[:2], (300, 517)):
            more = rng.integers(0, cfg.vocab_size, size=n - r.prompt.shape[0])
            r.prompt = np.concatenate([r.prompt, more.astype(np.int32)])
        return out

    card_cpu_parity(torch, np, cfg, None, reqs, "ssm parity",
                    "arch=mamba2-130m full width, float32, prompts of 300 "
                    "and 517 tokens in chunks of 512", max_len=1024,
                    prefill_chunk=512)


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
    the serve phase's 16 requests with the first setting, its first 8 (one
    batch, to keep the run inside its time) with the second and then with
    the first setting on int8 pages of 16 tokens; each drained twice with
    identical tokens, K1 once a layer on every tick, the warm tick beside
    the greedy one."""
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
    for i, (b, sp, kw, kv) in enumerate(runs):
        batch = reqs if i == 0 else reqs[:8]
        eng = timed_engine_class(torch, ServeEngine)(
            b, params, 8, 1024, sampling=SamplingParams(**sp), seed=3, **kw)

        def checks(run, eng=eng, sp=sp):
            check(bool(eng.keys.any()), "sampled serve: no key was set")
            return (f" sampling='{_desc(sp)}' seed=3 "
                    f"greedy_ms_per_decode_tick={greedy['tick_ms']:.3f} "
                    f"greedy_tok_s={greedy['tok_s']:.1f}")

        n, warm = serve_runs(torch, eng, batch, "sampled serve", card,
                             cfg.num_layers, pa, checks)
        launches[f"sampled serve {kv} {_desc(sp)}"] = n
        print(f"[sampled serve] kv={kv} sampling='{_desc(sp)}' "
              f"requests={len(batch)} first_equals_warm=True "
              f"warm_ms_per_decode_tick="
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
# run once, after the comparison (the run's time): its gates are in-sweep
BENCH_ONCE = ("preempt_serve",)


def bench_serve_phase(torch, card):
    """The serving sweeps at card scale twice in one call, then the
    comparator between the two runs: every row and verdict printed; the
    structural gate (deterministic rows identical, no vanished metric)
    must pass; wall-clock verdicts are advisory.  ``BENCH_ONCE`` runs
    once, its sweeps raising on a failed gate."""
    from repro_torch.bench import compare, run_sweeps

    out = os.path.join(ROOT, "build", "bench_serve")
    paths = []
    for i, names in ((1, BENCH_SWEEPS), (2, BENCH_SWEEPS), (3, BENCH_ONCE)):
        print(f"[bench serve] run={i} card='{card}' sweeps="
              f"{','.join(names)} scale=card", flush=True)
        t0 = time.perf_counter()
        run = run_sweeps(names=names, fast=False, out_dir=out,
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
    paths = paths[:2]
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
# the calibration's gate: a fit whose knobs describe the card lands its T_l
# near the chase's ns/hop and its bandwidth near the data sheet's
FIT_LATENCY_RANGE = (0.5, 2.0)     # x the median HBM ns/hop
FIT_BW_RANGE = (0.5, 1.05)         # x 3.35 TB/s
# the fit's residual at the rows' own knobs before the rows carried the
# kernels' geometry, as PERF.md records it (not measured in a run)
PREVIOUS_RMS_LOG_ERROR = 2.449
PAPER_SWEEPS = ("database", "conv", "roofline")
CONV_TOL = 1e-4                    # float32, against numpy's window sum
ADVISOR_CELLS = (("gemma-2b", "decode_32k"), ("gemma2-27b", "train_4k"))


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


def calibrate_phase(run, card):
    """Fits the memory model to the memory phase's rows at the knobs the
    card ran (``bench.calibrate.card_knobs``) and gates the fit: T_l within
    ``FIT_LATENCY_RANGE`` of the median HBM ns/hop the latency rows
    measured, BW within ``FIT_BW_RANGE`` of 3.35 TB/s.  Beside it, the fit
    of the same rows at their own knobs (the reference's, as the port
    fitted them before).  Returns the fit."""
    import dataclasses
    from repro_torch.bench import BenchRun, calibrate
    from repro_torch.core.memmodel import H100
    t0 = time.perf_counter()
    cal = calibrate(run=run)
    # without the kernels' geometry every row fits at its own knobs
    own = calibrate(run=BenchRun(results=[
        dataclasses.replace(r, extras={}) for r in run.results]))
    seconds = time.perf_counter() - t0
    hops = sorted(float(r.extras["ns_per_hop"]) for r in run.results
                  if r.name.startswith("latency_region_"))
    hop_ns = hops[len(hops) // 2]
    lat_ratio = cal.spec.latency_s * 1e9 / hop_ns
    bw_ratio = cal.spec.hbm_bw / HBM_BYTES_PER_S
    print(f"[calibrate] card='{card}' samples={cal.n_samples} "
          f"fitted_latency_ns={cal.spec.latency_s * 1e9:.1f} "
          f"hbm_ns_per_hop_median={hop_ns} latency_over_hop={lat_ratio:.3f} "
          f"(gate {FIT_LATENCY_RANGE}) "
          f"fitted_hbm_GBps={cal.spec.hbm_bw / 1e9:.1f} "
          f"bw_over_peak={bw_ratio:.3f} (gate {FIT_BW_RANGE}) "
          f"spec_latency_ns={H100.latency_s * 1e9:.1f} "
          f"spec_hbm_GBps={H100.hbm_bw / 1e9:.1f} "
          f"rms_log_error={cal.rms_log_error:.3f} "
          f"measured_over_model={ {k: round(v, 3) for k, v in cal.ratios.items()} } "
          f"seconds={seconds:.2f}", flush=True)
    print(f"[calibrate] own knobs (the rows' knobs, the earlier fit) on "
          f"this run's rows: fitted_latency_ns={own.spec.latency_s * 1e9:.1f} "
          f"fitted_hbm_GBps={own.spec.hbm_bw / 1e9:.1f} "
          f"rms_log_error={own.rms_log_error:.3f}; the earlier fit's own "
          f"run: rms_log_error={PREVIOUS_RMS_LOG_ERROR} (PERF.md, not "
          f"measured in this run)", flush=True)
    check(FIT_LATENCY_RANGE[0] <= lat_ratio <= FIT_LATENCY_RANGE[1],
          f"fitted T_l {cal.spec.latency_s * 1e9:.1f} ns is {lat_ratio:.3f}x "
          f"the measured {hop_ns} ns/hop: the fit's knobs are wrong")
    check(FIT_BW_RANGE[0] <= bw_ratio <= FIT_BW_RANGE[1],
          f"fitted BW {cal.spec.hbm_bw / 1e9:.1f} GB/s is {bw_ratio:.3f}x "
          f"3.35 TB/s: the fit's knobs are wrong")
    return cal


def paper_tables_phase(torch, np, card):
    """Tables 9 and 10 and the roofline rows at card scale: no sweep may
    fail, every row with memory traffic must read above 0 and at most
    ``PEAK_SHARE_LIMIT`` x 3.35 TB/s, and the fused convolution must match
    numpy's on a 64 x 64 tile."""
    from repro_torch.bench import run_sweeps
    from repro_torch.bench.sweeps import conv
    t0 = time.perf_counter()
    run = run_sweeps(names=PAPER_SWEEPS, device="cuda", out_dir=None,
                     echo=False)
    seconds = time.perf_counter() - t0
    check(not run.failures, f"paper-table sweeps failed: {run.failures}")
    check({r.sweep for r in run.results} == set(PAPER_SWEEPS),
          f"a paper-table sweep emitted no row: "
          f"{sorted({r.sweep for r in run.results})}")
    limit = PEAK_SHARE_LIMIT * HBM_BYTES_PER_S / 1e9
    for r in run.results:
        if r.extras.get("bytes_moved"):
            check(0 < r.gbps_measured <= limit,
                  f"{r.name} reads {r.gbps_measured:.1f} GB/s, outside "
                  f"(0, {limit:.0f}]")
            ws = r.extras["working_set_bytes"]
            print(f"[paper tables] row={r.name} sweep={r.sweep} "
                  f"pattern={r.pattern} GBps={r.gbps_measured:.1f} "
                  f"us={r.us_per_call:.2f} "
                  f"bytes_moved={r.extras['bytes_moved']} "
                  f"working_set_MiB={ws / 2**20:.1f} "
                  f"working_set_over_l2={ws / L2_BYTES:.2f} "
                  f"paper={ {k: v for k, v in r.extras.items() if k.startswith('paper_')} }",
                  flush=True)
        else:
            print(f"[paper tables] row={r.name} sweep={r.sweep} modelled "
                  + " ".join(f"{k}={r.extras.get(k)}" for k in (
                      "status", "compute_ms", "memory_ms", "dominant",
                      "frac", "reason") if r.extras.get(k) is not None),
                  flush=True)
    k = 11
    rng = np.random.default_rng(21)
    tile = rng.standard_normal((64 + k - 1, 64 + k - 1)).astype(np.float32)
    ker = np.ones((k, k), np.float32) / (k * k)
    got = conv.conv_valid(torch.from_numpy(tile).cuda()[None, None],
                          torch.from_numpy(ker).cuda()[None, None])
    got = got[0, 0].cpu().numpy()
    want = conv.naive_conv(tile, ker)
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=CONV_TOL, atol=CONV_TOL),
          f"conv_xla_fused leaves numpy's 64x64 tile by {err:.3e}")
    print(f"[paper tables] card='{card}' sweeps={','.join(PAPER_SWEEPS)} "
          f"rows={len(run.results)} conv_64x64_max_abs_err={err:.3e} "
          f"(float32, tol {CONV_TOL}) l2_MiB={L2_BYTES / 2**20:.0f} "
          f"seconds={seconds:.2f}", flush=True)


def advisor_phase(cal, card):
    """The advisor's reports for gemma-2b decode_32k and gemma2-27b
    train_4k under the H100's spec and under the calibration: every site
    predicts a bandwidth, and in measured mode carries a ratio."""
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME
    from repro_torch.core.advisor import advise_model, render_report
    from repro_torch.core.memmodel import H100
    t0 = time.perf_counter()
    for arch, shape in ADVISOR_CELLS:
        for mode, kw in (("analytic", dict(spec=H100)),
                         ("measured", dict(calibration=cal))):
            reports = advise_model(ARCHS[arch], SHAPES_BY_NAME[shape], **kw)
            check(all(r.predicted_gbps > 0 for r in reports),
                  f"{arch} {shape} {mode}: a site predicts no bandwidth")
            if mode == "measured":
                check(all(r.measured_vs_predicted is not None
                          for r in reports),
                      f"{arch} {shape}: a site has no meas/pred ratio")
            for line in render_report(reports).splitlines():
                print(f"[advisor] {arch} {shape} {mode}: {line}", flush=True)
    print(f"[advisor] card='{card}' cells={len(ADVISOR_CELLS)} "
          f"fitted_latency_ns={cal.spec.latency_s * 1e9:.1f} "
          f"fitted_hbm_GBps={cal.spec.hbm_bw / 1e9:.1f} "
          f"seconds={time.perf_counter() - t0:.2f}", flush=True)


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
    t_lap = [t_start]

    def lap(name):
        now = time.perf_counter()
        print(f"[phase] {name} seconds={now - t_lap[0]:.1f} "
              f"elapsed={now - t_start:.1f}", flush=True)
        t_lap[0] = now

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
        lap("build")
        drain = drain_lens(np)
        hybrid = hybrid_lens(np)
        err = k1_check(torch, pa, ref, drain, hybrid)
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
                ("gemma-2b-int8-full", [1024] * 8, INT8_GEOMETRY),
                ("recurrentgemma-9b-ring", hybrid,
                 RECURRENTGEMMA_GEOMETRY))]
        lap("K1")
        launches, greedy = serve_phase(torch, np, card)
        parity_phase(torch, np)
        lap("serve, parity")
        gc.collect()                 # the gemma-2b engine and weights go
        torch.cuda.empty_cache()
        k2_err = k2_check(torch, fa, ref)
        k2_timing = k2_time(torch, fa, ref, card)
        k2_launches = dense_serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        dense_parity_phase(torch, np)
        lap("K2, dense serve, dense parity")
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
        lap("K4-K7")
        gc.collect()
        torch.cuda.empty_cache()
        run, mem_launches = memory_phase(torch, card, dict(
            stream_copy=sc, strided_copy=st, random_gather=rg,
            pointer_chase=pc))
        cal = calibrate_phase(run, card)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        paper_tables_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        advisor_phase(cal, card)
        lap("memory, calibrate, paper tables, advisor")
        tune_launches, _ = tune_phase(torch, cal, card)
        k3_err = k3_check(torch, ops, ref, da)
        k3_timing = k3_time(torch, ops, ref, da, card, K3_GEOMETRIES[0])
        k3_time(torch, ops, ref, da, card, K3_GEOMETRIES[1])
        gc.collect()
        torch.cuda.empty_cache()
        k8_err = k8_check(torch, ops, ref, mm)
        k8_timing = k8_time(torch, ops, ref, mm, card)
        lap("tune, K3, K8")
        gc.collect()
        torch.cuda.empty_cache()
        ring_launches = ring_serve_phase(torch, np, card)
        lap("ring serve")
        gc.collect()                 # the 54 GB of gemma2-27b go
        torch.cuda.empty_cache()
        int8_launches, int8_warm = int8_serve_phase(torch, np, card)
        lap("int8 serve")
        gc.collect()
        torch.cuda.empty_cache()
        ring_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        int8_parity_phase(torch, np)
        lap("ring parity, int8 parity")
        gc.collect()
        torch.cuda.empty_cache()
        host_link_phase(torch, card)
        preempt_launches = preempt_serve_phase(torch, np, card, greedy,
                                               int8_warm)
        lap("host link, preempt serve")
        gc.collect()
        torch.cuda.empty_cache()
        preempt_parity_phase(torch, np)
        lap("preempt parity")
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_launches = hybrid_serve_phase(torch, np, card)
        gc.collect()                 # the 17 GB of recurrentgemma-9b go
        torch.cuda.empty_cache()
        ssm_serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        ssm_parity_phase(torch, np)
        lap("hybrid serve, ssm serve, hybrid parity, ssm parity")
        gc.collect()
        torch.cuda.empty_cache()
        prng_phase(torch, np, card)
        sampled_launches = sampled_serve_phase(torch, np, card, greedy)
        lap("prng, sampled serve")
        gc.collect()
        torch.cuda.empty_cache()
        sampled_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        spec_serve_phase(torch, np, card)
        lap("sampled parity, spec serve")
        gc.collect()
        torch.cuda.empty_cache()
        bench_serve_phase(torch, card)
        lap("bench serve")
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
                                "hybrid serve": hybrid_launches,
                                **sampled_launches, **preempt_launches},
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
