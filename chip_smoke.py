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
   pages, window 2048, two rows past the window), granite-moe-3b-a800m's
   (B 8, 24/8 heads: group 3, D 64, 128 pages, the moe serve's lengths)
   and grok-1-314b's (B 4, 48/8: group 6, D 128, softcap 30, the grok
   serve's lengths), each in
   float32 (tolerance 1e-4) and bfloat16 (3e-2; and, held against the
   plain version run in float32 on the same inputs, within one bfloat16
   rounding of its output), each line naming its configuration, split
   count and merge (bfloat16 q with bfloat16 or int8 pages at D 64, 128
   and 256 on the tensor cores);
4. K1 time at the main path's shape (B 8, 128 pages of 8 tokens), full
   and at the serve drain's ragged lengths (its first 8 prompts plus 16
   decoded tokens), then at gemma2-27b's ring and global geometry and at
   gemma-2b's int8 pages (the drain's lengths and full rows of 1024
   tokens), recurrentgemma-9b's ring (group 16, D 256, the hybrid
   serve's lengths at its longest) and granite-moe-3b-a800m's geometry
   (group 3, D 64) at the moe serve's lengths, each beside its plain
   version, one SDPA call on the gathered
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
   window 96, softcap 30, a non-causal cross length, pixtral-12b's
   prefill (B 2, 32/8, causal S 1088, D 128) and seamless-m4t-medium's
   encoder (non-causal 1024^2) and cross-attention (non-causal, 64 rows
   over 1024 frames) at 16/16 heads, D 64, in float32
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
   16 new tokens each, drained twice with identical tokens.  Every decode
   tick must launch K1 once per layer (ring tables on the local layers,
   full tables on the global ones), the ring must turn (a ring page
   reused) and its peak stay within batch x ring_slots; prefix sharing
   stays off on a windowed stack, as in the reference.  A profiled decode window and prefill chunk
   follow;
23. int8 serve: full-width gemma-2b with ``kv_dtype="int8"`` (pages of 16
   tokens, the bf16 page's bytes), the serve phase's first 10 requests
   (the tenth hits the first's prefix pages) drained twice with identical
   tokens; every tick launches K1 once per layer on its tensor-core route
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
28. cluster serve: two full-width gemma-2b (bf16) replicas behind a
   ``ClusterFrontEnd``, sharing one weight tree (the second engine adds
   only its KV pool), batch 8, max_len 1024, window 8 each, draining 16
   open-loop requests (Poisson and bursty arrivals over three Zipf-shared
   256-token prefixes, 16-32 new tokens): undisturbed in chunks of 256
   (every request completes, both replicas serve, prefix pages hit), then
   under cluster_serve's pinned kill schedule (admission refusals, a
   crash, a brownout) in chunks of 64 (failovers, quarantines and retries;
   the requests that part from the undisturbed drain printed); K1 = 18 x
   the ticks of both replicas; TTFT/TPOT p50/p99 in rounds, routed counts,
   tok/s and the host's ms per round printed;
29. disagg serve: a ``DisaggPool`` of 1 prefill and 1 decode engine of the
   same weights, every request shipped, on the cluster's first 8 requests:
   bf16 pages and int8 pages of 16 tokens (scale lanes shipped), tokens
   equal to a colocated engine's, the transfer ledger equal to the page
   geometry, K1 = 18 x the decode engine's ticks; a hand-off's export,
   CRC and import ms beside the cost model's swap time; then every buffer
   corrupted in transit (fallbacks, no corrupted import, requests parted
   printed);
30. cluster parity: 2-layer full-width gemma-2b in float32 on the card and
   on the CPU, greedy and sampled: two replicas undisturbed, under the
   kill schedule and under random crash, brownout and admission faults
   (4 requests), and a ``DisaggPool`` with every transfer corrupted (2
   requests): tokens, keys, every router and engine counter and the
   percentiles card == CPU, and every chaos drain's tokens the
   undisturbed drain's;
31. hybrid serve: full-width recurrentgemma-9b (38 layers: 26 RG-LRU
   layers on dense per-slot state and 12 local-attention layers, 16 query
   heads over one kv head at D 256, window 2048; 17.3 GB of bf16 weights
   drawn on the card) through the paged engine, batch 8, max_len 4096,
   prefill chunks of 256: 8 requests (prompts of 2100 and 2600 tokens
   past the window, six of 64-512), 16 new tokens each, drained twice with
   identical tokens.  No full-attention pool; every decode tick must
   launch K1 once per attention layer (12) on the ring tables, the ring
   must turn and every ring page be back at the end; the warm tick, the ms
   per 256-token chunk and a profiled decode window follow;
32. ssm serve: full-width mamba2-130m (24 SSD layers, no attention)
   through the paged engine with no pool at all: six prompts of 64-512
   tokens and one of 600, 16 new tokens each, drained twice with identical
   tokens and no K1 launch;
33. hybrid parity: recurrentgemma-9b at published widths cut to 5 layers
   (one triple and both remainder RG-LRU layers), float32, window
   narrowed to 32, drained on the card and on the CPU through the paged
   backend (K1) and through the dense backend with ``attn_impl="pallas"``
   (K2 in every prefill's attention layer); the tokens must agree; the
   paged drain again under chaos in recompute mode (the resumed RG-LRU
   state comes from the prefill scan), card == CPU;
34. ssm parity: float32 mamba2-130m at full width, prompts of 300 and 517
   tokens in prefill chunks of 512 (whole and padded SSD chunks of 256),
   drained on the card and on the CPU; the tokens must agree;
35. prng: JAX's threefry keys and bits (``repro_torch.serve.prng``) at
   (8, 256000) on the card exactly equal to the CPU's (bits, ``split``,
   ``fold_in``, ``subkey_chain``, ``uniform``), ``gumbel`` within 2 ulp;
   the sampler at gemma-2b's vocab for (temperature 0.9, top_p 0.95) and
   (temperature 0.8, top_k 50): masks, draws and times;
36. sampled serve: full-width gemma-2b (bf16) through the paged engine
   with each sampling setting (keys seeded with 3), then the first on
   int8 pages: the serve phase's first 8 requests (one batch) with 16 new
   tokens (both for the run's time), each drained twice with identical
   tokens, K1 once a layer on every tick, the warm tick beside the greedy
   tick of phase 5;
37. sampled parity: the parity phase's model and requests sampled with
   (temperature 0.9, top_p 0.95) on the card and on the CPU: tokens and
   final keys must agree;
38. spec serve: full-width gemma-2b in float32, the serve phase's first 8
   requests through the vanilla engine and speculative engines (spec_k 3),
   greedy and sampled, drafting with the target itself and with weights
   from another seed (the draft's dense prefill through K2): tokens equal
   to vanilla, the self-draft's accept rate 1.0, the other draft's
   sampled proposals partly rejected, the pools conserve pages; rounds,
   accepted drafts per round and ms per round printed;
39. bench serve: the ``serve``, ``kernel_plan`` and ``paged_serve`` sweeps
   at card scale (2 trials), twice, persisted under ``build/bench_serve``,
   then ``repro_torch.bench.compare`` between the two runs: every row and
   verdict printed, and ``--gate structural`` (deterministic rows equal,
   no vanished metric) must pass; wall-clock verdicts are advisory; the
   ``spec_serve``, ``dist_serve``, ``preempt_serve``, ``cluster_serve``
   and ``disagg_serve`` sweeps once at card scale (full-width gemma-2b in
   float32, the reference's larger mixes; ``dist_serve`` at the
   reference's config, smoke gemma-2b with 2 kv heads in float32, over
   two shards and two replicas on the one card; ``disagg_serve``'s TP=2
   row, a TP=2 prefill engine shipping to a TP=2 decode engine on the
   same config, both with two shards on the one card, must be there with
   at least one transfer), their gates in the sweeps and every row
   printed;
40. moe serve: full-width granite-moe-3b-a800m (32 layers of 40 experts,
   top 8, d_ff 512; 24/8 heads at D 64; 6.6 GB of bf16 weights drawn on
   the card) through the paged engine under ``moe_impl="sorted"``, batch
   8, max_len 1024, chunks of 256: the serve phase's recipe at granite's
   vocab, its first 10 requests (rid 9 hits rid 0's prefix), 16 new
   tokens each, drained twice with identical tokens; K1 once a layer a
   tick, prefix hits, every page back; the warm tick, a 256-token chunk
   and a profiled decode window of 2 ticks; then one drain under the launcher's
   ``moe_impl="dense"`` on the same weights (tokens not compared: the
   sorted dispatch drops prefill assignments past capacity), its tick
   printed;
41. grok serve: grok-1-314b at its published widths with 64 layers cut to
   2 (the whole model fits no card: its cut is printed), 8 experts of
   d_ff 32768, top 2, GeGLU; 48/8 heads, softcaps 30; 23 GB of bf16
   weights; 4 requests of 64-300 tokens, 8 new tokens each, batch 4,
   paged, sorted, drained once: K1 = 2 x ticks;
42. moe parity: granite-moe-3b-a800m at published widths cut to 4 layers,
   float32, paged drains under ``dense`` and ``sorted`` with chunks of 64
   (padded chunks overflow capacity) on the card and on the CPU: tokens
   and every counter equal; one ``apply_sorted`` at (1, 64, 1536) whose
   last 16 rows are one row (a padded tail): card against CPU within
   1e-4, expert ids equal, the top-k gap and the dropped assignments
   (> 0) printed; smoke grok-1-314b drained under both dispatches, card
   == CPU;
43. frontend serve: full-width pixtral-12b (40 layers, 24.5 GB) prefilled
   through the bundle with ``attn_impl="pallas"``: 1024 patch embeddings
   drawn on the card and 64 tokens, B 2 (K2 = 40 a prefill), 16 tokens
   decoded on the padded dense cache, once; then the
   engine's dense fallback drains 4 text-only requests, 8 new tokens
   each, K2 = 40 a prefill;
44. encdec serve: full-width seamless-m4t-medium (12 + 12 layers)
   prefilled with ``attn_impl="pallas"``: frames (2, 1024, 1024) drawn on
   the card and 64 decoder tokens (K2 = 36 a prefill: encoder, decoder
   self and cross layers), 16 steps decoded on the split cache, once;
45. encdec parity: pixtral-12b cut to 2 layers (64 patches, 16 tokens)
   and seamless-m4t-medium cut to 2 + 2 layers (128 frames, 16 decoder
   tokens) at published widths, float32, ``attn_impl="pallas"`` (K2's
   float32 route on the card): the last prefill logits within 1e-3 and 8
   greedy decode tokens equal, card against CPU;
46. tp serve: full-width phi4-mini-3.8b (32 layers, 24/8 heads, bf16
   weights and pages) through a paged engine at TP=2, both shards on the
   one card (``ServeMesh.tp(2, [cuda:0, cuda:0])``), batch 8, max_len
   1024, chunks of 256, the serve phase's first 8 requests at phi4's
   vocab, 16 new tokens each, after a 2-request warm-up drain; then TP=1
   on the same weights, the same way.  Gated: K1
   = 2 shards x 32 layers x ticks at each shard's Hq 12 / Hkv 4, each
   shard's pools and live bytes half of TP=1's, the shards' tables
   equal, every request at its length; printed, ungated: the share of
   tokens equal to TP=1's and the first divergence (two bf16 partial sums
   round otherwise than one product), and each layout's ms per tick;
47. tp parity: phi4-mini-3.8b at published widths cut to 2 layers,
   float32: the greedy drain's tokens equal on the card at TP=2, on the
   card at TP=1 and on the CPU at TP=1 (K1 = 2 x 2 x ticks at TP=2); a
   paged chunk and 3 decode ticks' logits at TP=2 within 1e-4 of TP=1;
   the sampled drain at TP=2 gives the CPU's tokens and keys;
48. dp serve: a colocated ``build_pool(tp=1, dp=2)`` of full-width
   gemma-2b in bf16 over the one card twice, one weight tree, 8 of the
   serve phase's requests, 16 new tokens each: every stream equals the
   single engine's, both replicas take work, K1 = 18 x the replicas'
   ticks;
49. train: full-width gemma-2b (2.51 B params) trained for 8 steps on
   the card through the training launcher's trainer at its defaults
   (float32, seq 256, batch 8, markov data, fsdp_tp on a 1x1 mesh, lr
   1e-3 under warmup_cosine(10, steps), no checkpoint): loss, grad norm,
   lr and ms per step; the median step time of steps 2-8, tokens/s, the
   training state's bytes, ``max_memory_allocated`` and the step's
   6 N T operations against the float32 peak.  Gated: every loss finite,
   the loss falls over the 8 steps (else over 4 more on one fixed
   batch, said so), TF32 off, and no launch of K1-K8 (the reference's
   training path reaches no Pallas kernel);
50. train parity: gemma-2b at published widths cut to 2 layers, float32,
   the launcher's flags, B 2 x S 32: one step on the card and on the CPU
   from the same params and batch: the loss within 1e-5 relative, each
   gradient leaf within 1e-4 of its largest magnitude, every param after
   AdamW within 2 lr (one sign flip of a near-zero gradient), the share
   apart by more than 1e-6 printed; microbatches=2 against that step
   on the card (loss within 1e-4, params within 2e-3);
51. train recovery: smoke gemma-2b on the card, 6 steps with a
   checkpoint every 2 and failures injected at steps 3 and 5: the
   recovered params equal two uninterrupted runs' within their printed
   run-to-run spread; a checkpoint written on the CPU restores onto the
   card exactly;
52. dp train: ``make_dp_train_step`` with both shards on cuda:0: the
   reference's dp_compression scenario (16x4 least squares, 150 steps,
   lr 0.1) with and without int8 error feedback, each converging by
   more than 100x and the compressed run within 5x of the uncompressed
   one; an uncompressed DP=2 step of smoke gemma-2b against the
   one-device step on the full batch (loss within 1e-5, params within
   2 lr);
53. ckpt serve (in the parity lane): full-width gemma-2b (bf16, 5.0 GB)
   drawn on the card as the serving launcher draws it, saved by the
   port's ``CheckpointManager`` under ``build/ckpt_serve`` as the
   trainer's ``dict(params=...)``, then ``launch.serve.main`` twice at
   the same ``--seed`` (batch 8, max_len 1024, 16 requests, 32 new
   tokens), with ``--ckpt`` and without: every leaf the launcher
   restored equals the drawn one bit for bit, the two summaries agree in
   every count, and K1 = 18 x decode_steps in the ``--ckpt`` drain; save
   and restore seconds and GB/s and ms per tick printed; the directory
   is deleted.

Kernel times are CUDA-event times over back-to-back calls behind a spin
of the card, so they time the card's work, not the host's enqueueing.
A ``[phase]`` line after each group of phases gives its seconds, the
run's elapsed time, the process's peak reserved card memory and the
card's free memory.

Phases that need no result of another phase run beside the main
process once the kernels are timed, the host link measured and ring
serve's weights freed: it starts two lanes, processes of their own on the
same card (``LANES``; ``chip_smoke.py --lane NAME`` runs one), and drives
its other serving phases meanwhile.  The bench lane runs bench serve and
spec serve; then it, the parity lane and the main process, each once its
own phases are done, take the card == CPU phases of ``QUEUE`` one at a
time, heaviest first, each with torch's CPU threads shared among those
taking them.  The main process joins the lanes, prints each lane's log
(``build/smoke_lanes``), fails if a lane failed or a queued phase never
finished, then runs train parity, train and dp train on a card of its
own; a lane that fails ends the run at the main process's next
``[phase]`` line.  Serving walls measured beside the lanes share the
card and the host with them; kernel times, the host link, the main
path's serve and train's step times do not.

It ends with a ``[previous]`` line (K1's, K2's, K3's, K4's and K8's times
before their redesign, and K1's int8 pages on the CUDA cores, as PERF.md
records them: not measured in this run),
the kernels' JSON line (K1, K2, K3, K4 and K8 also carry their design, K7
its latency bound; K1 its launches on each serving path, the sampled,
hybrid, preempted, cluster, disagg, MoE, TP and DP ones included, and its
times at the new geometries; K2 its launches on the dense, frontend and encdec
paths), the card line and the result line.
Any failure exits non-zero before the result line; so does a host without
a card, or a directory without the package.
"""
import gc
import inspect
import json
import math
import os
import shutil
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
# phi4-mini-3.8b's decode geometry at TP=2: each shard's 12 query heads
# over 4 kv heads (group 3) at D 128, pages of 8 at max_len 1024
PHI4_TP2_GEOMETRY = dict(b=8, hq=12, hkv=4, d=128, page=8, n=128,
                         int8=False, kw={})
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


def k1_cases(drain, hybrid, moe, grok):
    """(name, B, Hq, Hkv, D, page, N, valid lengths, kwargs); ``drain``
    holds the serve drain's ragged lengths (:func:`drain_lens`),
    ``hybrid`` the hybrid serve's (:func:`hybrid_lens`), ``moe`` and
    ``grok`` those of the MoE serves (:func:`moe_lens`)."""
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
        # granite-moe-3b-a800m: group 3 (24/8 heads) at D 64, pages of 8 at
        # max_len 1024, the moe serve's lengths; grok-1-314b: group 6
        # (48/8) at D 128, softcap 30, max_len 512, the grok serve's
        ("granite-moe-drain", 8, 24, 8, 64, 8, 128, moe, {}),
        ("grok-1-drain", 4, 48, 8, 128, 8, GROK_MAX_LEN // 8, grok,
         dict(softcap=30.0)),
        # phi4-mini-3.8b at TP=2: each shard's 12/4 heads (group 3) at D
        # 128, pages of 8 at max_len 1024, the tp serve's lengths (the
        # serve drain's), on bf16 and int8 pages
        ("phi4-mini-tp2-drain", 8, 12, 4, 128, 8, 128, drain, {}),
        ("phi4-mini-tp2-drain-int8", 8, 12, 4, 128, 8, 128, drain,
         dict(int8=True)),
    ]


def k1_check(torch, pa, ref, drain, hybrid, moe, grok):
    """Every case in both dtypes against the plain version; returns the
    largest absolute error seen."""
    from repro_torch.kernels import decode_core as core
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for name, b, hq, hkv, d, page, n, vlens, kw in k1_cases(drain, hybrid,
                                                            moe, grok):
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
        # the model paths of every family: pixtral-12b's prefill over 1024
        # patches and 64 tokens (causal, 32/8 heads, D 128), and
        # seamless-m4t-medium's encoder (non-causal 1024^2) and
        # cross-attention (non-causal, 64 decoder rows over 1024 frames)
        # at 16/16 heads, D 64
        ("pixtral-12b", 2, 32, 8, 1088, 1088, 128, {}),
        ("seamless-encoder", 2, 16, 16, 1024, 1024, 64, dict(causal=False)),
        ("seamless-cross", 2, 16, 16, 64, 1024, 64, dict(causal=False)),
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


def serve_runs(torch, eng, reqs, tag, card, n_attn, pa, extra_checks,
               runs=("first", "warm")):
    """Drain ``reqs`` once for each of ``runs`` (first, warm) with K1's
    count set to 0 just before each drain and read just after; checks
    budgets, token range and K1 launches = attention layers x decode ticks
    (ticks > 0), then ``extra_checks(run)``, and that the drains gave the
    same tokens.  Prints one ``[tag]`` line a run; returns the last run's
    launches and its ms per decode tick, ms per prefill chunk, tokens per
    second, page peak and tokens."""
    cfg = eng.bundle.cfg
    launches = 0
    warm = {}
    tokens = []
    for run in runs:
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
    if len(runs) > 1:
        check(all(t == tokens[0] for t in tokens),
              f"{tag}: the drains' tokens differ")
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
    # two prompts past the 4096-token window; 16 new tokens (32 before the
    # cluster phases joined the run: its time)
    reqs = long_requests(np, Request, cfg.vocab_size, (4160, 5120), 16)
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
    decode tick, the serve phase's first ``INT8_REQUESTS`` requests."""
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
                         (0, 9, 12, 15), 32)[:INT8_REQUESTS]
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


# [int8 serve]'s requests: the serve phase's first 10 (16 before the
# cluster phases joined the run: its time).  Rid 9 waits for a slot and
# hits rid 0's prefix pages; the preempt phase's chaos rids (0, 2, 5) are
# among them
INT8_REQUESTS = 10


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
# the cluster front end and the disaggregated pools
# ---------------------------------------------------------------------------

# [cluster serve]'s open-loop traffic: cluster_serve's shape (Poisson and
# bursty arrivals, three Zipf-shared prefixes) with [serve]'s 256-token
# shared prefix and output lengths
CLUSTER_TRAFFIC = dict(seed=23, n_requests=16, rate=1.2, burst_rate_mult=3.0,
                       phase_rounds=4.0, n_prefixes=3, prefix_len=256,
                       tail_lo=3, tail_hi=9, out_lo=16, out_hi=32)
# cluster_serve's pinned kill schedule: an admission refusal on each replica
# at round 0, replica 1 crashes at round 2, replica 0 browns out at round 12
KILL_SCHEDULE = dict(seed=5, crash_rounds=4, brownout_rounds=4,
                     brownout_latency_s=1.0,
                     kill_at=((0, 0, "admit"), (0, 1, "admit"),
                              (2, 1, "crash"), (12, 0, "brownout")))
# the undisturbed cluster drain's and the disagg phase's prefill chunk: a
# prompt (the 256-token prefix and its tail) prefills in 2 rounds, so a
# prefix's pages are registered while later arrivals of its burst still
# come (all 16 arrive in rounds 1-4) and those hit them.  The kill schedule
# drains in chunks of 64 (5 rounds a prompt): there replica 0 still holds a
# request when its brownout quarantines it at round 14 (in chunks of 256
# the drain ends in round 11, and replica 1, which refuses its first
# admission and crashes at round 2, has held no request: nothing would
# fail over)
CLUSTER_CHUNK = 256
KILL_CHUNK = 64
# the reference's random cluster chaos (tests/test_serve_cluster.py)
RANDOM_CLUSTER_CHAOS = dict(seed=12, crash_prob=0.05, crash_rounds=3,
                            brownout_prob=0.05, brownout_rounds=3,
                            brownout_latency_s=1.0, admit_prob=0.1)
# [cluster parity]'s traffic: cluster_serve's at fast, cut to 4 requests of
# 3-6 new tokens (the CPU drains are most of the phase's time; the kill
# schedule still fails one over); the disagg drive takes the first 2
PARITY_TRAFFIC = dict(seed=23, n_requests=4, rate=1.2, burst_rate_mult=3.0,
                      phase_rounds=4.0, n_prefixes=3, prefix_len=16,
                      tail_lo=3, tail_hi=9, out_lo=3, out_hi=6)
PARITY_DISAGG = 2
# the router's counters a cluster drain's line prints
CLUSTER_COUNTERS = ("routed", "completed", "shed", "failovers",
                    "quarantines", "recoveries", "probe_failures",
                    "slow_probes", "retries", "rounds")


def _pct(front):
    return " ".join(f"{k}={v:.2f}" for k, v in front.percentiles().items())


def cluster_serve_phase(torch, np, card):
    """Two full-width gemma-2b (bf16) replicas behind a ``ClusterFrontEnd``,
    one weight tree on the card (the second engine adds its KV pool, not
    the weights), batch 8, max_len 1024, window 8 each, draining
    ``CLUSTER_TRAFFIC`` open-loop: once undisturbed in chunks of
    ``CLUSTER_CHUNK`` (every request completes, both replicas serve,
    prefix pages hit, K1 = 18 x the ticks of both replicas), once under
    cluster_serve's kill schedule in chunks of ``KILL_CHUNK`` (failovers,
    quarantines and retries; the requests whose tokens part from the
    undisturbed drain printed, no gate: other chunks, and a failed-over
    request resumes by recompute, and bf16 rows round by how they were
    computed).  Returns K1's launches of each drain and the model."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import (ClusterChaos, ClusterChaosConfig,
                                   ClusterFrontEnd, ServeEngine,
                                   TrafficConfig, generate_traffic)

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg)
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    Timed = timed_engine_class(torch, ServeEngine)
    launches, tokens = {}, {}
    for label, chunk, chaos in (
            ("undisturbed", CLUSTER_CHUNK, None),
            ("kill schedule", KILL_CHUNK,
             ClusterChaos(ClusterChaosConfig(**KILL_SCHEDULE)))):
        engines = [Timed(bundle, params, 8, 1024, prefill_chunk=chunk)]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        engines.append(Timed(bundle, params, 8, 1024, prefill_chunk=chunk))
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - before
        check(engines[1].params is engines[0].params and grew < weights / 10,
              f"cluster serve: the second replica added {grew} bytes beside "
              f"{weights} bytes of weights")
        if chaos is None:
            print(f"[cluster serve] replicas=2 one weight tree: the second "
                  f"engine added {grew / 2**30:.3f} GiB (its KV pool "
                  f"{engines[1].kv_bytes() / 2**30:.3f} GiB) beside "
                  f"{weights / 1e9:.2f} GB of weights", flush=True)
        front = ClusterFrontEnd(engines)
        front.reset()
        sched = generate_traffic(TrafficConfig(**CLUSTER_TRAFFIC),
                                 cfg.vocab_size)
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        front.run(sched, chaos=chaos)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st, c = front.stats(), front.cstats
        reqs = [r for _, r in sched]
        ticks = [e.stats.decode_steps for e in engines]
        check(c.completed == len(reqs) and all(
            len(r.out_tokens) == r.max_new_tokens for r in reqs),
            f"cluster serve {label}: {c.completed} of {len(reqs)} requests "
            "completed their budgets")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens), f"cluster serve {label}: token "
              "out of range")
        check(pa.LAUNCHES == cfg.num_layers * sum(ticks) and sum(ticks) > 0,
              f"cluster serve {label}: K1 launches {pa.LAUNCHES} != "
              f"{cfg.num_layers} x {sum(ticks)} ticks")
        tokens[label] = [list(r.out_tokens) for r in reqs]
        launches["cluster serve" + ("" if chaos is None
                                    else f" {label}")] = pa.LAUNCHES
        if chaos is None:
            check(all(rep.routed > 0 for rep in front.replicas),
                  "cluster serve: a replica served nothing")
            check(st.prefix_hit_tokens > 0, "cluster serve: no prefix hit")
            parted = "n/a"
        else:
            check(c.failovers >= 1 and c.quarantines >= 1 and c.retries >= 1,
                  f"cluster serve kill schedule: failovers={c.failovers} "
                  f"quarantines={c.quarantines} retries={c.retries}")
            parted = sum(a != b for a, b in zip(tokens[label],
                                                tokens["undisturbed"]))
        decode_s = sum(e.decode_s for e in engines)
        prefill_s = sum(e.prefill_s for e in engines)
        print(f"[cluster serve] card='{card}' drain='{label}' arch=gemma-2b "
              f"dtype=bfloat16 replicas=2 requests={len(reqs)} batch=8 "
              f"max_len=1024 window=8 prefill_chunk={chunk} "
              f"seconds={dt:.3f} "
              f"tok_s={st.tokens_out / dt:.1f} "
              f"ms_per_round={1e3 * dt / c.rounds:.1f} "
              f"ticks={'+'.join(map(str, ticks))} "
              f"ms_per_decode_tick={1e3 * decode_s / sum(ticks):.3f} "
              f"prefill_chunks={st.prefill_chunks} ms_per_prefill_chunk="
              f"{1e3 * prefill_s / max(1, st.prefill_chunks):.3f} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"routed_per_replica="
              f"{'/'.join(str(rep.routed) for rep in front.replicas)} "
              + " ".join(f"{k}={getattr(c, k)}" for k in CLUSTER_COUNTERS)
              + f" recompute_resumes={st.recompute_resumes} "
              f"preempt_restarts={st.preempt_restarts} {_pct(front)} "
              f"(rounds) k1_launches={pa.LAUNCHES} requests_parted={parted}",
              flush=True)
        del front, engines
    return launches, (bundle, params)


def disagg_serve_phase(torch, np, card, bundle, params):
    """A ``DisaggPool`` of 1 prefill and 1 decode engine of full-width
    gemma-2b (the cluster phase's weight tree) with ``force="disagg"``, on
    ``CLUSTER_TRAFFIC``'s first 8 requests, submitted at once: bf16 pages
    and int8 pages of 16 tokens (their scale lanes shipped), each drain's
    tokens equal to a colocated engine's (pages ship bit for bit), the
    transfer ledger equal to the geometry (2 x the power-of-two padded
    pages x bytes a page, a hand-off), K1 = 18 x the decode engine's
    ticks (the prefill engine decodes nothing).  A hand-off's export
    (gather to pinned host memory), CRC and import (scatter) ms beside the
    pool's ``SwapCostModel.swap_s`` at the mean prompt.  Then every
    buffer corrupted in transit: fallbacks, no import of a corrupted
    buffer, the requests that part (bf16 recompute) printed."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import (DisaggChaos, DisaggChaosConfig,
                                   DisaggConfig, DisaggPool, ServeEngine,
                                   TrafficConfig, generate_traffic, hosttier)
    from repro_torch.tune.plan import next_pow2

    cfg = bundle.cfg
    int8 = build(cfg, RuntimeFlags(kv_dtype="int8"))
    Timed = swap_timed_engine_class(torch, ServeEngine)

    def batch():
        sched = generate_traffic(TrafficConfig(**CLUSTER_TRAFFIC),
                                 cfg.vocab_size)
        return [r for _, r in sched[:8]]

    def run(target, chaos=None):
        reqs = batch()
        submit = getattr(target, "submit", None) or target.add_request
        for r in reqs:
            submit(r)
        pa.reset_launches()
        with CrcClock(hosttier) as crc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if isinstance(target, DisaggPool):
                target.run(chaos=chaos)
            else:
                target.run_to_completion()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              "disagg serve: a request missed its budget")
        return reqs, [list(r.out_tokens) for r in reqs], dt, crc

    launches = {}
    for kv, b, kw in (("bfloat16", bundle, dict(prefill_chunk=CLUSTER_CHUNK)),
                      ("int8", int8, dict(page_size=16,
                                          prefill_chunk=CLUSTER_CHUNK))):
        _, want, _, _ = run(Timed(b, params, 8, 1024, **kw))
        pool = DisaggPool([Timed(b, params, 8, 1024, **kw)],
                          [Timed(b, params, 8, 1024, **kw)],
                          DisaggConfig(force="disagg"))
        reqs, got, dt, crc = run(pool)
        st, d = pool.stats(), pool.dstats
        pe, de = pool.prefill_engines[0], pool.decode_engines[0]
        check(got == want, f"disagg serve {kv}: tokens differ from the "
              "colocated drain's")
        check(st.prefill_exports == st.prefill_imports == len(reqs)
              and st.transfer_fallbacks == 0, f"disagg serve {kv}: "
              f"{st.prefill_exports} exports, {st.prefill_imports} imports")
        check(pe.stats.decode_steps == 0 and pa.LAUNCHES
              == cfg.num_layers * de.stats.decode_steps > 0,
              f"disagg serve {kv}: K1 launches {pa.LAUNCHES} != "
              f"{cfg.num_layers} x {de.stats.decode_steps} decode ticks")
        geometry = 2 * sum(next_pow2(max(1, -(-len(r.prompt) // de.page)))
                           * de.bytes_per_page for r in reqs)
        check(st.transfer_bytes == geometry, f"disagg serve {kv}: transfer "
              f"bytes {st.transfer_bytes} != geometry {geometry}")
        if kv == "int8":
            check(de.cache["blocks"]["p0"]["k_scale"].dtype == torch.float32,
                  "disagg serve int8: no scale lanes")
        mean = int(round(sum(len(r.prompt) for r in reqs) / len(reqs)))
        cm = pool.cost_model
        launches["disagg serve" + (" int8" if kv == "int8" else "")] = \
            pa.LAUNCHES
        print(f"[disagg serve] card='{card}' kv_dtype={kv} page={de.page} "
              f"requests={len(reqs)} force=disagg seconds={dt:.3f} "
              f"tok_s={st.tokens_out / dt:.1f} rounds={d.rounds} "
              f"transfers={d.transfers} transfer_bytes={st.transfer_bytes} "
              f"geometry_bytes={geometry} export_ms_per_handoff="
              f"{1e3 * pe.gather_s / pe.gathers:.3f} import_ms_per_handoff="
              f"{1e3 * de.scatter_s / de.scatters:.3f} crc_ms_per_handoff="
              f"{1e3 * crc.s / d.transfers:.3f} crcs={crc.n} "
              f"model_swap_ms={1e3 * cm.swap_s(mean):.3f} "
              f"model_reprefill_ms={1e3 * cm.recompute_s(mean):.3f} "
              f"(pool link {cm.host_link_bw / 1e9:.0f} GB/s, H100 spec, "
              f"{mean} tokens) decode_ticks={de.stats.decode_steps} "
              f"ms_per_decode_tick="
              f"{1e3 * de.decode_s / de.stats.decode_steps:.3f} "
              f"{_pct(pool)} (rounds) equals_colocated=True "
              f"k1_launches={pa.LAUNCHES}", flush=True)
        if kv == "bfloat16":
            pool.reset()
            chaos = DisaggChaos(DisaggChaosConfig(seed=5, corrupt_prob=1.0))
            _, bad, dt, _ = run(pool, chaos)
            st = pool.stats()
            check(chaos.corruptions >= 1 and st.transfer_fallbacks >= 1
                  and st.prefill_imports == 0, f"disagg serve corrupted: "
                  f"corruptions={chaos.corruptions} fallbacks="
                  f"{st.transfer_fallbacks} imports={st.prefill_imports}")
            check(pa.LAUNCHES == cfg.num_layers * de.stats.decode_steps,
                  "disagg serve corrupted: K1 missed a tick")
            launches["disagg serve corrupted"] = pa.LAUNCHES
            print(f"[disagg serve] card='{card}' kv_dtype={kv} "
                  f"corrupt_prob=1.0 seconds={dt:.3f} "
                  f"corruptions={chaos.corruptions} "
                  f"transfer_fallbacks={st.transfer_fallbacks} "
                  f"prefill_imports={st.prefill_imports} "
                  f"recompute_resumes={st.recompute_resumes} "
                  f"requests_parted={sum(a != b for a, b in zip(bad, want))}"
                  f" of {len(want)} (bf16: a recomputed row rounds as a "
                  f"prefill chunk's) k1_launches={pa.LAUNCHES}", flush=True)
        del pool
    return launches


def cluster_parity_phase(torch, np):
    """Full-width 2-layer gemma-2b in float32, the same weights on the card
    and on the CPU, greedy and sampled (keys seeded 3): two replicas drain
    ``PARITY_TRAFFIC`` undisturbed, under the kill schedule and under the
    reference's random cluster chaos; a ``DisaggPool`` drains its first
    ``PARITY_DISAGG`` requests with every transfer corrupted.  Card == CPU
    in tokens, keys, every ClusterStats, DisaggStats and ServeStats field
    and the percentiles; every chaos drain's tokens are the undisturbed
    drain's (the disagg drive's, its requests'); K1 once a layer on every
    card tick."""
    import dataclasses

    from repro_torch.configs import ARCHS, override
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build
    from repro_torch.serve import (ClusterChaos, ClusterChaosConfig,
                                   ClusterFrontEnd, DisaggChaos,
                                   DisaggChaosConfig, DisaggConfig,
                                   DisaggPool, ServeEngine, TrafficConfig,
                                   generate_traffic)
    from repro_torch.serve.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    card_bundle = build(cfg, device="cuda")
    card_params = card_bundle.init(
        torch.Generator(device="cuda").manual_seed(1))
    sides = (("cuda", card_bundle, card_params),
             ("cpu", build(cfg, device="cpu"), _to(card_params, "cpu")))
    drives = (("undisturbed", None), ("kill schedule", KILL_SCHEDULE),
              ("random chaos", RANDOM_CLUSTER_CHAOS),
              ("disagg corrupted", 1.0))
    for label, sp in (("greedy", {}), ("sampled", SAMPLINGS[0])):
        rec = {}
        for dev, bundle, p in sides:
            def make(bundle=bundle, p=p, dev=dev):
                return ServeEngine(bundle, p, 2, 64, window=4,
                                   prefill_chunk=8, seed=3, device=dev,
                                   sampling=SamplingParams(**sp))
            front = ClusterFrontEnd([make(), make()])
            pool = DisaggPool([make()], [make()],
                              DisaggConfig(force="disagg"))
            for drive, chaos in drives:
                sched = generate_traffic(TrafficConfig(**PARITY_TRAFFIC),
                                         cfg.vocab_size)
                pa.reset_launches()
                if drive.startswith("disagg"):
                    target = pool
                    pool.reset()
                    reqs = [r for _, r in sched[:PARITY_DISAGG]]
                    for r in reqs:
                        pool.submit(r)
                    ch = DisaggChaos(DisaggChaosConfig(seed=5,
                                                       corrupt_prob=chaos))
                    pool.run(chaos=ch)
                    router = dataclasses.asdict(pool.dstats)
                    faults = ch.corruptions
                else:
                    target = front
                    front.reset()
                    ch = (None if chaos is None else
                          ClusterChaos(ClusterChaosConfig(**chaos)))
                    front.run(sched, chaos=ch)
                    router = dataclasses.asdict(front.cstats)
                    faults = (None if ch is None else
                              (ch.crashes, ch.brownouts, ch.admit_faults))
                    reqs = [r for _, r in sched]
                engines = target.engines
                ticks = sum(e.stats.decode_steps for e in engines)
                if dev == "cuda":
                    check(pa.LAUNCHES == cfg.num_layers * ticks and ticks > 0,
                          f"cluster parity {label} {drive}: K1 launches "
                          f"{pa.LAUNCHES} != {cfg.num_layers} x {ticks}")
                check(all(r.done for r in reqs), f"cluster parity {label} "
                      f"{drive} {dev}: a request did not finish")
                rec[(dev, drive)] = dict(
                    tokens=[list(r.out_tokens) for r in reqs],
                    keys=torch.cat([e.keys.cpu() for e in engines]),
                    stats=[dataclasses.asdict(e.stats) for e in engines],
                    router=router, faults=faults,
                    pct=target.percentiles())
            del front, pool
        for drive, _ in drives:
            g, c = rec[("cuda", drive)], rec[("cpu", drive)]
            same = {k: (bool(torch.equal(g[k], c[k])) if k == "keys"
                        else g[k] == c[k]) for k in g}
            want = rec[("cuda", "undisturbed")]["tokens"][:len(g["tokens"])]
            equal_base = g["tokens"] == want
            router = g["router"]
            print(f"[cluster parity] arch=gemma-2b full width, 2 layers, "
                  f"float32, {label} drive='{drive}' "
                  f"requests={len(g['tokens'])} cuda_equals_cpu="
                  f"{all(same.values())} "
                  + " ".join(f"{k}_equal={v}" for k, v in same.items())
                  + f" equals_undisturbed={equal_base} "
                  f"faults={g['faults']} "
                  + " ".join(f"{k}={router[k]}" for k in router
                             if k in CLUSTER_COUNTERS + ("transfers",))
                  + " " + " ".join(f"{k}={v:.2f}"
                                   for k, v in g["pct"].items()), flush=True)
            check(all(same.values()), f"cluster parity {label} {drive}: "
                  "card and CPU differ in "
                  f"{[k for k, v in same.items() if not v]}")
            check(equal_base, f"cluster parity {label} {drive}: tokens "
                  "differ from the undisturbed drain's")
        k = rec[("cuda", "kill schedule")]["router"]
        check(k["failovers"] >= 1 and k["quarantines"] >= 1,
              f"cluster parity {label}: the kill schedule failed nothing over")
        check(sum(rec[("cuda", "random chaos")]["faults"]) > 0,
              f"cluster parity {label}: the random chaos fired nothing")
        d = rec[("cuda", "disagg corrupted")]["stats"]
        check(sum(s["transfer_fallbacks"] for s in d) >= 1
              and sum(s["prefill_imports"] for s in d) == 0,
              f"cluster parity {label}: corrupted transfers landed")


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

SAMPLED_NEW = 16                   # [sampled serve]'s new tokens
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
    the serve phase's first 8 requests (one batch, to keep the run inside
    its time) with each setting and then with the first setting on int8
    pages of 16 tokens, 16 new tokens each (the run's time); each
    drained twice with identical tokens, K1 once a layer on every tick,
    the warm tick beside the greedy one."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg)
    int8 = build(cfg, RuntimeFlags(kv_dtype="int8"))
    reqs = make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), SAMPLED_NEW)
    launches = {}
    runs = [(b, p, {}, "bf16") for b, p in ((bundle, SAMPLINGS[0]),
                                            (bundle, SAMPLINGS[1]))]
    runs.append((int8, SAMPLINGS[0], dict(page_size=16), "int8"))
    for b, sp, kw, kv in runs:
        batch = reqs[:8]
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
              f"requests={len(batch)} new_tokens={SAMPLED_NEW} "
              f"first_equals_warm=True "
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


BENCH_SWEEPS = ("serve", "kernel_plan", "paged_serve")
# run once, after the comparison (the run's time): their gates are in-sweep
# (spec_serve ran in both compared runs before the cluster phases joined)
BENCH_ONCE = ("spec_serve", "dist_serve", "preempt_serve", "cluster_serve",
              "disagg_serve")


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
        # dist_serve spreads over two shards (and two replicas) on the
        # one card
        run = run_sweeps(names=names, fast=False, out_dir=out,
                         device="cuda", devices=tp_devices(torch))
        check(not run.failures, f"bench serve run {i}: sweeps failed "
              f"{sorted(run.failures)}: {run.failures}")
        paths.append(run.env["path"])
        det = {r.name: r.gbps_measured for r in run.results
               if r.extras.get("deterministic")}
        print(f"[bench serve] run={i} rows={len(run.results)} "
              f"seconds={time.perf_counter() - t0:.2f} deterministic={det} "
              f"path={os.path.relpath(paths[-1], ROOT)}", flush=True)
        if names == BENCH_ONCE:
            for r in run.results:
                extras = {k: v for k, v in r.extras.items() if k != "metric"}
                print(f"[bench serve] row={r.name} us={r.us_per_call:.1f} "
                      f"value={r.gbps_measured:.6g} {extras}", flush=True)
            tp2 = run.by_name().get("disagg_serve_tp2_bitwise")
            check(tp2 is not None and tp2.extras["transfers"] >= 1,
                  "bench serve run 3: no disagg_serve_tp2_bitwise row with "
                  "a transfer over the two shards")
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

# ---------------------------------------------------------------------------
# every model family: MoE layers, the patch prefix, the encoder-decoder
# ---------------------------------------------------------------------------

# granite-moe-3b-a800m's attention layers: 24 query heads over 8 kv heads
# (group 3) at D 64, pages of 8 tokens at max_len 1024
GRANITE_GEOMETRY = dict(b=8, hq=24, hkv=8, d=64, page=8, n=128, int8=False,
                        kw={})
MOE_NEW = 16                       # [moe serve]'s new tokens a request
MOE_REQUESTS = 10
GROK_LAYERS = 2                    # grok-1-314b's 64 layers cut to 2
GROK_MAX_LEN = 512
GROK_NEW = 8
PIXTRAL_PATCHES, PIXTRAL_TOKENS = 1024, 64
SEAMLESS_FRAMES, SEAMLESS_TOKENS = 1024, 64
DECODE_STEPS = 16                  # decode ticks after a bundle prefill
PARITY_DECODE = 8
LOGIT_TOL = 1e-3                   # float32 last logits, card against CPU
MOE_TOL = 1e-4                     # float32 apply_sorted, card against CPU


def moe_requests(np, vocab):
    """``[moe serve]``'s requests: ``[serve]``'s recipe at granite's vocab,
    its first 10 (as ``[int8 serve]``: rid 9 waits for a slot and hits rid
    0's 256-token prefix; the first 8 alone share none), 16 new tokens
    each."""
    from repro_torch.serve import Request
    return make_requests(np, Request, vocab, 0, 16, (64, 513), 256,
                         (0, 9, 12, 15), MOE_NEW)[:MOE_REQUESTS]


def grok_requests(np, vocab):
    """``[grok serve]``'s 4 requests of 64-300 tokens, two sharing a
    64-token prefix, 8 new tokens each."""
    from repro_torch.serve import Request
    return make_requests(np, Request, vocab, 3, 4, (64, 301), 64, (0, 3),
                         GROK_NEW)


def moe_lens(np):
    """K1's lengths at the end of ``[moe serve]`` (its first 8 prompts, the
    batch's first slots) and ``[grok serve]``."""
    from repro_torch.configs import ARCHS
    return ([r.prompt.shape[0] + MOE_NEW for r in moe_requests(
                np, ARCHS["granite-moe-3b-a800m"].vocab_size)[:8]],
            [r.prompt.shape[0] + GROK_NEW for r in grok_requests(
                np, ARCHS["grok-1-314b"].vocab_size)])


def _prepare_short_decode(eng, reqs):
    """As :func:`_prepare_decode`, for a window of 2 ticks: a MoE tick
    runs about 100 ops a layer, and the profiler's host-side bookkeeping
    grows with the events it records (an 8-tick granite window holds about
    50,000 of them)."""
    _prepare_decode(eng, reqs)
    return lambda: eng.decode_many(2)


def moe_serve_phase(torch, np, card):
    """Full-width granite-moe-3b-a800m (32 layers of 40 experts, top 8) on
    the paged engine under the sorted dispatch, K1 on every attention
    layer at D 64 with 3 query heads a kv head; then one warm drain under
    the launcher's dense dispatch on the same weights."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_core as core
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags, build, moe
    from repro_torch.serve import ServeEngine

    cfg = ARCHS["granite-moe-3b-a800m"]
    bundle, params = load_model(torch, cfg, RuntimeFlags(moe_impl="sorted"))
    engine = timed_engine_class(torch, ServeEngine)
    eng = engine(bundle, params, 8, 1024, prefill_chunk=256)
    reqs = moe_requests(np, cfg.vocab_size)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = pa.route(torch.bfloat16, torch.bfloat16, cfg.resolved_head_dim)
    splits = pa.split_count(route, eng.bsz, cfg.num_kv_heads, eng.page,
                            eng.pages_per_seq, sms)
    k, e, cf = (cfg.num_experts_per_tok, cfg.num_experts,
                cfg.moe_capacity_factor)
    group = inspect.signature(moe.apply_sorted).parameters[
        "group_size"].default
    print(f"[moe serve] experts={e} top_k={k} d_ff={cfg.d_ff} "
          f"activation={cfg.activation} moe_impl=sorted "
          f"group={group} capacity_factor={cf} "
          f"cap_decode={moe.capacity(k, 1, cf, e)} "
          f"cap_256_chunk={moe.capacity(k, 256, cf, e)} K1 route={route} "
          f"group={cfg.num_heads // cfg.num_kv_heads} "
          f"D={cfg.resolved_head_dim} N={eng.pages_per_seq} splits={splits} "
          f"merge={core.merge_kind(route, splits)} "
          f"lens_at_end={moe_lens(np)[0]}", flush=True)

    def checks(run):
        check(eng.stats.prefix_hit_tokens > 0,
              f"moe serve {run}: no prefix hit on shared prompts")
        check(pages_conserved(eng),
              f"moe serve {run}: pages not all back at the end")
        return " pages_back=True"

    launches, warm = serve_runs(torch, eng, reqs, "moe serve", card,
                                cfg.num_layers, pa, checks)
    print(f"[moe serve] warm moe_impl=sorted "
          f"ms_per_decode_tick={warm['tick_ms']:.3f} "
          f"ms_per_256_token_chunk={warm['chunk_ms']:.3f} card='{card}'",
          flush=True)
    for line in profile_window(torch, eng, reqs, steps=(
            ("decode window of 2 ticks", _prepare_short_decode),)):
        print(line.replace("[profile]",
                           "[profile] arch=granite-moe-3b-a800m moe=sorted"),
              flush=True)
    del eng
    # the launcher's dispatch on the same weights, one drain on the warm
    # card; its tokens are not compared with the sorted ones (the sorted
    # dispatch drops prefill assignments past capacity)
    dense = engine(build(cfg, RuntimeFlags(moe_impl="dense")), params, 8,
                   1024, prefill_chunk=256)
    pa.reset_launches()
    dt = drain(torch, dense, reqs)
    st = dense.stats
    check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
          "moe serve dense: a request missed its budget")
    check(pa.LAUNCHES == cfg.num_layers * st.decode_steps > 0,
          f"moe serve dense: K1 launches {pa.LAUNCHES} != "
          f"{cfg.num_layers} x {st.decode_steps} decode ticks")
    print(f"[moe serve] run=warm moe_impl=dense (the launcher's) "
          f"card='{card}' tokens_out={st.tokens_out} seconds={dt:.3f} "
          f"tok_s={st.tokens_out / dt:.1f} decode_steps={st.decode_steps} "
          f"ms_per_decode_tick={1e3 * dense.decode_s / st.decode_steps:.3f} "
          f"ms_per_256_token_chunk="
          f"{1e3 * dense.prefill_s / st.prefill_chunks:.3f} "
          f"k1_launches={pa.LAUNCHES} (tokens not compared with sorted: "
          f"prefill capacity drops differ)", flush=True)
    return {"moe serve": launches, "moe serve dense": pa.LAUNCHES}


def grok_serve_phase(torch, np, card):
    """grok-1-314b at its published widths, 2 of its 64 layers: 8 experts
    of d_ff 32768 (top 2, GeGLU), K1 at 48/8 heads, D 128, softcap 30."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import ServeEngine

    full = ARCHS["grok-1-314b"]
    cfg = override(full, num_layers=GROK_LAYERS)
    bundle, params = load_model(torch, cfg, RuntimeFlags(moe_impl="sorted"))
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 4,
                                                 GROK_MAX_LEN,
                                                 prefill_chunk=256)
    reqs = grok_requests(np, cfg.vocab_size)
    print(f"[grok serve] depth cut: num_layers {full.num_layers}->"
          f"{GROK_LAYERS} (the whole model's {full.param_count()[0] / 1e9:.0f}B "
          f"parameters, {2 * full.param_count()[0] / 1e9:.0f} GB in bf16, fit "
          f"no card); experts={cfg.num_experts} top_k="
          f"{cfg.num_experts_per_tok} d_ff={cfg.d_ff} "
          f"activation={cfg.activation} moe_impl=sorted "
          f"softcap={cfg.attn_logit_softcap} "
          f"final_softcap={cfg.final_logit_softcap} K1 group="
          f"{cfg.num_heads // cfg.num_kv_heads} D={cfg.resolved_head_dim} "
          f"lens_at_end={moe_lens(np)[1]}", flush=True)

    def checks(run):
        check(pages_conserved(eng),
              f"grok serve {run}: pages not all back at the end")
        return " pages_back=True"

    launches, _ = serve_runs(torch, eng, reqs, "grok serve", card,
                             cfg.num_layers, pa, checks, runs=("first",))
    return {"grok serve": launches}


def prefill_then_decode(torch, bundle, params, batch, steps):
    """Prefill ``batch`` through the bundle, write its cache into a decode
    cache of ``steps`` more rows (an encoder-decoder's split cache keeps
    the frames' cross rows), then decode ``steps`` greedy tokens at per-slot
    positions.  Returns (last prefill logits, tokens (B, steps), prefill
    seconds, seconds a decode step, the prefill's K2 launches); a decode
    step must launch no K2 (one query takes ``naive``)."""
    from repro_torch.kernels import flash_attention as fa
    cfg = bundle.cfg
    dev = bundle.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fa.reset_launches()
    sync()
    t0 = time.perf_counter()
    new, logits = bundle.prefill(params, batch)
    sync()
    prefill_s = time.perf_counter() - t0
    k2 = fa.LAUNCHES
    b = logits.shape[0]
    if cfg.enc_dec:
        s = batch["dec_tokens"].shape[1]
        cache = bundle.init_cache(b, s + steps, batch["frames"].shape[1])
        layers, new = cache["dec"], new["dec"]
    else:
        s = batch["tokens"].shape[1] + batch["patch_embeds"].shape[1]
        cache = bundle.init_cache(b, s + steps)
        layers, new = cache["blocks"]["p0"], new["blocks"]["p0"]
    for n, t in new.items():
        layers[n][:, :, :t.shape[2]] = t
    tok = logits.argmax(-1)[:, None]
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = []
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = bundle.decode_step(params, cache, tok, pos)
        tok = lg.argmax(-1)[:, None]
        out.append(tok)
        pos = pos + 1
    sync()
    step_s = (time.perf_counter() - t0) / steps
    check(fa.LAUNCHES == k2, f"{cfg.name}: a decode step launched K2")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(lg).all()),
          f"{cfg.name}: non-finite logits")
    return logits, torch.cat(out, dim=1), prefill_s, step_s, k2


def frontend_serve_phase(torch, np, card):
    """Full-width pixtral-12b: 1024 patch embeddings drawn on the card and
    64 tokens prefilled through the bundle under ``attn_impl="pallas"``
    (K2 on all 40 layers at S 1088), 16 tokens decoded on the padded
    dense cache, once; then the engine's dense
    fallback drains 4 text-only requests (prefill through K2)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import RuntimeFlags
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["pixtral-12b"]
    bundle, params = load_model(torch, cfg, RuntimeFlags(attn_impl="pallas"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = dict(
        patch_embeds=torch.randn((2, PIXTRAL_PATCHES, cfg.d_model),
                                 generator=gen, device="cuda"
                                 ).to(torch.bfloat16),
        tokens=torch.randint(0, cfg.vocab_size, (2, PIXTRAL_TOKENS),
                             generator=gen, device="cuda"))
    _, _, pre_s, step_s, launches = prefill_then_decode(
        torch, bundle, params, batch, DECODE_STEPS)
    check(launches == cfg.num_layers, f"frontend serve: K2 launches "
          f"{launches} != {cfg.num_layers} layers a prefill")
    print(f"[frontend serve] card='{card}' arch={cfg.name} "
          f"B=2 patches={PIXTRAL_PATCHES} tokens={PIXTRAL_TOKENS} "
          f"S={PIXTRAL_PATCHES + PIXTRAL_TOKENS} attn_impl=pallas "
          f"prefill_ms={1e3 * pre_s:.3f} k2_launches={launches} "
          f"decode_steps={DECODE_STEPS} "
          f"ms_per_decode_step={1e3 * step_s:.3f} (dense cache of "
          f"{PIXTRAL_PATCHES + PIXTRAL_TOKENS + DECODE_STEPS} rows; one "
          "run, its first)", flush=True)
    eng = timed_engine_class(torch, ServeEngine)(bundle, params, 4, 1024)
    check(eng.backend == "dense", f"frontend serve: the engine chose "
          f"{eng.backend}, not the dense fallback")
    reqs = make_requests(np, Request, cfg.vocab_size, 4, 4, (64, 513), 0, (),
                         PARITY_DECODE)
    fa.reset_launches()
    dt = drain(torch, eng, reqs)
    st = eng.stats
    check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
          "frontend serve drain: a request missed its budget")
    check(fa.LAUNCHES == cfg.num_layers * st.prefills == cfg.num_layers * 4,
          f"frontend serve drain: K2 launches {fa.LAUNCHES} != "
          f"{cfg.num_layers} x {st.prefills} prefills")
    launches += fa.LAUNCHES
    print(f"[frontend serve] drain backend={eng.backend} (the dense "
          f"fallback: a frontend stack is not paged) requests={len(reqs)} "
          f"text-only prompts={[r.prompt.shape[0] for r in reqs]} "
          f"tokens_out={st.tokens_out} seconds={dt:.3f} "
          f"ms_per_prefill={1e3 * eng.prefill_s / st.prefills:.3f} "
          f"ms_per_decode_tick={1e3 * eng.decode_s / st.decode_steps:.3f} "
          f"k2_launches={fa.LAUNCHES} card='{card}'", flush=True)
    return {"frontend serve": launches}


def encdec_serve_phase(torch, np, card):
    """Full-width seamless-m4t-medium: frames (2, 1024, 1024) drawn on the
    card and 64 decoder tokens prefilled under ``attn_impl="pallas"``
    (K2 on 12 encoder layers, non-causal 1024^2, 12 decoder self layers,
    causal 64^2, and 12 cross layers, 64 x 1024), 16 steps decoded on the
    split cache, once."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import RuntimeFlags

    cfg = ARCHS["seamless-m4t-medium"]
    bundle, params = load_model(torch, cfg, RuntimeFlags(attn_impl="pallas"))
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = dict(
        frames=torch.randn((2, SEAMLESS_FRAMES, cfg.d_model), generator=gen,
                           device="cuda").to(torch.bfloat16),
        dec_tokens=torch.randint(0, cfg.vocab_size, (2, SEAMLESS_TOKENS),
                                 generator=gen, device="cuda"))
    want = cfg.num_encoder_layers + 2 * cfg.num_layers
    _, _, pre_s, step_s, launches = prefill_then_decode(
        torch, bundle, params, batch, DECODE_STEPS)
    check(launches == want, f"encdec serve: K2 launches {launches} != "
          f"{want} (encoder, decoder self and cross layers) a prefill")
    print(f"[encdec serve] card='{card}' arch={cfg.name} "
          f"encoder_layers={cfg.num_encoder_layers} "
          f"decoder_layers={cfg.num_layers} B=2 "
          f"frames={SEAMLESS_FRAMES} dec_tokens={SEAMLESS_TOKENS} "
          f"attn_impl=pallas prefill_ms={1e3 * pre_s:.3f} "
          f"k2_launches={launches} decode_steps={DECODE_STEPS} "
          f"ms_per_decode_step={1e3 * step_s:.3f} (split cache: "
          f"{SEAMLESS_TOKENS + DECODE_STEPS} self rows, "
          f"{SEAMLESS_FRAMES} cross rows; one run, its first)", flush=True)
    return {"encdec serve": launches}


def moe_parity_phase(torch, np):
    """granite-moe-3b-a800m at published widths cut to 4 layers, float32,
    paged drains under both dispatches with chunks of 64 (padded chunks
    overflow capacity), card == CPU in tokens and counters;
    ``apply_sorted`` on one input card against CPU; smoke grok-1-314b's
    drains under both dispatches."""
    from repro_torch.configs import ARCHS, override, smoke_config
    from repro_torch.models import RuntimeFlags, moe
    from repro_torch.serve import Request

    cfg = override(ARCHS["granite-moe-3b-a800m"], num_layers=4,
                   param_dtype="float32", compute_dtype="float32")

    def reqs():
        return make_requests(np, Request, cfg.vocab_size, 2, 6, (20, 72), 17,
                             (0, 4), PARITY_DECODE)

    desc = ("arch=granite-moe-3b-a800m full width, depth cut 32->4 layers, "
            "float32, prefill chunks of 64")
    params = None
    for impl in ("dense", "sorted"):
        params = card_cpu_parity(torch, np, cfg,
                                 RuntimeFlags(moe_impl=impl), reqs,
                                 "moe parity", f"{desc} moe_impl={impl}",
                                 prefill_chunk=64, params=params)
    # one sorted dispatch at granite's widths: a 64-token chunk whose last
    # 16 rows are one row (a padded tail), layer 0's experts
    p = {n: w[0] for n, w in params["blocks"]["p0"]["moe"].items()}
    p_cpu = _to(p, "cpu")
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((1, 64, cfg.d_model), generator=gen)
    x[0, 48:] = torch.randn(cfg.d_model, generator=gen)
    k, e, cf = (cfg.num_experts_per_tok, cfg.num_experts,
                cfg.moe_capacity_factor)
    got, _ = moe.apply_sorted(p, x.cuda(), k, cfg.activation,
                              capacity_factor=cf)
    want, _ = moe.apply_sorted(p_cpu, x, k, cfg.activation,
                               capacity_factor=cf)
    _, ids, probs = moe._route(p_cpu, x, k)
    _, card_ids, _ = moe._route(p, x.cuda(), k)
    top = probs.topk(k + 1, dim=-1).values
    gap = float((top[..., k - 1] - top[..., k]).min())
    cap = moe.capacity(k, 64, cf, e)
    _, _, keep, _ = moe.dispatch(ids, k, 64, cap, e)
    dropped = int((~keep).sum())
    g, w = got.cpu(), want
    err = float((g - w).abs().max())
    ok = bool(((g - w).abs() <= MOE_TOL + MOE_TOL * w.abs()).all())
    same_ids = bool(torch.equal(card_ids.cpu(), ids))
    print(f"[moe parity] apply_sorted x=(1, 64, {cfg.d_model}) float32 "
          f"(the last 16 rows one row, a padded tail) experts={e} top_k={k} "
          f"cap={cap} dropped_assignments={dropped} of {64 * k} "
          f"ids_equal={same_ids} min_topk_gap={gap:.3e} "
          f"max_abs_err={err:.3e} tol={MOE_TOL} ok={ok}", flush=True)
    check(dropped > 0, "moe parity: no assignment dropped at capacity")
    check(same_ids and ok, f"moe parity: apply_sorted card != CPU (ids "
          f"equal {same_ids}, max_abs_err {err}, min top-k gap {gap})")
    gcfg = smoke_config(ARCHS["grok-1-314b"])
    for impl in ("dense", "sorted"):
        card_cpu_parity(
            torch, np, gcfg, RuntimeFlags(moe_impl=impl),
            lambda: make_requests(np, Request, gcfg.vocab_size, 2, 6, (5, 40),
                                  17, (0, 4), PARITY_DECODE),
            "moe parity", f"arch=grok-1-314b smoke width, float32, "
            f"softcaps 30 moe_impl={impl}")


def encdec_parity_phase(torch, np):
    """pixtral-12b cut to 2 layers (64 patches, 16 tokens) and
    seamless-m4t-medium cut to 2 + 2 layers (128 frames, 16 decoder
    tokens) at published widths, float32, ``attn_impl="pallas"``: K2's
    float32 route on the card, its plain version on the CPU; the last
    prefill logits allclose and 8 greedy decode tokens equal."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.models import RuntimeFlags, build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    cases = (
        (override(ARCHS["pixtral-12b"], num_layers=2, **f32),
         "depth cut 40->2 layers", 2,
         lambda cfg, gen: dict(
             patch_embeds=torch.randn((2, 64, cfg.d_model), generator=gen),
             tokens=torch.randint(0, cfg.vocab_size, (2, 16),
                                  generator=gen))),
        (override(ARCHS["seamless-m4t-medium"], num_layers=2,
                  num_encoder_layers=2, **f32),
         "depth cut 12+12->2+2 layers", 6,
         lambda cfg, gen: dict(
             frames=torch.randn((2, 128, cfg.d_model), generator=gen),
             dec_tokens=torch.randint(0, cfg.vocab_size, (2, 16),
                                      generator=gen))))
    flags = RuntimeFlags(attn_impl="pallas")
    for cfg, cut, want_k2, make in cases:
        card_bundle = build(cfg, flags, device="cuda")
        params = card_bundle.init(torch.Generator(device="cuda"
                                                  ).manual_seed(1))
        batch = make(cfg, torch.Generator().manual_seed(9))
        outs = {}
        for dev in ("cuda", "cpu"):
            bundle = (card_bundle if dev == "cuda"
                      else build(cfg, flags, device="cpu"))
            p = params if dev == "cuda" else _to(params, "cpu")
            logits, toks, _, _, k2 = prefill_then_decode(
                torch, bundle, p, _to(batch, dev), PARITY_DECODE)
            if dev == "cuda":
                check(k2 == want_k2, f"encdec parity {cfg.name}: K2 launches "
                      f"{k2} != {want_k2} a prefill")
            outs[dev] = (logits.cpu(), toks.cpu())
            del p
        g, w = outs["cuda"][0], outs["cpu"][0]
        err = float((g - w).abs().max())
        ok = bool(((g - w).abs() <= LOGIT_TOL + LOGIT_TOL * w.abs()).all())
        same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
        print(f"[encdec parity] arch={cfg.name} full width, {cut}, float32, "
              f"attn_impl=pallas batch={ {n: tuple(t.shape) for n, t in batch.items()} } "
              f"k2_launches={want_k2} last_logits_max_abs_err={err:.3e} "
              f"tol={LOGIT_TOL} logits_ok={ok} decode_tokens={PARITY_DECODE} "
              f"cuda_equals_cpu={same}", flush=True)
        check(ok, f"encdec parity {cfg.name}: last logits differ by {err}")
        check(same, f"encdec parity {cfg.name}: greedy tokens differ: cpu "
              f"{outs['cpu'][1].tolist()} cuda {outs['cuda'][1].tolist()}")
        del params, card_bundle
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# tensor and data parallelism: ServeMesh and ReplicaPool on the one card
# ---------------------------------------------------------------------------

TP_NEW = 16                        # [tp serve]'s and [dp serve]'s new tokens


def tp_devices(torch):
    """A group of two on the one card: both shards of a TP=2 engine, or
    both replicas of a DP=2 pool, on ``cuda:<current>``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return [dev, dev]


def _first_divergence(got, want):
    """(equal tokens / all tokens, the first (request, index) that
    differs or None)."""
    same = total = 0
    first = None
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            total += 1
            same += a == b
            if a != b and first is None:
                first = (i, j)
    return same / max(1, total), first


def _copies_line(copies, ticks):
    """The bytes the shards copied between them, by kind, per decode tick
    (the drain's prefill chunks included)."""
    return " ".join(f"{k.replace(' ', '_')}_KiB_per_tick="
                    f"{v / max(1, ticks) / 1024:.1f}"
                    for k, v in sorted(copies.items()))


def _shard_state_equal(torch, eng):
    """Every shard's copy of every recurrent state leaf is the first
    shard's (the pools and their scale lanes split, and are skipped)."""
    first = eng.cache[0]
    for c in eng.cache[1:]:
        for part in ("blocks", "rem"):
            for name, layer in first[part].items():
                for n, leaf in layer.items():
                    if n in ("k_pages", "v_pages", "k_scale", "v_scale"):
                        continue
                    if not torch.equal(leaf, c[part][name][n].to(
                            leaf.device)):
                        return False
    return True


def tp_family_serve(torch, np, card, cfg, flags, tag, reqs, extra):
    """``cfg`` at TP=2 with both shards on the one card, then TP=1 on the
    same weights: the same requests drained warm by each; K1's launches
    = shards x attention layers x ticks, every budget met.  ``extra(tp2,
    tp1)`` adds the family's checks and returns words for the summary
    line.  Returns (K1 launches of the TP=2 drain, the runs)."""
    from repro_torch.dist import ServeMesh
    from repro_torch.dist import tp as tpc
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Request, ServeEngine

    bundle, params = load_model(torch, cfg, flags)
    Timed = timed_engine_class(torch, ServeEngine)
    mesh = ServeMesh.tp(2, devices=tp_devices(torch))
    n_attn = attention_layers(cfg)
    runs = {}
    for label, kw in (("tp2", dict(dist=mesh)), ("tp1", {})):
        eng = Timed(bundle, params, 8, 1024, prefill_chunk=256, **kw)
        # a short drain first meets the layout's shapes, so both layouts
        # are timed warm
        drain(torch, eng, [Request(rid=r.rid, prompt=r.prompt,
                                   max_new_tokens=2) for r in reqs[:2]])
        pa.reset_launches()
        tpc.reset_copies()
        dt = drain(torch, eng, reqs)
        st = eng.stats
        launches = pa.LAUNCHES
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              f"{tag} {label}: a request missed its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens), f"{tag} {label}: token out of "
              "range")
        check(launches == eng.tp * n_attn * st.decode_steps
              and st.decode_steps > 0,
              f"{tag} {label}: K1 launches {launches} != {eng.tp} shards x "
              f"{n_attn} attention layers x {st.decode_steps} ticks")
        runs[label] = dict(eng=eng, tokens=[list(r.out_tokens) for r in reqs],
                           tick_ms=1e3 * eng.decode_s / st.decode_steps,
                           chunk_ms=1e3 * eng.prefill_s / st.prefill_chunks,
                           tok_s=st.tokens_out / dt, seconds=dt,
                           launches=launches, copies=dict(tpc.COPIES))
    tp2, tp1 = runs["tp2"]["eng"], runs["tp1"]["eng"]
    words = extra(tp2, tp1)
    share, first = _first_divergence(runs["tp2"]["tokens"],
                                     runs["tp1"]["tokens"])
    for label, r in runs.items():
        e = r["eng"]
        print(f"[{tag}] layout={label} card='{card}' arch={cfg.name} "
              f"requests={len(reqs)} batch={e.bsz} max_len={e.max_len} "
              f"page={e.page} prefill_chunk={e.prefill_chunk} "
              f"shards={e.tp} shard_heads=Hq{cfg.num_heads // e.tp}/"
              f"Hkv{cfg.num_kv_heads // e.tp} "
              f"moe_impl={e.bundle.flags.moe_impl} "
              f"tokens_out={e.stats.tokens_out} seconds={r['seconds']:.3f} "
              f"tok_s={r['tok_s']:.1f} decode_steps={e.stats.decode_steps} "
              f"prefill_chunks={e.stats.prefill_chunks} "
              f"ms_per_decode_tick={r['tick_ms']:.3f} "
              f"ms_per_prefill_chunk={r['chunk_ms']:.3f} "
              f"k1_launches={r['launches']} "
              f"live_kv_bytes_per_shard="
              f"{e.live_kv_bytes_peak(per_shard=True)} "
              f"kv_pool_GiB_per_shard={e.kv_bytes() / e.tp / 2**30:.3f} "
              f"{_copies_line(r['copies'], e.stats.decode_steps)}",
              flush=True)
    print(f"[{tag}] tokens_equal_to_tp1={share:.4f} first_divergence="
          f"{first} (request, token; not gated: bf16 partial sums) "
          f"tick_ratio_tp2_to_tp1="
          f"{runs['tp2']['tick_ms'] / runs['tp1']['tick_ms']:.3f} {words} "
          f"card='{card}'", flush=True)
    return runs["tp2"]["launches"], runs


def tp_serve_phase(torch, np, card):
    """Full-width phi4-mini-3.8b at TP=2 on the one card, then TP=1 on the
    same weights (:func:`tp_family_serve`); returns K1's launches on both
    paths."""
    from repro_torch.configs import ARCHS
    from repro_torch.serve import Request

    cfg = ARCHS["phi4-mini-3.8b"]

    def extra(tp2, tp1):
        # each shard: 12 query heads over a stripe of 4 kv heads, the same
        # page ids (the tables are one tensor copied per shard)
        heads = [(s["blocks"]["p0"]["attn"]["wq"].shape[-1] // 128,
                  c["blocks"]["p0"]["k_pages"].shape[-2])
                 for s, c in zip(tp2.params, tp2.cache)]
        check(heads == [(12, 4), (12, 4)], f"tp serve: shard heads {heads}, "
              "not Hq 12 / Hkv 4")
        check(all(torch.equal(t["full"], tp2._table[0]["full"])
                  for t in tp2._table), "tp serve: the shards' tables differ")
        pool = sum(c["blocks"]["p0"][n].numel() * c["blocks"]["p0"][n]
                   .element_size() for c in tp2.cache[:1]
                   for n in ("k_pages", "v_pages"))
        check(2 * pool == tp1.kv_bytes() == tp2.kv_bytes(),
              f"tp serve: a shard's pools hold {pool} bytes, TP=1's "
              f"{tp1.kv_bytes()}")
        live = tp2.live_kv_bytes_peak(per_shard=True)
        check(2 * live == tp1.live_kv_bytes_peak(),
              f"tp serve: a shard's live bytes {live} are not half of "
              f"TP=1's {tp1.live_kv_bytes_peak()}")
        return "shard_heads=Hq12/Hkv4"

    _, runs = tp_family_serve(
        torch, np, card, cfg, None, "tp serve",
        make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513), 256,
                      (0, 9, 12, 15), TP_NEW)[:8], extra)
    return {f"{label} serve": r["launches"] for label, r in runs.items()}


def _tp_drain_parity(torch, np, cfg, flags, reqs_of, tag, desc,
                     sampling=None, params=None):
    """The same float32 weights drain the same requests at TP=2 on the
    card (both shards on cuda:0), at TP=1 on the card and on the CPU:
    tokens, final keys and every counter equal; K1 = 2 x attention
    layers x ticks at TP=2; the shards' state copies equal.  Returns
    (TP=2's K1 launches, the card weights)."""
    import dataclasses

    from repro_torch.dist import ServeMesh
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_bundle = build(cfg, flags, device="cuda")
    card_params = params or card_bundle.init(
        torch.Generator(device="cuda").manual_seed(1))
    mesh = ServeMesh.tp(2, devices=tp_devices(torch))
    layouts = (("card tp2", card_bundle, card_params, dict(dist=mesh)),
               ("card tp1", card_bundle, card_params, dict(device="cuda")),
               ("cpu tp1", build(cfg, flags, device="cpu"),
                _to(card_params, "cpu"), dict(device="cpu")))
    n_attn = attention_layers(cfg)
    outs, keys, stats = {}, {}, {}
    launches, same_state, reused = 0, True, {}
    for label, bundle, params_l, kw in layouts:
        eng = ServeEngine(bundle, params_l, 4, 128, sampling=sampling,
                          seed=3, prefill_chunk=32, **kw)
        reqs = reqs_of()
        pa.reset_launches()
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion()
        if label == "card tp2":
            launches = pa.LAUNCHES
            check(launches == 2 * n_attn * eng.stats.decode_steps
                  and eng.stats.decode_steps > 0,
                  f"{tag}: K1 launches {launches} != 2 shards x {n_attn} "
                  f"x {eng.stats.decode_steps} ticks")
            same_state = _shard_state_equal(torch, eng)
        outs[label] = [list(r.out_tokens) for r in reqs]
        keys[label] = eng.keys.cpu()
        stats[label] = dataclasses.asdict(eng.stats)
        reused[label] = eng.stats.ring_pages_reused
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              f"{tag} {label}: budget missed")
        del eng
    if any(s.sliding_window for s in cfg.layer_pattern):
        check(all(v > 0 for v in reused.values()),
              f"{tag}: the ring never turned: {reused}")
    want = "cpu tp1"
    same = all(o == outs[want] for o in outs.values())
    same_keys = all(torch.equal(k, keys[want]) for k in keys.values())
    same_stats = all(s == stats[want] for s in stats.values())
    mode = "greedy" if sampling is None else "sampled"
    print(f"[{tag}] {desc} mode={mode} layouts={sorted(outs)} "
          f"requests={len(outs[want])} tokens_equal={same} "
          f"keys_equal={same_keys} stats_equal={same_stats} "
          f"shard_state_equal={same_state} ring_pages_reused="
          f"{reused['card tp2']} k1_launches_tp2={launches}", flush=True)
    check(same, f"{tag} {mode}: tokens differ: {outs}")
    check(same_keys, f"{tag} {mode}: final keys differ")
    check(same_stats, f"{tag} {mode}: counters differ")
    check(same_state, f"{tag} {mode}: the shards' state copies differ")
    return launches, card_params


def tp_parity_phase(torch, np):
    """phi4-mini-3.8b at published widths cut to 2 layers, float32: TP=2
    on the card against TP=1 on the card and on the CPU, greedy and
    sampled (:func:`_tp_drain_parity`); then logits of a paged chunk and
    3 ticks."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.dist import ServeMesh
    from repro_torch.models import build
    from repro_torch.serve import Request, SamplingParams

    cfg = override(ARCHS["phi4-mini-3.8b"], num_layers=2,
                   param_dtype="float32", compute_dtype="float32")

    def reqs_of():
        return make_requests(np, Request, cfg.vocab_size, 2, 6, (5, 40), 17,
                             (0, 4), 8)

    desc = "arch=phi4-mini-3.8b full width, 2 layers, float32"
    launches, card_params = _tp_drain_parity(torch, np, cfg, None, reqs_of,
                                             "tp parity", desc)
    n, _ = _tp_drain_parity(torch, np, cfg, None, reqs_of, "tp parity", desc,
                            sampling=SamplingParams(temperature=0.9,
                                                    top_k=11),
                            params=card_params)
    launches += n
    card_bundle = build(cfg, device="cuda")
    mesh = ServeMesh.tp(2, devices=tp_devices(torch))
    # logits of a paged chunk and 3 decode ticks, TP=2 against TP=1
    tb, tparams = mesh.bind(card_bundle), mesh.shard_params(card_bundle,
                                                            card_params)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen).cuda()
    table = dict(full=torch.arange(1, 9, dtype=torch.int32,
                                   device="cuda").reshape(2, 4))
    c1 = card_bundle.init_paged_cache(9, 8, batch=2)
    c2 = mesh.shard_paged_cache(card_bundle.init_paged_cache(9, 8, batch=2))
    cv = torch.tensor([24, 19], dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    c1, want = card_bundle.paged_prefill_chunk(card_params, c1, toks, pos,
                                               table, cv)
    c2, got = tb.paged_prefill_chunk(tparams, c2, toks, pos, table, cv)
    errs = [float((torch.cat(got, -1) - want).abs().max())]
    for t in range(3):
        nt = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen).cuda()
        want, c1 = card_bundle.paged_decode_step(card_params, c1, nt, cv + t,
                                                 table)
        got, c2 = tb.paged_decode_step(tparams, c2, nt, cv + t, table)
        errs.append(float((torch.cat(got, -1) - want).abs().max()))
    print(f"[tp parity] logits TP=2 vs TP=1 on the card: chunk and 3 "
          f"ticks max_abs_err={['%.3e' % e for e in errs]} tol=1e-4",
          flush=True)
    check(max(errs) <= 1e-4, f"tp parity: TP=2 logits {errs} beyond 1e-4 "
          "of TP=1")
    return {"tp parity": launches}


def dp_serve_phase(torch, np, card):
    """A colocated DP=2 pool of full-width gemma-2b on the one card, one
    weight tree, against the single engine."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import build_pool
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["gemma-2b"]
    bundle, params = load_model(torch, cfg)

    def reqs_of():
        return make_requests(np, Request, cfg.vocab_size, 0, 16, (64, 513),
                             256, (0, 9, 12, 15), TP_NEW)[:8]

    kw = dict(batch_size=8, max_len=1024, prefill_chunk=256)
    single = ServeEngine(bundle, params, **kw)
    want = reqs_of()
    t0 = time.perf_counter()
    drain(torch, single, want)
    single_s = time.perf_counter() - t0
    pool = build_pool(bundle, params, tp=1, dp=2, devices=tp_devices(torch),
                      **kw)
    reqs = reqs_of()
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        pool.submit(r)
    stats = pool.drain()
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    ticks = sum(e.stats.decode_steps for e in pool.engines)
    same = [list(r.out_tokens) for r in reqs] == [list(r.out_tokens)
                                                  for r in want]
    shared = all(e.params["embed"]["tok"] is params["embed"]["tok"]
                 for e in pool.engines)
    print(f"[dp serve] card='{card}' arch={cfg.name} replicas=2 "
          f"routed={pool.routed} batch={kw['batch_size']} requests="
          f"{len(reqs)} tokens_out={stats.tokens_out} "
          f"streams_equal_single={same} one_weight_tree={shared} "
          f"k1_launches={pa.LAUNCHES} replica_ticks="
          f"{[e.stats.decode_steps for e in pool.engines]} "
          f"pool_seconds={pool_s:.3f} single_seconds={single_s:.3f}",
          flush=True)
    check(same, "dp serve: a replica's stream differs from the single "
          "engine's")
    check(shared, "dp serve: the replicas copied the weights")
    check(all(n > 0 for n in pool.routed), "dp serve: a replica took no "
          "request")
    check(pa.LAUNCHES == cfg.num_layers * ticks > 0,
          f"dp serve: K1 launches {pa.LAUNCHES} != {cfg.num_layers} x "
          f"{ticks} ticks")
    return {"dp serve": pa.LAUNCHES}


# ---------------------------------------------------------------------------
# training (the reference's training path reaches no Pallas kernel, so
# these phases launch none of K1-K8)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8                    # [train]'s steps of full-width gemma-2b
FIXED_STEPS = 4                    # its fixed-batch fallback
PARITY_SEQ = 32                    # [train parity]'s sequence (B 2)
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores


def kernel_launches():
    """Every kernel's launch count, K1-K8 in order."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import pointer_chase as pc
    from repro_torch.kernels import random_gather as rg
    from repro_torch.kernels import stream_copy as sc
    from repro_torch.kernels import strided_copy as st
    return [m.LAUNCHES for m in (pa, fa, da, sc, st, rg, pc, mm)]


def _tree_bytes(tree):
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _copy(tree, device):
    """A detached copy of a param tree on ``device``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def _leaf_gap(got, want):
    """The largest over the leaves of max |got - want| over max |want|
    (1 where ``want``'s leaf is all zeros), computed on ``got``'s
    device: how far two gradient trees, or two first moments after one
    AdamW step ((1 - b1) times the clipped gradient), stand apart."""
    from repro_torch.tree import leaves_with_paths
    w = dict(leaves_with_paths(want))
    worst = 0.0
    for path, g in leaves_with_paths(got):
        x = w[path].detach().float().to(g.device)
        worst = max(worst, float((g.detach().float() - x).abs().max())
                    / (float(x.abs().max()) or 1.0))
    return worst


def _param_gap(torch, got, want):
    """(largest |got - want| over every leaf, elements apart by more than
    1e-6, elements), computed on ``got``'s device."""
    from repro_torch.tree import leaves_with_paths
    w = dict(leaves_with_paths(want))
    worst, parted, total = 0.0, 0, 0
    for path, g in leaves_with_paths(got):
        d = (g.detach().float()
             - w[path].detach().float().to(g.device)).abs()
        worst = max(worst, float(d.max()))
        parted += int((d > 1e-6).sum())
        total += d.numel()
    return worst, parted, total


def train_phase(torch, np, card):
    """Full-width gemma-2b trained on the card through the launcher's
    trainer (its defaults: float32, seq 256, batch 8, markov data,
    fsdp_tp on a 1x1 mesh, lr 1e-3 under warmup_cosine(10, steps)), no
    checkpoint."""
    from repro_torch.launch import train as launch_train
    from repro_torch.tree import leaves

    args = launch_train.parser().parse_args(
        ["--arch", "gemma-2b", "--steps", str(TRAIN_STEPS)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_launches()
    t0 = time.perf_counter()
    tr = launch_train.build_trainer(args)
    tr.tcfg.log_every = 1                # a metrics row every step
    final = tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cfg = tr.bundle.cfg
    params, opt = tr._final
    hist = tr.history
    losses = [h["loss"] for h in hist]
    for h in hist:
        print(f"[train] step={h['step']} loss={h['loss']:.6f} "
              f"grad_norm={h['grad_norm']:.6f} lr={h['lr']:.3e} "
              f"ms={h['sec'] * 1e3:.1f}", flush=True)
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    tokens = tr.cell.tokens
    n_params = sum(t.numel() for t in leaves(params))
    p_bytes = _tree_bytes(params)
    mv_bytes = _tree_bytes(opt.m) + _tree_bytes(opt.v)
    g_bytes = 4 * n_params               # the float32 gradient tree
    flops = 6.0 * n_params * tokens
    fixed = []
    falling = losses[-1] < losses[0]
    if not falling:
        # the warmup kept the loss flat: hold one batch for a few steps
        batch = tr._put(tr.data.batch_at(0))
        for _ in range(FIXED_STEPS):
            params, opt, m = tr.step_fn(params, opt, batch)
            fixed.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    after = kernel_launches()
    print(f"[train] card='{card}' arch={cfg.name} dtype={cfg.param_dtype} "
          f"layers={cfg.num_layers} params={n_params} seq={tr.cell.seq_len} "
          f"batch={tr.cell.global_batch} steps={final} data={args.data} "
          f"policy={args.policy} mesh={dict(tr.mesh.shape)} "
          f"step_ms_median_2_{final}={step_s * 1e3:.1f} "
          f"tokens_per_s={tokens / step_s:.1f} "
          f"state_GB={(p_bytes + g_bytes + mv_bytes) / 1e9:.2f} "
          f"(params {p_bytes / 1e9:.2f}, grads {g_bytes / 1e9:.2f}, "
          f"m+v {mv_bytes / 1e9:.2f}) "
          f"max_memory_allocated_GB={peak / 1e9:.2f} "
          f"flops_6NT={flops:.4e} fp32_peak_share="
          f"{flops / step_s / FP32_OPS_PER_S:.3f} "
          f"run_s={run_s:.1f} first_step_ms={hist[0]['sec'] * 1e3:.1f} "
          f"tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"kernel_launches_moved={[a - b for a, b in zip(after, before)]}",
          flush=True)
    if fixed:
        print(f"[train] the loss did not fall over {final} steps of the "
              f"warmup; {FIXED_STEPS} more steps on batch 0: {fixed}",
              flush=True)
    check(all(math.isfinite(x) for x in losses + fixed),
          f"train: a loss is not finite: {losses + fixed}")
    check(falling or fixed[-1] < fixed[0],
          f"train: the loss does not fall: {losses}, fixed batch {fixed}")
    check(after == before,
          f"train: kernels launched during training: {before} -> {after}")
    check(not torch.backends.cuda.matmul.allow_tf32, "train: TF32 is on")
    del tr, params, opt
    return dict(peak=peak, p_bytes=p_bytes, mv_bytes=mv_bytes)


def train_parity_phase(torch, np):
    """One train step of 2-layer full-width gemma-2b in float32 at the
    launcher's flags, B 2 x S 32, on the card and on the CPU from the same
    params and batch; then microbatches=2 against that step on the card.
    Compared on the card."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.dist import POLICIES
    from repro_torch.dist.steps import make_train_step, value_and_grad
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw, schedule
    from repro_torch.tree import tree_map

    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train parity: TF32 is on")
    rng = np.random.default_rng(21)
    tok = rng.integers(0, cfg.vocab_size, (2, PARITY_SEQ + 1)).astype(
        np.int32)
    card = build(cfg, FLAGS, device="cuda")
    # drawn on the card (the CPU's draw of 744 M values takes seconds)
    init = card.init(torch.Generator(device="cuda").manual_seed(3))
    opt_cfg = AdamWConfig(lr=1e-3, schedule=schedule.warmup_cosine(
        10, TRAIN_STEPS))

    def batch_on(dev):
        return {k: torch.from_numpy(x).to(dev)
                for k, x in (("tokens", tok[:, :-1]), ("labels", tok[:, 1:]))}

    def one_step(dev):
        """The launcher's train step (microbatches=1) from ``init`` on
        ``dev``: (loss, float32 grads, params after AdamW, AdamW's state,
        its metrics)."""
        bundle = build(cfg, FLAGS, device=dev)
        params = _copy(init, dev)
        loss, _, grads = value_and_grad(bundle.train_loss, params,
                                        batch_on(dev))
        grads = tree_map(lambda g: g.float(), grads)
        params, opt, om = adamw.update(grads, adamw.init(params), params,
                                       opt_cfg)
        return float(loss), grads, params, opt, {k: float(v)
                                                 for k, v in om.items()}

    t0 = time.perf_counter()
    l_cpu, g_cpu, p_cpu, o_cpu, om_cpu = one_step("cpu")
    del o_cpu
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_card, g_card, p_card, o_card, om_card = one_step("cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    lr = om_cpu["lr"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    gn_rel = abs(om_card["grad_norm"] - om_cpu["grad_norm"]) / om_cpu[
        "grad_norm"]
    grad_worst = _leaf_gap(g_card, g_cpu)
    del g_cpu, g_card
    worst, parted, total = _param_gap(torch, p_card, p_cpu)
    del p_cpu
    # microbatches=2 against that step, tests/test_train.py's check; the
    # gradients are held through grad_norm and the first moment, since
    # one AdamW step moves a param by about lr whatever its gradient
    step, _, _, _ = make_train_step(card, Mesh(("data", "model"), (1, 1),
                                               ("cuda",)),
                                    POLICIES["fsdp_tp"], opt_cfg,
                                    microbatches=2)
    params = _copy(init, "cuda")
    params, o_mb, met = step(params, adamw.init(params), batch_on("cuda"))
    mb_loss = float(met["loss"])
    mb_gn_rel = abs(float(met["grad_norm"]) - om_card["grad_norm"]) / om_card[
        "grad_norm"]
    mb_grad_worst = _leaf_gap(o_mb.m, o_card.m)
    del o_mb, o_card
    mb_worst, _, _ = _param_gap(torch, params, p_card)
    print(f"[train parity] arch={cfg.name} layers=2 dtype=float32 batch=2 "
          f"seq={PARITY_SEQ} loss_cpu={l_cpu:.8f} loss_card={l_card:.8f} "
          f"loss_rel={loss_rel:.3e} grad_norm_rel={gn_rel:.3e} "
          f"grad_worst_rel_to_leaf_max={grad_worst:.3e} "
          f"param_max_abs_diff={worst:.3e} (2 lr = "
          f"{2 * lr:.1e}) params_apart_over_1e-6={parted}/{total} "
          f"micro2_loss={mb_loss:.8f} micro_grad_norm_rel={mb_gn_rel:.3e} "
          f"micro_moment_worst_rel_to_leaf_max={mb_grad_worst:.3e} "
          f"micro_param_max_abs_diff={mb_worst:.3e} cpu_step_s={cpu_s:.1f} "
          f"card_step_s={card_s:.1f}", flush=True)
    check(loss_rel <= 1e-5, f"train parity: loss {l_card} vs CPU {l_cpu}")
    check(gn_rel <= 1e-5, f"train parity: grad_norm "
          f"{om_card['grad_norm']} vs CPU {om_cpu['grad_norm']}")
    check(grad_worst <= 1e-4, f"train parity: a gradient leaf is "
          f"{grad_worst:.3e} of its largest magnitude from the CPU's")
    check(worst <= 2 * lr, f"train parity: a param is {worst:.3e} from "
          f"the CPU's after AdamW, over 2 lr = {2 * lr:.1e}")
    check(abs(mb_loss - l_card) < 1e-4 and mb_worst <= 2e-3
          and mb_gn_rel <= 1e-5 and mb_grad_worst <= 1e-4,
          f"train parity: microbatches=2 loss {mb_loss} vs {l_card}, "
          f"grad_norm {mb_gn_rel:.3e} relative, first moment "
          f"{mb_grad_worst:.3e} of a leaf's largest, params {mb_worst:.3e} "
          "apart")


def _smoke_trainer(ckpt, device, steps=6, injector=None):
    from repro_torch.configs import ARCHS, ShapeCell, smoke_config
    from repro_torch.dist import POLICIES
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    return Trainer(build(smoke_config(ARCHS["gemma-2b"]), FLAGS,
                         device=device),
                   ShapeCell("smoke", "train", 32, 4),
                   Mesh(("data", "model"), (1, 1), (device,)),
                   POLICIES["fsdp_tp"], AdamWConfig(lr=1e-3),
                   TrainConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=2,
                               log_every=1, data_kind="markov"),
                   injector=injector)


def train_recovery_phase(torch, np):
    """Smoke gemma-2b on the card: 6 steps with a checkpoint every 2,
    failures injected at steps 3 and 5 and recovered, against two
    uninterrupted runs (their gap is the run-to-run spread); then a
    checkpoint written on the CPU restored onto the card."""
    import shutil
    from repro_torch.train import FailureInjector, run_with_recovery
    from repro_torch.tree import leaves_with_paths

    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    finals = []
    for name in ("a", "b"):
        tr = _smoke_trainer(os.path.join(root, name), "cuda")
        tr.run()
        finals.append(tr._final[0])
    spread, _, _ = _param_gap(torch, finals[1], finals[0])
    inj = FailureInjector(fail_at=(3, 5))
    tr = _smoke_trainer(os.path.join(root, "rec"), "cuda", injector=inj)
    final = run_with_recovery(tr.run)
    gap, parted, total = _param_gap(torch, tr._final[0], finals[0])
    # written on the CPU, restored onto the card
    cpu = _smoke_trainer(os.path.join(root, "cpu"), "cpu", steps=2)
    cpu.run()
    card = _smoke_trainer(os.path.join(root, "cpu"), "cuda", steps=2)
    rp, ro, step = card.restore_state()
    want = dict(leaves_with_paths(dict(params=cpu._final[0],
                                       opt=cpu._final[1])))
    exact = all(torch.equal(t.cpu(), want[p].detach().cpu())
                and t.device.type == "cuda"
                for p, t in leaves_with_paths(dict(params=rp, opt=ro)))
    shutil.rmtree(root, ignore_errors=True)
    print(f"[train recovery] arch=gemma-2b(smoke) steps={final} "
          f"failures_at={sorted(inj.seen)} ckpt_every=2 "
          f"run_to_run_spread={spread:.3e} recovered_vs_uninterrupted="
          f"{gap:.3e} params_apart_over_1e-6={parted}/{total} "
          f"cpu_checkpoint_step={step} restores_exactly_on_card={exact} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    check(final == 6 and inj.seen == {3, 5},
          f"train recovery: ended at {final}, failures {inj.seen}")
    check(gap <= spread, f"train recovery: the recovered params are "
          f"{gap:.3e} from an uninterrupted run's, over the run-to-run "
          f"spread {spread:.3e}")
    check(step == 2 and exact, "train recovery: the CPU's checkpoint does "
          "not restore exactly onto the card")


def dp_train_phase(torch, np, card):
    """DP=2 with both shards on cuda:0: the reference's dp_compression
    scenario (16x4 least squares, 150 steps, lr 0.1) with and without
    int8 error feedback, then an uncompressed DP=2 step of smoke gemma-2b
    against the one-device step on the full batch."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.dist import POLICIES
    from repro_torch.dist.dp_shardmap import (init_error_feedback,
                                              make_dp_train_step)
    from repro_torch.dist.steps import make_train_step
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(("data",), (2,), (dev, dev))
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((16, 4)).astype(np.float32)
    batches = []
    for _ in range(150):
        x = rng.standard_normal((64, 16)).astype(np.float32)
        batches.append(dict(x=torch.from_numpy(x).to(dev),
                            y=torch.from_numpy(x @ w_true).to(dev)))

    def lsq(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    t0 = time.perf_counter()
    results, saved = {}, {}
    for comp in (False, True):
        params = dict(w=torch.zeros(16, 4, device=dev))
        opt, err = adamw.init(params), init_error_feedback(params, 2)
        step = make_dp_train_step(lsq, mesh, AdamWConfig(
            lr=0.1, weight_decay=0.0, clip_norm=None), compress_grads=comp)
        first = None
        for b in batches:
            params, opt, err, m = step(params, opt, err, b)
            first = first if first is not None else float(m["loss"])
        results[comp] = (first, float(m["loss"]))
        saved[comp] = float(m.get("wire_bytes_saved", torch.zeros(())))
    scen_s = time.perf_counter() - t0
    cfg = smoke_config(ARCHS["gemma-2b"])
    bundle = build(cfg, FLAGS, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)).astype(
        np.int32)).to(dev)
    batch = dict(tokens=tok[:, :-1], labels=tok[:, 1:])
    init = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    one, _, _, _ = make_train_step(bundle, Mesh(("data", "model"), (1, 1),
                                                (dev,)),
                                   POLICIES["fsdp_tp"], opt_cfg)
    p1 = _copy(init, dev)
    p1, o1, m1 = one(p1, adamw.init(p1), batch)
    dp = make_dp_train_step(lambda p, b: bundle.train_loss(p, b)[0], mesh,
                            opt_cfg)
    p2 = _copy(init, dev)
    p2, o2, _, m2 = dp(p2, adamw.init(p2), init_error_feedback(p2, 2), batch)
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(
        float(m1["loss"]))
    # the parity phase's gates: the shards' mean gradient through
    # grad_norm and the first moment, the params within 2 lr
    gn_rel = abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) / float(
        m1["grad_norm"])
    grad_worst = _leaf_gap(o2.m, o1.m)
    worst, parted, total = _param_gap(torch, p2, p1)
    print(f"[dp train] card='{card}' shards=2 on {dev} scenario=dp_compression "
          f"uncompressed first={results[False][0]:.6e} "
          f"last={results[False][1]:.6e} compressed first="
          f"{results[True][0]:.6e} last={results[True][1]:.6e} "
          f"wire_bytes_saved={saved[True]:.0f} scenario_s={scen_s:.1f} "
          f"| smoke gemma-2b dp2 vs full batch: loss_rel={loss_rel:.3e} "
          f"grad_norm_rel={gn_rel:.3e} moment_worst_rel_to_leaf_max="
          f"{grad_worst:.3e} "
          f"param_max_abs_diff={worst:.3e} (2 lr = {2 * opt_cfg.lr:.1e}) "
          f"params_apart_over_1e-6={parted}/{total}", flush=True)
    check(results[False][1] < results[False][0] / 100,
          f"dp train: uncompressed did not converge 100x: {results}")
    check(results[True][1] < results[True][0] / 100,
          f"dp train: compressed did not converge 100x: {results}")
    check(results[True][1] < 5 * results[False][1] + 1e-3,
          f"dp train: compressed ends over 5x uncompressed: {results}")
    check(loss_rel <= 1e-5 and gn_rel <= 1e-5 and grad_worst <= 1e-4
          and worst <= 2 * opt_cfg.lr,
          f"dp train: DP=2 differs from the full-batch step: loss "
          f"{loss_rel:.3e}, grad_norm {gn_rel:.3e}, first moment "
          f"{grad_worst:.3e} of a leaf's largest, params {worst:.3e}")


# ---------------------------------------------------------------------------
# sharded training, the sharded step builders and the dry-run (one process
# drives every shard; the four devices of the (2, 2) mesh are cuda:0)
# ---------------------------------------------------------------------------

FSDP_STEPS = 5                     # [fsdp tp train]'s steps on batch 0
FSDP_GROUP = ",".join(["cuda:0"] * 4)
DECODE_PROMPT = 256                # [sharded decode]: 8 prompts, 16 steps
DECODE_NEW = 16
MIN_FREE_GIB = 2.0


def _card_mesh(torch, shape):
    from repro_torch.launch.mesh import Mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(("data", "model"), shape, (dev,) * (shape[0] * shape[1]))


def _device_bytes(trees, n):
    """Bytes of the blocks each mesh device owns, over ``trees``."""
    from repro_torch.dist.sharding import Sharded
    from repro_torch.tree import leaves
    out = [0] * n
    for tree in trees:
        for x in leaves(tree):
            for k, nb in (x.block_bytes() if isinstance(x, Sharded)
                          else [(0, x.numel() * x.element_size())]):
                out[k] += nb
    return out


def fsdp_tp_train_phase(torch, np, card):
    """Full-width gemma-2b in float32 through the launcher's trainer with
    ``--mesh-model 2 --devices cuda:0 x4``: a (2, 2) mesh under fsdp_tp,
    FSDP_STEPS steps on batch 0 (B 8 x S 256, the launcher's defaults)."""
    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(
        ["--arch", "gemma-2b", "--mesh-model", "2", "--devices", FSDP_GROUP,
         "--steps", str(FSDP_STEPS)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_launches()
    t0 = time.perf_counter()
    tr = launch_train.build_trainer(args)
    params, opt, _ = tr.init_state()
    batch = tr._put(tr.data.batch_at(0))
    init_s = time.perf_counter() - t0
    free = [torch.cuda.mem_get_info()[0] / 2**30]
    losses, secs = [], []
    for i in range(FSDP_STEPS):
        t1 = time.perf_counter()
        params, opt, m = tr.step_fn(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        free.append(torch.cuda.mem_get_info()[0] / 2**30)
        losses.append(loss)
        print(f"[fsdp tp train] step={i + 1} loss={loss:.6f} "
              f"grad_norm={float(m['grad_norm']):.6f} "
              f"lr={float(m['lr']):.3e} ms={secs[-1] * 1e3:.1f}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    after = kernel_launches()
    n = len(tr.mesh.devices)
    per_dev = _device_bytes((params, opt.m, opt.v), n)
    step_s = float(np.median(secs[1:]))
    tokens = tr.cell.tokens
    headroom = (total - reserved) / 2**30
    print(f"[fsdp tp train] card='{card}' arch=gemma-2b dtype=float32 "
          f"mesh={dict(tr.mesh.shape)} devices={FSDP_GROUP} "
          f"policy={args.policy} seq={tr.cell.seq_len} "
          f"batch={tr.cell.global_batch} steps={FSDP_STEPS} (batch 0) "
          f"step_ms_median_2_{FSDP_STEPS}={step_s * 1e3:.1f} "
          f"first_step_ms={secs[0] * 1e3:.1f} "
          f"tokens_per_s={tokens / step_s:.1f} "
          f"block_bytes_GB_by_device="
          f"{[round(b / 1e9, 3) for b in per_dev]} "
          f"(params + m + v, {sum(per_dev) / 1e9:.2f} GB in all) "
          f"max_memory_allocated_GB={peak / 1e9:.2f} "
          f"max_reserved_GiB={reserved / 2**30:.2f} "
          f"card_free_GiB_min={min(free):.2f} "
          f"init_s={init_s:.1f} "
          f"kernel_launches_moved={[a - b for a, b in zip(after, before)]}",
          flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"fsdp tp train: a loss is not finite: {losses}")
    check(losses[-1] < losses[0],
          f"fsdp tp train: the loss does not fall: {losses}")
    check(after == before, f"fsdp tp train: kernels launched: {before} -> "
          f"{after}")
    check(min(free) >= MIN_FREE_GIB and headroom >= MIN_FREE_GIB,
          f"fsdp tp train: the card's free memory fell to {min(free):.2f} "
          f"GiB (reserved peak leaves {headroom:.2f})")
    return dict(peak=peak, step_ms=step_s * 1e3, per_dev=per_dev)


def fsdp_tp_parity_phase(torch, np):
    """One step of 2-layer gemma-2b in float32 (the launcher's flags,
    B 4 x S 32) on the (2, 2) card mesh against the 1x1 card step from the
    same weights; then the (2, 2) state checkpointed and restored onto a
    (1, 2) mesh (the elastic restore), compared whole."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.dist import POLICIES
    from repro_torch.dist.sharding import assemble, assemble_tree
    from repro_torch.dist.steps import make_train_step, shard_state
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw, schedule
    from repro_torch.train import CheckpointManager
    from repro_torch.tree import leaves_with_paths

    cfg = override(ARCHS["gemma-2b"], num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fsdp tp parity: TF32 is on")
    rng = np.random.default_rng(22)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)).astype(
        np.int32))
    batch = dict(tokens=tok[:, :-1], labels=tok[:, 1:])
    bundle = build(cfg, FLAGS, device="cuda")
    init = bundle.init(torch.Generator(device="cuda").manual_seed(4))
    opt_cfg = AdamWConfig(lr=1e-3, schedule=schedule.warmup_cosine(
        10, TRAIN_STEPS))
    t0 = time.perf_counter()
    out = {}
    for shape in ((1, 1), (2, 2)):
        mesh = _card_mesh(torch, shape)
        step, p_sh, o_sh, _ = make_train_step(bundle, mesh,
                                              POLICIES["fsdp_tp"], opt_cfg)
        params, opt = shard_state(_copy(init, mesh.devices[0]), p_sh, mesh)
        b = {k: v.to(mesh.devices[0]) for k, v in batch.items()}
        params, opt, m = step(params, opt, b)
        out[shape] = (params, opt, {k: float(v) for k, v in m.items()})
    step_s = time.perf_counter() - t0
    (p1, o1, m1), (p4, o4, m4) = out[1, 1], out[2, 2]
    loss_rel = abs(m4["loss"] - m1["loss"]) / abs(m1["loss"])
    gn_rel = abs(m4["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    moment = _leaf_gap(assemble_tree(o4.m), o1.m)
    # elastic: (2, 2) -> (1, 2)
    root = os.path.join(ROOT, "build", "fsdp_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(root, async_save=False)
    mgr.save(1, dict(params=p4, opt=o4))
    mesh12 = _card_mesh(torch, (1, 2))
    _, p_sh12, o_sh12, _ = make_train_step(bundle, mesh12,
                                           POLICIES["fsdp_tp"], opt_cfg)
    abs_params, _ = bundle.abstract_params()
    like = dict(params=abs_params, opt=adamw.AdamWState(
        step=None, m=abs_params, v=abs_params))
    back = mgr.restore(None, like, mesh12.devices[0],
                       shardings=dict(params=p_sh12, opt=o_sh12),
                       mesh=mesh12)
    want = dict(leaves_with_paths(dict(params=p4, opt=o4)))
    exact = all(torch.equal(assemble(x).detach(),
                            assemble(want[path]).detach())
                for path, x in leaves_with_paths(back))
    exact = exact and all(x.mesh is mesh12 for _, x in
                          leaves_with_paths(back["params"]))
    shutil.rmtree(root, ignore_errors=True)
    print(f"[fsdp tp parity] arch=gemma-2b layers=2 dtype=float32 batch=4 "
          f"seq=32 mesh=(2, 2) on cuda:0 vs 1x1: loss_1x1={m1['loss']:.8f} "
          f"loss_mesh={m4['loss']:.8f} loss_rel={loss_rel:.3e} "
          f"grad_norm_rel={gn_rel:.3e} "
          f"moment_worst_rel_to_leaf_max={moment:.3e} "
          f"elastic_2x2_to_1x2_exact={exact} steps_s={step_s:.1f}",
          flush=True)
    check(loss_rel <= 1e-6, f"fsdp tp parity: loss {m4['loss']} vs "
          f"{m1['loss']} ({loss_rel:.3e} relative)")
    check(gn_rel <= 1e-5, f"fsdp tp parity: grad_norm {gn_rel:.3e} relative")
    check(moment <= 1e-4, f"fsdp tp parity: a first-moment leaf is "
          f"{moment:.3e} of its largest from the 1x1 step's")
    check(exact, "fsdp tp parity: the (2, 2) checkpoint does not restore "
          "exactly onto (1, 2)")


def _grown(torch, cache, max_len):
    """A dense prefill cache (k/v rows of the prompt) in a decode cache of
    ``max_len`` rows."""
    from repro_torch.tree import tree_map

    def grow(t):
        if t.dim() < 4:
            return t
        out = torch.zeros(t.shape[:2] + (max_len,) + t.shape[3:],
                          dtype=t.dtype, device=t.device)
        out[:, :, :t.shape[2]] = t
        return out
    return tree_map(grow, cache)


def _decode_run(torch, np, cfg, mesh_shape, init, tok, vl, forced=None):
    """Prefill ``tok`` (valid lengths ``vl``) and decode DECODE_NEW greedy
    steps at per-slot positions ``vl + t`` through make_prefill_step and
    make_decode_step on a card mesh of ``mesh_shape`` (1x1: one device).
    ``forced`` feeds those tokens instead of the greedy ones.  Returns
    (tokens (B, DECODE_NEW), [prefill logits, each step's logits])."""
    from repro_torch.configs import ShapeCell
    from repro_torch.dist import POLICIES
    from repro_torch.dist.sharding import assemble_tree, cut_tree
    from repro_torch.dist.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build

    mesh = _card_mesh(torch, mesh_shape)
    dev = mesh.devices[0]
    bundle = build(cfg, device=dev)
    b = tok.shape[0]
    max_len = DECODE_PROMPT + DECODE_NEW
    pol = POLICIES["fsdp_tp"]
    pre, p_sh = make_prefill_step(bundle, mesh, pol,
                                  ShapeCell("p", "prefill", DECODE_PROMPT, b))
    dec, _, c_sh = make_decode_step(bundle, mesh, pol,
                                    ShapeCell("d", "decode", max_len, b))
    many = len(mesh.devices) > 1
    params = cut_tree(init, p_sh, mesh) if many else init
    batch = dict(tokens=torch.from_numpy(tok).to(dev),
                 valid_len=torch.from_numpy(vl).to(dev))
    cache, logits = pre(params, batch)
    cache = _grown(torch, assemble_tree(cache) if many else cache, max_len)
    if many:
        cache = cut_tree(cache, c_sh, mesh)
    pos = torch.from_numpy(vl).to(dev)
    out, all_logits = [], [logits]
    nxt = logits.argmax(-1)
    for t in range(DECODE_NEW):
        feed = nxt if forced is None else torch.from_numpy(
            forced[:, t]).to(dev)
        out.append(feed.cpu())
        logits, cache = dec(params, cache, feed[:, None].int(), pos + t)
        all_logits.append(logits)
        nxt = logits.argmax(-1)
    return torch.stack(out, 1).numpy(), all_logits


def sharded_decode_phase(torch, np, card):
    """make_prefill_step + make_decode_step of full-width gemma-2b in
    bf16 on the (2, 2) card mesh against 1x1: 8 prompts of up to 256
    tokens (right-padded, valid lengths 256 - 8 i) and DECODE_NEW greedy
    steps at per-slot positions; the share of tokens equal to 1x1's is
    printed (bf16 TP sums differ).  Then the same path at 2 layers in
    float32, 1x1's tokens fed to both: logits within 1e-4."""
    from repro_torch.configs import ARCHS, override
    from repro_torch.models import build

    rng = np.random.default_rng(31)
    cfg = ARCHS["gemma-2b"]
    b = 8
    tok = rng.integers(0, cfg.vocab_size, (b, DECODE_PROMPT)).astype(
        np.int32)
    vl = (DECODE_PROMPT - 8 * np.arange(b)).astype(np.int32)
    t0 = time.perf_counter()
    before = kernel_launches()
    init = build(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(5))
    one, _ = _decode_run(torch, np, cfg, (1, 1), init, tok, vl)
    t1 = time.perf_counter()
    mesh_tok, _ = _decode_run(torch, np, cfg, (2, 2), init, tok, vl)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    after = kernel_launches()
    share = float((mesh_tok == one).mean())
    del init
    gc.collect()
    torch.cuda.empty_cache()
    f32 = override(cfg, num_layers=2, param_dtype="float32",
                   compute_dtype="float32")
    init = build(f32, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(6))
    ref_tok, ref_logits = _decode_run(torch, np, f32, (1, 1), init, tok, vl)
    _, got_logits = _decode_run(torch, np, f32, (2, 2), init, tok, vl,
                                forced=ref_tok)
    gap = max(float((g.float() - r.float()).abs().max())
              for g, r in zip(got_logits, ref_logits))
    print(f"[sharded decode] card='{card}' arch=gemma-2b dtype=bfloat16 "
          f"mesh=(2, 2) on cuda:0 prompts={b} prompt_len<={DECODE_PROMPT} "
          f"new={DECODE_NEW} per_slot_pos=True token_share_equal_1x1="
          f"{share:.4f} mesh_prefill_decode_s={mesh_s:.2f} | 2 layers "
          f"float32: max_abs_logit_gap_vs_1x1={gap:.3e} (prefill + "
          f"{DECODE_NEW} steps) kernel_launches_moved="
          f"{[a - c for a, c in zip(after, before)]} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    check(gap <= 1e-4, f"sharded decode: float32 logits {gap:.3e} from "
          "1x1's")
    check(np.isfinite(share) and mesh_tok.shape == (b, DECODE_NEW),
          "sharded decode: no tokens")


def dryrun_phase(torch, np, card, train_info, fsdp_info):
    """The dry-run's accounting of [train]'s configuration (full-width
    gemma-2b in float32, the launcher's flags, B 8 x S 256, fsdp_tp) on
    meta meshes of 1x1 and (2, 2): per-device argument bytes and peak,
    beside [train]'s and [fsdp tp train]'s max_memory_allocated."""
    from repro_torch.configs import ARCHS, ShapeCell, override
    from repro_torch.dist import POLICIES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import FLAGS

    cfg = override(ARCHS["gemma-2b"], param_dtype="float32",
                   compute_dtype="float32")
    cell = ShapeCell("cli", "train", 256, 8)
    batch = 2 * cell.global_batch * cell.seq_len * 4
    state = train_info["p_bytes"] + train_info["mv_bytes"] + 4
    t0 = time.perf_counter()
    traces = {}
    for shape, measured in (((1, 1), train_info["peak"]),
                            ((2, 2), fsdp_info["peak"])):
        mesh = Mesh(("data", "model"), shape, ("meta",) * (shape[0]
                                                          * shape[1]))
        tr = dryrun.trace_cell(cfg, cell, mesh, POLICIES["fsdp_tp"], FLAGS)
        traces[shape] = tr
        print(f"[dryrun] card='{card}' config=[train] mesh={shape} "
              f"argument_GB_by_device={[round(a / 1e9, 4) for a in tr.args]}"
              f" peak_GB_by_device={[round(p / 1e9, 3) for p in tr.peak]} "
              f"peak_GB_all_devices={sum(tr.peak) / 1e9:.2f} "
              f"max_memory_allocated_GB={measured / 1e9:.2f} "
              f"ratio_measured_over_traced="
              f"{measured / sum(tr.peak):.3f} "
              f"flops={tr.total_flops:.4e} flops_by_device_sum="
              f"{sum(tr.flops):.4e} collective_GB_by_device="
              f"{[round(r / 1e9, 3) for r in tr.recv]} "
              f"trace_s={tr.seconds:.1f}", flush=True)
    one, four = traces[1, 1], traces[2, 2]
    blocks = fsdp_info["per_dev"]
    # each device: its blocks on the card, the optimizer's step on the
    # first, and a row's batch slice on each row's first device (0, 2)
    want = [blocks[k] + (4 if k == 0 else 0)
            + (batch // 2 if k in (0, 2) else 0) for k in range(4)]
    print(f"[dryrun] state_bytes(params + m + v + step)={state} "
          f"batch_bytes={batch} traced_1x1={sum(one.args)} "
          f"traced_2x2={sum(four.args)} traced_2x2_by_device={four.args} "
          f"card_blocks_by_device={blocks} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    check(sum(one.args) == state + batch and sum(four.args) == state + batch,
          f"dryrun: argument bytes {sum(one.args)} / {sum(four.args)} are "
          f"not the state's {state} + the batch's {batch}")
    check(four.args == want, f"dryrun: the (2, 2) trace's argument bytes "
          f"{four.args} are not the card's blocks, step and batch slices "
          f"{want}")
    check(all(sum(t.flops) == t.total_flops for t in traces.values()),
          "dryrun: the per-device FLOPs do not add up to the total")


# ---------------------------------------------------------------------------
# tensor parallelism over the MoE, recurrent and encoder-decoder stacks
# ---------------------------------------------------------------------------

A9B_TRAIN_BATCH = 2                # [a9b parity]'s train step: B 2 x S 32
A9B_WINDOW = 32                    # recurrentgemma-9b's window in [a9b parity]


def moe_tp_serve_phase(torch, np, card):
    """Full-width granite-moe-3b-a800m (32 layers of 40 experts, top 8)
    at TP=2 then TP=1 under the launcher's dense dispatch: each shard
    holds 20 experts of every layer and runs K1 at Hq 12 / Hkv 4, D 64."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import RuntimeFlags

    cfg = ARCHS["granite-moe-3b-a800m"]

    def experts(eng):
        """(experts of layer 0 on each shard, expert bytes of each)."""
        trees = eng.params if isinstance(eng.params, list) else [eng.params]
        return ([t["blocks"]["p0"]["moe"]["w_up"].shape[1] for t in trees],
                [sum(t["blocks"]["p0"]["moe"][n].numel()
                     * t["blocks"]["p0"]["moe"][n].element_size()
                     for n in ("w_gate", "w_up", "w_down")) for t in trees])

    def extra(tp2, tp1):
        n2, b2 = experts(tp2)
        n1, b1 = experts(tp1)
        check(n2 == [20, 20] and n1 == [40] and all(2 * b == b1[0]
                                                    for b in b2),
              f"moe tp serve: experts per shard {n2} ({b2} bytes), TP=1 "
              f"{n1} ({b1})")
        heads = [(s["blocks"]["p0"]["attn"]["wq"].shape[-1] // 64,
                  c["blocks"]["p0"]["k_pages"].shape[-2])
                 for s, c in zip(tp2.params, tp2.cache)]
        check(heads == [(12, 4), (12, 4)], f"moe tp serve: shard heads "
              f"{heads}, not Hq 12 / Hkv 4")
        live2 = tp2.live_kv_bytes_peak(per_shard=True)
        live1 = tp1.live_kv_bytes_peak()
        check(2 * live2 == live1, f"moe tp serve: a shard's live KV bytes "
              f"{live2} are not half of TP=1's {live1}")
        return (f"experts_per_shard={n2} expert_bytes_per_shard={b2} "
                f"tp1_expert_bytes={b1[0]} shard_heads=Hq12/Hkv4 group=3 D=64")

    launches, _ = tp_family_serve(
        torch, np, card, cfg, RuntimeFlags(moe_impl="dense"), "moe tp serve",
        moe_requests(np, cfg.vocab_size)[:8], extra)
    return {"moe tp serve": launches}


def ssm_tp_serve_phase(torch, np, card):
    """Full-width mamba2-130m (24 SSD layers, 24 heads: 12 a shard) at
    TP=2 then TP=1: no pool, no K1; the SSM state replicated on both
    shards and equal there after the drain."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS["mamba2-130m"]

    def extra(tp2, tp1):
        same = _shard_state_equal(torch, tp2)
        check(same, "ssm tp serve: the shards' state copies differ after "
              "the drain")
        live2 = tp2.live_kv_bytes_peak(per_shard=True)
        live1 = tp1.live_kv_bytes_peak(per_shard=True)
        check(live2 == live1 and tp2.kv_bytes() == tp1.kv_bytes(),
              f"ssm tp serve: per-shard live bytes {live2} != TP=1's "
              f"{live1} (no pools: the state counted once)")
        heads = [t["blocks"]["p0"]["ssd"]["a_log"].shape[-1]
                 for t in tp2.params]
        check(heads == [12, 12], f"ssm tp serve: SSD heads per shard {heads}")
        return (f"ssd_heads_per_shard={heads} state_copies_equal={same} "
                f"live_kv_bytes_per_shard={live2}")

    tp_family_serve(torch, np, card, cfg, None, "ssm tp serve",
                    moe_requests(np, cfg.vocab_size)[:8], extra)


def a9b_parity_phase(torch, np):
    """TP=2 on the card == TP=1 on the card == the CPU, float32, for
    granite-moe-3b-a800m at 2 layers (dense dispatch, greedy and
    sampled; then one sorted apply_tp call against apply_sorted at a
    capacity that drops rows), mamba2-130m at full depth, and
    recurrentgemma-9b's widths with 2 kv heads at one pattern block
    (window narrowed 2048 -> 32 so the ring turns)."""
    from repro_torch.configs import ARCHS, LayerSpec, override
    from repro_torch.configs.base import ATTN, RGLRU
    from repro_torch.dist import tp as tpc
    from repro_torch.models import RuntimeFlags
    from repro_torch.models import moe
    from repro_torch.serve import Request, SamplingParams

    f32 = dict(param_dtype="float32", compute_dtype="float32")
    launches = 0

    def reqs_of(cfg):
        return lambda: make_requests(np, Request, cfg.vocab_size, 2, 6,
                                     (20, 72), 17, (0, 4), 8)

    cfg = override(ARCHS["granite-moe-3b-a800m"], num_layers=2, **f32)
    flags = RuntimeFlags(moe_impl="dense")
    n, params = _tp_drain_parity(
        torch, np, cfg, flags, reqs_of(cfg), "a9b parity",
        "arch=granite-moe-3b-a800m full width, 2 layers, float32, dense")
    launches += n
    n, _ = _tp_drain_parity(
        torch, np, cfg, flags, reqs_of(cfg), "a9b parity",
        "arch=granite-moe-3b-a800m full width, 2 layers, float32, dense",
        sampling=SamplingParams(temperature=0.9, top_k=11), params=params)
    launches += n
    # the sorted dispatch over two shards of layer 0 against the plain
    # version on the same input, at a capacity factor that drops rows
    p = {k: v[0] for k, v in params["blocks"]["p0"]["moe"].items()}
    e = cfg.num_experts
    ps = [{k: (v if k == "router" else v[i * e // 2:(i + 1) * e // 2])
           for k, v in p.items()} for i in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device="cuda")
    k, cf = cfg.num_experts_per_tok, 0.5
    tpc.reset_copies()
    got, aux = moe.apply_tp(ps, x, k, cfg.activation,
                            tpc.DeviceGroup(tp_devices(torch)), impl="sorted",
                            group_size=256, capacity_factor=cf, d_ff=cfg.d_ff)
    want, aux1 = moe.apply_sorted(p, x, k, cfg.activation, group_size=256,
                                  capacity_factor=cf)
    _, ids, _ = moe._route(p, x, k)
    cap = moe.capacity(k, 256, cf, e)
    dropped = int((~moe.dispatch(ids, k, 256, cap, e)[2]).sum())
    err = float((got - want).abs().max())
    print(f"[a9b parity] apply_tp sorted, 2 shards of 20 experts, x (2, 256, "
          f"1536) float32, capacity_factor={cf} cap={cap} "
          f"dropped_assignments={dropped} max_abs_err={err:.3e} "
          f"aux_equal={bool(aux == aux1)} tol={MOE_TOL} "
          f"{_copies_line(tpc.COPIES, 1)}", flush=True)
    check(dropped > 0, "a9b parity: the sorted call dropped no row")
    check(err <= MOE_TOL and bool(aux == aux1),
          f"a9b parity: sorted apply_tp {err:.3e} from apply_sorted")
    del params, p, ps

    cfg = override(ARCHS["mamba2-130m"], **f32)
    n, _ = _tp_drain_parity(torch, np, cfg, None, reqs_of(cfg),
                            "a9b parity",
                            "arch=mamba2-130m full width and depth, float32")
    launches += n
    cfg = override(ARCHS["recurrentgemma-9b"], num_layers=3, num_kv_heads=2,
                   layer_pattern=(LayerSpec(mixer=RGLRU),
                                  LayerSpec(mixer=RGLRU),
                                  LayerSpec(mixer=ATTN,
                                            sliding_window=A9B_WINDOW)),
                   **f32)
    n, _ = _tp_drain_parity(
        torch, np, cfg, None, reqs_of(cfg), "a9b parity",
        f"arch=recurrentgemma-9b full width, one block, num_kv_heads=2, "
        f"window narrowed 2048->{A9B_WINDOW}, float32")
    launches += n
    return {"a9b parity": launches}


def _a9b_train_cases(np, torch):
    """[a9b parity]'s train cases: (config, batch on the host) of
    granite-moe-3b-a800m (2 layers), recurrentgemma-9b (one block, its
    one kv head), mamba2-130m (2 layers) and seamless-m4t-medium (2 + 2
    layers), float32 at published widths, B 2 x S 32."""
    from repro_torch.configs import ARCHS, override

    f32 = dict(param_dtype="float32", compute_dtype="float32")
    cfgs = (override(ARCHS["granite-moe-3b-a800m"], num_layers=2, **f32),
            override(ARCHS["recurrentgemma-9b"], num_layers=3, **f32),
            override(ARCHS["mamba2-130m"], num_layers=2, **f32),
            override(ARCHS["seamless-m4t-medium"], num_layers=2,
                     num_encoder_layers=2, **f32))
    out = []
    for i, cfg in enumerate(cfgs):
        rng = np.random.default_rng(30 + i)
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (A9B_TRAIN_BATCH, 33)).astype(np.int32))
        batch = dict(labels=tok[:, 1:])
        if cfg.enc_dec:
            batch.update(dec_tokens=tok[:, :-1], frames=torch.from_numpy(
                rng.standard_normal((A9B_TRAIN_BATCH, 32, cfg.d_model))
                .astype(np.float32)))
        else:
            batch.update(tokens=tok[:, :-1])
        out.append((cfg, batch))
    return out


def _a9b_train_pair(torch, cfg, batch, meshes):
    """One train step (the launcher's flags, AdamW at lr 1e-3) from the
    same weights on each of the two ``meshes`` (1x1, then (1, 2)):
    ((loss, grad_norm) of each, the first moments' worst leaf gap, the
    leaves the (1, 2) mesh splits over model).  The weights are drawn on
    the card, so the CPU's are the card's."""
    from repro_torch.dist import POLICIES
    from repro_torch.dist.sharding import Sharded, assemble_tree
    from repro_torch.dist.steps import make_train_step, shard_state
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import leaves

    init = build(cfg, FLAGS, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(6))
    dev = meshes[0].devices[0]
    if dev.type != "cuda":
        init = _copy(init, dev)
    out, moments, split = [], [], 0
    for mesh in meshes:
        step, p_sh, _, _ = make_train_step(build(cfg, FLAGS, device=dev),
                                           mesh, POLICIES["fsdp_tp"],
                                           AdamWConfig(lr=1e-3))
        params, opt = shard_state(_copy(init, dev), p_sh, mesh)
        split = sum(isinstance(x, Sharded) and len(x.blocks) == 2
                    for x in leaves(params))
        _, opt, m = step(params, opt, {k: v.to(dev)
                                       for k, v in batch.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
        moments.append(assemble_tree(opt.m) if len(mesh.devices) > 1
                       else opt.m)
        del params, opt, step
    gap = _leaf_gap(moments[1], moments[0])
    del init, moments
    gc.collect()
    torch.cuda.empty_cache()
    return out, gap, split


def _a9b_mesh_gates(tag, cfg, where, pair, gap, split):
    """[fsdp tp parity]'s gates: the (1, 2) step's loss within 1e-6 and
    grad_norm within 1e-5 of 1x1's (relative), the first moment within
    1e-4 of each leaf's largest."""
    (l1, g1), (l2, g2) = pair
    loss_rel, gn_rel = abs(l2 - l1) / abs(l1), abs(g2 - g1) / g1
    check(split > 0, f"{tag} {cfg.name} {where}: no leaf split over model")
    check(loss_rel <= 1e-6 and gn_rel <= 1e-5 and gap <= 1e-4,
          f"{tag} {cfg.name} {where}: the (1, 2) step is loss "
          f"{loss_rel:.3e}, grad_norm {gn_rel:.3e}, moment {gap:.3e} from "
          "1x1's")
    return (f"{where}: loss_1x1={l1:.8f} loss_1x2={l2:.8f} loss_rel="
            f"{loss_rel:.3e} grad_norm_rel={gn_rel:.3e} moment={gap:.3e} "
            f"leaves_split_over_model={split}")


A9B_CPU_STEPS = os.path.join(ROOT, "build", "smoke_lanes",
                             "a9b_train_cpu.json")


def a9b_train_cpu_phase(torch, np):
    """[a9b parity]'s train cases on the CPU (a queued phase: the card
    holds none of it): a (1, 2) mesh of the CPU against 1x1, at [fsdp tp
    parity]'s gates; the 1x1 steps' loss and grad_norm are left for
    :func:`a9b_train_parity_phase` to hold the card's against."""
    from repro_torch.launch.mesh import Mesh

    cpu = torch.device("cpu")
    meshes = (Mesh(("data", "model"), (1, 1), (cpu,)),
              Mesh(("data", "model"), (1, 2), (cpu, cpu)))
    record = {}
    for cfg, batch in _a9b_train_cases(np, torch):
        t0 = time.perf_counter()
        pair, gap, split = _a9b_train_pair(torch, cfg, batch, meshes)
        words = _a9b_mesh_gates("a9b parity train", cfg, "cpu", pair, gap,
                                split)
        print(f"[a9b parity] train arch={cfg.name} layers={cfg.num_layers}"
              f"{' + %d' % cfg.num_encoder_layers if cfg.enc_dec else ''} "
              f"float32 batch={A9B_TRAIN_BATCH} seq=32 {words} "
              f"seconds={time.perf_counter() - t0:.1f}", flush=True)
        record[cfg.name] = pair[0]
    with open(A9B_CPU_STEPS, "w") as f:
        json.dump(record, f)


def a9b_train_parity_phase(torch, np):
    """[a9b parity]'s train cases on the card, after the lanes (the
    recurrentgemma step's state takes about 40 GiB): a (1, 2) mesh of
    cuda:0 against the 1x1 step at [fsdp tp parity]'s gates, and the 1x1
    step's loss and grad_norm against the CPU's (written by
    :func:`a9b_train_cpu_phase`) at [train parity]'s, 1e-5 relative."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "a9b train parity: TF32 is on")
    with open(A9B_CPU_STEPS) as f:
        cpu = json.load(f)
    meshes = (_card_mesh(torch, (1, 1)), _card_mesh(torch, (1, 2)))
    for cfg, batch in _a9b_train_cases(np, torch):
        t0 = time.perf_counter()
        pair, gap, split = _a9b_train_pair(torch, cfg, batch, meshes)
        words = _a9b_mesh_gates("a9b parity train", cfg, "card", pair, gap,
                                split)
        (l1, g1), (l0, g0) = pair[0], cpu[cfg.name]
        loss_rel, gn_rel = abs(l1 - l0) / abs(l0), abs(g1 - g0) / g0
        print(f"[a9b parity] train arch={cfg.name} layers={cfg.num_layers}"
              f"{' + %d' % cfg.num_encoder_layers if cfg.enc_dec else ''} "
              f"float32 batch={A9B_TRAIN_BATCH} seq=32 (1, 2) mesh of "
              f"cuda:0 {words} card_1x1_vs_cpu_1x1: loss_cpu={l0:.8f} "
              f"loss_rel={loss_rel:.3e} grad_norm_rel={gn_rel:.3e} "
              f"seconds={time.perf_counter() - t0:.1f}", flush=True)
        check(loss_rel <= 1e-5 and gn_rel <= 1e-5,
              f"a9b parity train {cfg.name}: the card's 1x1 step is loss "
              f"{loss_rel:.3e}, grad_norm {gn_rel:.3e} from the CPU's")


# ---------------------------------------------------------------------------
# lanes: phases that need no result of another phase, run in processes of
# their own beside the main one
# ---------------------------------------------------------------------------

# Once the kernels are timed, the host link measured and [ring serve]'s
# 68 GiB freed, the main process starts one process per lane on the same
# card and drives its other serving phases meanwhile.  A lane runs its own
# phases, then, like the main process once its own are done, takes the
# card == CPU phases of QUEUE one at a time (heaviest first) until none is
# left; each phase runs with the counters of the process that runs it.  A
# lane writes its log under build/smoke_lanes; the main process prints
# each log when it joins the lanes, fails if a lane failed or a queued
# phase never finished, then runs [train parity] (30 GiB of the card),
# [train] (whose step times need the card to itself) and [dp train].
CKPT_SERVE_DIR = os.path.join(ROOT, "build", "ckpt_serve")
CKPT_SERVE_ARGS = ["--arch", "gemma-2b", "--device", "cuda", "--batch", "8",
                   "--max-len", "1024", "--requests", "16", "--max-new",
                   "32", "--seed", "0"]


def _summary_counts(line):
    """Every count of the launcher's one-engine summary line: the tokens
    and each ``key=value`` but the seconds and tok/s."""
    import re
    counts = dict(re.findall(r"(\w+)=(\w+)", line))
    counts["tokens_out"] = re.search(r"(\d+) tokens in ", line).group(1)
    return counts


def ckpt_serve_phase(torch, np, card):
    """Full-width gemma-2b drawn on the card as the serving launcher draws
    it (seed 0), saved by the port's CheckpointManager as the trainer's
    ``dict(params=...)``, then served twice through ``launch.serve.main``
    at the same seed: with ``--ckpt`` (every restored leaf bit-equal to
    the drawn one) and without; both summaries agree in every count, and
    the ``--ckpt`` drain runs K1 once a layer a tick."""
    import contextlib
    import io
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeEngine
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import leaves_with_paths

    cfg = ARCHS["gemma-2b"]
    bundle, drawn = load_model(torch, cfg)
    nbytes = _tree_bytes(drawn)
    real_restore = launch_serve.restore_params
    restored = {}

    def checked_restore(b, directory):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = real_restore(b, directory)
        torch.cuda.synchronize()
        restored["seconds"] = time.perf_counter() - t0
        want = dict(leaves_with_paths(drawn))
        got = dict(leaves_with_paths(tree))
        check(got.keys() == want.keys(), "ckpt serve: restored paths differ")
        restored["apart"] = [
            path for path, t in got.items()
            if t.dtype != want[path].dtype or t.device != want[path].device
            or not torch.equal(t.contiguous().view(torch.uint8),
                               want[path].contiguous().view(torch.uint8))]
        restored["leaves"] = len(got)
        return tree

    shutil.rmtree(CKPT_SERVE_DIR, ignore_errors=True)
    runs = {}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(CKPT_SERVE_DIR, async_save=False).save(
            0, dict(params=drawn))
        save_s = time.perf_counter() - t0
        launch_serve.restore_params = checked_restore
        Timed = timed_engine_class(torch, ServeEngine)
        for label, extra in (("ckpt", ["--ckpt", CKPT_SERVE_DIR]),
                             ("drawn", [])):
            if label == "drawn":
                del drawn                # the launcher draws its own
                gc.collect()
                torch.cuda.empty_cache()
            engines = []

            class Recorded(Timed):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    engines.append(self)

            launch_serve.ServeEngine = Recorded
            pa.reset_launches()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = launch_serve.main(CKPT_SERVE_ARGS + extra)
            line = out.getvalue().strip().splitlines()[-1]
            print(f"[ckpt serve] run={label} {line}", flush=True)
            check(rc == 0, f"ckpt serve {label}: the launcher exited {rc}")
            eng = engines[0]
            runs[label] = dict(counts=_summary_counts(line),
                               launches=pa.LAUNCHES,
                               tick_ms=1e3 * eng.decode_s
                               / max(1, eng.stats.decode_steps))
            del engines, eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        launch_serve.restore_params = real_restore
        launch_serve.ServeEngine = ServeEngine
        shutil.rmtree(CKPT_SERVE_DIR, ignore_errors=True)
    check(restored.get("leaves", 0) > 0 and not restored["apart"],
          f"ckpt serve: restored leaves differ from the drawn ones: "
          f"{restored.get('apart')}")
    ck, dr = runs["ckpt"], runs["drawn"]
    check(ck["counts"] == dr["counts"], f"ckpt serve: the summaries' "
          f"counts differ: {ck['counts']} != {dr['counts']}")
    steps = int(ck["counts"]["decode_steps"])
    check(steps > 0 and ck["launches"] == cfg.num_layers * steps,
          f"ckpt serve: K1 launches {ck['launches']} != {cfg.num_layers} "
          f"layers x {steps} ticks")
    print(f"[ckpt serve] card='{card}' arch={cfg.name} "
          f"leaves={restored['leaves']} bytes={nbytes} "
          f"restored_equal_drawn=bitwise save_s={save_s:.2f} "
          f"save_GB_s={nbytes / save_s / 1e9:.2f} "
          f"restore_s={restored['seconds']:.2f} "
          f"restore_GB_s={nbytes / restored['seconds'] / 1e9:.2f} "
          f"(warm file cache) tokens_out={ck['counts']['tokens_out']} "
          f"decode_steps={steps} k1_launches={ck['launches']} "
          f"ms_per_decode_tick_ckpt={ck['tick_ms']:.3f} "
          f"ms_per_decode_tick_drawn={dr['tick_ms']:.3f} counts_equal=True",
          flush=True)
    return {"ckpt serve": ck["launches"]}


def _without_card(phase):
    """``phase(torch, np)`` called as ``phase(torch, np, card)``."""
    return lambda torch, np, card: phase(torch, np)


LANES = {
    "parity": (
        ("moe tp serve", moe_tp_serve_phase),
        ("ssm tp serve", ssm_tp_serve_phase),
        ("ckpt serve", ckpt_serve_phase),
    ),
    "bench": (
        ("bench serve",
         lambda torch, np, card: bench_serve_phase(torch, card)),
        ("spec serve", spec_serve_phase),
    ),
}
QUEUE = (
    ("a9b parity", _without_card(a9b_parity_phase)),
    ("a9b train cpu", _without_card(a9b_train_cpu_phase)),
    ("hybrid parity", _without_card(hybrid_parity_phase)),
    ("ring parity", _without_card(ring_parity_phase)),
    ("preempt parity", _without_card(preempt_parity_phase)),
    ("cluster parity", _without_card(cluster_parity_phase)),
    ("moe parity", _without_card(moe_parity_phase)),
    ("tp parity", _without_card(tp_parity_phase)),
    ("encdec parity", _without_card(encdec_parity_phase)),
    ("parity", _without_card(parity_phase)),
    ("dense parity", _without_card(dense_parity_phase)),
    ("sampled parity", _without_card(sampled_parity_phase)),
    ("int8 parity", _without_card(int8_parity_phase)),
    ("ssm parity", _without_card(ssm_parity_phase)),
    ("prng", prng_phase),
    ("train recovery", _without_card(train_recovery_phase)),
)
LANE_DIR = os.path.join(ROOT, "build", "smoke_lanes")
LANE_DEADLINE_S = 1150               # of the run's elapsed time
LANE_RESULT = "[lane result] "


def lane_file(kind, key):
    return os.path.join(LANE_DIR, f"{kind}.{key}")


def set_state(who, state):
    """``who``'s state for the others to read: ``own`` (its own phases),
    ``queue`` (taking queued phases) or ``done``."""
    with open(lane_file("state", who), "w") as f:
        f.write(state)


def queue_threads(who, cores):
    """CPU threads of torch for ``who``'s next queued phase: of ``cores``
    (torch's threads in a fresh process), those that the processes still
    driving their own phases leave, shared among those taking queued
    phases (the card == CPU phases' CPU drains run on them)."""
    states = {}
    for name in ("main", *LANES):
        try:
            with open(lane_file("state", name)) as f:
                states[name] = f.read()
        except OSError:
            states[name] = "own" if name != who else "queue"
    own = sum(st == "own" for name, st in states.items() if name != who)
    taking = max(1, sum(st == "queue" for st in states.values()))
    return max(1, -(-(cores - own) // taking))


def take_queue(torch, np, card, who, cores, note):
    """Run queued phases until none is left, each claimed by creating its
    claim file (one process wins it) and marked done after it passed;
    ``note(label)`` ends each.  Returns the launch counts they return."""
    set_state(who, "queue")
    results = {}
    for i, (label, phase) in enumerate(QUEUE):
        try:
            fd = os.open(lane_file("claim", i),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.write(fd, who.encode())
        os.close(fd)
        threads = queue_threads(who, cores)
        torch.set_num_threads(threads)
        out = phase(torch, np, card)
        if isinstance(out, dict):
            results.update(out)
        open(lane_file("done", i), "w").close()
        gc.collect()
        torch.cuda.empty_cache()
        note(f"queue {label} by={who} threads={threads}")
    set_state(who, "done")
    return results


def memory_note(torch):
    """The process's peak reserved card memory since the last note (a
    phase that resets the peak itself shows less), and the card's free
    memory now (every process's use counted)."""
    peak = torch.cuda.max_memory_reserved() / 2**30
    free = torch.cuda.mem_get_info()[0] / 2**30
    torch.cuda.reset_peak_memory_stats()
    return f"reserved_peak_GiB={peak:.2f} card_free_GiB={free:.2f}"


def lane_main(name):
    """One lane (``python3 chip_smoke.py --lane NAME``, started by
    ``main``): its own phases in order, then queued ones, a ``[phase]``
    line after each, then the launch counts its phases returned as one
    ``[lane result]`` JSON line.  Exits 1 on a failed check; dies with the
    process that started it."""
    try:                                 # prctl(PR_SET_PDEATHSIG, SIGKILL)
        import ctypes
        import signal
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    import numpy as np
    import torch
    import repro_torch  # noqa: F401
    if not torch.cuda.is_available():
        print("[FAIL] no CUDA card is visible to the lane", file=sys.stderr)
        return 2
    cores = torch.get_num_threads()
    torch.set_num_threads(2)
    card = card_line()
    t_start = time.perf_counter()
    t_lap = [t_start]

    def note(label):
        now = time.perf_counter()
        print(f"[phase] lane={name} {label} seconds={now - t_lap[0]:.1f} "
              f"elapsed={now - t_start:.1f} {memory_note(torch)}",
              flush=True)
        t_lap[0] = now

    results = {}
    try:
        for label, phase in LANES[name]:
            out = phase(torch, np, card)
            if isinstance(out, dict):
                results.update(out)
            gc.collect()
            torch.cuda.empty_cache()
            note(label)
        results.update(take_queue(torch, np, card, name, cores, note))
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr, flush=True)
        return 1
    print(f"[lane] name={name} seconds={time.perf_counter() - t_start:.1f}",
          flush=True)
    print(LANE_RESULT + json.dumps(results), flush=True)
    return 0


def start_lanes():
    """Start every lane; returns name -> (process, log path)."""
    shutil.rmtree(LANE_DIR, ignore_errors=True)
    os.makedirs(LANE_DIR)
    for name in ("main", *LANES):
        set_state(name, "own" if LANES.get(name, True) else "queue")
    lanes = {}
    for name in LANES:
        path = lane_file(name, "log")
        with open(path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--lane", name],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        lanes[name] = (proc, path)
        print(f"[lane] name={name} started pid={proc.pid} phases="
              f"{','.join(label for label, _ in LANES[name])} then the "
              "queue", flush=True)
    return lanes


def join_lanes(lanes, timeout):
    """Wait for each lane (at most ``timeout`` seconds in all), print its
    log, and fail on the first that failed; returns their results."""
    deadline = time.perf_counter() + timeout
    results = {}
    for name, (proc, path) in lanes.items():
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=max(1.0, deadline - t0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the deadline"
        with open(path) as f:
            text = f.read()
        print(f"[lane] name={name} log={os.path.relpath(path, ROOT)} "
              f"follows", flush=True)
        sys.stdout.write(text)
        print(f"[lane] name={name} rc={rc} waited_s="
              f"{time.perf_counter() - t0:.1f}", flush=True)
        fails = [ln for ln in text.splitlines() if ln.startswith("[FAIL]")]
        check(rc == 0, f"lane {name} failed (rc {rc}): "
              + (fails[-1] if fails else text[-3000:]))
        for ln in text.splitlines():
            if ln.startswith(LANE_RESULT):
                results.update(json.loads(ln[len(LANE_RESULT):]))
    missing = [label for i, (label, _) in enumerate(QUEUE)
               if not os.path.exists(lane_file("done", i))]
    check(not missing, f"queued phases never finished: {missing}")
    return results


def stop_lanes(lanes):
    for proc, _ in lanes.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main():
    if sys.argv[1:2] == ["--lane"]:
        return lane_main(sys.argv[2])
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
    lanes = {}
    cores = torch.get_num_threads()

    def lap(name):
        now = time.perf_counter()
        print(f"[phase] {name} seconds={now - t_lap[0]:.1f} "
              f"elapsed={now - t_start:.1f} {memory_note(torch)}",
              flush=True)
        t_lap[0] = now
        failed = {n: lane for n, lane in lanes.items()
                  if lane[0].poll() not in (None, 0)}
        if failed:                   # a lane that failed ends the run now
            join_lanes(failed, 1.0)

    try:
        card = card_line()
        print(f"[card] card='{card}' torch={torch.__version__} "
              f"cuda={torch.version.cuda} python={sys.version.split()[0]} "
              f"torch_threads={cores} cpus={len(os.sched_getaffinity(0))}",
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
        moe, grok = moe_lens(np)
        err = k1_check(torch, pa, ref, drain, hybrid, moe, grok)
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
                 RECURRENTGEMMA_GEOMETRY),
                ("granite-moe-3b-drain", moe, GRANITE_GEOMETRY),
                ("phi4-mini-tp2-drain", drain, PHI4_TP2_GEOMETRY))]
        lap("K1")
        launches, greedy = serve_phase(torch, np, card)
        lap("serve")
        gc.collect()                 # the gemma-2b engine and weights go
        torch.cuda.empty_cache()
        k2_err = k2_check(torch, fa, ref)
        k2_timing = k2_time(torch, fa, ref, card)
        k2_launches = dense_serve_phase(torch, np, card)
        lap("K2, dense serve")
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
        gc.collect()                 # the 54 GB of gemma2-27b go
        torch.cuda.empty_cache()
        host_link_phase(torch, card)
        lap("ring serve, host link")
        lanes.update(start_lanes())
        int8_launches, int8_warm = int8_serve_phase(torch, np, card)
        lap("int8 serve")
        gc.collect()
        torch.cuda.empty_cache()
        preempt_launches = preempt_serve_phase(torch, np, card, greedy,
                                               int8_warm)
        lap("preempt serve")
        gc.collect()
        torch.cuda.empty_cache()
        cluster_launches, model = cluster_serve_phase(torch, np, card)
        disagg_launches = disagg_serve_phase(torch, np, card, *model)
        del model
        gc.collect()                 # the cluster's gemma-2b goes
        torch.cuda.empty_cache()
        lap("cluster serve, disagg serve")
        hybrid_launches = hybrid_serve_phase(torch, np, card)
        gc.collect()                 # the 17 GB of recurrentgemma-9b go
        torch.cuda.empty_cache()
        ssm_serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap("hybrid serve, ssm serve")
        sampled_launches = sampled_serve_phase(torch, np, card, greedy)
        gc.collect()
        torch.cuda.empty_cache()
        lap("sampled serve")
        moe_launches = moe_serve_phase(torch, np, card)
        gc.collect()                 # the 6.6 GB of granite-moe go
        torch.cuda.empty_cache()
        moe_launches.update(grok_serve_phase(torch, np, card))
        gc.collect()                 # the 23 GB of grok-1's 2 layers go
        torch.cuda.empty_cache()
        lap("moe serve, grok serve")
        k2_paths = frontend_serve_phase(torch, np, card)
        gc.collect()                 # the 24.5 GB of pixtral-12b go
        torch.cuda.empty_cache()
        k2_paths.update(encdec_serve_phase(torch, np, card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("frontend serve, encdec serve")
        tp_launches = tp_serve_phase(torch, np, card)
        gc.collect()                 # the 7.7 GB of phi4-mini (twice) go
        torch.cuda.empty_cache()
        tp_launches.update(dp_serve_phase(torch, np, card))
        gc.collect()                 # the pool's gemma-2b goes
        torch.cuda.empty_cache()
        lap("tp serve, dp serve")
        tp_launches.update(take_queue(torch, np, card, "main", cores, lap))
        tp_launches.update(join_lanes(
            lanes, LANE_DEADLINE_S - (time.perf_counter() - t_start)))
        lap("lanes joined")
        torch.set_num_threads(cores)
        train_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        train_info = train_phase(torch, np, card)
        gc.collect()                 # the 40 GB of training state go
        torch.cuda.empty_cache()
        dp_train_phase(torch, np, card)
        lap("train parity, train, dp train")
        fsdp_tp_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_info = fsdp_tp_train_phase(torch, np, card)
        gc.collect()                 # the 40 GB of sharded state go
        torch.cuda.empty_cache()
        sharded_decode_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        dryrun_phase(torch, np, card, train_info, fsdp_info)
        lap("fsdp tp parity, fsdp tp train, sharded decode, dryrun")
        a9b_train_parity_phase(torch, np)
        gc.collect()
        torch.cuda.empty_cache()
        lap("a9b train parity")
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr)
        return 1
    finally:
        stop_lanes(lanes)
    k1 = dict(name="paged_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/paged_attention.cu",
              replaces="src/repro/kernels/paged_attention.py:100",
              launches=launches, max_abs_err=err, **timing,
              launches_by_path={"serve": launches,
                                "ring serve": ring_launches,
                                "int8 serve": int8_launches,
                                "hybrid serve": hybrid_launches,
                                **sampled_launches, **preempt_launches,
                                **cluster_launches, **disagg_launches,
                                **moe_launches, **tp_launches},
              timed=k1_timed)
    k2 = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/flash_attention.cu",
              replaces="src/repro/kernels/flash_attention.py:128",
              launches=k2_launches, max_abs_err=k2_err, **k2_timing,
              launches_by_path={"dense serve": k2_launches, **k2_paths})
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
