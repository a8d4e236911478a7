"""Serving launcher: the continuous-batching engine over fresh weights
drawn from a seeded generator, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 16 --batch 8 --max-len 1024 --max-new 32

``--cache`` picks the KV backend (``auto`` lets the engine pick: paged);
``--kv-int8`` stores the KV cache as int8 with a float32 scale per token;
prefill attention is the reference launcher's, ``chunked`` with 64-token
blocks, and so is its MoE dispatch, ``dense``.  ``--arch gemma2-27b``
serves its sliding-window layers from ring pages; ``recurrentgemma-9b``
and ``mamba2-130m`` keep their recurrent state beside the pools
(mamba2-130m, with no attention layer, has none); the MoE stacks
(granite-moe-3b-a800m, grok-1-314b) serve from pages, pixtral-12b's text
prompts from the dense cache.  seamless-m4t-medium fails at its first
prefill, as the reference's launcher does: the requests carry no encoder
frames.  ``--smoke`` serves the same architecture at smoke width;
``--device cpu`` runs the plain PyTorch path on the CPU (without it, a
host with no card is an error).  ``--priority`` gives the requests
scheduler classes (``mixed``: odd rids high), which admit high first and
let a high request preempt a low one when slots or pages run out.

``--topology disagg`` serves through a
:class:`~repro_torch.serve.cluster.DisaggPool`: ``--prefill-replicas``
engines prefill and ship each finished prompt's pages to ``--dp`` decode
engines, all on the one device and sharing one weight tree;
``--link-bw`` prices the shipment against a decode-side prefill and
``--route`` pins the decision.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --topology disagg --dp 1 --requests 16 --batch 8 --max-len 1024

Tensor parallelism (``--tp`` > 1) and colocated replicas (``--dp`` > 1
under ``--topology colocated``) wait for the port of the reference's
``ServeMesh`` and ``ReplicaPool`` and exit with an error.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import RuntimeFlags, build
from repro_torch.serve import (DisaggConfig, DisaggPool, Request,
                               ServeEngine)

# request i's scheduler class under each --priority mix (the reference
# launcher's)
_PRIORITY_MIX = {"off": lambda i: 0, "low": lambda i: 0,
                 "high": lambda i: 1, "mixed": lambda i: i % 2}

_NOT_PORTED = ("is not ported yet: it needs the reference's ServeMesh and "
               "ReplicaPool (ROADMAP A9)")


def build_disagg_pool(bundle, params, *, prefill_replicas: int = 1,
                      decode_replicas: int = 1,
                      disagg_config: Optional[DisaggConfig] = None,
                      **engine_kw) -> DisaggPool:
    """The ``disagg`` topology: a prefill pool that ships every finished
    prompt's pages to a decode pool as a checksummed transfer entry
    (:class:`~repro_torch.serve.cluster.DisaggPool`), paged engines with
    the host swap tier on both sides.  Disaggregation is a scheduling
    topology, so the pools may share a device: every engine runs
    undistributed on the bundle's device and serves the one ``params``
    tree (no copy of the weights per engine).  The reference's ``tp`` > 1
    branch (an engine sharded over a device group) is not ported yet."""
    if prefill_replicas < 1 or decode_replicas < 1:
        raise ValueError("disagg topology needs >= 1 prefill and >= 1 "
                         "decode replica")
    engine_kw.setdefault("cache_backend", "paged")
    engines = [ServeEngine(bundle, params, **engine_kw)
               for _ in range(prefill_replicas + decode_replicas)]
    return DisaggPool(engines[:prefill_replicas],
                      engines[prefill_replicas:], config=disagg_config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=8,
                    help="decode ticks per host sync")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with per-token float32 scales")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights + traffic seed")
    ap.add_argument("--priority", default="off",
                    choices=sorted(_PRIORITY_MIX),
                    help="scheduler priority classes for the request mix")
    ap.add_argument("--cache", default="auto",
                    choices=("auto", "dense", "paged"),
                    help="KV backend; auto lets the engine pick")
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card is an error)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width per engine (only 1 is "
                         "ported)")
    ap.add_argument("--dp", type=int, default=1,
                    help="engine replicas: decode replicas under --topology "
                         "disagg (colocated replicas are not ported)")
    ap.add_argument("--topology", default="colocated",
                    choices=("colocated", "disagg"),
                    help="colocated: one engine prefills and decodes.  "
                         "disagg: a prefill pool ships finished prompts' "
                         "pages to a decode pool (DisaggPool); --dp counts "
                         "decode replicas")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="prefill-pool replicas under --topology disagg")
    ap.add_argument("--link-bw", type=float, default=32e9,
                    help="prefill->decode transfer link bandwidth (prices "
                         "the disagg-vs-colocated routing break-even)")
    ap.add_argument("--route", default="auto",
                    choices=("auto", "disagg", "colocated"),
                    help="pin the disagg router's per-request decision "
                         "(auto defers to the swap cost model)")
    args = ap.parse_args(argv)
    if args.tp != 1:
        raise SystemExit(f"--tp {args.tp} {_NOT_PORTED}")
    if args.topology == "colocated" and args.dp != 1:
        raise SystemExit(f"colocated --dp {args.dp} {_NOT_PORTED}")

    cfg = smoke_config(ARCHS[args.arch]) if args.smoke else ARCHS[args.arch]
    flags = RuntimeFlags(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                         moe_impl="dense",
                         kv_dtype="int8" if args.kv_int8 else "native")
    bundle = build(cfg, flags, device=args.device)
    gen = torch.Generator(device=bundle.device).manual_seed(args.seed)
    params = bundle.init(gen)
    engine_kw = dict(batch_size=args.batch, max_len=args.max_len,
                     window=args.window, seed=args.seed, device=args.device)
    if args.cache != "auto":
        engine_kw["cache_backend"] = args.cache
    if args.topology == "disagg":
        pool = build_disagg_pool(
            bundle, params, prefill_replicas=args.prefill_replicas,
            decode_replicas=args.dp, disagg_config=DisaggConfig(
                link_bw=args.link_bw,
                force=None if args.route == "auto" else args.route),
            **engine_kw)
        submit = pool.submit
    else:
        eng = ServeEngine(bundle, params, **engine_kw)
        submit = eng.add_request
    rng = np.random.default_rng(args.seed)
    mix = _PRIORITY_MIX[args.priority]
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, 24))).astype(np.int32)
        submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                       priority=mix(i)))
    t0 = time.perf_counter()
    if args.topology == "disagg":
        stats = pool.run()
        if bundle.device.type == "cuda":
            torch.cuda.synchronize(bundle.device)
        dt = time.perf_counter() - t0
        d = pool.dstats
        print(f"{stats.tokens_out} tokens in {dt:.2f}s "
              f"({stats.tokens_out / dt:.1f} tok/s) across "
              f"{len(pool.engines)} replica(s) x tp={args.tp}, "
              f"prefills={stats.prefills}, decode_steps={stats.decode_steps}, "
              f"decode_dispatches={stats.decode_dispatches}")
        print(f"disagg: {d.disagg_routed} shipped / {d.colocated_routed} "
              f"colocated, {d.transfers} transfers "
              f"({stats.transfer_bytes} bytes), "
              f"{stats.transfer_fallbacks} recompute fallbacks, "
              f"{d.rounds} rounds")
        return 0
    stats = eng.run_to_completion()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(bundle.device)
             if bundle.device.type == "cuda" else str(bundle.device))
    print(f"{cfg.name}{' (smoke)' if args.smoke else ''} on {where}, "
          f"{eng.backend} cache{' (int8)' if args.kv_int8 else ''}: "
          f"{stats.tokens_out} tokens in {dt:.2f}s "
          f"({stats.tokens_out / dt:.1f} tok/s), prefills={stats.prefills}, "
          f"prefill_retraces={stats.prefill_retraces}, "
          f"prefill_chunks={stats.prefill_chunks}, "
          f"decode_steps={stats.decode_steps}, "
          f"decode_dispatches={stats.decode_dispatches}, "
          f"prefix_hit_tokens={stats.prefix_hit_tokens}, "
          f"pages_peak={stats.pages_peak}, "
          f"ring_pages_peak={stats.ring_pages_peak}, "
          f"priority={args.priority}, preemptions={stats.preemptions}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
