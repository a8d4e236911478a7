"""Serving launcher: the continuous-batching engine over fresh weights
drawn from a seeded generator, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 16 --batch 8 --max-len 1024 --max-new 32

``--cache`` picks the KV backend (``auto`` lets the engine pick: paged);
``--kv-int8`` stores the KV cache as int8 with a float32 scale per token;
prefill attention is the reference launcher's, ``chunked`` with 64-token
blocks.  ``--arch gemma2-27b`` serves its sliding-window layers from ring
pages; ``recurrentgemma-9b`` and ``mamba2-130m`` keep their recurrent
state beside the pools (mamba2-130m, with no attention layer, has none).  ``--smoke`` serves the same architecture at smoke width;
``--device cpu`` runs the plain PyTorch path on the CPU (without it, a
host with no card is an error).  ``--priority`` gives the requests
scheduler classes (``mixed``: odd rids high), which admit high first and
let a high request preempt a low one when slots or pages run out.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import RuntimeFlags, build
from repro_torch.serve import Request, ServeEngine

# request i's scheduler class under each --priority mix (the reference
# launcher's)
_PRIORITY_MIX = {"off": lambda i: 0, "low": lambda i: 0,
                 "high": lambda i: 1, "mixed": lambda i: i % 2}


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
    args = ap.parse_args(argv)

    cfg = smoke_config(ARCHS[args.arch]) if args.smoke else ARCHS[args.arch]
    flags = RuntimeFlags(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                         kv_dtype="int8" if args.kv_int8 else "native")
    bundle = build(cfg, flags, device=args.device)
    gen = torch.Generator(device=bundle.device).manual_seed(args.seed)
    params = bundle.init(gen)
    eng = ServeEngine(bundle, params, args.batch, args.max_len,
                      window=args.window,
                      cache_backend=None if args.cache == "auto" else args.cache,
                      device=args.device)
    rng = np.random.default_rng(args.seed)
    mix = _PRIORITY_MIX[args.priority]
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, 24))).astype(np.int32)
        eng.add_request(Request(rid=i, prompt=prompt,
                                max_new_tokens=args.max_new,
                                priority=mix(i)))
    t0 = time.perf_counter()
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
