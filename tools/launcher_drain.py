#!/usr/bin/env python3
"""The serving launcher's two ways to drain one engine, timed on the card.
Needs one CUDA card; run from the root of a checkout:

    python3 tools/launcher_drain.py [--rounds N] [--requests N] [--max-new N]

``launch/serve.py`` with ``--tp 1 --dp 1`` builds one ``ServeEngine`` and
drains it.  It can drain it two ways:

1. ``fused``: ``eng.run_to_completion()``: queued requests are admitted
   once a window, and up to ``--window`` (8) decode ticks run between two
   host syncs;
2. ``step``: ``ReplicaPool([eng]).drain()``, as the reference's launcher
   drains every layout: requests are admitted before every tick, and every
   tick ends in a host sync.

Both drain full-width gemma-2b (bf16, weights drawn on the card from seed
0) over the launcher's own request mix and engine arguments (batch 8,
max_len 1024, 16 requests of 4-23 tokens, 32 new, seed 0), each on a new
engine over the same weights, ``--rounds`` times in the order fused, step,
step, fused (so that a drift of the host clock falls on both alike), after
one untimed drain.  One JSON object a line per drain (wall seconds from a
synchronized host clock, tokens, ticks, dispatches, prefills); the last
line is the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("launcher_drain: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import ReplicaPool
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import Request, ServeEngine

    cfg = ARCHS["gemma-2b"]
    flags = RuntimeFlags(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                         moe_impl="dense")
    bundle = build(cfg, flags, device="cuda")
    params = bundle.init(torch.Generator(device=bundle.device).manual_seed(0))
    engine_kw = dict(batch_size=8, max_len=1024, window=8, seed=0,
                     device="cuda")

    def drain(mode, requests):
        eng = ServeEngine(bundle, params, **engine_kw)
        rng = np.random.default_rng(0)
        for i in range(requests):
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(4, 24))
                                  ).astype(np.int32)
            eng.add_request(Request(rid=i, prompt=prompt,
                                    max_new_tokens=args.max_new))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = (eng.run_to_completion() if mode == "fused"
                 else ReplicaPool([eng]).drain())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(mode=mode, wall_s=wall, tokens_out=stats.tokens_out,
                    tok_s=stats.tokens_out / wall,
                    decode_steps=stats.decode_steps,
                    decode_dispatches=stats.decode_dispatches,
                    prefills=stats.prefills,
                    ms_per_token=1e3 * wall / stats.tokens_out)

    drain("step", 4)                       # untimed: builds and warms
    for _ in range(args.rounds):
        for mode in ("fused", "step", "step", "fused"):
            print(json.dumps(drain(mode, args.requests)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "card unknown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
