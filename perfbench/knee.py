"""The one-off rate sweep of an open-loop traffic mix on a configuration:
the highest rate the port sustains, from which an open-loop cell's fixed
rate is set.  Not part of a run.

    python3 -m perfbench.knee --config phi4-mini-3.8b \
        --traffic chat-online --rates 3,4,5,6,8 --seconds 30 --seed 1

One process; weights drawn from ``--seed`` once, the engine built and
warmed anew for each rate, as a run does.  Each rate serves the mix at
that mean rate (the same bursts and sizes; ``ramp_s`` before the window,
then until every request due in the window is done or ``drain_s`` has
passed).  One JSON line a rate: the tails, how many requests were due and
failed, and the slots busy and requests queued for a slot when serving
stops.  A rate is sustained when nothing failed and no request is left
waiting for a slot: past the knee every slot is taken and the queue grows
through the window and the drain.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from perfbench.run import ROOT, prepare_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated mean arrival rates, requests/s")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    prepare_env()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card is visible", file=sys.stderr)
        return 2
    from repro_torch.serve import Request
    from perfbench import harness, registry
    from perfbench.loadgen import Spec, Traffic
    config = registry.config_file(registry.benchmark(ROOT), args.config, ROOT)
    spec = Spec.from_dict(registry.traffic_file(args.traffic))
    if spec.loop != "open":
        raise SystemExit(f"traffic {args.traffic} is not an open loop")
    dev = torch.device("cuda")
    vocab = config["model"]["vocab_size"]
    bundle, params = harness.build(config, args.seed, dev)
    for rate in (float(r) for r in args.rates.split(",")):
        t = time.perf_counter()
        eng = harness.engine(bundle, params, spec, args.seed)
        harness.warm(eng, Request, spec, vocab, args.seed)
        run = harness.Run(eng, spec, Traffic(spec, args.seed, vocab),
                          Request)
        t_w0, t_w1, s0, s1, due, cut = harness.serve_open(
            run, spec, args.seconds, rate=rate)
        e2e, failed = harness.open_metrics(due, cut)
        row = dict(rate=rate, due=len(due), failed=failed,
                   sustained=failed == 0 and not eng.queue,
                   tokens_per_s=(s1["tokens_out"] - s0["tokens_out"])
                   / args.seconds,
                   slots_busy_at_end=sum(s is not None for s in eng.slots),
                   queued_at_end=len(eng.queue),
                   wall_s=time.perf_counter() - t, **e2e)
        print(json.dumps(row), flush=True)
        del eng, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
