"""Readings for a cell's output-check limits: the program's widest and
mean logit gaps and the fp8 control's, seed by seed, at the cell's own
size and load.  Not part of a run.

    python3 -m perfbench.calibrate --workload phi4-mini.reason-batch \
        --seeds 11,12,13 --seconds 8

Each seed is a whole run (weights, set-up, a window of ``--seconds`` at
the cell's load) whose sampled finished requests go through the float32
reference twice: once to read the program's served tokens, once with
every projection in float8 (the control, :func:`perfbench.reference.
common.fp8_linear`) to read the gap of the token the control puts first
at each of the same positions.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from perfbench.run import ROOT, prepare_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    prepare_env()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card is visible", file=sys.stderr)
        return 2
    from perfbench import harness, registry
    cell = registry.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               control=bool(args.control))
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              **out["readings"])), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
