#!/usr/bin/env python3
"""K1 (``paged_attention``) of several checkouts side by side on one CUDA
card.  Run from the root of a checkout, naming the checkouts to compare
(each the root of an unpacked tree, e.g. from ``git archive``) in the order
to run them; parent, change, change, parent shows the drift between runs:

    python3 tools/k1_compare.py build/parent . . build/parent

Each checkout runs in a process of its own, with its own package and its
own build of the kernels.  For each it prints, one JSON object a line, each
tensor-core K1 kernel's registers and spills (ptxas), its instruction
count and its opcode histogram (``cuobjdump --dump-sass``), then the
checkout's own ``chip_smoke.k1_time`` at the six shapes chip_smoke.py
times (its ``[K1 time]`` lines and their numbers).  The last line is the
card's name and power limit.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "paged_attention_mma_kernel"
INSTRUCTION = re.compile(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def ptxas(log):
    """{kernel function: (registers, spill stores, spill loads)} from an
    ``nvcc -Xptxas=-v`` log."""
    out, cur, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), *spills)
    return out


def sass(path, tool):
    """{kernel function: Counter of opcodes} of a built library."""
    text = subprocess.run([tool, "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = INSTRUCTION.match(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def one(root):
    """Everything above for the checkout at ``root``, in this process."""
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import numpy as np
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    build.build(["paged_attention"])
    regs = ptxas(build.build_log("paged_attention"))
    for name, ops in sass(build.library_path("paged_attention"),
                          build._tool("cuobjdump")).items():
        if KERNEL not in name:
            continue
        r = regs.get(name, (None, None, None))
        print(json.dumps({"tree": root, "kernel": name, "registers": r[0],
                          "spill_stores": r[1], "spill_loads": r[2],
                          "instructions": sum(ops.values()),
                          "opcodes": dict(sorted(ops.items()))}), flush=True)
    card = smoke.card_line()
    drain = smoke.drain_lens(np)
    for label, lens, geometry in (
            ("full", [1024] * 8, smoke.MAIN_GEOMETRY),
            ("drain", drain, smoke.MAIN_GEOMETRY),
            ("gemma2-27b-ring", smoke.RING_LENS, smoke.RING_GEOMETRY),
            ("gemma2-27b-global", smoke.RING_LENS[:3] + [8192],
             smoke.GLOBAL_GEOMETRY),
            ("gemma-2b-int8-drain", drain, smoke.INT8_GEOMETRY),
            ("gemma-2b-int8-full", [1024] * 8, smoke.INT8_GEOMETRY)):
        t = smoke.k1_time(torch, pa, ref, card, lens, label, geometry)
        print(json.dumps({"tree": root, "shape": label, **t}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one)
        return 0
    for tree in args.trees:
        print(f"[tree] {tree}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree], cwd=ROOT).returncode
        if rc:
            print(f"[FAIL] {tree}: exit code {rc}", file=sys.stderr)
            return rc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
