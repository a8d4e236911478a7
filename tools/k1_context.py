#!/usr/bin/env python3
"""K1 (``paged_attention``) alone against K1 inside a decode step's traffic.
Needs one CUDA card; run from the root of a checkout:

    python3 tools/k1_context.py [--root CHECKOUT]

(``--root``: time the package of another checkout, e.g. one unpacked by
``git archive``, with this script's settings.)

A decode tick of the paged engine runs dozens of other kernels between two
K1 launches.  At gemma-2b's decode geometry (B 8, 8/1 heads, D 256, the
lengths of chip_smoke.py's profiled int8 window) this times K1 under
``torch.profiler`` (kernel time only, 30 launches) in two settings:

1. ``gemm``: each launch follows one bf16 GEMM of gemma-2b's MLP width
   ((8, 2048) x (2048, 16384), 64 MiB of weights through the L2);
2. ``gemm+48``: the same GEMM, then 48 small PyTorch kernels (24
   operations: elementwise, reductions, a sort, a top-k, a layer norm, each
   on an (8, 2048) float32 and a bfloat16 tensor), so that K1's machine
   code is no longer cached on the SMs when it launches;
3. ``gemm+48same``: the same GEMM, then 48 launches of one small kernel
   (an in-place multiply of the (8, 2048) float32 tensor by 1): as many
   launches between the GEMM and K1 as ``gemm+48``, little machine code.
   If K1 is slower after ``gemm+48`` than after ``gemm+48same``, the
   other kernels' code, not the launches or the gap, is what slows it.

for three routes: int8 pages on the tensor cores (bf16 q), bf16 pages
(pages of 8), and int8 pages on the CUDA cores (the route int8 took before,
32 splits).  It also prints each K1 kernel's machine-code size
(instructions, from ``cuobjdump --dump-sass``).  One JSON object a line;
the last line is the card's name and power limit.
"""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LENS = [258, 414, 151, 386, 373, 295, 370, 403]
B, HQ, HKV, D, TOKENS = 8, 8, 1, 256, 1024


def sass_sizes(build):
    """Instructions in each kernel function of K1's built library."""
    sass = subprocess.run([build._tool("cuobjdump"), "--dump-sass",
                           str(build.library_path("paged_attention"))],
                          capture_output=True, text=True, check=True).stdout
    sizes, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = m.group(1)
            sizes[cur] = 0
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]+\*/", line):
            sizes[cur] += 1
    return sizes


def inputs(torch, int8, gen):
    page = 16 if int8 else 8
    n = TOKENS // page
    pool = 1 + B * n
    dev = torch.device("cuda")
    q = torch.randn((B, HQ, D), generator=gen).to(dev, torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (pool, page, HKV, D), generator=gen,
                              dtype=torch.int8).to(dev) for _ in range(2))
        ks, vs = ((torch.rand((pool, page), generator=gen) * 0.05).to(dev)
                  for _ in range(2))
    else:
        k, v = (torch.randn((pool, page, HKV, D), generator=gen
                            ).to(dev, torch.bfloat16) for _ in range(2))
        ks = vs = None
    table = (1 + torch.randperm(B * n, generator=gen)).reshape(B, n)
    valid = torch.tensor(LENS, dtype=torch.int32, device=dev)
    return q, k, v, table.to(dev, torch.int32), valid, ks, vs, page, n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose package is timed (default: this)")
    sys.path.insert(0, os.path.join(os.path.abspath(ap.parse_args().root),
                                    "src"))
    import torch
    if not torch.cuda.is_available():
        print("k1_context needs a CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_core as core
    from repro_torch.kernels import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build.build(["paged_attention"])
    for name, n in sass_sizes(build).items():
        print(json.dumps({"sass": name, "instructions": n}), flush=True)

    dev = torch.device("cuda")
    x = torch.randn((8, 2048), device=dev, dtype=torch.bfloat16)
    w = torch.randn((2048, 16384), device=dev, dtype=torch.bfloat16)
    small = torch.randn((8, 2048), device=dev)
    small_bf16 = small.to(torch.bfloat16)
    fns = [torch.exp, torch.sin, torch.cos, torch.tanh, torch.sigmoid,
           torch.nn.functional.gelu, torch.nn.functional.silu,
           lambda t: torch.softmax(t, -1), lambda t: torch.cumsum(t, -1),
           lambda t: torch.sort(t, -1)[0], lambda t: torch.topk(t, 8)[0],
           lambda t: torch.nn.functional.layer_norm(t, (2048,)),
           lambda t: t * 2 + 1, torch.abs, torch.sqrt, torch.rsqrt,
           lambda t: t.amax(-1), lambda t: t.sum(-1), torch.log1p,
           lambda t: torch.where(t > 0, t, 0.0), torch.erf, torch.floor,
           lambda t: t.argmax(-1), lambda t: t.to(torch.float16)]
    gen = torch.Generator().manual_seed(0)
    routes = [("int8 tensor cores", True, False), ("bf16", False, False),
              ("int8 cuda cores", True, True)]
    for setting in ("gemm", "gemm+48", "gemm+48same"):
        for route, int8, cuda_cores in routes:
            q, k, v, table, valid, ks, vs, page, n = inputs(torch, int8, gen)
            if cuda_cores:
                splits = pa.split_count("cuda-cores", B, HKV, page, n,
                                        core.sm_count(0))
                cfg = core.KernelConfig("cuda-cores", pa.TILE, 1, D // 32)
            else:
                splits = pa.split_count(pa.route(q.dtype, k.dtype, D), B,
                                        HKV, page, n, core.sm_count(0))
                cfg = pa.kernel_config(q.dtype, k.dtype, D, page, n, splits)

            def step():
                torch.matmul(x, w)
                if setting == "gemm+48":
                    for f in fns:
                        f(small)
                        f(small_bf16)
                elif setting == "gemm+48same":
                    for _ in range(2 * len(fns)):
                        small.mul_(1.0)
                pa.launch(q, k, v, table, valid, cfg, splits, k_scale=ks,
                          v_scale=vs)
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(30):
                    step()
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and "paged_attention" in e.key]
            total = sum(e.self_device_time_total for e in evs) / 1e3
            count = sum(e.count for e in evs)
            print(json.dumps({"setting": setting, "route": route,
                              "config": str(cfg), "splits": splits,
                              "k1_ms": total / max(count, 1),
                              "launches": count}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
