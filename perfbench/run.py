"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m perfbench.run --workload phi4-mini.reason-batch \
        --seed 1234 --seconds 30 --trace 0

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (it exits with 2 and prints no result otherwise).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
of the profiled slice, and a ``breakdown``.  ``correct`` is the output
check (:func:`perfbench.harness.check_outputs`); its numbers and limits are
the line's last key, ``checks``, and the last lines on standard error.
Every build and kernel cache the run writes lies under ``build/`` of the
checkout.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def prepare_env() -> None:
    """Caches inside the checkout, at fixed paths; the port's sources on
    the import path."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["REPRO_TORCH_TUNEPLANS"] = str(build / "tuneplans_torch.json")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden package's, the
    whole name compared (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def result_line(cell, out: dict, trace_on: bool, kind: str,
                cold: bool = False) -> dict:
    from perfbench import harness, registry
    metrics = {}
    if not trace_on:
        for m in cell.end_to_end:
            v = out["setup_s"] if m["name"] == "setup_s" \
                else out["e2e"][m["name"]]
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for name, read in registry.readers(cell.per_layer).items():
            v = read(out["records"])
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = dict(value=v, unit=unit)
    checks = harness.verdict(cell, out["readings"])
    device = dict(platform="gpu", kind=kind, count=cell.chips,
                  memory_peak_bytes=out["memory_peak_bytes"])
    line = dict(correct=harness.passed(checks), attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=device)
    if trace_on:
        sl = out["records"]["slice"]
        device.update(busy_s=sl.get("busy_s", 0.0),
                      window_s=sl.get("window_s", 0.0))
        line["breakdown"] = dict(device_ops=sl.get("device_ops", []),
                                 idle_gaps=sl.get("idle_gaps", []))
    # set-up built the port's kernels (a checkout's first run): its
    # ``setup_s`` holds the nvcc build
    line["setup_built_kernels"] = cold
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card is visible", file=sys.stderr)
        return 2
    from perfbench import harness, registry
    cell = registry.load_cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import library_path
    cold = not library_path(harness.K1).exists()
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(0), cold)
    info = dict(workload=cell.name, seed=args.seed,
                window_s=out["window_s"], e2e=out["e2e"],
                live_kv_bytes_peak=out["live_kv_bytes_peak"],
                window_stats=out["window_stats"], host=out["host"],
                check=out["readings"])
    print("info " + json.dumps(info), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (must be {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
