"""Sweep registry + runner.

The port of ``repro.bench.registry``.  Each paper table/figure is one
registered sweep: a function ``fn(ctx: SweepContext) -> None`` that measures
and calls ``ctx.emit``.  ``run_sweeps`` executes a selection on one device
(the card unless the caller names the CPU), collects a :class:`BenchRun`,
optionally persists it as ``BENCH_torch_<timestamp>.json``, and echoes the
``name,us_per_call,derived`` CSV.
"""
from __future__ import annotations

import dataclasses
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.bench.schema import (BenchResult, BenchRun, Timing,
                                      env_fingerprint, spec_to_dict)
from repro_torch.core.engines import trial_walls
from repro_torch.core.memmodel import H100, HopperSpec, predict_bw
from repro_torch.core.patterns import Knobs, Pattern


@dataclass(frozen=True)
class SweepSpec:
    name: str
    paper_ref: str
    fn: Callable[["SweepContext"], None]
    doc: str = ""


REGISTRY: Dict[str, SweepSpec] = {}

# canonical execution order == the paper's presentation order
ORDER: List[str] = []


def register(name: str, paper_ref: str = ""):
    """Decorator: ``@register("latency", "Table 2 / Fig 6")``."""

    def deco(fn: Callable[["SweepContext"], None]):
        if name in REGISTRY:
            raise ValueError(f"duplicate sweep {name!r}")
        REGISTRY[name] = SweepSpec(name=name, paper_ref=paper_ref, fn=fn,
                                   doc=(fn.__doc__ or "").strip())
        ORDER.append(name)
        return fn

    return deco


class SweepContext:
    """Handed to each sweep: scale flag, spec, device, timing, and the emit
    sink.  ``devices`` is the device group a distributed sweep spreads
    over (None: the sweep's default; a caller's list may repeat a
    device)."""

    def __init__(self, sweep: str, fast: bool, spec: HopperSpec = H100,
                 echo: bool = True, device: Optional[torch.device] = None,
                 devices: Optional[Sequence] = None):
        self.sweep = sweep
        self.fast = fast
        self.spec = spec
        self.echo = echo
        self.device = resolve_device(device)
        self.devices = None if devices is None else list(devices)
        self.results: List[BenchResult] = []

    # -- measurement --------------------------------------------------------

    def timeit(self, fn, *args, trials: int = 3, warmup: int = 1) -> Timing:
        """Best/mean of ``trials`` calls after ``warmup``: CUDA events
        around each call on the card (L2 flushed before each), the host
        clock on the CPU."""
        walls = trial_walls(fn, *args, device=self.device, trials=trials,
                            warmup=warmup)
        return Timing(best_s=min(walls), mean_s=sum(walls) / len(walls),
                      trials=trials)

    # -- emission -----------------------------------------------------------

    def header(self, title: str) -> None:
        if self.echo:
            print(f"# --- {title} ---", flush=True)

    def emit(self, name: str, *, pattern: Optional[Pattern] = None,
             knobs: Optional[Knobs] = None, timing: Optional[Timing] = None,
             us: Optional[float] = None, bytes_moved: float = 0.0,
             gbps_measured: Optional[float] = None,
             gbps_predicted: Optional[float] = None,
             **extras) -> BenchResult:
        """Record one row.  ``gbps_measured`` defaults to Eq. 5
        (``bytes_moved / best wall``) and ``gbps_predicted`` to
        ``predict_bw(pattern, knobs)`` under the context spec, so every row
        carries both columns.  ``bytes_moved`` is kept in the extras."""
        wall = timing.best_s if timing else (us or 0.0) * 1e-6
        if gbps_measured is None:
            gbps_measured = (bytes_moved / wall / 1e9) if wall > 0 else 0.0
        if gbps_predicted is None:
            if pattern is not None:
                gbps_predicted = predict_bw(pattern, knobs or Knobs(),
                                            self.spec) / 1e9
            else:
                gbps_predicted = 0.0
        r = BenchResult(
            name=name, sweep=self.sweep,
            pattern=pattern.value if pattern is not None else None,
            knobs=dataclasses.asdict(knobs) if knobs is not None else {},
            us_per_call=wall * 1e6 if us is None else us,
            gbps_measured=float(gbps_measured),
            gbps_predicted=float(gbps_predicted),
            timing=timing,
            extras={k: v for k, v in extras.items()},
        )
        if bytes_moved:
            r.extras.setdefault("bytes_moved", bytes_moved)
        if timing is not None:
            r.extras.setdefault("mean_us", f"{timing.mean_s * 1e6:.2f}")
            r.extras.setdefault("trials", timing.trials)
        self.results.append(r)
        if self.echo:
            print(r.csv(), flush=True)
        return r


def run_sweeps(names: Optional[Sequence[str]] = None, fast: bool = False,
               spec: HopperSpec = H100, echo: bool = True,
               out_dir: Optional[str] = None,
               calibration: Optional[Dict] = None,
               device=None, devices: Optional[Sequence] = None) -> BenchRun:
    """Run the selected sweeps (default: all, in registration order) on
    ``device`` (default: the card; raises without one); ``devices`` is the
    device group of the distributed sweep (``dist_serve``).

    Per-sweep exceptions are caught and recorded in ``run.failures`` —
    the CLI turns those into a nonzero exit, the library API never throws
    mid-campaign.  With ``out_dir`` the run is persisted as
    ``BENCH_torch_<timestamp>.json`` and the path stored in
    ``run.env["path"]``.
    """
    import repro_torch.bench.sweeps  # noqa: F401  (registers every sweep)

    device = resolve_device(device)
    selected = list(names) if names else list(ORDER)
    unknown = [n for n in selected if n not in REGISTRY]
    if unknown:
        raise KeyError(f"unknown sweeps {unknown}; known: {sorted(REGISTRY)}")

    run = BenchRun(env=env_fingerprint(device), spec=spec_to_dict(spec),
                   calibration=calibration)
    run.env["fast"] = fast
    for name in selected:
        sw = REGISTRY[name]
        ctx = SweepContext(sweep=name, fast=fast, spec=spec, echo=echo,
                           device=device, devices=devices)
        ctx.header(f"{name} ({sw.paper_ref})" if sw.paper_ref else name)
        try:
            sw.fn(ctx)
        except Exception:  # noqa: BLE001 — one bad sweep must not kill the run
            run.failures[name] = traceback.format_exc()
            if echo:
                print(f"# FAILED {name}", flush=True)
                traceback.print_exc()
        run.results.extend(ctx.results)
    if out_dir:
        run.save(out_dir)  # records the path in run.env["path"] pre-dump
    return run
