"""The paper's two benchmarking engines, timing the port's kernels.

The port of ``repro.core.engines``.  The reference times plain XLA ops
and keeps its Pallas kernels for tests; on the card a library copy or
gather would hide the knobs just as XLA does, so these engines time the
kernels themselves through :mod:`repro_torch.kernels.ops`: K4
``stream_copy``, K5 ``strided_copy``, K6 ``random_gather`` and K7
``pointer_chase`` on a CUDA device, their plain PyTorch versions on the
CPU.  Each row reports the measured bandwidth (Eq. 5, useful bytes over
the best of 3 trials) and the model's (``predict_bw`` under the spec in
use, :data:`~repro_torch.core.memmodel.H100` by default).

Timing: on the card, CUDA events around each trial after ``warmup`` calls,
with the card idle, then the L2 cache flushed (a read of four times its
size) and about a millisecond spun on the card before every trial, so a
trial never finds the previous one's lines and the host has enqueued the
call before the card reaches it; on the CPU, the host clock.  The device comes from :func:`repro_torch.resolve_device`:
the card unless the caller names the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.memmodel import (H100, HopperSpec, achieved_bw,
                                       predict_bw, theoretical_bw)
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops
from repro_torch.kernels import pointer_chase as _pc
from repro_torch.kernels import random_gather as _rg
from repro_torch.kernels import stream_copy as _sc


@dataclass
class Row:
    name: str
    pattern: str
    bytes_moved: float
    wall_s: float
    gbps_measured: float
    gbps_model: float
    extras: dict = field(default_factory=dict)

    def csv(self) -> str:
        us = self.wall_s * 1e6
        return (f"{self.name},{us:.2f},"
                f"gbps_measured={self.gbps_measured:.3f};"
                f"gbps_model={self.gbps_model:.3f};"
                + ";".join(f"{k}={v}" for k, v in self.extras.items()))


# about 1 ms of device time at the H100's clock, spun before each timed
# call: longer than the host takes to enqueue the call through its wrapper,
# allocating its output included
_COVER_CYCLES = 2_000_000


def flush_l2(device: torch.device, spec: HopperSpec = H100) -> None:
    """Evict the card's L2 by reading a buffer of four times its size (its
    values do not matter; the caching allocator hands back the same block
    each time)."""
    torch.empty(spec.l2_bytes, dtype=torch.float32, device=device).sum()


def trial_walls(fn, *args, device: torch.device, trials: int = 3,
                warmup: int = 1, prepare=None,
                flush: bool = True) -> List[float]:
    """Seconds of each of ``trials`` calls of ``fn(*args)`` after
    ``warmup`` untimed calls.  ``prepare(t)``, when given, runs before
    trial t outside the timed region and returns the arguments of that
    trial instead of ``args`` (t = 0 is the warm-up).  On the card the L2
    is flushed before each trial unless ``flush`` is False (to time a
    working set the warm-up left in the cache)."""
    def call_args(t):
        return prepare(t) if prepare is not None else args

    for _ in range(warmup):
        fn(*call_args(0))
    walls = []
    if device.type != "cuda":
        for t in range(1, trials + 1):
            a = call_args(t)
            t0 = time.perf_counter()
            fn(*a)
            walls.append(time.perf_counter() - t0)
        return walls
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for t in range(1, trials + 1):
        a = call_args(t)
        # the arguments are made and the card is idle; the flush and a
        # spin then run while the host enqueues the call, so the events
        # time the card, not the host catching up with it
        torch.cuda.synchronize(device)
        if flush:
            flush_l2(device)
        torch.cuda._sleep(_COVER_CYCLES)
        start.record()
        fn(*a)
        stop.record()
        stop.synchronize()
        walls.append(start.elapsed_time(stop) / 1e3)
    return walls


def _time(fn, *args, device, trials=3, warmup=1, prepare=None) -> float:
    return min(trial_walls(fn, *args, device=device, trials=trials,
                           warmup=warmup, prepare=prepare))


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Latency engine (paper §3.1)
# ---------------------------------------------------------------------------

def latency_chase(n_entries: int = 1 << 16, steps: int = 1 << 14,
                  seed: int = 0, spec: HopperSpec = H100,
                  device=None) -> Row:
    """Dependent-load chain latency (ns/hop measured; T_l modeled)."""
    device = resolve_device(device)
    table, builder = _pc.chain(n_entries, seed, device)
    wall = _time(lambda t: ops.pointer_chase(t, steps=steps), table,
                 device=device)
    unit = 4  # int32 payload
    return Row(
        name=f"chase_n{n_entries}", pattern=Pattern.CHASE.value,
        bytes_moved=steps * unit, wall_s=wall,
        gbps_measured=achieved_bw(steps * unit, wall) / 1e9,
        gbps_model=predict_bw(Pattern.CHASE, Knobs(unit_bytes=unit),
                              spec) / 1e9,
        extras=dict(ns_per_hop=f"{wall / steps * 1e9:.1f}",
                    t_l_model_ns=f"{spec.latency_s * 1e9:.0f}",
                    chain=builder))


def latency_by_region(n_regions: int = 8, entries_per_region: int = 1 << 14,
                      steps: int = 1 << 12, spec: HopperSpec = H100,
                      device=None) -> List[Row]:
    """Per-address-region chase (the paper's per-channel Table 2
    analogue)."""
    device = resolve_device(device)
    rows = []
    for r in range(n_regions):
        table, builder = _pc.chain(entries_per_region, r, device)
        wall = _time(lambda t: ops.pointer_chase(t, steps=steps), table,
                     device=device)
        rows.append(Row(
            name=f"region_{r}", pattern=Pattern.CHASE.value,
            bytes_moved=steps * 4, wall_s=wall,
            gbps_measured=achieved_bw(steps * 4, wall) / 1e9,
            gbps_model=predict_bw(Pattern.CHASE, Knobs(unit_bytes=4),
                                  spec) / 1e9,
            extras=dict(ns_per_hop=f"{wall / steps * 1e9:.1f}",
                        chain=builder)))
    return rows


# ---------------------------------------------------------------------------
# Bandwidth engine (paper §3.2/§4.2)
# ---------------------------------------------------------------------------

def bw_sequential(rows: int = 4096, cols: int = 2048,
                  dtype: torch.dtype = torch.float32, mode: str = "copy",
                  block_rows: int = 256, spec: HopperSpec = H100,
                  device=None) -> Row:
    """K4 over a (rows, cols) array in tiles of ``block_rows`` whole
    rows."""
    device = resolve_device(device)
    x = torch.ones((rows, cols), dtype=dtype, device=device)
    wall = _time(lambda a: ops.stream_copy(a, block_rows=block_rows,
                                           mode=mode), x, device=device)
    nbytes = x.numel() * x.element_size() * 2  # read + write
    knobs = Knobs(unit_bytes=128 * x.element_size(),
                  burst_bytes=cols * x.element_size() * 8)
    return Row(
        name=f"seq_{dtype_name(dtype)}_{rows}x{cols}",
        pattern=Pattern.SEQUENTIAL.value, bytes_moved=nbytes, wall_s=wall,
        gbps_measured=achieved_bw(nbytes, wall) / 1e9,
        gbps_model=predict_bw(Pattern.SEQUENTIAL, knobs, spec) / 1e9,
        extras=dict(theoretical_gbps=f"{theoretical_bw(spec) / 1e9:.0f}",
                    **_sc.kernel_knobs(x, block_rows)))


def bw_strided(rows: int, cols: int, stride: int, block_rows: int = 8,
               dtype: torch.dtype = torch.float32, spec: HopperSpec = H100,
               device=None) -> Row:
    """K5: block-rows read ``stride`` blocks apart, written densely."""
    device = resolve_device(device)
    x = torch.ones((rows, cols), dtype=dtype, device=device)
    wall = _time(lambda a: ops.strided_copy(a, block_rows=block_rows,
                                            stride=stride), x, device=device)
    nbytes = x.numel() * x.element_size() * 2
    knobs = Knobs(unit_bytes=cols * x.element_size() * block_rows,
                  stride=stride)
    return Row(
        name=f"stride_{stride}", pattern=Pattern.STRIDED.value,
        bytes_moved=nbytes, wall_s=wall,
        gbps_measured=achieved_bw(nbytes, wall) / 1e9,
        gbps_model=predict_bw(Pattern.STRIDED, knobs, spec) / 1e9,
        extras=dict(block_rows=block_rows))


def random_indices(n_idx: int, n_rows: int, seed: int, generator: str,
                   device: torch.device) -> torch.Tensor:
    """int32 row indices in [0, n_rows): the paper's 24-bit LFSR (the
    reference's, bit for bit) or a seeded ``torch.randint`` (the
    reference's "prng" row draws from ``jax.random``; the numbers differ,
    the distribution is the same)."""
    if generator == "lfsr":
        idx = _rg.lfsr_indices(n_idx, bits=24, seed=0xACE1 + seed,
                               device=device)
        return idx % n_rows
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, n_rows, (n_idx,), generator=gen, device=device,
                         dtype=torch.int32)


def bw_random(n_rows: int = 1 << 15, cols: int = 128, n_idx: int = 1 << 14,
              dtype: torch.dtype = torch.float32, generator: str = "lfsr",
              spec: HopperSpec = H100, device=None) -> Row:
    """K6: ``n_idx`` random rows of ``cols`` elements out of ``n_rows``."""
    device = resolve_device(device)
    x = torch.ones((n_rows, cols), dtype=dtype, device=device)
    # fresh indices per trial: re-timing the same gather measures the cached
    # working set, not memory (the paper's page-hit effect)
    wall = _time(lambda a, i: ops.random_gather(a, i), device=device,
                 prepare=lambda t: (x, random_indices(n_idx, n_rows, t,
                                                      generator, device)))
    unit = cols * x.element_size()
    nbytes = n_idx * unit * 2
    knobs = Knobs(unit_bytes=unit, outstanding=8)
    return Row(
        name=f"random_{generator}_row{unit}B",
        pattern=Pattern.RANDOM.value, bytes_moved=nbytes, wall_s=wall,
        gbps_measured=achieved_bw(nbytes, wall) / 1e9,
        gbps_model=predict_bw(Pattern.RANDOM, knobs, spec) / 1e9,
        extras=dict(table_bytes=x.numel() * x.element_size(),
                    **_rg.kernel_knobs(x, n_idx=n_idx)))


def bw_unit_size_sweep(units=(4, 16, 64, 256, 1024, 4096),
                       n_rows: Optional[int] = None, n_idx: int = 1 << 13,
                       spec: HopperSpec = H100, device=None) -> List[Row]:
    """paper Fig. 7: throughput vs transaction width (row bytes).
    ``n_rows`` None keeps the reference's 2^13 rows."""
    rows = []
    for u in units:
        r = bw_random(n_rows=n_rows or 1 << 13, cols=max(1, u // 4),
                      n_idx=n_idx, dtype=torch.float32, spec=spec,
                      device=device)
        r.name = f"unit_{u}B"
        r.extras["unit_bytes"] = u
        rows.append(r)
    return rows


def bw_outstanding_sweep(depths=(1, 2, 4, 8, 16, 32, 64),
                         spec: HopperSpec = H100) -> List[Row]:
    """paper Fig. 5: the modelled knee at NO* = ceil(T_l * BW / burst);
    model-only rows (the measured curve is the ``outstanding`` sweep)."""
    out = []
    burst = 64 * 1024
    for no in depths:
        knobs = Knobs(burst_bytes=burst, outstanding=no)
        out.append(Row(
            name=f"outstanding_{no}", pattern=Pattern.SEQUENTIAL.value,
            bytes_moved=0, wall_s=0.0, gbps_measured=float("nan"),
            gbps_model=predict_bw(Pattern.SEQUENTIAL, knobs, spec) / 1e9,
            extras=dict(smem_bytes=knobs.smem_bytes())))
    return out
