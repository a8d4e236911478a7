"""Reduce a ``torch.profiler`` slice to what the per-layer metrics and the
breakdown read: the union of the device's operation intervals, the time of
the kernels matched by name, the operations that took most time, and the
longest idle gaps labelled by the harness span open on the host.

The harness wraps its calls into the program in ``record_function``
ranges named ``perfbench.<span>`` and the whole slice in
``perfbench.slice``; those host ranges and the device's operations share
the profiler's clock.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

SLICE = "perfbench.slice"
TOP = 10


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def reduce(device_ops: Sequence[Tuple[str, float, float]],
           host_spans: Sequence[Tuple[str, float, float]],
           match: Dict[str, str]) -> dict:
    """``device_ops``: (name, start, end) of every device operation, and
    ``host_spans``: (name, start, end) of the harness's ranges, in
    microseconds on the profiler's clock.  ``match`` maps a label to a
    substring of kernel names.  Returns seconds: the slice's length
    (``window_s``), the union of device intervals inside it
    (``busy_s``), each match's summed kernel time, the top operations and
    the longest idle gaps by the host span open at their start."""
    bounds = [(a, b) for n, a, b in host_spans if n == SLICE]
    if not bounds:
        return {}
    lo, hi = bounds[0]
    ops = [(n, max(a, lo), min(b, hi)) for n, a, b in device_ops
           if b > lo and a < hi]
    busy = union((a, b) for _, a, b in ops)
    by_name: Dict[str, float] = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    matched = {label: sum(b - a for n, a, b in ops if sub in n) * 1e-6
               for label, sub in match.items()}
    inner = sorted((a, b, n) for n, a, b in host_spans if n != SLICE)

    def label(t: float) -> str:
        best = "host between calls"
        for a, b, n in inner:
            if a > t:
                break
            if b > t:
                best = n      # the innermost: the latest start covering t
        return best

    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=(hi - lo) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                matched_s=matched,
                device_ops=[[n[:120], s * 1e-6] for n, s in top],
                idle_gaps=[[label(a), (b - a) * 1e-6] for a, b in idle],
                n_device_ops=len(ops))


def from_profiler(prof, match: Dict[str, str]) -> dict:
    """:func:`reduce` over a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device_ops, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("perfbench."):
            # the harness's ranges appear on both timelines; only the
            # host's copy is a span, and neither is a device operation
            if e.device_type != DeviceType.CUDA:
                host.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CUDA:
            device_ops.append((e.name, tr.start, tr.end))
    return reduce(device_ops, host, match)
