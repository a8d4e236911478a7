"""Roofline terms from a step traced on the meta device (the port of
``repro.core.roofline``).

The reference reads XLA's compiled artifact: ``cost_analysis()`` for
FLOPs and bytes, the HLO text for collective bytes, ``memory_analysis()``
for the per-device footprint.  The port has no compiler between the step
and the card: its step is the eager program itself, so it is traced.
:func:`trace_step` runs the step on meta tensors (shapes and dtypes, no
memory, no arithmetic) under :class:`~repro_torch.dist.fsdp.Accounting`,
which attributes every op to the mesh device it runs for:

- FLOPs, by ``torch.utils.flop_counter``'s formulas (the total is held
  against ``FlopCounterMode``'s);
- bytes, each op's inputs read once and outputs written once (eager
  PyTorch runs op by op, so this is the memory traffic without fusion,
  the reference's ``bytes accessed``);
- collective bytes, what each device receives through the single
  controller's own copies between shards (gathers, broadcasts, sums,
  and the backward's splits and sums);
- memory: argument bytes exact from the blocks' shapes (params,
  optimizer state, the batch or cache slice), and the peak of the live
  tensors on the device while the step runs, on top of them;
- the bytes of the ops issued inside a ``flash_inner``
  :func:`named_scope` (the unrolled attention's inner loop, the
  reference's ``jax.named_scope``): what a fused attention kernel would
  keep on chip.  The backward's ops are counted apart only where a remat
  recomputes the forward inside the scope; the reference's HLO also tags
  the transposed ops.

The reference's HLO parsers (``collective_stats``, ``fused_bytes*``)
read XLA's text, which the port never produces, and are not ported.
:class:`CellCost`, :func:`affine_extrapolate` and :func:`terms_from_cost`
are the reference's, over the card's :class:`~repro_torch.core.memmodel.
HopperSpec`.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.memmodel import H100, HopperSpec, RooflineTerms, \
    roofline


@dataclass(frozen=True)
class CellCost:
    flops: float
    bytes_raw: float      # every op's inputs and outputs (no fusion)
    bytes_fused: float    # the memory term's source (the same, eager)
    collective: float
    bytes_flash_inner: float = 0.0  # of bytes_raw, the ops inside a
    #                                 flash_inner scope (recorded, never
    #                                 taken off the memory term)

    def __add__(self, other):
        return CellCost(self.flops + other.flops,
                        self.bytes_raw + other.bytes_raw,
                        self.bytes_fused + other.bytes_fused,
                        self.collective + other.collective,
                        self.bytes_flash_inner + other.bytes_flash_inner)

    def scale(self, k: float) -> "CellCost":
        return CellCost(self.flops * k, self.bytes_raw * k,
                        self.bytes_fused * k, self.collective * k,
                        self.bytes_flash_inner * k)


FLASH_INNER = "flash_inner"
_SCOPE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_scope",
                                                        default=None)


@contextlib.contextmanager
def named_scope(name: str):
    """Ops issued inside run under ``name`` (the innermost scope wins):
    :class:`~repro_torch.dist.fsdp.Accounting` counts the bytes of those
    under :data:`FLASH_INNER` apart."""
    token = _SCOPE.set(name)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_scope() -> Optional[str]:
    return _SCOPE.get()


@dataclass
class Trace:
    """Per-device counts of one traced step (lists indexed by the mesh's
    flat device index) and ``FlopCounterMode``'s total."""
    flops: List[int]
    bytes: List[int]
    recv: List[int]
    args: List[int]
    peak: List[int]            # argument bytes + the live tensors' peak
    flash_inner: List[int]     # of ``bytes``, the ops in a flash_inner scope
    total_flops: int
    seconds: float = 0.0


def trace_step(fn, arguments, shards: int, counter: bool = True) -> Trace:
    """Run ``fn()`` (a step over meta tensors) under the accounting.
    ``arguments`` is [(tensor, device index)] of every tensor that exists
    before the step and that it reads or keeps (the blocks of params and
    optimizer state, the batch's slices, the cache's blocks): their bytes
    are each device's argument bytes.  ``counter`` also runs
    ``FlopCounterMode`` for the total to hold the per-device FLOPs
    against (it doubles the trace's time; a production mesh's trace
    leaves it out, ``total_flops`` is then the per-device sum)."""
    import contextlib
    import time
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist.fsdp import Accounting

    acct = Accounting(shards)
    args = [0] * shards
    seen = set()
    for t, k in arguments:
        if id(t) in seen:
            continue
        seen.add(id(t))
        acct.register(t, k)
        args[k] += t.numel() * t.element_size()
    t0 = time.perf_counter()
    fc = FlopCounterMode(display=False) if counter else None
    with fc if counter else contextlib.nullcontext(), acct:
        fn()
    return Trace(flops=list(acct.flops), bytes=list(acct.bytes),
                 recv=list(acct.recv), args=args,
                 peak=[a + p for a, p in zip(args, acct.peak)],
                 flash_inner=list(acct.flash_inner),
                 total_flops=int(fc.get_total_flops() if counter
                                 else sum(acct.flops)),
                 seconds=time.perf_counter() - t0)


def cost_of(trace: Trace) -> CellCost:
    """The busiest device's counts (a step lasts as long as its slowest
    device): the reference's per-device ``cost_of``.  The memory term
    stays every op's bytes; the flash_inner share is recorded beside
    it, as the reference records its scope's bytes."""
    k = max(range(len(trace.flops)),
            key=lambda i: (trace.flops[i], trace.bytes[i]))
    return CellCost(float(trace.flops[k]), float(trace.bytes[k]),
                    float(trace.bytes[k]), float(max(trace.recv)),
                    float(trace.flash_inner[k]))


def affine_extrapolate(c_a: CellCost, c_b: CellCost, nb_a: int, nb_b: int,
                       nb_target: int) -> CellCost:
    """cost(nb) = base + slope*nb, from two measured points."""
    dn = nb_b - nb_a
    slope = (c_b + c_a.scale(-1)).scale(1.0 / dn)
    base = c_a + slope.scale(-nb_a)
    return base + slope.scale(nb_target)


def terms_from_cost(cost: CellCost, chips: int, model_flops_per_chip: float,
                    spec: HopperSpec = H100) -> RooflineTerms:
    return roofline(cost.flops, cost.bytes_fused, cost.collective, chips,
                    model_flops=model_flops_per_chip, spec=spec)


def memory_summary(trace: Trace) -> Dict[str, float]:
    """The reference's keys, for the busiest device: argument bytes and
    the peak (arguments + live tensors), and both per device."""
    return dict(argument_size_in_bytes=float(max(trace.args)),
                peak_bytes_per_device=float(max(trace.peak)),
                argument_bytes_by_device=list(trace.args),
                peak_bytes_by_device=list(trace.peak))
