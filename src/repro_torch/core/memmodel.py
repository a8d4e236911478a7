"""Analytic memory-performance model (paper Eqs. 1-6), with Hopper constants.

The paper models HBM behaviour under a high-level toolchain with five
numbers: transaction latency ``T_l`` (Eq. 1), loop iteration interval
``tau_II`` (Eqs. 2-4: serialized / pipelined / pipelined with NO
outstanding requests), achieved bandwidth (Eq. 5) and theoretical bandwidth
(Eq. 6).  The port of ``repro.core.memmodel``: the same equations, line for
line, over a :class:`HopperSpec` whose constants are the H100's.  Each
bench row carries the measured and the modelled column; ``bench.calibrate``
fits ``latency_s`` and ``hbm_bw`` to the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.patterns import Knobs, Pattern


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (tile/page/bucket rounding)."""
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class HopperSpec:
    """Hardware constants of one H100 SXM (NVIDIA's data sheet), and the
    transaction latency measured on it."""

    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12       # dense tensor-core rate
    hbm_bw: float = 3.35e12               # bytes/s
    hbm_bytes: int = 80 * 2**30
    l2_bytes: int = 50 * 2**20
    smem_bytes: int = 227 * 2**10         # shared memory a block can use
    # the SM clock's maximum, nvidia-smi --query-gpu=clocks.max.sm
    # (NVIDIA H100 80GB HBM3, 700.00 W): 1980 MHz
    clock_hz: float = 1980e6
    # one dependent load from HBM: the latency sweep's ns/hop over 256 MiB
    # chains (pointer_chase, 2^26 entries, 2^13 hops; chip_smoke.py's
    # [memory] phase on an NVIDIA H100 80GB HBM3 at 700.00 W: medians of
    # the eight chains 384.2 to 389.1 ns in three runs)
    latency_s: float = 386e-9

    @property
    def latency_cycles(self) -> float:
        return self.latency_s * self.clock_hz


H100 = HopperSpec()


# ---------------------------------------------------------------------------
# Paper equations
# ---------------------------------------------------------------------------

def t_l(spec: HopperSpec = H100) -> float:
    """Eq. 1 — absolute transaction latency (seconds)."""
    return spec.latency_s


def tau_ii_serialized(t_op: float, spec: HopperSpec = H100) -> float:
    """Eq. 2 — blocked loop: every access waits for the previous access AND
    the dependent op: tau = T_l + T_o."""
    return t_l(spec) + t_op


def tau_ii_pipelined(spec: HopperSpec = H100) -> float:
    """Eq. 3 — pipelined but dependence on returned data: tau = T_l."""
    return t_l(spec)


def tau_ii_outstanding(outstanding: int, spec: HopperSpec = H100) -> float:
    """Eq. 4 (steady-state form) — NO requests in flight:
    tau = max(1 cycle, T_l / NO)."""
    return max(1.0 / spec.clock_hz, t_l(spec) / max(1, outstanding))


def achieved_bw(total_bytes: float, wall_s: float) -> float:
    """Eq. 5 — achieved bandwidth from bytes moved and timed seconds."""
    return total_bytes / wall_s


def theoretical_bw(spec: HopperSpec = H100) -> float:
    """Eq. 6 analogue — the card's peak HBM bandwidth (its N*W*F/8)."""
    return spec.hbm_bw


# ---------------------------------------------------------------------------
# Pattern throughput predictions
# ---------------------------------------------------------------------------

def predict_bw(pattern: Pattern, knobs: Knobs,
               spec: HopperSpec = H100) -> float:
    """Predicted bytes/s for an engine running ``pattern`` with ``knobs``.

    Steady state per tile/touch: t = max(transfer_time, T_l / NO); the chase
    pattern forbids overlap entirely (NO == 1 by construction).
    """
    lat = t_l(spec)
    if pattern in (Pattern.SEQUENTIAL, Pattern.RS_TRA, Pattern.NEST):
        b = knobs.burst_bytes
        t = max(b / spec.hbm_bw, lat / max(1, knobs.outstanding))
        return min(spec.hbm_bw, b / t)
    if pattern == Pattern.STRIDED:
        # each touch moves unit_bytes of useful data but occupies the channel
        # for stride * unit worth of row activation; model as useful
        # fraction 1/stride down to the latency floor.
        b = knobs.unit_bytes
        t = max(b * knobs.stride / spec.hbm_bw,
                lat / max(1, knobs.outstanding))
        return min(spec.hbm_bw / max(1, knobs.stride), b / t)
    if pattern in (Pattern.RANDOM, Pattern.R_ACC, Pattern.RR_TRA):
        b = knobs.unit_bytes
        t = max(b / spec.hbm_bw, lat / max(1, knobs.outstanding))
        return min(spec.hbm_bw, b / t)
    if pattern == Pattern.CHASE:
        return knobs.unit_bytes / lat
    raise ValueError(pattern)


def aggregate_bw(pattern: Pattern, knobs: Knobs,
                 spec: HopperSpec = H100) -> float:
    """Multi-engine aggregate bytes/s (paper Tables 3-5 scaling): linear in
    the engine count, the paper's idealisation."""
    return predict_bw(pattern, knobs, spec) * max(1, knobs.engines)


def min_outstanding_for_peak(burst_bytes: int,
                             spec: HopperSpec = H100) -> int:
    """Knee of the paper's Fig. 5: NO* = ceil(T_l * BW / burst)."""
    return max(1, math.ceil(t_l(spec) * spec.hbm_bw / max(1, burst_bytes)))


def smem_ok(knobs: Knobs, spec: HopperSpec = H100,
            budget_fraction: float = 0.5) -> bool:
    """The paper's BRAM constraint (Tables 3-5): buffering must fit the
    shared memory of a block."""
    return knobs.smem_bytes() <= spec.smem_bytes * budget_fraction
