"""Canonical memory-access patterns and their optimization directions.

The paper's §5/§6 taxonomy (rs_tra / rr_tra / r_acc / nest, plus the
micro-patterns the engines sweep), grounded in the Hopper memory hierarchy
(HBM -> L2 -> shared memory / L1 -> registers).  The port of
``repro.core.patterns``; the advisor's ``SiteReport`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Tuple


class Pattern(str, Enum):
    # micro patterns (engine-level, paper §3/§4)
    SEQUENTIAL = "sequential"      # address-continuous stream (burstable)
    STRIDED = "strided"            # constant stride > contiguous tile
    RANDOM = "random"              # independent random indices (LFSR analogue)
    CHASE = "chase"                # dependent loads (pointer chasing)
    # application patterns (paper §6, database taxonomy)
    RS_TRA = "rs_tra"              # repetitive sequential traversal (weight streaming)
    RR_TRA = "rr_tra"              # repetitive random traversal
    R_ACC = "r_acc"                # random access (embedding / expert gather)
    NEST = "nest"                  # interleaved multi-cursor sequential (attention)


@dataclass(frozen=True)
class Knobs:
    """The paper's optimization parameters, in their GPU meaning.

    unit_bytes   — bytes per access (one thread's vector load, or one
                   gathered row)
    burst_bytes  — bytes of one tile that a block moves
    outstanding  — independent loads in flight
    stride       — inter-tile stride in units of burst_bytes (1 = contiguous)
    engines      — concurrent launches

    The defaults are the reference's, so that rows built with them carry
    the same knobs on both packages.
    """

    unit_bytes: int = 2 * 128
    burst_bytes: int = 2 * 8 * 128 * 128
    outstanding: int = 2
    stride: int = 1
    engines: int = 1

    def smem_bytes(self) -> int:
        """Buffering cost — the paper's BRAM column (Tables 3-5): buffers
        that must be resident = burst x outstanding per engine."""
        return self.burst_bytes * self.outstanding * self.engines


@dataclass(frozen=True)
class Advice:
    """Optimization direction for one pattern (the paper's §5/§6 prose,
    machine-readable)."""

    pattern: Pattern
    summary: str
    knob_moves: Tuple[str, ...]
    expected_bw_fraction: Tuple[float, float]  # (naive, optimized) of HBM peak


ADVICE: Dict[Pattern, Advice] = {
    Pattern.SEQUENTIAL: Advice(
        Pattern.SEQUENTIAL,
        "Stream with wide vector loads over large tiles; saturates HBM once "
        "the bytes in flight cover the latency-bandwidth product.",
        ("unit_bytes: 16-byte vector loads per thread",
         "burst_bytes: tiles of tens of KiB per block",
         "outstanding: unroll independent loads per thread"),
        (0.6, 0.95),
    ),
    Pattern.STRIDED: Advice(
        Pattern.STRIDED,
        "Throughput collapses ~1/stride once the stride exceeds the tile row; "
        "fold the stride into the tile (transpose/relayout) or widen unit size "
        "to amortize (paper Figs. 6/8/9).",
        ("relayout: make the strided dim minor (stride -> 1)",
         "unit_bytes: widen so each strided touch moves a full tile",
         "outstanding: raise to cover per-touch latency"),
        (0.05, 0.6),
    ),
    Pattern.RANDOM: Advice(
        Pattern.RANDOM,
        "Independent random indices pipeline but defeat bursts: bandwidth = "
        "unit_bytes / latency * outstanding, two orders below sequential "
        "(paper Table 8: 421 -> 5.8 GB/s on the FPGA).",
        ("unit_bytes: the ONLY lever that scales throughput linearly",
         "outstanding: raise until latency-covered (Eq. 4)",
         "sort/bucket indices when semantics allow -> SEQUENTIAL"),
        (0.005, 0.1),
    ),
    Pattern.CHASE: Advice(
        Pattern.CHASE,
        "Dependent loads serialize on full latency; no pipelining possible "
        "(paper Table 8: 0.99 GB/s on the FPGA).  Restructure the data "
        "(block the linked structure) or prefetch speculatively.",
        ("restructure: turn chains into index arrays -> RANDOM",
         "block: store next-pointers with payloads (unit_bytes up)"),
        (0.001, 0.01),
    ),
    Pattern.RS_TRA: Advice(
        Pattern.RS_TRA,
        "Weight streaming: sequential traversal repeated every step; the "
        "tile loads of step i+1 overlap the compute of step i.",
        ("burst_bytes: per-layer parameter tile",
         "overlap: prefetch layer i+1 during layer i compute",
         "layout: keep each gathered shard contiguous"),
        (0.5, 0.9),
    ),
    Pattern.RR_TRA: Advice(
        Pattern.RR_TRA,
        "Repeated random traversal (shuffled epochs): randomness amortized by "
        "large unit size (paper: unit-size dominates).",
        ("unit_bytes: page-sized records", "prefetch one epoch ahead"),
        (0.02, 0.3),
    ),
    Pattern.R_ACC: Advice(
        Pattern.R_ACC,
        "Pure random access (embedding rows, MoE expert pick): size the row to "
        "the transaction; one-hot matmul converts gather -> RS_TRA when the "
        "table is small relative to compute.",
        ("unit_bytes: row width >= 512B",
         "outstanding: batch the gathers (one launch, many rows)",
         "convert: one-hot matmul when table fits the FLOP budget"),
        (0.005, 0.15),
    ),
    Pattern.NEST: Advice(
        Pattern.NEST,
        "Interleaved multi-cursor sequential (attention q-blocks over kv "
        "stream): block both cursors so the inner stream stays in shared "
        "memory -- this is flash-attention blocking; the paper's 'nest' row "
        "hits full sequential bandwidth (Table 9).",
        ("block: tile q and kv cursors",
         "burst_bytes: kv tile sized to shared memory minus q/accumulator",
         "outstanding: 2 on the kv stream"),
        (0.3, 0.95),
    ),
}
