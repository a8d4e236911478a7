"""Knob search driven by the analytic memory model (paper §5 applied).

The port of ``repro.core.autotune``: given a pattern, a
:class:`~repro_torch.core.memmodel.HopperSpec` and a budget of shared
memory per block, pick the kernel parameters the model predicts best — the
paper's "choose the right optimization level that meets throughput while
consuming as few resources as possible".  The candidate grids, the 2% rule
and the tie-break are the reference's, so the same constants give the same
knobs; the one change is the budget, a block's shared memory
(``spec.smem_bytes``, :meth:`Knobs.smem_bytes`) where the reference uses
the TPU's VMEM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from repro_torch.core.memmodel import (H100, HopperSpec,
                                       min_outstanding_for_peak, predict_bw,
                                       smem_ok)
from repro_torch.core.patterns import Knobs, Pattern


@dataclass(frozen=True)
class TunedResult:
    knobs: Knobs
    predicted_gbps: float
    smem_bytes: int
    note: str = ""
    # best predicted bandwidth over the whole feasible set (GB/s) — the
    # chosen knobs are within 2% of this; monotone in the budget
    best_gbps: float = 0.0
    # measured/predicted ratio for this pattern when tuned under a
    # calibration (repro_torch.bench.calibrate); None in analytic mode
    measured_vs_predicted: Optional[float] = None


def tune_pattern(pattern: Pattern, spec: HopperSpec = H100,
                 smem_budget_fraction: float = 0.5,
                 unit_candidates: Iterable[int] = (256, 512, 1024, 2048, 4096),
                 burst_candidates: Iterable[int] = tuple(
                     2 ** i for i in range(12, 23)),
                 outstanding_candidates: Iterable[int] = (1, 2, 3, 4, 8, 16, 32),
                 calibration=None,
                 ) -> TunedResult:
    """Smallest-resource knobs within 2% of the best predicted bandwidth
    (the paper's resource-throughput tradeoff, Tables 3-5).

    ``calibration`` (a :class:`repro_torch.bench.calibrate.
    CalibrationResult`) switches to measured mode: the search runs against
    the fitted spec, and the result carries the pattern's
    measured/predicted ratio.
    """
    if calibration is not None:
        spec = calibration.spec
    best: List[Tuple[float, int, Knobs]] = []
    for u in unit_candidates:
        for b in burst_candidates:
            if b < u:
                continue
            for no in outstanding_candidates:
                k = Knobs(unit_bytes=u, burst_bytes=b, outstanding=no)
                if not smem_ok(k, spec, smem_budget_fraction):
                    continue
                bw = predict_bw(pattern, k, spec)
                best.append((bw, k.smem_bytes(), k))
    if not best:
        raise ValueError("no feasible knobs under the shared-memory budget")
    top_bw = max(b[0] for b in best)
    feasible = [b for b in best if b[0] >= 0.98 * top_bw]
    bw, smem, knobs = min(feasible, key=lambda t: t[1])
    ratio = (calibration.measured_vs_predicted(pattern)
             if calibration is not None else None)
    return TunedResult(knobs=knobs, predicted_gbps=bw / 1e9, smem_bytes=smem,
                       note=f"NO*={min_outstanding_for_peak(knobs.burst_bytes, spec)}",
                       best_gbps=top_bw / 1e9, measured_vs_predicted=ratio)


def tune_attention_blocks(head_dim: int, kv_heads_per_device: int = 1,
                          dtype_bytes: int = 2, spec: HopperSpec = H100,
                          smem_budget_fraction: float = 0.4,
                          candidates=(128, 256, 512, 1024, 2048, 4096),
                          ) -> Tuple[int, int]:
    """(bq, bkv) for the nest/flash tiling: maximize the kv burst under the
    budget; q tile secondary (it is re-used across the whole kv stream).
    Bytes per block ~= (bq*(d+4)*4 + 2*bkv*d*NO) * bytes, NO=2."""
    budget = spec.smem_bytes * smem_budget_fraction
    best = (128, 128)
    best_score = -1.0
    for bq in candidates:
        for bkv in candidates:
            smem = (bq * (head_dim + 4) * 4          # fp32 q + m/l/acc rows
                    + 2 * bkv * head_dim * dtype_bytes * 2)
            if smem > budget:
                continue
            k = Knobs(unit_bytes=head_dim * dtype_bytes,
                      burst_bytes=bkv * head_dim * dtype_bytes, outstanding=2)
            score = predict_bw(Pattern.NEST, k, spec) * min(bq, bkv)
            if score > best_score:
                best_score, best = score, (bq, bkv)
    return best


def tune_ssd_chunk(d_inner: int, nheads: int, head_dim: int, dstate: int,
                   candidates=(64, 128, 256, 512)) -> int:
    """Chunk Q balancing intra-chunk (Q*H bytes/token) vs inter-chunk state
    (H*P*N/Q bytes/token): optimum near sqrt(P*N)."""
    target = (head_dim * dstate) ** 0.5
    return min(candidates, key=lambda q: abs(q - target))
