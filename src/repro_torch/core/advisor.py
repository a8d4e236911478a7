"""Per-site memory-pattern advice for a model (paper §5/§6).

The port of ``repro.core.advisor``.  :func:`advise_model` walks a
``ModelConfig`` x ``ShapeCell`` and emits a :class:`SiteReport` per
memory-significant structure (embedding gather = r_acc, attention = nest,
weight streaming = rs_tra, MoE routing = expert-level r_acc, recurrent
state = sequential), each with its bytes, the paper's optimization
direction and the tuned bandwidth the model predicts for its pattern on
the card (:data:`~repro_torch.core.memmodel.H100`, or the spec a
calibration fitted).  :func:`render_report` prints the table.

The reference's ``classify_hlo`` counts opcodes in XLA's HLO text, which
the port never produces; it has no counterpart here.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List

from repro_torch.configs.base import (ATTN, DECODE, MOE, RGLRU, SSD,
                                      ModelConfig, ShapeCell)
from repro_torch.core.memmodel import H100, HopperSpec
from repro_torch.core.patterns import Pattern, SiteReport


@lru_cache(maxsize=None)
def _tuned_gbps(pattern: Pattern, spec: HopperSpec) -> float:
    """Model-predicted tuned bandwidth for a pattern under ``spec`` (GB/s).
    Cached — HopperSpec is frozen/hashable and the knob search is pure."""
    from repro_torch.core.autotune import tune_pattern
    return tune_pattern(pattern, spec).predicted_gbps


def advise_model(cfg: ModelConfig, cell: ShapeCell, engines: int = 1,
                 param_engines: int = None, spec: HopperSpec = H100,
                 calibration=None) -> List[SiteReport]:
    """``engines`` is the number of parallel access engines (shards of the
    batch, each streaming its slice from its own device memory, paper
    Tables 3-5): traffic is reported *per engine*.

    Batch-scaled sites (embedding, attention, states, routing) split across
    all ``engines``; the weight stream splits only across ``param_engines``
    (1 for pure data parallelism, where every shard streams the full
    model).  Defaults to ``engines`` when unset.

    ``spec`` grounds each site's ``predicted_gbps`` (tuned-model bandwidth
    for its pattern).  Passing a ``calibration``
    (:class:`repro_torch.bench.calibrate.CalibrationResult`) switches
    predictions to the fitted constants and stamps every site with the
    pattern's ``measured_vs_predicted`` ratio — measured mode."""
    reports: List[SiteReport] = []
    dt = 2  # bf16
    tokens = cell.tokens
    d = cfg.d_model
    engines = max(1, engines)
    param_engines = engines if param_engines is None else max(1, param_engines)

    # embedding gather: random row access into the (V, d) table
    reports.append(SiteReport(
        op_name="embedding.lookup", pattern=Pattern.R_ACC,
        bytes_moved=tokens * d * dt, shape=(cfg.vocab_size, d),
        detail=f"row={d*dt}B from a {cfg.vocab_size}-row table; widen row / "
               f"shard vocab so gathers stay local (address-mapping)"))

    total, active = cfg.param_count()
    reports.append(SiteReport(
        op_name="params.stream", pattern=Pattern.RS_TRA,
        bytes_moved=active * dt,
        detail="per-step weight streaming; FSDP all-gather of layer i+1 "
               "overlaps layer i compute (prefetch = outstanding)"))

    for j, lspec in enumerate(cfg.layer_pattern):
        if lspec.mixer == ATTN:
            kv = cell.seq_len if lspec.sliding_window is None else min(
                lspec.sliding_window, cell.seq_len)
            qn = 1 if cell.kind == DECODE else cell.seq_len
            b = cell.global_batch
            bytes_kv = b * kv * cfg.num_kv_heads * cfg.resolved_head_dim * dt * 2
            reports.append(SiteReport(
                op_name=f"attn[p{j}]{'.window' if lspec.sliding_window else ''}",
                pattern=Pattern.NEST, bytes_moved=bytes_kv,
                shape=(qn, kv),
                detail=f"q-cursor {qn} x kv-cursor {kv}; block both cursors "
                       f"(flash tiling) so the kv stream stays resident in "
                       f"shared memory"))
        elif lspec.mixer == SSD:
            h = cfg.ssm_expand * d // cfg.ssm_head_dim
            state = cell.global_batch * h * cfg.ssm_head_dim * cfg.ssm_state * 4
            reports.append(SiteReport(
                op_name=f"ssd[p{j}].state", pattern=Pattern.SEQUENTIAL,
                bytes_moved=state,
                detail=f"constant {state/1e6:.2f}MB state; chunk size trades "
                       f"intra (~Q*H/token) vs inter (~H*P*N/Q/token) traffic"))
        elif lspec.mixer == RGLRU:
            w = cfg.lru_width or d
            reports.append(SiteReport(
                op_name=f"rglru[p{j}].state", pattern=Pattern.SEQUENTIAL,
                bytes_moved=cell.global_batch * w * 4,
                detail="streaming recurrence; associative-scan keeps it "
                       "bandwidth-bound, not latency-bound"))
        if lspec.mlp == MOE:
            reports.append(SiteReport(
                op_name=f"moe[p{j}].route", pattern=Pattern.R_ACC,
                bytes_moved=3 * d * cfg.d_ff * cfg.num_experts_per_tok * dt,
                detail=f"top-{cfg.num_experts_per_tok}/{cfg.num_experts} "
                       f"expert pick; sort-dispatch converts token-level "
                       f"r_acc into per-expert rs_tra (the paper's conversion)"))
    if cell.kind == DECODE:
        reports.append(SiteReport(
            op_name="kv_cache.decode_stream", pattern=Pattern.RS_TRA,
            bytes_moved=sum(r.bytes_moved for r in reports
                            if r.pattern == Pattern.NEST),
            detail="decode re-reads the whole cache per token: pure "
                   "bandwidth; batch tokens to amortize (throughput mode)"))
    if engines > 1 or param_engines > 1:
        for r in reports:
            n = param_engines if r.op_name == "params.stream" else engines
            if n > 1:
                r.bytes_moved = max(1, r.bytes_moved // n)
                r.detail = f"[1/{n} engines] " + r.detail
    eff_spec = calibration.spec if calibration is not None else spec
    for r in reports:
        r.predicted_gbps = _tuned_gbps(r.pattern, eff_spec)
        if calibration is not None:
            r.measured_vs_predicted = calibration.measured_vs_predicted(
                r.pattern)
    return reports


def render_report(reports: List[SiteReport]) -> str:
    calibrated = any(r.measured_vs_predicted is not None for r in reports)
    head = "site | pattern | bytes | pred GB/s"
    head += " | meas/pred | direction" if calibrated else " | direction"
    lines = [head]
    for r in reports:
        row = (f"{r.op_name:28s} | {r.pattern.value:10s} | "
               f"{r.bytes_moved/2**20:10.1f}MiB | {r.predicted_gbps:8.1f}")
        if calibrated:
            ratio = ("      n/a" if r.measured_vs_predicted is None
                     else f"{r.measured_vs_predicted:9.3f}")
            row += f" | {ratio}"
        lines.append(row + f" | {r.advice.knob_moves[0]}")
    return "\n".join(lines)
