"""KernelPlan: the applied output of the autotuner (paper §5, closed loop).

The port of ``repro.tune.plan``.  A plan turns ``tune_attention_blocks`` /
``tune_pattern`` output into concrete, serializable kernel parameters —
tiles, pipeline depth, dtype — that the kernels (:mod:`repro_torch.kernels.
ops`) and the model's attention take as their defaults.  A plan is derived
once per ``(kernel, shape signature, dtype, spec fingerprint)`` and cached
(:mod:`repro_torch.tune.cache`); with a :class:`~repro_torch.bench.
calibrate.CalibrationResult` the derivation runs against the fitted spec,
so measured mode changes the plans and the fingerprint.

The reference's ``interpret`` flag has no counterpart: the tensor's device
decides between the CUDA kernel and its plain version.  The budget is a
block's shared memory (:attr:`HopperSpec.smem_bytes`) where the reference
uses the TPU's VMEM; the rules are the reference's, so the same constants
give the same plans.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.autotune import tune_attention_blocks, tune_pattern
from repro_torch.core.memmodel import H100, HopperSpec, next_pow2, predict_bw
from repro_torch.core.patterns import Knobs, Pattern

# the kernels a plan can target (for the paged kernels the plan's bkv IS
# the page size — the pool is laid out from the plan; paged_verify is the
# reference's k-token speculative verify step over the same pool)
KERNELS = ("flash_attention", "decode_attention", "matmul", "paged_attention",
           "paged_verify")


def dtype_name(dtype) -> str:
    """The reference's name of a dtype: ``torch.bfloat16`` -> "bfloat16",
    so that plan keys read alike on both packages."""
    return str(dtype).removeprefix("torch.")


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def spec_fingerprint(spec: HopperSpec) -> str:
    """Short stable id of the constants that shape a tuning decision.

    Calibration replaces the spec (name + fitted constants), so a
    calibrated run fingerprints differently from the analytic one — the
    cache invalidation rule: new constants => new key => plans re-derived.
    """
    raw = (f"{spec.name}|{spec.hbm_bw:.6g}|{spec.latency_s:.6g}"
           f"|{spec.smem_bytes}|{spec.clock_hz:.6g}")
    return hashlib.sha1(raw.encode()).hexdigest()[:12]


@dataclass(frozen=True)
class KernelPlan:
    """One tuned kernel configuration, ready to execute.

    Paper §5 knob -> plan field:
      burst size       -> ``bkv`` (the contiguous kv/rhs tile per copy)
      outstanding (NO) -> ``pipeline_depth`` (tiles in flight)
      unit width       -> ``dtype`` x head row (``unit_bytes``)
    """

    kernel: str
    bq: int
    bkv: int
    pipeline_depth: int = 2
    dtype: str = "bfloat16"
    head_dim: int = 128
    predicted_gbps: float = 0.0
    source: str = "analytic"            # analytic | calibrated

    # ------------------------------------------------------------------
    @property
    def dtype_bytes(self) -> int:
        return _itemsize(self.dtype)

    @property
    def unit_bytes(self) -> int:
        """Transaction width: one head row of the plan's dtype."""
        return max(1, self.head_dim * self.dtype_bytes)

    @property
    def burst_bytes(self) -> int:
        """Contiguous copy size: the kv/rhs tile."""
        return max(1, self.bkv * self.head_dim * self.dtype_bytes)

    @property
    def page_size(self) -> int:
        """Paged-attention reading of ``bkv``: tokens per KV page."""
        return self.bkv

    def knobs(self) -> Knobs:
        """The plan in the paper's knob vocabulary (for smem_ok /
        predict_bw round trips)."""
        return Knobs(unit_bytes=self.unit_bytes, burst_bytes=self.burst_bytes,
                     outstanding=self.pipeline_depth)

    def smem_bytes(self) -> int:
        """Resident buffering: q tile + f32 scratch rows + the kv tiles in
        flight (``tune_attention_blocks``'s budget formula)."""
        db = self.dtype_bytes
        return (self.bq * (self.head_dim + 4) * 4
                + self.pipeline_depth * self.bkv * self.head_dim * db * 2)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel, "bq": self.bq, "bkv": self.bkv,
            "pipeline_depth": self.pipeline_depth, "dtype": self.dtype,
            "head_dim": self.head_dim, "predicted_gbps": self.predicted_gbps,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KernelPlan":
        """Reads the port's dicts and the reference's (whose ``interpret``
        is ignored)."""
        return cls(kernel=d["kernel"], bq=int(d["bq"]), bkv=int(d["bkv"]),
                   pipeline_depth=int(d.get("pipeline_depth", 2)),
                   dtype=d.get("dtype", "bfloat16"),
                   head_dim=int(d.get("head_dim", 128)),
                   predicted_gbps=float(d.get("predicted_gbps", 0.0)),
                   source=d.get("source", "analytic"))


# ---------------------------------------------------------------------------
# Derivation (the tune -> plan step)
# ---------------------------------------------------------------------------

def plan_key(kernel: str, shape_sig: Tuple[int, ...], dtype: str,
             spec: HopperSpec) -> str:
    sig = "x".join(str(int(s)) for s in shape_sig)
    return f"{kernel}|{sig}|{dtype}|{spec_fingerprint(spec)}"


def _resolve_spec(spec: Optional[HopperSpec],
                  calibration) -> Tuple[HopperSpec, str]:
    if calibration is not None:
        return calibration.spec, "calibrated"
    return (spec or H100), "analytic"


def _shrink_to_budget(bq: int, bkv: int, head_dim: int, db: int,
                      budget: float, depth: int) -> Tuple[int, int]:
    """Halve the kv (then q) tile until the scratch+buffer estimate fits,
    down to 8 — the floor may stay over the budget."""
    def smem(bq_, bkv_):
        return bq_ * (head_dim + 4) * 4 + depth * bkv_ * head_dim * db * 2
    while smem(bq, bkv) > budget and bkv > 8:
        bkv //= 2
    while smem(bq, bkv) > budget and bq > 8:
        bq //= 2
    return max(8, bq), max(8, bkv)


def derive_attention_plan(*, sq: int, skv: int, head_dim: int,
                          dtype: str = "bfloat16",
                          kernel: str = "flash_attention",
                          spec: Optional[HopperSpec] = None, calibration=None,
                          smem_budget_fraction: float = 0.4) -> KernelPlan:
    """(bq, bkv) for the nest tiling from ``tune_attention_blocks`` under the
    (possibly calibrated) spec, clamped to the actual sequence lengths."""
    spec, source = _resolve_spec(spec, calibration)
    db = _itemsize(dtype)
    bq, bkv = tune_attention_blocks(head_dim, dtype_bytes=db, spec=spec,
                                    smem_budget_fraction=smem_budget_fraction)
    bq, bkv = min(bq, max(8, sq)), min(bkv, max(8, skv))
    bq, bkv = _shrink_to_budget(bq, bkv, head_dim, db,
                                spec.smem_bytes * smem_budget_fraction, 2)
    knobs = Knobs(unit_bytes=head_dim * db, burst_bytes=bkv * head_dim * db,
                  outstanding=2)
    return KernelPlan(
        kernel=kernel, bq=bq, bkv=bkv, pipeline_depth=2, dtype=dtype,
        head_dim=head_dim,
        predicted_gbps=predict_bw(Pattern.NEST, knobs, spec) / 1e9,
        source=source)


def derive_decode_plan(*, seq_len: int, head_dim: int, dtype: str = "bfloat16",
                       spec: Optional[HopperSpec] = None, calibration=None,
                       smem_budget_fraction: float = 0.4) -> KernelPlan:
    """Split-KV tile for flash-decode: decode streams the whole cache once
    per token (the paper's `rs_tra` pure-bandwidth regime), so the kv tile
    is the tuned sequential burst divided by the row width, and the tiles
    in flight are the tuned outstanding count."""
    spec, source = _resolve_spec(spec, calibration)
    db = _itemsize(dtype)
    tuned = tune_pattern(Pattern.RS_TRA, spec=spec,
                         smem_budget_fraction=smem_budget_fraction,
                         calibration=calibration)
    bkv = max(8, tuned.knobs.burst_bytes // max(1, head_dim * db))
    bkv = min(bkv, max(8, seq_len))
    _, bkv = _shrink_to_budget(8, bkv, head_dim, db,
                               spec.smem_bytes * smem_budget_fraction,
                               tuned.knobs.outstanding)
    return KernelPlan(
        kernel="decode_attention", bq=1, bkv=bkv,
        pipeline_depth=tuned.knobs.outstanding, dtype=dtype,
        head_dim=head_dim, predicted_gbps=tuned.predicted_gbps, source=source)


def derive_paged_plan(*, max_len: int, head_dim: int, dtype: str = "bfloat16",
                      spec: Optional[HopperSpec] = None, calibration=None,
                      smem_budget_fraction: float = 0.4) -> KernelPlan:
    """Page size (``bkv``) for the paged-KV pool + kernel.

    Paged decode is the paper's `r_acc` engine: each sequence gathers its
    pages through a table, so the page is the memory transaction.  The
    page is the smallest power-of-two token count whose rows reach 512
    bytes, at least 8 tokens, and at most half the sequence budget rounded
    up to a power of two.  ``dtype`` is the dtype the pool stores, so a
    narrower store holds more tokens per page.  Pipeline depth comes from
    the tuned r_acc knobs.
    """
    spec, source = _resolve_spec(spec, calibration)
    row = max(1, head_dim * _itemsize(dtype))
    tuned = tune_pattern(Pattern.R_ACC, spec=spec,
                         smem_budget_fraction=smem_budget_fraction,
                         calibration=calibration)
    page = next_pow2(-(-512 // row))
    page = max(8, min(page, max(8, next_pow2(max_len) // 2)))
    return KernelPlan(
        kernel="paged_attention", bq=1, bkv=page,
        pipeline_depth=tuned.knobs.outstanding, dtype=dtype,
        head_dim=head_dim, predicted_gbps=tuned.predicted_gbps, source=source)


def derive_verify_plan(*, verify_tokens: int, max_len: int, head_dim: int,
                       dtype: str = "bfloat16",
                       spec: Optional[HopperSpec] = None, calibration=None,
                       smem_budget_fraction: float = 0.4) -> KernelPlan:
    """Plan for the speculative k-token verify step: the paged plan's page
    (the pool is shared), ``bq`` the verify width, and the gather rate
    scaled by the reuse of each fetched row."""
    base = derive_paged_plan(max_len=max_len, head_dim=head_dim, dtype=dtype,
                             spec=spec, calibration=calibration,
                             smem_budget_fraction=smem_budget_fraction)
    vt = max(1, int(verify_tokens))
    return KernelPlan(
        kernel="paged_verify", bq=vt, bkv=base.bkv,
        pipeline_depth=base.pipeline_depth, dtype=dtype, head_dim=head_dim,
        predicted_gbps=base.predicted_gbps * vt, source=base.source)


def derive_matmul_plan(*, m: int, n: int, k: int, dtype: str = "bfloat16",
                       spec: Optional[HopperSpec] = None, calibration=None,
                       smem_budget_fraction: float = 0.4) -> KernelPlan:
    """Square tile for the tiled matmul: the largest tile of 128, 256, 512
    or 1024 whose triple (lhs, rhs, acc) double-buffered footprint fits the
    budget, and 128 when none does."""
    spec, source = _resolve_spec(spec, calibration)
    db = _itemsize(dtype)
    budget = spec.smem_bytes * smem_budget_fraction
    tile = 128
    for t in (128, 256, 512, 1024):
        if 2 * (2 * t * t * db + t * t * 4) <= budget:
            tile = t
    tile = min(tile, max(8, m), max(8, n), max(8, k))
    knobs = Knobs(unit_bytes=tile * db, burst_bytes=tile * tile * db,
                  outstanding=2)
    return KernelPlan(
        kernel="matmul", bq=tile, bkv=tile, pipeline_depth=2, dtype=dtype,
        head_dim=tile,
        predicted_gbps=predict_bw(Pattern.SEQUENTIAL, knobs, spec) / 1e9,
        source=source)


def derive_plan(kernel: str, *, shape_sig: Tuple[int, ...], dtype: str,
                spec: Optional[HopperSpec] = None,
                calibration=None) -> KernelPlan:
    """Dispatch on kernel name; ``shape_sig`` is the kernel's tuning-relevant
    shape tuple (see :func:`repro_torch.tune.cache.plan_for`)."""
    if kernel == "flash_attention":
        sq, skv, head_dim = shape_sig
        return derive_attention_plan(sq=sq, skv=skv, head_dim=head_dim,
                                     dtype=dtype, spec=spec,
                                     calibration=calibration)
    if kernel == "decode_attention":
        seq_len, head_dim = shape_sig
        return derive_decode_plan(seq_len=seq_len, head_dim=head_dim,
                                  dtype=dtype, spec=spec,
                                  calibration=calibration)
    if kernel == "paged_attention":
        # an optional trailing element (kv heads per shard) keys the cache
        # but never changes the page
        max_len, head_dim = shape_sig[:2]
        return derive_paged_plan(max_len=max_len, head_dim=head_dim,
                                 dtype=dtype, spec=spec,
                                 calibration=calibration)
    if kernel == "paged_verify":
        verify_tokens, max_len, head_dim = shape_sig[:3]
        return derive_verify_plan(verify_tokens=verify_tokens,
                                  max_len=max_len, head_dim=head_dim,
                                  dtype=dtype, spec=spec,
                                  calibration=calibration)
    if kernel == "matmul":
        m, n, k = shape_sig
        return derive_matmul_plan(m=m, n=n, k=k, dtype=dtype, spec=spec,
                                  calibration=calibration)
    raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
