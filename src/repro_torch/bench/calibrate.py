"""Measured mode: fit the memory model's constants to observed sweeps.

The port of ``repro.bench.calibrate``.  The analytic model
(:mod:`repro_torch.core.memmodel`) predicts bandwidth from two hardware
constants — transaction latency ``T_l`` and peak HBM bandwidth.
``calibrate()`` runs the micro-sweeps on a device (or consumes a persisted
:class:`~repro_torch.bench.schema.BenchRun`), then least-squares-fits those
two constants over the latency/unit-size/stride/random curves so that the
same equations describe the device that ran them.  The result is a fitted
:class:`HopperSpec` and a ``measured_vs_predicted`` ratio per pattern,
which the autotuner, the plans and the advisor take in measured mode.

Knobs that describe the card.  A row keeps the reference's knobs (the CPU
tests compare them), but on the card they do not say what ran: the
reference's random rows claim 8 loads in flight where the whole card keeps
tens of thousands, and its stride rows claim a stride the kernel never
pays (K5 reads every block-row whole).  A row that carries its kernel's
geometry (``kernel_resident_blocks``, set only when the kernel ran on a
card) is fitted with :func:`card_knobs` instead: outstanding = the loads
in flight on the whole card (per-block requests x resident blocks), unit =
bytes per touch rounded up to 32-byte sectors, stride and burst as the
kernel ran them.  Rows without the geometry (the CPU's, the reference's,
K4's element route) fit with their own knobs, as before; the equations
are the reference's.

The fit is an exhaustive log-space grid refine (no scipy dependency): the
loss surface over (log T_l, log BW) is piecewise-smooth and unimodal for
samples spanning both the latency-limited regime (chase, small bursts) and
the bandwidth-limited regime (large sequential bursts), which the sample
sets here always include.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.memmodel import H100, HopperSpec, predict_bw
from repro_torch.core.patterns import Knobs, Pattern


@dataclass(frozen=True)
class CalibSample:
    """One observation: ``pattern`` run with ``knobs`` achieved ``gbps``."""

    pattern: Pattern
    knobs: Knobs
    gbps: float


# micro-pattern family fallback for ratio lookup (predict_bw's grouping)
_RATIO_FAMILY = {
    Pattern.RS_TRA.value: Pattern.SEQUENTIAL.value,
    Pattern.NEST.value: Pattern.SEQUENTIAL.value,
    Pattern.R_ACC.value: Pattern.RANDOM.value,
    Pattern.RR_TRA.value: Pattern.RANDOM.value,
    Pattern.STRIDED.value: Pattern.RANDOM.value,
}


@dataclass
class CalibrationResult:
    spec: HopperSpec                  # fitted constants
    base_spec: HopperSpec             # what the fit started from
    rms_log_error: float              # residual of the fit (log-space RMS)
    n_samples: int
    ratios: Dict[str, float] = field(default_factory=dict)

    @property
    def latency_scale(self) -> float:
        """Fitted T_l over the base spec's T_l."""
        return self.spec.latency_s / self.base_spec.latency_s

    @property
    def bandwidth_scale(self) -> float:
        """Fitted HBM bandwidth over the base spec's."""
        return self.spec.hbm_bw / self.base_spec.hbm_bw

    def measured_vs_predicted(self, pattern: Pattern) -> Optional[float]:
        """Mean observed/predicted (base spec) ratio for ``pattern``.

        Application patterns the micro-sweeps don't measure directly fall
        back to their micro-pattern family — the same grouping
        ``predict_bw`` uses (rs_tra/nest share the sequential burst formula,
        r_acc/rr_tra/strided the random unit formula)."""
        key = pattern.value if isinstance(pattern, Pattern) else str(pattern)
        if key in self.ratios:
            return self.ratios[key]
        family = _RATIO_FAMILY.get(key)
        return self.ratios.get(family) if family else None

    def to_dict(self) -> Dict:
        return {
            "fitted": {"latency_s": self.spec.latency_s,
                       "hbm_bw": self.spec.hbm_bw},
            "base": {"latency_s": self.base_spec.latency_s,
                     "hbm_bw": self.base_spec.hbm_bw},
            "latency_scale": self.latency_scale,
            "bandwidth_scale": self.bandwidth_scale,
            "rms_log_error": self.rms_log_error,
            "n_samples": self.n_samples,
            "ratios": dict(self.ratios),
        }


# ---------------------------------------------------------------------------
# Sample generation
# ---------------------------------------------------------------------------

def synthetic_samples(spec: HopperSpec, noise: float = 0.0,
                      seed: int = 0) -> List[CalibSample]:
    """Samples generated *from the model itself* — the property-test probe:
    fitting them must recover ``spec``'s constants.  Covers the
    latency-limited (chase / small-burst low-NO) and bandwidth-limited
    (large sequential burst) regimes so both constants are identifiable."""
    import random as _random
    rng = _random.Random(seed)
    samples: List[CalibSample] = []

    def jitter() -> float:
        return 1.0 + rng.uniform(-noise, noise) if noise else 1.0

    for unit in (4, 64, 256):
        k = Knobs(unit_bytes=unit, outstanding=1)
        samples.append(CalibSample(
            Pattern.CHASE, k,
            predict_bw(Pattern.CHASE, k, spec) / 1e9 * jitter()))
    for burst in (1 << 12, 1 << 16, 1 << 20, 1 << 22):
        for no in (1, 2, 8, 32):
            k = Knobs(burst_bytes=burst, outstanding=no)
            samples.append(CalibSample(
                Pattern.SEQUENTIAL, k,
                predict_bw(Pattern.SEQUENTIAL, k, spec) / 1e9 * jitter()))
    for unit in (64, 512, 4096):
        k = Knobs(unit_bytes=unit, outstanding=8)
        samples.append(CalibSample(
            Pattern.RANDOM, k,
            predict_bw(Pattern.RANDOM, k, spec) / 1e9 * jitter()))
    return samples


SECTOR_BYTES = 32    # the card's memory moves whole 32-byte sectors


def card_knobs(knobs: Knobs, extras: Dict) -> Knobs:
    """The knobs a row ran with on the card, from its kernel's geometry
    (``kernel_*`` extras), or the row's own knobs when it carries none."""
    blocks = extras.get("kernel_resident_blocks")
    if not blocks:
        return knobs
    per_block = int(extras.get("kernel_outstanding", 1))
    unit = -(-knobs.unit_bytes // SECTOR_BYTES) * SECTOR_BYTES
    return replace(
        knobs, unit_bytes=unit, outstanding=per_block * int(blocks),
        burst_bytes=int(extras.get("kernel_burst_bytes", knobs.burst_bytes)),
        stride=int(extras.get("kernel_stride", knobs.stride)))


# sweeps whose rows carry knobs that faithfully describe the measured access
# (outstanding/num_kernels measure hops or dispatch effects, and burst rows
#  carry the reference's nominal outstanding — none of those identify
#  T_l / BW cleanly)
CALIBRATION_SWEEPS = ("latency", "unit_size", "stride", "random")


def samples_from_run(run, sweeps: Sequence[str] = CALIBRATION_SWEEPS
                     ) -> List[CalibSample]:
    """Extract fit-worthy samples from a persisted :class:`BenchRun`, at
    the knobs the card ran (:func:`card_knobs`)."""
    samples: List[CalibSample] = []
    for r in run.results:
        if r.sweep not in sweeps or not r.pattern or r.gbps_measured <= 0:
            continue
        try:
            knobs = Knobs(**r.knobs) if r.knobs else Knobs()
            pattern = Pattern(r.pattern)
        except (TypeError, ValueError):
            continue
        samples.append(CalibSample(pattern, card_knobs(knobs, r.extras),
                                   r.gbps_measured))
    return samples


def measured_samples(fast: bool = True, device=None) -> List[CalibSample]:
    """Run the micro-sweeps directly (no persistence) and return samples —
    the quick path for ``calibrate()`` without a saved run.  ``fast`` keeps
    the reference's fast sizes; the full sizes are the card's (every
    working set at least 20 times the L2)."""
    from repro_torch.core import engines

    samples: List[CalibSample] = []
    chase = engines.latency_chase(n_entries=1 << (14 if fast else 26),
                                  steps=1 << (11 if fast else 13),
                                  device=device)
    samples.append(CalibSample(Pattern.CHASE, Knobs(unit_bytes=4, outstanding=1),
                               chase.gbps_measured))
    for rows, cols in ((1024, 512), (4096, 1024)) if fast else \
            ((1 << 17, 1024), (1 << 18, 1024)):
        r = engines.bw_sequential(rows=rows, cols=cols, device=device)
        samples.append(CalibSample(
            Pattern.SEQUENTIAL,
            card_knobs(Knobs(unit_bytes=128 * 4, burst_bytes=cols * 4 * 8,
                             outstanding=2), r.extras),
            r.gbps_measured))
    for unit in (64, 256, 1024):
        r = engines.bw_random(n_rows=1 << 13 if fast else
                              min(1 << 24, (1 << 30) // unit),
                              cols=max(1, unit // 4),
                              n_idx=1 << (12 if fast else 20), device=device)
        samples.append(CalibSample(
            Pattern.RANDOM,
            card_knobs(Knobs(unit_bytes=unit, outstanding=8), r.extras),
            r.gbps_measured))
    return samples


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------

def _loss(samples: List[Tuple[Pattern, Knobs, float]],
          spec: HopperSpec) -> float:
    tot = 0.0
    for pattern, knobs, log_obs in samples:
        pred = predict_bw(pattern, knobs, spec)
        tot += (math.log(max(pred, 1e-30)) - log_obs) ** 2
    return tot / len(samples)


def fit_spec(samples: Iterable[CalibSample], base: HopperSpec = H100,
             rounds: int = 4, grid: int = 17,
             lat_bounds: Tuple[float, float] = (1e-9, 1e-4),
             bw_bounds: Tuple[float, float] = (1e8, 1e13)
             ) -> CalibrationResult:
    """Least-squares over log bandwidth: refine a (T_l, BW) grid ``rounds``
    times.  Final resolution ~0.2% — far inside the 5% recovery target."""
    samples = list(samples)
    if not samples:
        raise ValueError("no calibration samples")
    obs = [(s.pattern, s.knobs, math.log(max(s.gbps, 1e-12) * 1e9))
           for s in samples]

    lo_l, hi_l = (math.log(b) for b in lat_bounds)
    lo_b, hi_b = (math.log(b) for b in bw_bounds)
    best_l = best_b = 0.0
    best_loss = float("inf")
    for _ in range(rounds):
        step_l = (hi_l - lo_l) / (grid - 1)
        step_b = (hi_b - lo_b) / (grid - 1)
        for i in range(grid):
            for j in range(grid):
                l, b = lo_l + i * step_l, lo_b + j * step_b
                spec = replace(base, latency_s=math.exp(l),
                               hbm_bw=math.exp(b))
                cur = _loss(obs, spec)
                if cur < best_loss:
                    best_loss, best_l, best_b = cur, l, b
        # zoom around the incumbent with a 2-step margin so a flat valley
        # cannot push the true optimum outside the next window
        lo_l, hi_l = best_l - 2 * step_l, best_l + 2 * step_l
        lo_b, hi_b = best_b - 2 * step_b, best_b + 2 * step_b

    fitted = replace(base, name=base.name + "-calibrated",
                     latency_s=math.exp(best_l), hbm_bw=math.exp(best_b))

    ratios: Dict[str, List[float]] = {}
    for s in samples:
        pred = predict_bw(s.pattern, s.knobs, base) / 1e9
        if pred > 0:
            ratios.setdefault(s.pattern.value, []).append(s.gbps / pred)
    return CalibrationResult(
        spec=fitted, base_spec=base,
        rms_log_error=math.sqrt(best_loss), n_samples=len(samples),
        ratios={p: sum(v) / len(v) for p, v in ratios.items()})


def calibrate(run=None, samples: Optional[Iterable[CalibSample]] = None,
              base: HopperSpec = H100, fast: bool = True,
              device=None) -> CalibrationResult:
    """Measured mode, one call.

    Priority: explicit ``samples`` > persisted ``run`` > run the micro-sweeps
    now on ``device`` (default: the card).  Returns the fitted spec +
    per-pattern measured/predicted ratios.
    """
    if samples is None:
        samples = samples_from_run(run) if run is not None else \
            measured_samples(fast=fast, device=device)
    return fit_spec(samples, base=base)
