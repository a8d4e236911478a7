"""Structured benchmark subsystem (the paper's measurement campaign), on
the card.

- :mod:`repro_torch.bench.schema` — ``BenchResult``/``BenchRun`` + JSON
- :mod:`repro_torch.bench.registry` — sweep registry + :func:`run_sweeps`
- :mod:`repro_torch.bench.sweeps` — the seven memory-engine sweeps
- :mod:`repro_torch.bench.calibrate` — measured mode: fit the memmodel
  constants

CLI: ``PYTHONPATH=src python -m repro_torch.bench [--fast] [--device cpu]``.
"""
from repro_torch.bench.calibrate import (CalibrationResult,  # noqa: F401
                                         CalibSample, calibrate, fit_spec,
                                         measured_samples, samples_from_run,
                                         synthetic_samples)
from repro_torch.bench.registry import (ORDER, REGISTRY,  # noqa: F401
                                        SweepContext, register, run_sweeps)
from repro_torch.bench.schema import (BenchResult, BenchRun,  # noqa: F401
                                      Timing, env_fingerprint)
from repro_torch.bench import sweeps as _sweeps  # noqa: F401  (populate REGISTRY)

__all__ = [
    "BenchResult", "BenchRun", "Timing", "env_fingerprint",
    "REGISTRY", "ORDER", "SweepContext", "register", "run_sweeps",
    "CalibrationResult", "CalibSample", "calibrate", "fit_spec",
    "measured_samples", "samples_from_run", "synthetic_samples",
]
