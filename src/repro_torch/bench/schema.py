"""Benchmark result schema + JSON persistence.

The port of ``repro.bench.schema``, with the same JSON layout.  Every
measurement row is a :class:`BenchResult` (pattern, knobs, timing,
measured + model-predicted bandwidth) and a whole campaign is a
:class:`BenchRun` (results + environment fingerprint + the spec constants
the predictions used).  A run serializes to ``BENCH_torch_<timestamp>.json``
under a directory the caller names, and feeds
:mod:`repro_torch.bench.calibrate`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Timing:
    """Wall-clock statistics so noise is visible in persisted results."""

    best_s: float
    mean_s: float
    trials: int

    @property
    def noise(self) -> float:
        """Relative spread (mean - best) / best; 0.0 when degenerate."""
        if self.best_s <= 0:
            return 0.0
        return max(0.0, self.mean_s - self.best_s) / self.best_s

    def to_dict(self) -> Dict[str, Any]:
        return {"best_s": self.best_s, "mean_s": self.mean_s,
                "trials": self.trials}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Timing":
        return cls(best_s=float(d["best_s"]), mean_s=float(d["mean_s"]),
                   trials=int(d["trials"]))


@dataclass
class BenchResult:
    """One measurement row.

    ``gbps_measured`` is Eq. 5 on the device that ran it; ``gbps_predicted`` is
    ``predict_bw`` under the run's spec constants.  Rows that carry no
    meaningful host timing (status rows, artifact-derived rows) still carry
    both columns so downstream consumers never branch on missing keys.
    """

    name: str
    sweep: str
    pattern: Optional[str] = None
    knobs: Dict[str, Any] = field(default_factory=dict)
    us_per_call: float = 0.0
    gbps_measured: float = 0.0
    gbps_predicted: float = 0.0
    timing: Optional[Timing] = None
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def measured_vs_predicted(self) -> float:
        """Measured over model-predicted bandwidth (0.0 if unknown)."""
        if self.gbps_predicted <= 0:
            return 0.0
        return self.gbps_measured / self.gbps_predicted

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "sweep": self.sweep,
            "pattern": self.pattern,
            "knobs": dict(self.knobs),
            "us_per_call": self.us_per_call,
            "gbps_measured": self.gbps_measured,
            "gbps_predicted": self.gbps_predicted,
            "measured_vs_predicted": self.measured_vs_predicted,
            "extras": dict(self.extras),
        }
        if self.timing is not None:
            d["timing"] = self.timing.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchResult":
        return cls(
            name=d["name"], sweep=d["sweep"], pattern=d.get("pattern"),
            knobs=dict(d.get("knobs", {})),
            us_per_call=float(d.get("us_per_call", 0.0)),
            gbps_measured=float(d.get("gbps_measured", 0.0)),
            gbps_predicted=float(d.get("gbps_predicted", 0.0)),
            timing=Timing.from_dict(d["timing"]) if d.get("timing") else None,
            extras=dict(d.get("extras", {})),
        )

    def csv(self) -> str:
        """Legacy stdout row: ``name,us_per_call,derived``."""
        derived = {
            "gbps_measured": f"{self.gbps_measured:.3f}",
            "gbps_model": f"{self.gbps_predicted:.3f}",
            **self.extras,
        }
        d = ";".join(f"{k}={v}" for k, v in derived.items())
        return f"{self.name},{self.us_per_call:.2f},{d}"


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    '' where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else ""


def env_fingerprint(device: Optional[str] = None) -> Dict[str, Any]:
    """What produced these numbers — enough to judge comparability: the
    host, torch and its CUDA version, and for a run on the card the card's
    name and power limit."""
    import torch
    fp: Dict[str, Any] = {
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "device": str(device) if device is not None else None,
    }
    if device is not None and str(device).startswith("cuda"):
        fp["card"] = torch.cuda.get_device_name(torch.device(device))
        fp["card_power_limit"] = card_name_and_power_limit()
        fp["device_count"] = torch.cuda.device_count()
    return fp


@dataclass
class BenchRun:
    """A full campaign: results + provenance, serializable to one JSON file."""

    results: List[BenchResult] = field(default_factory=list)
    env: Dict[str, Any] = field(default_factory=env_fingerprint)
    spec: Dict[str, Any] = field(default_factory=dict)
    calibration: Optional[Dict[str, Any]] = None
    failures: Dict[str, str] = field(default_factory=dict)
    created: str = ""
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if not self.created:
            self.created = time.strftime("%Y-%m-%dT%H:%M:%S")

    # -- access -------------------------------------------------------------

    def sweeps(self) -> List[str]:
        return sorted({r.sweep for r in self.results})

    def by_sweep(self, sweep: str) -> List[BenchResult]:
        return [r for r in self.results if r.sweep == sweep]

    def by_name(self) -> Dict[str, BenchResult]:
        return {r.name: r for r in self.results}

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "created": self.created,
            "env": self.env,
            "spec": self.spec,
            "calibration": self.calibration,
            "failures": self.failures,
            "results": [r.to_dict() for r in self.results],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchRun":
        return cls(
            results=[BenchResult.from_dict(r) for r in d.get("results", [])],
            env=dict(d.get("env", {})),
            spec=dict(d.get("spec", {})),
            calibration=d.get("calibration"),
            failures=dict(d.get("failures", {})),
            created=d.get("created", ""),
            schema_version=int(d.get("schema_version", SCHEMA_VERSION)),
        )

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "BenchRun":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, out_dir: str) -> str:
        """Persist under ``out_dir`` as ``BENCH_torch_<timestamp>.json``.  The
        chosen path is recorded in ``env["path"]`` *before* dumping so the
        file on disk carries its own provenance."""
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(out_dir, f"BENCH_torch_{stamp}.json")
        # never clobber a run written within the same second
        n = 0
        while os.path.exists(path):
            n += 1
            path = os.path.join(out_dir, f"BENCH_torch_{stamp}_{n}.json")
        self.env["path"] = path
        return self.dump(path)


def spec_to_dict(spec) -> Dict[str, Any]:
    """HopperSpec -> plain dict (provenance for the prediction columns)."""
    return dataclasses.asdict(spec)
