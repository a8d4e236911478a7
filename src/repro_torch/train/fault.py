"""Fault tolerance: retry with restore, straggler detection (the port of
``repro.train.fault``, pure Python).

Every policy here is control-plane logic over the checkpoint manager and
the step timer, so it does not depend on the device count.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.fault")


class PreemptionError(RuntimeError):
    """Raised by tests and injected hooks to simulate a node loss."""


@dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the rolling median of the
    last ``window`` (from the fifth step on) and calls ``on_straggler``,
    where a cluster would exclude or replace the slow host."""

    window: int = 32
    threshold: float = 3.0
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        if len(hist) >= 5 and seconds > self.threshold * med:
            self.flagged.append(step)
            log.warning("straggler step %d: %.3fs vs median %.3fs", step,
                        seconds, med)
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
            return True
        return False


@dataclass
class FailureInjector:
    """Deterministic failure injection: raise once at each given step."""

    fail_at: tuple = ()
    seen: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise PreemptionError(f"injected preemption at step {step}")


def run_with_recovery(run_fn: Callable[[Optional[int]], int],
                      max_failures: int = 3) -> int:
    """``run_fn(resume_step)`` runs to its end or raises; after a
    :class:`PreemptionError` it runs again with ``resume=-1`` (restore the
    latest checkpoint), up to ``max_failures`` times.  Returns the final
    step."""
    failures = 0
    resume: Optional[int] = None
    while True:
        try:
            return run_fn(resume)
        except PreemptionError as e:   # noqa: PERF203
            failures += 1
            log.warning("recovering from failure %d: %s", failures, e)
            if failures > max_failures:
                raise
            resume = -1
            time.sleep(0.01)
