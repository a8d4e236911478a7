"""Diff two persisted bench runs and flag regressions beyond noise (the
port of ``repro.bench.compare``: the same verdicts and exit codes on the
same pair of runs).

Matching is by row ``name``.  The primary metric is ``gbps_measured``
(higher is better); rows with no bandwidth fall back to ``us_per_call``
(lower is better).  The noise threshold is the comparator's floor; each
row's own recorded timing spread (``Timing.noise``) widens it further, so a
jittery row must move more than a steady one before it counts.

CLI:
  python -m repro_torch.bench.compare runs/BENCH_torch_a.json \
      runs/BENCH_torch_b.json [--threshold 0.15] [--gate all|structural]
  (exit 1 when a gating regression verdict is produced)
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.bench.schema import BenchResult, BenchRun

REGRESSION = "regression"
IMPROVEMENT = "improvement"
UNCHANGED = "unchanged"
ADDED = "added"
REMOVED = "removed"


@dataclass
class RowDiff:
    name: str
    verdict: str
    metric: str = ""
    old: float = 0.0
    new: float = 0.0
    rel_change: float = 0.0  # signed; positive = better
    threshold: float = 0.0
    # True when both rows are flagged ``extras["deterministic"]``: the
    # metric is a derived/counted figure (dispatch counts, model-predicted
    # plan bandwidth), so any regression on it is real, not timer noise
    deterministic: bool = False

    @property
    def structural(self) -> bool:
        """A regression the gate can trust on a noisy host: the bandwidth
        metric vanished outright, the row is deterministic, or a
        deterministic row disappeared from the candidate run entirely
        (dropping a gated invariant must not read as a pass)."""
        if self.verdict == REMOVED:
            return self.deterministic
        if self.verdict != REGRESSION:
            return False
        # rel_change <= -1.0 means "vanished" only for higher-is-better
        # bandwidth; for us_per_call any 2x slowdown hits -1.0, which is
        # still just timing noise across hosts
        vanished = self.metric == "gbps_measured" and self.rel_change <= -1.0
        return self.deterministic or vanished


@dataclass
class CompareReport:
    rows: List[RowDiff] = field(default_factory=list)
    noise_threshold: float = 0.15

    @property
    def regressions(self) -> List[RowDiff]:
        return [r for r in self.rows if r.verdict == REGRESSION]

    @property
    def structural_regressions(self) -> List[RowDiff]:
        """Regressions that survive host timing noise: vanished metrics and
        rows flagged ``extras["deterministic"]``."""
        return [r for r in self.rows if r.structural]

    @property
    def improvements(self) -> List[RowDiff]:
        return [r for r in self.rows if r.verdict == IMPROVEMENT]

    def verdicts(self) -> Dict[str, str]:
        return {r.name: r.verdict for r in self.rows}

    def render(self) -> str:
        lines = [f"{'name':40s} {'verdict':12s} {'metric':14s} "
                 f"{'old':>12s} {'new':>12s} {'change':>8s}"]
        for r in sorted(self.rows, key=lambda r: (r.verdict, r.name)):
            if r.verdict in (ADDED, REMOVED):
                lines.append(f"{r.name:40s} {r.verdict:12s}")
                continue
            lines.append(
                f"{r.name:40s} {r.verdict:12s} {r.metric:14s} "
                f"{r.old:12.3f} {r.new:12.3f} {r.rel_change:+7.1%}")
        n_reg = len(self.regressions)
        lines.append(f"# {len(self.rows)} rows compared, "
                     f"{n_reg} regression(s), "
                     f"{len(self.improvements)} improvement(s), "
                     f"noise floor {self.noise_threshold:.0%}")
        return "\n".join(lines)


def _row_threshold(old: BenchResult, new: BenchResult, floor: float) -> float:
    """Noise floor widened by the rows' own recorded trial spread."""
    spread = 0.0
    for r in (old, new):
        if r.timing is not None:
            spread = max(spread, r.timing.noise)
    return floor + spread


def _diff_row(old: BenchResult, new: BenchResult, floor: float) -> RowDiff:
    thresh = _row_threshold(old, new, floor)
    det = (bool(old.extras.get("deterministic"))
           and bool(new.extras.get("deterministic")))
    if old.gbps_measured > 0 and new.gbps_measured <= 0:
        # the primary metric vanished — that IS a regression, never let it
        # fall through to the wall-clock comparison
        return RowDiff(name=old.name, verdict=REGRESSION,
                       metric="gbps_measured", old=old.gbps_measured,
                       new=0.0, rel_change=-1.0, threshold=thresh,
                       deterministic=det)
    if old.gbps_measured <= 0 and new.gbps_measured > 0:
        return RowDiff(name=old.name, verdict=IMPROVEMENT,
                       metric="gbps_measured", old=0.0,
                       new=new.gbps_measured, rel_change=1.0,
                       threshold=thresh, deterministic=det)
    if old.gbps_measured > 0 and new.gbps_measured > 0:
        metric, o, n = "gbps_measured", old.gbps_measured, new.gbps_measured
        rel = (n - o) / o  # positive = faster
    elif old.us_per_call > 0 and new.us_per_call > 0:
        metric, o, n = "us_per_call", old.us_per_call, new.us_per_call
        rel = (o - n) / o  # lower is better -> positive = faster
    else:
        return RowDiff(name=old.name, verdict=UNCHANGED, metric="none",
                       threshold=thresh, deterministic=det)
    if rel < -thresh:
        verdict = REGRESSION
    elif rel > thresh:
        verdict = IMPROVEMENT
    else:
        verdict = UNCHANGED
    return RowDiff(name=old.name, verdict=verdict, metric=metric, old=o,
                   new=n, rel_change=rel, threshold=thresh,
                   deterministic=det)


def compare_runs(old: BenchRun, new: BenchRun,
                 noise_threshold: float = 0.15) -> CompareReport:
    """Row-by-row diff; verdicts: regression / improvement / unchanged /
    added / removed."""
    report = CompareReport(noise_threshold=noise_threshold)
    old_by, new_by = old.by_name(), new.by_name()
    for name, o in old_by.items():
        if name in new_by:
            report.rows.append(_diff_row(o, new_by[name], noise_threshold))
        else:
            report.rows.append(RowDiff(
                name=name, verdict=REMOVED,
                deterministic=bool(o.extras.get("deterministic"))))
    for name in new_by:
        if name not in old_by:
            report.rows.append(RowDiff(name=name, verdict=ADDED))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("old", help="baseline BENCH_torch_*.json")
    ap.add_argument("new", help="candidate BENCH_torch_*.json")
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="relative noise floor (default 0.15)")
    ap.add_argument("--gate", choices=("all", "structural"), default="all",
                    help="which regression verdicts set a nonzero exit: "
                         "'all' (default), or 'structural' — only vanished "
                         "metrics and rows flagged extras['deterministic']; "
                         "wall-clock regressions still print but are "
                         "advisory.  Use 'structural' when baseline and "
                         "candidate ran on different hosts (CI).")
    args = ap.parse_args(argv)
    report = compare_runs(BenchRun.load(args.old), BenchRun.load(args.new),
                          noise_threshold=args.threshold)
    print(report.render())
    # a dropped deterministic row gates under EVERY mode — removing an
    # invariant from the candidate run must never read as a pass
    removed_det = [r for r in report.structural_regressions
                   if r.verdict == REMOVED]
    gating = (report.structural_regressions if args.gate == "structural"
              else report.regressions + removed_det)
    if args.gate == "structural" and (gating or report.regressions):
        print(f"# gate=structural: {len(gating)} gating verdict(s) out of "
              f"{len(report.regressions)} regression(s) + "
              f"{len(removed_det)} dropped deterministic row(s)")
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
