"""The serving yardstick held against the reference on the CPU.

- ``compare``: the reference's comparator cases (``tests/test_bench.py``:
  a synthetic pair, noise widening the threshold, a vanished bandwidth, the
  us-per-call fallback, the CLI, the structural gate) written once as JSON
  runs and read by both comparators: every verdict, every structural flag
  and every exit code of both CLI gates must be equal, and equal to what
  the reference's own test expects;
- the ``serve``, ``kernel_plan``, ``paged_serve``, ``spec_serve`` and
  ``preempt_serve`` sweeps at ``fast``:
  the port's rows (on the CPU) against the reference's, in names, order,
  patterns, knobs and deterministic columns (the counters, pages and
  live-bytes ratios, the speculative counters, the preemption, swap and
  fault counters, and the plan's tiles and predicted GB/s, derived by
  both under the H100's constants).  Wall-clock columns are never
  compared.  The one deterministic value that differs on purpose is
  ``preempt_serve_swap_advantage``: the port prices the swap on the
  card's host link (64 GB/s), the reference on its 32 GB/s guess; the
  port's value is held to its own cost model instead.
"""
import dataclasses
import math

import pytest

from repro.bench import run_sweeps as j_run_sweeps
from repro.bench.compare import compare_runs as j_compare_runs
from repro.bench.compare import main as j_compare_main
from repro.bench.registry import ORDER as J_ORDER
from repro.bench.schema import BenchResult as JResult
from repro.bench.schema import BenchRun as JRun
from repro.bench.schema import Timing as JTiming
from repro.core import memmodel as jmm
from repro_torch.bench import run_sweeps as t_run_sweeps
from repro_torch.bench.compare import (ADDED, IMPROVEMENT, REGRESSION,
                                       REMOVED, UNCHANGED)
from repro_torch.bench.compare import compare_runs as t_compare_runs
from repro_torch.bench.compare import main as t_compare_main
from repro_torch.bench.registry import ORDER as T_ORDER
from repro_torch.bench.schema import BenchRun as TRun
from repro_torch.core.memmodel import H100
from repro_torch.serve import SwapCostModel

SWEEPS = ("serve", "kernel_plan", "paged_serve", "spec_serve",
          "preempt_serve")

# the H100's constants in the reference's spec type (as test_torch_tune)
H100_AS_TPU = jmm.TPUSpec(
    name=H100.name, peak_flops_bf16=H100.peak_flops_bf16, hbm_bw=H100.hbm_bw,
    ici_bw=H100.nvlink_bw, hbm_bytes=H100.hbm_bytes,
    vmem_bytes=H100.smem_bytes, clock_hz=H100.clock_hz,
    dma_latency_s=H100.latency_s)


# ---------------------------------------------------------------------------
# compare: the reference's cases, through both comparators
# ---------------------------------------------------------------------------

def _row(name, gbps=10.0, timing=None, us=123.4, **extras):
    return JResult(name=name, sweep="unit_size", pattern="random",
                   knobs=dict(unit_bytes=1024, outstanding=8),
                   us_per_call=us, gbps_measured=gbps, gbps_predicted=8.0,
                   timing=timing, extras=extras)


NOISY = JTiming(best_s=1e-3, mean_s=1.3e-3, trials=3)
STEADY = JTiming(best_s=1e-3, mean_s=1.0e-3, trials=3)
TIMED = JTiming(best_s=1e-3, mean_s=1.1e-3, trials=3)

# name: (old rows, new rows, noise threshold, the reference test's
# expected verdicts, expected exit codes (gate all, gate structural))
COMPARE_CASES = {
    "synthetic-pair": (
        [_row("reg"), _row("imp"), _row("same"), _row("gone")],
        [_row("reg", 5.0), _row("imp", 20.0), _row("same", 10.5),
         _row("new", 1.0)], 0.15,
        dict(reg=REGRESSION, imp=IMPROVEMENT, same=UNCHANGED, gone=REMOVED,
             new=ADDED), (1, 0)),
    "noise-widens": (
        [_row("r", 10.0, NOISY)], [_row("r", 8.0, NOISY)], 0.15,
        dict(r=UNCHANGED), (0, 0)),
    "steady-at-5pct": (
        [_row("r", 10.0, STEADY)], [_row("r", 8.0, STEADY)], 0.05,
        dict(r=REGRESSION), (1, 0)),
    "vanished-bandwidth": (
        [_row("r", 10.0)], [_row("r", 0.0)], 0.15,
        dict(r=REGRESSION), (1, 1)),
    "vanished-mirror": (
        [_row("r", 0.0)], [_row("r", 10.0)], 0.15,
        dict(r=IMPROVEMENT), (0, 0)),
    "us-fallback": (
        [_row("r", 0.0)], [_row("r", 0.0, us=300.0)], 0.15,
        dict(r=REGRESSION), (1, 0)),
    "cli-same": (
        [_row("r", 10.0)], [_row("r", 10.0)], 0.15,
        dict(r=UNCHANGED), (0, 0)),
    "cli-drop": (
        [_row("r", 10.0)], [_row("r", 1.0)], 0.15,
        dict(r=REGRESSION), (1, 0)),
    "structural-noise": (
        [_row("wallclock", 10.0, TIMED), _row("counter", 8.0,
                                              deterministic=True)],
        [_row("wallclock", 1.0, TIMED), _row("counter", 8.0,
                                             deterministic=True)], 0.15,
        dict(wallclock=REGRESSION, counter=UNCHANGED), (1, 0)),
    "structural-broken": (
        [_row("wallclock", 10.0, TIMED), _row("counter", 8.0,
                                              deterministic=True)],
        [_row("wallclock", 10.0, TIMED), _row("counter", 1.0,
                                              deterministic=True)], 0.15,
        dict(wallclock=UNCHANGED, counter=REGRESSION), (1, 1)),
    "structural-vanished": (
        [_row("wallclock", 10.0, TIMED), _row("counter", 8.0,
                                              deterministic=True)],
        [_row("wallclock", 0.0, TIMED), _row("counter", 8.0,
                                             deterministic=True)], 0.15,
        dict(wallclock=REGRESSION, counter=UNCHANGED), (1, 1)),
    "structural-removed": (
        [_row("wallclock", 10.0, TIMED), _row("counter", 8.0,
                                              deterministic=True)],
        [_row("wallclock", 9.0, TIMED)], 0.15,
        dict(wallclock=UNCHANGED, counter=REMOVED), (1, 1)),
    "us-slowdown-not-structural": (
        [_row("uscall", 0.0, TIMED, us=100.0)],
        [_row("uscall", 0.0, TIMED, us=250.0)], 0.15,
        dict(uscall=REGRESSION), (1, 0)),
}


@pytest.mark.parametrize("name", list(COMPARE_CASES))
def test_compare_matches_reference(name, tmp_path, capsys):
    old, new, floor, verdicts, exits = COMPARE_CASES[name]
    a = JRun(results=old, spec={"name": "test"}).dump(str(tmp_path / "a.json"))
    b = JRun(results=new, spec={"name": "test"}).dump(str(tmp_path / "b.json"))
    jrep = j_compare_runs(JRun.load(a), JRun.load(b), noise_threshold=floor)
    trep = t_compare_runs(TRun.load(a), TRun.load(b), noise_threshold=floor)
    assert trep.verdicts() == jrep.verdicts() == verdicts
    assert ([dataclasses.astuple(r) for r in trep.rows]
            == [dataclasses.astuple(r) for r in jrep.rows])
    assert ([r.name for r in trep.structural_regressions]
            == [r.name for r in jrep.structural_regressions])
    assert trep.render() == jrep.render()
    for gate, want in zip(("all", "structural"), exits):
        args = [a, b, "--threshold", str(floor), "--gate", gate]
        assert t_compare_main(args) == j_compare_main(args) == want, gate
    out = capsys.readouterr().out
    assert "rows compared" in out


def test_compare_cli_runs_as_a_module(tmp_path):
    import os
    import subprocess
    import sys
    a = JRun(results=[_row("r", 10.0)]).dump(str(tmp_path / "a.json"))
    b = JRun(results=[_row("r", 1.0)]).dump(str(tmp_path / "b.json"))
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "repro_torch.bench.compare",
                          a, b], cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 1 and "regression" in res.stdout


# ---------------------------------------------------------------------------
# the serving sweeps at fast
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_runs():
    jrun = j_run_sweeps(names=list(SWEEPS), fast=True, echo=False,
                        spec=H100_AS_TPU)
    trun = t_run_sweeps(names=list(SWEEPS), fast=True, echo=False,
                        device="cpu")
    return jrun, trun


def test_serving_sweeps_registered_in_the_reference_order():
    assert T_ORDER == [n for n in J_ORDER if n in T_ORDER]
    assert [n for n in T_ORDER if n in SWEEPS] == list(SWEEPS)


def test_serving_sweeps_emit_the_reference_rows(both_runs):
    jrun, trun = both_runs
    assert not jrun.failures and not trun.failures, (jrun.failures,
                                                     trun.failures)
    assert ([(r.sweep, r.name) for r in trun.results]
            == [(r.sweep, r.name) for r in jrun.results])


# the columns that do not depend on the host's clock
DETERMINISTIC_EXTRAS = (
    "tokens_out", "decode_dispatches", "ticks_per_dispatch",
    "prefill_compiles_cold", "kv_bytes", "live_bytes_peak", "bq", "bkv",
    "plan_source", "plan_predicted_gbps", "pages_peak", "page_size",
    "pool_pages", "hit_tokens", "prompt_tokens", "ring_slots",
    "ring_pages_peak", "native_page_size", "spec_steps", "draft_accepted",
    "draft_tokens", "preemptions", "swap_outs", "swap_ins",
    "swap_fallbacks", "recompute_resumes", "swap_bytes", "choice",
    "prefill_chunks", "pool_stalls", "recompute_ms", "deterministic")

# rows whose value (and these extras) the port prices on the card's host
# link: held to the port's own cost model, not to the reference's
CARD_PRICED = {"preempt_serve_swap_advantage": ("swap_ms",)}

J_ROWS = [
    "serve_default", "serve_fastpath", "serve_ticks_per_dispatch",
    "serve_prefill_compiles", "kernel_plan_default", "kernel_plan_tuned",
    "kernel_plan_predicted", "paged_serve_dense", "paged_serve_paged",
    "paged_serve_live_bytes_ratio", "paged_serve_prefix_hit_rate",
    "paged_serve_ticks_per_dispatch",
    "paged_serve_windowed_live_bytes_ratio",
    "paged_serve_windowed_ring_bound", "paged_serve_int8_live_bytes_ratio",
    "paged_serve_int8_page_tokens_ratio", "spec_serve_vanilla",
    "spec_serve_spec", "spec_serve_accept_per_step",
    "spec_serve_accept_rate", "spec_serve_verify_tokens_per_dispatch",
    "spec_serve_ticks_per_dispatch", "spec_serve_tokens_match",
    "preempt_serve_undisturbed", "preempt_serve_chaos_costmodel",
    "preempt_serve_chaos_swap", "preempt_serve_chaos_recompute",
    "preempt_serve_tokens_match", "preempt_serve_fault_coverage",
    "preempt_serve_swap_advantage", "preempt_serve_resume_walls",
    "preempt_serve_burst_bound", "preempt_serve_p99_tick",
    "preempt_serve_priority_first"]


@pytest.mark.parametrize("name", J_ROWS)
def test_serving_row_matches_reference(both_runs, name):
    jrun, trun = both_runs
    j, t = jrun.by_name()[name], trun.by_name()[name]
    assert (t.sweep, t.pattern, t.knobs) == (j.sweep, j.pattern, j.knobs)
    for key in DETERMINISTIC_EXTRAS:
        assert (key in t.extras) == (key in j.extras), key
        if key in j.extras:
            assert t.extras[key] == j.extras[key], (key, t.extras[key],
                                                     j.extras[key])
    assert ("metric" in t.extras) == ("metric" in j.extras)
    if j.extras.get("deterministic"):
        assert t.timing is None and j.timing is None
        if name in CARD_PRICED:
            cm = SwapCostModel(weight_bytes=5e9, kv_bytes_per_token=18_432,
                               prefill_chunk=256)
            assert t.gbps_measured == cm.recompute_s(8192) / cm.swap_s(8192)
            assert t.extras["swap_ms"] == cm.swap_s(8192) * 1e3
            assert t.gbps_measured > j.gbps_measured > 1.0
        else:
            assert math.isclose(t.gbps_measured, j.gbps_measured,
                                rel_tol=1e-12), (t.gbps_measured,
                                                 j.gbps_measured)
        assert math.isclose(t.gbps_predicted, j.gbps_predicted,
                            rel_tol=1e-12)
        if j.us_per_call or t.us_per_call:
            assert t.us_per_call == j.us_per_call
    elif j.timing is None:
        # advisory rows (a p99 round, resume walls): a wall in microseconds
        assert t.timing is None and t.us_per_call > 0 and j.us_per_call > 0
    else:
        assert t.timing.trials == j.timing.trials
        # a timed row carries a bandwidth where the reference's does
        # (spec_serve's timed rows move no counted bytes)
        assert (t.gbps_measured > 0) == (j.gbps_measured > 0)
        assert t.us_per_call > 0
