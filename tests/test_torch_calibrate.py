"""The calibration's knobs that describe the card, on the CPU.

On the card a memory row carries its kernel's geometry
(``kernel_resident_blocks`` beside ``kernel_outstanding``, ``kernel_burst_
bytes`` and ``kernel_stride``), and the fit reads the knobs the card ran
(``bench.calibrate.card_knobs``).  Here:

- fitting rows generated at the card's knobs from an H100-like truth
  recovers T_l and BW within 5% (the reference's recovery test at the new
  knobs), where the rows' own knobs do not;
- a row without the geometry (every CPU row, every reference row) gives
  the reference's sample, knob for knob;
- the launcher accepts every architecture (it once refused the unported
  ones).
"""
import dataclasses
import importlib

import pytest

from repro.bench import run_sweeps as j_run_sweeps
from repro.bench.schema import BenchRun as JBenchRun
from repro.configs import ARCHS as J_ARCHS
from repro.core import memmodel as jmm
from repro.models.transformer import paged_supported as j_paged_supported
from repro_torch.bench import run_sweeps as t_run_sweeps
from repro_torch.bench.schema import BenchResult, BenchRun
from repro_torch.core.memmodel import H100, predict_bw
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.launch import serve as launch_serve

jcal = importlib.import_module("repro.bench.calibrate")
tcal = importlib.import_module("repro_torch.bench.calibrate")

# an H100-like truth: the HBM chase's latency and K4's copy rate as the
# card shows them
TRUTH = dataclasses.replace(H100, latency_s=381e-9, hbm_bw=3.0e12)

# the bulk copy's geometry at 1 MiB tiles on 132 SMs (kernels.stream_copy)
BULK = dict(kernel_route="bulk", kernel_unit_bytes=16,
            kernel_burst_bytes=16384, kernel_outstanding=3,
            kernel_smem_bytes=49152)


def _k6(unit, blocks):
    lanes = min(32, max(1, unit // 16))
    return dict(kernel_unit_bytes=16, kernel_lanes_per_index=lanes,
                kernel_outstanding=256 // lanes,
                kernel_resident_blocks=blocks)


def _k5(blocks):
    return dict(kernel_unit_bytes=16, kernel_burst_bytes=32768,
                kernel_outstanding=1, kernel_stride=1,
                kernel_resident_blocks=blocks)


def _card_rows():
    """The memory phase's kinds of row, each at its own knobs (the
    reference's) with the kernel's geometry, measured as the truth's
    model says the card would run them.  Small grids put some rows in the
    latency-limited regime."""
    rows = []

    def add(name, sweep, pattern, knobs, extras):
        card = tcal.card_knobs(knobs, extras)
        rows.append(BenchResult(
            name=name, sweep=sweep, pattern=pattern.value,
            knobs=dataclasses.asdict(knobs),
            gbps_measured=predict_bw(pattern, card, TRUTH) / 1e9,
            extras=dict(extras)))

    for r in range(4):
        add(f"latency_region_{r}", "latency", Pattern.CHASE,
            Knobs(unit_bytes=4, outstanding=1), {})
    for unit in (4, 64, 1024, 4096):
        for blocks in (1, 3, 1056):
            add(f"unit_{unit}B_{blocks}", "unit_size", Pattern.RANDOM,
                Knobs(unit_bytes=unit, outstanding=8), _k6(unit, blocks))
    for blocks in (2, 264):
        add(f"seq_{blocks}", "random", Pattern.SEQUENTIAL,
            Knobs(unit_bytes=512, burst_bytes=32768, outstanding=2),
            dict(BULK, kernel_resident_blocks=blocks))
    for stride in (1, 4, 32):
        for blocks in (1, 1056):
            add(f"stride_{stride}_loop_{blocks}", "stride", Pattern.STRIDED,
                Knobs(unit_bytes=32768, stride=stride), _k5(blocks))
    return BenchRun(results=rows)


def test_card_knobs_rules():
    k = Knobs(unit_bytes=4, outstanding=8, stride=16)
    assert tcal.card_knobs(k, {}) == k
    assert tcal.card_knobs(k, dict(kernel_outstanding=64)) == k
    got = tcal.card_knobs(k, dict(kernel_outstanding=64,
                                  kernel_resident_blocks=1056,
                                  kernel_stride=1))
    assert (got.unit_bytes, got.outstanding, got.stride) == (32, 64 * 1056, 1)
    assert got.burst_bytes == k.burst_bytes
    for unit, want in ((32, 32), (64, 64), (100, 128), (32768, 32768)):
        assert tcal.card_knobs(Knobs(unit_bytes=unit), dict(
            kernel_resident_blocks=2)).unit_bytes == want
    bulk = tcal.card_knobs(Knobs(), dict(BULK, kernel_resident_blocks=264))
    assert (bulk.burst_bytes, bulk.outstanding) == (16384, 3 * 264)


def test_fit_at_the_cards_knobs_recovers_the_truth():
    run = _card_rows()
    cal = tcal.fit_spec(tcal.samples_from_run(run))
    assert cal.n_samples == len(run.results)
    assert abs(cal.spec.latency_s / TRUTH.latency_s - 1) < 0.05
    assert abs(cal.spec.hbm_bw / TRUTH.hbm_bw - 1) < 0.05
    assert cal.rms_log_error < 0.01
    # the same rows under their own knobs: the unphysical fit the card's
    # geometry repairs
    for r in run.results:
        r.extras = {}
    nominal = tcal.fit_spec(tcal.samples_from_run(run))
    assert nominal.spec.hbm_bw > 2 * TRUTH.hbm_bw
    assert nominal.rms_log_error > 10 * cal.rms_log_error


def test_fit_at_the_cards_knobs_recovers_the_truth_with_noise():
    run = _card_rows()
    for i, r in enumerate(run.results):
        r.gbps_measured *= 1.0 + 0.03 * ((i * 7919) % 11 - 5) / 5
    cal = tcal.fit_spec(tcal.samples_from_run(run))
    assert abs(cal.spec.latency_s / TRUTH.latency_s - 1) < 0.15
    assert abs(cal.spec.hbm_bw / TRUTH.hbm_bw - 1) < 0.15


def _sample_tuple(s):
    return (s.pattern.value, dataclasses.asdict(s.knobs), s.gbps)


def test_rows_without_geometry_give_the_reference_samples():
    """Rows with the kernels' other knobs but no resident blocks (what the
    CPU emits) and rows with no extras at all."""
    run = _card_rows()
    for r in run.results:
        r.extras.pop("kernel_resident_blocks", None)
    jrun = JBenchRun.from_dict(run.to_dict())
    got = [_sample_tuple(s) for s in tcal.samples_from_run(run)]
    want = [_sample_tuple(s) for s in jcal.samples_from_run(jrun)]
    assert got == want and got


@pytest.fixture(scope="module")
def cpu_runs():
    names = ["latency", "unit_size", "stride", "random"]
    spec = jmm.TPUSpec(
        name=H100.name, peak_flops_bf16=H100.peak_flops_bf16,
        hbm_bw=H100.hbm_bw, ici_bw=H100.nvlink_bw, hbm_bytes=H100.hbm_bytes,
        vmem_bytes=H100.smem_bytes, clock_hz=H100.clock_hz,
        dma_latency_s=H100.latency_s)
    jrun = j_run_sweeps(names=names, fast=True, echo=False, spec=spec)
    trun = t_run_sweeps(names=names, fast=True, echo=False, device="cpu")
    return jrun, trun


def test_cpu_rows_fit_as_the_reference(cpu_runs):
    jrun, trun = cpu_runs
    assert not trun.failures and not jrun.failures
    assert not any("kernel_resident_blocks" in r.extras
                   for r in trun.results)
    got = [(s.pattern.value, dataclasses.asdict(s.knobs))
           for s in tcal.samples_from_run(trun)]
    want = [(s.pattern.value, dataclasses.asdict(s.knobs))
            for s in jcal.samples_from_run(jrun)]
    assert got == want and len(got) > 20


class _Built(Exception):
    """Stops the launcher once its model is built."""


# every stack serves at smoke width but seamless-m4t-medium, which fails at
# its first prefill as the reference's launcher does: the engine's requests
# carry no encoder frames
ENCODER_DECODER = ("seamless-m4t-medium",)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "grok-1-314b",
                                  "pixtral-12b", "seamless-m4t-medium"])
@pytest.mark.parametrize("smoke", [True, False])
def test_launcher_refuses_unported_archs(arch, smoke, monkeypatch, capsys):
    """Every stack is accepted now.  A served stack serves at smoke width
    on the CPU (the MoE stacks under the launcher's ``moe_impl="dense"``,
    pixtral-12b's text prompts from the dense cache); seamless-m4t-medium
    fails at its first prefill.  At full width (17 GB of weights for
    recurrentgemma-9b, 628 GB for grok-1-314b) the launcher is stopped once
    its model is built, which shows the build accepted it, with the
    reference's paged support."""
    argv = ["--arch", arch, "--device", "cpu"] + (["--smoke"] if smoke else [])
    if smoke:
        argv += ["--requests", "3", "--batch", "2", "--max-new", "4"]
        if arch in ENCODER_DECODER:
            with pytest.raises(ValueError, match="no encoder frames"):
                launch_serve.main(argv)
            return
        assert launch_serve.main(argv) == 0
        assert "12 tokens" in capsys.readouterr().out
        return
    real_build = launch_serve.build

    def build_then_stop(cfg, flags, device=None):
        raise _Built(real_build(cfg, flags, device=device))

    monkeypatch.setattr(launch_serve, "build", build_then_stop)
    with pytest.raises(_Built) as built:
        launch_serve.main(argv)
    bundle = built.value.args[0]
    assert bundle.cfg.name == arch and bundle.flags.moe_impl == "dense"
    assert bundle.paged_supported() == j_paged_supported(J_ARCHS[arch])
