"""The port's memory engines held against the reference's on the CPU.

- K4-K7's plain versions (``repro_torch.kernels.ref``, what the port runs on
  the CPU) against the reference's Pallas kernels in interpret mode, at
  tolerance 0 (they copy), over the parameter sets of
  ``tests/test_kernels.py``;
- the LFSR address generator and the Sattolo chain builder, bit for bit,
  against live JAX and numpy output;
- the memory model's equations under a ``HopperSpec`` built here from the
  reference's ``V5E`` fields (relative tolerance 1e-12), and the
  calibration fit;
- the seven ported sweeps at ``fast`` on the CPU: the same rows (names,
  order, patterns, knobs, bytes moved) as the reference's;
- the schema's JSON round trip and the CLI.

No test here asserts an ordering of wall times: on a loaded host they
move; the orderings are checked on the card (``chip_smoke.py``).
The CUDA kernels themselves are held against the plain versions on the
card in ``test_torch_cuda.py``.
"""
import dataclasses
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import run_sweeps as j_run_sweeps
from repro.bench.schema import BenchRun as JBenchRun
from repro.bench.sweeps.outstanding import _multi_chase
from repro.core import engines as jeng
from repro.core import memmodel as jmm
from repro.core.patterns import Knobs as JKnobs
from repro.core.patterns import Pattern as JPattern
from repro.kernels import ops as jops
from repro.kernels.random_gather import random_gather as j_random_gather
from repro_torch.bench import run_sweeps as t_run_sweeps
from repro_torch.bench.schema import BenchResult, BenchRun, Timing
from repro_torch.core import engines as teng
from repro_torch.core import memmodel as tmm
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pointer_chase as tpc

# the modules (each package's ``calibrate`` name is the function)
jcal = importlib.import_module("repro.bench.calibrate")
tcal = importlib.import_module("repro_torch.bench.calibrate")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(42)
SWEEPS = ("latency", "outstanding", "unit_size", "stride", "burst",
          "num_kernels", "random")

# the reference's constants in the port's spec type, built here: the port's
# code holds no TPU constant
V5E_AS_HOPPER = tmm.HopperSpec(
    name=jmm.V5E.name, peak_flops_bf16=jmm.V5E.peak_flops_bf16,
    hbm_bw=jmm.V5E.hbm_bw, hbm_bytes=jmm.V5E.hbm_bytes,
    smem_bytes=jmm.V5E.vmem_bytes, clock_hz=jmm.V5E.clock_hz,
    latency_s=jmm.V5E.dma_latency_s)


def _arr(shape, dtype):
    """numpy data for both sides; int8 as in tests/test_kernels.py."""
    x = RNG.standard_normal(shape)
    if dtype == "int8":
        return (x * 32).clip(-127, 127).astype(np.int8)
    return x.astype(np.float32)


def _both(a, dtype):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``."""
    if dtype == "int8":
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.dtype(dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _same(got, want):
    """Tolerance 0, compared as float32 (bf16 and int8 are exact there)."""
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# K4-K7 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

STREAM_CASES = [(shape, dtype, br)
                for shape in ((128, 128), (256, 512), (64, 384))
                for dtype in ("float32", "bfloat16", "int8")
                for br in (8, 64) if shape[0] % br == 0]


@pytest.mark.parametrize("shape,dtype,block_rows", STREAM_CASES)
def test_stream_copy_matches_pallas(shape, dtype, block_rows):
    jx, tx = _both(_arr(shape, dtype), dtype)
    _same(tops.stream_copy(tx, block_rows=block_rows),
          jops.stream_copy(jx, block_rows=block_rows, interpret=True))


@pytest.mark.parametrize("mode", ["copy", "rw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_stream_modes_match_pallas(mode, dtype):
    a = _arr((128, 256), dtype)
    if dtype == "int8":      # reach the int8 wrap of x2
        a = (RNG.integers(-128, 128, (128, 256))).astype(np.int8)
    jx, tx = _both(a, dtype)
    _same(tops.stream_copy(tx, block_rows=32, mode=mode),
          jops.stream_copy(jx, block_rows=32, mode=mode, interpret=True))


@pytest.mark.parametrize("stride", [1, 2, 3, 7, 15])
@pytest.mark.parametrize("block_rows", [4, 16])
def test_strided_copy_matches_pallas(stride, block_rows):
    jx, tx = _both(_arr((256, 64), "float32"), "float32")
    _same(tops.strided_copy(tx, block_rows=block_rows, stride=stride),
          jops.strided_copy(jx, block_rows=block_rows, stride=stride,
                            interpret=True))


def test_strided_copy_repeats_blocks_when_not_coprime():
    """Stride 2 over 16 blocks reads only the even blocks, twice each."""
    x = torch.arange(64, dtype=torch.float32)[:, None].repeat(1, 4)
    out = tops.strided_copy(x, block_rows=4, stride=2)
    src = out[::4, 0].long() // 4
    assert src.tolist() == [(2 * i) % 16 for i in range(16)]


@pytest.mark.parametrize("n_idx", [16, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_gather_matches_pallas(n_idx, dtype):
    jx, tx = _both(_arr((512, 128), dtype), dtype)
    jidx = jops.lfsr_indices(n_idx, bits=16) % 512
    tidx = tops.lfsr_indices(n_idx, bits=16) % 512
    _same(tops.random_gather(tx, tidx),
          jops.random_gather(jx, jidx, interpret=True))


@pytest.mark.parametrize("block_rows,cols", [(4, 16), (2, 1), (8, 128)])
def test_random_gather_blocks_match_pallas(block_rows, cols):
    """block_rows > 1 indexes blocks: idx[i] * block_rows."""
    jx, tx = _both(_arr((256, cols), "float32"), "float32")
    nb = 256 // block_rows
    tidx = tops.lfsr_indices(40, bits=16) % nb      # repeats: 40 over nb
    _same(tops.random_gather(tx, tidx, block_rows=block_rows),
          j_random_gather(jx, jnp.asarray(tidx.numpy()),
                          block_rows=block_rows, interpret=True))


@pytest.mark.parametrize("n", [64, 256, 1000])
def test_pointer_chase_matches_pallas(n):
    steps = min(2 * n, 300)
    got = tops.pointer_chase(tops.make_chain(n, seed=n), steps=steps)
    _same(got, jops.pointer_chase(jops.make_chain(n, seed=n), steps=steps,
                                  interpret=True))


@pytest.mark.parametrize("chains", [1, 4, 64])
def test_multi_chain_chase_matches_reference(chains):
    """C > 1 chains walked together: the outstanding sweep's
    ``_multi_chase``."""
    n, steps = 128, 200
    t = torch.stack([tops.make_chain(n, seed=i) for i in range(chains)])
    j = jnp.stack([jops.make_chain(n, seed=i) for i in range(chains)])
    got = tops.pointer_chase(t, steps=steps)
    assert got.shape == (chains, steps, 1)
    _same(got[..., 0], _multi_chase(j, steps))


# ---------------------------------------------------------------------------
# the host generators, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("seed", [0xACE1, 0xACE1 + 3, 7, 0x7FFFFFFF])
def test_lfsr_indices_bit_for_bit(bits, seed):
    for n in (1, 5, 1000, 4097):
        want = np.asarray(jops.lfsr_indices(n, bits=bits, seed=seed))
        got = tops.lfsr_indices(n, bits=bits, seed=seed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 16, 1000, 4096, 70000])
def test_make_chain_bit_for_bit(n):
    for seed in (0, n, 12345):
        np.testing.assert_array_equal(
            tops.make_chain(n, seed=seed).numpy(),
            np.asarray(jops.make_chain(n, seed=seed)))


@pytest.mark.parametrize("n", [1, 7, 4096])
def test_randperm_chain_is_one_cycle(n):
    table = tops.make_chain_randperm(n, seed=3)
    assert table.shape == (n, 1) and table.dtype == torch.int32
    trace = tops.pointer_chase(table, steps=n)[:, 0]
    assert sorted(trace.tolist()) == list(range(n))


def test_chain_builder_by_size():
    assert tpc.chain(64, 1)[1] == "sattolo"
    table, builder = tpc.chain(tpc.SATTOLO_MAX_N + 1, 1)
    assert builder == "randperm" and table.shape == (tpc.SATTOLO_MAX_N + 1, 1)


# ---------------------------------------------------------------------------
# the memory model
# ---------------------------------------------------------------------------

KNOB_SETS = [dict(), dict(unit_bytes=4, outstanding=1),
             dict(unit_bytes=64, outstanding=8),
             dict(burst_bytes=1 << 16, outstanding=3, engines=4),
             dict(unit_bytes=4096, stride=8, outstanding=32),
             dict(burst_bytes=1 << 22, outstanding=64, stride=2, engines=2)]


def _rel(a, b):
    assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (a, b)


@pytest.mark.parametrize("pattern", list(Pattern), ids=lambda p: p.value)
@pytest.mark.parametrize("kw", KNOB_SETS, ids=str)
def test_memmodel_matches_reference(pattern, kw):
    tk, jk = Knobs(**kw), JKnobs(**kw)
    jp = JPattern(pattern.value)
    spec = V5E_AS_HOPPER
    _rel(tmm.predict_bw(pattern, tk, spec), jmm.predict_bw(jp, jk))
    _rel(tmm.aggregate_bw(pattern, tk, spec), jmm.aggregate_bw(jp, jk))
    assert tk.smem_bytes() == jk.vmem_bytes()
    assert tmm.smem_ok(tk, spec) == jmm.vmem_ok(jk)


def test_memmodel_equations_match_reference():
    spec = V5E_AS_HOPPER
    _rel(tmm.t_l(spec), jmm.t_l())
    _rel(tmm.tau_ii_serialized(3e-9, spec), jmm.tau_ii_serialized(3e-9))
    _rel(tmm.tau_ii_pipelined(spec), jmm.tau_ii_pipelined())
    for no in (1, 2, 7, 64, 10**6):
        _rel(tmm.tau_ii_outstanding(no, spec), jmm.tau_ii_outstanding(no))
    _rel(tmm.achieved_bw(12345.0, 6e-6), jmm.achieved_bw(12345.0, 6e-6))
    _rel(tmm.theoretical_bw(spec), jmm.theoretical_bw())
    _rel(spec.latency_cycles, jmm.V5E.dma_latency_cycles)
    for burst in (1, 4096, 1 << 16, 1 << 20):
        assert tmm.min_outstanding_for_peak(burst, spec) == \
            jmm.min_outstanding_for_peak(burst)
    for n in (0, 1, 3, 8, 1000):
        assert tmm.next_pow2(n) == jmm.next_pow2(n)


def test_h100_spec_holds_the_cards_constants():
    h = tmm.H100
    assert h.hbm_bw == 3.35e12 and h.peak_flops_bf16 == 989e12
    assert h.hbm_bytes == 80 * 2**30 and h.l2_bytes == 50 * 2**20
    assert h.smem_bytes == 227 * 2**10
    assert 100e-9 < h.latency_s < 2e-6


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _as_reference(samples):
    return [jcal.CalibSample(JPattern(s.pattern.value),
                             JKnobs(**dataclasses.asdict(s.knobs)), s.gbps)
            for s in samples]


@pytest.mark.parametrize("lat,bw,noise", [(420e-9, 512e9, 0.0),
                                          (1200e-9, 96e9, 0.03),
                                          (386e-9, 3.0e12, 0.0)])
def test_fit_spec_matches_reference(lat, bw, noise):
    true = dataclasses.replace(tmm.H100, latency_s=lat, hbm_bw=bw)
    jtrue = dataclasses.replace(jmm.V5E, dma_latency_s=lat, hbm_bw=bw)
    samples = tcal.synthetic_samples(true, noise=noise, seed=7)
    jsamples = jcal.synthetic_samples(jtrue, noise=noise, seed=7)
    assert [s.gbps for s in samples] == pytest.approx(
        [s.gbps for s in jsamples], rel=1e-12)
    base = dataclasses.replace(tmm.H100, latency_s=jmm.V5E.dma_latency_s,
                               hbm_bw=jmm.V5E.hbm_bw)
    got = tcal.fit_spec(samples, base=base)
    want = jcal.fit_spec(_as_reference(samples))
    _rel(got.spec.latency_s, want.spec.dma_latency_s)
    _rel(got.spec.hbm_bw, want.spec.hbm_bw)
    _rel(got.rms_log_error, want.rms_log_error)
    assert got.ratios == pytest.approx(want.ratios, rel=1e-12)
    tol = 0.05 if noise == 0 else 0.15
    assert abs(got.spec.latency_s / lat - 1) < tol
    assert abs(got.spec.hbm_bw / bw - 1) < tol


def test_samples_from_run_keeps_the_fit_sweeps():
    def row(name, sweep, gbps):
        return BenchResult(name=name, sweep=sweep, pattern="random",
                           knobs=dict(unit_bytes=64, outstanding=8),
                           gbps_measured=gbps)
    run = BenchRun(results=[row("ok", "unit_size", 3.0),
                            row("wrong_sweep", "num_kernels", 3.0),
                            row("no_bw", "latency", 0.0)])
    samples = tcal.samples_from_run(run)
    assert [s.gbps for s in samples] == [3.0]
    assert samples[0].pattern == Pattern.RANDOM


# ---------------------------------------------------------------------------
# engines and sweeps at fast, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_runs():
    jrun = j_run_sweeps(names=list(SWEEPS), fast=True, echo=False)
    # the reference's constants, so that the model columns compare too
    trun = t_run_sweeps(fast=True, echo=False, device="cpu",
                        spec=V5E_AS_HOPPER)
    return jrun, trun


def test_sweeps_run_in_the_reference_order(both_runs):
    jrun, trun = both_runs
    assert not jrun.failures and not trun.failures
    assert [r.sweep for r in trun.results] == [r.sweep for r in jrun.results]
    assert trun.env["device"] == "cpu" and trun.env["fast"] is True


@pytest.mark.parametrize("sweep", SWEEPS)
def test_sweep_rows_match_reference(both_runs, sweep):
    jrun, trun = both_runs
    jrows, trows = jrun.by_sweep(sweep), trun.by_sweep(sweep)
    assert [r.name for r in trows] == [r.name for r in jrows]
    assert [r.pattern for r in trows] == [r.pattern for r in jrows]
    assert [r.knobs for r in trows] == [r.knobs for r in jrows]
    for t, j in zip(trows, jrows):
        # the reference keeps no bytes column: its Eq. 5 gives them back
        want = j.gbps_measured * 1e9 * j.us_per_call * 1e-6
        assert math.isclose(t.extras["bytes_moved"], want, rel_tol=1e-9), \
            (t.name, t.extras["bytes_moved"], want)
        assert t.gbps_measured > 0 and t.us_per_call > 0
        _rel(t.gbps_predicted, j.gbps_predicted)


def test_engine_rows_match_reference():
    spec = V5E_AS_HOPPER
    pairs = [
        (teng.latency_chase(n_entries=256, steps=64, spec=spec, device="cpu"),
         jeng.latency_chase(n_entries=256, steps=64)),
        (teng.bw_sequential(rows=64, cols=128, spec=spec, device="cpu"),
         jeng.bw_sequential(rows=64, cols=128)),
        (teng.bw_sequential(rows=64, cols=128, dtype=torch.bfloat16,
                            spec=spec, device="cpu"),
         jeng.bw_sequential(rows=64, cols=128, dtype=jnp.bfloat16)),
        (teng.bw_strided(64, 32, 3, spec=spec, device="cpu"),
         jeng.bw_strided(64, 32, 3)),
        (teng.bw_random(n_rows=256, cols=16, n_idx=64, spec=spec,
                        device="cpu"),
         jeng.bw_random(n_rows=256, cols=16, n_idx=64)),
        (teng.bw_random(n_rows=256, cols=16, n_idx=64, generator="prng",
                        spec=spec, device="cpu"),
         jeng.bw_random(n_rows=256, cols=16, n_idx=64, generator="prng")),
    ]
    pairs += list(zip(teng.latency_by_region(2, 128, 32, spec=spec,
                                             device="cpu"),
                      jeng.latency_by_region(2, 128, 32)))
    pairs += list(zip(teng.bw_unit_size_sweep((4, 64), spec=spec,
                                              device="cpu"),
                      jeng.bw_unit_size_sweep((4, 64))))
    pairs += list(zip(teng.bw_outstanding_sweep(spec=spec),
                      jeng.bw_outstanding_sweep()))
    for t, j in pairs:
        assert (t.name, t.pattern, t.bytes_moved) == \
            (j.name, j.pattern, j.bytes_moved)
        _rel(t.gbps_model, j.gbps_tpu_model)


def test_bw_random_draws_fresh_indices_per_trial(monkeypatch):
    seen = []
    real = teng.random_indices

    def spy(n_idx, n_rows, seed, generator, device):
        seen.append(seed)
        return real(n_idx, n_rows, seed, generator, device)

    monkeypatch.setattr(teng, "random_indices", spy)
    teng.bw_random(n_rows=64, cols=4, n_idx=32, device="cpu")
    assert seen == [0, 1, 2, 3]      # one warm-up, three timed trials


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engines_and_sweeps_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        teng.latency_chase(n_entries=64, steps=8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_run_sweeps(names=["latency"], fast=True, echo=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcal.calibrate(fast=True)


# ---------------------------------------------------------------------------
# schema and CLI
# ---------------------------------------------------------------------------

def test_schema_round_trip_keeps_the_reference_layout(tmp_path):
    r = BenchResult(name="x", sweep="latency", pattern="chase",
                    knobs=dict(unit_bytes=4), us_per_call=12.5,
                    gbps_measured=0.3, gbps_predicted=0.01,
                    timing=Timing(best_s=1.25e-5, mean_s=1.5e-5, trials=3),
                    extras=dict(ns_per_hop="386.0"))
    run = BenchRun(results=[r], spec=dataclasses.asdict(tmm.H100),
                   failures={"stride": "trace"})
    path = run.save(str(tmp_path))
    assert os.path.basename(path).startswith("BENCH_torch_")
    back = BenchRun.load(path)
    assert back.to_dict() == run.to_dict()
    assert back.results[0].timing.noise == pytest.approx(0.2)
    d = run.to_dict()
    jd = JBenchRun.from_dict(json.loads(json.dumps(d))).to_dict()
    assert set(jd) == set(d)
    assert set(jd["results"][0]) == set(d["results"][0])


def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.bench", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_cli_runs_latency_on_the_cpu(tmp_path):
    res = _cli("--fast", "--sweeps", "latency", "--device", "cpu", "--out",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "latency_region_0," in res.stdout
    assert "latency_stride_18," in res.stdout
    files = list(tmp_path.glob("BENCH_torch_*.json"))
    assert len(files) == 1
    run = BenchRun.load(str(files[0]))
    assert len(run.results) == 12 and run.env["device"] == "cpu"


def test_cli_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    res = _cli("--fast", "--sweeps", "latency")
    assert res.returncode != 0
    assert "no CUDA card" in res.stderr


def test_dispatch_has_no_path_for_other_devices():
    x = torch.empty((8, 4), device="meta")
    idx = torch.empty(2, dtype=torch.int32, device="meta")
    table = torch.empty((8, 1), dtype=torch.int32, device="meta")
    for call in (lambda: tops.stream_copy(x), lambda: tops.strided_copy(x),
                 lambda: tops.random_gather(x, idx),
                 lambda: tops.pointer_chase(table, steps=2)):
        with pytest.raises(ValueError, match="no path for device"):
            call()
