"""The paper's Tables 9 and 10 and the roofline rows, held against the
reference on the CPU.

- the ``database``, ``conv`` and ``roofline`` sweeps at ``fast``: row
  names, order, patterns, knobs, bytes moved, the paper's columns, the
  advice (after the word map of ``tests/test_torch_advisor.py``) and the
  roofline terms equal the reference's sweep run under a ``TPUSpec`` that
  carries the H100's constants; the reference is pinned to its analytic
  roofline path (no dry-run artifact);
- what the rows compute: the convolution against
  ``lax.conv_general_dilated`` (1e-5), the split row's padded shards, the
  naive CPU window, the r_acc row's LFSR indices (bit for bit) and the
  nest row's chunked attention (1e-5);
- the sweep registry: 14 sweeps in the reference's order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import run_sweeps as j_run_sweeps
from repro.bench.registry import ORDER as J_ORDER
from repro.core import memmodel as jmm
from repro.core.patterns import ADVICE as J_ADVICE
from repro.kernels import ops as jops
from repro.models.attention import AttnParams as JAttnParams
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.bench import run_sweeps as t_run_sweeps
from repro_torch.bench.registry import ORDER as T_ORDER
from repro_torch.bench.sweeps import conv as tconv
from repro_torch.core.memmodel import H100
from repro_torch.core.patterns import ADVICE, Pattern
from repro_torch.kernels.random_gather import lfsr_indices
from repro_torch.models.attention import AttnParams, chunked_attention

SWEEPS = ("database", "conv", "roofline")
PAPER_COLUMNS = ("paper_u280_gbps", "paper_cpu_s", "paper_fpga2ch_s",
                 "paper_fpga32ch_s", "note", "status", "reason", "source")
ROOFLINE_TERMS = ("compute_ms", "memory_ms", "collective_ms", "dominant",
                  "useful_flops_ratio", "frac")

# the H100's constants in the reference's spec type (as test_torch_tune)
H100_AS_TPU = jmm.TPUSpec(
    name=H100.name, peak_flops_bf16=H100.peak_flops_bf16, hbm_bw=H100.hbm_bw,
    ici_bw=H100.nvlink_bw, hbm_bytes=H100.hbm_bytes,
    vmem_bytes=H100.smem_bytes, clock_hz=H100.clock_hz,
    dma_latency_s=H100.latency_s)


def _advice(text):
    """The reference's first knob move for a pattern, in the port's words."""
    for pattern, advice in J_ADVICE.items():
        if text == advice.knob_moves[0]:
            return ADVICE[Pattern(pattern.value)].knob_moves[0]
    return text


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    missing = tmp_path_factory.mktemp("dryrun") / "no_dryrun.json"
    with pytest.MonkeyPatch.context() as mp:
        # a runs/dryrun.json would switch the reference to its artifact path
        mp.setenv("DRYRUN_JSON", str(missing))
        jrun = j_run_sweeps(names=list(SWEEPS), fast=True, echo=False,
                            spec=H100_AS_TPU)
    trun = t_run_sweeps(names=list(SWEEPS), fast=True, echo=False,
                        device="cpu")
    return jrun, trun


def test_fourteen_sweeps_in_the_reference_order():
    assert T_ORDER == [n for n in J_ORDER if n in T_ORDER]
    # 15 since the preemption sweep (PR 24) joined the fourteen
    assert len(T_ORDER) == 15 and T_ORDER[-1] == "preempt_serve"
    assert T_ORDER.index("random") + 1 == T_ORDER.index("database")
    assert T_ORDER[T_ORDER.index("database"):][:4] == [
        "database", "conv", "roofline", "serve"]


def test_sweeps_run(both_runs):
    jrun, trun = both_runs
    assert not jrun.failures and not trun.failures, (jrun.failures,
                                                     trun.failures)
    assert [(r.sweep, r.name) for r in trun.results] == \
        [(r.sweep, r.name) for r in jrun.results]


@pytest.mark.parametrize("sweep", SWEEPS)
def test_rows_match_reference(both_runs, sweep):
    jrun, trun = both_runs
    jrows, trows = jrun.by_sweep(sweep), trun.by_sweep(sweep)
    assert jrows and [r.name for r in trows] == [r.name for r in jrows]
    assert [r.pattern for r in trows] == [r.pattern for r in jrows]
    assert [r.knobs for r in trows] == [r.knobs for r in jrows]
    for t, j in zip(trows, jrows):
        for key in PAPER_COLUMNS:
            assert t.extras.get(key) == j.extras.get(key), (t.name, key)
        assert t.extras.get("advice") == _advice(j.extras.get("advice")), \
            t.name
        if j.timing is not None:
            # the reference keeps no bytes column: its Eq. 5 gives them back
            want = j.gbps_measured * 1e9 * j.us_per_call * 1e-6
            assert math.isclose(t.extras["bytes_moved"], want,
                                rel_tol=1e-9), (t.name, want)
            assert t.gbps_measured > 0 and t.us_per_call > 0
        assert math.isclose(t.gbps_predicted, j.gbps_predicted,
                            rel_tol=1e-9), t.name


def test_roofline_terms_match_reference(both_runs):
    jrun, trun = both_runs
    rows = list(zip(trun.by_sweep("roofline"), jrun.by_sweep("roofline")))
    assert [t.name for t, _ in rows] == [
        "roofline_mamba2-130m_train_4k", "roofline_gemma-2b_train_4k"]
    for t, j in rows:
        assert j.extras["source"] == "analytic_fallback"
        for key in ROOFLINE_TERMS:
            assert t.extras[key] == j.extras[key], (t.name, key)
        assert math.isclose(t.us_per_call, j.us_per_call, rel_tol=1e-9)
        assert math.isclose(t.gbps_measured, j.gbps_measured, rel_tol=1e-9)


# ---------------------------------------------------------------------------
# what the rows compute
# ---------------------------------------------------------------------------

def _lax_conv(img, ker):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(img)[None, :, :, None], jnp.asarray(ker)[:, :, None, None],
        (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")))[0, :, :, 0]


@pytest.mark.parametrize("hw,k", [((96, 80), 11), ((64, 64), 3),
                                  ((75, 121), 11)])
def test_conv_matches_lax(hw, k):
    rng = np.random.default_rng(sum(hw) + k)
    img = rng.standard_normal(hw).astype(np.float32)
    ker = rng.standard_normal((k, k)).astype(np.float32)
    got = tconv.conv_valid(torch.from_numpy(img)[None, None],
                           torch.from_numpy(ker)[None, None])[0, 0].numpy()
    np.testing.assert_allclose(got, _lax_conv(img, ker), rtol=1e-5,
                               atol=1e-5)


def test_split_shards_match_reference():
    """The split row's eight padded shards convolve to the reference's."""
    H, W, K = 120, 40, 11
    rng = np.random.default_rng(5)
    img = rng.standard_normal((H, W)).astype(np.float32)
    ker = np.ones((K, K), np.float32) / (K * K)
    pads = tconv.split_shards(torch.from_numpy(img), K)
    jpads = [jnp.pad(s, ((0, K - 1), (0, 0)))
             for s in jnp.split(jnp.asarray(img), 8, axis=0)]
    assert len(pads) == 8
    for p, jp in zip(pads, jpads):
        np.testing.assert_array_equal(p[0, 0].numpy(), np.asarray(jp))
        got = tconv.conv_valid(p, torch.from_numpy(ker)[None, None])
        np.testing.assert_allclose(got[0, 0].numpy(),
                                   _lax_conv(np.asarray(jp), ker),
                                   rtol=1e-5, atol=1e-5)


def test_naive_conv_matches_lax():
    rng = np.random.default_rng(9)
    tile = rng.standard_normal((74, 74)).astype(np.float32)
    ker = np.ones((11, 11), np.float32) / 121
    np.testing.assert_allclose(tconv.naive_conv(tile, ker),
                               _lax_conv(tile, ker), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1 << 12, 1 << 19])
def test_r_acc_indices_match_reference(n):
    got = (lfsr_indices(n // 8, bits=24) % n).numpy()
    want = np.asarray(jops.lfsr_indices(n // 8, bits=24) % n)
    np.testing.assert_array_equal(got, want)


def test_nest_attention_matches_reference():
    b, s, h, hd = 1, 512, 4, 64
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            AttnParams(bq=256, bkv=256))
    want = j_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                     JAttnParams(bq=256, bkv=256))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
