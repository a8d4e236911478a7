"""The port's tune -> plan -> execute loop held against the reference's.

The reference's autotuner and plans run here under a ``TPUSpec`` that
carries the H100's constants (``vmem_bytes`` = the block's shared memory,
``dma_latency_s`` = the measured latency, ``ici_bw`` = one direction of
NVLink), the port's under ``H100`` itself: the same constants must give
the same knobs and plans, field for field, with ``predicted_gbps`` to
1e-9 relative — on a grid of shapes, both dtypes, every kernel of
``KERNELS``, analytic and calibrated.  The plans the port's H100 runs take
are pinned.  Then the reference's cache tests (``tests/test_tune.py``),
ported: persistence, a corrupt file, memory-only, invalidation, the
environment variable, reading a reference plan dict; the roofline terms;
and ``chunked`` attention with its blocks left to the plan.
"""
import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import memmodel as jmm
from repro.core.patterns import Pattern as JPattern
from repro.models import attention as j_attn
from repro.tune import plan as jplan
from repro_torch.core import autotune as tat
from repro_torch.core import memmodel as tmm
from repro_torch.core.memmodel import H100, smem_ok
from repro_torch.core.patterns import Pattern
from repro_torch.models import attention as t_attn
from repro_torch.tune import (KERNELS, KernelPlan, PlanCache, default_cache,
                              derive_plan, plan_for, plan_key,
                              set_default_cache, spec_fingerprint)

# the modules (each package's ``calibrate`` name is the function)
jcal = importlib.import_module("repro.bench.calibrate")
tcal = importlib.import_module("repro_torch.bench.calibrate")

# the H100's constants in the reference's spec type
H100_AS_TPU = jmm.TPUSpec(
    name=H100.name, peak_flops_bf16=H100.peak_flops_bf16, hbm_bw=H100.hbm_bw,
    ici_bw=H100.nvlink_bw, hbm_bytes=H100.hbm_bytes,
    vmem_bytes=H100.smem_bytes, clock_hz=H100.clock_hz,
    dma_latency_s=H100.latency_s)

SIGS = {
    "flash_attention": (512, 768, 64),
    "decode_attention": (4096, 128),
    "matmul": (512, 512, 256),
    "paged_attention": (4096, 128),
    "paged_verify": (5, 4096, 128),
}
# a grid of shape signatures per kernel: the reference test's, the port's
# main paths' (phi4-mini, gemma-2b), short and ragged lengths
GRID = {
    "flash_attention": [(512, 768, 64), (16, 24, 16), (512, 512, 128),
                        (1024, 1024, 256), (37, 53, 16), (4096, 4096, 64)],
    "decode_attention": [(4096, 128), (1024, 128), (1024, 256), (90, 16),
                         (100, 32), (7, 64), (256, 256)],
    "matmul": [(512, 512, 256), (4096, 4096, 4096), (8, 8192, 3072),
               (96, 64, 100), (3, 5, 7), (128, 256, 64)],
    "paged_attention": [(4096, 128), (1024, 256), (16, 16), (64, 8),
                        (4096, 16, 2)],
    "paged_verify": [(5, 4096, 128), (2, 1024, 256), (9, 64, 16)],
}
CASES = [(kernel, sig, dtype) for kernel in KERNELS for sig in GRID[kernel]
         for dtype in ("bfloat16", "float32")]


def _rel(got, want, tol=1e-9):
    assert got == pytest.approx(want, rel=tol, abs=0.0)


def _knobs(k):
    return (k.unit_bytes, k.burst_bytes, k.outstanding, k.stride, k.engines)


def _same_plan(got: KernelPlan, want):
    assert (got.kernel, got.bq, got.bkv, got.pipeline_depth, got.dtype,
            got.head_dim, got.source) == (
        want.kernel, want.bq, want.bkv, want.pipeline_depth, want.dtype,
        want.head_dim, want.source)
    _rel(got.predicted_gbps, want.predicted_gbps)
    assert got.smem_bytes() == want.vmem_bytes()
    assert _knobs(got.knobs()) == _knobs(want.knobs())


def _calibrations(lat=2000e-9, bw=64e9):
    """A fit of synthetic samples on the port's side, and the same fitted
    spec and ratios in the reference's types."""
    slow = dataclasses.replace(H100, latency_s=lat, hbm_bw=bw)
    tc = tcal.fit_spec(tcal.synthetic_samples(slow))
    jspec = dataclasses.replace(H100_AS_TPU, name=tc.spec.name,
                                hbm_bw=tc.spec.hbm_bw,
                                dma_latency_s=tc.spec.latency_s)
    jc = jcal.CalibrationResult(spec=jspec, base_spec=H100_AS_TPU,
                                rms_log_error=tc.rms_log_error,
                                n_samples=tc.n_samples, ratios=dict(tc.ratios))
    return tc, jc


# ---------------------------------------------------------------------------
# the autotuner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [0.4, 0.5, 0.05])
@pytest.mark.parametrize("pattern", list(Pattern), ids=lambda p: p.value)
def test_tune_pattern_matches_reference(pattern, fraction):
    got = tat.tune_pattern(pattern, spec=H100, smem_budget_fraction=fraction)
    want = jat.tune_pattern(JPattern(pattern.value), spec=H100_AS_TPU,
                            vmem_budget_fraction=fraction)
    assert _knobs(got.knobs) == _knobs(want.knobs)
    _rel(got.predicted_gbps, want.predicted_gbps)
    _rel(got.best_gbps, want.best_gbps)
    assert got.smem_bytes == want.vmem_bytes
    assert got.note == want.note
    assert got.measured_vs_predicted is None
    assert smem_ok(got.knobs, H100, fraction)


@pytest.mark.parametrize("pattern", [Pattern.RS_TRA, Pattern.R_ACC,
                                     Pattern.CHASE], ids=lambda p: p.value)
def test_tune_pattern_calibrated_matches_reference(pattern):
    tc, jc = _calibrations()
    got = tat.tune_pattern(pattern, calibration=tc,
                           smem_budget_fraction=0.4)
    want = jat.tune_pattern(JPattern(pattern.value), calibration=jc,
                            vmem_budget_fraction=0.4)
    assert _knobs(got.knobs) == _knobs(want.knobs)
    _rel(got.predicted_gbps, want.predicted_gbps)
    assert got.measured_vs_predicted == want.measured_vs_predicted


def test_tune_pattern_refuses_an_empty_budget():
    with pytest.raises(ValueError, match="no feasible knobs"):
        tat.tune_pattern(Pattern.SEQUENTIAL, smem_budget_fraction=1e-6)


@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
def test_tune_attention_blocks_matches_reference(head_dim, dtype_bytes):
    got = tat.tune_attention_blocks(head_dim, dtype_bytes=dtype_bytes,
                                    spec=H100)
    want = jat.tune_attention_blocks(head_dim, dtype_bytes=dtype_bytes,
                                     spec=H100_AS_TPU)
    assert got == want
    # a budget that holds more: the reference's V5E VMEM in the port's type
    big = dataclasses.replace(H100, smem_bytes=jmm.V5E.vmem_bytes)
    assert tat.tune_attention_blocks(
        head_dim, dtype_bytes=dtype_bytes, spec=big) == \
        jat.tune_attention_blocks(head_dim, dtype_bytes=dtype_bytes,
                                  spec=dataclasses.replace(
                                      H100_AS_TPU,
                                      vmem_bytes=jmm.V5E.vmem_bytes))


@pytest.mark.parametrize("head_dim,dstate", [(64, 128), (64, 16), (32, 64),
                                             (128, 256), (8, 8)])
def test_tune_ssd_chunk_matches_reference(head_dim, dstate):
    assert tat.tune_ssd_chunk(1024, 16, head_dim, dstate) == \
        jat.tune_ssd_chunk(1024, 16, head_dim, dstate)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,sig,dtype", CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}-{d}"
                              for k, s, d in CASES])
def test_derive_plan_matches_reference(kernel, sig, dtype):
    got = derive_plan(kernel, shape_sig=sig, dtype=dtype)
    want = jplan.derive_plan(kernel, shape_sig=sig, dtype=dtype,
                             spec=H100_AS_TPU)
    _same_plan(got, want)
    # the budget rule holds exactly where it holds for the reference (its
    # floors, a tile of 8 rows or of 128, may stay over the budget)
    assert smem_ok(got.knobs(), H100) == jmm.vmem_ok(want.knobs(),
                                                     H100_AS_TPU)


@pytest.mark.parametrize("kernel", KERNELS)
def test_derive_plan_calibrated_matches_reference(kernel):
    tc, jc = _calibrations()
    got = derive_plan(kernel, shape_sig=SIGS[kernel], dtype="bfloat16",
                      calibration=tc)
    want = jplan.derive_plan(kernel, shape_sig=SIGS[kernel],
                             dtype="bfloat16", calibration=jc)
    assert got.source == "calibrated"
    _same_plan(got, want)
    # the same constants fingerprint alike on both packages
    assert spec_fingerprint(tc.spec) == jplan.spec_fingerprint(jc.spec)


@pytest.mark.parametrize("kernel", KERNELS)
def test_derive_plan_every_kernel(kernel):
    plan = derive_plan(kernel, shape_sig=SIGS[kernel], dtype="bfloat16")
    assert plan.kernel == kernel
    assert plan.bq >= 1 and plan.bkv >= 1 and plan.pipeline_depth >= 1
    assert plan.predicted_gbps > 0
    assert plan.source == "analytic"
    assert smem_ok(plan.knobs(), H100)


def test_plans_the_h100_path_runs():
    """The tiles the card runs: K3 at phi4-mini's and gemma-2b's decode
    geometry, K8 at the two timed shapes and the reference test's."""
    for d in (128, 256):
        plan = derive_plan("decode_attention", shape_sig=(1024, d),
                           dtype="bfloat16")
        assert (plan.bkv, plan.pipeline_depth) == (8, 16)
        # one block's Little's law: 64 KiB in flight over 386 ns
        assert 160 < plan.predicted_gbps < 260
    assert derive_plan("matmul", shape_sig=(4096, 4096, 4096),
                       dtype="bfloat16").bq == 128
    assert derive_plan("matmul", shape_sig=(8, 8192, 3072),
                       dtype="bfloat16").bq == 8
    assert derive_plan("matmul", shape_sig=(96, 64, 100),
                       dtype="float32").bq == 64


@pytest.mark.parametrize("max_len,head_dim,dtype,page", [
    (1024, 256, "bfloat16", 8), (1024, 128, "bfloat16", 8),
    (4096, 16, "float32", 8), (4096, 16, "int8", 32), (16, 16, "float32", 8)])
def test_paged_plan_keeps_its_pages(max_len, head_dim, dtype, page):
    plan = derive_plan("paged_attention", shape_sig=(max_len, head_dim),
                       dtype=dtype)
    assert plan.page_size == plan.bkv == page


def test_unknown_kernel_rejected():
    with pytest.raises(ValueError, match="unknown kernel"):
        derive_plan("warp_attention", shape_sig=(4096, 128), dtype="bfloat16")


def test_plan_round_trips_through_json():
    plan = derive_plan("flash_attention", shape_sig=SIGS["flash_attention"],
                       dtype="bfloat16")
    assert KernelPlan.from_dict(json.loads(json.dumps(plan.to_dict()))) == plan


@pytest.mark.parametrize("kernel", KERNELS)
def test_from_dict_reads_a_reference_plan(kernel):
    """A reference plan's dict (with its ``interpret``) reads as the port's
    plan of the same fields."""
    want = jplan.derive_plan(kernel, shape_sig=SIGS[kernel], dtype="bfloat16",
                             spec=H100_AS_TPU)
    raw = json.loads(json.dumps(want.to_dict()))
    assert "interpret" in raw
    got = KernelPlan.from_dict(raw)
    _same_plan(got, want)
    assert got == derive_plan(kernel, shape_sig=SIGS[kernel],
                              dtype="bfloat16")


def test_dtype_names_read_as_the_references():
    from repro_torch.tune.plan import dtype_name
    assert dtype_name(torch.bfloat16) == "bfloat16" == str(jnp.bfloat16.dtype)
    assert dtype_name(torch.float32) == "float32"
    assert getattr(torch, dtype_name(torch.int8)) is torch.int8


# ---------------------------------------------------------------------------
# the cache (tests/test_tune.py, ported)
# ---------------------------------------------------------------------------

def test_plan_cache_persistence_round_trip(tmp_path):
    path = str(tmp_path / "tuneplans_torch.json")
    cache = PlanCache(path)
    plan = cache.get_or_derive("flash_attention",
                               shape_sig=SIGS["flash_attention"],
                               dtype="bfloat16")
    assert len(cache) == 1
    reloaded = PlanCache(path)
    key = plan_key("flash_attention", SIGS["flash_attention"], "bfloat16",
                   H100)
    assert reloaded.get(key) == plan
    assert reloaded.get_or_derive(
        "flash_attention", shape_sig=SIGS["flash_attention"],
        dtype="bfloat16") == plan
    assert len(reloaded) == 1
    reloaded.clear()
    assert len(PlanCache(path)) == 0


def test_plan_cache_memory_only_and_corrupt_file(tmp_path):
    mem = PlanCache(None)
    mem.get_or_derive("matmul", shape_sig=SIGS["matmul"], dtype="float32")
    assert len(mem) == 1
    bad = tmp_path / "tuneplans_torch.json"
    bad.write_text("{not json")
    assert len(PlanCache(str(bad))) == 0
    bad.write_text("[1, 2]")
    assert len(PlanCache(str(bad))) == 0


def test_default_path_outside_a_checkout_writes_nothing(tmp_path,
                                                        monkeypatch):
    """The default path is relative: without a runs/ directory in the
    working directory the cache stays in memory."""
    monkeypatch.chdir(tmp_path)
    cache = PlanCache()
    cache.get_or_derive("matmul", shape_sig=(64, 64, 64), dtype="float32")
    assert len(cache) == 1
    assert list(tmp_path.iterdir()) == []
    (tmp_path / "runs").mkdir()
    PlanCache().get_or_derive("matmul", shape_sig=(64, 64, 64),
                              dtype="float32")
    assert [p.name for p in (tmp_path / "runs").iterdir()] == [
        "tuneplans_torch.json"]


def test_key_invalidates_on_spec_and_calibration_change():
    base_key = plan_key("flash_attention", (512, 512, 128), "bfloat16", H100)
    other = dataclasses.replace(H100, hbm_bw=H100.hbm_bw * 2)
    assert spec_fingerprint(other) != spec_fingerprint(H100)
    assert plan_key("flash_attention", (512, 512, 128), "bfloat16",
                    other) != base_key
    assert plan_key("flash_attention", (512, 512, 128), "float32",
                    H100) != base_key
    assert plan_key("flash_attention", (512, 256, 128), "bfloat16",
                    H100) != base_key
    # the fields the fingerprint hashes, and only those
    for field, value in (("latency_s", 1e-6), ("smem_bytes", 1 << 16),
                         ("clock_hz", 1e9), ("name", "other")):
        assert spec_fingerprint(dataclasses.replace(H100, **{field: value})) \
            != spec_fingerprint(H100)
    assert spec_fingerprint(dataclasses.replace(H100, nvlink_bw=1.0)) == \
        spec_fingerprint(H100)
    # the H100's constants fingerprint alike in the reference's type
    assert spec_fingerprint(H100) == jplan.spec_fingerprint(H100_AS_TPU)


def test_calibration_threads_into_plans():
    tc, _ = _calibrations()
    cache = PlanCache(None)
    plan = cache.get_or_derive("decode_attention",
                               shape_sig=SIGS["decode_attention"],
                               dtype="bfloat16", calibration=tc)
    assert plan.source == "calibrated"
    assert smem_ok(plan.knobs(), tc.spec)
    assert cache.get(plan_key("decode_attention", SIGS["decode_attention"],
                              "bfloat16", H100)) is None
    assert cache.get(plan_key("decode_attention", SIGS["decode_attention"],
                              "bfloat16", tc.spec)) == plan


def test_default_cache_swap_and_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNEPLANS", str(tmp_path / "plans.json"))
    set_default_cache(None)
    try:
        cache = default_cache()
        assert cache.path == str(tmp_path / "plans.json")
        plan = plan_for("matmul", shape_sig=(256, 256, 256), dtype="float32")
        assert (tmp_path / "plans.json").exists()
        assert plan.kernel == "matmul"
        raw = json.loads((tmp_path / "plans.json").read_text())
        assert list(raw["plans"]) == [plan_key("matmul", (256, 256, 256),
                                               "float32", H100)]
    finally:
        set_default_cache(None)


def test_verify_plans_are_cached_under_their_signature():
    set_default_cache(PlanCache(None))
    try:
        cached = plan_for("paged_verify", shape_sig=(5, 4096, 128),
                          dtype="bfloat16")
        assert cached is plan_for("paged_verify", shape_sig=(5, 4096, 128),
                                  dtype="bfloat16")
        base = plan_for("paged_attention", shape_sig=(4096, 128),
                        dtype="bfloat16")
        assert (cached.bq, cached.bkv) == (5, base.page_size)
        _rel(cached.predicted_gbps, 5 * base.predicted_gbps)
    finally:
        set_default_cache(None)


def test_cache_file_is_the_ports_own():
    from repro.tune import cache as jcache
    from repro_torch.tune import cache as tcache
    assert tcache.DEFAULT_PATH != jcache.DEFAULT_PATH
    assert tcache.ENV_VAR != jcache.ENV_VAR


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (137.4e9, 100.7e6, 0.0, 1), (1.0e8, 33.6e6, 0.0, 1),
    (1e12, 1e9, 4e9, 4), (0.0, 5e6, 0.0, 1)])
def test_roofline_matches_reference(flops, nbytes, coll, chips):
    got = tmm.roofline(flops, nbytes, coll, chips, model_flops=flops / 2,
                       per_chip=chips == 1)
    want = jmm.roofline(flops, nbytes, coll, chips, model_flops=flops / 2,
                        spec=H100_AS_TPU, per_chip=chips == 1)
    for f in ("compute_s", "memory_s", "collective_s", "bound_s",
              "bound_s_no_overlap", "roofline_fraction",
              "roofline_fraction_no_overlap", "useful_flops_ratio"):
        _rel(getattr(got, f), getattr(want, f), 1e-12)
    assert got.dominant == want.dominant


def test_roofline_bounds_of_the_timed_shapes():
    """K8 at 4096^3 bf16 is bound by operations (0.139 ms); K3 at phi4-mini's
    batch-8 decode by bytes (about 0.010 ms)."""
    n = 4096
    t = tmm.roofline(2 * n ** 3, 3 * n * n * 2, 0, 1)
    assert t.dominant == "compute"
    assert t.bound_s * 1e3 == pytest.approx(0.139, abs=5e-4)
    kv = 2 * 8 * 1024 * 8 * 128 * 2
    t = tmm.roofline(4 * 8 * 24 * 1024 * 128, kv + 2 * 8 * 24 * 128 * 2, 0, 1)
    assert t.dominant == "memory"
    assert t.bound_s * 1e3 == pytest.approx(0.010, abs=5e-4)
    assert H100.nvlink_bw == 450e9


# ---------------------------------------------------------------------------
# chunked attention with its blocks left to the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,kw", [
    (40, 40, dict()), (37, 37, dict(window=9)), (24, 48, dict(causal=False)),
    (130, 130, dict(softcap=5.0))])
def test_chunked_attention_with_plan_blocks_matches_reference(sq, skv, kw):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    from repro.tune import PlanCache as JCache
    from repro.tune import set_default_cache as j_set
    tcache = PlanCache(None)
    set_default_cache(tcache)
    j_set(JCache(None))
    try:
        want = j_attn.chunked_attention(
            *(jnp.asarray(a) for a in (q, k, v)),
            j_attn.AttnParams(impl="chunked", **kw))
        p = t_attn.AttnParams(impl="chunked", **kw)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = t_attn.chunked_attention(tq, tk, tv, p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        plan = derive_plan("flash_attention", shape_sig=(sq, skv, 16),
                           dtype="float32")
        assert t_attn.resolve_blocks(p, tq, tk) == (plan.bq, plan.bkv)
        assert list(tcache.plans()) == [plan_key(
            "flash_attention", (sq, skv, 16), "float32", H100)]
        # explicit blocks win, one at a time too
        assert t_attn.resolve_blocks(p._replace(bq=8, bkv=16), tq, tk) == \
            (8, 16)
        assert t_attn.resolve_blocks(p._replace(bkv=16), tq, tk) == \
            (plan.bq, 16)
    finally:
        set_default_cache(None)
        j_set(None)
