"""The port's advisor stack held against the reference's on the CPU.

- the ten architecture configs and their smoke configs, field for field;
  their parameter accounting (``param_count``, ``flops_per_token``);
- the shape tables (``LM_SHAPES``, ``SHAPES_BY_NAME``) and
  ``shape_applicable`` over every (arch, shape) cell;
- ``advise_model`` over 10 archs x 4 shapes x engines {1, 4} x
  param_engines {None, 1}: site names, patterns, bytes and shapes exactly;
  ``detail`` and the report after the word map below; ``predicted_gbps``
  to 1e-9 relative (the tolerance of ``test_tune_pattern_matches_reference``);
- measured mode: each package fits the same synthetic samples, and the
  ratios, predictions and rendered reports agree;
- the reference's golden taxonomy tests (``tests/test_advisor_golden.py``),
  run on the port.

The reference runs under a ``TPUSpec`` that carries the H100's constants
(as ``tests/test_torch_tune.py``), the port under ``H100`` itself.  The
word map: the port's advice speaks of the card (shared memory where the
reference says VMEM, its own first knob move for each pattern).
"""
import dataclasses
import importlib

import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import LM_SHAPES as J_SHAPES
from repro.configs import SHAPES_BY_NAME as J_SHAPES_BY_NAME
from repro.configs import all_cells as j_all_cells
from repro.configs import shape_applicable as j_shape_applicable
from repro.configs import smoke_config as j_smoke
from repro.configs.base import asdict as j_asdict
from repro.core import memmodel as jmm
from repro.core.advisor import advise_model as j_advise
from repro.core.advisor import render_report as j_render
from repro.core.patterns import ADVICE as J_ADVICE
from repro.core.patterns import Pattern as JPattern
from repro_torch.configs import ARCHS, LM_SHAPES, SHAPES_BY_NAME, all_cells
from repro_torch.configs import get_arch, shape_applicable, smoke_config
from repro_torch.configs.base import ATTN, MOE, RGLRU, SSD, asdict
from repro_torch.core.advisor import advise_model, render_report
from repro_torch.core.memmodel import H100
from repro_torch.core.patterns import ADVICE, Pattern, SiteReport

# the modules (each package's ``calibrate`` name is the function)
jcal = importlib.import_module("repro.bench.calibrate")
tcal = importlib.import_module("repro_torch.bench.calibrate")

# the H100's constants in the reference's spec type (as test_torch_tune)
H100_AS_TPU = jmm.TPUSpec(
    name=H100.name, peak_flops_bf16=H100.peak_flops_bf16, hbm_bw=H100.hbm_bw,
    ici_bw=H100.nvlink_bw, hbm_bytes=H100.hbm_bytes,
    vmem_bytes=H100.smem_bytes, clock_hz=H100.clock_hz,
    dma_latency_s=H100.latency_s)

ARCH_NAMES = sorted(J_ARCHS)
SHAPE_NAMES = [s.name for s in J_SHAPES]


def word_map(text: str) -> str:
    """The reference's words for the TPU, in the port's words for the
    card."""
    text = text.replace("VMEM-resident", "resident in shared memory")
    for pattern, advice in J_ADVICE.items():
        text = text.replace(advice.knob_moves[0],
                            ADVICE[Pattern(pattern.value)].knob_moves[0])
    return text


def _rel(got, want, tol=1e-9):
    assert got == pytest.approx(want, rel=tol, abs=0.0)


# ---------------------------------------------------------------------------
# configs, accounting, shapes
# ---------------------------------------------------------------------------

def test_registry_holds_the_reference_archs_in_order():
    assert list(ARCHS) == list(J_ARCHS)
    assert len(ARCHS) == 10
    assert get_arch("gemma-2b") is ARCHS["gemma-2b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_matches_reference(arch):
    assert asdict(ARCHS[arch]) == j_asdict(J_ARCHS[arch])
    assert dataclasses.asdict(smoke_config(ARCHS[arch])) == \
        dataclasses.asdict(j_smoke(J_ARCHS[arch]))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_accounting_matches_reference(arch):
    for t, j in ((ARCHS[arch], J_ARCHS[arch]),
                 (smoke_config(ARCHS[arch]), j_smoke(J_ARCHS[arch]))):
        assert t.param_count() == j.param_count()
        assert t.flops_per_token() == j.flops_per_token()
        for spec, jspec in zip(t.layer_pattern, j.layer_pattern):
            assert t._mixer_params(spec) == j._mixer_params(jspec)
            assert t._mlp_params(spec) == j._mlp_params(jspec)


def test_shape_tables_match_reference():
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == \
        [dataclasses.asdict(s) for s in J_SHAPES]
    assert list(SHAPES_BY_NAME) == list(J_SHAPES_BY_NAME)
    for name, cell in SHAPES_BY_NAME.items():
        assert cell.tokens == J_SHAPES_BY_NAME[name].tokens


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shape_applicable_matches_reference(arch, shape):
    assert shape_applicable(ARCHS[arch], SHAPES_BY_NAME[shape]) == \
        j_shape_applicable(J_ARCHS[arch], J_SHAPES_BY_NAME[shape])


def test_all_cells_match_reference():
    got = [(c.name, s.name, ok, why) for c, s, ok, why in all_cells()]
    want = [(c.name, s.name, ok, why) for c, s, ok, why in j_all_cells()]
    assert got == want and len(got) == 40


# ---------------------------------------------------------------------------
# advise_model, analytic
# ---------------------------------------------------------------------------

def _same_reports(got, want):
    assert [r.op_name for r in got] == [r.op_name for r in want]
    for t, j in zip(got, want):
        assert isinstance(t, SiteReport)
        assert t.pattern.value == j.pattern.value, t.op_name
        assert t.bytes_moved == j.bytes_moved, t.op_name
        assert tuple(t.shape) == tuple(j.shape), t.op_name
        assert t.detail == word_map(j.detail), t.op_name
        assert t.advice is ADVICE[t.pattern]
        _rel(t.predicted_gbps, j.predicted_gbps)
        assert t.measured_vs_predicted == j.measured_vs_predicted


@pytest.mark.parametrize("param_engines", [None, 1])
@pytest.mark.parametrize("engines", [1, 4])
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_advise_model_matches_reference(arch, shape, engines, param_engines):
    got = advise_model(ARCHS[arch], SHAPES_BY_NAME[shape], engines=engines,
                       param_engines=param_engines)
    want = j_advise(J_ARCHS[arch], J_SHAPES_BY_NAME[shape], engines=engines,
                    param_engines=param_engines, spec=H100_AS_TPU)
    _same_reports(got, want)
    assert render_report(got).splitlines() == \
        [word_map(line) for line in j_render(want).splitlines()]


def test_default_spec_is_the_card():
    cell = SHAPES_BY_NAME["decode_32k"]
    assert [r.predicted_gbps for r in advise_model(ARCHS["gemma-2b"], cell)] \
        == [r.predicted_gbps for r in advise_model(ARCHS["gemma-2b"], cell,
                                                   spec=H100)]


# ---------------------------------------------------------------------------
# advise_model, measured mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrations():
    """Each package fits synthetic samples drawn from the same slow truth
    (its own sampler, its own fit)."""
    lat, bw = 900e-9, 1.2e12
    tc = tcal.fit_spec(tcal.synthetic_samples(
        dataclasses.replace(H100, latency_s=lat, hbm_bw=bw)))
    jc = jcal.fit_spec(jcal.synthetic_samples(
        dataclasses.replace(H100_AS_TPU, dma_latency_s=lat, hbm_bw=bw)),
        base=H100_AS_TPU)
    return tc, jc


def test_calibrations_agree(calibrations):
    tc, jc = calibrations
    _rel(tc.spec.latency_s, jc.spec.dma_latency_s, 1e-12)
    _rel(tc.spec.hbm_bw, jc.spec.hbm_bw, 1e-12)
    assert tc.ratios == pytest.approx(jc.ratios, rel=1e-12)
    for p in Pattern:
        got = tc.measured_vs_predicted(p)
        want = jc.measured_vs_predicted(JPattern(p.value))
        assert (got is None) == (want is None)
        if got is not None:
            _rel(got, want, 1e-12)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_advise_model_measured_mode_matches_reference(calibrations, arch,
                                                      shape):
    tc, jc = calibrations
    got = advise_model(ARCHS[arch], SHAPES_BY_NAME[shape], calibration=tc)
    want = j_advise(J_ARCHS[arch], J_SHAPES_BY_NAME[shape], spec=H100_AS_TPU,
                    calibration=jc)
    assert [r.op_name for r in got] == [r.op_name for r in want]
    for t, j in zip(got, want):
        assert t.measured_vs_predicted is not None
        _rel(t.measured_vs_predicted, j.measured_vs_predicted, 1e-12)
        _rel(t.predicted_gbps, j.predicted_gbps)
    lines = render_report(got).splitlines()
    assert "meas/pred" in lines[0]
    assert lines == [word_map(line) for line in j_render(want).splitlines()]


# ---------------------------------------------------------------------------
# the reference's golden taxonomy tests, on the port
# ---------------------------------------------------------------------------

def _patterns_by_site(reports):
    return {r.op_name: r.pattern for r in reports}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_taxonomy_train(arch):
    cfg = ARCHS[arch]
    reports = advise_model(cfg, SHAPES_BY_NAME["train_4k"])
    by_site = _patterns_by_site(reports)

    # universal sites
    assert by_site["embedding.lookup"] == Pattern.R_ACC
    assert by_site["params.stream"] == Pattern.RS_TRA

    # per-layer sites follow the mixer/mlp kinds in the config
    for site, pattern in by_site.items():
        if site.startswith("attn["):
            assert pattern == Pattern.NEST, site
        if site.startswith(("ssd[", "rglru[")):
            assert pattern == Pattern.SEQUENTIAL, site
        if site.startswith("moe[") and site.endswith(".route"):
            assert pattern == Pattern.R_ACC, site


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_sites_match_layer_pattern(arch):
    """Every mixer/mlp kind in the config produces its site, and no site
    appears without its kind — the golden structure, derived not hardcoded."""
    cfg = ARCHS[arch]
    reports = advise_model(cfg, SHAPES_BY_NAME["train_4k"])
    sites = [r.op_name for r in reports]
    kinds = {spec.mixer for spec in cfg.layer_pattern}
    mlps = {spec.mlp for spec in cfg.layer_pattern}

    assert (ATTN in kinds) == any(s.startswith("attn[") for s in sites)
    assert (SSD in kinds) == any(s.startswith("ssd[") for s in sites)
    assert (RGLRU in kinds) == any(s.startswith("rglru[") for s in sites)
    assert (MOE in mlps) == any(s.startswith("moe[") for s in sites)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_adds_cache_stream(arch):
    cfg = ARCHS[arch]
    reports = advise_model(cfg, SHAPES_BY_NAME["decode_32k"])
    by_site = _patterns_by_site(reports)
    assert by_site["kv_cache.decode_stream"] == Pattern.RS_TRA
    # the cache stream aggregates exactly the nest (attention) bytes
    nest_bytes = sum(r.bytes_moved for r in reports
                     if r.pattern == Pattern.NEST)
    cache = next(r for r in reports
                 if r.op_name == "kv_cache.decode_stream")
    assert cache.bytes_moved == nest_bytes


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_site_has_advice_and_prediction(arch):
    cfg = ARCHS[arch]
    reports = advise_model(cfg, SHAPES_BY_NAME["train_4k"])
    for r in reports:
        assert r.advice is not None and r.advice.pattern == r.pattern
        assert r.bytes_moved > 0
        assert r.predicted_gbps > 0  # spec-grounded model prediction
        assert r.measured_vs_predicted is None  # analytic mode
    assert render_report(reports).count("\n") == len(reports)
