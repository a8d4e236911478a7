"""Disaggregated prefill/decode pools in the port, held against the
reference on the CPU.

Both packages serve the same bridged weights (smoke gemma-2b, float32,
``jax.random.PRNGKey(7)``) through pools of the same geometry (one
prefill engine, one or two decode engines); every drain runs on both,
and the tokens, the final keys, EVERY ``ServeStats`` field of every
engine, every ``DisaggStats`` field and the virtual-round percentiles
must be equal, and the tokens equal a colocated engine's.

- the reference's pool cases (``tests/test_serve_disagg.py``): greedy,
  sampled and int8 drains equal to colocated ones, two decode replicas,
  forced colocation, percentiles, the pool's validation, routing by the
  link's bandwidth (and, with ``force=None``, by the cost model, whose
  spec both pools are given: the port's default is the H100's), the
  transfer ledger against the page geometry, every or some transfers
  corrupted in transit, ``build_disagg_pool``; the engine cases of that
  file (export and import refusals, ``evacuate`` of a swap record whose
  tier is gone, ``adopt`` of a finished request) run in
  ``tests/test_torch_preempt.py``; the TP=2 case runs in
  ``tests/test_torch_tp_serve.py``;
- the launcher's ``--topology disagg`` against the reference launcher's
  summary, and its refusals (no card without ``--device``, ``--tp`` > 1
  or a colocated ``--dp`` > 1 on one distinct device);
- the ``disagg_serve`` sweep at ``fast``: the reference's rows and
  deterministic columns, save the break-even row's ``reprefill_ms``,
  priced on the H100's spec; over ``["cpu", "cpu"]`` the reference's
  tenth row, ``disagg_serve_tp2_bitwise``, its transfers and tokens
  those of the reference's pool on the same weights.
"""
import dataclasses
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serve as J
from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.core.memmodel import V5E
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.serve.engine import ServeStats as JStats
import repro_torch.serve as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.memmodel import H100, HopperSpec
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.tune.plan import next_pow2

FIELDS = [f.name for f in dataclasses.fields(JStats)]
KW = dict(batch_size=2, max_len=64, window=4, prefill_chunk=8,
          cache_backend="paged", seed=0)
SAMPLED = dict(temperature=0.9, top_k=11)
PORT_SPEC = HopperSpec(hbm_bw=V5E.hbm_bw)     # V5E's rate in the port's type

PKG = {"ref": types.SimpleNamespace(S=J, spec=V5E),
       "port": types.SimpleNamespace(S=T, spec=PORT_SPEC)}

_STATE = {}


def _models(kv="native"):
    """(reference bundle, params, port bundle, params), weights bridged
    from ``jax.random.PRNGKey(7)``."""
    key = ("models", kv)
    if key not in _STATE:
        jcfg = j_smoke(J_ARCHS["gemma-2b"])
        jb = j_build(jcfg, JFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16, moe_impl="dense",
                                  loss_chunk=16, kv_dtype=kv))
        jparams = jb.init(jax.random.PRNGKey(7))
        tcfg = t_smoke(T_ARCHS["gemma-2b"])
        tb = t_build(tcfg, TFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16, kv_dtype=kv), device="cpu")
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _STATE[key] = (jcfg, jb, jparams, tb, tparams)
    return _STATE[key]


def _engine(side, kv="native", **kw):
    _, jb, jparams, tb, tparams = _models(kv)
    kw = {**KW, **kw}
    sp = kw.pop("sampling", None)
    if side == "ref":
        return J.ServeEngine(jb, jparams,
                             sampling=J.SamplingParams(**(sp or {})), **kw)
    return T.ServeEngine(tb, tparams, sampling=T.SamplingParams(**(sp or {})),
                         device="cpu", **kw)


def _pools(key, kv="native", n_decode=1, config=None, **kw):
    """The (reference, port) pools of one prefill and ``n_decode`` decode
    engines, cached per key and reset.  ``config`` is DisaggConfig's
    keyword arguments (default: every request shipped)."""
    if key not in _STATE:
        pools = {}
        for side, P in PKG.items():
            pools[side] = P.S.DisaggPool(
                [_engine(side, kv, **kw)],
                [_engine(side, kv, **kw) for _ in range(n_decode)],
                P.S.DisaggConfig(**(config or dict(force="disagg"))))
        _STATE[key] = pools
    pools = _STATE[key]
    for p in pools.values():
        p.reset()
    return pools


def _mk_reqs(R, n=4, max_new=8, seed=13):
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=rng.integers(1, 256, size=int(rng.integers(
        12, 28))).astype(np.int32), max_new_tokens=max_new)
        for i in range(n)]


def _colocated(kv="native", **kw):
    """A colocated port engine's tokens for the standard mix, cached."""
    key = ("colocated", kv, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _STATE:
        eng = _engine("port", kv, **kw)
        reqs = _mk_reqs(T.Request)
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion()
        _STATE[key] = {r.rid: list(r.out_tokens) for r in reqs}
    return _STATE[key]


def _check_pools(jp, tp):
    assert dataclasses.asdict(tp.dstats) == dataclasses.asdict(jp.dstats)
    assert tp.percentiles() == jp.percentiles()
    assert len(tp.engines) == len(jp.engines)
    for je, te in zip(jp.engines, tp.engines):
        for f in FIELDS:
            assert getattr(te.stats, f) == getattr(je.stats, f), f
        np.testing.assert_array_equal(te.keys.numpy(),
                                      np.asarray(je.keys).astype(np.int64))
    assert not tp._transit and not tp._live


def _both(key, chaos=None, reqs=None, **pool_kw):
    """The standard mix drained through the reference's pool and the
    port's (``chaos``: DisaggChaosConfig's keyword arguments): tokens,
    chaos counters and every counter equal.  Returns the port's tokens
    and the (reference, port) pools."""
    pools = _pools(key, **pool_kw)
    out = {}
    for side, P in PKG.items():
        pool = pools[side]
        rs = (reqs or _mk_reqs)(P.S.Request)
        for r in rs:
            pool.submit(r)
        ch = (None if chaos is None
              else P.S.DisaggChaos(P.S.DisaggChaosConfig(**chaos)))
        pool.run(chaos=ch)
        out[side] = ({r.rid: list(r.out_tokens) for r in rs},
                     None if ch is None else ch.corruptions)
    assert out["port"] == out["ref"]
    _check_pools(pools["ref"], pools["port"])
    return out["port"][0], pools["ref"], pools["port"]


# ---------------------------------------------------------------------------
# pool drains: disaggregated == colocated, and == the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv,kw", [("native", {}),
                                   ("native", dict(sampling=SAMPLED)),
                                   ("int8", {})],
                         ids=["greedy", "sampled", "int8"])
def test_disagg_drain_equals_colocated(kv, kw):
    got, _, tp = _both(f"pool-{kv}-{bool(kw)}", kv=kv, **kw)
    assert got == _colocated(kv, **kw)
    s = tp.stats()
    assert s.prefill_exports == s.prefill_imports == len(got)
    assert s.transfer_bytes > 0 and s.transfer_fallbacks == 0
    # the prefill pool never decoded; the decode pool never exported
    assert tp.prefill_engines[0].stats.tokens_out == len(got)
    assert tp.decode_engines[0].stats.prefill_exports == 0
    d = tp.dstats
    assert d.transfers == len(got) and d.completed == d.submitted
    if kv == "int8":
        assert tp.decode_engines[0].cache["blocks"]["p0"]["k_scale"].dtype \
            == torch.float32


def test_disagg_two_decode_replicas():
    got, _, tp = _both("pool2", n_decode=2)
    assert got == _colocated()
    loads = [e.stats.prefill_imports for e in tp.decode_engines]
    assert sum(loads) == len(got) and all(n > 0 for n in loads)


def test_force_colocated_never_ships():
    got, _, tp = _both("pool-colo", config=dict(force="colocated"))
    assert got == _colocated()
    s = tp.stats()
    assert s.prefill_exports == 0 and s.transfer_bytes == 0
    assert tp.dstats.colocated_routed == len(got)
    assert tp.prefill_engines[0].stats.tokens_out == 0


@pytest.mark.parametrize("transit", [0, 3])
def test_transit_rounds_equal_reference(transit):
    got, _, tp = _both(f"pool-transit-{transit}",
                       config=dict(force="disagg", transit_rounds=transit))
    assert got == _colocated()


def test_percentiles_deterministic_and_positive():
    _, _, tp = _both("pool-native-False")
    a = tp.percentiles()
    _both("pool-native-False")
    assert tp.percentiles() == a
    assert all(v > 0 for v in a.values())
    assert tp.dstats.rounds > 0


# ---------------------------------------------------------------------------
# hand-off mechanics
# ---------------------------------------------------------------------------

def test_pool_construction_validation():
    eng = _engine("port")
    with pytest.raises(ValueError, match=">= 1 prefill"):
        T.DisaggPool([], [eng])
    with pytest.raises(ValueError, match="unknown force"):
        T.DisaggPool([eng], [eng], T.DisaggConfig(force="sideways"))
    with pytest.raises(ValueError, match="share the sampling seed"):
        T.DisaggPool([eng], [_engine("port", seed=1)])
    with pytest.raises(ValueError, match="share max_len"):
        T.DisaggPool([eng], [_engine("port", max_len=32)])
    with pytest.raises(ValueError, match="share the page size"):
        T.DisaggPool([eng], [_engine("port", page_size=16)])
    with pytest.raises(ValueError, match="requires paged engines"):
        T.DisaggPool([eng], [_engine("port", cache_backend="dense")])
    noswap = _engine("port", scheduler=T.Scheduler(
        T.SchedulerConfig(swap=False)))
    with pytest.raises(ValueError, match="host swap tier"):
        T.DisaggPool([noswap], [eng])


def test_cost_model_matches_reference_geometry():
    """The pool prices a shipment from the decode engine's geometry: its
    weight bytes (the port walks its own parameter tree), KV bytes a
    token and chunk equal the reference pool's; the link is the config's,
    never the card's host link; the spec is the H100's."""
    pools = _pools("pool-native-False")
    jc, tc = pools["ref"].cost_model, pools["port"].cost_model
    assert (tc.weight_bytes, tc.kv_bytes_per_token, tc.prefill_chunk,
            tc.host_link_bw) == (jc.weight_bytes, jc.kv_bytes_per_token,
                                 jc.prefill_chunk, jc.host_link_bw)
    assert tc.host_link_bw == 32e9 and tc.spec is H100


def test_route_follows_link_bandwidth():
    # auto routing (force=None) is the cost model's break-even: a glacial
    # link prices the shipment above a decode-side prefill
    fast = T.DisaggPool([_engine("port")], [_engine("port")],
                        T.DisaggConfig(link_bw=1e15, force=None))
    slow = T.DisaggPool([_engine("port")], [_engine("port")],
                        T.DisaggConfig(link_bw=1.0, force=None))
    req = _mk_reqs(T.Request, n=1)[0]
    assert fast.route(req) == "disagg"
    assert slow.route(req) == "colocated"
    assert fast.cost_model.host_link_bw == 1e15  # adopted verbatim
    slow.submit(req)
    assert slow.dstats.colocated_routed == 1 and slow.dstats.disagg_routed == 0


def test_auto_routes_equal_reference():
    """``force=None`` over prompts of 4 to 50 tokens, with the link at the
    break-even of a 17-token prompt (3 chunks of 8), both pools priced on
    V5E's rate: prompts under it ship, longer ones (their chunks fall
    behind their bytes) colocate, the same ones in both, and the drains
    agree."""
    pools = _pools("pool-auto", config=dict(force=None))
    jc = pools["ref"].cost_model
    mid = 17
    link = (2 * mid * jc.kv_bytes_per_token * jc.spec.hbm_bw
            / (jc.weight_bytes * -(-mid // jc.prefill_chunk)
               + mid * jc.kv_bytes_per_token))
    for side, P in PKG.items():
        pools[side].cost_model = P.S.SwapCostModel(
            weight_bytes=jc.weight_bytes,
            kv_bytes_per_token=jc.kv_bytes_per_token,
            prefill_chunk=jc.prefill_chunk, spec=P.spec, host_link_bw=link)

    def reqs(R):
        rng = np.random.default_rng(5)
        return [R(rid=i, prompt=rng.integers(1, 256, size=n).astype(
            np.int32), max_new_tokens=6)
            for i, n in enumerate((4, 9, 10, 23, 25, 40, 50, 12))]
    routes = {side: [pools[side].route(r) for r in reqs(P.S.Request)]
              for side, P in PKG.items()}
    assert routes["port"] == routes["ref"]
    assert set(routes["port"]) == {"disagg", "colocated"}
    _, _, tp = _both("pool-auto", reqs=reqs, config=dict(force=None))
    assert tp.dstats.disagg_routed == routes["port"].count("disagg")


def test_transfer_byte_ledger_matches_geometry():
    _, _, tp = _both("pool-native-False")
    eng = tp.decode_engines[0]
    predicted = 2 * sum(
        next_pow2(max(1, -(-len(r.prompt) // eng.page))) * eng.bytes_per_page
        for r in _mk_reqs(T.Request))
    assert tp.stats().transfer_bytes == predicted


# ---------------------------------------------------------------------------
# failure paths
# ---------------------------------------------------------------------------

def test_transfer_corruption_recovers_by_recompute():
    got, _, tp = _both("pool-native-False", chaos=dict(seed=5,
                                                        corrupt_prob=1.0))
    assert got == _colocated()            # float32: recompute is the stream
    s = tp.stats()
    assert s.transfer_fallbacks == len(got) and s.recompute_resumes >= 1
    assert s.prefill_imports == 0         # no corrupted buffer landed


@pytest.mark.parametrize("seed", [9, 21])
def test_transfer_corruption_partial_seeded(seed):
    got, _, tp = _both("pool-native-False", chaos=dict(seed=seed,
                                                        corrupt_prob=0.5))
    assert got == _colocated()
    s = tp.stats()
    assert s.prefill_imports + s.transfer_fallbacks == len(got)


# ---------------------------------------------------------------------------
# the launch path
# ---------------------------------------------------------------------------

def test_build_disagg_pool_smoke():
    from repro_torch.launch.serve import build_disagg_pool

    _, _, _, tb, tparams = _models()
    pool = build_disagg_pool(tb, tparams, prefill_replicas=1,
                             decode_replicas=2,
                             disagg_config=T.DisaggConfig(force="disagg"),
                             device="cpu", **KW)
    assert isinstance(pool, T.DisaggPool) and len(pool.engines) == 3
    assert all(e.params is tparams for e in pool.engines)
    reqs = _mk_reqs(T.Request)
    for r in reqs:
        pool.submit(r)
    pool.run()
    assert {r.rid: list(r.out_tokens) for r in reqs} == _colocated()
    with pytest.raises(ValueError, match=">= 1 prefill"):
        build_disagg_pool(tb, tparams, prefill_replicas=0, device="cpu",
                          **KW)


ARGS = ["--arch", "gemma-2b", "--smoke", "--topology", "disagg", "--dp", "2",
        "--requests", "6", "--batch", "2", "--max-new", "4", "--max-len",
        "64", "--route", "disagg"]


def _summary(text):
    """The launcher's two disagg lines without the wall clock."""
    lines = [ln for ln in text.splitlines()
             if "replica(s)" in ln or ln.startswith("disagg:")]
    return [re.sub(r"^\d+ tokens in [\d.]+s \([\d.]+ tok/s\)", "", ln)
            for ln in lines]


def test_launcher_disagg_equals_reference(capsys):
    from repro.launch.serve import main as j_main
    from repro_torch.launch.serve import main as t_main

    assert j_main(ARGS) == 0
    want = _summary(capsys.readouterr().out)
    assert t_main(ARGS + ["--device", "cpu"]) == 0
    got = _summary(capsys.readouterr().out)
    assert len(got) == 2 and got == want
    assert got[1].startswith("disagg: 6 shipped / 0 colocated, 6 transfers")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_launcher_refusals():
    from repro_torch.launch.serve import main as t_main

    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_main(ARGS)                      # no --device: the card's path
    # one distinct device: the reference's messages for a TP=2 engine
    # group and for two colocated replicas
    with pytest.raises(SystemExit, match="tp=2 needs 2 devices, have 1"):
        t_main(ARGS + ["--device", "cpu", "--tp", "2"])
    with pytest.raises(SystemExit,
                       match="tp=1 x dp=2 needs 2 devices, have 1"):
        t_main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--dp",
                "2"])


# ---------------------------------------------------------------------------
# the disagg_serve sweep at fast
# ---------------------------------------------------------------------------

WALL_EXTRAS = ("tok_s", "mean_us")
# priced on the context's spec: the H100's in the port
SPEC_PRICED = {"disagg_serve_routing_break_even": ("reprefill_ms",)}


@pytest.fixture(scope="module")
def j_disagg_run():
    """The reference's sweep at fast on tier-1's one jax device (9 rows:
    its TP=2 row needs two)."""
    from repro.bench import run_sweeps as j_run_sweeps

    jrun = j_run_sweeps(names=["disagg_serve"], fast=True, echo=False)
    assert not jrun.failures, jrun.failures
    assert len(jax.devices()) == 1
    return jrun


def _rows_equal(jrows, trows):
    """Names, sweeps, patterns, knobs and deterministic columns equal;
    wall-clock rows timed twice."""
    assert [r.name for r in trows] == [r.name for r in jrows]
    for j, t in zip(jrows, trows):
        skip = WALL_EXTRAS + SPEC_PRICED.get(t.name, ())
        assert (t.sweep, t.pattern, t.knobs) == (j.sweep, j.pattern, j.knobs)
        assert ({k: v for k, v in t.extras.items() if k not in skip}
                == {k: v for k, v in j.extras.items() if k not in skip}), \
            t.name
        if j.extras.get("deterministic"):
            assert t.timing is None and j.timing is None
            assert (t.gbps_measured, t.gbps_predicted) == (
                j.gbps_measured, j.gbps_predicted), t.name
        else:
            assert t.timing.trials == j.timing.trials == 2
            assert t.us_per_call > 0


def test_disagg_serve_rows_equal_reference(j_disagg_run):
    from repro_torch.bench import run_sweeps as t_run_sweeps

    trun = t_run_sweeps(names=["disagg_serve"], fast=True, echo=False,
                        device="cpu")
    assert not trun.failures, trun.failures
    assert len(trun.results) == 9
    _rows_equal(j_disagg_run.results, trun.results)
    row = trun.by_name()["disagg_serve_routing_break_even"]
    cm = T.SwapCostModel(weight_bytes=5e9, kv_bytes_per_token=18_432,
                         prefill_chunk=256, host_link_bw=32e9)
    assert row.extras["reprefill_ms"] == cm.recompute_s(8192) * 1e3
    assert row.extras["ship_ms"] == cm.swap_s(8192) * 1e3
    assert row.extras["reprefill_ms"] > row.extras["ship_ms"]


def _reference_row_order():
    """The reference sweep's row names in the order its source emits
    them (the three percentile rows of its loop in place)."""
    src = (Path(__file__).resolve().parents[1]
           / "src/repro/bench/sweeps/disagg_serve.py").read_text()
    names = re.findall(r'"(disagg_serve_\w+)"', src)
    assert 'f"disagg_serve_{mname}"' in src
    i = names.index("disagg_serve_chaos_recovery")
    return (names[:i] + [f"disagg_serve_{m}" for m in
                         ("ttft_p50", "ttft_p99", "tpot_p50")] + names[i:])


def test_disagg_serve_tp2_row_over_two_devices(j_disagg_run, monkeypatch):
    """Over ``["cpu", "cpu"]`` the sweep adds the reference's last row:
    a TP=2 prefill engine shipping to a TP=2 decode engine drains the
    TP=2 colocated engine's tokens.  Its transfers and tokens equal the
    reference pool's on the port's weights (at TP=1: tier-1's jax has
    one device); the first 9 rows are the one-device run's."""
    from repro.bench.sweeps import disagg_serve as j_sweep
    from repro_torch.bench import run_sweeps as t_run_sweeps
    from repro_torch.bench.sweeps import disagg_serve as t_sweep

    drains = []
    real = t_sweep._drain

    def recording(*args, **kw):
        drains.append(real(*args, **kw))
        return drains[-1]

    monkeypatch.setattr(t_sweep, "_drain", recording)
    trun = t_run_sweeps(names=["disagg_serve"], fast=True, echo=False,
                        device="cpu", devices=["cpu", "cpu"])
    assert not trun.failures, trun.failures
    assert [r.name for r in trun.results] == _reference_row_order()
    assert len(trun.results) == 10
    _rows_equal(j_disagg_run.results, trun.results[:9])
    row = trun.results[-1]
    assert row.name == "disagg_serve_tp2_bitwise"
    assert (row.sweep, row.pattern, row.knobs) == (
        j_disagg_run.results[-1].sweep, None, {})
    assert row.extras["deterministic"] and row.timing is None
    assert (row.gbps_measured, row.gbps_predicted) == (1.0, 1.0)
    # the reference's pool on the weights the sweep drew
    cfg = t_override(t_smoke(T_ARCHS["gemma-2b"]), num_kv_heads=2)
    tparams = t_build(cfg, TFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16), device="cpu").init(
        torch.Generator().manual_seed(0))
    jcfg = j_override(j_smoke(J_ARCHS["gemma-2b"]), num_kv_heads=2)
    jb = j_build(jcfg, JFlags(attn_impl="chunked", attn_bq=16, attn_bkv=16,
                              moe_impl="dense", loss_chunk=16))
    jparams = jax.tree.map(lambda t: np.asarray(t.numpy()), tparams)
    kw = dict(batch_size=2, max_len=64, window=4, prefill_chunk=8,
              cache_backend="paged", seed=0)
    jpool = J.DisaggPool([J.ServeEngine(jb, jparams, **kw)],
                         [J.ServeEngine(jb, jparams, **kw)],
                         J.DisaggConfig(force="disagg"))
    want, jstats, _ = j_sweep._drain(jpool, jcfg, 4, 8)
    got, tstats, _ = drains[-1]
    assert got == want
    assert row.extras["transfers"] == tstats.prefill_imports
    assert row.extras["transfers"] == jstats.prefill_imports >= 1
