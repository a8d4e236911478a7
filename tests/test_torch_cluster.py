"""The cluster front end, open-loop traffic and cluster chaos in the port,
held against the reference on the CPU.

Both packages serve the same bridged weights (smoke gemma-2b, float32,
``jax.random.PRNGKey(7)``) through fronts of the same geometry; every
scenario runs the same operations on both, and the tokens, the final
keys, EVERY ``ServeStats`` field of every replica, every
``ClusterStats`` field, the replicas' states and routed counts, the
owner map, the shed requests and the virtual-round percentiles must be
equal.  Engines share the reference's cost model numbers (V5E's HBM rate,
a 32 GB/s link) wherever a preemption prices its resume.

- pure units: ``generate_traffic`` equal to the reference's over several
  configs (deadlines, a high-priority share, bursts, one prefix) and a
  pure function of its config; ``PrefixIndex.match_len`` equal and a
  pure peek; ``fault_rng``'s streams;
- the reference's front-end cases (``tests/test_serve_cluster.py``):
  rejected pools, evacuate -> adopt mid-stream, routing to the predicted
  prefix hit, deadline shedding and degradation, transient admission
  refusals, crash failover, brownout quarantine, percentiles, and the
  seeded random chaos over native, int8 and sampled replicas (the TP case
  runs in ``tests/test_torch_tp_serve.py``);
- the ``cluster_serve`` sweep at ``fast``: the reference's rows and
  every deterministic column.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

import repro.serve as J
from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.core.memmodel import V5E
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.serve.engine import ServeStats as JStats
from repro.serve.scheduler import PRIORITY_HIGH as J_HIGH
import repro_torch.serve as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.memmodel import HopperSpec
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.serve.hosttier import tree_leaves
from repro_torch.serve.scheduler import PRIORITY_HIGH as T_HIGH

FIELDS = [f.name for f in dataclasses.fields(JStats)]
KW = dict(batch_size=2, max_len=64, window=4, prefill_chunk=8,
          cache_backend="paged", seed=0)
SAMPLED = dict(temperature=0.9, top_p=0.95)
TCFG = dict(seed=23, n_requests=8, rate=1.2, burst_rate_mult=3.0,
            phase_rounds=4.0, n_prefixes=3, prefix_len=16, tail_lo=3,
            tail_hi=9, out_lo=6, out_hi=12)
RANDOM_CHAOS = dict(seed=12, crash_prob=0.05, crash_rounds=3,
                    brownout_prob=0.05, brownout_rounds=3,
                    brownout_latency_s=1.0, admit_prob=0.1)

# each package's names, so one scenario runs on both
PKG = {
    "ref": types.SimpleNamespace(S=J, HIGH=J_HIGH, cost=J.SwapCostModel,
                                 spec=V5E),
    "port": types.SimpleNamespace(S=T, HIGH=T_HIGH, cost=T.SwapCostModel,
                                  spec=HopperSpec(hbm_bw=V5E.hbm_bw)),
}

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


def _share_cost_model(jeng, teng):
    """Both engines price a resume with the reference engine's numbers
    (its weight bytes, KV bytes per token, chunk, V5E's rate, 32 GB/s)."""
    wb = sum(x.size * x.dtype.itemsize
             for x in jax.tree_util.tree_leaves(jeng.params))
    num = dict(weight_bytes=wb,
               kv_bytes_per_token=jeng.bytes_per_page / jeng.page,
               prefill_chunk=jeng.prefill_chunk, host_link_bw=32e9)
    for side, eng in (("ref", jeng), ("port", teng)):
        eng.sched.cost_model = PKG[side].cost(spec=PKG[side].spec, **num)


def _engines(kv="native", **kw):
    """A (reference, port) engine pair of the front geometry."""
    _, jb, jparams, tb, tparams = _models(kv)
    kw = {**KW, **kw}
    sp = kw.pop("sampling", None)
    jeng = J.ServeEngine(jb, jparams, sampling=J.SamplingParams(**(sp or {})),
                         **kw)
    teng = T.ServeEngine(tb, tparams, sampling=T.SamplingParams(**(sp or {})),
                         page_size=jeng.page, device="cpu", **kw)
    _share_cost_model(jeng, teng)
    return jeng, teng


def _fronts(key, n=2, kv="native", **kw):
    """The (reference, port) fronts of ``n`` replicas, cached per key and
    reset."""
    if key not in _STATE:
        pairs = [_engines(kv, **kw) for _ in range(n)]
        _STATE[key] = {"ref": J.ClusterFrontEnd([p[0] for p in pairs]),
                       "port": T.ClusterFrontEnd([p[1] for p in pairs])}
    fronts = _STATE[key]
    for f in fronts.values():
        f.reset()
    return fronts


def _check_fronts(jf, tf):
    """Every router and engine counter, state and key of two fronts."""
    assert dataclasses.asdict(tf.cstats) == dataclasses.asdict(jf.cstats)
    assert tf.percentiles() == jf.percentiles()
    assert tf.owner == jf.owner
    assert ([r.rid for r in tf.shed_requests]
            == [r.rid for r in jf.shed_requests])
    for jr, tr in zip(jf.replicas, tf.replicas):
        assert (tr.state, tr.routed, tr.backoff_until) == (
            jr.state, jr.routed, jr.backoff_until)
        for f in FIELDS:
            assert getattr(tr.engine.stats, f) == getattr(jr.engine.stats,
                                                          f), f
        np.testing.assert_array_equal(
            tr.engine.keys.numpy(), np.asarray(jr.engine.keys).astype(
                np.int64))
    for f in FIELDS:
        assert getattr(tf.stats(), f) == getattr(jf.stats(), f), f


def _both(key, scenario, **front_kw):
    """``scenario(P, front)`` on the reference's front and the port's: the
    results and every counter must be equal.  Returns the result and the
    (reference, port) fronts."""
    fronts = _fronts(key, **front_kw)
    want = scenario(PKG["ref"], fronts["ref"])
    got = scenario(PKG["port"], fronts["port"])
    assert got == want
    _check_fronts(fronts["ref"], fronts["port"])
    return want, fronts["ref"], fronts["port"]


def _drain(tcfg=None, chaos=None):
    """A scenario: the open-loop schedule drained under optional chaos
    (``ClusterChaosConfig`` keyword arguments); returns the tokens and the
    chaos counters."""
    def scenario(P, front):
        vocab = front.engines[0].bundle.cfg.vocab_size
        sched = P.S.generate_traffic(P.S.TrafficConfig(**(tcfg or TCFG)),
                                     vocab)
        ch = (None if chaos is None
              else P.S.ClusterChaos(P.S.ClusterChaosConfig(**chaos)))
        front.run(sched, chaos=ch)
        assert not front.backlog and not front._live
        faults = (None if ch is None
                  else (ch.crashes, ch.brownouts, ch.admit_faults))
        return {r.rid: list(r.out_tokens) for _, r in sched}, faults
    return scenario


# ---------------------------------------------------------------------------
# pure units
# ---------------------------------------------------------------------------

TRAFFIC = {
    "sweep": TCFG,
    "slo": dict(seed=3, n_requests=12, rate=1.5, burst_rate_mult=2.5,
                n_prefixes=2, prefix_len=8, deadline_rounds=(3, 9),
                high_priority_frac=0.5),
    "congested": dict(seed=29, n_requests=12, rate=6.0, burst_rate_mult=2.0,
                      phase_rounds=4.0, n_prefixes=3, prefix_len=16,
                      deadline_rounds=(2, 10), high_priority_frac=0.25),
    "bursty": dict(seed=7, n_requests=40, rate=0.5, burst_rate_mult=8.0,
                   phase_rounds=2.0, zipf_a=2.0, prefix_len=256, tail_lo=1,
                   tail_hi=40, out_lo=1, out_hi=64),
    "defaults": {},
    "one-prefix": dict(seed=11, n_requests=5, n_prefixes=1, prefix_len=0,
                       high_priority_frac=1.0, deadline_rounds=(0, 0)),
}


def _flat(sched):
    return [(t, r.rid, r.max_new_tokens, r.priority, r.deadline,
             r.prompt.dtype.str, r.prompt.tolist()) for t, r in sched]


@pytest.mark.parametrize("name", list(TRAFFIC))
def test_traffic_equals_reference(name):
    kw = TRAFFIC[name]
    want = J.generate_traffic(J.TrafficConfig(**kw), vocab_size=257)
    got = T.generate_traffic(T.TrafficConfig(**kw), vocab_size=257)
    assert _flat(got) == _flat(want)
    assert all(isinstance(r, T.Request) and r.out_tokens == []
               for _, r in got)


def test_traffic_schedule_is_pure_and_shaped():
    cfg = T.TrafficConfig(**TRAFFIC["slo"])
    a = T.generate_traffic(cfg, vocab_size=101)
    b = T.generate_traffic(cfg, vocab_size=101)
    assert _flat(a) == _flat(b)              # same config, same schedule
    assert a[0][1] is not b[0][1]            # ...but fresh Request objects
    arrivals = [t for t, _ in a]
    assert arrivals == sorted(arrivals)
    heads = {tuple(r.prompt[:cfg.prefix_len].tolist()) for _, r in a}
    assert len(heads) <= cfg.n_prefixes < len(a)
    for t, r in a:
        assert 3 <= r.deadline - t <= 9      # the deadline window is relative
    assert {r.priority for _, r in a} == {0, 1}
    c = T.generate_traffic(dataclasses.replace(cfg, seed=4), 101)
    assert _flat(c) != _flat(a)


def _match_len_scenario(S):
    idx = S.PrefixIndex()
    alloc = S.PageAllocator(8, 4, reserved=1)
    alloc.alloc(1)
    alloc.reserve(1, 8)                      # two pages
    p0, p1 = alloc.tables[1]
    alloc.pin(p0)
    alloc.pin(p1)
    idx.register("h0", p0)
    idx.register("h1", p1)
    before = dict(idx._by_hash)
    out = [idx.match_len(["h0", "h1"], alloc),
           idx.match_len(["h0", "hX", "h1"], alloc),
           idx.match_len(["hX"], alloc), idx.match_len([], alloc)]
    alloc.unpin(p1)
    # an unpinned page is a miss for routing, and its entry stays
    out += [idx.match_len(["h0", "h1"], alloc), len(idx),
            idx.match_len(["h0", "h1"])]
    assert idx._by_hash == before            # a peek drops nothing
    # lookup, not match_len, reaps the stale entry
    out += [idx.lookup(["h0", "h1"], alloc), len(idx)]
    return out, idx


def test_match_len_equals_reference_and_is_a_pure_peek():
    want, jidx = _match_len_scenario(J)
    got, _ = _match_len_scenario(T)
    assert got == want == [2, 1, 0, 0, 1, 2, 2, [1], 1]
    assert (jidx.hits, jidx.misses) == (1, 1)  # only lookup counted


@pytest.mark.parametrize("kind", ["storm", "exhaust", "corrupt", "crash",
                                  "brownout", "admit", "transfer"])
def test_fault_rng_streams_equal_reference(kind):
    for seed in (0, 1, 12):
        a, b = T.fault_rng(seed, kind), J.fault_rng(seed, kind)
        assert [a.random() for _ in range(8)] == [b.random()
                                                  for _ in range(8)]
    sa = [T.fault_rng(0, kind).random() for _ in range(8)]
    for other in ("storm", "crash", "brownout"):
        if other != kind:
            assert [T.fault_rng(0, other).random() for _ in range(8)] != sa
    with pytest.raises(KeyError):
        T.fault_rng(0, "gremlin")


# ---------------------------------------------------------------------------
# the reference's front-end cases, through both packages
# ---------------------------------------------------------------------------

def test_front_end_rejects_bad_pools():
    with pytest.raises(ValueError, match="at least one"):
        T.ClusterFrontEnd([])
    _, _, _, tb, tparams = _models()
    kw = {**KW, "device": "cpu"}
    with pytest.raises(ValueError, match="share the sampling seed"):
        T.ClusterFrontEnd([T.ServeEngine(tb, tparams, **{**kw, "seed": 0}),
                           T.ServeEngine(tb, tparams, **{**kw, "seed": 1})])


def test_replicas_share_one_weight_tree():
    fronts = _fronts("pair")
    e0, e1 = fronts["port"].engines
    assert e0.params is e1.params
    assert all(a is b for (_, a), (_, b) in zip(tree_leaves(e0.params),
                                                tree_leaves(e1.params)))


def test_evacuate_adopt_midstream_is_bitwise():
    def scenario(P, front):
        e1, e2 = front.engines
        vocab = e1.bundle.cfg.vocab_size

        def mk():
            rng = np.random.default_rng(13)
            return [P.S.Request(rid=i, prompt=rng.integers(
                1, vocab, size=20).astype(np.int32), max_new_tokens=8)
                for i in range(4)]
        ref_reqs = mk()
        for r in ref_reqs:
            e1.add_request(r)
        e1.run_to_completion()
        ref = {r.rid: list(r.out_tokens) for r in ref_reqs}
        e1.reset()
        reqs = mk()
        for r in reqs:
            e1.add_request(r)
        for _ in range(3):                   # mid-stream: some tokens out
            e1.step()
        assert any(r.out_tokens for r in reqs)
        moved = e1.evacuate()
        assert not e1.queue and all(s is None for s in e1.slots)
        assert {r.rid for r in moved} == {r.rid for r in reqs if not r.done}
        for r in moved:
            e2.adopt(r)
        e2.run_to_completion()
        got = {r.rid: list(r.out_tokens) for r in reqs}
        assert got == ref
        assert e2.stats.recompute_resumes >= 1
        return got, sorted(r.rid for r in moved)
    _both("pair", scenario)


def test_router_prefers_predicted_prefix_hit():
    def scenario(P, front):
        vocab = front.engines[0].bundle.cfg.vocab_size
        rng = np.random.default_rng(11)
        common = rng.integers(1, vocab, size=32).astype(np.int32)
        # warm replica 1's prefix cache off the router
        front.replicas[1].engine.add_request(
            P.S.Request(rid=100, prompt=common.copy(), max_new_tokens=4))
        front.replicas[1].engine.run_to_completion()
        tail = rng.integers(1, vocab, size=5).astype(np.int32)
        req = P.S.Request(rid=101, prompt=np.concatenate([common, tail]),
                          max_new_tokens=4)
        hits = [rep.predicted_hit_tokens(req.prompt)
                for rep in front.replicas]
        assert hits[1] > 0 and hits[0] == 0
        front.submit(req)
        front.run()
        # ties break to the LOWER index, so landing on 1 proves the cache
        assert front.owner[101] == 1
        assert front.stats().prefix_hit_tokens > 0
        return hits, list(req.out_tokens)
    _both("pair", scenario)


def test_deadline_sheds_low_priority_keeps_high():
    def scenario(P, front):
        vocab = front.engines[0].bundle.cfg.vocab_size
        rng = np.random.default_rng(17)

        def prompt():
            return rng.integers(1, vocab, size=20).astype(np.int32)
        for i in range(4):                   # congest both replicas
            front.submit(P.S.Request(rid=i, prompt=prompt(),
                                     max_new_tokens=24))
        low = P.S.Request(rid=50, prompt=prompt(), max_new_tokens=8,
                          deadline=1)
        high = P.S.Request(rid=51, prompt=prompt(), max_new_tokens=8,
                           deadline=1, priority=P.HIGH)
        front.submit(low)
        front.submit(high)
        front.run()
        assert low in front.shed_requests and low.out_tokens == []
        assert high.done                     # never shed, routed at risk
        c = front.cstats
        assert c.shed == 1 and c.slo_risk == 1
        assert c.completed + c.shed == c.submitted
        return list(high.out_tokens)
    _both("pair", scenario)


def test_deadline_degrades_max_new_tokens_to_fit():
    def scenario(P, front):
        vocab = front.engines[0].bundle.cfg.vocab_size
        req = P.S.Request(rid=7, prompt=np.arange(1, 21, dtype=np.int32)
                          % vocab, max_new_tokens=12, deadline=1)
        # slack = 1 round x (bsz x window = 8 units) - 3 prefill chunks = 5
        front.submit(req)
        front.run()
        assert front.cstats.degraded == 1 and front.cstats.shed == 0
        assert req.max_new_tokens == 5 and req.done
        return list(req.out_tokens)
    _both("solo", scenario, n=1)


def test_replica_submit_raises_when_fault_armed():
    def scenario(P, front):
        rep = front.replicas[0]
        rep.admit_faults = 1
        with pytest.raises(P.S.TransientAdmitError):
            rep.submit(P.S.Request(rid=9, prompt=np.ones(4, np.int32)))
        # the fault is consumed: the retry lands
        rep.submit(P.S.Request(rid=9, prompt=np.ones(4, np.int32)))
        return rep.routed, rep.admit_faults, len(rep.engine.queue)
    assert _both("pair", scenario)[0] == (1, 0, 1)


# the reference's chaos cases: (front key, front kwargs, chaos, checks on
# the port's front and chaos counters)
def _crash_checks(c, s, faults):
    assert faults[0] == 1
    assert c.quarantines >= 1 and c.failovers >= 1
    assert c.probe_failures >= 1 and c.recoveries >= 1
    assert s.preemptions >= 1
    assert s.recompute_resumes + s.preempt_restarts >= 1


CHAOS = {
    "admit": ("pair", {}, dict(seed=2, admit_prob=0.5),
              lambda c, s, f: f[2] > 0 and c.retries > 0 and c.shed == 0),
    "crash": ("pair", {}, dict(seed=1, crash_rounds=4,
                               kill_at=((2, 1, "crash"),)),
              lambda c, s, f: _crash_checks(c, s, f) is None),
    "brownout": ("pair", {}, dict(seed=1, brownout_rounds=5,
                                  brownout_latency_s=1.0,
                                  kill_at=((1, 0, "brownout"),)),
                 lambda c, s, f: f[1] == 1 and c.slow_probes >= 3
                 and c.quarantines >= 1),
    "sweep-kill-schedule": (
        "pair", {}, dict(seed=5, crash_rounds=4, brownout_rounds=4,
                         brownout_latency_s=1.0,
                         kill_at=((0, 0, "admit"), (0, 1, "admit"),
                                  (2, 1, "crash"), (12, 0, "brownout"))),
        lambda c, s, f: c.failovers >= 1 and c.quarantines >= 1
        and c.retries >= 1),
    "random-native": ("pair", {}, RANDOM_CHAOS, lambda c, s, f: sum(f) > 0),
    "random-int8": ("int8", dict(kv="int8"), RANDOM_CHAOS,
                    lambda c, s, f: sum(f) > 0),
    "random-sampled": ("sampled", dict(sampling=SAMPLED, seed=3),
                       RANDOM_CHAOS, lambda c, s, f: sum(f) > 0),
}


@pytest.mark.parametrize("name", list(CHAOS))
def test_cluster_chaos_drains_bitwise(name):
    """The undisturbed drain, then the chaos drain: each equal to the
    reference's in tokens and every counter, and the chaos drain's tokens
    the undisturbed ones (float32: a failed-over request's recomputed rows
    equal the decoded ones)."""
    key, kw, chaos, checks = CHAOS[name]
    (want, _), _, _ = _both(key, _drain(), **kw)
    (got, faults), _, tf = _both(key, _drain(chaos=chaos), **kw)
    assert got == want
    assert checks(tf.cstats, tf.stats(), faults)


def test_percentiles_are_deterministic_and_positive():
    _, _, tf = _both("pair", _drain())
    a = tf.percentiles()
    _both("pair", _drain())
    assert tf.percentiles() == a
    assert all(v > 0 for v in a.values())
    assert tf.cstats.rounds > 0


def test_deadline_workload_sheds_as_the_reference():
    """``cluster_serve``'s congested workload: some requests shed, some
    degraded, high ones at risk, the same ones as the reference."""
    (tokens, _), _, tf = _both("pair", _drain(TRAFFIC["congested"]))
    c = tf.cstats
    assert 0 < c.shed < c.submitted and c.completed + c.shed == c.submitted


# ---------------------------------------------------------------------------
# the cluster_serve sweep at fast
# ---------------------------------------------------------------------------

WALL_EXTRAS = ("tok_s", "mean_us")


def test_cluster_serve_rows_equal_reference():
    from repro.bench import run_sweeps as j_run_sweeps
    from repro_torch.bench import run_sweeps as t_run_sweeps

    jrun = j_run_sweeps(names=["cluster_serve"], fast=True, echo=False)
    trun = t_run_sweeps(names=["cluster_serve"], fast=True, echo=False,
                        device="cpu")
    assert not jrun.failures and not trun.failures, (jrun.failures,
                                                     trun.failures)
    assert [r.name for r in trun.results] == [r.name for r in jrun.results]
    assert len(trun.results) == 8
    for j, t in zip(jrun.results, trun.results):
        assert (t.sweep, t.pattern, t.knobs) == (j.sweep, j.pattern, j.knobs)
        assert ({k: v for k, v in t.extras.items() if k not in WALL_EXTRAS}
                == {k: v for k, v in j.extras.items()
                    if k not in WALL_EXTRAS}), t.name
        if j.extras.get("deterministic"):
            assert t.timing is None and j.timing is None
            assert (t.gbps_measured, t.gbps_predicted) == (
                j.gbps_measured, j.gbps_predicted), t.name
        else:
            assert t.timing.trials == j.timing.trials == 2
            assert t.us_per_call > 0
