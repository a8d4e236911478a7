"""Tensor- and data-parallel serving in the port, held against the
reference's single-device engine on the CPU.

The reference's contract (``repro.dist.serve``) makes the single-device
engine the answer of a TP drain: shards split only the heads, logits are
gathered before selection, and the key chains never see the mesh.  So
every case here runs a port engine at TP=2 over ``["cpu", "cpu"]`` (two
shards on one device: the same per-shard code as on cards) beside the
reference's undistributed engine on the same bridged weights
(``jax.random.PRNGKey(7)``), the same page size and the same cost-model
numbers, and the tokens, the final keys and EVERY ``ServeStats`` field
must be equal:

- greedy drains on native and int8 pages for smoke gemma-2b with 2 kv
  heads (the reference's TP config), phi4-mini and gemma2-27b (ring
  tables, both softcaps);
- sampled drains (keys equal too), a speculative drain (as the
  reference's ``serve_tp_spec`` scenario), per-shard live-KV bytes
  exactly half, and logits within 1e-5 of TP=1 in every model mode;
- a DP=2 replica pool equal to one engine per request;
- two TP=2 replicas under cluster chaos (a replica killed mid-drain)
  equal to the reference's front of two single-device replicas under the
  same chaos, and a TP=2 prefill -> TP=2 decode disaggregated drain equal
  to the TP=2 colocated engine and to the reference's colocated one.
"""
import dataclasses

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
from repro_torch.core.memmodel import HopperSpec
from repro_torch.dist import ServeMesh
from repro_torch.launch.serve import build_pool
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build

FIELDS = [f.name for f in dataclasses.fields(JStats)]
KW = dict(batch_size=2, max_len=64, window=4, prefill_chunk=8,
          cache_backend="paged", seed=0)
SAMPLED = dict(temperature=0.9, top_k=11)
CPU2 = ["cpu", "cpu"]
FAMILIES = ("gemma-2b", "phi4-mini-3.8b", "gemma2-27b")

_STATE = {}


def _models(arch="gemma-2b", kv="native", seed=7):
    """(reference bundle, params, port bundle, params) at smoke width
    (gemma-2b with 2 kv heads), weights bridged from ``PRNGKey(seed)``."""
    key = ("models", arch, kv, seed)
    if key not in _STATE:
        jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
        if arch == "gemma-2b":
            jcfg = j_override(jcfg, num_kv_heads=2)
            tcfg = t_override(tcfg, num_kv_heads=2)
        jb = j_build(jcfg, JFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16, moe_impl="dense",
                                  loss_chunk=16, kv_dtype=kv))
        jparams = jb.init(jax.random.PRNGKey(seed))
        tb = t_build(tcfg, TFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16, kv_dtype=kv), device="cpu")
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _STATE[key] = (jb, jparams, tb, tparams)
    return _STATE[key]


def _share_cost_model(jeng, teng):
    """Both engines price a resume with the reference engine's numbers
    (its weight bytes, KV bytes per token, chunk, V5E's rate, 32 GB/s)."""
    num = dict(weight_bytes=sum(x.size * x.dtype.itemsize for x in
                                jax.tree_util.tree_leaves(jeng.params)),
               kv_bytes_per_token=jeng.bytes_per_page / jeng.page,
               prefill_chunk=jeng.prefill_chunk, host_link_bw=32e9)
    jeng.sched.cost_model = J.SwapCostModel(spec=V5E, **num)
    teng.sched.cost_model = T.SwapCostModel(
        spec=HopperSpec(hbm_bw=V5E.hbm_bw), **num)


def _pair(arch="gemma-2b", kv="native", tp=2, sampling=None, **kw):
    """A (reference single-device, port TP) engine pair of one geometry."""
    jb, jparams, tb, tparams = _models(arch, kv)
    kw = {**KW, **kw}
    jeng = J.ServeEngine(jb, jparams,
                         sampling=J.SamplingParams(**(sampling or {})), **kw)
    teng = T.ServeEngine(tb, tparams,
                         sampling=T.SamplingParams(**(sampling or {})),
                         page_size=jeng.page, **kw,
                         dist=ServeMesh.tp(tp, devices=["cpu"] * tp))
    _share_cost_model(jeng, teng)
    return jeng, teng


def _mk_reqs(R, n=5, max_new=8, seed=3, vocab=256):
    """Even rids share an 18-token prefix; prompts of 3-10 more tokens."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size=18).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab, size=int(rng.integers(3, 11))
                            ).astype(np.int32)
        reqs.append(R(rid=i, prompt=np.concatenate([common, tail])
                      if i % 2 == 0 else tail, max_new_tokens=max_new))
    return reqs


def _drain(eng, R, **kw):
    reqs = _mk_reqs(R, **kw)
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    return [list(r.out_tokens) for r in reqs]


def _check_engines(jeng, teng):
    for f in FIELDS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    np.testing.assert_array_equal(
        teng.keys.numpy(), np.asarray(jeng.keys).astype(np.int64))


# ---------------------------------------------------------------------------
# TP=2 drains against the reference's single device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tp2_greedy_drain_equals_reference_single_device(arch, kv):
    # gemma2-27b's ring (window 16 at smoke width) turns only past its
    # ring slots' pages: longer drains there
    ring = arch == "gemma2-27b"
    jeng, teng = _pair(arch, kv, max_len=128 if ring else 64)
    n_new = 48 if ring else 8
    want = _drain(jeng, J.Request, max_new=n_new)
    got = _drain(teng, T.Request, max_new=n_new)
    assert got == want
    _check_engines(jeng, teng)
    assert teng.tp == 2 and isinstance(teng.cache, list)
    # the pools are split on kv-heads: each shard holds its stripe of
    # every page, the same page ids on both
    whole = T_ARCHS[arch]
    hkv = (2 if arch == "gemma-2b" else t_smoke(whole).num_kv_heads)
    for c in teng.cache:
        for layer in c["blocks"].values():
            assert layer["k_pages"].shape[-2] == hkv // 2
    if teng.ralloc is not None:
        assert teng.stats.ring_pages_reused > 0


def test_tp2_sampled_drain_is_key_exact():
    jeng, teng = _pair(sampling=SAMPLED)
    want = _drain(jeng, J.Request)
    got = _drain(teng, T.Request)
    assert got == want
    _check_engines(jeng, teng)
    assert teng.keys.any()


def test_tp2_speculative_drain_equals_vanilla_reference():
    """The reference's ``serve_tp_spec`` scenario: a draft (the same
    architecture, weights of another seed) proposes 3 tokens a round to a
    TP=2 target whose draft is sharded too; the sampled drain gives the
    reference's single-device drain's tokens and counters, and its
    vanilla one's tokens."""
    jb, jparams, tb, tparams = _models()
    _, jdraft, _, tdraft = _models(seed=5)
    jvan, _ = _pair(sampling=SAMPLED)
    jeng, teng = _pair(sampling=SAMPLED, draft_bundle=None)
    jeng = J.ServeEngine(jb, jparams, sampling=J.SamplingParams(**SAMPLED),
                         draft_bundle=jb, draft_params=jdraft, spec_k=3,
                         **KW)
    teng = T.ServeEngine(tb, tparams, sampling=T.SamplingParams(**SAMPLED),
                         draft_bundle=tb, draft_params=tdraft, spec_k=3,
                         page_size=jeng.page, dist=ServeMesh.tp(2, CPU2),
                         **KW)
    _share_cost_model(jeng, teng)
    want = _drain(jvan, J.Request)
    assert _drain(jeng, J.Request) == want
    assert _drain(teng, T.Request) == want
    _check_engines(jeng, teng)
    assert teng.stats.spec_steps > 0 and isinstance(teng.draft_cache, list)


def test_tp2_live_bytes_per_shard_are_exactly_half():
    jeng, teng = _pair()
    _drain(jeng, J.Request)
    _drain(teng, T.Request)
    whole = jeng.live_kv_bytes_peak()
    assert teng.live_kv_bytes_peak() == whole
    assert 2 * teng.live_kv_bytes_peak(per_shard=True) == whole
    assert teng.kv_bytes() == jeng.kv_bytes()


def _logits(tb, params, cache, mode, toks, pos, table, cv):
    if mode == "decode":
        logits, _ = tb.paged_decode_step(params, cache, toks, pos, table)
    elif mode == "verify":
        _, logits = tb.paged_verify(params, cache, toks, pos, table, cv)
    else:
        _, logits = tb.paged_prefill_chunk(params, cache, toks, pos, table,
                                           cv)
    return logits


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tp2_logits_within_1e5_of_tp1(arch, kv):
    """Every model entry point at TP=2 against TP=1 on the same weights:
    dense prefill, a paged chunk, three decode ticks and a verify pass,
    float32 logits within 1e-5."""
    _, _, tb, tparams = _models(arch, kv)
    mesh = ServeMesh.tp(2, CPU2)
    tb2, tp2 = mesh.bind(tb), mesh.shard_params(tb, tparams)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (2, 12), generator=gen)
    got = torch.cat(tb2.prefill(tp2, dict(tokens=toks))[1], dim=-1)
    want = tb.prefill(tparams, dict(tokens=toks))[1]
    assert float((got - want).abs().max()) <= 1e-5
    table = dict(full=torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]],
                                   dtype=torch.int32),
                 ring=torch.tensor([[1, 2, 3], [4, 5, 6]],
                                   dtype=torch.int32))
    c1 = tb.init_paged_cache(9, 8, batch=2)
    c2 = mesh.shard_paged_cache(tb.init_paged_cache(9, 8, batch=2))
    cv = torch.tensor([12, 9], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    steps = [("extend", toks, pos, cv)]
    steps += [("decode", torch.randint(0, 256, (2, 1), generator=gen),
               cv + t, None) for t in range(3)]
    steps += [("verify", torch.randint(0, 256, (2, 4), generator=gen),
               cv + 3, torch.tensor([4, 2], dtype=torch.int32))]
    for mode, tk, p, v in steps:
        want = _logits(tb, tparams, c1, mode, tk, p, table, v)
        got = torch.cat(_logits(tb2, tp2, c2, mode, tk, p, table, v), -1)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5, mode


# ---------------------------------------------------------------------------
# DP: a replica pool behind one admission queue
# ---------------------------------------------------------------------------

def test_dp2_pool_streams_equal_the_reference_single_engine():
    """The reference's ``serve_dp_pool`` scenario: two replicas on two
    CPU "devices", one weight tree, the single engine's streams per
    request, and both replicas take work."""
    jb, jparams, tb, tparams = _models()
    jeng = J.ServeEngine(jb, jparams, **KW)
    want = _drain(jeng, J.Request)
    pool = build_pool(tb, tparams, tp=1, dp=2, devices=CPU2,
                      page_size=jeng.page, **KW)
    reqs = _mk_reqs(T.Request)
    for r in reqs:
        pool.submit(r)
    stats = pool.drain()
    assert [list(r.out_tokens) for r in reqs] == want
    assert stats.tokens_out == sum(len(t) for t in want)
    assert all(e.stats.tokens_out > 0 for e in pool.engines)
    assert pool.routed == [3, 2]
    assert len({id(e.cache) for e in pool.engines}) == 2
    # one device: the replicas serve the caller's weight tree itself
    assert all(e.params["embed"]["tok"] is tparams["embed"]["tok"]
               for e in pool.engines)


# ---------------------------------------------------------------------------
# TP replicas under cluster chaos and across the disaggregated hand-off
# ---------------------------------------------------------------------------

TCFG = dict(seed=23, n_requests=6, rate=1.2, burst_rate_mult=3.0,
            phase_rounds=4.0, n_prefixes=3, prefix_len=16, tail_lo=3,
            tail_hi=9, out_lo=6, out_hi=12)
KILL = dict(seed=4, crash_rounds=4, kill_at=((2, 0, "crash"),))


def test_cluster_chaos_over_tp2_replicas_equals_reference():
    """Two TP=2 replicas (four shards) under a replica kill: failover
    re-prefills on the other mesh and the drain replays the undisturbed
    one bitwise; both equal the reference's front of two single-device
    replicas under the same chaos, counter for counter."""
    pairs = [_pair() for _ in range(2)]
    fronts = {"ref": J.ClusterFrontEnd([p[0] for p in pairs]),
              "port": T.ClusterFrontEnd([p[1] for p in pairs])}
    mods = {"ref": J, "port": T}
    runs = {}
    for side, front in fronts.items():
        S = mods[side]
        for chaos in (None, KILL):
            front.reset()
            sched = S.generate_traffic(S.TrafficConfig(**TCFG), 256)
            front.run(sched, chaos=None if chaos is None else
                      S.ClusterChaos(S.ClusterChaosConfig(**chaos)))
            runs[side, chaos is None] = {r.rid: list(r.out_tokens)
                                         for _, r in sched}
    assert runs["port", False] == runs["port", True]
    assert runs["port", False] == runs["ref", False]
    assert runs["port", True] == runs["ref", True]
    jf, tf = fronts["ref"], fronts["port"]
    assert dataclasses.asdict(tf.cstats) == dataclasses.asdict(jf.cstats)
    assert tf.cstats.failovers >= 1 and tf.cstats.quarantines >= 1
    for jr, tr in zip(jf.replicas, tf.replicas):
        _check_engines(jr.engine, tr.engine)


def test_disagg_tp2_to_tp2_equals_colocated():
    """A TP=2 prefill engine ships each finished prompt to a TP=2 decode
    engine: per-shard gathers assemble whole pages (the entry a single
    device makes, so its bytes and checksum are the reference's) and
    per-shard scatters land the stripes; the drain equals the TP=2
    colocated engine's and the reference's colocated one's."""
    jeng, tcol = _pair(max_len=64)
    want = _drain(jeng, J.Request, n=3, max_new=6)
    assert _drain(tcol, T.Request, n=3, max_new=6) == want
    jpool = J.DisaggPool([_pair()[0]], [_pair()[0]],
                         J.DisaggConfig(force="disagg"))
    tpool = T.DisaggPool([_pair()[1]], [_pair()[1]],
                         T.DisaggConfig(force="disagg"))
    got = {}
    for side, pool, R in (("ref", jpool, J.Request),
                          ("port", tpool, T.Request)):
        reqs = _mk_reqs(R, n=3, max_new=6)
        for r in reqs:
            pool.submit(r)
        pool.run()
        got[side] = [list(r.out_tokens) for r in reqs]
    assert got["port"] == want and got["ref"] == want
    st, sj = tpool.stats(), jpool.stats()
    assert st.prefill_imports >= 1
    for f in FIELDS:
        assert getattr(st, f) == getattr(sj, f), f
    assert all(e.tp == 2 for e in tpool.engines)
