"""Preemption, the host swap tier and chaos in the port's engine, held
against the reference's engine on the CPU.

Both engines serve the same bridged weights (smoke configs, float32) with
the same page size; every scenario runs the same operations on both, and
the tokens, the final keys and EVERY field of the reference's
``ServeStats`` must be equal.  Where the policy prices a resume (victim
choice, ``mode=None``), both engines get a cost model with the same
numbers: the reference's ``V5E`` HBM rate and 32 GB/s link, which the
port's model reads as ``HopperSpec(hbm_bw=V5E.hbm_bw)``.

- the reference's engine cases (``tests/test_serve_scheduler.py``):
  recompute and swap resumes, a corrupted swap recomputed, the dense
  backend's preemption, high priority displacing low under pool pressure,
  uniform priorities never preempting, priority admission order, the
  prefill-chunk cap, ``reset()`` after a preempted speculative drain;
- ``ChaosEngine`` drains (storms, phantom exhaustion, corruption; modes
  None/swap/recompute and several seeds) on gemma-2b paged with native
  and int8 pages, dense, sampled and speculative, and on smoke gemma2-27b
  (ring pages): equal to the reference's chaos drains, and to the
  undisturbed drain where the reference's tests claim it;
- smoke recurrentgemma-9b and mamba2-130m preempted in recompute mode:
  their state comes back from the prefill scan, not from decode steps, so
  they are held to the reference's preempted drain;
- the hand-off between engines (``tests/test_serve_disagg.py``'s engine
  cases, ``test_serve_cluster.py``'s evacuate/adopt): export and import
  refusals and drains, a transfer corrupted in transit recomputed,
  ``evacuate`` of a swap record whose tier is gone, ``adopt`` of a
  finished request, evacuate -> adopt mid-stream bitwise;
- the engine's own cost model: the H100's spec and host link with the
  reference's weight and KV byte counts.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.core.memmodel import V5E
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.serve import ChaosConfig as JChaosConfig
from repro.serve import ChaosEngine as JChaos
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SwapCostModel as JCost
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import ServeStats as JStats
from repro.serve.engine import _Resume as JResume
from repro.serve.sampling import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.memmodel import H100, HopperSpec
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.serve import ChaosConfig as TChaosConfig
from repro_torch.serve import ChaosEngine as TChaos
from repro_torch.serve import Scheduler as TScheduler
from repro_torch.serve import SchedulerConfig as TSchedulerConfig
from repro_torch.serve import SwapCostModel as TCost
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TServeEngine
from repro_torch.serve.engine import _Resume as TResume
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import HOST_LINK_BW
from repro_torch.tune.plan import next_pow2

BATCH, MAX_LEN, WINDOW, CHUNK, SEED = 2, 64, 4, 8, 3
SAMPLED = dict(temperature=0.9, top_p=0.95)
FIELDS = [f.name for f in dataclasses.fields(JStats)]

_MODELS = {}
_ENGINES = {}


def _model(arch, kv="native", seed=7):
    """(reference bundle, params, port bundle, params), bridged weights
    drawn by ``jax.random.PRNGKey(seed)``."""
    key = (arch, kv, seed)
    if key not in _MODELS:
        jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
        jb = j_build(jcfg, JFlags(kv_dtype=kv))
        jparams = jb.init(jax.random.PRNGKey(seed))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _MODELS[key] = (jb, jparams, t_build(tcfg, TFlags(kv_dtype=kv),
                                             device="cpu"), tparams)
    return _MODELS[key]


def _share_cost_model(jeng, teng):
    """Give both schedulers the cost model the reference engine derives
    (its weight bytes, KV bytes per token, chunk, V5E's rate, a 32 GB/s
    link), the port's with ``HopperSpec(hbm_bw=V5E.hbm_bw)``."""
    wb = sum(x.size * x.dtype.itemsize
             for x in jax.tree_util.tree_leaves(jeng.params))
    if jeng.backend == "paged":
        kv_tok, chunk = jeng.bytes_per_page / jeng.page, jeng.prefill_chunk
    else:
        kv_tok, chunk = jeng.kv_bytes() / (BATCH * MAX_LEN), MAX_LEN
    num = dict(weight_bytes=wb, kv_bytes_per_token=kv_tok,
               prefill_chunk=chunk, host_link_bw=32e9)
    jeng.sched.cost_model = JCost(spec=V5E, **num)
    teng.sched.cost_model = TCost(spec=HopperSpec(hbm_bw=V5E.hbm_bw), **num)


def _pair(arch="gemma-2b", kv="native", backend="paged", sampling="greedy",
          spec=False, num_pages=None, prefix_cache=True, sched=None,
          batch=BATCH):
    """(reference engine, port engine), cached per geometry and reset.
    ``sched`` is a SchedulerConfig's keyword arguments."""
    key = (arch, kv, backend, sampling, spec, num_pages, prefix_cache,
           tuple(sorted((sched or {}).items())), batch)
    if key not in _ENGINES:
        jb, jparams, tb, tparams = _model(arch, kv)
        sp = SAMPLED if sampling == "sampled" else {}
        jkw, tkw = {}, {}
        if spec:
            jdb, jdp, tdb, tdp = _model(arch, kv, seed=11)
            jkw = dict(draft_bundle=jdb, draft_params=jdp, spec_k=3)
            tkw = dict(draft_bundle=tdb, draft_params=tdp, spec_k=3)
        jeng = JServeEngine(
            jb, jparams, batch_size=batch, max_len=MAX_LEN, window=WINDOW,
            cache_backend=backend, prefill_chunk=CHUNK, num_pages=num_pages,
            prefix_cache=prefix_cache, sampling=JSP(**sp), seed=SEED,
            scheduler=JScheduler(JSchedulerConfig(**(sched or {}))), **jkw)
        if backend == "paged":
            tkw.update(page_size=jeng.page, num_pages=num_pages)
        teng = TServeEngine(
            tb, tparams, batch, MAX_LEN, window=WINDOW, cache_backend=backend,
            prefill_chunk=CHUNK, prefix_cache=prefix_cache,
            sampling=TSP(**sp), seed=SEED,
            scheduler=TScheduler(TSchedulerConfig(**(sched or {}))),
            device="cpu", **tkw)
        _share_cost_model(jeng, teng)
        _ENGINES[key] = (jeng, teng)
    jeng, teng = _ENGINES[key]
    jeng.reset()
    teng.reset()
    return jeng, teng


def _requests(R, seed=1, n=4, plen=20, new=8, priority=None):
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=rng.integers(1, 256, size=plen).astype(np.int32),
              max_new_tokens=new,
              priority=0 if priority is None else priority(i))
            for i in range(n)]


def _both(scenario, **kw):
    """Run ``scenario(eng, R)`` on the reference engine and the port's (a
    pair from :func:`_pair` with ``kw``) and hold them equal: what the
    scenario returns, every ServeStats field, the final keys and page
    conservation.  Returns (reference's result, port's, (jeng, teng))."""
    jeng, teng = _pair(**kw)
    want = scenario(jeng, JRequest)
    got = scenario(teng, TRequest)
    assert got == want
    for f in FIELDS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    np.testing.assert_array_equal(teng.keys.numpy(),
                                  np.asarray(jeng.keys).astype(np.int64))
    if teng.backend == "paged":
        for a in (teng.alloc, teng.ralloc):
            if a is not None:
                assert a.pages_in_use + len(a.free) == (a.num_pages
                                                        - a.reserved)
                assert not a.tables and set(a.ref) == a.pinned
    return want, got, (jeng, teng)


def _outs(reqs):
    return {r.rid: list(r.out_tokens) for r in reqs}


def _drain(eng, R, **kw):
    reqs = _requests(R, **kw)
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion(max_ticks=5_000)
    assert all(r.done for r in reqs)
    return _outs(reqs)


def _undisturbed(**pair_kw):
    want, _, _ = _both(_drain, **pair_kw)
    return want


# ---------------------------------------------------------------------------
# the reference's engine cases
# ---------------------------------------------------------------------------

def _preempt_after(steps, mode, corrupt=False, decoding=False):
    def scenario(eng, R):
        reqs = _requests(R)
        for r in reqs:
            eng.add_request(r)
        if decoding:    # past every prefill: the victim is mid-decode
            while not any(r is not None and r.out_tokens for r in eng.slots):
                eng.step()
            victim = next(i for i, r in enumerate(eng.slots)
                          if r is not None and r.out_tokens)
        else:
            for _ in range(steps):
                eng.step()
            victim = next(i for i, r in enumerate(eng.slots)
                          if r is not None)
        rid = eng.slots[victim].rid
        used = eng.preempt(victim, mode=mode)
        held = len(eng.host_tier) if eng.host_tier is not None else None
        if corrupt:
            assert eng.host_tier.corrupt(rid)
        eng.run_to_completion(max_ticks=5_000)
        return _outs(reqs), used, held
    return scenario


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_recompute_resume_is_lossless(kv):
    ref = _undisturbed(kv=kv)
    (outs, used, _), _, (_, teng) = _both(_preempt_after(3, "recompute"),
                                          kv=kv)
    assert used in ("recompute", "restart")
    assert teng.stats.preemptions >= 1
    assert teng.stats.recompute_resumes + teng.stats.preempt_restarts >= 1
    if kv == "native":          # the reference's own claim
        assert outs == ref


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_swap_resume_is_lossless_and_counts_bytes(kv):
    ref = _undisturbed(kv=kv)
    (outs, used, held), _, (_, teng) = _both(
        _preempt_after(0, "swap", decoding=True), kv=kv)
    assert used == "swap" and held == 1
    st = teng.stats
    assert outs == ref          # swap restores the rows bit for bit
    assert st.swap_outs == st.swap_ins == 1 and st.swap_fallbacks == 0
    assert st.swap_bytes > 0 and len(teng.host_tier) == 0


def test_corrupted_swap_falls_back_to_recompute():
    ref = _undisturbed()
    (outs, _, _), _, (_, teng) = _both(
        _preempt_after(0, "swap", corrupt=True, decoding=True))
    assert outs == ref
    st = teng.stats
    assert st.swap_fallbacks == 1 and st.swap_ins == 0
    assert st.recompute_resumes >= 1


def test_dense_backend_preempts_and_resumes():
    ref = _undisturbed(backend="dense")
    (outs, used, held), _, _ = _both(_preempt_after(2, "swap"),
                                     backend="dense")
    assert used == "recompute" and held is None   # no pools: no swap
    assert outs == ref


def test_high_priority_preempts_low_under_pool_pressure():
    def scenario(eng, R):
        rng = np.random.default_rng(2)

        def prompt():
            return rng.integers(1, 256, size=20).astype(np.int32)

        low = [R(rid=i, prompt=prompt(), max_new_tokens=24, priority=0)
               for i in range(2)]
        hi = R(rid=99, prompt=prompt(), max_new_tokens=4, priority=1)
        for r in low:
            eng.add_request(r)
        for _ in range(4):
            eng.step()
        eng.add_request(hi)
        eng.run_to_completion(max_ticks=5_000)
        assert hi.done and all(r.done for r in low)
        return _outs(low + [hi])

    _, _, (_, teng) = _both(scenario, num_pages=2 * 3 + 3)
    assert teng.stats.preemptions >= 1


@pytest.mark.parametrize("num_pages", [9, 12])
def test_priority_pool_at_the_card_mix(num_pages):
    """``preempt_serve``'s priority block at its card mix (16 new tokens,
    so low requests of 48, max_len 128): the reference's 9 pages (8 usable)
    cannot hold one 68-token low request of 9 pages, and both engines
    raise; the sweep's card pool of 12 (the null page, one low request's
    pages and two more) drains high first on both, equal in tokens and
    every counter."""
    from repro.serve import PoolExhausted as JPoolExhausted
    from repro_torch.serve import PoolExhausted as TPoolExhausted

    jb, jparams, tb, tparams = _model("gemma-2b")
    common = dict(window=WINDOW, prefill_chunk=CHUNK, cache_backend="paged",
                  num_pages=num_pages)
    jeng = JServeEngine(jb, jparams, batch_size=2, max_len=128, **common)
    teng = TServeEngine(tb, tparams, 2, 128, page_size=jeng.page,
                        device="cpu", **common)

    def scenario(eng, R):
        rng = np.random.default_rng(10)
        low = [R(rid=i, prompt=rng.integers(1, 256, size=20).astype(
            np.int32), max_new_tokens=48, priority=0) for i in range(2)]
        hi = R(rid=99, prompt=rng.integers(1, 256, size=20).astype(np.int32),
               max_new_tokens=4, priority=1)
        for r in low:
            eng.add_request(r)
        for _ in range(4):
            eng.step()
        eng.add_request(hi)
        order = []
        while any(s is not None for s in eng.slots) or eng.queue:
            eng.step()
            order += [r.rid for r in (hi, *low)
                      if r.done and r.rid not in order]
        return order, _outs(low + [hi])

    if num_pages == 9:
        with pytest.raises(JPoolExhausted):
            scenario(jeng, JRequest)
        with pytest.raises(TPoolExhausted):
            scenario(teng, TRequest)
        return
    want, got = scenario(jeng, JRequest), scenario(teng, TRequest)
    assert got == want and want[0][0] == 99
    for f in FIELDS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert teng.stats.preemptions >= 1


def test_uniform_priorities_never_preempt():
    _, _, (_, teng) = _both(_drain)
    assert teng.stats.preemptions == 0


def test_admission_orders_by_priority():
    def scenario(eng, R):
        for r in _requests(R, n=4, priority=lambda i: i % 2):
            eng.add_request(r)
        eng._admit()
        admitted = {r.rid for r in eng.slots if r is not None}
        eng.run_to_completion(max_ticks=5_000)
        return admitted

    admitted, _, _ = _both(scenario)
    assert admitted == {1, 3}


@pytest.mark.parametrize("cap", [None, 1])
def test_prefill_chunk_cap_bounds_decode_gap(cap):
    def scenario(eng, R):
        rng = np.random.default_rng(5)
        decode = R(rid=0, prompt=rng.integers(1, 256, size=8).astype(
            np.int32), max_new_tokens=40)
        eng.add_request(decode)
        while eng._pending:
            eng.step()
        for rid in (1, 2):
            eng.add_request(R(rid=rid, prompt=rng.integers(
                1, 256, size=32).astype(np.int32), max_new_tokens=2))
        eng.run_to_completion(max_ticks=5_000)
        return eng.stats.prefill_burst_max

    burst, _, _ = _both(scenario, batch=3,
                        sched=dict(prefill_chunks_per_tick=cap))
    assert burst == 1 if cap == 1 else burst >= 2


def test_reset_clears_scheduler_and_spec_state():
    def scenario(eng, R):
        reqs = _requests(R)
        for r in reqs:
            eng.add_request(r)
        while not any(r is not None and r.out_tokens for r in eng.slots):
            eng.step()
        victim = next(i for i, r in enumerate(eng.slots)
                      if r is not None and r.out_tokens)
        eng.preempt(victim, mode="swap")
        eng.run_to_completion(max_ticks=5_000)
        s = eng.stats
        assert s.spec_steps > 0 and s.draft_tokens > 0
        assert s.preemptions == 1 and s.swap_outs == 1
        first = _outs(reqs)
        eng.reset()
        s = eng.stats
        assert (s.spec_steps, s.draft_tokens, s.draft_accepted) == (0, 0, 0)
        assert (s.preemptions, s.swap_outs, s.swap_ins,
                s.swap_bytes) == (0,) * 4
        assert not eng._resume and len(eng.host_tier) == 0
        assert not np.asarray(eng.keys).any()
        got = _drain(eng, R)
        eng.reset()
        assert _drain(eng, R) == got
        return first, got

    _both(scenario, sampling="sampled", spec=True)


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

def _chaos(seed, mode, preempt=0.5, exhaust=0.3, corrupt=0.4, latency=0.0,
           **req_kw):
    def scenario(eng, R):
        reqs = _requests(R, **req_kw)
        C, CC = (TChaos, TChaosConfig) if R is TRequest else (JChaos,
                                                               JChaosConfig)
        ch = C(eng, CC(seed=seed, preempt_prob=preempt, exhaust_prob=exhaust,
                       corrupt_prob=corrupt, swap_latency_s=latency,
                       mode=mode))
        for r in reqs:
            ch.add_request(r)
        ch.run_to_completion()
        if eng.host_tier is not None:
            eng.host_tier.latency_s = 0.0
        return _outs(reqs), ch.faults, ch.exhausts, ch.corruptions
    return scenario


# (pair keywords, whether the reference's tests claim the undisturbed
# tokens under chaos)
CHAOS_STACKS = {
    "paged": (dict(), True),
    "paged-int8": (dict(kv="int8"), False),
    "dense": (dict(backend="dense"), False),
    "sampled": (dict(sampling="sampled"), True),
    "spec": (dict(spec=True), False),
    "ring": (dict(arch="gemma2-27b"), False),
}


@pytest.mark.parametrize("seed", [5, 13])
@pytest.mark.parametrize("mode", [None, "swap", "recompute"])
@pytest.mark.parametrize("stack", list(CHAOS_STACKS))
def test_chaos_drain_matches_reference(stack, mode, seed):
    kw, claimed = CHAOS_STACKS[stack]
    (outs, faults, _, _), _, (_, teng) = _both(_chaos(seed, mode), **kw)
    assert faults > 0 and teng.stats.preemptions > 0
    if claimed:
        assert outs == _undisturbed(**kw)


def test_chaos_swap_latency_injection():
    ref = _undisturbed()
    (outs, _, _, _), _, (_, teng) = _both(
        _chaos(11, "swap", corrupt=0.0, exhaust=0.0, latency=0.002))
    assert outs == ref and teng.host_tier.latency_s == 0.0
    assert teng.stats.swap_ins > 0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
@pytest.mark.parametrize("seed", [5, 13])
@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_recurrent_recompute_matches_reference_preempted_drain(arch, seed,
                                                               mode):
    """Recurrent state resumes from the prefill scan over the context,
    not from decode steps: held to the reference's preempted drain (a
    forced swap recomputes too: these stacks hold no tier)."""
    (outs, faults, _, _), _, (_, teng) = _both(
        _chaos(seed, mode, corrupt=0.0), arch=arch)
    assert faults > 0 and teng.host_tier is None
    st = teng.stats
    assert st.swap_outs == 0 and st.recompute_resumes > 0
    assert all(len(t) == 8 for t in outs.values())


# ---------------------------------------------------------------------------
# the hand-off between engines
# ---------------------------------------------------------------------------

def _prefilled(eng, R, seed=13, max_new=8):
    req = _requests(R, seed=seed, n=1, new=max_new)[0]
    eng.add_request(req)
    while 0 in eng._pending or eng.slots[0] is None:
        eng._admit()
    return req


def test_export_preconditions():
    def scenario(eng, R):
        with pytest.raises(ValueError, match="empty slot"):
            eng.export_finished_prefill(0)
        req = _requests(R, seed=13, n=1)[0]
        eng.add_request(req)
        eng._admit()
        assert 0 in eng._pending
        with pytest.raises(ValueError, match="mid-prefill"):
            eng.export_finished_prefill(0)
        while 0 in eng._pending:
            eng._admit()
        assert len(req.out_tokens) == 1
        eng.decode_many(1)
        with pytest.raises(ValueError, match="decode must not have begun"):
            eng.export_finished_prefill(0)
        eng.run_to_completion()
        return list(req.out_tokens)

    _both(scenario)

    def noswap(eng, R):
        _prefilled(eng, R)
        with pytest.raises(ValueError, match="host swap tier"):
            eng.export_finished_prefill(0)
        eng.run_to_completion()
        return eng.host_tier is None

    assert _both(noswap, sched=dict(swap=False))[0] is True


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_export_import_drains_to_the_colocated_stream(kv, corrupt):
    """A prefill exported from one engine and imported by another decodes
    the colocated drain's tokens; a transfer damaged in transit is caught
    by the checksum and recomputed."""
    from repro.serve.hosttier import corrupt_entry as j_corrupt
    from repro_torch.serve.hosttier import corrupt_entry as t_corrupt

    jsrc, tsrc = _pair(kv=kv)
    jdst, tdst = _pair(kv=kv, prefix_cache=False)
    got = {}
    for src, dst, R, corrupt_entry in ((jsrc, jdst, JRequest, j_corrupt),
                                       (tsrc, tdst, TRequest, t_corrupt)):
        req = _prefilled(src, R)
        shipped, entry = src.export_finished_prefill(0)
        assert shipped is req and int(entry.length) == len(req.prompt)
        assert all(s is None for s in src.slots)
        if corrupt:
            corrupt_entry(entry)
        dst.import_prefill(req, entry)
        dst.run_to_completion()
        got[R] = (list(req.out_tokens), entry.nbytes, entry.n_pages,
                  dataclasses.asdict(src.stats), dataclasses.asdict(dst.stats))
    assert got[TRequest][:3] == got[JRequest][:3]
    for side in (3, 4):
        for f in FIELDS:
            assert got[TRequest][side][f] == got[JRequest][side][f], (side, f)
    # the transfer carries every layer's k/v (and scale lanes) of the
    # pages padded to a power of two
    n_pages = got[TRequest][2]
    assert got[TRequest][1] == next_pow2(n_pages) * tsrc.bytes_per_page
    tsrc_st, tdst_st = got[TRequest][3], got[TRequest][4]
    assert tsrc_st["prefill_exports"] == 1 and tdst_st["swap_ins"] == 0
    assert tdst_st["prefill_imports"] == (0 if corrupt else 1)
    assert tdst_st["transfer_fallbacks"] == (1 if corrupt else 0)
    _, colocated = _pair(kv=kv)
    assert got[TRequest][0] == _drain(colocated, TRequest, seed=13, n=1)[0]


def test_import_preconditions():
    _, tsrc = _pair()
    req = _prefilled(tsrc, TRequest)
    _, entry = tsrc.export_finished_prefill(0)
    _, noswap = _pair(sched=dict(swap=False))
    with pytest.raises(ValueError, match="host swap tier"):
        noswap.import_prefill(req, entry)
    _, dst = _pair(prefix_cache=False)
    short = TRequest(rid=req.rid, prompt=req.prompt[:4].copy(),
                     max_new_tokens=4)
    short.out_tokens.append(req.out_tokens[0])
    with pytest.raises(ValueError, match="prompt holds"):
        dst.import_prefill(short, entry)
    decoded = TRequest(rid=req.rid, prompt=req.prompt.copy(),
                       max_new_tokens=8)
    decoded.out_tokens.extend([1, 2])
    with pytest.raises(ValueError, match="exactly the seed token"):
        dst.import_prefill(decoded, entry)


def test_evacuate_survives_lost_host_tier():
    want = _undisturbed()
    got = {}
    for R, Res, eng1, eng2 in (
            (JRequest, JResume, _pair(sched=dict(swap=False))[0],
             _pair(prefix_cache=False)[0]),
            (TRequest, TResume, _pair(sched=dict(swap=False))[1],
             _pair(prefix_cache=False)[1])):
        assert eng1.host_tier is None
        reqs = _requests(R)
        for r in reqs:
            eng1.add_request(r)
        for _ in range(3):
            eng1.step()
        mid = [i for i, r in enumerate(eng1.slots)
               if r is not None and r.out_tokens and not r.done]
        assert mid
        eng1.preempt(mid[0], mode="recompute")
        rid = eng1.queue[-1].rid
        res = eng1._resume[rid]
        eng1._resume[rid] = Res("swap", res.ctx, res.pending)
        moved = eng1.evacuate()
        assert not eng1.queue and all(s is None for s in eng1.slots)
        for r in moved:
            eng2.adopt(r)
        eng2.run_to_completion()
        got[R] = (_outs(reqs), dataclasses.asdict(eng1.stats),
                  dataclasses.asdict(eng2.stats))
        assert eng2.stats.recompute_resumes >= 1
    assert got[TRequest][0] == got[JRequest][0] == want
    for side in (1, 2):
        for f in FIELDS:
            assert got[TRequest][side][f] == got[JRequest][side][f], (side, f)


def test_adopt_finished_request_is_noop():
    _, eng = _pair()
    req = _requests(TRequest, n=1, new=4)[0]
    eng.add_request(req)
    eng.run_to_completion()
    tokens = list(req.out_tokens)
    assert req.done and len(tokens) == 4
    _, other = _pair(prefix_cache=False)
    other.adopt(req)
    assert not other.queue
    other.run_to_completion()
    assert list(req.out_tokens) == tokens and other.stats.tokens_out == 0


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_evacuate_adopt_midstream_is_bitwise(sampling):
    ref = _undisturbed(sampling=sampling)
    got = {}
    for R, side in ((JRequest, 0), (TRequest, 1)):
        e1 = _pair(sampling=sampling)[side]
        e2 = _pair(sampling=sampling, prefix_cache=False)[side]
        reqs = _requests(R)
        for r in reqs:
            e1.add_request(r)
        for _ in range(3):
            e1.step()
        assert any(r.out_tokens for r in reqs)
        moved = e1.evacuate()
        assert not e1.queue and all(s is None for s in e1.slots)
        assert {r.rid for r in moved} == {r.rid for r in reqs if not r.done}
        for r in moved:
            e2.adopt(r)
        e2.run_to_completion()
        assert e2.stats.recompute_resumes >= 1
        got[R] = (_outs(reqs), dataclasses.asdict(e2.stats),
                  np.asarray(e2.keys).astype(np.int64))
    assert got[TRequest][0] == got[JRequest][0] == ref
    for f in FIELDS:
        assert got[TRequest][1][f] == got[JRequest][1][f], f
    np.testing.assert_array_equal(got[TRequest][2], got[JRequest][2])


# ---------------------------------------------------------------------------
# the engine's own cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_engine_cost_model_reads_the_card(backend):
    """Left to itself the port prices on the H100 and its host link, with
    the reference's byte counts for weights and KV rows."""
    jb, jparams, tb, tparams = _model("gemma-2b")
    jeng = JServeEngine(jb, jparams, batch_size=BATCH, max_len=MAX_LEN,
                        cache_backend=backend, prefill_chunk=CHUNK)
    kw = dict(page_size=jeng.page) if backend == "paged" else {}
    teng = TServeEngine(tb, tparams, BATCH, MAX_LEN, cache_backend=backend,
                        prefill_chunk=CHUNK, device="cpu", **kw)
    jcm, tcm = jeng._cost_model(), teng._cost_model()
    assert tcm.spec == H100 and tcm.host_link_bw == HOST_LINK_BW == 64e9
    for name in ("weight_bytes", "kv_bytes_per_token", "prefill_chunk"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    assert (teng.host_tier is not None) == (jeng.host_tier is not None)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_priority_mixed_admits_high_first(monkeypatch, capsys):
    """``--priority mixed`` drains smoke gemma-2b on the CPU with odd rids
    high: they are admitted first, and every request meets its budget."""
    from repro_torch.launch import serve as launch_serve

    admitted, engines = [], []

    class Recording(launch_serve.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

        def _paged_admit_slot(self, slot, req):
            super()._paged_admit_slot(slot, req)
            admitted.append((req.rid, req.priority))

    monkeypatch.setattr(launch_serve, "ServeEngine", Recording)
    assert launch_serve.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--requests", "6", "--batch", "2",
                              "--max-new", "4", "--priority", "mixed"]) == 0
    out = capsys.readouterr().out
    assert "24 tokens" in out and "priority=mixed" in out
    assert [p for _, p in admitted] == [1, 1, 1, 0, 0, 0]
    assert [rid for rid, _ in admitted] == [1, 3, 5, 0, 2, 4]
    assert engines[0].stats.preemptions == 0
