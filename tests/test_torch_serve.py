"""The port's ServeEngine against the reference's, on the CPU.

Paged: both engines serve the same bridged weights (gemma-2b's smoke
config in float32) and the same request mixes, greedy.  The drains must be
token for token identical, with the same scheduling counters: prefix hits,
prefill chunks and decode windows.  The port's page size is pinned to the
one the reference engine derived.  After every drain the port's allocator
must conserve pages: every page is free or referenced, and what stays
referenced is exactly the prefix cache's pins.

Dense: phi4-mini's smoke config through both engines with
``cache_backend="dense"``, prefill attention ``chunked`` and ``pallas``
(blocks pinned at 16 on both sides), on mixes that queue, vary the prompt
length across buckets up to ``max_len``, and meet budgets of 1 by prefill
alone; tokens and counters (prefills and prefill shapes included) equal.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags as JRuntimeFlags
from repro.models import build as j_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import RuntimeFlags as TRuntimeFlags
from repro_torch.models import build as t_build
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve.kvcache import PoolExhausted

BATCH, MAX_LEN, CHUNK = 2, 64, 8
_MODELS = {}
_ENGINES = {}


def _models():
    if not _MODELS:
        jcfg = j_smoke(J_ARCHS["gemma-2b"])
        tcfg = t_smoke(T_ARCHS["gemma-2b"])
        jb = j_build(jcfg)
        jparams = jb.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _MODELS.update(jcfg=jcfg, jb=jb, jparams=jparams,
                       tb=t_build(tcfg, device="cpu"), tparams=tparams)
    return _MODELS


def _engines(num_pages=None):
    """(reference engine, port engine) sharing one pool geometry; cached
    per pool size, reset before each drain."""
    if num_pages not in _ENGINES:
        m = _models()
        jeng = JServeEngine(m["jb"], m["jparams"], batch_size=BATCH,
                            max_len=MAX_LEN, cache_backend="paged",
                            prefill_chunk=CHUNK, num_pages=num_pages)
        teng = TServeEngine(m["tb"], m["tparams"], BATCH, MAX_LEN,
                            prefill_chunk=CHUNK, page_size=jeng.page,
                            num_pages=num_pages, device="cpu")
        _ENGINES[num_pages] = (jeng, teng)
    return _ENGINES[num_pages]


def _drive(eng, make_request, waves):
    """Admit wave 0, tick three times so wave 1 lands mid-drain, drain."""
    eng.reset()
    reqs = []

    def admit(wave):
        for prompt, max_new in wave:
            r = make_request(rid=len(reqs), prompt=prompt,
                             max_new_tokens=max_new)
            reqs.append(r)
            eng.add_request(r)

    admit(waves[0])
    if waves[1]:
        for _ in range(3):
            eng.step()
        admit(waves[1])
    eng.run_to_completion(max_ticks=5_000)
    assert all(s is None for s in eng.slots)
    return [r.out_tokens for r in reqs]


def _prompts(seed, lens, prefix_len=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 256, size=prefix_len).astype(np.int32)
    return [np.concatenate([common, rng.integers(0, 256, size=n)
                            .astype(np.int32)]) for n in lens]


def _mix(name):
    """(waves, num_pages): wave = [(prompt, max_new)]."""
    if name == "queueing":        # five requests through two slots
        ps = _prompts(1, [3, 13, 21, 9, 30])
        return ([(p, n) for p, n in zip(ps, [5, 3, 7, 4, 6])], []), None
    if name == "shared-prefix":   # 17 shared tokens cross two pages
        first = _prompts(2, [4, 11], prefix_len=17)
        later = _prompts(3, [6, 1, 9], prefix_len=17)
        # the later wave shares the first wave's prefix
        later = [np.concatenate([first[0][:17], p[17:]]) for p in later]
        return ([(first[0], 6), (first[1], 4)],
                [(p, 5) for p in later]), None
    if name == "backpressure":
        # 9 usable pages of 8 tokens: the third prompt (6 pages) finds a
        # free slot but waits on the pool until the long decode releases
        ps = _prompts(4, [30, 10, 44])
        return ([(p, n) for p, n in zip(ps, [24, 1, 4])], []), 10
    if name == "budget-1":        # prefill alone meets every budget
        ps = _prompts(5, [5, 17, 8])
        return ([(p, 1) for p in ps], [(ps[0][:4], 1)]), None
    raise KeyError(name)


MIXES = ["queueing", "shared-prefix", "backpressure", "budget-1"]


@pytest.mark.parametrize("name", MIXES)
def test_greedy_drain_matches_reference(name):
    waves, num_pages = _mix(name)
    jeng, teng = _engines(num_pages)
    assert teng.page == jeng.page and teng.num_pages == jeng.num_pages
    want = _drive(jeng, JRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    budgets = [n for wave in waves for _, n in wave]
    assert [len(t) for t in got] == budgets
    for field in ("prefix_hit_tokens", "prefill_chunks", "decode_dispatches",
                  "decode_steps", "tokens_out", "prefills", "pool_stalls",
                  "pages_peak", "prefill_retraces"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    # the port leaves preemption out: the reference must not have used it
    assert jeng.stats.preemptions == 0
    if name == "shared-prefix":
        assert teng.stats.prefix_hit_tokens > 0
    if name == "backpressure":
        assert teng.stats.pool_stalls > 0

    a = teng.alloc
    assert a.pages_in_use + len(a.free) == a.num_pages - a.reserved
    assert sorted(a.free) == a.free and 0 not in a.free
    assert not a.tables and not a.lengths
    assert set(a.ref) == a.pinned and all(r == 1 for r in a.ref.values())
    assert a.pages_in_use == len(teng.prefix)


def test_pool_smaller_than_one_prompt_is_refused():
    _, teng = _engines(4)
    teng.reset()
    teng.add_request(TRequest(rid=0, prompt=np.arange(40, dtype=np.int32)))
    with pytest.raises(ValueError, match="num_pages"):
        teng.run_to_completion()


def test_every_slot_pool_blocked_raises():
    """Two requests that each outgrow half the pool while both are live:
    with preemption left out, the engine says so instead of spinning."""
    _, teng = _engines(5)
    teng.reset()
    for rid in range(2):
        teng.add_request(TRequest(rid=rid, prompt=np.arange(
            8 * rid, 8 * rid + 15, dtype=np.int32), max_new_tokens=20))
    with pytest.raises(PoolExhausted, match="pool-blocked"):
        teng.run_to_completion()


@pytest.mark.parametrize("max_len,head_dim,dtype", [
    (1024, 256, "bfloat16"), (64, 16, "float32"), (32, 16, "float32"),
    (4096, 128, "bfloat16"), (256, 64, "int8"), (16, 8, "float32")])
def test_page_rule_matches_reference(max_len, head_dim, dtype):
    from repro.tune.plan import derive_paged_plan as j_plan
    from repro_torch.tune import derive_paged_plan as t_plan
    want = j_plan(max_len=max_len, head_dim=head_dim, dtype=dtype)
    got = t_plan(max_len=max_len, head_dim=head_dim, dtype=dtype)
    assert got.page_size == want.page_size
    assert (got.kernel, got.bq, got.dtype, got.head_dim) == (
        want.kernel, want.bq, want.dtype, want.head_dim)
    if (max_len, head_dim, dtype) == (1024, 256, "bfloat16"):
        assert got.page_size == 8     # gemma-2b's pages on the card


# ---------------------------------------------------------------------------
# dense backend
# ---------------------------------------------------------------------------

_DENSE = {}


def _dense_engines(impl):
    """(reference engine, port engine), dense, phi4-mini smoke in float32;
    cached per prefill attention impl, reset before each drain."""
    if impl not in _DENSE:
        jcfg = j_smoke(J_ARCHS["phi4-mini-3.8b"])
        tcfg = t_smoke(T_ARCHS["phi4-mini-3.8b"])
        jb = j_build(jcfg, JRuntimeFlags(attn_impl=impl, attn_bq=16,
                                         attn_bkv=16))
        jparams = jb.init(jax.random.PRNGKey(1))
        tb = t_build(tcfg, TRuntimeFlags(attn_impl=impl, attn_bq=16,
                                         attn_bkv=16), device="cpu")
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _DENSE[impl] = (
            JServeEngine(jb, jparams, batch_size=BATCH, max_len=MAX_LEN,
                         cache_backend="dense"),
            TServeEngine(tb, tparams, BATCH, MAX_LEN, cache_backend="dense",
                         device="cpu"))
    return _DENSE[impl]


def _dense_mix(name):
    """waves = ([(prompt, max_new)], later wave)."""
    if name == "queueing":        # five requests through two slots
        ps = _prompts(6, [3, 13, 21, 9, 30])
        return [(p, n) for p, n in zip(ps, [5, 3, 7, 4, 6])], []
    if name == "varied-lengths":  # buckets 8, 8, 16, 64 and 64 = max_len
        ps = _prompts(7, [1, 8, 9, 33, 57])
        return ([(p, n) for p, n in zip(ps[:3], [4, 6, 3])],
                [(p, n) for p, n in zip(ps[3:], [5, 9])])
    if name == "budget-1":        # prefill alone meets every budget
        ps = _prompts(8, [5, 17, 8])
        return [(p, 1) for p in ps], [(ps[0][:4], 1)]
    raise KeyError(name)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", ["queueing", "varied-lengths", "budget-1"])
def test_dense_greedy_drain_matches_reference(name, impl):
    waves = _dense_mix(name)
    jeng, teng = _dense_engines(impl)
    assert teng.backend == jeng.backend == "dense"
    jeng._seen_prefill_shapes.clear()   # count every bucket in both drains
    teng._seen_prefill_shapes.clear()
    want = _drive(jeng, JRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    # the cache-length guard stops a request at max_len - 1 positions
    assert [len(t) for t in got] == [min(n, MAX_LEN - len(p))
                                     for wave in waves for p, n in wave]
    for field in ("prefills", "prefill_retraces", "decode_dispatches",
                  "decode_steps", "tokens_out", "prompt_tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert teng.stats.prefill_chunks == 0 and teng.stats.pages_peak == 0
    assert teng.kv_bytes() == jeng.kv_bytes()


def test_dense_drain_without_buckets_matches_reference():
    """bucket_prompts=False prefills each prompt at its own length: one
    prefill shape per distinct length, in both engines."""
    waves = _dense_mix("queueing")
    jb_eng, tb_eng = _dense_engines("chunked")
    jeng = JServeEngine(jb_eng.bundle, jb_eng.params, batch_size=BATCH,
                        max_len=MAX_LEN, cache_backend="dense",
                        bucket_prompts=False)
    teng = TServeEngine(tb_eng.bundle, tb_eng.params, BATCH, MAX_LEN,
                        cache_backend="dense", bucket_prompts=False,
                        device="cpu")
    want = _drive(jeng, JRequest, waves)
    assert _drive(teng, TRequest, waves) == want
    lengths = {len(p) for wave in waves for p, _ in wave}
    assert teng.stats.prefill_retraces == jeng.stats.prefill_retraces \
        == len(lengths)


def test_dense_engine_refuses_an_unknown_backend():
    _, teng = _dense_engines("chunked")
    with pytest.raises(ValueError, match="cache_backend"):
        TServeEngine(teng.bundle, teng.params, BATCH, MAX_LEN,
                     cache_backend="ring", device="cpu")
