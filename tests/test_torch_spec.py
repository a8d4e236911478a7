"""Sampled and speculative serving of the port against the reference on
the CPU.

- ``PageAllocator.truncate`` over random operation sequences (reserve,
  attach, fork, pin, truncate, release; full and ring pools): the
  reference's tables, lengths, free lists, refcounts and returns;
- ``paged_verify``: float32 logits at every position allclose to the
  reference's (native and int8 pages), and row i allclose to what
  ``paged_decode_step`` gives after the same prefix;
- sampled drains (bridged weights, ``fold_in(PRNGKey(seed), rid)`` keys)
  through both engines on ``test_torch_serve.py``'s mixes: paged with
  native and int8 pages, and dense: token for token and key for key;
- speculative drains with a draft whose weights come from another seed
  (``PRNGKey(11)`` against the target's ``PRNGKey(7)``), greedy and
  sampled, native and int8 pages: equal to the port's vanilla drain and to
  the reference's speculative drain, with the reference's ``spec_steps``,
  ``draft_tokens`` and ``draft_accepted``; speculative rounds are asserted
  only where some request's budget is over 1 token (a budget of 1 is met
  by prefill);
- after every paged drain the allocator conserves pages;
- ``_init_spec``'s refusals, the greedy engine's untouched keys, and
  ``reset()`` clearing keys and the draft's cache.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.serve import kvcache as j_kv
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import kvcache as t_kv
from repro_torch.serve import prng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.sampling import subkey_chain
from test_torch_serve import MIXES, _dense_mix, _drive, _mix

TOL = 1e-4
BATCH, MAX_LEN, CHUNK, SPEC_K, SEED = 2, 64, 8, 3, 3
SAMPLED = dict(temperature=0.9, top_p=0.95)
SAMPLINGS = {"greedy": {}, "sampled": SAMPLED,
             "top-k": dict(temperature=0.8, top_k=50)}


# ---------------------------------------------------------------------------
# truncate
# ---------------------------------------------------------------------------

def _alloc_state(a):
    return (dict(a.tables), dict(a.lengths), list(a.free), dict(a.ref),
            sorted(a.pinned))


def _random_ops(seed, n=60):
    """A random operation sequence over rids 0..3: the op, its rid and a
    length (attach and fork read the source rid from the length)."""
    rng = np.random.default_rng(seed)
    names = ["alloc", "reserve", "reserve", "truncate", "truncate",
             "release", "fork", "pin"]
    return [(names[int(rng.integers(len(names)))], int(rng.integers(4)),
             int(rng.integers(0, 40))) for _ in range(n)]


def _apply_op(a, op):
    name, rid, n = op
    if name == "alloc":
        return a.alloc(rid)
    if name == "reserve":
        return a.reserve(rid, a.lengths[rid] + n)
    if name == "truncate":
        return a.truncate(rid, max(0, a.lengths[rid] - n))
    if name == "release":
        return a.release(rid)
    if name == "fork":
        return a.fork(n % 4, rid)
    table = a.tables[rid]            # pin: the rid's first page
    return a.pin(table[0]) if table else None


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("seed", range(8))
def test_truncate_sequences_match_reference(seed, window):
    ja = j_kv.PageAllocator(14, 4, reserved=1, window=window)
    ta = t_kv.PageAllocator(14, 4, reserved=1, window=window)
    errors = (KeyError, ValueError, j_kv.PoolExhausted, t_kv.PoolExhausted)
    truncated = 0
    for op in _random_ops(seed):
        outs = []
        for a in (ja, ta):
            try:
                outs.append(("ok", _apply_op(a, op)))
            except errors as e:
                outs.append((type(e).__name__,))
        assert outs[1] == outs[0], op
        assert _alloc_state(ta) == _alloc_state(ja), op
        truncated += op[0] == "truncate" and outs[0][0] == "ok"
    assert truncated > 0
    assert ta.pages_in_use == ja.pages_in_use
    assert ta.pages_in_use + len(ta.free) == ta.num_pages - ta.reserved


def test_truncate_frees_only_the_last_reference():
    a = t_kv.PageAllocator(10, 4, reserved=1)
    a.alloc(0)
    a.reserve(0, 12)                       # pages 1, 2, 3
    a.fork(0, 1)                           # all three shared
    assert a.truncate(0, 5) == []          # page 3 detached, still rid 1's
    assert a.tables[0] == [1, 2] and a.ref[3] == 1
    # rid 1 held page 3's last reference; page 2 stays rid 0's
    assert a.truncate(1, 4) == [3]
    assert a.tables[1] == [1] and a.ref[1] == 2 and a.ref[2] == 1
    with pytest.raises(ValueError, match="exceeds"):
        a.truncate(1, 9)
    ring = t_kv.PageAllocator(10, 4, reserved=1, window=8)
    ring.alloc(0)
    ring.reserve(0, 30)
    table = list(ring.tables[0])
    assert ring.truncate(0, 3) == [] and ring.tables[0] == table
    assert ring.lengths[0] == 3


# ---------------------------------------------------------------------------
# models and engines
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(arch, kv="native", seed=7):
    """(reference bundle, params, port bundle, params) with bridged
    weights drawn by ``jax.random.PRNGKey(seed)``."""
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


_ENGINES = {}


def _engines(kv, sampling, spec=False, num_pages=None, backend="paged"):
    """(reference engine, port engine) over gemma-2b's smoke config
    (phi4-mini's for the dense backend), cached and reset per drain."""
    key = (kv, sampling, spec, num_pages, backend)
    if key not in _ENGINES:
        arch = "gemma-2b" if backend == "paged" else "phi4-mini-3.8b"
        jb, jparams, tb, tparams = _model(arch, kv)
        jkw, tkw = {}, {}
        if spec:
            jdb, jdparams, tdb, tdparams = _model(arch, kv, seed=11)
            jkw = dict(draft_bundle=jdb, draft_params=jdparams, spec_k=SPEC_K)
            tkw = dict(draft_bundle=tdb, draft_params=tdparams, spec_k=SPEC_K)
        jeng = JServeEngine(jb, jparams, batch_size=BATCH, max_len=MAX_LEN,
                            cache_backend=backend, prefill_chunk=CHUNK,
                            num_pages=num_pages,
                            sampling=JSP(**SAMPLINGS[sampling]), seed=SEED,
                            **jkw)
        if backend == "paged":
            tkw.update(page_size=jeng.page, num_pages=num_pages)
        teng = TServeEngine(tb, tparams, BATCH, MAX_LEN,
                            cache_backend=backend, prefill_chunk=CHUNK,
                            sampling=TSP(**SAMPLINGS[sampling]), seed=SEED,
                            device="cpu", **tkw)
        _ENGINES[key] = (jeng, teng)
    return _ENGINES[key]


def _conserves_pages(eng):
    a = eng.alloc
    assert a.pages_in_use + len(a.free) == a.num_pages - a.reserved
    assert sorted(a.free) == a.free and 0 not in a.free
    assert not a.tables and not a.lengths
    assert set(a.ref) == a.pinned and all(r == 1 for r in a.ref.values())


def _keys(eng):
    return np.asarray(eng.keys).astype(np.int64)


def _holds_request_keys(eng, outs):
    """Every slot's key is the key some drained request ends on: its
    admission key ``fold_in(PRNGKey(SEED), rid)`` split once per emitted
    token (which request a slot served last depends on the schedule,
    which speculative rounds change)."""
    base = prng.prng_key(SEED)
    final = set()
    for rid, toks in enumerate(outs):
        _, carried = subkey_chain(prng.fold_in(base, rid)[None], len(toks))
        final.add(tuple(carried[0, -1].tolist()))
    assert {tuple(k) for k in eng.keys.tolist()} <= final


# ---------------------------------------------------------------------------
# sampled drains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("kv", ["native", "int8"])
def test_sampled_paged_drain_matches_reference(kv, name):
    waves, num_pages = _mix(name)
    jeng, teng = _engines(kv, "sampled", num_pages=num_pages)
    want = _drive(jeng, JRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    assert np.array_equal(teng.keys.numpy(), _keys(jeng))
    assert teng.keys.any()
    _holds_request_keys(teng, got)
    for field in ("decode_steps", "decode_dispatches", "tokens_out",
                  "prefill_chunks", "prefix_hit_tokens", "pool_stalls"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert jeng.stats.preemptions == 0
    _conserves_pages(teng)


@pytest.mark.parametrize("name", MIXES[:2])
def test_top_k_paged_drain_matches_reference(name):
    waves, num_pages = _mix(name)
    jeng, teng = _engines("native", "top-k", num_pages=num_pages)
    want = _drive(jeng, JRequest, waves)
    assert _drive(teng, TRequest, waves) == want
    assert np.array_equal(teng.keys.numpy(), _keys(jeng))


@pytest.mark.parametrize("name", ["queueing", "varied-lengths", "budget-1"])
def test_sampled_dense_drain_matches_reference(name):
    waves = _dense_mix(name)
    jeng, teng = _engines("native", "sampled", backend="dense")
    want = _drive(jeng, JRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    assert np.array_equal(teng.keys.numpy(), _keys(jeng))
    for field in ("decode_steps", "decode_dispatches", "tokens_out"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


def test_greedy_engine_consumes_no_prng_state():
    waves, num_pages = _mix("queueing")
    _, teng = _engines("native", "greedy", num_pages=num_pages)
    _drive(teng, TRequest, waves)
    assert teng.stats.tokens_out > 0 and not teng.keys.any()


# ---------------------------------------------------------------------------
# speculative drains
# ---------------------------------------------------------------------------

SPEC_COUNTERS = ("spec_steps", "draft_tokens", "draft_accepted",
                 "decode_steps", "decode_dispatches", "tokens_out",
                 "prefill_chunks", "prefix_hit_tokens", "prefill_retraces")


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("kv", ["native", "int8"])
def test_spec_drain_matches_vanilla_and_reference(kv, sampling, name):
    waves, num_pages = _mix(name)
    _, vanilla = _engines(kv, sampling, num_pages=num_pages)
    jeng, teng = _engines(kv, sampling, spec=True, num_pages=num_pages)
    jeng._seen_prefill_shapes.clear()   # count every shape in both drains
    teng._seen_prefill_shapes.clear()
    want = _drive(vanilla, TRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    if sampling == "sampled":
        _holds_request_keys(vanilla, want)
        _holds_request_keys(teng, got)
    assert _drive(jeng, JRequest, waves) == got
    assert np.array_equal(teng.keys.numpy(), _keys(jeng))
    for field in SPEC_COUNTERS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert jeng.stats.preemptions == 0
    budgets = [n for wave in waves for _, n in wave]
    if max(budgets) > 1:
        assert teng.stats.spec_steps > 0
        assert 0 <= teng.stats.draft_accepted <= teng.stats.draft_tokens
    else:                          # prefill meets every budget (C1)
        assert teng.stats.spec_steps == 0
    assert teng.stats.accept_rate == jeng.stats.accept_rate
    assert teng.stats.accepted_per_step == jeng.stats.accepted_per_step
    _conserves_pages(teng)


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_self_draft_accepts_every_proposal(sampling):
    """A draft that is the target accepts every proposal a budget can
    take: here every request's decode budget (max_new - 1) leaves a last
    round of 3 or 4 tokens, so none is cut short."""
    jb, jparams, tb, tparams = _model("gemma-2b")
    sp = SAMPLINGS[sampling]
    jeng = JServeEngine(jb, jparams, batch_size=BATCH, max_len=MAX_LEN,
                        cache_backend="paged", prefill_chunk=CHUNK,
                        draft_bundle=jb, draft_params=jparams, spec_k=SPEC_K,
                        sampling=JSP(**sp), seed=SEED)
    eng = TServeEngine(tb, tparams, BATCH, MAX_LEN, prefill_chunk=CHUNK,
                       page_size=jeng.page, draft_bundle=tb,
                       draft_params=tparams, spec_k=SPEC_K,
                       sampling=TSP(**sp), seed=SEED, device="cpu")
    rng = np.random.default_rng(9)
    waves = ([(rng.integers(0, 256, size=n).astype(np.int32), b)
              for n, b in zip([5, 19, 11, 27], [9, 5, 8, 12])], [])
    got = _drive(eng, TRequest, waves)
    assert _drive(jeng, JRequest, waves) == got
    _, vanilla = _engines("native", sampling)
    assert _drive(vanilla, TRequest, waves) == got
    st = eng.stats
    assert st.spec_steps > 0 and st.draft_tokens > 0
    assert st.accept_rate == 1.0 and st.draft_accepted == st.draft_tokens
    for field in SPEC_COUNTERS[:3]:
        assert getattr(st, field) == getattr(jeng.stats, field), field
    _conserves_pages(eng)


def test_reset_clears_keys_and_the_draft_cache():
    _, teng = _engines("native", "sampled", spec=True)
    waves, _ = _mix("queueing")
    _drive(teng, TRequest, waves)
    assert teng.keys.any()
    assert any(t.any() for t in _leaves(teng.draft_cache))
    teng.reset()
    assert not teng.keys.any()
    assert not any(t.any() for t in _leaves(teng.draft_cache))
    assert teng.stats.spec_steps == teng.stats.draft_tokens == 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _refusal(case):
    """(target arch, engine kwargs) for a refused speculative engine."""
    _, _, tb, tparams = _model("gemma-2b")
    if case == "no-draft-params":
        return "gemma-2b", dict(draft_bundle=tb, draft_params=None)
    if case == "dense-backend":
        return "gemma-2b", dict(draft_bundle=tb, draft_params=tparams,
                                cache_backend="dense")
    if case == "ring-target":
        return "gemma2-27b", dict(draft_bundle=tb, draft_params=tparams)
    if case == "vocab":
        other = t_build(override(tb.cfg, vocab_size=512), device="cpu")
        return "gemma-2b", dict(draft_bundle=other, draft_params=tparams)
    _, _, rb, rparams = _model("gemma2-27b")
    return "gemma-2b", dict(draft_bundle=rb, draft_params=rparams)


REFUSALS = {"no-draft-params": "draft_params", "dense-backend": "paged",
            "ring-target": "full-attention", "vocab": "vocab",
            "windowed-draft": "full-attention"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_init_spec_refusals(case):
    arch, kw = _refusal(case)
    _, _, tb, tparams = _model(arch)
    if case == "vocab":
        assert kw["draft_bundle"].cfg.vocab_size != tb.cfg.vocab_size
    with pytest.raises(ValueError, match=REFUSALS[case]):
        TServeEngine(tb, tparams, BATCH, MAX_LEN, device="cpu", **kw)


def test_draft_on_another_device_is_refused():
    _, _, tb, tparams = _model("gemma-2b")
    meta = t_build(tb.cfg, device="meta")
    with pytest.raises(ValueError, match="draft runs on"):
        TServeEngine(tb, tparams, BATCH, MAX_LEN, device="cpu",
                     draft_bundle=meta, draft_params=tparams)


# ---------------------------------------------------------------------------
# paged_verify
# ---------------------------------------------------------------------------

def _verify_setup(kv):
    """Both bundles, a pool with two prompts (13 and 6 tokens) prefilled
    through chunked prefill, the page tables, and the verify burst."""
    import jax.numpy as jnp
    from repro.tune.plan import derive_paged_plan

    jb, jparams, tb, tparams = _model("gemma-2b", kv)
    cfg = tb.cfg
    page = derive_paged_plan(max_len=MAX_LEN, head_dim=cfg.resolved_head_dim,
                             dtype="int8" if kv == "int8" else "float32"
                             ).page_size
    n = MAX_LEN // page
    table = np.zeros((2, n), np.int32)
    table[0] = np.arange(1, n + 1)
    table[1] = np.arange(n + 1, 2 * n + 1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=s) for s in (13, 6)]
    jcache = jb.init_paged_cache(2 * n + 1, page, batch=2)
    tcache = tb.init_paged_cache(2 * n + 1, page)
    for b, p in enumerate(prompts):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        jcache, _ = jb.paged_prefill_chunk(
            jparams, jcache, jnp.asarray(toks), jnp.asarray([0], jnp.int32),
            dict(full=jnp.asarray(table[b:b + 1])),
            jnp.asarray([len(p)], jnp.int32))
        tcache, _ = tb.paged_prefill_chunk(
            tparams, tcache, torch.from_numpy(toks.astype(np.int64)),
            torch.tensor([0], dtype=torch.int32),
            dict(full=torch.from_numpy(table[b:b + 1])),
            torch.tensor([len(p)], dtype=torch.int32))
    burst = rng.integers(0, cfg.vocab_size, size=(2, SPEC_K + 1))
    pos = np.asarray([len(p) for p in prompts], np.int32)
    return jb, jparams, tb, tparams, jcache, tcache, table, burst, pos, page


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_paged_verify_logits_match_reference(kv):
    import jax.numpy as jnp

    (jb, jparams, tb, tparams, jcache, tcache, table, burst, pos,
     page) = _verify_setup(kv)
    cv = np.asarray([SPEC_K + 1, 2], np.int32)
    _, jlogits = jb.paged_verify(
        jparams, jcache, jnp.asarray(burst, jnp.int32), jnp.asarray(pos),
        dict(full=jnp.asarray(table)), jnp.asarray(cv))
    _, tlogits = tb.paged_verify(
        tparams, tcache, torch.from_numpy(burst), torch.from_numpy(pos),
        dict(full=torch.from_numpy(table)), torch.from_numpy(cv))
    assert tlogits.shape == (2, SPEC_K + 1, tb.cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_paged_verify_rows_equal_serial_decode(kv):
    """Row i of one verify pass against i+1 single-token decode ticks over
    the same pages."""
    import copy

    (_, _, tb, tparams, _, tcache, table, burst, pos,
     page) = _verify_setup(kv)
    tbl = dict(full=torch.from_numpy(table))
    cv = torch.full((2,), SPEC_K + 1, dtype=torch.int32)
    _, vlogits = tb.paged_verify(tparams, copy.deepcopy(tcache),
                                 torch.from_numpy(burst),
                                 torch.from_numpy(pos), tbl, cv)
    cache = tcache
    for i in range(SPEC_K + 1):
        logits, cache = tb.paged_decode_step(
            tparams, cache, torch.from_numpy(burst[:, i:i + 1]),
            torch.from_numpy(pos + i), tbl)
        np.testing.assert_allclose(vlogits[:, i].numpy(), logits.numpy(),
                                   rtol=TOL, atol=TOL)


def test_paged_verify_refuses_a_plan_for_another_page():
    from repro_torch.tune import plan_for

    (_, _, tb, tparams, _, tcache, table, burst, pos,
     page) = _verify_setup("native")
    plan = plan_for("paged_verify", shape_sig=(SPEC_K + 1, 4096, 8),
                    dtype="float32")
    assert plan.page_size != page
    with pytest.raises(ValueError, match="verify plan"):
        tb.paged_verify(tparams, tcache, torch.from_numpy(burst),
                        torch.from_numpy(pos),
                        dict(full=torch.from_numpy(table)),
                        torch.full((2,), 2, dtype=torch.int32), plan)
