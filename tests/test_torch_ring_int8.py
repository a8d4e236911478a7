"""Ring pages, softcaps and int8 KV held against the reference on the CPU.

- greedy drains through both engines, paged and dense, of smoke
  gemma2-27b (a (local, global) pair, window 16, both softcaps,
  ``query_pre_attn_scalar``) and of smoke gemma-2b with int8 KV, on mixes
  whose prompts run past the window while slots churn: token for token
  identical, with equal counters (pages and ring pages peaks, prefix hits,
  chunks, windows);
- ``_kv_quant``/``_kv_dequant`` exactly equal to the reference's;
- allocator operation sequences (ring growth and rotation, fork,
  copy-on-write, release, exhaustion) giving the reference's tables,
  lengths, free lists, refcounts and batch tables;
- float32 logits of smoke gemma2-27b (native and int8 KV) and
  internlm2-20b, dense and paged (ring tables included), allclose to the
  reference within 1e-4; naive attention over explicit ring positions;
- the two configs field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags as JFlags
from repro.models import attention as j_attn
from repro.models import build as j_build
from repro.models import transformer as j_tr
from repro.serve import kvcache as j_kv
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import attention as t_attn
from repro_torch.models import build as t_build
from repro_torch.models import transformer as t_tr
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import kvcache as t_kv

TOL = 1e-4
BATCH, MAX_LEN, CHUNK = 2, 64, 8
MODELS = {"gemma2-27b": ("gemma2-27b", "native"),
          "gemma-2b-int8": ("gemma-2b", "int8")}


@pytest.fixture(scope="module")
def models():
    """Reference and port bundles with the same (bridged) weights, built
    once per model."""
    out = {}
    for key, (arch, kv) in MODELS.items():
        jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
        jb = j_build(jcfg, JFlags(kv_dtype=kv))
        jparams = jb.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        out[key] = (jb, jparams, t_build(tcfg, TFlags(kv_dtype=kv),
                                         device="cpu"), tparams)
    return out


@pytest.fixture(scope="module")
def engines(models):
    """(reference engine, port engine) per (model, backend), built once
    and reset before every drain."""
    cache = {}

    def get(key, backend):
        if (key, backend) not in cache:
            jb, jparams, tb, tparams = models[key]
            jeng = JServeEngine(jb, jparams, batch_size=BATCH,
                                max_len=MAX_LEN, cache_backend=backend,
                                prefill_chunk=CHUNK)
            kw = dict(page_size=jeng.page) if backend == "paged" else {}
            teng = TServeEngine(tb, tparams, BATCH, MAX_LEN,
                                cache_backend=backend, prefill_chunk=CHUNK,
                                device="cpu", **kw)
            cache[key, backend] = (jeng, teng)
        return cache[key, backend]
    return get


def _prompts(seed, lens, prefix_len=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 256, size=prefix_len).astype(np.int32)
    return [np.concatenate([common, rng.integers(0, 256, size=n)
                            .astype(np.int32)]) for n in lens]


def _mix(name):
    """waves = ([(prompt, max_new)], later wave)."""
    if name == "churn":            # six requests through two slots
        ps = _prompts(11, [3, 21, 40, 17, 33, 9])
        return ([(p, n) for p, n in zip(ps[:4], [6, 9, 4, 20])],
                [(p, n) for p, n in zip(ps[4:], [5, 7])])
    if name == "past-the-window":  # every prompt and decode past 16 tokens
        ps = _prompts(12, [19, 47, 26])
        return [(p, n) for p, n in zip(ps, [12, 6, 25])], []
    if name == "shared-prefix":    # 40 shared tokens: a page of 32 int8
        first = _prompts(13, [5, 12], prefix_len=40)
        later = [np.concatenate([first[0][:40], p])
                 for p in _prompts(14, [3, 9])]
        return ([(first[0], 6), (first[1], 4)], [(p, 5) for p in later])
    if name == "budget-1":         # prefill alone meets every budget
        ps = _prompts(15, [5, 23, 8])
        return [(p, 1) for p in ps], [(ps[1][:18], 1)]
    raise KeyError(name)


MIXES = ["churn", "past-the-window", "shared-prefix", "budget-1"]


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


COUNTERS = ("prefix_hit_tokens", "prefill_chunks", "decode_dispatches",
            "decode_steps", "tokens_out", "prefills", "pool_stalls",
            "pages_peak", "ring_pages_peak", "prefill_retraces",
            "prompt_tokens")


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("backend", ["paged", "dense"])
@pytest.mark.parametrize("key", list(MODELS))
def test_greedy_drain_matches_reference(engines, key, backend, mix):
    jeng, teng = engines(key, backend)
    waves = _mix(mix)
    jeng._seen_prefill_shapes.clear()   # count every shape in both drains
    teng._seen_prefill_shapes.clear()
    want = _drive(jeng, JRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    for field in COUNTERS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert teng.kv_bytes() == jeng.kv_bytes()
    assert teng.live_kv_bytes_peak() == jeng.live_kv_bytes_peak()
    if backend == "dense":
        return
    assert teng.page == jeng.page and teng.bytes_per_page == \
        jeng.bytes_per_page
    assert jeng.stats.preemptions == 0
    if key == "gemma2-27b":
        assert teng.ring_slots == jeng.ring_slots == 3
        assert teng.stats.ring_pages_peak <= BATCH * teng.ring_slots
        if mix != "budget-1":
            assert teng.stats.ring_pages_reused > 0      # the ring turned
        a = teng.ralloc
        assert not a.tables and a.pages_in_use == 0 and 0 not in a.free
    else:
        assert teng.page == 32 and teng.stats.ring_pages_peak == 0
        if mix == "shared-prefix":
            assert teng.stats.prefix_hit_tokens > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 3, 16), (1, 7, 1, 256),
                                   (3, 1, 2, 8)])
def test_kv_quant_matches_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[0, 0] = 0.0                                  # a token of zeros
    # a token whose scale is exactly 1: ties round half to even
    x[-1, -1].reshape(-1)[:4] = [127.0, 63.5, -0.5, 2.5]
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = j_tr._kv_quant(jx)
    tq, ts = t_tr._kv_quant(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = j_tr._kv_dequant(jq, js, jnp.dtype(dtype))
    td = t_tr._kv_dequant(tq, ts, getattr(torch, dtype))
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# allocator sequences
# ---------------------------------------------------------------------------

def _state(a):
    return (dict(a.tables), dict(a.lengths), list(a.free), dict(a.ref),
            sorted(a.pinned))


def _kv(seed, n, hkv=1, d=4):
    x = np.random.default_rng(seed).standard_normal((n, hkv, d)).astype(
        np.float32)
    return x


# (name, allocator kwargs, ops); an op is (method, args...)
ALLOC_SEQS = [
    ("ring-growth", dict(num_pages=12, page_size=8, reserved=1, window=16),
     [("alloc", 0), ("reserve", 0, 5), ("reserve", 0, 20), ("alloc", 1),
      ("reserve", 1, 30), ("reserve", 0, 47), ("reserve", 0, 100),
      ("can_grow", 1, 200), ("release", 0), ("reserve", 1, 64)]),
    ("full-growth", dict(num_pages=6, page_size=4, reserved=1),
     [("alloc", 0), ("reserve", 0, 9), ("alloc", 1), ("reserve", 1, 4),
      ("can_grow", 1, 40), ("reserve", 1, 40), ("release", 0),
      ("reserve", 1, 16)]),
    ("fork-cow", dict(num_pages=10, page_size=4, reserved=1),
     [("alloc", 0), ("append", 0, 6), ("fork", 0, 1), ("append", 1, 3),
      ("append", 0, 5), ("release", 0), ("append", 1, 4), ("release", 1)]),
    ("ring-fork-rotate", dict(num_pages=12, page_size=4, reserved=1,
                              window=8),
     [("alloc", 0), ("append", 0, 10), ("fork", 0, 1), ("append", 1, 7),
      ("append", 0, 2), ("can_grow", 0, 40), ("release", 1),
      ("append", 0, 9)]),
    ("pin-and-exhaust", dict(num_pages=5, page_size=4, reserved=1),
     [("alloc", 0), ("append", 0, 8), ("pin", 1), ("release", 0),
      ("alloc", 1), ("append", 1, 13), ("unpin", 1), ("append", 1, 4)]),
]


def _apply(mod, a, op, seed):
    name, *args = op
    if name == "append":
        rid, n = args
        kv = _kv(seed, n)
        k = jnp.asarray(kv) if mod is j_kv else torch.from_numpy(kv)
        return a.append(rid, k, k * 2)
    return getattr(a, name)(*args)


@pytest.mark.parametrize("name,kw,ops", ALLOC_SEQS,
                         ids=[s[0] for s in ALLOC_SEQS])
def test_allocator_sequence_matches_reference(name, kw, ops):
    pools = []
    for mod in (j_kv, t_kv):
        if any(op[0] == "append" for op in ops):
            dev = dict(device="cpu") if mod is t_kv else {}
            pools.append(mod.PagedKVCache(num_kv_heads=1, head_dim=4, **kw,
                                          **dev))
        else:
            pools.append(mod.PageAllocator(**kw))
    ja, ta = pools
    assert ta.ring_slots == ja.ring_slots and ta.kind == ja.kind
    for i, op in enumerate(ops):
        outs = []
        for mod, a in ((j_kv, ja), (t_kv, ta)):
            try:
                outs.append(("ok", _apply(mod, a, op, i)))
            except (j_kv.PoolExhausted, t_kv.PoolExhausted) as e:
                outs.append(("exhausted", e.need_pages, e.free_pages))
        assert outs[1] == outs[0], op
        assert _state(ta) == _state(ja), op
        if hasattr(ja, "k_pages"):
            np.testing.assert_array_equal(ta.k_pages.numpy(),
                                          np.asarray(ja.k_pages))
            np.testing.assert_array_equal(ta.v_pages.numpy(),
                                          np.asarray(ja.v_pages))
            rids = sorted(ja.tables)
            if rids:
                jt, jv = ja.batch_view(rids)
                tt, tv = ta.batch_view(rids)
                np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ta.pages_in_use == ja.pages_in_use
    assert ta.live_tokens == ja.live_tokens


def test_ring_pool_smaller_than_one_prompt_is_refused(models):
    _, _, tb, tparams = models["gemma2-27b"]
    eng = TServeEngine(tb, tparams, BATCH, MAX_LEN, num_ring_pages=2,
                       device="cpu")
    eng.add_request(TRequest(rid=0, prompt=np.arange(40, dtype=np.int32)))
    with pytest.raises(ValueError, match="num_ring_pages"):
        eng.run_to_completion()


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

LOGIT_CASES = [("gemma2-27b", "native"), ("gemma2-27b", "int8"),
               ("internlm2-20b", "native")]


def _pair(arch, kv, seed):
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    jb = j_build(jcfg, JFlags(kv_dtype=kv))
    jparams = jb.init(jax.random.PRNGKey(seed))
    tb = t_build(tcfg, TFlags(kv_dtype=kv), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return tcfg, jb, jparams, tb, tparams


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch,kv", LOGIT_CASES)
def test_dense_logits_match_reference(arch, kv):
    """Prefill of a prompt past the window, then decode ticks."""
    tcfg, jb, jparams, tb, tparams = _pair(arch, kv, 5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (1, 23)).astype(np.int32)
    jcache1, jlog = jb.prefill(jparams, dict(tokens=jnp.asarray(toks)))
    tcache1, tlog = tb.prefill(tparams, dict(tokens=torch.from_numpy(toks)))
    _close(tlog, jlog)
    # the prompt's cache in a batch-2 decode cache at slot 1
    jcache = JServeEngine._scatter_slot_cache(jb.init_cache(2, 48), jcache1,
                                              1)
    tcache = TServeEngine._scatter_slot_cache(tb.init_cache(2, 48), tcache1,
                                              1)
    tokens = np.array(jnp.argmax(jlog, -1), np.int32)
    tokens = np.stack([tokens, tokens])
    pos = np.array([0, 23], np.int32)
    for _ in range(4):
        jlog, jcache = jb.decode_step(jparams, jcache, jnp.asarray(tokens),
                                      jnp.asarray(pos))
        tlog, tcache = tb.decode_step(tparams, tcache,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch,kv", LOGIT_CASES)
def test_paged_logits_match_reference(arch, kv):
    """Chunked prefill of two prompts past the window (page 8, chunk 8,
    ring tables of 3 slots), then decode ticks; live pages compared too
    (native KV)."""
    tcfg, jb, jparams, tb, tparams = _pair(arch, kv, 7)
    b, page, n, r = 2, 8, 6, 3
    lens = [13, 29]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, m).astype(np.int32)
               for m in lens]
    full = np.stack([1 + np.arange(n), 1 + n + np.arange(n)]).astype(
        np.int32)
    ring = np.stack([1 + np.arange(r), 1 + r + np.arange(r)]).astype(
        np.int32)
    jcache = jb.init_paged_cache(1 + b * n, page, batch=b,
                                 ring_pages=1 + b * r)
    tcache = tb.init_paged_cache(1 + b * n, page, ring_pages=1 + b * r)
    jtable = dict(full=jnp.asarray(full), ring=jnp.asarray(ring))
    ttable = dict(full=torch.from_numpy(full), ring=torch.from_numpy(ring))

    def pages():
        if kv == "int8":
            return
        for part in jcache["blocks"]:
            for kind in ("k_pages", "v_pages"):
                _close(tcache["blocks"][part][kind][:, 1:],
                       jcache["blocks"][part][kind][:, 1:])

    off = np.zeros(b, np.int32)
    while (off < lens).any():
        valid = np.minimum(CHUNK, np.maximum(np.array(lens) - off, 0))
        valid = np.maximum(valid, 1).astype(np.int32)
        pos = np.minimum(off, np.array(lens) - 1).astype(np.int32)
        toks = np.zeros((b, CHUNK), np.int32)
        for i in range(b):
            toks[i, :valid[i]] = prompts[i][pos[i]:pos[i] + valid[i]]
        jcache, jlog = jb.paged_prefill_chunk(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(pos), jtable,
            jnp.asarray(valid))
        tcache, tlog = tb.paged_prefill_chunk(
            tparams, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            ttable, torch.from_numpy(valid))
        _close(tlog, jlog)
        pages()
        off = pos + valid
    tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = np.array(lens, np.int32)
    for _ in range(4):
        jlog, jcache = jb.paged_decode_step(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(pos), jtable)
        tlog, tcache = tb.paged_decode_step(
            tparams, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(pos), ttable)
        _close(tlog, jlog)
        pages()
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


def test_naive_attention_over_ring_positions_matches_reference():
    rng = np.random.default_rng(9)
    b, sq, skv, hq, hkv, d = 2, 3, 12, 4, 2, 8
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    kpos = np.array([[8, 9, 10, 11, 4, 5, 6, 7, -10**9, -10**9, 12, 13],
                     [0, 1, 2, 3, 4, 5, -10**9, 7, 8, 9, 10, 11]], np.int32)
    off = np.array([12, 11], np.int32)
    for kw in (dict(window=6), dict(window=6, softcap=5.0), dict()):
        want = j_attn.naive_attention(
            *(jnp.asarray(x) for x in (q, k, v)),
            j_attn.AttnParams(**kw), q_offset=jnp.asarray(off),
            k_positions=jnp.asarray(kpos))
        got = t_attn.naive_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            t_attn.AttnParams(**kw), q_offset=torch.from_numpy(off),
            k_positions=torch.from_numpy(kpos))
        _close(got, want)


@pytest.mark.parametrize("arch", ["gemma2-27b", "internlm2-20b"])
def test_configs_match_field_for_field(arch):
    assert (dataclasses.asdict(T_ARCHS[arch])
            == dataclasses.asdict(J_ARCHS[arch]))
    smoke = t_smoke(T_ARCHS[arch])
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        j_smoke(J_ARCHS[arch]))
    if arch == "gemma2-27b":
        assert [s.sliding_window for s in smoke.layer_pattern] == [16, None]


@pytest.mark.parametrize("s", [16, 19, 32])
def test_dense_ring_prefill_hazard_matches_reference(s):
    """The reference's dense decode after a windowed prefill of s tokens
    writes position p at ring row ``p % window`` while the prefill left
    positions ``s-window..s-1`` at rows ``0..window-1``: for ``s % window
    != 0`` it overwrites a row still in the window, and the next logits
    leave a full recompute's.  The port keeps that behaviour (its dense
    drains equal the reference's); both must drift alike."""
    tcfg, jb, jparams, tb, tparams = _pair("gemma2-27b", "native", 0)
    toks = np.random.default_rng(s).integers(0, tcfg.vocab_size,
                                             (1, s)).astype(np.int32)
    drift = []
    for side in ("j", "t"):
        if side == "j":
            c1, lg = jb.prefill(jparams, dict(tokens=jnp.asarray(toks)))
            nxt = np.asarray(jnp.argmax(lg, -1), np.int32)[:, None]
            cache = JServeEngine._scatter_slot_cache(jb.init_cache(1, 64),
                                                     c1, 0)
            ld, _ = jb.decode_step(jparams, cache, jnp.asarray(nxt),
                                   jnp.asarray([s], jnp.int32))
            _, lf = jb.prefill(jparams, dict(tokens=jnp.asarray(
                np.concatenate([toks, nxt], 1))))
            drift.append(float(jnp.abs(ld - lf).max()))
        else:
            c1, lg = tb.prefill(tparams, dict(tokens=torch.from_numpy(toks)))
            cache = TServeEngine._scatter_slot_cache(tb.init_cache(1, 64),
                                                     c1, 0)
            tn = torch.tensor(nxt).long()
            ld, _ = tb.decode_step(tparams, cache, tn,
                                   torch.tensor([s], dtype=torch.int32))
            _, lf = tb.prefill(tparams, dict(tokens=torch.cat(
                [torch.from_numpy(toks).long(), tn], 1)))
            drift.append(float((ld - lf).abs().max()))
    assert drift[1] == pytest.approx(drift[0], abs=TOL)
    window = [w for w in (x.sliding_window for x in tcfg.layer_pattern)
              if w][0]
    if s <= window or s % window == 0:
        assert drift[0] < TOL
    else:
        assert drift[0] > 1e-2
