"""Hybrid recurrent stacks served by the port's engine, held against the
reference's engine on the CPU.

- greedy drains of smoke recurrentgemma-9b (RG-LRU + a windowed attention
  layer), its 5-layer variant with two remainder RG-LRU layers, and smoke
  mamba2-130m (SSD only, no attention: the paged backend with no pool),
  on both backends: the mixes of the reference's paged tests (slot churn
  over six prompts; a 40-token prompt prefilled in chunks while another
  slot decodes, whose recurrent state must survive the masked ticks),
  prompts shorter than the conv's context (the reference's dense
  prefill pads their conv state at its end, ROADMAP C10: the port copies
  it) and seeded request mixes in the style of ``test_serve_fuzz.py``;
  tokens identical, counters equal (``prefill_chunks``, ``pages_peak``,
  ``ring_pages_peak``, ``live_kv_bytes_peak`` and the rest);
- the engine's accounting for these stacks: no full-attention pool where
  no layer needs one, recurrent state bytes counted as live, prefix
  sharing and speculative decoding off;
- a prefill cache written into a slot whose rows hold another request's
  state, against the reference's scatter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import build as t_build
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

BATCH, MAX_LEN, CHUNK = 2, 64, 8
STACKS = ["recurrentgemma-9b", "recurrentgemma-9b-5l", "mamba2-130m"]
COUNTERS = ("prefix_hit_tokens", "prefill_chunks", "decode_dispatches",
            "decode_steps", "tokens_out", "prefills", "pool_stalls",
            "pages_peak", "ring_pages_peak", "prefill_retraces",
            "prompt_tokens")


def _cfgs(name):
    if name == "recurrentgemma-9b-5l":
        return (j_override(j_smoke(J_ARCHS["recurrentgemma-9b"]), num_layers=5),
                t_override(t_smoke(T_ARCHS["recurrentgemma-9b"]), num_layers=5))
    return j_smoke(J_ARCHS[name]), t_smoke(T_ARCHS[name])


@pytest.fixture(scope="module")
def models():
    """Reference and port bundles with the same (bridged) weights."""
    out = {}
    for name in STACKS:
        jcfg, tcfg = _cfgs(name)
        jb = j_build(jcfg, JFlags())
        jparams = jb.init(jax.random.PRNGKey(12))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        out[name] = (jb, jparams, t_build(tcfg, device="cpu"), tparams)
    return out


@pytest.fixture(scope="module")
def engines(models):
    """(reference engine, port engine) per (stack, backend), built once
    and reset before every drain."""
    cache = {}

    def get(name, backend):
        if (name, backend) not in cache:
            jb, jparams, tb, tparams = models[name]
            jeng = JServeEngine(jb, jparams, batch_size=BATCH,
                                max_len=MAX_LEN, cache_backend=backend,
                                prefill_chunk=CHUNK)
            kw = dict(page_size=jeng.page) if backend == "paged" else {}
            teng = TServeEngine(tb, tparams, BATCH, MAX_LEN,
                                cache_backend=backend, prefill_chunk=CHUNK,
                                device="cpu", **kw)
            cache[name, backend] = (jeng, teng)
        return cache[name, backend]
    return get


def _prompts(seed, lens, prefix_len=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 256, size=prefix_len).astype(np.int32)
    return [np.concatenate([common, rng.integers(0, 256, size=n)
                            .astype(np.int32)]) for n in lens]


def _fuzz_mix(seed, max_requests, max_prompt):
    """A seeded mix in the style of the reference's fuzz strategy: per
    request a prompt length, a shared 9-token prefix or not, a budget of
    1-8 and a wave (the second lands mid-drain)."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 256, size=9).astype(np.int32)
    waves = ([], [])
    for _ in range(int(rng.integers(1, max_requests + 1))):
        plen = int(rng.integers(1, max_prompt + 1))
        tail = rng.integers(0, 256, size=plen).astype(np.int32)
        prompt = np.concatenate([common, tail]) if rng.random() < 0.5 else tail
        waves[int(rng.random() < 0.5)].append((prompt,
                                               int(rng.integers(1, 9))))
    return waves if waves[0] else (waves[1], [])


def _mix(name):
    """waves = ([(prompt, max_new)], later wave)."""
    if name == "churn":            # six prompts through two slots
        ps = _prompts(21, [5, 13, 9, 27, 7, 18])
        return [(p, 6) for p in ps], []
    if name == "pending-prefill":  # 40 tokens in chunks while slot 0 decodes
        ps = _prompts(23, [4, 40])
        return [(p, 8) for p in ps], []
    if name == "short-prompts":    # shorter than the conv's context of 3
        ps = _prompts(24, [1, 2, 3, 5])
        return [(p, 6) for p in ps[:3]], [(ps[3], 4)]
    if name == "shared-prefix":    # prefix sharing stays off
        first = _prompts(25, [5, 12], prefix_len=17)
        later = [np.concatenate([first[0][:17], p])
                 for p in _prompts(26, [3, 9])]
        return [(first[0], 6), (first[1], 4)], [(p, 5) for p in later]
    if name.startswith("fuzz-"):
        seed = int(name.split("-")[1])
        return _fuzz_mix(seed, 6 if seed % 2 else 3, 40 if seed % 2 else 12)
    raise KeyError(name)


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


def _check_drain(jeng, teng, waves):
    jeng._seen_prefill_shapes.clear()   # count every shape in both drains
    teng._seen_prefill_shapes.clear()
    want = _drive(jeng, JRequest, waves)
    got = _drive(teng, TRequest, waves)
    assert got == want
    for (_, max_new), toks in zip(waves[0] + waves[1], got):
        assert len(toks) == max_new
    for field in COUNTERS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert teng.kv_bytes() == jeng.kv_bytes()
    assert teng.live_kv_bytes_peak() == jeng.live_kv_bytes_peak()


MIXES = ["churn", "pending-prefill", "short-prompts", "shared-prefix"]


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("backend", ["paged", "dense"])
@pytest.mark.parametrize("name", STACKS)
def test_greedy_drain_matches_reference(engines, name, backend, mix):
    jeng, teng = engines(name, backend)
    _check_drain(jeng, teng, _mix(mix))
    if backend == "dense":
        return
    assert teng.pages_per_seq == jeng.pages_per_seq == 0
    assert teng.alloc is None and teng.prefix is None
    assert teng.stats.prefix_hit_tokens == 0
    if name.startswith("recurrentgemma"):
        assert teng.ring_slots == jeng.ring_slots == 3
        assert teng.stats.ring_pages_peak <= BATCH * teng.ring_slots
        a = teng.ralloc
        assert not a.tables and a.pages_in_use == 0
        if mix == "pending-prefill":
            assert teng.stats.prefill_chunks >= 6   # the prompt chunked
            assert teng.stats.ring_pages_reused > 0
    else:
        assert teng.ralloc is None and teng.stats.ring_pages_peak == 0


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_seeded_mix_matches_reference(engines, backend, seed):
    """recurrentgemma-9b on seeded mixes: odd seeds up to six requests of
    up to 40 tokens (the ring turns, slots churn), even seeds up to three
    of up to 12."""
    jeng, teng = engines("recurrentgemma-9b", backend)
    _check_drain(jeng, teng, _mix(f"fuzz-{seed}"))


@pytest.mark.parametrize("name", STACKS)
def test_paged_engine_accounting_matches_reference(models, name):
    """Before any request: no full-attention pool (RG-LRU layers are not
    full-attention layers), the ring sized by the attention layers alone,
    every state byte counted as live, page bytes from attention layers
    only."""
    jb, jparams, tb, tparams = models[name]
    jeng = JServeEngine(jb, jparams, batch_size=3, max_len=MAX_LEN,
                        cache_backend="paged")
    teng = TServeEngine(tb, tparams, 3, MAX_LEN, cache_backend="paged",
                        page_size=jeng.page, device="cpu")
    assert (teng.has_full, teng.has_recurrent, teng.attn_window) == (
        jeng.has_full, jeng.has_recurrent, jeng.attn_window)
    assert not teng.has_full and teng.has_recurrent
    assert (teng.pages_per_seq, teng.ring_slots, teng.num_pages,
            teng.num_ring_pages) == (jeng.pages_per_seq, jeng.ring_slots,
                                     jeng.num_pages, jeng.num_ring_pages)
    assert teng._page_bytes_by_kind() == jeng._page_bytes_by_kind()
    assert teng.kv_bytes() == jeng.kv_bytes()
    assert teng._recurrent_state_bytes() == jeng._recurrent_state_bytes() > 0
    assert teng.live_kv_bytes_peak() == jeng.live_kv_bytes_peak()
    if name == "mamba2-130m":
        # no attention layer: no pool at all, only the state
        assert teng.kv_bytes() == teng._recurrent_state_bytes()
        assert teng.bytes_per_page == 0


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mamba2-130m"])
def test_speculative_decoding_is_refused_on_hybrid_stacks(models, name):
    jb, jparams, tb, tparams = models[name]
    draft = t_build(t_smoke(T_ARCHS["gemma-2b"]), device="cpu")
    dparams = draft.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="recurrent state cannot"):
        TServeEngine(tb, tparams, BATCH, MAX_LEN, cache_backend="paged",
                     draft_bundle=draft, draft_params=dparams, device="cpu")
    jdraft = j_build(j_smoke(J_ARCHS["gemma-2b"]), JFlags())
    with pytest.raises(ValueError, match="recurrent state cannot"):
        JServeEngine(jb, jparams, batch_size=BATCH, max_len=MAX_LEN,
                     cache_backend="paged", draft_bundle=jdraft,
                     draft_params=jdraft.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("s", [2, 21])
@pytest.mark.parametrize("name", STACKS)
def test_prefill_scatter_overwrites_the_slot_whole(models, name, s):
    """A prompt's dense cache written into slot 1 of a batch cache whose
    rows hold another request's cache: every leaf equals the reference's
    scatter (a 2-token prompt gives a 2-row conv state, padded at its end
    as the reference pads it)."""
    jb, jparams, tb, tparams = models[name]
    rng = np.random.default_rng(s)
    toks = rng.integers(0, 256, (1, s)).astype(np.int32)
    other = rng.integers(0, 256, (1, 30)).astype(np.int32)
    jbatch, tbatch = jb.init_cache(2, 32), tb.init_cache(2, 32)
    for slot in (0, 1):
        jc, _ = jb.prefill(jparams, dict(tokens=jnp.asarray(other)))
        tc, _ = tb.prefill(tparams, dict(tokens=torch.from_numpy(other)))
        jbatch = JServeEngine._scatter_slot_cache(jbatch, jc, slot)
        tbatch = TServeEngine._scatter_slot_cache(tbatch, tc, slot)
    jc, _ = jb.prefill(jparams, dict(tokens=jnp.asarray(toks)))
    tc, _ = tb.prefill(tparams, dict(tokens=torch.from_numpy(toks)))
    jbatch = JServeEngine._scatter_slot_cache(jbatch, jc, 1)
    tbatch = TServeEngine._scatter_slot_cache(tbatch, tc, 1)
    for part in ("blocks", "rem"):
        for lname, layer in tbatch[part].items():
            ref = jbatch[part][lname]
            ref = ref._asdict() if hasattr(ref, "_asdict") else ref
            assert set(layer) == set(ref)
            for kind, leaf in layer.items():
                want = np.asarray(ref[kind])
                assert tuple(leaf.shape) == want.shape
                np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                           atol=1e-5)
