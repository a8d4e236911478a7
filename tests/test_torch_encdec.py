"""The frontend and encoder-decoder stacks held against the reference on the
CPU.

- smoke seamless-m4t-medium: ``prefill`` over frames and decoder tokens
  (the split cache's self ``k``/``v`` and cross ``ck``/``cv``, the last
  logits), then ``decode_step`` at per-slot positions on a split cache
  of ``max_len`` self rows and ``enc_len`` cross rows, within 1e-4;
- smoke pixtral-12b with ``patch_embeds`` prepended: prefill logits and
  caches, then decode on the padded dense cache, and a decode that
  matches the next prefill (the reference's ``tests/test_models.py``
  pattern);
- the bridge on an encoder-decoder tree;
- ``paged_supported()`` False for both, the engine's dense fallback and
  its paged refusal (the reference's ``tests/test_serve_paged.py``);
- a pixtral text-only drain token- and counter-exact with the reference
  engine's, and seamless's first engine prefill failing in both
  packages (the requests carry no encoder frames);
- the full-width trees: the reference's paths and shapes, just above the
  config's ``param_count``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.models import encdec as t_encdec
from repro_torch.models import transformer as t_tr
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

TOL = 1e-4
STACKS = ["pixtral-12b", "seamless-m4t-medium"]
FLAGS = dict(attn_impl="chunked", attn_bq=16, attn_bkv=16)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def stacks():
    """(reference bundle, reference params, port bundle, port params) per
    stack, the same weights."""
    out = {}
    for name in STACKS:
        jcfg, tcfg = j_smoke(J_ARCHS[name]), t_smoke(T_ARCHS[name])
        jb = j_build(jcfg, JFlags(**FLAGS))
        jparams = jb.init(jax.random.PRNGKey(6))
        out[name] = (jb, jparams, t_build(tcfg, TFlags(**FLAGS),
                                          device="cpu"),
                     params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"))
    return out


def test_seamless_prefill_and_decode_match_reference(stacks):
    """Prefill of 12 frames and 7 decoder tokens, then four decode ticks
    of both slots at positions 7 and 3 on a split cache of 16 self rows
    and 12 cross rows (the prefill's cross k/v written in)."""
    jb, jparams, tb, tparams = stacks["seamless-m4t-medium"]
    cfg = tb.cfg
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    jc, jlog = jax.jit(jb.prefill)(jparams, dict(
        frames=jnp.asarray(frames), dec_tokens=jnp.asarray(toks)))
    tc, tlog = tb.prefill(tparams, dict(frames=torch.from_numpy(frames),
                                        dec_tokens=torch.from_numpy(toks)))
    _close(tlog, jlog)
    for n in ("k", "v", "ck", "cv"):
        assert tuple(tc["dec"][n].shape) == jc["dec"][n].shape
        _close(tc["dec"][n], jc["dec"][n])
    jcache = jb.init_cache(2, 16, 12)
    tcache = tb.init_cache(2, 16, 12)
    assert {n: tuple(v.shape) for n, v in tcache["dec"].items()} == \
        {n: v.shape for n, v in jcache["dec"].items()}
    jcache = dict(dec={n: v.at[:, :, :jc["dec"][n].shape[2]].set(jc["dec"][n])
                       for n, v in jcache["dec"].items()})
    for n, v in tcache["dec"].items():
        v[:, :, :tc["dec"][n].shape[2]] = tc["dec"][n]
    tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = np.array([7, 3], np.int32)
    step = jax.jit(jb.decode_step)
    for _ in range(4):
        jlog, jcache = step(jparams, jcache, jnp.asarray(tokens),
                            jnp.asarray(pos))
        tlog, tcache = tb.decode_step(tparams, tcache,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        for n in ("k", "v"):
            _close(tcache["dec"][n], jcache["dec"][n])
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


def test_pixtral_patch_prefix_matches_reference(stacks):
    """8 patch embeddings prepended to 9 tokens: prefill logits and the
    cache over P + S positions, then decode on the padded dense cache
    (logits equal to the prefill of one more token), then two more
    ticks."""
    jb, jparams, tb, tparams = stacks["pixtral-12b"]
    cfg = tb.cfg
    p = cfg.num_frontend_tokens
    rng = np.random.default_rng(4)
    patches = rng.standard_normal((2, p, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)

    def both(n):
        jbatch = dict(tokens=jnp.asarray(toks[:, :n]),
                      patch_embeds=jnp.asarray(patches))
        tbatch = dict(tokens=torch.from_numpy(toks[:, :n]),
                      patch_embeds=torch.from_numpy(patches))
        return jb.prefill(jparams, jbatch), tb.prefill(tparams, tbatch)

    (jc, jlog), (tc, tlog) = both(9)
    _close(tlog, jlog)
    for n in ("k", "v"):
        assert tc["blocks"]["p0"][n].shape[2] == p + 9
        _close(tc["blocks"]["p0"][n], jc["blocks"]["p0"][n])
    (_, jnext), (_, tnext) = both(10)
    _close(tnext, jnext)
    tcache = tb.init_cache(2, p + 16)
    for n in ("k", "v"):
        tcache["blocks"]["p0"][n][:, :, :p + 9] = tc["blocks"]["p0"][n]
    jcache = jb.init_cache(2, p + 16)
    jcache["blocks"]["p0"] = {
        n: jcache["blocks"]["p0"][n].at[:, :, :p + 9].set(
            jc["blocks"]["p0"][n]) for n in ("k", "v")}
    tokens = toks[:, 9:10]
    pos = np.full((2,), p + 9, np.int32)
    for i in range(3):
        jlog, jcache = jb.decode_step(jparams, jcache, jnp.asarray(tokens),
                                      jnp.asarray(pos))
        tlog, tcache = tb.decode_step(tparams, tcache,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        if i == 0:
            _close(tlog, tnext)         # decode == one more prefill token
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


def test_bridge_takes_an_encoder_decoder_tree(stacks):
    jb, jparams, tb, tparams = stacks["seamless-m4t-medium"]
    want = flatten(jax.tree.map(np.asarray, jparams))
    got = flatten(tparams)
    assert set(got) == set(want)
    assert "dec.cross.wq" in got and "enc.attn.wq" in got \
        and "enc_norm" in got and "blocks.p0.ln1" not in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    tree = jax.tree.map(np.asarray, jparams)
    tree["dec"]["cross"].pop("wq")
    with pytest.raises(ValueError, match="dec.cross.wq"):
        params_from_numpy(tree, tb.cfg, "cpu")


def test_dense_fallback_and_paged_refusal(stacks):
    """Both stacks fall back to the dense cache and refuse the paged one,
    as the reference's engine does; every other stack pages."""
    for name in STACKS:
        jb, jparams, tb, tparams = stacks[name]
        assert not tb.paged_supported() and not jb.paged_supported()
        jeng = JServeEngine(jb, jparams, batch_size=1, max_len=32)
        teng = TServeEngine(tb, tparams, 1, 32, device="cpu")
        assert teng.backend == jeng.backend == "dense"
        with pytest.raises(ValueError):
            JServeEngine(jb, jparams, batch_size=1, max_len=32,
                         cache_backend="paged")
        with pytest.raises(ValueError, match="paged KV backend"):
            TServeEngine(tb, tparams, 1, 32, cache_backend="paged",
                         device="cpu")
    for name in T_ARCHS:
        if name not in STACKS:
            assert t_build(t_smoke(T_ARCHS[name]),
                           device="cpu").paged_supported()


def test_pixtral_text_drain_matches_reference(stacks):
    """Text-only requests (the engine's requests carry no patches) over
    two slots of the dense fallback: tokens identical, counters equal."""
    jb, jparams, tb, tparams = stacks["pixtral-12b"]
    jeng = JServeEngine(jb, jparams, batch_size=2, max_len=48)
    teng = TServeEngine(tb, tparams, 2, 48, device="cpu")
    rng = np.random.default_rng(8)
    mix = [(rng.integers(0, 256, m).astype(np.int32), b)
           for m, b in ((5, 4), (13, 6), (9, 3), (21, 5))]
    outs = []
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        reqs = [make(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(mix)]
        for r in reqs:
            eng.add_request(r)
        eng.run_to_completion(max_ticks=1_000)
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[1] == outs[0]
    assert [len(t) for t in outs[1]] == [b for _, b in mix]
    for field in ("prefills", "decode_steps", "decode_dispatches",
                  "tokens_out", "prompt_tokens", "prefill_retraces"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


def test_seamless_first_engine_prefill_fails_in_both(stacks):
    """The engine's requests carry tokens only; an encoder-decoder prefill
    needs frames: the reference fails with a KeyError, the port with a
    ValueError that says so."""
    jb, jparams, tb, tparams = stacks["seamless-m4t-medium"]
    prompt = np.arange(1, 6, dtype=np.int32)
    jeng = JServeEngine(jb, jparams, batch_size=1, max_len=32)
    jeng.add_request(JRequest(rid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jeng.run_to_completion()
    teng = TServeEngine(tb, tparams, 1, 32, device="cpu")
    teng.add_request(TRequest(rid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="no encoder frames"):
        teng.run_to_completion()


@pytest.mark.parametrize("arch", STACKS)
def test_full_width_tree_matches_reference(arch):
    """The full-width trees (on the meta device, and the reference's
    abstract one) hold the same paths and shapes; beside them the config's
    analytic ``param_count`` (12 247 782 400 for pixtral-12b, exactly the
    tree; seamless-m4t-medium's leaves out the norms)."""
    cfg = T_ARCHS[arch]
    jtree = jax.eval_shape(j_build(J_ARCHS[arch], JFlags()).init,
                           jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten(jtree).items()}
    mod = t_encdec if cfg.enc_dec else t_tr
    got = {k: tuple(v.shape) for k, v in
           flatten(mod.init_params(cfg, None, "meta")).items()}
    assert got == want
    total = sum(int(np.prod(v)) for v in got.values())
    analytic = cfg.param_count()[0]
    assert 0 <= total - analytic < 1e-3 * analytic
