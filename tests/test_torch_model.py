"""The port's model against the reference, on bridged weights.

Same weights (the reference's init, handed over as numpy), same inputs,
all in float32 within 1e-4:

- paged: ``paged_prefill_chunk`` logits and the pages it writes, then
  ``paged_decode_step`` logits.  Prompt lengths divide neither the page
  (8) nor the chunk (16).  Two configs: gemma-2b's smoke config at 2
  layers, and gemma-2b's attention geometry (8/1 heads, head_dim 256) at
  narrow d_model, d_ff and vocab;
- dense: ``prefill`` (right-padded prompts, per-row valid lengths) logits
  and caches, then ``decode_step`` logits at per-slot positions, with
  prefill attention ``chunked`` and ``pallas``, for gemma-2b's and
  phi4-mini's smoke configs;
- the attention impls ``chunked_attention`` and ``pallas_attention``
  against the reference's, on GQA inputs with causal, window, softcap and
  offset cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn

from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags
from repro.models import build as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import RuntimeFlags as TRuntimeFlags
from repro_torch.models import attention as t_attn
from repro_torch.models import build as t_build

TOL = 1e-4
PAGE, CHUNK, N = 8, 16, 6

NARROW = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
              param_dtype="float32", compute_dtype="float32")
CONFIGS = {
    "smoke-2layer": (
        lambda a, smoke, ov: ov(smoke(a["gemma-2b"]), num_layers=2)),
    "gemma-attn-geometry": (
        lambda a, smoke, ov: ov(a["gemma-2b"], **NARROW)),
}


def _configs(name):
    make = CONFIGS[name]
    return (make(J_ARCHS, j_smoke, j_override),
            make(T_ARCHS, t_smoke, t_override))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_configs_match_field_for_field():
    assert (dataclasses.asdict(T_ARCHS["gemma-2b"])
            == dataclasses.asdict(J_ARCHS["gemma-2b"]))
    for name in CONFIGS:
        jcfg, tcfg = _configs(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("arch", ["gemma-2b", "phi4-mini-3.8b"])
def test_arch_configs_match_field_for_field(arch):
    assert (dataclasses.asdict(T_ARCHS[arch])
            == dataclasses.asdict(J_ARCHS[arch]))
    assert (dataclasses.asdict(t_smoke(T_ARCHS[arch]))
            == dataclasses.asdict(j_smoke(J_ARCHS[arch])))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_prefill_and_decode_match_reference(name):
    jcfg, tcfg = _configs(name)
    jb = j_build(jcfg, RuntimeFlags())
    jparams = jb.init(jax.random.PRNGKey(3))
    tb = t_build(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")

    b = 2
    num_pages = 1 + b * N
    jcache = jb.init_paged_cache(num_pages, PAGE, batch=b)
    tcache = tb.init_paged_cache(num_pages, PAGE)
    rng = np.random.default_rng(7)
    lens = [13, 21]                                # true prompt lengths
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    table = np.stack([1 + np.arange(N), 1 + N + np.arange(N)]).astype(np.int32)
    jtable = dict(full=jax.numpy.asarray(table),
                  ring=jax.numpy.zeros((b, 1), jax.numpy.int32))
    ttable = torch.from_numpy(table)

    def pages(jc, tc):
        # page 0 is the null page: padded positions all write there, in an
        # order neither framework specifies, so only live pages compare
        for kind in ("k_pages", "v_pages"):
            _close(tc["blocks"]["p0"][kind][:, 1:],
                   jc["blocks"]["p0"][kind][:, 1:])

    # two prefill chunks per row, right-padded to the 16-token bucket
    off = np.zeros(b, np.int32)
    while (off < lens).any():
        valid = np.minimum(CHUNK, np.maximum(np.array(lens) - off, 0))
        valid = np.maximum(valid, 1).astype(np.int32)   # finished rows redo 1
        pos = np.minimum(off, np.array(lens) - 1).astype(np.int32)
        toks = np.zeros((b, CHUNK), np.int32)
        for i in range(b):
            toks[i, :valid[i]] = prompts[i][pos[i]:pos[i] + valid[i]]
        jcache, jlog = jb.paged_prefill_chunk(
            jparams, jcache, jax.numpy.asarray(toks), jax.numpy.asarray(pos),
            jtable, jax.numpy.asarray(valid))
        tcache, tlog = tb.paged_prefill_chunk(
            tparams, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            ttable, torch.from_numpy(valid))
        _close(tlog, jlog)
        pages(jcache, tcache)
        off = pos + valid

    # three decode ticks, both sides fed the reference's greedy tokens
    tokens = np.array(jax.numpy.argmax(jlog, -1), np.int32)[:, None]
    pos = np.array(lens, np.int32)
    for _ in range(3):
        jlog, jcache = jb.paged_decode_step(
            jparams, jcache, jax.numpy.asarray(tokens), jax.numpy.asarray(pos),
            jtable)
        tlog, tcache = tb.paged_decode_step(
            tparams, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(pos), ttable)
        _close(tlog, jlog)
        pages(jcache, tcache)
        tokens = np.array(jax.numpy.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


def test_bridge_rejects_mismatched_trees():
    jcfg, tcfg = _configs("smoke-2layer")
    tree = jax.tree.map(np.asarray,
                        j_build(jcfg, RuntimeFlags()).init(jax.random.PRNGKey(0)))
    tree["blocks"]["p0"]["attn"]["wq"] = tree["blocks"]["p0"]["attn"]["wq"][:, :4]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, tcfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, tcfg, "cpu")


# ---------------------------------------------------------------------------
# attention impls
# ---------------------------------------------------------------------------

# (name, B, Sq, Skv, Hq, Hkv, D, AttnParams kwargs, q_offset, kv_valid_len)
ATTN_CASES = [
    ("causal-gqa", 2, 40, 40, 8, 2, 16, dict(bq=16, bkv=16), 0, None),
    ("window", 1, 37, 37, 4, 1, 32, dict(window=9, bq=16, bkv=8), 0, None),
    ("softcap", 2, 33, 33, 4, 2, 16, dict(softcap=5.0, bq=8, bkv=16), 0,
     None),
    ("noncausal-cross", 1, 24, 48, 4, 2, 16,
     dict(causal=False, bq=16, bkv=16), 0, None),
    ("offset-valid", 2, 12, 40, 4, 2, 16, dict(bq=8, bkv=16), 20, 32),
]


def _attn_inputs(case):
    _, b, sq, skv, hq, hkv, d, kw, off, kvl = case
    rng = np.random.default_rng(11)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


# pallas serves full-block prefill only (both packages refuse an offset)
ATTN_RUNS = [(c, impl) for impl in ("chunked", "pallas") for c in ATTN_CASES
             if impl == "chunked" or (c[8] == 0 and c[9] is None)]


@pytest.mark.parametrize("case,impl", ATTN_RUNS,
                         ids=[f"{c[0]}-{i}" for c, i in ATTN_RUNS])
def test_attention_impl_matches_reference(case, impl):
    name, b, sq, skv, hq, hkv, d, kw, off, kvl = case
    arrays = _attn_inputs(case)
    want = j_attn.IMPLS[impl](*(jnp.asarray(a) for a in arrays),
                              j_attn.AttnParams(impl=impl, **kw),
                              q_offset=off, kv_valid_len=kvl)
    got = t_attn.IMPLS[impl](*(torch.from_numpy(a) for a in arrays),
                             t_attn.AttnParams(impl=impl, **kw),
                             q_offset=off, kv_valid_len=kvl)
    _close(got, want)


def test_pallas_attention_refuses_an_offset():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="full-block"):
        t_attn.pallas_attention(q, k, k, t_attn.AttnParams(), q_offset=2)
    with pytest.raises(ValueError, match="full-block"):
        t_attn.pallas_attention(q, k, k, t_attn.AttnParams(),
                                kv_valid_len=3)


def test_attention_dispatch_sends_one_query_to_naive():
    """Sq == 1 takes the naive path whatever the impl (pallas would refuse
    the offset)."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 10, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    p = t_attn.AttnParams(impl="pallas")
    pos = torch.tensor([3, 9])
    got = t_attn.attention(q, k, v, p, q_offset=pos, kv_valid_len=pos + 1)
    want = t_attn.naive_attention(q, k, v, p, q_offset=pos,
                                  kv_valid_len=pos + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dense prefill + decode
# ---------------------------------------------------------------------------

DENSE_CONFIGS = {
    "gemma-2b-smoke": lambda a, smoke, ov: ov(smoke(a["gemma-2b"]),
                                             num_layers=2),
    "phi4-mini-smoke": lambda a, smoke, ov: smoke(a["phi4-mini-3.8b"]),
}


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", list(DENSE_CONFIGS))
def test_dense_prefill_and_decode_match_reference(name, impl):
    make = DENSE_CONFIGS[name]
    jcfg = make(J_ARCHS, j_smoke, j_override)
    tcfg = make(T_ARCHS, t_smoke, t_override)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jb = j_build(jcfg, RuntimeFlags(attn_impl=impl, attn_bq=16, attn_bkv=16))
    jparams = jb.init(jax.random.PRNGKey(5))
    tb = t_build(tcfg, TRuntimeFlags(attn_impl=impl, attn_bq=16,
                                     attn_bkv=16), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")

    b, width, max_len = 2, 32, 48
    lens = np.array([19, 32], np.int32)       # right-padded to the bucket
    rng = np.random.default_rng(9)
    toks = np.zeros((b, width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab_size, n)
    jcache, jlog = jb.prefill(jparams, dict(tokens=jnp.asarray(toks),
                                            valid_len=jnp.asarray(lens)))
    tcache, tlog = tb.prefill(tparams, dict(tokens=torch.from_numpy(toks),
                                            valid_len=torch.from_numpy(lens)))
    _close(tlog, jlog)
    for kind in ("k", "v"):
        _close(tcache["blocks"]["p0"][kind], jcache["blocks"]["p0"][kind])

    # the prompt caches padded out to max_len, as the engine scatters them
    pad = [(0, 0), (0, 0), (0, max_len - width), (0, 0), (0, 0)]
    jcache = jax.tree.map(lambda a: jnp.pad(a, pad), jcache)
    tcache = tb.init_cache(b, max_len)
    for kind in ("k", "v"):
        tcache["blocks"]["p0"][kind][:, :, :width] = torch.from_numpy(
            np.array(jcache["blocks"]["p0"][kind][:, :, :width]))

    tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = lens.copy()
    for _ in range(3):
        jlog, jcache = jb.decode_step(jparams, jcache, jnp.asarray(tokens),
                                      jnp.asarray(pos))
        tlog, tcache = tb.decode_step(tparams, tcache,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        for kind in ("k", "v"):
            _close(tcache["blocks"]["p0"][kind],
                   jcache["blocks"]["p0"][kind])
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


def test_runtime_flags_refuse_what_is_not_ported():
    """int8 KV, sliding windows, recurrent (SSD, RG-LRU) layers, MoE
    layers under either dispatch, encoder-decoder stacks and the roofline
    mode's unrolled attention are built; unknown flags are refused."""
    from repro_torch.configs import LayerSpec
    from repro_torch.configs.base import MOE, SSD
    cfg = t_smoke(T_ARCHS["phi4-mini-3.8b"])
    t_build(cfg, TRuntimeFlags(kv_dtype="int8"), device="cpu")
    t_build(t_smoke(T_ARCHS["gemma2-27b"]), device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        t_build(cfg, TRuntimeFlags(kv_dtype="fp8"), device="cpu")
    t_build(cfg, TRuntimeFlags(attn_impl="unrolled"), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        t_build(cfg, TRuntimeFlags(attn_impl="flex"), device="cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        t_build(cfg, TRuntimeFlags(moe_impl="grouped"), device="cpu")
    t_build(t_override(cfg, layer_pattern=(LayerSpec(mixer=SSD),)),
            device="cpu")
    moe = dict(num_experts=4, num_experts_per_tok=2)
    for spec in (LayerSpec(mlp=MOE), LayerSpec(mixer=SSD, mlp=MOE)):
        for impl in ("dense", "sorted"):
            bundle = t_build(t_override(cfg, layer_pattern=(spec,), **moe),
                             TRuntimeFlags(moe_impl=impl), device="cpu")
            assert bundle.paged_supported()
            params = bundle.init(torch.Generator().manual_seed(0))
            assert "moe" in params["blocks"]["p0"]
    encdec = t_build(t_override(cfg, enc_dec=True, num_encoder_layers=1),
                     device="cpu")
    assert not encdec.paged_supported()
    assert "enc" in encdec.init(torch.Generator().manual_seed(0))