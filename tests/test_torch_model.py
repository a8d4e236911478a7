"""The port's paged model against the reference, on bridged weights.

Same weights (the reference's init, handed over as numpy), same inputs:
``paged_prefill_chunk`` logits and the pages it writes, then
``paged_decode_step`` logits, all in float32 within 1e-4.  Prompt lengths
divide neither the page (8) nor the chunk (16).  Two configs: gemma-2b's
smoke config at 2 layers, and gemma-2b's attention geometry (8/1 heads,
head_dim 256) at narrow d_model, d_ff and vocab.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.models import RuntimeFlags
from repro.models import build as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
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
