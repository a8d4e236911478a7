"""The MoE layers held against the reference on the CPU.

- the module (``repro_torch.models.moe``) against ``repro.models.moe`` on
  weights drawn by the reference's ``init`` and numpy-seeded inputs:
  ``_route``'s ids equal and gates within 1e-6, ``_lb_loss`` within rtol
  1e-5, ``apply_dense`` and ``apply_sorted`` within 5e-4 (the cases of
  the reference's ``tests/test_models.py``: ample capacity, where sorted
  equals dense, and a capacity factor of 0.25 that drops assignments), in
  swiglu, geglu and gelu, and an input whose padded tail overflows
  capacity: only pad tokens drop, the real ones keep every assignment;
  in bfloat16 (gates cast before the combine), ids equal and outputs
  within 2 bf16 ulps of their largest value;
- float32 logits of smoke granite-moe-3b-a800m and grok-1-314b (softcaps
  30) under both dispatches in the four modes (dense prefill and decode,
  paged chunks and paged decode), within 1e-4;
- greedy drains of smoke granite-moe under ``moe_impl="dense"`` (the
  launchers'), paged and dense, and paged under ``sorted`` with chunks of
  8 tokens, whose padded chunks overflow capacity: tokens identical and
  counters equal with the reference engine's;
- the full-width trees of both stacks: the reference's paths and shapes,
  and the config's ``param_count``.
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
from repro.models import moe as j_moe
from repro.models.common import ParamBuilder as JParamBuilder
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

TOL = 1e-4
MOE_TOL = 5e-4
STACKS = ["granite-moe-3b-a800m", "grok-1-314b"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _moe_params(seed, d, f, e, act):
    """The reference's init, (jax params, the port's params)."""
    b = JParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    j_moe.init(b, "moe", d, f, e, act)
    jp = b.params["moe"]
    return jp, {k: _t(v) for k, v in jp.items()}


# (name, d, f, E, k, x shape, group, capacity factor (None: E / k), scale)
CASES = {
    "ample": (32, 64, 8, 2, (2, 64), 64, None, 0.5),
    "drops": (16, 32, 4, 2, (1, 32), 32, 0.25, 1.0),
    "groups": (16, 32, 4, 2, (2, 24), 16, 1.25, 1.0),
}


def _case_inputs(name, act):
    d, f, e, k, (b, s), group, cf, scale = CASES[name]
    jp, tp = _moe_params(len(name), d, f, e, act)
    rng = np.random.default_rng(len(name) + 1)
    x = (rng.standard_normal((b, s, d)) * scale).astype(np.float32)
    return jp, tp, x, k, group, (float(e) / k if cf is None else cf)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("name", list(CASES))
def test_route_and_lb_loss_match_reference(name, act):
    jp, tp, x, k, _, _ = _case_inputs(name, act)
    jg, jids, jprobs = j_moe._route(jp, jnp.asarray(x), k)
    tg, tids, tprobs = t_moe._route(tp, _t(x), k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tg, jg, 1e-6)
    _close(tprobs, jprobs, 1e-6)
    n_exp = tp["router"].shape[-1]
    np.testing.assert_allclose(
        float(t_moe._lb_loss(tprobs, tids, n_exp)),
        float(j_moe._lb_loss(jprobs, jids, n_exp)), rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("name", list(CASES))
def test_apply_dense_and_sorted_match_reference(name, act):
    jp, tp, x, k, group, cf = _case_inputs(name, act)
    jout, jaux = j_moe.apply_dense(jp, jnp.asarray(x), k, act)
    tout, taux = t_moe.apply_dense(tp, _t(x), k, act)
    _close(tout, jout, MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jout, jaux = j_moe.apply_sorted(jp, jnp.asarray(x), k, act,
                                    group_size=group, capacity_factor=cf)
    tout, taux = t_moe.apply(tp, _t(x), k, act, impl="sorted",
                             group_size=group, capacity_factor=cf)
    _close(tout, jout, MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    _, ids, _ = t_moe._route(tp, _t(x), k)
    e = tp["router"].shape[-1]
    g_sz = min(group, x.shape[1])
    cap = t_moe.capacity(k, g_sz, cf, e)
    assert cap == int(max(k, k * g_sz * cf // e))
    _, _, keep, _ = t_moe.dispatch(ids, k, g_sz, cap, e)
    dropped = int((~keep).sum())
    if name == "ample":
        assert dropped == 0
        _close(tout, t_moe.apply_dense(tp, _t(x), k, act)[0], MOE_TOL)
    if name == "drops":
        # some assignments drop, and the output parts from full capacity
        assert dropped > 0
        full, _ = t_moe.apply_sorted(tp, _t(x), k, act, group_size=group,
                                     capacity_factor=float(e) / k)
        assert float((tout - full).abs().max()) > 0


@pytest.mark.parametrize("name,act", [("ample", "swiglu"),
                                      ("drops", "geglu"),
                                      ("groups", "gelu")])
def test_apply_dense_and_sorted_match_reference_bf16(name, act):
    """The served dtype: weights and input in bfloat16 (the router still
    float32 inside ``_route``), so the gates are cast to bfloat16 before
    the combine in both packages.  The two packages' bf16 matmuls
    accumulate in their own orders, so the outputs agree within 2 bf16
    ulps of the output's largest value, not bitwise; the expert ids are
    equal."""
    jp, tp, x, k, group, cf = _case_inputs(name, act)
    jp = {n: jnp.asarray(v, jnp.bfloat16) for n, v in jp.items()}
    tp = {n: v.to(torch.bfloat16) for n, v in tp.items()}
    jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    np.testing.assert_array_equal(t_moe._route(tp, tx, k)[1].numpy(),
                                  np.asarray(j_moe._route(jp, jx, k)[1]))
    for jout, tout in (
            (j_moe.apply_dense(jp, jx, k, act)[0],
             t_moe.apply_dense(tp, tx, k, act)[0]),
            (j_moe.apply_sorted(jp, jx, k, act, group_size=group,
                                capacity_factor=cf)[0],
             t_moe.apply_sorted(tp, tx, k, act, group_size=group,
                                capacity_factor=cf)[0])):
        assert tout.dtype == torch.bfloat16
        want = np.asarray(jout.astype(jnp.float32))
        np.testing.assert_allclose(tout.float().numpy(), want, rtol=0,
                                   atol=2 ** -6 * float(np.abs(want).max()))


def test_padded_tail_drops_before_real_tokens():
    """20 real tokens and 12 copies of one pad row (a right-padded chunk):
    the pad rows all pick the same experts and overflow them, and since
    the stable sort keeps token order within an expert, every dropped
    assignment is a pad token's.  The output matches the reference."""
    d, f, e, k, act = 16, 32, 4, 2, "swiglu"
    jp, tp = _moe_params(11, d, f, e, act)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 32, d)).astype(np.float32)
    x[0, 20:] = rng.standard_normal(d).astype(np.float32)
    jout, _ = j_moe.apply_sorted(jp, jnp.asarray(x), k, act, group_size=32,
                                 capacity_factor=1.0)
    tout, _ = t_moe.apply_sorted(tp, _t(x), k, act, group_size=32,
                                 capacity_factor=1.0)
    _close(tout, jout, MOE_TOL)
    cap = t_moe.capacity(k, 32, 1.0, e)
    _, ids, _ = t_moe._route(tp, _t(x), k)
    _, tok_of, keep, slot = t_moe.dispatch(ids, k, 32, cap, e)
    dropped = tok_of[~keep]
    assert dropped.numel() > 0 and bool((dropped >= 20).all())
    assert bool((slot[~keep] == e * cap).all())
    # the real tokens keep every assignment: their rows equal a dispatch
    # with capacity for everything
    full, _ = t_moe.apply_sorted(tp, _t(x), k, act, group_size=32,
                                 capacity_factor=float(e) / k)
    _close(tout[0, :20], full[0, :20], 1e-6)


def test_sorted_combine_is_deterministic():
    """Two calls give bit-identical outputs (the combine adds a token's
    contributions in a fixed order, no atomics)."""
    _, tp, x, k, group, cf = _case_inputs("groups", "swiglu")
    a, _ = t_moe.apply_sorted(tp, _t(x), k, "swiglu", group, cf)
    b, _ = t_moe.apply_sorted(tp, _t(x), k, "swiglu", group, cf)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# whole stacks: logits in four modes
# ---------------------------------------------------------------------------

class _Jitted:
    """The reference bundle's entry points under ``jax.jit``."""

    def __init__(self, jb):
        self.init_cache = jb.init_cache
        self.init_paged_cache = jb.init_paged_cache
        self.prefill = jax.jit(jb.prefill)
        self.decode_step = jax.jit(jb.decode_step)
        self.paged_prefill_chunk = jax.jit(jb.paged_prefill_chunk)
        self.paged_decode_step = jax.jit(jb.paged_decode_step)


@pytest.fixture(scope="module")
def stacks():
    """(reference params, port params) per stack, the same weights."""
    out = {}
    for name in STACKS:
        jcfg, tcfg = j_smoke(J_ARCHS[name]), t_smoke(T_ARCHS[name])
        jparams = j_build(jcfg, JFlags()).init(jax.random.PRNGKey(4))
        out[name] = (jcfg, tcfg, jparams,
                     params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"))
    return out


@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("name", STACKS)
def test_logits_match_reference_in_four_modes(stacks, name, impl):
    """Dense: a right-padded 13-token prefill (valid length 11), then
    decode ticks at per-slot positions.  Paged: a 21-token and a 13-token
    prompt in right-padded chunks of 16 (the padded tail overflows the
    sorted dispatch's capacity), then decode ticks."""
    jcfg, tcfg, jparams, tparams = stacks[name]
    jb = _Jitted(j_build(jcfg, JFlags(moe_impl=impl)))
    tb = t_build(tcfg, TFlags(moe_impl=impl), device="cpu")
    rng = np.random.default_rng(9)
    # dense prefill and decode
    toks = np.zeros((2, 16), np.int32)
    toks[:, :11] = rng.integers(0, tcfg.vocab_size, (2, 11))
    jc, jlog = jb.prefill(jparams, dict(tokens=jnp.asarray(toks),
                                        valid_len=11))
    tc, tlog = tb.prefill(tparams, dict(tokens=torch.from_numpy(toks),
                                        valid_len=11))
    _close(tlog, jlog)
    _close(tc["blocks"]["p0"]["k"], jc["blocks"]["p0"]["k"])
    jcache = jb.init_cache(2, 24)
    tcache = tb.init_cache(2, 24)
    tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = np.array([0, 5], np.int32)
    for _ in range(3):
        jlog, jcache = jb.decode_step(jparams, jcache, jnp.asarray(tokens),
                                      jnp.asarray(pos))
        tlog, tcache = tb.decode_step(tparams, tcache,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1
    # paged chunks and decode
    b, page, n, chunk = 2, 8, 6, 16
    lens = [21, 13]
    prompts = [rng.integers(0, tcfg.vocab_size, m).astype(np.int32)
               for m in lens]
    table = np.stack([1 + np.arange(n), 1 + n + np.arange(n)]).astype(
        np.int32)
    jtable = dict(full=jnp.asarray(table), ring=jnp.zeros((b, 1), jnp.int32))
    ttable = torch.from_numpy(table)
    jcache = jb.init_paged_cache(1 + b * n, page, batch=b)
    tcache = tb.init_paged_cache(1 + b * n, page)
    off = np.zeros(b, np.int32)
    while (off < lens).any():
        valid = np.minimum(chunk, np.maximum(np.array(lens) - off, 0))
        valid = np.maximum(valid, 1).astype(np.int32)
        pos = np.minimum(off, np.array(lens) - 1).astype(np.int32)
        toks = np.zeros((b, chunk), np.int32)
        for i in range(b):
            toks[i, :valid[i]] = prompts[i][pos[i]:pos[i] + valid[i]]
        jcache, jlog = jb.paged_prefill_chunk(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(pos), jtable,
            jnp.asarray(valid))
        tcache, tlog = tb.paged_prefill_chunk(
            tparams, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            ttable, torch.from_numpy(valid))
        _close(tlog, jlog)
        off = pos + valid
    tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = np.array(lens, np.int32)
    for _ in range(3):
        jlog, jcache = jb.paged_decode_step(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(pos), jtable)
        tlog, tcache = tb.paged_decode_step(
            tparams, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(pos), ttable)
        _close(tlog, jlog)
        for kind in ("k_pages", "v_pages"):
            _close(tcache["blocks"]["p0"][kind][:, 1:],
                   jcache["blocks"]["p0"][kind][:, 1:])
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# engine drains
# ---------------------------------------------------------------------------

COUNTERS = ("prefix_hit_tokens", "prefill_chunks", "decode_dispatches",
            "decode_steps", "tokens_out", "prefills", "pool_stalls",
            "pages_peak", "prefill_retraces", "prompt_tokens")
BATCH, MAX_LEN = 2, 64


def _mix(seed):
    """Five requests over two slots: the first and the last share a
    17-token prefix (a prefix hit on the paged backend), lengths that divide neither the page
    nor the chunk, budgets of 3-6."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, 17).astype(np.int32)
    prompts = [rng.integers(0, 256, m).astype(np.int32)
               for m in (9, 30, 5)]
    first, later = (np.concatenate([shared, rng.integers(0, 256, m)
                                    .astype(np.int32)]) for m in (4, 11))
    prompts = [first] + prompts + [later]
    return [(p, 3 + i % 4) for i, p in enumerate(prompts)]


def _drive(eng, make_request, mix):
    eng.reset()
    eng._seen_prefill_shapes.clear()
    reqs = [make_request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(mix)]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion(max_ticks=2_000)
    assert all(s is None for s in eng.slots)
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("impl,backend,chunk", [
    ("dense", "paged", 16), ("dense", "dense", 16), ("sorted", "paged", 8)])
def test_granite_moe_drain_matches_reference(stacks, impl, backend, chunk,
                                             monkeypatch):
    """Under ``sorted`` with chunks of 8 every padded chunk overflows
    capacity (cap = 5 of 16 assignments over 4 experts): the dropped
    assignments are counted through the port's dispatch and must be > 0."""
    jcfg, tcfg, jparams, tparams = stacks["granite-moe-3b-a800m"]
    jb = j_build(jcfg, JFlags(attn_impl="chunked", attn_bq=16, attn_bkv=16,
                              moe_impl=impl))
    tb = t_build(tcfg, TFlags(attn_impl="chunked", attn_bq=16, attn_bkv=16,
                              moe_impl=impl), device="cpu")
    jeng = JServeEngine(jb, jparams, batch_size=BATCH, max_len=MAX_LEN,
                        cache_backend=backend, prefill_chunk=chunk)
    kw = dict(page_size=jeng.page) if backend == "paged" else {}
    teng = TServeEngine(tb, tparams, BATCH, MAX_LEN, cache_backend=backend,
                        prefill_chunk=chunk, device="cpu", **kw)
    dropped = []
    real_dispatch = t_moe.dispatch

    def counting(*a):
        out = real_dispatch(*a)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(t_moe, "dispatch", counting)
    mix = _mix(31)
    want = _drive(jeng, JRequest, mix)
    got = _drive(teng, TRequest, mix)
    assert got == want
    assert [len(t) for t in got] == [m for _, m in mix]
    for field in COUNTERS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert teng.kv_bytes() == jeng.kv_bytes()
    if backend == "paged":
        assert teng.stats.prefix_hit_tokens > 0 and not teng.alloc.tables
    if impl == "sorted":
        assert sum(dropped) > 0
    else:
        assert not dropped


# ---------------------------------------------------------------------------
# the full-width trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", STACKS)
def test_full_width_tree_matches_reference(arch):
    """The full-width trees (on the meta device, and the reference's
    abstract one) hold the same paths and shapes, and as many parameters
    as the config's analytic ``param_count`` (316 489 340 928 for
    grok-1-314b)."""
    jtree = jax.eval_shape(j_build(J_ARCHS[arch], JFlags()).init,
                           jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten(jtree).items()}
    got = {k: tuple(v.shape) for k, v in
           flatten(t_tr.init_params(T_ARCHS[arch], None, "meta")).items()}
    assert got == want
    assert got["blocks.p0.moe.w_up"] == (
        T_ARCHS[arch].num_layers, T_ARCHS[arch].num_experts,
        T_ARCHS[arch].d_model, T_ARCHS[arch].d_ff)
    total = sum(int(np.prod(v)) for v in got.values())
    analytic = T_ARCHS[arch].param_count()[0]
    assert total == analytic
