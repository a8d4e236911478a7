"""The recurrent mixers (RG-LRU, SSD) and the hybrid stacks held against the
reference on the CPU.

- ``causal_conv1d`` and ``conv_state_from`` (with and without a carried
  state, prompts shorter than the conv's context);
- the log-depth scan against ``jax.lax.associative_scan``, bit for bit;
- ``rglru.forward``/``ssm.forward`` with and without a carried state, at
  lengths that are not a multiple of ``ssm_chunk``, split into segments
  and whole, and ``decode_step``, on weights drawn by the reference's
  ``init`` and perturbed so that no bias or gain sits at its zero or one;
- float32 logits of smoke recurrentgemma-9b, a 5-layer variant with both
  remainder RG-LRU layers, and smoke mamba2-130m, in all four modes (dense
  prefill and decode, paged chunks and paged decode with an inactive
  slot), with the state leaves compared after every step;
- the layer and weight layout, and which stacks are accepted or refused.

Every comparison is float32 within ``TOL`` (absolute and relative); the
scan is compared exactly.
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
from repro.models import common as j_common
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.configs.base import MOE, NONE, SSD, LayerSpec
from repro_torch.models import build as t_build
from repro_torch.models import common as t_common
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tr
from repro_torch.models.scan import associative_scan

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# the conv and the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 3, 7])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_causal_conv1d_matches_reference(s, with_state, with_bias):
    rng = np.random.default_rng(s)
    b, c, k = 2, 6, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32) if with_bias else None
    st = (rng.standard_normal((b, k - 1, c)).astype(np.float32)
          if with_state else None)
    want = j_common.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias),
        None if st is None else jnp.asarray(st))
    got = t_common.causal_conv1d(_t(x), _t(w),
                                 None if bias is None else _t(bias),
                                 None if st is None else _t(st))
    _close(got, want, 1e-6)
    want = j_common.conv_state_from(jnp.asarray(x), k,
                                    None if st is None else jnp.asarray(st))
    got = t_common.conv_state_from(_t(x), k, None if st is None else _t(st))
    assert tuple(got.shape) == want.shape      # 2 rows from a 2-token x
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _affine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def _chunks(left, right):
    dl, sl = left
    dr, sr = right
    return dl * dr, sr + dr[..., None, None] * sl


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16, 33])
def test_scan_matches_jax_associative_scan(n):
    """The RG-LRU's operator along axis 1 and SSD's chunk-state operator
    (a rank-3 decay beside a rank-5 state) along axis 1, exactly."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = rng.standard_normal((2, n, 5)).astype(np.float32)
    want = jax.lax.associative_scan(_affine, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = associative_scan(_affine, (_t(a), _t(b)), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d = rng.uniform(0.5, 1.0, (1, n, 3)).astype(np.float32)
    s = rng.standard_normal((1, n, 3, 2, 4)).astype(np.float32)
    want = jax.lax.associative_scan(_chunks, (jnp.asarray(d), jnp.asarray(s)),
                                    axis=1)
    got = associative_scan(_chunks, (_t(d), _t(s)), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _mixer_params(jmod, cfg, seed):
    """The reference's ``init`` for one unstacked layer, each leaf moved
    off its constant by seeded noise (zero biases, unit gains, the 0.66
    Lambda and the zero ``a_log`` would hide a wrong sign or a dropped
    term); returns (jax tree, torch tree)."""
    b = j_common.ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jmod.init(b, "m", cfg)
    rng = np.random.default_rng(seed)
    jp, tp = {}, {}
    for name, leaf in b.params["m"].items():
        v = np.asarray(leaf) + 0.1 * rng.standard_normal(leaf.shape).astype(
            np.float32)
        jp[name], tp[name] = jnp.asarray(v), _t(v)
    return jp, tp


MIXERS = {"rglru": (j_rglru, t_rglru, "recurrentgemma-9b"),
          "ssd": (j_ssm, t_ssm, "mamba2-130m")}


def _state_close(got, want):
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("split", [None, 5, 16, 23])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_forward_matches_reference(mixer, split):
    """A 41-token sequence (ssm_chunk 16: two chunks and a padded one)
    whole, or as two segments with the state carried across ``split``;
    then four decode steps from the final state."""
    jmod, tmod, arch = MIXERS[mixer]
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    jp, tp = _mixer_params(jmod, jcfg, 3)
    j_forward = jax.jit(lambda p, x, st: jmod.forward(
        p, x, jcfg, return_state=True, state=st))
    j_decode = jax.jit(lambda p, x, st: jmod.decode_step(p, x, st, jcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 41, jcfg.d_model)).astype(np.float32)
    if split is None:
        want, jst = j_forward(jp, jnp.asarray(x), None)
        got, tst = tmod.forward(tp, _t(x), tcfg, return_state=True)
        _close(got, want)
        assert tmod.forward(tp, _t(x), tcfg).shape == got.shape
    else:
        want0, jst = j_forward(jp, jnp.asarray(x[:, :split]), None)
        got0, tst = tmod.forward(tp, _t(x[:, :split]), tcfg,
                                 return_state=True)
        _close(got0, want0)
        _state_close(tst, jst)
        want, jst = j_forward(jp, jnp.asarray(x[:, split:]), jst)
        got, tst = tmod.forward(tp, _t(x[:, split:]), tcfg,
                                return_state=True, state=tst)
        _close(got, want)
        # a carried state gives the unbroken sequence's outputs
        whole = tmod.forward(tp, _t(x), tcfg)
        _close(got, whole[:, split:], 1e-4)
    _state_close(tst, jst)
    for i in range(4):
        xi = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        want, jst = j_decode(jp, jnp.asarray(xi), jst)
        got, tst = tmod.decode_step(tp, _t(xi), tst, tcfg)
        _close(got, want)
        _state_close(tst, jst)


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_init_state_matches_reference(mixer):
    jmod, tmod, arch = MIXERS[mixer]
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    want = jmod.init_state(jcfg, 3, jnp.float32)
    got = tmod.init_state(tcfg, 3, torch.float32, "cpu")
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


# ---------------------------------------------------------------------------
# whole stacks: logits in four modes
# ---------------------------------------------------------------------------

def _cfgs(name):
    """(reference config, port config): the smoke configs, and the 5-layer
    variant of smoke recurrentgemma-9b (one (rglru, rglru, attn) triple and
    two remainder RG-LRU layers)."""
    if name == "recurrentgemma-9b-5l":
        return (j_override(j_smoke(J_ARCHS["recurrentgemma-9b"]), num_layers=5),
                t_override(t_smoke(T_ARCHS["recurrentgemma-9b"]), num_layers=5))
    return j_smoke(J_ARCHS[name]), t_smoke(T_ARCHS[name])


STACKS = ["recurrentgemma-9b", "recurrentgemma-9b-5l", "mamba2-130m"]


def _pair(name, seed):
    jcfg, tcfg = _cfgs(name)
    jb = j_build(jcfg, JFlags())
    jparams = jb.init(jax.random.PRNGKey(seed))
    tb = t_build(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return tcfg, _Jitted(jb), jparams, tb, tparams


class _Jitted:
    """The reference bundle's entry points under ``jax.jit`` (eager JAX
    would take tens of seconds over these stacks)."""

    def __init__(self, jb):
        self.init_cache = jb.init_cache
        self.init_paged_cache = jb.init_paged_cache
        self.prefill = jax.jit(jb.prefill)
        self.decode_step = jax.jit(jb.decode_step)
        self.paged_prefill_chunk = jax.jit(jb.paged_prefill_chunk)
        self.paged_decode_step = jax.jit(jb.paged_decode_step)


def _leaves_close(tcache, jcache, kinds=("h", "conv", "state")):
    """Every recurrent state leaf of the two caches (stacked and remainder
    layers)."""
    n = 0
    for part in ("blocks", "rem"):
        for name, layer in tcache[part].items():
            ref = jcache[part][name]
            ref = ref._asdict() if hasattr(ref, "_asdict") else ref
            for kind in kinds:
                if kind in layer:
                    _close(layer[kind], ref[kind])
                    n += 1
    return n


@pytest.mark.parametrize("name", STACKS)
def test_stack_layout_matches_reference(name):
    jcfg, tcfg = _cfgs(name)
    jparams = jax.eval_shape(j_build(jcfg, JFlags()).init,
                             jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten(jparams).items()}
    got = {k: tuple(v.shape) for k, v in
           flatten(t_tr.init_params(tcfg, None, "meta")).items()}
    assert got == want
    if name == "recurrentgemma-9b-5l":
        assert "rem.r0.rglru.bd_a" in got and "rem.r1.rglru.lam" in got
    if name == "mamba2-130m":
        assert not any(".mlp." in k or ".ln2" in k for k in got)


@pytest.mark.parametrize("name", STACKS)
def test_dense_logits_match_reference(name):
    """Prefill of a 21-token prompt (past the window of 16 and the SSD
    chunk of 16), scattered into slot 1 of a batch-2 cache, then decode
    ticks of both slots (slot 0 starts from an empty state)."""
    from repro.serve.engine import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine as TEngine
    tcfg, jb, jparams, tb, tparams = _pair(name, 5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (1, 21)).astype(np.int32)
    jc1, jlog = jb.prefill(jparams, dict(tokens=jnp.asarray(toks)))
    tc1, tlog = tb.prefill(tparams, dict(tokens=torch.from_numpy(toks)))
    _close(tlog, jlog)
    assert _leaves_close(tc1, jc1) > 0
    jcache = JEngine._scatter_slot_cache(jb.init_cache(2, 48), jc1, 1)
    tcache = TEngine._scatter_slot_cache(tb.init_cache(2, 48), tc1, 1)
    _leaves_close(tcache, jcache, ("h", "conv", "state", "k", "v", "kpos"))
    tokens = np.array(jnp.argmax(jlog, -1), np.int32)
    tokens = np.stack([tokens, tokens])
    pos = np.array([0, 21], np.int32)
    for _ in range(4):
        jlog, jcache = jb.decode_step(jparams, jcache, jnp.asarray(tokens),
                                      jnp.asarray(pos))
        tlog, tcache = tb.decode_step(tparams, tcache,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        _leaves_close(tcache, jcache)
        tokens = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("name", STACKS)
def test_paged_logits_match_reference(name):
    """Chunked prefill (batch-1 chunks of 8, each continuing its slot's
    state row) of a 29-token prompt into slot 1 while slot 0 holds a
    stale state, then the 13-token prompt into slot 0 after paged decode
    ticks in which slot 0 is inactive (its rows must not move), then
    decode ticks of both slots; ring tables of 3 pages of 8."""
    tcfg, jb, jparams, tb, tparams = _pair(name, 7)
    b, page, n, r = 2, 8, 6, 3
    rng = np.random.default_rng(8)
    prompts = {1: rng.integers(0, tcfg.vocab_size, 29).astype(np.int32),
               0: rng.integers(0, tcfg.vocab_size, 13).astype(np.int32)}
    full = np.stack([1 + np.arange(n), 1 + n + np.arange(n)]).astype(
        np.int32)
    ring = np.stack([1 + np.arange(r), 1 + r + np.arange(r)]).astype(
        np.int32)
    jcache = jb.init_paged_cache(1 + b * n, page, batch=b,
                                 ring_pages=1 + b * r)
    tcache = tb.init_paged_cache(1 + b * n, page, ring_pages=1 + b * r,
                                 batch=b)
    # a stale state in both rows: the first chunk must restart from zeros
    for part in ("blocks", "rem"):
        for lname, layer in tcache[part].items():
            for kind in ("h", "state"):
                if kind in layer:
                    layer[kind].fill_(0.5)
                    jcache[part][lname] = jcache[part][lname]._replace(
                        **{kind: jnp.full(layer[kind].shape, 0.5)})

    def prefill(slot, jcache):
        p = prompts[slot]
        off = 0
        while off < len(p):
            c = min(8, len(p) - off)
            toks = p[None, off:off + c]
            jt = dict(full=jnp.asarray(full[slot:slot + 1]),
                      ring=jnp.asarray(ring[slot:slot + 1]))
            tt = dict(full=torch.from_numpy(full[slot:slot + 1]),
                      ring=torch.from_numpy(ring[slot:slot + 1]))
            jcache, jlog = jb.paged_prefill_chunk(
                jparams, jcache, jnp.asarray(toks),
                jnp.asarray([off], jnp.int32), jt,
                jnp.asarray([c], jnp.int32), jnp.int32(slot))
            _, tlog = tb.paged_prefill_chunk(
                tparams, tcache, torch.from_numpy(toks),
                torch.tensor([off], dtype=torch.int32), tt,
                torch.tensor([c], dtype=torch.int32), slot)
            _close(tlog, jlog)
            _leaves_close(tcache, jcache)
            off += c
        return jcache, int(jnp.argmax(jlog[0]))

    jtable = dict(full=jnp.asarray(full), ring=jnp.asarray(ring))
    ttable = dict(full=torch.from_numpy(full), ring=torch.from_numpy(ring))

    def decode(jcache, tokens, pos, active):
        jlog, jcache = jb.paged_decode_step(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(pos), jtable,
            None, jnp.asarray(active))
        tlog, _ = tb.paged_decode_step(
            tparams, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(pos), ttable, torch.from_numpy(active))
        _close(tlog, jlog)
        _leaves_close(tcache, jcache)
        return jcache, np.array(jnp.argmax(jlog, -1), np.int32)

    jcache, t1 = prefill(1, jcache)
    tokens = np.array([[0], [t1]], np.int32)
    pos = np.array([0, 29], np.int32)
    frozen = {k: v.clone() for k, v in flatten(tcache).items()
              if k.endswith((".h", ".state", ".conv"))}
    for _ in range(3):                      # slot 0 inactive
        jcache, nxt = decode(jcache, tokens, pos, np.array([False, True]))
        tokens[1, 0] = nxt[1]
        pos[1] += 1
    for k, v in frozen.items():             # row 0 kept, row 1 moved
        now = flatten(tcache)[k]
        row = 0 if k.startswith("rem.") else (slice(None), 0)
        assert torch.equal(now[row], v[row]), k
    jcache, t0 = prefill(0, jcache)
    tokens[0, 0], pos[0] = t0, 13
    for _ in range(3):
        jcache, nxt = decode(jcache, tokens, pos, np.array([True, True]))
        tokens = nxt[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# what is accepted and what is refused
# ---------------------------------------------------------------------------

def test_hybrid_stacks_build_and_moe_encdec_are_refused():
    """The hybrid stacks build and page; the MoE, frontend and
    encoder-decoder stacks, once refused, build too, with the reference's
    paged support (a frontend or an encoder-decoder stack keeps the dense
    cache)."""
    for arch in ("recurrentgemma-9b", "mamba2-130m"):
        t_build(T_ARCHS[arch], device="cpu")
        assert t_build(T_ARCHS[arch], device="cpu").paged_supported()
    cfg = t_smoke(T_ARCHS["gemma-2b"])
    t_build(t_override(cfg, layer_pattern=(LayerSpec(mixer=SSD, mlp=NONE),)),
            device="cpu")
    moe = t_override(cfg, layer_pattern=(LayerSpec(mlp=MOE),), num_experts=4,
                     num_experts_per_tok=2)
    assert t_build(moe, device="cpu").paged_supported()
    for arch in ("granite-moe-3b-a800m", "grok-1-314b", "seamless-m4t-medium",
                 "pixtral-12b"):
        bundle = t_build(T_ARCHS[arch], device="cpu")
        want = j_build(J_ARCHS[arch], JFlags()).paged_supported()
        assert bundle.paged_supported() == want
        assert want == (arch in ("granite-moe-3b-a800m", "grok-1-314b"))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_full_width_tree_matches_reference(arch):
    """The full-width trees (on the meta device, and the reference's
    abstract one) hold the same paths and shapes; beside them the config's
    analytic ``param_count`` (8 632 832 000 and 128 921 472, which leaves
    out biases and norms)."""
    jtree = jax.eval_shape(j_build(J_ARCHS[arch], JFlags()).init,
                           jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten(jtree).items()}
    got = {k: tuple(v.shape) for k, v in
           flatten(t_tr.init_params(T_ARCHS[arch], None, "meta")).items()}
    assert got == want
    total = sum(int(np.prod(v)) for v in got.values())
    analytic = T_ARCHS[arch].param_count()[0]
    assert analytic == {"recurrentgemma-9b": 8_632_832_000,
                        "mamba2-130m": 128_921_472}[arch]
    assert 0 < total - analytic < 1e-3 * analytic


def test_paged_chunk_through_a_recurrent_layer_needs_its_slot():
    tcfg = t_smoke(T_ARCHS["mamba2-130m"])
    tb = t_build(tcfg, device="cpu")
    params = tb.init(torch.Generator().manual_seed(0))
    cache = tb.init_paged_cache(1, 8, batch=2)
    table = dict(full=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="slot"):
        tb.paged_prefill_chunk(params, cache, torch.zeros((1, 4)).long(),
                               torch.tensor([0]), table, torch.tensor([4]))
