"""Tensor parallelism over the MoE, recurrent and encoder-decoder stacks
in the port, held against the reference on the CPU (two shards on
``["cpu", "cpu"]``: the same per-shard code as on cards).

- TP=2 serving drains of smoke granite-moe-3b-a800m (native and int8
  pages, the launcher's dense dispatch), grok-1-314b,
  mamba2-130m (with the short-prompts mix of prompts shorter than the
  conv's context) and recurrentgemma-9b with 2 kv heads, against the
  reference's single-device engine on the same bridged weights: tokens,
  final keys and every ``ServeStats`` field equal, greedy (and sampled
  for granite-moe);
  the shards' replicated state copies equal after the drain, and
  ``live_kv_bytes_peak(per_shard=True)`` the reference's formula;
- every MoE and recurrent leaf stored in the blocks the reference's
  ``spec_for`` gives under the ``tp`` policy at TP=2;
- ``moe.apply_tp`` against ``repro.models.moe.apply_dense`` and
  ``apply_sorted`` in the cases of the reference's
  ``tests/test_models.py`` (ample capacity; a capacity factor of 0.25
  that drops assignments), float32;
- ``rglru.forward_tp``/``ssm.forward_tp`` and their decode steps over 16
  and 3 shards, which divide neither the RG-LRU's 8 blocks nor the SSD's
  heads, against the reference's modules;
- train steps on (2, 2) and (1, 2) meshes (and (1, 3) for the
  recurrent stacks) against the reference's one-device step for the four
  families, at ``_holds``' gates;
- make_prefill_step/make_decode_step at model 2 for granite-moe and
  mamba2-130m against the reference's prefill and decode_step, float32
  logits within 1e-5;
- bfloat16 mamba2-130m at TP=2 rounds as TP=1 does: over a decode with
  forced inputs, the TP=2 logits' error against the float32 ones (the
  reference's) is at most twice TP=1's at every position, and where the
  layouts' greedy tokens part, TP=1's top-2 gap is within the layouts'
  logit difference; one layer's bfloat16 SSD mixer at TP=2 keeps TP=1's
  float32 state to float32 rounding, and its output within two bfloat16
  ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.dist import POLICIES as J_POLICIES
from repro.dist.sharding import spec_for as j_spec_for
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
import repro_torch.serve as T
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import ShapeCell
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.dist import POLICIES, ServeMesh
from repro_torch.dist import tp as tp_mod
from repro_torch.dist.sharding import assemble_tree, cut_tree
from repro_torch.dist.steps import make_decode_step, make_prefill_step
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build
from repro_torch.models import moe as t_moe
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssm as t_ssm

from test_torch_hybrid_serve import _drive, _mix
from test_torch_tp_serve import (KW, SAMPLED, _check_engines, _drain,
                                 _share_cost_model)
from test_torch_train_mesh import (B, _batch, _holds, _mesh, _nest,
                                   _port_step, _reference_step, _weights)

CPU2 = ["cpu", "cpu"]
# arch -> the config override of its TP case (recurrentgemma-9b's one kv
# head does not divide by 2: the reference refuses it, as the port does)
ARCH_KW = {"granite-moe-3b-a800m": {}, "grok-1-314b": {},
           "mamba2-130m": {}, "recurrentgemma-9b": dict(num_kv_heads=2)}

_STATE = {}


def _models(arch, kv="native", moe="dense"):
    """(reference bundle, params, port bundle, params) at smoke width, the
    same seed-7 weights in both (drawn by the port, bridged as numpy)."""
    key = (arch, kv, moe)
    if key not in _STATE:
        jcfg = j_override(j_smoke(J_ARCHS[arch]), **ARCH_KW[arch])
        tcfg = t_override(t_smoke(T_ARCHS[arch]), **ARCH_KW[arch])
        jb = j_build(jcfg, JFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16, moe_impl=moe, kv_dtype=kv))
        tb = t_build(tcfg, TFlags(attn_impl="chunked", attn_bq=16,
                                  attn_bkv=16, moe_impl=moe, kv_dtype=kv),
                     device="cpu")
        if ("weights", arch) not in _STATE:
            w = tb.init(torch.Generator().manual_seed(7))
            _STATE["weights", arch] = _nest(
                {k: v.numpy() for k, v in flatten(w).items()})
        w = _STATE["weights", arch]
        _STATE[key] = (jb, jax.tree.map(jnp.asarray, w), tb,
                       params_from_numpy(w, tcfg, "cpu"))
    return _STATE[key]


def _pair(arch, kv="native", moe="dense", sampling=None):
    """A (reference single-device, port TP=2) engine pair, built once and
    reset before each use (the prefill shapes both have met stay met)."""
    key = ("pair", arch, kv, moe, sampling is None)
    if key not in _STATE:
        _STATE[key] = _new_pair(arch, kv, moe, sampling)
    for eng in _STATE[key]:
        eng.reset()
    return _STATE[key]


def _new_pair(arch, kv, moe, sampling):
    jb, jparams, tb, tparams = _models(arch, kv, moe)
    jeng = J.ServeEngine(jb, jparams,
                         sampling=J.SamplingParams(**(sampling or {})), **KW)
    teng = T.ServeEngine(tb, tparams,
                         sampling=T.SamplingParams(**(sampling or {})),
                         page_size=jeng.page, dist=ServeMesh.tp(2, CPU2),
                         **KW)
    _share_cost_model(jeng, teng)
    return jeng, teng


def _state_copies_equal(teng):
    """Every recurrent state leaf equal on both shards."""
    a, b = teng.cache
    for part in ("blocks", "rem"):
        for name, layer in a[part].items():
            for n, leaf in layer.items():
                if n in ("k_pages", "v_pages", "k_scale", "v_scale"):
                    continue
                assert torch.equal(leaf, b[part][name][n]), (name, n)


# ---------------------------------------------------------------------------
# serving drains against the reference's single device
# ---------------------------------------------------------------------------

DRAINS = [("granite-moe-3b-a800m", "native", "dense"),
          ("granite-moe-3b-a800m", "int8", "dense"),
          ("grok-1-314b", "native", "dense"),
          ("mamba2-130m", "native", "dense"),
          ("recurrentgemma-9b", "native", "dense")]


@pytest.mark.parametrize("arch,kv,moe", DRAINS)
def test_tp2_greedy_drain_equals_reference_single_device(arch, kv, moe):
    jeng, teng = _pair(arch, kv, moe)
    want = _drain(jeng, J.Request)
    assert _drain(teng, T.Request) == want
    _check_engines(jeng, teng)
    assert teng.tp == 2 and isinstance(teng.cache, list)
    _state_copies_equal(teng)
    whole = jeng.live_kv_bytes_peak()
    assert teng.live_kv_bytes_peak() == whole
    assert teng.kv_bytes() == jeng.kv_bytes()
    # the reference's per-shard figure at tp=2: the pools over tp, the
    # recurrent state whole
    jeng.tp = 2
    assert (teng.live_kv_bytes_peak(per_shard=True)
            == jeng.live_kv_bytes_peak(per_shard=True))
    assert teng._recurrent_state_bytes() == jeng._recurrent_state_bytes()


def test_tp2_short_prompts_on_the_ssd_stack():
    """Prompts of 1-3 tokens, shorter than the conv's context, through
    the TP=2 paged engine: the reference's paged drain, counter for
    counter."""
    jeng, teng = _pair("mamba2-130m")
    waves = _mix("short-prompts")
    want = _drive(jeng, J.Request, waves)
    assert _drive(teng, T.Request, waves) == want
    _check_engines(jeng, teng)
    _state_copies_equal(teng)


def test_tp2_sampled_drain_is_key_exact():
    """A sampled drain of granite-moe at TP=2: the per-slot key chains
    never see the mesh, so the reference's tokens and final keys."""
    jeng, teng = _pair("granite-moe-3b-a800m", sampling=SAMPLED)
    want = _drain(jeng, J.Request, n=3, max_new=6)
    assert _drain(teng, T.Request, n=3, max_new=6) == want
    _check_engines(jeng, teng)
    assert teng.keys.any()


class _TP2:
    shape = {"model": 2}


@pytest.mark.parametrize("arch", sorted(ARCH_KW))
def test_tp2_blocks_follow_the_reference_spec(arch):
    """Each shard holds the block of every MoE and recurrent leaf that
    the reference's ``spec_for`` gives under the ``tp`` policy at
    model 2: half the experts, half the width, half the SSD heads."""
    _, _, tb, tparams = _models(arch)
    shards = ServeMesh.tp(2, CPU2).shard_params(tb, tparams)
    specs = flatten(tb.param_specs())
    for path, whole in flatten(tparams).items():
        if not any(k in path for k in ("moe", "rglru", "ssd")):
            continue
        spec = j_spec_for(tuple(whole.shape), specs[path],
                          J_POLICIES["tp"].param_rules, _TP2)
        want = tuple(n // (2 if e == "model" else 1)
                     for n, e in zip(whole.shape, spec))
        for sh in shards:
            assert tuple(flatten(sh)[path].shape) == want, path
    keys = [p for p in flatten(tparams) if "w_up" in p or "w_out" in p]
    assert keys and all(flatten(shards[0])[k].numel() * 2
                        == flatten(tparams)[k].numel() for k in keys)


# ---------------------------------------------------------------------------
# the recurrent mixers where the shards divide neither the blocks nor heads
# ---------------------------------------------------------------------------

# case -> (arch, config override, shards).  At 16 shards the splits are
# the production mesh's: recurrentgemma-9b's width in half blocks (its
# block rows split 16 ways), and mamba2-130m's 24 heads (1.5 heads of
# w_out rows a shard, w_in whole).  At 3 the smoke leaves stay whole and
# each shard computes an uneven span crossing block and head boundaries.
SPLITS = {"rglru-16": ("recurrentgemma-9b", dict(lru_width=256), 16),
          "rglru-3": ("recurrentgemma-9b", {}, 3),
          "ssd-16": ("mamba2-130m", dict(d_model=48, ssm_head_dim=4,
                                         ssm_state=8), 16),
          "ssd-3": ("mamba2-130m", {}, 3)}


MIXERS = {"rglru": (j_rglru, t_rglru), "ssd": (j_ssm, t_ssm)}


class _TPn:
    def __init__(self, n):
        self.shape = {"model": n}


def _mixer_case(case):
    """(reference module, port module, the two configs, the first layer's
    mixer leaves as numpy, each shard's blocks of them as the reference's
    ``spec_for`` cuts them under the ``tp`` policy)."""
    arch, kw, n = SPLITS[case]
    jcfg = j_override(j_smoke(J_ARCHS[arch]), **kw)
    tcfg = t_override(t_smoke(T_ARCHS[arch]), **kw)
    name = "rglru" if arch == "recurrentgemma-9b" else "ssd"
    jmod, tmod = MIXERS[name]
    tb = t_build(tcfg, device="cpu")
    specs = flatten(tb.param_specs())
    rng = np.random.default_rng(n)
    p, ps = {}, [{} for _ in range(n)]
    for path, v in flatten(tb.init(torch.Generator().manual_seed(3))).items():
        if not path.startswith(f"blocks.p0.{name}."):
            continue
        leaf = path.rsplit(".", 1)[1]
        # layer 0, every leaf moved off its init so zero biases count
        w = v[0].numpy() + 0.1 * rng.standard_normal(v.shape[1:]).astype(
            np.float32)
        p[leaf] = w
        spec = j_spec_for(tuple(v.shape), specs[path],
                          J_POLICIES["tp"].param_rules, _TPn(n))[1:]
        dim = spec.index("model") if "model" in spec else None
        for s in range(n):
            ps[s][leaf] = torch.from_numpy(
                w if dim is None else np.split(w, n, axis=dim)[s])
    return jmod, tmod, jcfg, tcfg, p, ps


@pytest.mark.parametrize("case", list(SPLITS))
def test_recurrent_tp_where_shards_do_not_divide(case):
    """A 24-token segment, an 8-token one continuing it (the state on the
    first shard alone, as a mesh row keeps it) and a decode step, through
    ``forward_tp``/``decode_step_tp`` over the case's shards, against the
    reference's ``forward``/``decode_step`` (float32, 1e-5)."""
    jmod, tmod, jcfg, tcfg, p, ps = _mixer_case(case)
    n = len(ps)
    g = tp_mod.DeviceGroup(["cpu"] * n)
    rng = np.random.default_rng(1)
    xs = [(0.5 * rng.standard_normal((2, s, tcfg.d_model))).astype(np.float32)
          for s in (24, 8, 1)]

    @jax.jit
    def reference(p, x0, x1, x2):
        j1, st = jmod.forward(p, x0, jcfg, return_state=True)
        j2, st = jmod.forward(p, x1, jcfg, return_state=True, state=st)
        return (j1, j2, st) + tuple(jmod.decode_step(p, x2, st, jcfg))

    j1, j2, jst, j3, jst3 = reference({k: jnp.asarray(v) for k, v in
                                       p.items()}, *map(jnp.asarray, xs))

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)

    tp_mod.reset_copies()
    one = [torch.from_numpy(xs[0])] * n
    out, sts = tmod.forward_tp(ps, one, tcfg, g, return_state=True)
    close(out, j1)
    two = [torch.from_numpy(xs[1])] * n
    out, sts = tmod.forward_tp(ps, two, tcfg, g, return_state=True,
                               states=[sts[0]] + [None] * (n - 1), to=(0,))
    close(out, j2)
    assert sts[1:] == [None] * (n - 1)
    for a, b in zip(sts[0], jst):
        close(a, b)
    out, sts = tmod.decode_step_tp(ps, [torch.from_numpy(xs[2])] * n, sts,
                                   tcfg, g)
    close(out, j3)
    for st in sts:
        for a, b in zip(st, jst3):
            close(a, b)
    if case == "rglru-16":
        # half a block a shard: the block's other inputs come across
        assert tuple(ps[0]["bd_a"].shape) == (8, 2, 32)
        assert tp_mod.COPIES["rglru block inputs"] > 0
    if case == "ssd-16":
        # w_out's 6-row blocks are 1.5 heads: a shard reads rows across
        assert tuple(ps[0]["w_out"].shape) == (6, 48)
        assert tuple(ps[0]["w_in"].shape) == (48, 232)
        assert tp_mod.COPIES["ssd params"] > 0


# ---------------------------------------------------------------------------
# the MoE layer at module level
# ---------------------------------------------------------------------------

# the reference's test_models.py cases: (d, f, E, k, x shape, group,
# capacity factor (None: E / k), input scale)
MOE_CASES = {"ample": (32, 64, 8, 2, (2, 64), 64, None, 0.5),
             "drops": (16, 32, 4, 2, (1, 32), 32, 0.25, 1.0)}


def _moe_case(name):
    """(params as numpy, input) of a case, drawn from a numpy seed at the
    reference init's scales."""
    d, f, e, k, (b, s), group, cf, scale = MOE_CASES[name]
    rng = np.random.default_rng(len(name))

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    p = dict(router=w(d, e), w_gate=w(e, d, f), w_up=w(e, d, f),
             w_down=w(e, f, d))
    x = (rng.standard_normal((b, s, d)) * scale).astype(np.float32)
    return p, x


@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_apply_tp_matches_reference(name, impl):
    d, f, e, k, (b, s), group, cf, scale = MOE_CASES[name]
    cf = float(e) / k if cf is None else cf
    p_np, x = _moe_case(name)
    if impl == "dense":
        ref = jax.jit(lambda p, x: j_moe.apply_dense(p, x, k, "swiglu"))
    else:
        ref = jax.jit(lambda p, x: j_moe.apply_sorted(
            p, x, k, "swiglu", group_size=group, capacity_factor=cf))
    jout, jaux = ref({n: jnp.asarray(v) for n, v in p_np.items()},
                     jnp.asarray(x))
    p = {n: torch.from_numpy(v) for n, v in p_np.items()}
    ps = [{n: (v if n == "router" else v[i * e // 2:(i + 1) * e // 2])
           for n, v in p.items()} for i in range(2)]
    tp_mod.reset_copies()
    out, aux = t_moe.apply_tp(ps, torch.from_numpy(x), k, "swiglu",
                              tp_mod.DeviceGroup(CPU2), impl=impl,
                              group_size=group, capacity_factor=cf, d_ff=f)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert tp_mod.COPIES["moe dispatch"] > 0
    assert tp_mod.COPIES["moe combine"] > 0
    if name == "drops" and impl == "sorted":
        cap = t_moe.capacity(k, s, cf, e)
        _, ids, _ = t_moe._route(p, torch.from_numpy(x), k)
        assert int((~t_moe.dispatch(ids, k, s, cap, e)[2]).sum()) > 0


# ---------------------------------------------------------------------------
# training and the sharded steps at model 2
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["granite-moe-3b-a800m", "recurrentgemma-9b", "mamba2-130m",
               "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_model2_train_steps_match_reference(arch):
    batch = _batch(t_smoke(T_ARCHS[arch]))
    p0, loss, gnorm, m_ref = _reference_step(arch, batch)
    # (1, 3): three columns divide neither the RG-LRU's 8 blocks nor the
    # SSD's 8 heads
    uneven = ((1, 3),) if arch in ("recurrentgemma-9b", "mamba2-130m") else ()
    for shape in uneven + ((2, 2), (1, 2)):
        params, opt, m, _ = _port_step(arch, p0, batch, _mesh(*shape))
        _holds(m, opt, loss, gnorm, m_ref)
        if arch == "granite-moe-3b-a800m":
            assert float(m["aux"]) > 0
    # the experts and the recurrent width are stored split over model
    split = [x for path, x in flatten(params).items()
             if any(k in path for k in ("moe.w_up", "rglru.w_out",
                                        "ssd.w_out"))]
    assert all(len(x.blocks) == 2 for x in split)


def _grown(cache, max_len):
    """A prefill cache's k/v rows in a decode cache of ``max_len`` rows
    (the recurrent state leaves as they are); either package's tree."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = _grown(v, max_len)
        elif k in ("k", "v"):
            widths = [(0, 0)] * v.ndim
            widths[2] = (0, max_len - v.shape[2])
            out[k] = (jnp.pad(v, widths) if isinstance(v, jax.Array)
                      else torch.from_numpy(np.pad(v.numpy(), widths)))
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m"])
def test_model2_prefill_and_decode_match_reference(arch):
    """A prefill of 24 tokens and two decode ticks continuing it, through
    make_prefill_step/make_decode_step on (2, 2), against the reference's
    one-device prefill and decode_step on the same weights and cache
    (float32, atol 1e-5); one device (1, 1) the same."""
    flags = dict(attn_impl="chunked", attn_bq=16, attn_bkv=16,
                 moe_impl="sorted")
    jb = j_build(j_smoke(J_ARCHS[arch]), JFlags(**flags))
    cfg = t_smoke(T_ARCHS[arch])
    bundle = t_build(cfg, TFlags(**flags), device="cpu")
    p0 = _weights(arch)
    params = params_from_numpy(p0, cfg, "cpu")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (B, 26)).astype(np.int32)
    jcache, jl = jb.prefill(p0, dict(tokens=jnp.asarray(tok[:, :24])))
    want = [np.asarray(jl)]
    jcache = _grown(jcache, 64)
    for t in range(24, 26):
        jl, jcache = jb.decode_step(p0, jcache, jnp.asarray(tok[:, t:t + 1]),
                                    jnp.asarray(t, jnp.int32))
        want.append(np.asarray(jl))
    for shape in ((1, 1), (2, 2)):
        mesh = _mesh(*shape)
        pre, p_sh = make_prefill_step(bundle, mesh, POLICIES["fsdp_tp"],
                                      ShapeCell("p", "prefill", 24, B))
        dec, _, c_sh = make_decode_step(bundle, mesh, POLICIES["fsdp_tp"],
                                        ShapeCell("d", "decode", 64, B))
        many = shape != (1, 1)
        p = cut_tree(params, p_sh, mesh) if many else params
        cache, logits = pre(p, dict(tokens=torch.from_numpy(tok[:, :24])))
        cache = _grown(assemble_tree(cache) if many else cache, 64)
        if many:
            cache = cut_tree(cache, c_sh, mesh)
        got = [logits]
        for t in range(24, 26):
            lg, cache = dec(p, cache, torch.from_numpy(tok[:, t:t + 1]),
                            torch.tensor(t))
            got.append(lg)
        for a, b in zip(got, want):
            assert a.shape == (B, cfg.vocab_size)
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


# ---------------------------------------------------------------------------
# bfloat16 TP=2 against TP=1: rounding, not a lower precision
# ---------------------------------------------------------------------------

C15_LAYERS, C15_PROMPT, C15_TICKS = 4, 40, 24


def _forced_logits(bundle, params, prompt, forced):
    """float32 logits (len(forced) + 1, V): a prefill of ``prompt``, then
    a decode tick on each forced token; row t predicts token t.  A TP
    bundle's vocab slices are concatenated in shard order."""
    def whole(lg):
        return (torch.cat([x.float().cpu() for x in lg], -1)
                if isinstance(lg, list) else lg.float())

    cache, lg = bundle.prefill(params, dict(tokens=prompt[None]))
    rows = [whole(lg)[0]]
    for i in range(len(forced)):
        lg, cache = bundle.decode_step(params, cache, forced[None, i:i + 1],
                                       torch.tensor(len(prompt) + i))
        rows.append(whole(lg)[0])
    return torch.stack(rows)


def test_tp2_bf16_ssd_rounds_as_tp1():
    """Smoke mamba2-130m at 4 layers in bfloat16, at TP=2 over ["cpu",
    "cpu"] and at TP=1 on the same weights, and in float32 at TP=1 on
    those weights upcast (exact): a prefill of 40 tokens and 24 decode
    ticks on the same forced tokens.  The float32 logits are the
    reference's (its prefill and decode_step, atol 1e-5).  At every
    position the largest absolute error of the TP=2 logits against the
    float32 ones is at most twice TP=1's: the shards keep TP=1's
    precision (float32 SSD state and norm sums), and only the
    row-parallel output projection's partial sums round once more.
    Wherever the two layouts' greedy tokens part, TP=1's top-2 gap there
    is at most the layouts' largest logit difference."""
    arch = "mamba2-130m"
    kw = dict(num_layers=C15_LAYERS)
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg32 = t_override(t_smoke(T_ARCHS[arch]), **kw)
    cfg16 = t_override(cfg32, **bf16)
    drawn = t_build(cfg32, device="cpu").init(torch.Generator().manual_seed(7))
    # the bfloat16 weights, and the same values in float32
    w = _nest({k: v.bfloat16().float().numpy()
               for k, v in flatten(drawn).items()})
    b16 = t_build(cfg16, device="cpu")
    p16 = params_from_numpy(w, cfg16, "cpu")
    mesh = ServeMesh.tp(2, CPU2)
    b2, p2 = mesh.bind(b16), mesh.shard_params(b16, p16)
    b32 = t_build(cfg32, device="cpu")
    p32 = params_from_numpy(w, cfg32, "cpu")
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg32.vocab_size, C15_PROMPT))
    forced = torch.from_numpy(rng.integers(0, cfg32.vocab_size, C15_TICKS))
    tp2 = _forced_logits(b2, p2, prompt, forced)
    tp1 = _forced_logits(b16, p16, prompt, forced)
    f32 = _forced_logits(b32, p32, prompt, forced)

    jb = j_build(j_override(j_smoke(J_ARCHS[arch]), **kw), JFlags())
    jw = jax.tree.map(jnp.asarray, w)
    jcache, jl = jb.prefill(jw, dict(tokens=jnp.asarray(prompt[None])))
    want = [np.asarray(jl)[0]]
    for i in range(C15_TICKS):
        jl, jcache = jb.decode_step(jw, jcache,
                                    jnp.asarray(forced[None, i:i + 1]),
                                    jnp.asarray(C15_PROMPT + i, jnp.int32))
        want.append(np.asarray(jl)[0])
    np.testing.assert_allclose(f32.numpy(), np.stack(want), atol=1e-5)

    err2 = (tp2 - f32).abs().amax(-1)
    err1 = (tp1 - f32).abs().amax(-1)
    assert bool((err1 > 0).all()), "bfloat16 TP=1 logits equal float32's"
    ratio = err2 / err1
    assert float(ratio.max()) <= 2.0, ratio
    top = tp1.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    diff = (tp2 - tp1).abs().amax(-1)
    parted = tp2.argmax(-1) != tp1.argmax(-1)
    assert bool((margin[parted] <= diff[parted]).all()), (
        margin[parted], diff[parted])


@pytest.mark.parametrize("step", [True, False], ids=["decode", "prefill"])
def test_tp2_bf16_ssd_mixer_keeps_tp1_precision(step):
    """Layer 0's SSD mixer of bfloat16 smoke mamba2-130m over the
    engine's two shards of its weights (``ServeMesh.shard_params``)
    against TP=1 on the same input (one token, or a 40-token chunk) and
    the same carried state: the new float32 state equals TP=1's within
    float32 rounding (1e-5 of its largest; a shard that kept or read it
    in bfloat16 would part by about 1e-3 of it), the conv state exactly,
    and the output within two bfloat16 ulps of its largest (the
    row-parallel output projection's partials each round once before
    they add)."""
    cfg = t_override(t_smoke(T_ARCHS["mamba2-130m"]), param_dtype="bfloat16",
                     compute_dtype="bfloat16")
    bundle = t_build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(7))
    shards = ServeMesh.tp(2, CPU2).shard_params(bundle, params)
    one = {k: v[0] for k, v in params["blocks"]["p0"]["ssd"].items()}
    two = [{k: v[0] for k, v in p["blocks"]["p0"]["ssd"].items()}
           for p in shards]
    gen = torch.Generator().manual_seed(1)
    bsz, seq = 4, (1 if step else 40)
    x = torch.randn((bsz, seq, cfg.d_model), generator=gen).bfloat16()
    zero = t_ssm.init_state(cfg, bsz, torch.bfloat16, "cpu")
    st = t_ssm.SSDState(
        state=torch.randn(zero.state.shape, generator=gen),
        conv=torch.randn(zero.conv.shape, generator=gen).bfloat16())
    g = tp_mod.DeviceGroup([torch.device("cpu")] * 2)
    if step:
        want, new = t_ssm.decode_step(one, x, st, cfg)
        got, news = t_ssm.decode_step_tp(two, [x, x], [st, st], cfg, g)
    else:
        want, new = t_ssm.forward(one, x, cfg, return_state=True, state=st)
        got, news = t_ssm.forward_tp(two, [x, x], cfg, g, return_state=True,
                                     states=[st, st])
    for s in news:
        assert s.state.dtype == torch.float32
        gap = float((s.state - new.state).abs().max())
        assert gap <= 1e-5 * float(new.state.abs().max()), gap
        assert torch.equal(s.conv, new.conv)
    top = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= 2 * ulp
