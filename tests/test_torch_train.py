"""The port's training stack held against the reference on the CPU.

Same inputs (numpy-seeded) and the reference's weights handed over with
``repro_torch.bridge``:

- optimizer: ``adamw.update`` over 5 steps of random trees (clipping,
  weight decay and a schedule on and off): params, ``m``, ``v`` and the
  metrics within 1e-6; ``warmup_cosine``/``wsd`` at steps 0-120 within
  1e-7; ``quantize``/``ef_compress``: int8 codes equal, scales and
  residuals within 1e-7;
- data: ``SyntheticLM.batch_at`` bit for bit (uniform, markov, smoke
  seamless-m4t-medium's frames, smoke pixtral-12b's patches) and
  ``iterate`` from a resumed step;
- attention and loss: the chunked attention's output and q/k/v
  gradients against ``jax.vjp`` of the reference's (GQA, causal, window,
  softcap, ``kv_valid_len``, offsets, lengths that pad) within 1e-5;
  ``chunked_ce`` and ``cross_entropy`` within 1e-6;
- every family's ``train_loss`` (within 1e-5) and its gradients (each
  leaf within 1e-4 of its largest magnitude), the sorted MoE dispatch's
  gradients, and remat none/full/dots giving identical loss and grads;
- ``make_train_step`` at 1 and 4 microbatches against the reference's
  and against each other (the reference's own tolerances);
- the trainer: the loss falls on a fixed batch, checkpoints round-trip
  and keep k, recovery at steps 3 and 5 equals an uninterrupted run,
  the straggler monitor, checkpoints each package restores from the
  other's, the launcher on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import ShapeCell as JCell
from repro.configs import smoke_config as j_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import POLICIES as J_POLICIES
from repro.dist.steps import make_train_step as j_make_train_step
from repro.models import RuntimeFlags as JFlags
from repro.models import attention as j_attn
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro.models.common import ParamBuilder as JParamBuilder
from repro.models.common import cross_entropy as j_cross_entropy
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.optim import schedule as j_schedule
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import Trainer as JTrainer
from repro_torch.bridge import flatten, opt_state_from_numpy, params_from_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import ShapeCell as TCell
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.data import DataConfig as TDataConfig
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.dist import POLICIES as T_POLICIES
from repro_torch.dist.steps import make_train_step as t_make_train_step
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import attention as t_attn
from repro_torch.models import build as t_build
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr
from repro_torch.models.common import cross_entropy as t_cross_entropy
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compress as t_compress
from repro_torch.optim import schedule as t_schedule
from repro_torch.train import (CheckpointManager, FailureInjector,
                               TrainConfig, Trainer, run_with_recovery)

# tests/test_smoke_archs.py's and tests/test_train.py's flags
FLAGS = dict(attn_impl="chunked", attn_bq=16, attn_bkv=16, moe_impl="dense",
             loss_chunk=16)
B, S = 2, 32
CELL = (32, 4)          # tests/test_train.py's cell: seq 32, batch 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_close(got: dict, want: dict, tol=1e-4):
    """Each leaf within ``tol`` of the reference leaf's largest magnitude."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].detach().float().numpy()
        scale = float(np.max(np.abs(w))) or 1.0
        assert float(np.max(np.abs(g - w))) <= tol * scale, k


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    # insertion order unlike the sorted order the reference adds norms in
    return {"w2": {"b": rng.standard_normal((3, 5)).astype(np.float32) * scale,
                   "a": rng.standard_normal((7,)).astype(np.float32) * scale},
            "emb": rng.standard_normal((6, 4, 2)).astype(np.float32) * scale,
            "bias": rng.standard_normal((4,)).astype(np.float32) * scale}


@pytest.mark.parametrize("clip,decay,sched", [
    (1.0, 0.1, False), (None, 0.0, False), (0.5, 0.1, True),
    (None, 0.1, True)])
def test_adamw_update_matches_reference(clip, decay, sched):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, weight_decay=decay, clip_norm=clip)
    jcfg = JAdamWConfig(**kw, schedule=(j_schedule.warmup_cosine(2, 5)
                                        if sched else None))
    tcfg = TAdamWConfig(**kw, schedule=(t_schedule.warmup_cosine(2, 5)
                                        if sched else None))
    jp = jax.tree.map(jnp.asarray, params)
    jst = j_adamw.init(jp)
    tp = jax.tree.map(_t, params)
    tst = t_adamw.init(tp)
    for _ in range(5):
        g = _tree(rng, scale=3.0)
        jp, jst, jm = j_adamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                     jcfg)
        tp, tst, tm = t_adamw.update(jax.tree.map(_t, g), tst, tp, tcfg)
        for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
            for k, w in flatten(_np(want)).items():
                np.testing.assert_allclose(flatten(got)[k].numpy(), w,
                                           rtol=1e-6, atol=1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, atol=1e-7)
        assert int(tst.step) == int(jst.step)


def test_adamw_update_of_bfloat16_params_matches_reference():
    """bf16 params and grads: the update in float32, the result cast back
    (within one bf16 rounding of the reference's); moments in float32."""
    rng = np.random.default_rng(9)
    params = _tree(rng)
    cfg = dict(lr=1e-2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jst = j_adamw.init(jp)
    tp = jax.tree.map(lambda a: _t(a).to(torch.bfloat16), params)
    tst = t_adamw.init(tp)
    for _ in range(3):
        g = _tree(rng, scale=3.0)
        jp, jst, _ = j_adamw.update(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g), jst, jp,
            JAdamWConfig(**cfg))
        tp, tst, _ = t_adamw.update(
            jax.tree.map(lambda a: _t(a).to(torch.bfloat16), g), tst, tp,
            TAdamWConfig(**cfg))
    for k, w in flatten(_np(jp)).items():
        got = flatten(tp)[k]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   w.astype(np.float32), rtol=2 ** -8,
                                   atol=1e-6)
    for k, w in flatten(_np(jst.m)).items():
        np.testing.assert_allclose(flatten(tst.m)[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6)


def test_global_norm_adds_leaves_in_sorted_key_order():
    # squares 1, 1 and 2**24: in insertion order the sum is 2**24 + 2, in
    # the reference's sorted order 2**24 (each + 1 rounds away)
    g = {"z": np.ones(1, np.float32), "y": np.ones(1, np.float32),
         "a": np.full(1, 4096.0, np.float32)}
    want = float(j_adamw.global_norm(jax.tree.map(jnp.asarray, g)))
    assert want == 4096.0
    assert float(t_adamw.global_norm(jax.tree.map(_t, g))) == want
    rng = np.random.default_rng(1)
    g = _tree(rng, scale=10.0)
    np.testing.assert_allclose(
        float(t_adamw.global_norm(jax.tree.map(_t, g))),
        float(j_adamw.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)


def test_schedules_match_reference():
    steps = np.arange(0, 121, dtype=np.int32)
    for jf, tf in ((j_schedule.warmup_cosine(10, 100),
                    t_schedule.warmup_cosine(10, 100)),
                   (j_schedule.warmup_cosine(0, 50, floor=0.0),
                    t_schedule.warmup_cosine(0, 50, floor=0.0)),
                   (j_schedule.wsd(10, 100, decay_frac=0.2),
                    t_schedule.wsd(10, 100, decay_frac=0.2)),
                   (j_schedule.wsd(5, 120), t_schedule.wsd(5, 120))):
        want = np.array([float(jf(jnp.int32(s))) for s in steps])
        got = np.array([float(tf(torch.tensor(int(s), dtype=torch.int32)))
                        for s in steps])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(), (9,), (5, 7), (3, 4, 6)])
def test_quantize_and_error_feedback_match_reference(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    err = rng.standard_normal(shape).astype(np.float32) * 0.01
    jq, js = j_compress.quantize(jnp.asarray(x))
    tq, ts = t_compress.quantize(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        t_compress.dequantize(tq, ts).numpy(),
        np.asarray(j_compress.dequantize(jq, js)), rtol=0, atol=1e-7)
    jq, js, je = j_compress.ef_compress(jnp.asarray(x), jnp.asarray(err))
    tq, ts, te = t_compress.ef_compress(_t(x), _t(err))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-7)
    tree = _tree(rng)
    assert (t_compress.wire_bytes_saved(jax.tree.map(_t, tree))
            == j_compress.wire_bytes_saved(tree))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    ("gemma-2b", "uniform"), ("gemma-2b", "markov"),
    ("seamless-m4t-medium", "markov"), ("pixtral-12b", "uniform")])
def test_batches_bit_for_bit(arch, kind):
    jd = JSyntheticLM(j_smoke(J_ARCHS[arch]), JCell("c", "train", *CELL),
                      JDataConfig(seed=3, kind=kind))
    td = TSyntheticLM(t_smoke(T_ARCHS[arch]), TCell("c", "train", *CELL),
                      TDataConfig(seed=3, kind=kind))
    for step in (0, 5):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = td.iterate(4)
    for step in (4, 5, 6):
        b = next(it)
        for k, v in jd.batch_at(step).items():
            np.testing.assert_array_equal(b[k], v)
    it.close()


def test_batches_split_by_process():
    cfg = t_smoke(T_ARCHS["gemma-2b"])
    cell = TCell("c", "train", *CELL)
    parts = [TSyntheticLM(cfg, cell, TDataConfig(seed=1), i, 2)
             for i in range(2)]
    for i, d in enumerate(parts):
        want = JSyntheticLM(j_smoke(J_ARCHS["gemma-2b"]),
                            JCell("c", "train", *CELL), JDataConfig(seed=1),
                            i, 2).batch_at(2)
        assert d.batch_at(2)["tokens"].shape == (2, 32)
        np.testing.assert_array_equal(d.batch_at(2)["tokens"],
                                      want["tokens"])


# ---------------------------------------------------------------------------
# attention and loss
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (sq, skv, hq, hkv, AttnParams kwargs, q_offset, kv_valid_len)
    "gqa-causal": (32, 32, 4, 2, dict(causal=True), 0, None),
    "window": (32, 32, 4, 1, dict(causal=True, window=8), 0, None),
    "softcap": (32, 32, 4, 2, dict(causal=True, softcap=5.0), 0, None),
    "kv-valid-len": (16, 32, 4, 2, dict(causal=False), 0, 20),
    "offset": (16, 32, 2, 2, dict(causal=True, window=12), 16, None),
    "ragged-pad": (27, 37, 4, 2, dict(causal=True, softcap=3.0), 0, None),
    "cross-pad": (13, 21, 4, 4, dict(causal=False), 0, None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_vjp_matches_reference(case):
    sq, skv, hq, hkv, kw, off, kvl = ATTN_CASES[case]
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, sq, hq, 16), (2, skv, hkv, 16),
                             (2, skv, hkv, 16), (2, sq, hq, 16)))
    jp = j_attn.AttnParams(impl="chunked", bq=8, bkv=8, scale=0.3, **kw)
    tp = t_attn.AttnParams(impl="chunked", bq=8, bkv=8, scale=0.3, **kw)
    out, vjp = jax.vjp(lambda a, b, c: j_attn.chunked_attention(
        a, b, c, jp, q_offset=off, kv_valid_len=kvl), *map(jnp.asarray,
                                                           (q, k, v)))
    want = (out,) + vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    got = t_attn.chunked_attention(tq, tk, tv, tp, q_offset=off,
                                   kv_valid_len=kvl)
    got.backward(_t(do))
    for g, w in zip((got, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_chunked_ce_and_cross_entropy_match_reference():
    cfg = j_smoke(J_ARCHS["gemma-2b"])          # final softcap 30, tied head
    tcfg = t_smoke(T_ARCHS["gemma-2b"])
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32) * 0.3
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels[0, :5] = -100
    jparams, tparams = dict(embed=dict(tok=emb)), dict(embed=dict(tok=_t(emb)))
    for chunk in (0, 8, 32):
        want = j_tr.chunked_ce(jparams, cfg, jnp.asarray(x),
                               jnp.asarray(labels),
                               JFlags(loss_chunk=chunk))
        got = t_tr.chunked_ce(tparams, tcfg, _t(x), _t(labels),
                              TFlags(loss_chunk=chunk))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 4
    lab = rng.integers(0, 50, (2, 9)).astype(np.int32)
    lab[1, 3] = -100
    mask = rng.random((2, 9)) > 0.3
    for kw in (dict(), dict(mask=mask), dict(z_loss=1e-3),
               dict(mask=mask, z_loss=1e-2)):
        want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(lab),
                               **{k: jnp.asarray(v) if k == "mask" else v
                                  for k, v in kw.items()})
        got = t_cross_entropy(_t(logits), _t(lab),
                              **{k: _t(v) if k == "mask" else v
                                 for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# every family
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0):
    """tests/test_smoke_archs.py's batch, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.enc_dec:
        return dict(frames=rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32), dec_tokens=tok, labels=tok)
    if cfg.frontend:
        p = cfg.num_frontend_tokens
        return dict(patch_embeds=rng.standard_normal(
            (B, p, cfg.d_model)).astype(np.float32), tokens=tok[:, :S - p],
            labels=tok)
    return dict(tokens=tok, labels=tok)


def _bridged(arch, **flags):
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    jb = j_build(jcfg, JFlags(**{**FLAGS, **flags}))
    tb = t_build(tcfg, TFlags(**{**FLAGS, **flags}), device="cpu")
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, tb, jp, params_from_numpy(_np(jp), tcfg, "cpu")


def _port_loss_and_grads(tb, tp, batch):
    leaves = flatten(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    loss, aux = tb.train_loss(tp, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(leaves, grads)))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_train_loss_and_grads_match_reference(arch):
    jb, tb, jp, tp = _bridged(arch)
    batch = _batch(jb.cfg)
    (jl, jaux), jg = jax.value_and_grad(jb.train_loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    loss, aux, grads = _port_loss_and_grads(tb, tp, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6)
    assert aux["aux"].dtype == torch.float32
    _grad_close(grads, flatten(_np(jg)))


def test_sorted_moe_dispatch_gradients_match_reference():
    """tests/test_models.py::test_moe_grads_flow_through_sorted_dispatch
    against the port: every gradient, and the router learns."""
    d, f, e, k = 16, 32, 4, 2
    b = JParamBuilder(jax.random.PRNGKey(2), jnp.float32)
    j_moe.init(b, "moe", d, f, e, "swiglu")
    jp = b.params["moe"]
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 32, d)))

    def jloss(p):
        out, aux = j_moe.apply_sorted(p, jnp.asarray(x), k, "swiglu",
                                      group_size=32)
        return jnp.mean(out ** 2) + 0.01 * aux

    jg = jax.grad(jloss)(jp)
    tp = {n: _t(v).requires_grad_(True) for n, v in _np(jp).items()}
    out, aux = t_moe.apply_sorted(tp, _t(x), k, "swiglu", group_size=32)
    loss = torch.mean(out ** 2) + 0.01 * aux
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    _grad_close(grads, _np(jg))
    assert float(grads["router"].abs().sum()) > 0


@pytest.mark.parametrize("arch", ["gemma2-27b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m",
                                  "seamless-m4t-medium"])
def test_remat_keeps_loss_and_grads(arch):
    tcfg = t_smoke(T_ARCHS[arch])
    batch = _batch(tcfg)
    _, _, jp, _ = _bridged(arch)
    got = {}
    for remat in ("none", "full", "dots"):
        tb = t_build(tcfg, TFlags(**FLAGS, remat=remat), device="cpu")
        tp = params_from_numpy(_np(jp), tcfg, "cpu")
        got[remat] = _port_loss_and_grads(tb, tp, batch)
    loss0, _, g0 = got["none"]
    for remat in ("full", "dots"):
        loss, _, g = got[remat]
        assert float(loss) == float(loss0), remat
        for name in g0:
            assert torch.equal(g[name], g0[name]), (remat, name)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _j_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _t_mesh():
    return Mesh(("data", "model"), (1, 1), ("cpu",))


def test_microbatched_steps_match_reference_and_each_other():
    """tests/test_train.py::test_microbatched_step_matches_full_batch, both
    packages from the same bridged state, at its tolerances (loss 1e-4,
    params 2e-3), and each microbatch count against the reference's.
    AdamW's first step moves a param by about lr whatever its gradient,
    so the accumulated gradient is held on its own: ``grad_norm`` within
    1e-5 relative, and the first moment (``(1 - b1)`` times the clipped
    gradient) per leaf within 1e-4 of its largest magnitude."""
    arch = "phi4-mini-3.8b"
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    jb, tb = j_build(jcfg, JFlags(**FLAGS)), t_build(tcfg, TFlags(**FLAGS),
                                                      device="cpu")
    rng = np.random.default_rng(6)
    tok = rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    p0 = _np(jb.init(jax.random.PRNGKey(0)))
    outs = {}
    for m in (1, 4):
        step, p_sh, o_sh, _ = j_make_train_step(
            jb, _j_mesh(), J_POLICIES["fsdp_tp"], JAdamWConfig(lr=1e-3),
            microbatches=m)
        with jax.set_mesh(_j_mesh()):
            jp = JTrainer._put_tree(jax.tree.map(jnp.asarray, p0), p_sh)
            jo = JTrainer._put_tree(j_adamw.init(jp), o_sh)
            jp, jo, jm = step(jp, jo, dict(tokens=jnp.asarray(tok),
                                           labels=jnp.asarray(tok)))
        tstep, tp_sh, to_sh, bsh = t_make_train_step(
            tb, _t_mesh(), T_POLICIES["fsdp_tp"], TAdamWConfig(lr=1e-3),
            microbatches=m)
        assert flatten(tp_sh).keys() == flatten(p0).keys()
        tp = params_from_numpy(p0, tcfg, "cpu")
        tp, to, tm = tstep(tp, t_adamw.init(tp), dict(tokens=_t(tok),
                                                      labels=_t(tok)))
        assert int(to.step) == 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        _grad_close(flatten(to.m), flatten(_np(jo.m)))
        for k, w in flatten(_np(jp)).items():
            np.testing.assert_allclose(flatten(tp)[k].detach().numpy(), w,
                                       atol=2e-3)
        outs[m] = (tp, to, tm)
    (p1, o1, m1), (p4, o4, m4) = outs[1], outs[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    np.testing.assert_allclose(float(m4["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    _grad_close(flatten(o4.m), {k: v.numpy()
                                for k, v in flatten(o1.m).items()})
    for k, v in flatten(p1).items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   flatten(p4)[k].detach().numpy(),
                                   atol=2e-3)


def test_opt_state_bridge_starts_both_packages_alike():
    """One reference step's AdamW state bridged to the port: the next step
    of each package gives the same params."""
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    cfg = dict(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, p0)
    jp, jst, _ = j_adamw.update(jax.tree.map(jnp.asarray, _tree(rng)),
                                j_adamw.init(jp), jp, JAdamWConfig(**cfg))
    tp = jax.tree.map(_t, _np(jp))
    tst = opt_state_from_numpy(_np(jst), tp, "cpu")
    assert tst.step.dtype == torch.int32 and int(tst.step) == 1
    g = _tree(rng)
    jp, _, _ = j_adamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                              JAdamWConfig(**cfg))
    tp, _, _ = t_adamw.update(jax.tree.map(_t, g), tst, tp,
                              TAdamWConfig(**cfg))
    for k, w in flatten(_np(jp)).items():
        np.testing.assert_allclose(flatten(tp)[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _trainer(tmp, steps=4, arch="gemma-2b", injector=None, ckpt_every=2):
    cfg = t_smoke(T_ARCHS[arch])
    return Trainer(t_build(cfg, TFlags(**FLAGS), device="cpu"),
                   TCell("smoke", "train", *CELL), _t_mesh(),
                   T_POLICIES["fsdp_tp"], TAdamWConfig(lr=1e-3),
                   TrainConfig(steps=steps, ckpt_dir=tmp,
                               ckpt_every=ckpt_every, log_every=1),
                   injector=injector)


def test_loss_decreases_on_fixed_batch():
    tr = _trainer(None)
    params, opt, _ = tr.init_state()
    batch = tr._put(tr.data.batch_at(0))
    losses = []
    for _ in range(8):
        params, opt, m = tr.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    tr = _trainer(str(tmp_path / "run"), steps=4)
    assert tr.run() == 4
    params, opt = tr._final
    rp, ro, step = tr.restore_state()
    assert step == 4 and ro.step.dtype == torch.int32 and ro.step.shape == ()
    for k, v in flatten(params).items():
        assert torch.equal(flatten(rp)[k], v.detach()), k
    for k, v in flatten(opt.m).items():
        assert torch.equal(flatten(ro.m)[k], v), k
    mgr = CheckpointManager(str(tmp_path / "k"), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, dict(x=torch.full((4,), float(s)),
                         h=torch.full((3,), s / 3.0, dtype=torch.bfloat16)))
    assert mgr.all_steps() == [3, 4]
    out = mgr.restore(None, dict(x=torch.zeros(4), h=torch.zeros(3)))
    assert torch.equal(out["x"], torch.full((4,), 4.0))
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"], torch.full((3,), 4 / 3.0,
                                            dtype=torch.bfloat16))


def test_recovery_matches_uninterrupted_run(tmp_path):
    tr_a = _trainer(str(tmp_path / "a"), steps=6, ckpt_every=2)
    tr_a.run()
    p_ref, _ = tr_a._final
    tr_b = _trainer(str(tmp_path / "b"), steps=6, ckpt_every=2,
                    injector=FailureInjector(fail_at=(3, 5)))
    assert run_with_recovery(tr_b.run) == 6
    assert tr_b.injector.seen == {3, 5}
    p_rec, _ = tr_b._final
    for k, v in flatten(p_ref).items():
        np.testing.assert_allclose(flatten(p_rec)[k].detach().numpy(),
                                   v.detach().numpy(), atol=1e-6)


def test_straggler_monitor_flags():
    tr = _trainer(None)
    for i in range(10):
        tr.monitor.record(i, 0.1)
    assert not tr.monitor.flagged
    assert tr.monitor.record(10, 1.0)
    assert tr.monitor.flagged == [10]


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the reference wrote restores in the port, and one the
    port wrote restores in the reference's CheckpointManager: every leaf
    equal (params, AdamW moments, the int32 step)."""
    rng = np.random.default_rng(8)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    jp, jst, _ = j_adamw.update(jax.tree.map(jnp.asarray, _tree(rng)),
                                j_adamw.init(jp), jp, JAdamWConfig())
    jtree = dict(params=jp, opt=jst)
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(7, jtree)
    like = dict(params=jax.tree.map(_t, p0),
                opt=t_adamw.AdamWState(step=None, m=jax.tree.map(_t, p0),
                                       v=jax.tree.map(_t, p0)))
    got = CheckpointManager(str(tmp_path / "j")).restore(None, like)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 1
    assert got["opt"].step.shape == ()
    for part in ("params",):
        for k, w in flatten(_np(jtree[part])).items():
            np.testing.assert_array_equal(flatten(got[part])[k].numpy(), w)
    for name in ("m", "v"):
        for k, w in flatten(_np(getattr(jst, name))).items():
            np.testing.assert_array_equal(
                flatten(getattr(got["opt"], name))[k].numpy(), w)
    # the port writes, the reference reads
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(7, got)
    back = JCheckpointManager(str(tmp_path / "t")).restore(
        None, dict(params=jp, opt=jst))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launcher_trains_on_an_explicit_cpu(capsys, tmp_path):
    assert launch_train.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--steps", "3", "--seq", "32",
                              "--batch", "4", "--ckpt",
                              str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "finished at step 3 on cpu" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_train_flags_are_the_reference_launchers():
    from repro.launch import train as j_launch  # noqa: F401  (imports jax)
    assert launch_train.FLAGS.attn_impl == "chunked"
    want = dataclasses.asdict(JFlags(attn_impl="chunked", attn_bq=128,
                                     attn_bkv=128, loss_chunk=128,
                                     moe_impl="dense"))
    got = dataclasses.asdict(launch_train.FLAGS)
    for k in ("attn_impl", "attn_bq", "attn_bkv", "loss_chunk", "moe_impl",
              "remat", "aux_loss_weight", "kv_dtype"):
        assert got[k] == want[k], k
