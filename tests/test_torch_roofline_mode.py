"""The dry-run's roofline mode against the reference, on the CPU in
float32.

- ``unrolled_attention`` against ``repro.models.attention``'s on causal
  and non-causal inputs, a window, a softcap, an offset, a valid length
  and lengths that divide no block (values at the port's ``chunked``
  tolerance, 1e-4; gradients against ``jax.vjp`` at 1e-5), and against
  the port's ``chunked`` (equal: a skipped block adds exactly nothing);
- a roofline-mode trace of a small prefill cell: its FLOPs are the
  ``chunked`` trace's less exactly the skipped blocks' two matmuls, and
  the ``flash_inner`` scope's bytes are counted apart;
- the backward of the nodes made in the scope counts to it: a function
  run wholly inside the scope (plain and under a remat) counts all its
  bytes there; a train cell's scope bytes exceed its forward's and the
  remat's recomputation's while every other count stays what a trace
  without the scope gives, at 1x1 and (2, 2); a prefill cell's stay
  what the forward's scope gives; the reference's HLO counts a train
  step's transposed ops to the scope in the same way;
- ``default_flags(roofline=True)`` is the reference's.
"""
import contextlib
import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.roofline import fused_bytes_detail
from repro.models import RuntimeFlags as JFlags
from repro.models import attention as j_attn
from repro_torch.configs import ARCHS, ShapeCell, smoke_config
from repro_torch.core import roofline as rl
from repro_torch.dist import POLICIES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import RuntimeFlags
from repro_torch.models import attention as t_attn

# (B, Sq, Skv, Hq, Hkv, D, AttnParams kwargs, q_offset, kv_valid_len)
CASES = {
    "causal-gqa": (2, 40, 40, 8, 2, 16, dict(bq=16, bkv=16), 0, None),
    "window": (1, 37, 37, 4, 1, 32, dict(window=9, bq=16, bkv=8), 0, None),
    "softcap-ragged": (2, 27, 37, 4, 2, 16,
                       dict(softcap=3.0, bq=8, bkv=16), 0, None),
    "noncausal-cross": (1, 24, 48, 4, 2, 16,
                        dict(causal=False, bq=16, bkv=16), 0, None),
    "noncausal-valid": (2, 13, 40, 4, 4, 16,
                        dict(causal=False, bq=8, bkv=8), 0, 20),
    "offset-valid-window": (2, 12, 40, 4, 2, 16,
                            dict(window=12, bq=8, bkv=16), 20, 30),
}


def _inputs(case, grad=False):
    b, sq, skv, hq, hkv, d = CASES[case][:6]
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
                 + (((b, sq, hq, d),) if grad else ()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_unrolled_matches_reference_and_chunked(case):
    *_, kw, off, kvl = CASES[case]
    arrays = _inputs(case)
    jp = j_attn.AttnParams(impl="unrolled", **kw)
    want = jax.jit(lambda a, b, c: j_attn.unrolled_attention(
        a, b, c, jp, q_offset=off, kv_valid_len=kvl))(
            *map(jnp.asarray, arrays))
    tp = t_attn.AttnParams(impl="unrolled", **kw)
    got = t_attn.IMPLS["unrolled"](*map(torch.from_numpy, arrays), tp,
                                   q_offset=off, kv_valid_len=kvl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    chunked = t_attn.chunked_attention(*map(torch.from_numpy, arrays), tp,
                                       q_offset=off, kv_valid_len=kvl)
    torch.testing.assert_close(got, chunked, rtol=0, atol=0)
    bf16 = t_attn.unrolled_attention(
        *(torch.from_numpy(a).bfloat16() for a in arrays), tp,
        q_offset=off, kv_valid_len=kvl)
    assert bf16.dtype == torch.bfloat16 and bf16.shape == got.shape


def test_unrolled_gradients_match_reference():
    *_, kw, off, kvl = CASES["softcap-ragged"]
    q, k, v, do = _inputs("softcap-ragged", grad=True)
    jp = j_attn.AttnParams(impl="unrolled", **kw)

    def fwd_bwd(a, b, c, dout):
        out, vjp = jax.vjp(lambda x, y, z: j_attn.unrolled_attention(
            x, y, z, jp, q_offset=off, kv_valid_len=kvl), a, b, c)
        return (out,) + vjp(dout)

    want = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = t_attn.unrolled_attention(tq, tk, tv,
                                    t_attn.AttnParams(impl="unrolled", **kw),
                                    q_offset=off, kv_valid_len=kvl)
    got.backward(torch.from_numpy(do))
    for g, w in zip((got, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the roofline trace
# ---------------------------------------------------------------------------

BLOCK, SEQ, BATCH = 16, 64, 2


def _skipped(cfg, seq, block):
    """Attention blocks the unrolled loop skips in one prefill of ``seq``
    tokens, summed over the layers: wholly in the future, or wholly out
    of the layer's window."""
    n = seq // block
    specs = (list(cfg.layer_pattern) * cfg.num_pattern_blocks
             + list(cfg.remainder_specs))
    count = 0
    for spec in specs:
        w = spec.sliding_window
        for i in range(n):
            q_lo, q_hi = i * block, (i + 1) * block - 1
            for j in range(n):
                k_lo, k_hi = j * block, (j + 1) * block - 1
                count += (k_lo > q_hi
                          or (w is not None and q_lo - k_hi >= w))
    return count


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_roofline_trace_skips_masked_blocks(shape):
    """Smoke gemma2-27b (a window-16 layer and a global one), a prefill
    of 64 tokens in 16-token blocks on a meta mesh (at (2, 2) through
    the sharded forward): the devices' FLOPs together drop by the
    skipped blocks' two einsums (scores and p @ v) of 2 B Hq bq bkv D
    operations each."""
    cfg = smoke_config(ARCHS["gemma2-27b"])
    cell = ShapeCell("prefill_smoke", "prefill", SEQ, BATCH)
    mesh = Mesh(("data", "model"), shape, ("meta",) * (shape[0] * shape[1]))
    roof = dataclasses.replace(dryrun.default_flags(roofline=True),
                               attn_bq=BLOCK, attn_bkv=BLOCK)
    traces = {impl: dryrun.trace_cell(
        cfg, cell, mesh, POLICIES["fsdp_tp"],
        dataclasses.replace(roof, attn_impl=impl))
        for impl in ("chunked", "unrolled")}
    skipped = _skipped(cfg, SEQ, BLOCK)
    assert skipped == 2 * 6 + 3          # causal on both, window on one
    per_block = 2 * (2 * BATCH * cfg.num_heads * BLOCK * BLOCK * cfg.head_dim)
    full, unrolled = traces["chunked"], traces["unrolled"]
    assert unrolled.total_flops == sum(unrolled.flops)
    assert full.total_flops - unrolled.total_flops == skipped * per_block
    assert sum(full.flops) - sum(unrolled.flops) == skipped * per_block
    assert sum(full.flash_inner) == 0
    # the scope's bytes sit on the devices that ran the attention
    assert any(unrolled.flash_inner)
    assert ([f > 0 for f in unrolled.flash_inner]
            == [a != b for a, b in zip(full.flops, unrolled.flops)])
    cost = rl.cost_of(unrolled)
    assert 0 < cost.bytes_flash_inner <= cost.bytes_raw
    assert cost.bytes_fused == cost.bytes_raw < rl.cost_of(full).bytes_raw
    if shape != (1, 1):
        return
    # the dry-run's roofline record carries the scope's bytes
    rec = dryrun.run_cell(cfg, cell, pods="single", roofline=True,
                          meshes={"single_pod": mesh})
    r = rec["roofline"]
    assert 0 < r["bytes_flash_inner"] <= r["hlo_bytes_raw"]


def _forward_rule():
    """The rule before the backward counted: an op counts to the scope it
    is issued in (the forward's, and the remat's recomputation's)."""
    return mock.patch.object(rl.ScopeLog, "op_scope",
                             lambda self: rl.current_scope())


def _no_scope():
    """The unrolled attention without its scope."""
    return mock.patch.object(t_attn, "named_scope",
                             lambda name: contextlib.nullcontext())


@pytest.mark.parametrize("remat", [False, True])
def test_scope_counts_its_backward(remat):
    """A function whose forward runs wholly inside the scope, its backward
    run outside it on a given gradient: every byte of the trace, the
    backward's included, counts to the scope (under a remat too: its
    recomputation runs in the scope again); without the scope none
    does, and the bytes are the same."""
    from torch.utils.checkpoint import checkpoint

    def fn(x, w, scope):
        with scope():
            return torch.tanh(x @ w).exp() * 2

    def traced(scope):
        x, w = (torch.empty((8, 16, 16), device="meta", requires_grad=True)
                for _ in range(2))
        g = torch.empty((8, 16, 16), device="meta")

        def step():
            y = (checkpoint(fn, x, w, scope, use_reentrant=False) if remat
                 else fn(x, w, scope))
            y.backward(g)
        return rl.trace_step(step, [(x, 0), (w, 0), (g, 0)], 1)

    inside = traced(lambda: rl.named_scope(rl.FLASH_INNER))
    outside = traced(contextlib.nullcontext)
    assert inside.flash_inner == inside.bytes
    assert inside.bytes == outside.bytes and inside.bytes[0] > 0
    assert outside.flash_inner == [0]


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_roofline_train_cell_counts_the_backward(shape):
    """Smoke gemma-2b under the roofline flags (16-token blocks, remat
    ``full``), traced as ``run_cell`` traces it: a train cell's
    ``flash_inner`` exceeds, on every device, what the forward and the
    remat's recomputation give (the rule before the backward counted;
    at 1x1 exactly twice the prefill cell's), and its bytes, FLOPs,
    received bytes, arguments and peaks are those of a trace without
    the scope, device by device.  A prefill cell runs no backward: its
    counts are the forward rule's exactly.  At 1x1 the dry-run's record
    carries the train cell's new count."""
    cfg = smoke_config(ARCHS["gemma-2b"])
    mesh = Mesh(("data", "model"), shape, ("meta",) * (shape[0] * shape[1]))
    flags = dataclasses.replace(dryrun.default_flags(roofline=True),
                                attn_bq=BLOCK, attn_bkv=BLOCK)
    traces = {}
    for kind in ("train", "prefill"):
        cell = ShapeCell(f"{kind}_smoke", kind, SEQ, BATCH)

        def trace():
            return dryrun.trace_cell(cfg, cell, mesh, POLICIES["fsdp_tp"],
                                     flags, counter=False)
        new = trace()
        with _forward_rule():
            fwd = trace()
        with _no_scope():
            none = trace()
        for t in (fwd, none):
            assert (t.bytes, t.flops, t.recv, t.args, t.peak) == (
                new.bytes, new.flops, new.recv, new.args, new.peak)
        assert none.flash_inner == [0] * len(new.bytes)
        assert all(f <= b for f, b in zip(new.flash_inner, new.bytes))
        traces[kind] = new, fwd
    new, fwd = traces["train"]
    assert all(n > f > 0 for n, f in zip(new.flash_inner, fwd.flash_inner))
    pre_new, pre_fwd = traces["prefill"]
    assert pre_new.flash_inner == pre_fwd.flash_inner and any(
        pre_new.flash_inner)
    if shape != (1, 1):
        return
    # forward + recomputation: twice the forward's scope bytes
    assert fwd.flash_inner == [2 * pre_new.flash_inner[0]]
    rec = dryrun.run_cell(cfg, ShapeCell("train_smoke", "train", SEQ, BATCH),
                          pods="single", roofline=True,
                          meshes={"single_pod": mesh})
    want = rl.affine_extrapolate(
        *(rl.cost_of(dryrun.trace_cell(
            dryrun.reduced_cfg(cfg, nb), ShapeCell("t", "train", SEQ, BATCH),
            mesh, POLICIES["fsdp_tp"], dryrun.default_flags(roofline=True),
            counter=False)) for nb in (1, 2)), 1, 2, cfg.num_pattern_blocks)
    r = rec["roofline"]
    assert r["bytes_flash_inner"] == want.bytes_flash_inner
    assert r["hlo_bytes_raw"] == want.bytes_raw
    with _forward_rule():
        before = dryrun.run_cell(
            cfg, ShapeCell("train_smoke", "train", SEQ, BATCH),
            pods="single", roofline=True, meshes={"single_pod": mesh})
    b = before["roofline"]
    assert b["bytes_flash_inner"] < r["bytes_flash_inner"] <= r[
        "hlo_bytes_raw"] == b["hlo_bytes_raw"]
    assert (b["hlo_flops"], b["collective_bytes"]) == (
        r["hlo_flops"], r["collective_bytes"])


def test_reference_counts_the_transposed_ops_to_the_scope():
    """The behaviour the port copies: the reference's ``fused_bytes_detail``
    gives a train step of the unrolled attention (``jax.grad``) more
    ``flash_inner`` bytes than its forward alone, since the transposed
    ops keep the scope in their ``op_name``."""
    rng = np.random.default_rng(11)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 32, 2, 16))
                           .astype(np.float32)) for _ in range(3))
    jp = j_attn.AttnParams(impl="unrolled", bq=16, bkv=16)

    def loss(a, b, c):
        return jnp.sum(j_attn.unrolled_attention(a, b, c, jp) ** 2)

    fwd = jax.jit(loss).lower(q, k, v).compile().as_text()
    step = jax.jit(jax.grad(loss, argnums=(0, 1, 2))).lower(
        q, k, v).compile().as_text()
    (f_total, f_scope), (s_total, s_scope) = (fused_bytes_detail(t)
                                              for t in (fwd, step))
    assert 0 < f_scope["flash_inner"] < s_scope["flash_inner"] <= s_total


def test_roofline_flags_are_the_reference_dryruns():
    """Every field the port's flags share with the reference's, in both
    modes; of the reference's, only the JAX mesh, ``shd`` (its sharder),
    ``unroll_layers`` (a scan made a Python loop; the port's block loops
    are Python loops) and ``moe_group`` (the sorted dispatch's default
    group, never set) are not the port's.  Importing the reference's dry-run sets ``XLA_FLAGS`` for 512
    host devices, so jax's backend is up first and the variable comes
    back as it was."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    assert len(jax.devices()) == 1
    shared = ({f.name for f in dataclasses.fields(JFlags)}
              & {f.name for f in dataclasses.fields(RuntimeFlags)}) - {"mesh"}
    assert ({f.name for f in dataclasses.fields(JFlags)} - shared
            == {"mesh", "shd", "unroll_layers", "moe_group"})
    for roofline in (True, False):
        want = dataclasses.asdict(j_dryrun.default_flags(roofline=roofline))
        got = dataclasses.asdict(dryrun.default_flags(roofline=roofline))
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert dryrun.default_flags(roofline=True).attn_impl == "unrolled"
