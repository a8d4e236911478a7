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
- ``default_flags(roofline=True)`` is the reference's.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
