"""The port's kernels' plain versions against the reference's kernels.

On the CPU the port runs the plain PyTorch version
(``repro_torch.kernels.ref``); it is held against the reference's Pallas
kernel (``repro.kernels.ops.paged_attention``, interpret mode on the CPU, as
the reference's own tests run it) and its oracle (``repro.kernels.ref``),
on the same inputs made with numpy.  Tolerances are those of
``tests/test_kernels.py``: 1e-4 in float32, 3e-2 in bfloat16 (inputs are
rounded to bfloat16 identically on both sides; the outputs differ by
where each side rounds).  The CUDA kernel itself runs only on a card:
``test_torch_cuda.py`` holds it against the plain version there, on the
same cases.

``decode_attention`` (K3) and ``matmul`` (K8) likewise, at the cases and
tolerances of ``tests/test_kernels.py`` (K3: 1e-4 / 3e-2, K8: 1e-4 /
2e-2), and with tiles left to the tuned plan on both sides.  K3's rows all
have ``valid_len >= 1``: a row with none gets the mean of V from the
reference's oracle (and the port's plain version, a copy of it), the mean
of its padding from the Pallas kernel, and 0 from the port's CUDA kernel
(ROADMAP C4), so such rows are checked only on the card.

``flash_attention`` (K2) likewise: the port's plain version against the
reference's Pallas kernel in interpret mode, with the reference's blocks at
16 or 32, at 2e-4 in float32 and 3e-2 in bfloat16 (the tolerances of
``tests/test_kernels.py``'s flash tests).  Every row of these cases sees a
key: where none does, the port returns 0 and the Pallas kernel a value
that depends on its block padding, so such rows are not compared.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import decode_core as tcore
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from test_torch_cuda import (CASES, DECODE_CASES, DECODE_TOL, FLASH_CASES,
                             FLASH_TOL, MATMUL_BLOCKS, MATMUL_MKN, MATMUL_TOL,
                             TOL, make_decode_inputs, make_flash_inputs,
                             make_inputs, make_matmul_inputs)


def _run_both(case, dtype):
    name, b, hq, hkv, d, page, n, vlens, kw = case
    kw = dict(kw)
    int8 = kw.pop("int8", False)
    q, k, v, table, vl, ks, vs = make_inputs(0, b, hq, hkv, d, page, n,
                                             vlens, int8)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jq = jnp.asarray(q, jdt)
    jk, jv = ((jnp.asarray(k), jnp.asarray(v)) if int8
              else (jnp.asarray(k, jdt), jnp.asarray(v, jdt)))
    jkw = dict(kw)
    tkw = dict(kw)
    if int8:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = ((torch.from_numpy(k), torch.from_numpy(v)) if int8
              else (torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)))
    jt, jvl = jnp.asarray(table), jnp.asarray(vl)
    tt, tvl = torch.from_numpy(table), torch.from_numpy(vl)
    want_kernel = jops.paged_attention(jq, jk, jv, jt, jvl, **jkw)
    want_oracle = jref.paged_attention(jq, jk, jv, jt, jvl, **jkw)
    got = tops.paged_attention(tq, tk, tv, tt, tvl, **tkw)
    return (np.asarray(want_kernel, np.float32),
            np.asarray(want_oracle, np.float32), got.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_paged_attention_matches_reference(case, dtype):
    want_kernel, want_oracle, got = _run_both(case, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_oracle, rtol=tol, atol=tol)


def test_fully_masked_row_is_exactly_zero():
    q, k, v, table, _, _, _ = make_inputs(1, 2, 4, 2, 16, 8, 3, [0, 0])
    out = tref.paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(table),
                               torch.zeros(2, dtype=torch.int32))
    assert torch.count_nonzero(out) == 0


def test_cpu_dispatch_takes_the_plain_path_and_kernel_refuses_cpu():
    """ops sends CPU tensors to the plain version; the kernel wrapper itself
    takes CUDA tensors only, with no fallback."""
    q, k, v, table, vl, _, _ = make_inputs(2, 2, 4, 1, 16, 8, 3, [5, 20])
    args = [torch.from_numpy(a) for a in (q, k, v, table, vl)]
    before = tpa.LAUNCHES
    out = tops.paged_attention(*args)
    assert tpa.LAUNCHES == before
    torch.testing.assert_close(out, tref.paged_attention(*args), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(*args)


@pytest.mark.parametrize("dtype, b, hkv, n_pages, want", [
    # tensor cores (4 warps of 16-token tiles): one block per SM in all,
    # while each warp of a full row walks 2 tiles
    ("bfloat16", 8, 1, 128, 8),      # main path: 16 wanted, 64 tiles cap it
    ("bfloat16", 5, 1, 16, 1),       # 8 tiles: one block writes the output
    ("bfloat16", 528, 1, 128, 1),    # the batch alone fills the card
    ("bfloat16", 1, 1, 1024, 64),    # one long row: at most 64 splits
    ("bfloat16", 8, 8, 128, 2),      # 64 (sequence, kv head) pairs
    # CUDA cores: 4 blocks per SM, at most one per 32-token tile
    ("float32", 8, 1, 128, 32),
    ("float32", 1, 1, 1024, 64),
])
def test_kernel_split_rule(dtype, b, hkv, n_pages, want):
    """How many blocks share a row's token walk, on a 132-SM card, for
    pages of 8 tokens at D 256."""
    dt = getattr(torch, dtype)
    assert tpa.split_count(tpa.route(dt, dt, 256), b, hkv, 8, n_pages,
                           132) == want


@pytest.mark.parametrize("q_dtype, want, merge", [
    # the int8 serve's geometry: the tensor cores' rule, 64 tiles cap 16
    ("bfloat16", 8, "cluster"),
    # float32 q keeps the CUDA cores' rule: 32 one-tile splits
    ("float32", 32, "counter"),
])
def test_kernel_split_rule_int8_pages(q_dtype, want, merge):
    """gemma-2b's int8 pages (B 8, 8/1 heads, D 256, 64 pages of 16
    tokens) on a 132-SM card: bfloat16 q takes the tensor-core route's
    split rule and merges its splits in a cluster."""
    route = tpa.route(getattr(torch, q_dtype), torch.int8, 256)
    splits = tpa.split_count(route, 8, 1, 16, 64, 132)
    assert (splits, tcore.merge_kind(route, splits)) == (want, merge)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_int8_ring_holds_the_merge_rows(d):
    """An int8 stage is half a bfloat16 one, so two of them are smaller
    than the 16 x (D + 8) floats a warp leaves for the block's merge; a
    warp's region is the larger of the two, and at every stage count the
    route allows the whole block fits a block's 227 KiB."""
    merge = 16 * (d + tcore.ACC_PAD) * 4
    assert tcore.MIN_STAGES * tcore.stage_bytes(d, 1) < merge
    fit = tcore.mma_stages_fit(d, tpa.MMA_WARPS, kv_bytes=1)
    assert fit >= tpa.MMA_STAGES
    for stages in range(tcore.MIN_STAGES, min(fit, tcore.MAX_STAGES) + 1):
        region = tcore.warp_ring_bytes(d, stages, 1)
        assert region >= merge and region >= stages * tcore.stage_bytes(d, 1)
        smem = tcore.mma_smem(d, tpa.MMA_WARPS, stages, 1)
        assert smem == (16 * d * 2 + tpa.MMA_WARPS * region
                        + tcore.recv_bytes(d))
        assert smem + tcore.STATIC_SMEM <= tcore.SMEM_BYTES
    cfg = tpa.kernel_config(torch.bfloat16, torch.int8, d, 16, 64, 8)
    assert (cfg.pages, cfg.stages) == ("int8", tpa.MMA_STAGES)


@pytest.mark.parametrize("q_dtype, kv_dtype, d, want", [
    ("bfloat16", "bfloat16", 256, "mma.sync tile=16 stages=3 warps=4"),
    ("bfloat16", "bfloat16", 64, "mma.sync tile=16 stages=3 warps=4"),
    ("bfloat16", "bfloat16", 32, "cuda-cores tile=32 stages=1 warps=4"),
    ("bfloat16", "int8", 256, "mma.sync tile=16 stages=3 warps=4 pages=int8"),
    ("bfloat16", "int8", 128, "mma.sync tile=16 stages=3 warps=4 pages=int8"),
    ("bfloat16", "int8", 64, "mma.sync tile=16 stages=3 warps=4 pages=int8"),
    ("bfloat16", "int8", 32, "cuda-cores tile=32 stages=1 warps=4"),
    ("float32", "int8", 256, "cuda-cores tile=32 stages=1 warps=8"),
    ("float32", "float32", 512, "cuda-cores tile=32 stages=1 warps=16"),
])
def test_kernel_config_routes_by_dtype_and_head_dim(q_dtype, kv_dtype, d,
                                                    want):
    """bfloat16 q with bfloat16 or int8 pages at D 64, 128 and 256 runs on
    the tensor cores (int8 pages named in the configuration); float32,
    float32 q with int8 pages and other head dims on the CUDA cores (the
    main path's table: 128 pages of 8 in 8 splits)."""
    cfg = tpa.kernel_config(getattr(torch, q_dtype), getattr(torch, kv_dtype),
                            d, 8, 128, 8)
    assert str(cfg) == want
    assert tpa.route(getattr(torch, q_dtype), getattr(torch, kv_dtype),
                     d) == cfg.route


@pytest.mark.parametrize("n_pages, splits, want", [
    (128, 8, 3),       # the main path: 512 bytes of page ids
    (2048, 8, 2),      # 8 KiB of page ids kept whole: 2 stages fit
    (4096, 1, 2),      # a split's 4097 page ids: 2 stages still fit
])
def test_kernel_ring_fits_the_page_ids(n_pages, splits, want):
    """At D 256 the tensor-core ring gives up stages to the page ids a
    block keeps; with the ring, the query rows and the cluster merge's
    buffers it always fits a block's 227 KiB."""
    cfg = tpa.kernel_config(torch.bfloat16, torch.bfloat16, 256, 8, n_pages,
                            splits)
    assert cfg.stages == want
    smem = (tcore.mma_smem(256, cfg.warps, cfg.stages)
            + 4 * tpa.pid_capacity(8, n_pages, splits) + tcore.STATIC_SMEM)
    assert smem <= tcore.SMEM_BYTES


def test_kernel_launch_refuses_a_configuration_of_other_pages():
    """A tensor-core configuration names its pages' type; a launch with
    pages of another type raises before anything reaches the card."""
    q, k, v, table, vl, ks, vs = make_inputs(2, 2, 8, 1, 64, 8, 3, [5, 20],
                                             int8=True)
    q = torch.from_numpy(q).to(torch.bfloat16)
    args = [torch.from_numpy(a) for a in (k, v, table, vl)]
    bf16_cfg = tpa.kernel_config(torch.bfloat16, torch.bfloat16, 64, 8, 3, 1)
    with pytest.raises(ValueError, match="does not match"):
        tpa.launch(q, *args, bf16_cfg, 1, k_scale=torch.from_numpy(ks),
                   v_scale=torch.from_numpy(vs))


def test_kernel_refuses_a_table_the_ring_cannot_fit_beside():
    with pytest.raises(ValueError, match="no room"):
        tpa.kernel_config(torch.bfloat16, torch.bfloat16, 256, 8, 32768, 1)


@pytest.mark.parametrize("route, splits, want", [
    ("mma.sync", 1, "none"),
    ("mma.sync", 2, "cluster"),
    ("mma.sync", 8, "cluster"),        # a portable cluster's most blocks
    ("mma.sync", 9, "counter"),
    ("mma.sync", 64, "counter"),
    ("cuda-cores", 8, "counter"),      # the CUDA-core bodies: counter only
])
def test_split_merge_rule(route, splits, want):
    """How a launch's splits merge inside it: through a thread-block
    cluster's shared memory or global partials and an arrival counter."""
    assert tcore.merge_kind(route, splits) == want


@pytest.mark.parametrize("page, n_pages, splits, want", [
    (8, 128, 8, 128),      # the main path's table row, whole
    (8, 2048, 64, 2048),   # the longest row kept whole
    (8, 4096, 16, 257),    # longer: a split's 128 tiles and one more page
    (16, 4096, 64, 65),    # 64 tiles of 16 tokens: 64 pages, plus one
])
def test_kernel_page_id_capacity(page, n_pages, splits, want):
    """Page ids a tensor-core block keeps in shared memory."""
    assert tpa.pid_capacity(page, n_pages, splits) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_plain_decode_attention_matches_reference_oracle(dtype, softcap):
    rng = np.random.default_rng(3)
    b, t, hq, hkv, d = 3, 19, 8, 2, 32
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vl = np.array([1, 11, 19], np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jref.decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                 jnp.asarray(v, jdt), jnp.asarray(vl),
                                 softcap=softcap)
    got = tref.decode_attention(torch.from_numpy(q).to(tdt),
                                torch.from_numpy(k).to(tdt),
                                torch.from_numpy(v).to(tdt),
                                torch.from_numpy(vl), softcap=softcap)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# flash_attention (K2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_plain_flash_attention_matches_reference_kernel(case, dtype):
    name, b, hq, hkv, sq, skv, d, block, kw = case
    arrays = make_flash_inputs(0, b, hq, hkv, sq, skv, d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                bq=block, bkv=block, interpret=True, **kw)
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in arrays), **kw)
    assert got.dtype == tdt and got.shape == (b, hq, sq, d)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_plain_flash_attention_matches_oracle_at_equal_lengths():
    """At Sq == Skv the two causal alignments agree: the reference's oracle
    (bottom-right) and the kernel's semantics (top-left)."""
    arrays = make_flash_inputs(1, 2, 4, 2, 40, 40, 16)
    for kw in (dict(), dict(window=7), dict(softcap=5.0)):
        want = jref.attention(*(jnp.asarray(a) for a in arrays), **kw)
        got = tref.flash_attention(*(torch.from_numpy(a) for a in arrays),
                                   **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_plain_flash_attention_rows_without_a_key_are_zero():
    q, k, v = (torch.from_numpy(a)
               for a in make_flash_inputs(2, 1, 4, 2, 20, 8, 16))
    out = tref.flash_attention(q, k, v, window=4)
    # causal + window 4 over 8 keys: rows 11.. see none
    assert torch.count_nonzero(out[:, :, 11:]) == 0
    assert bool((out[:, :, :11].abs().sum(-1) > 0).all())


def test_cpu_flash_dispatch_takes_the_plain_path_and_kernel_refuses_cpu():
    q, k, v = (torch.from_numpy(a)
               for a in make_flash_inputs(3, 1, 4, 1, 9, 9, 64))
    before = tfa.LAUNCHES
    out = tops.flash_attention(q, k, v, softcap=3.0)
    assert tfa.LAUNCHES == before
    torch.testing.assert_close(out, tref.flash_attention(q, k, v, softcap=3.0),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# decode_attention (K3)
# ---------------------------------------------------------------------------

def _decode_both(seed, b, hq, hkv, d, t, vlens, dtype, bkv, **kw):
    """(reference Pallas kernel in interpret mode, reference oracle, port
    through ops on the CPU), as float32 numpy."""
    arrays = make_decode_inputs(seed, b, hq, hkv, d, t, vlens)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in arrays[:3]] + [
        jnp.asarray(arrays[3])]
    targs = [torch.from_numpy(a).to(tdt) for a in arrays[:3]] + [
        torch.from_numpy(arrays[3])]
    want_kernel = jops.decode_attention(*jargs, bkv=bkv, interpret=True, **kw)
    want_oracle = jref.decode_attention(*jargs, **kw)
    got = tops.decode_attention(*targs, bkv=bkv, **kw)
    assert got.dtype == tdt and got.shape == (b, hq, d)
    return (np.asarray(want_kernel, np.float32),
            np.asarray(want_oracle, np.float32), got.float().numpy())


def _close_both(want_kernel, want_oracle, got, tol):
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bkv", [32, 96, 256])
@pytest.mark.parametrize("t", [100, 255, 256])
def test_plain_decode_attention_parity_sweep(dtype, bkv, t):
    """tests/test_kernels.py's parity sweep: ragged T, odd tiles."""
    _close_both(*_decode_both(0, 2, 4, 2, 32, t, [min(7, t), t], dtype, bkv),
                DECODE_TOL[dtype])


@pytest.mark.parametrize("vlens", [[7, 130, 256], [1, 64, 255]])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_plain_decode_attention_matches_reference_kernel(vlens, hq, hkv):
    _close_both(*_decode_both(1, 3, hq, hkv, 32, 256, vlens, "float32", 64),
                1e-4)


def test_plain_decode_attention_softcap():
    _close_both(*_decode_both(2, 2, 4, 2, 16, 128, [50, 128], "float32", 32,
                              softcap=10.0), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_plain_decode_attention_on_the_card_cases(case, dtype):
    """The card's cases (test_torch_cuda.py), held against the reference;
    a case that leaves its tile to the plan gives the reference 64."""
    name, b, hq, hkv, d, t, vlens, bkv, kw = case
    _close_both(*_decode_both(0, b, hq, hkv, d, t, vlens, dtype, bkv or 64,
                              **kw), DECODE_TOL[dtype])


def test_cpu_decode_dispatch_takes_the_plain_path_and_kernel_refuses_cpu():
    q, k, v, vl = (torch.from_numpy(a)
                   for a in make_decode_inputs(3, 2, 4, 2, 64, 40, [5, 40]))
    before = tda.LAUNCHES
    out = tops.decode_attention(q, k, v, vl, bkv=16, softcap=3.0)
    assert tda.LAUNCHES == before
    torch.testing.assert_close(out, tref.decode_attention(q, k, v, vl,
                                                          softcap=3.0),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(q, k, v, vl)
    with pytest.raises(ValueError, match="no path"):
        tops.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                              vl.to("meta"), bkv=16)


@pytest.mark.parametrize("t, d, g, itemsize, bkv, depth, want", [
    (1024, 128, 3, 2, 8, 16, 3),    # phi4-mini's plan: 128 rows over 4 warps
    (1024, 256, 8, 2, 8, 16, 3),    # gemma-2b's plan in bfloat16
    (1024, 256, 8, 4, 8, 16, 13),   # ... in float32: 13 stages fit 227 KiB
    (256, 64, 2, 4, 256, 2, 1),     # an explicit 256-row float32 tile
    (1024, 64, 1, 2, 64, 64, 8),    # bfloat16: never more than 8 a warp
    (1024, 64, 1, 4, 1, 64, 32),    # float32: never more than 32 in flight
])
def test_decode_ring_rule(t, d, g, itemsize, bkv, depth, want):
    """The stages the kernel runs for a plan's tile and depth."""
    assert tda.kernel_config(t, d, g, itemsize, bkv, depth).stages == want


def test_decode_ring_rule_refuses_a_tile_that_cannot_fit():
    with pytest.raises(ValueError, match="does not fit"):
        tda.kernel_config(1024, 256, 8, 4, 128, 2)
    with pytest.raises(ValueError, match="does not fit"):
        tda.stages_for(8, 256, 4, 128, 2)
    with pytest.raises(ValueError, match="bkv and depth"):
        tda.kernel_config(1024, 128, 3, 2, 8, 0)


@pytest.mark.parametrize("t, d, g, itemsize, bkv, depth, want", [
    # both models' plans (bkv 8, depth 16) in bfloat16: the tensor cores
    (1024, 128, 3, 2, 8, 16, "mma.sync tile=16 stages=3 warps=4"),
    (1024, 256, 8, 2, 8, 16, "mma.sync tile=16 stages=3 warps=4"),
    # float32 runs the plan's tile on the CUDA cores
    (1024, 128, 3, 4, 8, 16, "cuda-cores tile=8 stages=16 warps=4"),
    (1024, 256, 8, 4, 8, 16, "cuda-cores tile=8 stages=13 warps=8"),
    # an explicit 256-row tile: bfloat16 keeps 16-token warp tiles, its
    # ring capped by the 4 tiles a warp walks at T 256; float32 one stage
    (256, 64, 2, 2, 256, 2, "mma.sync tile=16 stages=5 warps=4"),
    (256, 64, 2, 4, 256, 2, "cuda-cores tile=256 stages=1 warps=4"),
    # a short cache: 7 tiles, 2 a warp
    (100, 64, 2, 2, 16, 16, "mma.sync tile=16 stages=3 warps=4"),
])
def test_decode_kernel_config(t, d, g, itemsize, bkv, depth, want):
    """The configuration the kernel runs for a plan's tiles
    (``kernel_config``), in the manner of K8's."""
    assert str(tda.kernel_config(t, d, g, itemsize, bkv, depth)) == want


@pytest.mark.parametrize("dtype, b, hkv, t, bkv, want", [
    ("bfloat16", 8, 8, 1024, 8, 2),     # phi4-mini at batch 8
    ("bfloat16", 8, 1, 1024, 8, 8),     # gemma-2b: 2 tiles a warp cap it
    ("bfloat16", 2, 2, 100, 32, 1),     # 7 tiles: one block a row
    ("bfloat16", 600, 1, 1024, 8, 1),   # the batch alone fills the card
    ("float32", 8, 8, 1024, 8, 9),      # CUDA cores: 4 blocks per SM
    ("float32", 2, 2, 100, 32, 4),      # a block per tile caps it
])
def test_decode_split_rule(monkeypatch, dtype, b, hkv, t, bkv, want):
    """Blocks sharing a row's token walk, on a 132-SM card."""
    monkeypatch.setattr(tda.core, "sm_count", lambda index: 132)
    dt = getattr(torch, dtype)
    q = torch.empty((b, hkv, 64), device="meta", dtype=dt)
    k = torch.empty((b, t, hkv, 64), device="meta", dtype=dt)
    assert tda.tiles(q, k, bkv, 2)["splits"] == want


# ---------------------------------------------------------------------------
# matmul (K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", MATMUL_BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", MATMUL_MKN)
def test_plain_matmul_matches_reference_kernel(mkn, dtype, blocks):
    m, k, n = mkn
    bm, bn, bk = blocks
    x, y = make_matmul_inputs(0, m, k, n)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    want_kernel = jops.matmul(jx, jy, bm=bm, bn=bn, bk=bk, interpret=True)
    want_oracle = jref.matmul(jx, jy)
    got = tops.matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
                      bm=bm, bn=bn, bk=bk)
    assert got.dtype == tdt and got.shape == (m, n)
    _close_both(np.asarray(want_kernel, np.float32),
                np.asarray(want_oracle, np.float32), got.float().numpy(),
                MATMUL_TOL[dtype])


@pytest.mark.parametrize("m, n, k, block, want", [
    (96, 64, 100, 64, (32, 64, 4)),
    (4096, 4096, 4096, 128, (128, 128, 128)),
    (8, 8192, 3072, 8, (8, 8, 8)),
    (100, 72, 700, 128, (100, 72, 4)),
])
def test_matmul_tiles_follow_the_references_fit(m, n, k, block, want):
    from repro_torch.tune import KernelPlan
    plan = KernelPlan(kernel="matmul", bq=block, bkv=block, head_dim=block)
    x, y = torch.empty((m, k), device="meta"), torch.empty((k, n),
                                                            device="meta")
    assert tops.matmul_tiles(x, y, plan=plan) == want
    # explicit tiles win, clamped to the dims
    assert tops.matmul_tiles(x, y, bm=512, bn=3, bk=5, plan=plan) == (
        min(512, m), 3, 5)


@pytest.mark.parametrize("bm, bn, bk, want", [
    (128, 128, 128, 128),    # the plan's tile: one stage of 128.5 KiB
    (128, 128, 512, 128),    # staged in sub-steps
    (8, 8, 8, 8), (32, 64, 4, 4),
    (128, 128, 300, 150),
])
def test_matmul_staging_rule(bm, bn, bk, want):
    assert tmm.staging(bm, bn, bk) == want


def test_matmul_staging_rule_refuses_wide_tiles():
    with pytest.raises(ValueError, match="tiles of 1 to 128"):
        tmm.staging(256, 128, 128)


# (m, n, k, the plan's bn, bases aligned, the configuration's
# (tile_m, tile_n, stages, staging))
KERNEL_CONFIG_CASES = [
    (8, 8192, 3072, 8, True, (64, 64, 8, "tma")),
    (1, 1024, 3072, 8, True, (64, 64, 8, "tma")),
    (64, 320, 512, 64, True, (64, 64, 8, "tma")),
    (65, 320, 512, 64, True, (128, 128, 6, "tma")),
    (4096, 4096, 4096, 128, True, (128, 256, 4, "tma")),
    (200, 520, 264, 128, True, (128, 256, 4, "tma")),
    (256, 200, 384, 128, True, (128, 128, 6, "tma")),
    (256, 384, 192, 64, True, (128, 128, 6, "tma")),
    (96, 64, 100, 64, True, (128, 128, 6, "elementwise")),
    (150, 300, 101, 128, True, (128, 256, 4, "elementwise")),
    (5, 93, 77, 8, True, (64, 64, 8, "elementwise")),
    (128, 320, 192, 128, False, (128, 256, 4, "elementwise")),
]


@pytest.mark.parametrize("m, n, k, bn, aligned, want", KERNEL_CONFIG_CASES)
def test_matmul_kernel_config_rule(m, n, k, bn, aligned, want):
    """The plan's tiles -> the bfloat16 route's compiled configuration:
    decode M, both N tiles, non-divisible dims, the reference's (96, 100,
    64), and shapes or bases TMA cannot take."""
    cfg = tmm.kernel_config(m, n, k, bn, aligned=aligned)
    assert dataclasses.astuple(cfg) == want
    assert tmm.compiled_configs()[cfg.tile_m, cfg.tile_n] == cfg.stages
    assert str(cfg) == (f"wgmma tile={want[0]}x{want[1]}x64 "
                        f"stages={want[2]} staging={want[3]}")


def test_matmul_compiled_configs_come_from_the_source():
    """The one list of bfloat16 configurations, read from the kernel's
    source: three tiles, each a whole number of 64-row warpgroups."""
    configs = tmm.compiled_configs()
    assert configs == {(128, 256): 4, (128, 128): 6, (64, 64): 8}
    assert all(tm % 64 == 0 for tm, _ in configs)


def test_matmul_kernel_config_follows_the_plan_at_the_timed_shapes():
    """At the timed shapes the plan's fitted tiles give the wide and the
    decode configurations."""
    from repro_torch.tune import KernelPlan
    for (m, n, k), block, tile in (((4096, 4096, 4096), 128, (128, 256)),
                                   ((8, 8192, 3072), 8, (64, 64))):
        plan = KernelPlan(kernel="matmul", bq=block, bkv=block,
                          head_dim=block)
        x = torch.empty((m, k), device="meta", dtype=torch.bfloat16)
        y = torch.empty((k, n), device="meta", dtype=torch.bfloat16)
        _, bn, _ = tops.matmul_tiles(x, y, plan=plan)
        cfg = tmm.kernel_config(m, n, k, bn)
        assert (cfg.tile_m, cfg.tile_n, cfg.staging) == (*tile, "tma")


@pytest.mark.parametrize("bad", [(0, 128, 128, 64), (128, 0, 128, 64),
                                 (128, 128, 0, 64), (128, 128, 128, 0)])
def test_matmul_kernel_config_refuses_empty_dims(bad):
    with pytest.raises(ValueError, match="must be >= 1"):
        tmm.kernel_config(*bad)


def test_kernels_route_by_dtype():
    """bfloat16 on the tensor cores, float32 on the CUDA cores; anything
    else is refused."""
    assert tmm.route(torch.bfloat16) == "wgmma"
    assert tmm.route(torch.float32) == "cuda-cores"
    assert tfa.route(torch.bfloat16) == "mma.sync"
    assert tfa.route(torch.float32) == "cuda-cores"
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        tmm.route(torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.route(torch.float16)
    x = torch.zeros((96, 100), dtype=torch.bfloat16)
    y = torch.zeros((100, 64), dtype=torch.bfloat16)
    assert tmm.configuration(x, y, bm=32, bn=64, bk=4).startswith(
        "wgmma tile=128x128x64 stages=6 staging=")
    assert tmm.configuration(x.float(), y.float(), bm=32, bn=64, bk=4) == (
        "cuda-cores tiles=(32,64,4) kc=4")


def _mm_operands(dtypes=("bfloat16", "bfloat16"), device="cpu",
                 shapes=((64, 32), (32, 48))):
    return tuple(torch.zeros(s, dtype=getattr(torch, dt), device=device)
                 for s, dt in zip(shapes, dtypes))


MATMUL_REFUSALS = [
    ("cpu-bfloat16", dict(), "CUDA"),
    ("cpu-float32", dict(dtypes=("float32", "float32")), "CUDA"),
    ("meta-bfloat16", dict(device="meta"), "CUDA"),
    ("mixed-dtypes", dict(dtypes=("bfloat16", "float32")), "both"),
    ("float16", dict(dtypes=("float16", "float16")), "both"),
    ("shapes", dict(shapes=((64, 32), (48, 32))), "shapes"),
]


@pytest.mark.parametrize("kw, match", [c[1:] for c in MATMUL_REFUSALS],
                         ids=[c[0] for c in MATMUL_REFUSALS])
def test_matmul_kernel_refuses_on_the_cpu(kw, match):
    x, y = _mm_operands(**kw)
    before = tmm.LAUNCHES
    with pytest.raises(ValueError, match=match):
        tmm.matmul(x, y, bm=64, bn=64, bk=64)
    assert tmm.LAUNCHES == before


def _fa_operands(dtypes=("bfloat16",) * 3, device="cpu", d=64):
    shapes = ((1, 4, 8, d), (1, 2, 8, d), (1, 2, 8, d))
    return tuple(torch.zeros(s, dtype=getattr(torch, dt), device=device)
                 for s, dt in zip(shapes, dtypes))


FLASH_REFUSALS = [
    ("cpu-bfloat16", dict(), "CUDA"),
    ("cpu-float32", dict(dtypes=("float32",) * 3), "CUDA"),
    ("meta-bfloat16", dict(device="meta"), "CUDA"),
    ("mixed-dtypes", dict(dtypes=("bfloat16", "float32", "float32")),
     "dtype"),
    ("float16", dict(dtypes=("float16",) * 3), "float32 or bfloat16"),
    ("d32", dict(d=32), "geometry"),
    ("d96", dict(d=96), "geometry"),
    ("d512", dict(d=512), "geometry"),
]


@pytest.mark.parametrize("kw, match", [c[1:] for c in FLASH_REFUSALS],
                         ids=[c[0] for c in FLASH_REFUSALS])
def test_flash_kernel_refuses_on_the_cpu(kw, match):
    q, k, v = _fa_operands(**kw)
    before = tfa.LAUNCHES
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, v)
    assert tfa.LAUNCHES == before


def test_sass_opcode_count():
    """The [sass] line's counter: opcodes, predicated or not, and never a
    word inside a comment."""
    from repro_torch.kernels.build import count_opcodes
    sass = """
        /*0450*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0460*/              @P0   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0470*/              @!PT  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0480*/                   FFMA R1, R2, R3, R4 ;  /* HMMA */
    """
    assert count_opcodes(sass, ("HGMMA", "HMMA", "LDSM")) == dict(
        HGMMA=1, HMMA=2, LDSM=0)


def test_cpu_matmul_dispatch_takes_the_plain_path_and_kernel_refuses_cpu():
    x, y = (torch.from_numpy(a) for a in make_matmul_inputs(4, 40, 24, 56))
    before = tmm.LAUNCHES
    out = tops.matmul(x, y, bm=8, bn=8, bk=8)
    assert tmm.LAUNCHES == before
    torch.testing.assert_close(out, tref.matmul(x, y), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tmm.matmul(x, y, bm=8, bn=8, bk=8)


# ---------------------------------------------------------------------------
# tiles left to the tuned plan, on both sides
# ---------------------------------------------------------------------------

def test_kernels_accept_tuned_plan_defaults():
    """tests/test_kernels.py's plan-default test: with memory-only plan
    caches on both sides and no tiles given, both packages resolve their
    plans, agree, and key them alike."""
    from repro.tune import PlanCache as JCache
    from repro.tune import set_default_cache as j_set
    from repro_torch.tune import PlanCache, set_default_cache
    jcache, tcache = JCache(None), PlanCache(None)
    j_set(jcache)
    set_default_cache(tcache)
    try:
        rng = np.random.default_rng(9)
        arr = [rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 16), (2, 90, 2, 16), (2, 90, 2, 16))]
        vl = np.asarray([13, 90], np.int32)
        want = jops.decode_attention(*(jnp.asarray(a) for a in arr),
                                     jnp.asarray(vl))
        got = tops.decode_attention(*(torch.from_numpy(a) for a in arr),
                                    torch.from_numpy(vl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        x, y = (rng.standard_normal(s).astype(np.float32)
                for s in ((96, 100), (100, 64)))
        want = jops.matmul(jnp.asarray(x), jnp.asarray(y))
        got = tops.matmul(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        for prefix in ("decode_attention|90x16|float32|",
                       "matmul|96x64x100|float32|"):
            assert any(key.startswith(prefix) for key in tcache.plans())
            assert any(key.startswith(prefix) for key in jcache.plans())
        # a bfloat16 tensor keys its plan "bfloat16", as the reference does
        xb = torch.from_numpy(x).to(torch.bfloat16)
        tops.matmul(xb, torch.from_numpy(y).to(torch.bfloat16))
        assert any(key.startswith("matmul|96x64x100|bfloat16|")
                   for key in tcache.plans())
    finally:
        j_set(None)
        set_default_cache(None)
