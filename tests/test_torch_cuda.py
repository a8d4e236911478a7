"""The port's CUDA kernels on the card, held against their plain versions.

These tests import neither JAX nor the JAX package, so they run on a host
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card they skip: a CUDA kernel has no CPU mode.  The case tables
and input makers of ``paged_attention`` (K1), ``flash_attention`` (K2),
``decode_attention`` (K3) and ``matmul`` (K8) are shared with
``test_torch_kernels.py``, which holds the plain versions against the JAX
package on the CPU.  The memory engines' kernels (K4-K7)
copy, so they must equal their plain versions exactly;
``test_torch_memory.py`` holds those plain versions against the JAX
package.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import decode_core
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import pointer_chase as pc
from repro_torch.kernels import random_gather as rg
from repro_torch.kernels import ref
from repro_torch.kernels import stream_copy as sc
from repro_torch.kernels import strided_copy as st

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# flash_attention: the tolerances of tests/test_kernels.py's flash tests
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}

# (name, B, Hq, Hkv, D, page, N, valid lens, extra kwargs)
CASES = [
    ("gemma-geometry", 5, 8, 1, 256, 8, 6, [1, 7, 9, 16, 48], {}),
    ("gqa", 3, 8, 2, 32, 8, 5, [3, 17, 40], {}),
    ("softcap", 3, 4, 2, 32, 8, 5, [1, 20, 33], dict(softcap=20.0)),
    ("ring-window", 3, 4, 2, 32, 8, 4, [5, 30, 61], dict(window=24)),
    ("int8-lanes", 3, 8, 1, 64, 8, 5, [2, 25, 40], dict(int8=True)),
    # head dims the bfloat16 tensor-core route takes (64, 128, 256)
    ("softcap-d128", 3, 8, 2, 128, 8, 6, [1, 20, 48], dict(softcap=20.0)),
    ("ring-window-d256", 3, 8, 1, 256, 8, 4, [5, 30, 61], dict(window=24)),
    ("group-16", 2, 16, 1, 64, 8, 6, [9, 48], {}),
]


def make_inputs(seed, b, hq, hkv, d, page, n, vlens, int8=False):
    """numpy inputs: q, pools with a spare page 0, a shuffled page table
    (distinct pages per row), valid lengths, optional int8 scale lanes."""
    rng = np.random.default_rng(seed)
    pool = 1 + b * n
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (pool, page, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (pool, page, hkv, d)).astype(np.int8)
        ks = (rng.random((pool, page)) * 0.05).astype(np.float32)
        vs = (rng.random((pool, page)) * 0.05).astype(np.float32)
    else:
        k = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
        v = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
        ks = vs = None
    table = (1 + rng.permutation(b * n)).reshape(b, n).astype(np.int32)
    return q, k, v, table, np.asarray(vlens, np.int32), ks, vs


# (name, B, Hq, Hkv, Sq, Skv, D, the reference's bq = bkv, extra kwargs);
# every row of every case sees at least one key
FLASH_CASES = [
    ("phi4-geometry", 1, 24, 8, 128, 128, 128, 32, {}),
    ("gemma-geometry", 1, 8, 1, 96, 96, 256, 32, {}),
    ("ragged", 2, 4, 2, 77, 77, 64, 16, {}),
    ("window-96", 1, 4, 2, 128, 128, 64, 32, dict(window=96)),
    ("softcap-30", 1, 4, 2, 100, 100, 128, 16, dict(softcap=30.0)),
    ("cross-noncausal", 1, 4, 2, 64, 128, 64, 32, dict(causal=False)),
    ("cross-causal", 2, 4, 1, 96, 64, 64, 16, {}),
]


def make_flash_inputs(seed, b, hq, hkv, sq, skv, d):
    """numpy q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


# decode_attention (K3): (name, B, Hq, Hkv, D, T, valid lens, bkv — None
# leaves it to the tuned plan —, extra kwargs); every valid length >= 1
DECODE_CASES = [
    ("phi4-geometry-plan", 3, 24, 8, 128, 256, [1, 100, 256], None, {}),
    ("gemma-geometry-plan", 3, 8, 1, 256, 255, [7, 130, 255], None, {}),
    ("gemma-geometry-bkv32", 2, 8, 1, 256, 100, [1, 100], 32, {}),
    ("ref-4/2-bkv32", 2, 4, 2, 64, 100, [7, 100], 32, {}),
    ("ref-4/2-bkv96", 2, 4, 2, 64, 255, [7, 255], 96, {}),
    ("ref-4/2-bkv256", 2, 4, 2, 64, 256, [7, 256], 256, {}),
    ("softcap-10", 2, 4, 2, 128, 128, [50, 128], 32, dict(softcap=10.0)),
    ("group-16", 2, 32, 2, 64, 100, [7, 100], None, {}),
]
DECODE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def make_decode_inputs(seed, b, hq, hkv, d, t, vlens):
    """numpy q (B, Hq, D), k and v (B, T, Hkv, D), valid lengths."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            np.asarray(vlens, np.int32))


# matmul (K8): the reference's (m, k, n) triples and blocks, as in
# tests/test_kernels.py, and tolerances
MATMUL_MKN = [(128, 128, 128), (256, 128, 384), (64, 256, 128)]
MATMUL_BLOCKS = [(64, 64, 64), (128, 128, 128)]
MATMUL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def make_matmul_inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(case, dtype, dev):
    name, b, hq, hkv, d, page, n, vlens, kw = case
    kw = dict(kw)
    int8 = kw.pop("int8", False)
    q, k, v, table, vl, ks, vs = make_inputs(0, b, hq, hkv, d, page, n,
                                             vlens, int8)
    tdt = getattr(torch, dtype)
    tk, tv = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    if int8:
        kw.update(k_scale=torch.from_numpy(ks).to(dev),
                  v_scale=torch.from_numpy(vs).to(dev))
    else:
        tk, tv = tk.to(tdt), tv.to(tdt)
    args = (torch.from_numpy(q).to(dev, tdt), tk, tv,
            torch.from_numpy(table).to(dev), torch.from_numpy(vl).to(dev))
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, case, dtype):
    args, kw = _on_card(case, dtype, cuda)
    before = pa.LAUNCHES
    got = ops.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    want = ref.paged_attention(*args, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_bf16_within_one_rounding(cuda, case):
    """bfloat16 in, float32 math, one rounding out: the kernel is held
    against the plain version run in float32 on the same inputs."""
    (q, k, v, table, vl), kw = _on_card(case, "bfloat16", cuda)
    got = ops.paged_attention(q, k, v, table, vl, **kw).float()
    if k.dtype != torch.int8:
        k, v = k.float(), v.float()
    want = ref.paged_attention(q.float(), k, v, table, vl, **kw)
    assert bool(((got - want).abs()
                 <= TOL["float32"] + 2.0 ** -8 * want.abs()).all())


# the decode geometries of the model paths: gemma2-27b's local layers (a
# ring table of ring_slots = 4096/8 + 1 pages, window 4096) and global
# layers at up to 8192 tokens, softcap 50 and scale 144^-0.5, batch 4;
# gemma-2b with int8 pages of 16 tokens at a serve drain's lengths; and
# recurrentgemma-9b's local-attention layers: 16 query heads over one kv
# head (the whole 16-row tile of the mma) at D 256, a ring of 2048/8 + 1
# pages, window 2048, batch 8, two rows past the window
GEMMA2_SCALE = 144.0 ** -0.5
MODEL_CASES = [
    ("recurrentgemma-9b-ring", 8, 16, 1, 256, 8, 257,
     [2116, 2616, 80, 529, 273, 166, 401, 388], dict(window=2048)),
    ("gemma2-27b-ring", 4, 32, 16, 128, 8, 513, [4176, 5136, 300, 8000],
     dict(window=4096, softcap=50.0, scale=GEMMA2_SCALE)),
    ("gemma2-27b-global", 4, 32, 16, 128, 8, 1024, [4176, 5136, 300, 8192],
     dict(softcap=50.0, scale=GEMMA2_SCALE)),
    ("gemma-2b-int8", 8, 8, 1, 256, 16, 64,
     [273, 429, 166, 401, 388, 310, 385, 418], dict(int8=True)),
    # phi4-mini-3.8b at TP=2: each shard's 12 query heads over 4 kv heads
    # (group 3) at D 128, pages of 8 at max_len 1024, the drain's lengths,
    # on bf16 and int8 pages
    ("phi4-mini-tp2-drain", 8, 12, 4, 128, 8, 128,
     [273, 429, 166, 401, 388, 310, 385, 418], {}),
    ("phi4-mini-tp2-drain-int8", 8, 12, 4, 128, 8, 128,
     [273, 429, 166, 401, 388, 310, 385, 418], dict(int8=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_kernel_matches_plain_at_model_geometry(cuda, case, dtype):
    """K1 at the geometry its model paths give it, against the plain
    version (bfloat16 also within one rounding of the plain version run
    in float32); the launch counts once."""
    (q, k, v, table, vl), kw = _on_card(case, dtype, cuda)
    before = pa.LAUNCHES
    got = ops.paged_attention(q, k, v, table, vl, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    want = ref.paged_attention(q, k, v, table, vl, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        if k.dtype != torch.int8:
            k, v = k.float(), v.float()
        w32 = ref.paged_attention(q.float(), k, v, table, vl, **kw)
        assert bool(((got.float() - w32).abs()
                     <= TOL["float32"] + 2.0 ** -8 * w32.abs()).all())


# bfloat16 q with int8 pages on the tensor cores: (name, B, Hq, Hkv, D,
# page, N, valid lens, extra kwargs); a valid length of 0 leaves a row
# without a token
INT8_MMA_CASES = [
    ("d64-gqa-page8", 3, 8, 2, 64, 8, 6, [1, 20, 48], dict(int8=True)),
    ("d128-gqa-page16", 3, 8, 2, 128, 16, 6, [5, 50, 96], dict(int8=True)),
    ("d256-gqa-page16", 3, 8, 2, 256, 16, 6, [7, 70, 96], dict(int8=True)),
    ("d256-page8-empty-rows", 3, 8, 1, 256, 8, 12, [0, 33, 0], dict(int8=True)),
    ("softcap-d128", 3, 8, 2, 128, 8, 6, [1, 20, 48], dict(int8=True, softcap=20.0)),
    ("softcap-d256-page16", 2, 8, 1, 256, 16, 8, [100, 128],
     dict(int8=True, softcap=30.0)),
    ("ring-window-d256", 3, 8, 1, 256, 8, 4, [5, 30, 61], dict(int8=True, window=24)),
    ("ring-window-d64-page16", 3, 8, 2, 64, 16, 4, [9, 60, 130],
     dict(int8=True, window=40)),
]


def _within_one_rounding(got, q, k, v, table, vl, kw):
    """The kernel computes in float32 and rounds its output once: it is
    held against the plain version run in float32 on the same inputs."""
    want = ref.paged_attention(q.float(), k, v, table, vl, **kw)
    return bool(((got.float() - want).abs()
                 <= TOL["float32"] + 2.0 ** -8 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_MMA_CASES,
                         ids=[c[0] for c in INT8_MMA_CASES])
def test_kernel_int8_pages_on_the_tensor_cores(cuda, case):
    """bfloat16 q with int8 pages takes the tensor-core route (one launch),
    within one bfloat16 rounding of the float32 plain version; a row
    without a token is exactly 0."""
    (q, k, v, table, vl), kw = _on_card(case, "bfloat16", cuda)
    assert k.dtype == v.dtype == torch.int8
    assert pa.route(q.dtype, k.dtype, q.shape[2]) == "mma.sync"
    n_pages = table.shape[1]
    splits = pa.split_count("mma.sync", q.shape[0], k.shape[2], k.shape[1],
                            n_pages, decode_core.sm_count(cuda.index or 0))
    assert pa.kernel_config(q.dtype, k.dtype, q.shape[2], k.shape[1],
                            n_pages, splits).pages == "int8"
    before = pa.LAUNCHES
    got = ops.paged_attention(q, k, v, table, vl, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    assert _within_one_rounding(got, q, k, v, table, vl, kw)
    empty = vl == 0
    assert torch.count_nonzero(got[empty]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("splits, merge", [
    (2, "cluster"), (5, "cluster"), (8, "cluster"),   # a thread-block cluster
    (16, "counter"), (64, "counter"),                 # global partials
])
def test_kernel_int8_pages_split_merges(cuda, splits, merge):
    """int8 pages on the tensor cores with the walk split 2 to 64 ways:
    the cluster merge (2-8 splits) and the counter merge (more); at 64
    splits most blocks of the short row find no token.  Twice on the same
    buffers: the same bits, so the counters were reset."""
    (q, k, v, table, vl), kw = _on_card(
        ("split-rows", 2, 8, 2, 128, 16, 32, [100, 512], dict(int8=True)),
        "bfloat16", cuda)
    cfg = pa.kernel_config(q.dtype, k.dtype, 128, 16, 32, splits)
    assert cfg.pages == "int8"
    assert decode_core.merge_kind(cfg.route, splits) == merge
    first = pa.launch(q, k, v, table, vl, cfg, splits, **kw)
    second = pa.launch(q, k, v, table, vl, cfg, splits, **kw)
    assert torch.equal(first, second)
    assert _within_one_rounding(first, q, k, v, table, vl, kw)


@pytest.mark.cuda
def test_kernel_int8_pages_counter_merge_past_a_whole_table(cuda):
    """One row over 4096 pages of 8 (past WHOLE_TABLE, so each block loads
    its split's page ids): the split rule gives 64 splits, merged through
    global partials and an arrival counter."""
    case = ("long-row", 1, 8, 1, 256, 8, 4096, [30001], dict(int8=True))
    (q, k, v, table, vl), kw = _on_card(case, "bfloat16", cuda)
    splits = pa.split_count(pa.route(q.dtype, k.dtype, 256), 1, 1, 8, 4096,
                            decode_core.sm_count(cuda.index or 0))
    assert 4096 > pa.WHOLE_TABLE
    assert decode_core.merge_kind("mma.sync", splits) == "counter"
    got = ops.paged_attention(q, k, v, table, vl, **kw)
    assert _within_one_rounding(got, q, k, v, table, vl, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16])   # one block per row, and split rows
def test_kernel_fully_masked_row_is_exactly_zero(cuda, n):
    q, k, v, table, _, _, _ = make_inputs(1, 2, 8, 1, 256, 8, n, [0, 0])
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table)]
    out = ops.paged_attention(*args, torch.zeros(2, dtype=torch.int32,
                                                 device=cuda))
    assert torch.count_nonzero(out) == 0


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    (q, k, v, table, vl), _ = _on_card(CASES[1], "float32", cuda)
    before = pa.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           k, v, table, vl)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                           table, vl)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, k, v, table.long(), vl)
    with pytest.raises(ValueError, match="scale"):
        pa.paged_attention(q, k.to(torch.int8), v.to(torch.int8), table, vl)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention(q[..., :30].contiguous(), k[..., :30].contiguous(),
                           v[..., :30].contiguous(), table, vl)
    assert pa.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_more_splits_than_live_tiles(cuda, dtype):
    """Rows far shorter than their table (512 tokens): most blocks of a row
    find no live token, take the empty path and still arrive at the merge;
    the split rule's count and the most splits a launch takes (64)."""
    (q, k, v, table, vl), _ = _on_card(
        ("short-rows", 3, 8, 1, 256, 8, 64, [1, 17, 40], {}), dtype, cuda)
    want = ref.paged_attention(q, k, v, table, vl)
    route = pa.route(q.dtype, k.dtype, 256)
    for splits in (pa.split_count(route, 3, 1, 8, 64, 132), 64):
        cfg = pa.kernel_config(q.dtype, k.dtype, 256, 8, 64, splits)
        got = pa.launch(q, k, v, table, vl, cfg, splits)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, splits", [
    ("float32", 4),       # the CUDA cores: the counter merge
    ("bfloat16", 4),      # the tensor cores: a cluster merge (2-8 splits)
    ("bfloat16", 16),     # the tensor cores: the counter merge (> 8 splits)
])
def test_kernels_reset_their_arrival_counters(cuda, dtype, splits):
    """K1 and K3 called twice on the same buffers with split walks give the
    same bits both times: the block that merges a (sequence, kv head)'s
    splits resets its arrival counter, so no launch clears them (a cluster
    merge uses none)."""
    from repro_torch.kernels import decode_core
    (q, k, v, table, vl), _ = _on_card(
        ("split-rows", 2, 8, 1, 128, 8, 32, [100, 256], {}), dtype, cuda)
    cfg = pa.kernel_config(q.dtype, k.dtype, 128, 8, 32, splits)
    first = pa.launch(q, k, v, table, vl, cfg, splits)
    second = pa.launch(q, k, v, table, vl, cfg, splits)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), ref.paged_attention(
        q, k, v, table, vl).float(), rtol=TOL[dtype], atol=TOL[dtype])
    args, _ = _decode_on_card(DECODE_CASES[0], dtype, cuda)
    run = da.tiles(args[0], args[1], 8, 16)
    dcfg = decode_core.KernelConfig(run["route"], run["tile"], run["stages"],
                                    run["warps"])
    first = da.launch(*args, dcfg, splits)
    second = da.launch(*args, dcfg, splits)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), ref.decode_attention(
        *args).float(), rtol=DECODE_TOL[dtype], atol=DECODE_TOL[dtype])
    torch.cuda.synchronize()
    for counters in decode_core._COUNTERS.values():
        assert torch.count_nonzero(counters) == 0


# ---------------------------------------------------------------------------
# flash_attention (K2)
# ---------------------------------------------------------------------------

def _flash_on_card(case, dtype, dev):
    name, b, hq, hkv, sq, skv, d, _, kw = case
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, tdt)
               for a in make_flash_inputs(0, b, hq, hkv, sq, skv, d))
    return (q, k, v), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    (q, k, v), kw = _flash_on_card(case, dtype, cuda)
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = ref.flash_attention(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # float32 math, one rounding out
        want32 = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
        assert bool(((got.float() - want32).abs()
                     <= TOL["float32"] + 2.0 ** -8 * want32.abs()).all())


@pytest.mark.cuda
def test_flash_kernel_takes_the_models_strided_layout(cuda):
    """(B, S, H, D) activations viewed as (B, H, S, D): no copy in, and the
    output comes back with q's strides."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 70, 8, 128))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((2, 70, 2, 128))
                             .astype(np.float32)).to(cuda, torch.bfloat16)
            for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = ops.flash_attention(qt, kt, vt)
    assert got.stride() == qt.stride()
    want = ref.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.cuda
def test_flash_kernel_rows_without_a_key_are_zero(cuda):
    """A window with Sq > Skv leaves late rows no key: 0 in kernel and plain
    version alike (off the model path; not compared with the reference)."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in
               make_flash_inputs(5, 1, 4, 2, 160, 64, 64))
    got = ops.flash_attention(q, k, v, window=32)
    want = ref.flash_attention(q, k, v, window=32)
    assert torch.count_nonzero(got[:, :, 64 + 32 - 1:]) == 0
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    (q, k, v), _ = _flash_on_card(FLASH_CASES[2], "float32", cuda)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16))
    with pytest.raises(ValueError, match="geometry"):      # D 32
        fa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    # D 64 rows that start 4 bytes into a 65-wide buffer
    q1, k1, v1 = (torch.cat([t[..., :1], t], dim=-1)[..., 1:]
                  for t in (q, k, v))
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q1, k1, v1)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
    assert fa.LAUNCHES == before


# ---------------------------------------------------------------------------
# the memory engines: stream_copy (K4), strided_copy (K5), random_gather
# (K6), pointer_chase (K7)
# ---------------------------------------------------------------------------

def _data(shape, dtype, dev, seed=0):
    """Values in [-127, 127] so every dtype holds them, int8's extremes
    included."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 60).clip(-127, 127)
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


def _launched_once(module, fn):
    before = module.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    assert module.LAUNCHES == before + 1
    return out


# (case, shape, block_rows, block_cols, view, the dtypes that take the
# element route; the others take the bulk route).  The view is the array
# itself, "offset" (a contiguous view one element into a buffer) or
# "split" (its rows // 32-row parts, one call each, as num_kernels runs;
# in float32 each part has more bulk requests than its grid).
ALL = ("float32", "bfloat16", "int8")
STREAM_TILES = [
    ("whole-rows", (128, 128), 8, 0, None, ()),
    ("whole-rows-64", (256, 512), 64, 0, None, ()),
    ("narrow", (64, 384), 8, 128, None, ()),
    ("rows-of-7", (96, 7), 32, 0, None, ALL),
    ("1mib-tile", (4096, 1024), 256, 0, None, ()),
    ("tile-over-ring", (600, 1040), 300, 0, None, ()),
    ("narrow-over-stage", (32, 12288), 4, 6144, None, ()),
    ("offset-base", (64, 256), 16, 0, "offset", ALL),
    ("split-32", (49152, 1024), 256, 0, "split", ()),
]


def _stream_input(shape, dtype, dev, view):
    rows, cols = shape
    n = rows * cols + (view == "offset")
    flat = _data((n,), dtype, dev)
    return flat[n - rows * cols:].view(rows, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["copy", "rw"])
@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("case,shape,br,bc,view,element", STREAM_TILES,
                         ids=[t[0] for t in STREAM_TILES])
def test_stream_copy_kernel_is_exact(cuda, case, shape, br, bc, view,
                                     element, dtype, mode):
    x = _stream_input(shape, getattr(torch, dtype), cuda, view)
    parts = x.split(shape[0] // 32) if view == "split" else [x]
    route = "element" if dtype in element else "bulk"
    assert {sc.config(p, br, bc).route for p in parts} == {route}
    if view == "split" and dtype == "float32":
        assert all(sc.config(p, br, bc).requests > sc.config(p, br, bc).grid
                   for p in parts)
    before = sc.LAUNCHES
    got = torch.cat([ops.stream_copy(p, block_rows=br, block_cols=bc,
                                     mode=mode) for p in parts])
    torch.cuda.synchronize()
    assert sc.LAUNCHES == before + len(parts)
    assert torch.equal(got, ref.stream_copy(x, mode))


@pytest.mark.cuda
def test_stream_copy_bulk_counter_is_zero_between_launches(cuda):
    """The bulk route's request counter is reset by the launch's last
    block, so back-to-back launches of other sizes all copy everything.
    Each launch has more requests than its grid, so it takes tickets from
    the counter, and each size has its own data, so a request a stale
    counter skipped shows."""
    for seed, rows in enumerate((4096, 8192, 2048)):
        x = _data((rows, 1024), torch.float32, cuda, seed=seed)
        cfg = sc.config(x, 4)
        assert cfg.route == "bulk" and cfg.requests > cfg.grid
        assert torch.equal(sc.stream_copy(x, block_rows=4), x)
    torch.cuda.synchronize()
    counters = sc.decode_core.arrival_counters(x.device, 2)
    assert int(counters[:2].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2, 3, 7, 15, 64])
@pytest.mark.parametrize("block_rows", [4, 16])
def test_strided_copy_kernel_is_exact(cuda, stride, block_rows):
    """64 or 16 blocks: strides coprime with them and not."""
    x = _data((256, 64), torch.float32, cuda)
    got = _launched_once(st, lambda: ops.strided_copy(
        x, block_rows=block_rows, stride=stride))
    assert torch.equal(got, ref.strided_copy(x, block_rows=block_rows,
                                             stride=stride))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,br,stride", [
    ("bfloat16", (96, 40), 8, 5), ("int8", (60, 3), 1, 6),
    ("float32", (8 * 1025, 1024), 8, 32)])
def test_strided_copy_kernel_other_units(cuda, dtype, shape, br, stride):
    x = _data(shape, getattr(torch, dtype), cuda)
    got = ops.strided_copy(x, block_rows=br, stride=stride)
    assert torch.equal(got, ref.strided_copy(x, block_rows=br, stride=stride))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cols,br", [
    ("float32", 1, 1), ("float32", 16, 1), ("float32", 1024, 1),
    ("float32", 16, 4), ("bfloat16", 1, 1), ("int8", 3, 1), ("int8", 3, 4)])
def test_random_gather_kernel_is_exact(cuda, dtype, cols, br):
    """Units of 2 B to 4 KiB; 1000 LFSR indices over 512 rows repeat."""
    x = _data((512, cols), getattr(torch, dtype), cuda)
    idx = ops.lfsr_indices(1000, bits=16, device=cuda) % (512 // br)
    assert torch.unique(idx).numel() < idx.numel()
    got = _launched_once(rg, lambda: ops.random_gather(x, idx,
                                                       block_rows=br))
    assert torch.equal(got, ref.random_gather(x, idx, block_rows=br))


@pytest.mark.cuda
def test_random_gather_kernel_zeroes_units_out_of_range(cuda):
    x = _data((64, 16), torch.float32, cuda) + 200
    idx = torch.tensor([3, -1, 64, 5], dtype=torch.int32, device=cuda)
    got = rg.random_gather(x, idx)
    assert torch.equal(got[[0, 3]], x[[3, 5]])
    assert torch.count_nonzero(got[[1, 2]]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 12, 1 << 22, 1 << 26])
def test_pointer_chase_kernel_is_exact(cuda, n):
    """Chains sized for L1 (16 KiB), L2 (16 MiB) and HBM (256 MiB)."""
    table, _ = pc.chain(n, 7, cuda)
    got = _launched_once(pc, lambda: ops.pointer_chase(table, steps=8192))
    assert torch.equal(got, ref.pointer_chase(table, 8192))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 6, 1 << 16, 1 << 22])
def test_pointer_chase_kernel_64_chains(cuda, n):
    tables = torch.stack([pc.make_chain_randperm(n, c, cuda)
                          for c in range(64)])
    got = _launched_once(pc, lambda: ops.pointer_chase(tables, steps=1024))
    assert got.shape == (64, 1024, 1)
    assert torch.equal(got, ref.pointer_chase(tables, 1024))


@pytest.mark.cuda
def test_pointer_chase_kernel_ends_a_chain_at_a_bad_entry(cuda):
    table = torch.tensor([[2], [0], [7], [1]], dtype=torch.int32,
                         device=cuda)       # 0 -> 2 -> 7 (outside)
    got = pc.pointer_chase(table, steps=5)[:, 0].tolist()
    assert got == [2, -1, -1, -1, -1]


@pytest.mark.cuda
def test_memory_kernels_refuse_what_they_cannot_take(cuda):
    x = _data((64, 32), torch.float32, cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    table = pc.make_chain(64).to(cuda)
    before = (sc.LAUNCHES, st.LAUNCHES, rg.LAUNCHES, pc.LAUNCHES)
    with pytest.raises(ValueError, match="divide"):         # indivisible
        sc.stream_copy(x, block_rows=24)
    with pytest.raises(ValueError, match="divide"):
        sc.stream_copy(x, block_rows=8, block_cols=12)
    with pytest.raises(ValueError, match="2-D"):
        sc.stream_copy(x[None])
    with pytest.raises(ValueError, match="dtype"):
        sc.stream_copy(x.double())
    with pytest.raises(ValueError, match="mode"):
        sc.stream_copy(x, mode="add")
    with pytest.raises(ValueError, match="contiguous"):
        sc.stream_copy(x.t())
    with pytest.raises(ValueError, match="divide"):
        st.strided_copy(x, block_rows=24)
    with pytest.raises(ValueError, match="2-D"):
        st.strided_copy(x[None])
    with pytest.raises(ValueError, match="dtype"):
        st.strided_copy(x.double())
    with pytest.raises(ValueError, match="divide"):
        rg.random_gather(x, idx, block_rows=24)
    with pytest.raises(ValueError, match="2-D"):
        rg.random_gather(x[None], idx)
    with pytest.raises(ValueError, match="dtype"):
        rg.random_gather(x.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        rg.random_gather(x, idx.long())
    with pytest.raises(ValueError, match="int32"):
        pc.pointer_chase(table.long(), steps=8)
    with pytest.raises(ValueError, match=r"\(n, 1\)"):
        pc.pointer_chase(table[:, 0], steps=8)
    with pytest.raises(ValueError, match="steps"):
        pc.pointer_chase(table, steps=0)
    with pytest.raises(ValueError, match="CUDA"):
        sc.stream_copy(x.cpu())
    assert (sc.LAUNCHES, st.LAUNCHES, rg.LAUNCHES, pc.LAUNCHES) == before


# ---------------------------------------------------------------------------
# decode_attention (K3) and matmul (K8), tiles from the tuned plan
# ---------------------------------------------------------------------------

@pytest.fixture
def memory_plans():
    """A memory-only default plan cache, so no plan file is read."""
    from repro_torch.tune import PlanCache, set_default_cache
    set_default_cache(PlanCache(None))
    yield
    set_default_cache(None)


def _decode_on_card(case, dtype, dev):
    name, b, hq, hkv, d, t, vlens, bkv, kw = case
    q, k, v, vl = make_decode_inputs(0, b, hq, hkv, d, t, vlens)
    tdt = getattr(torch, dtype)
    return ((torch.from_numpy(q).to(dev, tdt), torch.from_numpy(k).to(dev, tdt),
             torch.from_numpy(v).to(dev, tdt), torch.from_numpy(vl).to(dev)),
            dict(kw, bkv=bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_kernel_matches_plain(cuda, memory_plans, case, dtype):
    args, kw = _decode_on_card(case, dtype, cuda)
    got = _launched_once(da, lambda: ops.decode_attention(*args, **kw))
    kw.pop("bkv")
    want = ref.decode_attention(*args, **kw)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # float32 math, one rounding out
        q, k, v, vl = args
        want32 = ref.decode_attention(q.float(), k.float(), v.float(), vl,
                                      **kw)
        assert bool(((got.float() - want32).abs()
                     <= TOL["float32"] + 2.0 ** -8 * want32.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3, 16, 32])
def test_decode_kernel_at_every_depth(cuda, depth):
    """The ring of tiles in flight changes no result."""
    args, _ = _decode_on_card(DECODE_CASES[0], "float32", cuda)
    got = da.decode_attention(*args, bkv=8, depth=depth)
    torch.testing.assert_close(got, ref.decode_attention(*args), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 64, 1024])   # one split, and many
def test_decode_kernel_rows_without_a_key_are_zero(cuda, t):
    """valid_len 0 (or below 0) leaves a row no key: exactly 0 here (the
    reference's oracle returns the mean of V, its kernel the mean of its
    padding; ROADMAP C4), and the other rows are unchanged."""
    q, k, v, _ = make_decode_inputs(3, 3, 8, 2, 128, t, [0, 0, 0])
    q, k, v = (torch.from_numpy(a).to(cuda) for a in (q, k, v))
    vl = torch.tensor([0, -5, t], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, vl, bkv=8)
    assert torch.count_nonzero(got[:2]) == 0
    torch.testing.assert_close(got[2:], ref.decode_attention(
        q[2:], k[2:], v[2:], vl[2:]), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_decode_kernel_clamps_valid_len_to_t(cuda):
    args, _ = _decode_on_card(DECODE_CASES[3], "float32", cuda)
    q, k, v, vl = args
    got = ops.decode_attention(q, k, v, vl + 1000, bkv=32)
    full = torch.full_like(vl, k.shape[1])
    torch.testing.assert_close(got, ref.decode_attention(q, k, v, full),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_decode_kernel_refuses_what_it_cannot_take(cuda):
    (q, k, v, vl), _ = _decode_on_card(DECODE_CASES[3], "float32", cuda)
    before = da.LAUNCHES
    with pytest.raises(ValueError, match="geometry"):      # D 32
        da.decode_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous(), vl)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16), vl)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da.decode_attention(q.half(), k.half(), v.half(), vl)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, vl)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, v, vl.long())
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q.cpu(), k.cpu(), v.cpu(), vl.cpu())
    with pytest.raises(ValueError, match="does not fit"):  # one tile > 227 KiB
        da.decode_attention(q, k, v, vl, bkv=1024)
    with pytest.raises(ValueError, match="bkv and depth"):
        da.decode_attention(q, k, v, vl, bkv=8, depth=0)
    assert da.LAUNCHES == before


def _matmul_on_card(m, k, n, dtype, dev, seed=0):
    tdt = getattr(torch, dtype)
    return tuple(torch.from_numpy(a).to(dev, tdt)
                 for a in make_matmul_inputs(seed, m, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", MATMUL_BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", MATMUL_MKN)
def test_matmul_kernel_matches_plain(cuda, mkn, dtype, blocks):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _matmul_on_card(*mkn, dtype, cuda)
    bm, bn, bk = blocks
    got = _launched_once(mm, lambda: ops.matmul(x, y, bm=bm, bn=bn, bk=bk))
    tol = MATMUL_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.matmul(x, y).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kernel_plan_tiles(cuda, memory_plans, dtype):
    """(m, k, n) = (96, 100, 64) with tiles left to the plan: its 64 tile
    fitted to (32, 64, 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _matmul_on_card(96, 100, 64, dtype, cuda)
    assert ops.matmul_tiles(x, y) == (32, 64, 4)
    got = _launched_once(mm, lambda: ops.matmul(x, y))
    tol = MATMUL_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.matmul(x, y).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(48, 40, 24), (128, 8, 256), (1, 128, 3),
                                   (128, 128, 512)])
def test_matmul_kernel_ragged_tiles(cuda, tiles):
    """Tiles that do not divide the dims, and a K step staged in
    sub-steps (bk 512 at 128 x 128 tiles)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _matmul_on_card(100, 700, 72, "float32", cuda)
    bm, bn, bk = tiles
    got = mm.matmul(x, y, bm=bm, bn=bn, bk=bk)
    torch.testing.assert_close(got, ref.matmul(x, y), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_matmul_kernel_bf16_within_one_rounding(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _matmul_on_card(256, 1024, 384, "bfloat16", cuda)
    got = ops.matmul(x, y, bm=128, bn=128, bk=128).float()
    want32 = ref.matmul(x.float(), y.float())
    assert bool(((got - want32).abs()
                 <= TOL["float32"] + 2.0 ** -8 * want32.abs()).all())


@pytest.mark.cuda
def test_matmul_kernel_refuses_what_it_cannot_take(cuda):
    x, y = _matmul_on_card(64, 32, 48, "float32", cuda)
    before = mm.LAUNCHES
    with pytest.raises(ValueError, match="tiles of 1 to 128"):
        mm.matmul(x, y, bm=256, bn=64, bk=64)
    with pytest.raises(ValueError, match="bk"):
        mm.matmul(x, y, bm=64, bn=64, bk=0)
    with pytest.raises(ValueError, match="both"):
        mm.matmul(x, y.to(torch.bfloat16), bm=64, bn=64, bk=32)
    with pytest.raises(ValueError, match="both"):
        mm.matmul(x.half(), y.half(), bm=64, bn=64, bk=32)
    with pytest.raises(ValueError, match="shapes"):
        mm.matmul(x, y.t().contiguous(), bm=64, bn=64, bk=32)
    with pytest.raises(ValueError, match="contiguous"):
        mm.matmul(x, y.t().contiguous().t(), bm=64, bn=64, bk=32)
    with pytest.raises(ValueError, match="CUDA"):
        mm.matmul(x.cpu(), y.cpu(), bm=64, bn=64, bk=32)
    assert mm.LAUNCHES == before


# ---------------------------------------------------------------------------
# the tensor-core routes of matmul (K8, wgmma) and flash_attention (K2,
# mma.sync) in bfloat16, held within one bfloat16 rounding of the float32
# plain version
# ---------------------------------------------------------------------------

def _bf16_matmul_holds(got, x, y):
    """Within MATMUL_TOL of the plain version, and within one bfloat16
    rounding of the float32 plain version plus twice the float32 bound on a
    K-term sum taken in another order (2 * K * 2^-24 * (|x| @ |y|))."""
    torch.testing.assert_close(got.float(), ref.matmul(x, y).float(),
                               rtol=MATMUL_TOL["bfloat16"],
                               atol=MATMUL_TOL["bfloat16"])
    want32 = ref.matmul(x.float(), y.float())
    acc = 2 * x.shape[1] * 2.0 ** -24 * (x.float().abs() @ y.float().abs())
    assert bool(((got.float() - want32).abs()
                 <= TOL["float32"] + 2.0 ** -8 * want32.abs() + acc).all())


# (name, m, k, n, plan tiles (bm, bn, bk), the configuration's tile, staging)
# against every compiled configuration: K != N with non-square tiles (a
# transposed B cannot pass by symmetry), ragged M, N and K, decode M, and
# shapes whose K or N is not a multiple of 8 (no TMA)
MATMUL_BF16_CASES = [
    ("wide-k-ne-n", 192, 320, 512, (128, 128, 64), (128, 256), "tma"),
    ("narrow-k-ne-n", 256, 192, 384, (64, 64, 64), (128, 128), "tma"),
    ("wide-ragged", 200, 264, 520, (128, 128, 128), (128, 256), "tma"),
    ("narrow-ragged", 130, 136, 200, (64, 64, 64), (128, 128), "tma"),
    ("decode-m1", 1, 3072, 1024, (8, 8, 8), (64, 64), "tma"),
    ("decode-m8", 8, 1024, 768, (8, 8, 8), (64, 64), "tma"),
    ("decode-m64", 64, 512, 320, (64, 64, 64), (64, 64), "tma"),
    ("decode-ragged", 37, 200, 136, (8, 8, 8), (64, 64), "tma"),
    ("reference-96x100x64", 96, 100, 64, (32, 64, 4), (128, 128),
     "elementwise"),
    ("wide-unaligned", 150, 101, 300, (128, 128, 128), (128, 256),
     "elementwise"),
    ("decode-unaligned", 5, 77, 93, (8, 8, 8), (64, 64), "elementwise"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATMUL_BF16_CASES,
                         ids=[c[0] for c in MATMUL_BF16_CASES])
def test_matmul_bf16_wgmma_matches_plain(cuda, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    _, m, k, n, (bm, bn, bk), tile, staged = case
    x, y = _matmul_on_card(m, k, n, "bfloat16", cuda, seed=m + k + n)
    cfg = mm.kernel_config(m, n, k, bn)
    assert ((cfg.tile_m, cfg.tile_n), cfg.staging) == (tile, staged)
    assert mm.configuration(x, y, bm=bm, bn=bn, bk=bk) == str(cfg)
    got = _launched_once(mm, lambda: mm.matmul(x, y, bm=bm, bn=bn, bk=bk))
    _bf16_matmul_holds(got, x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(128, 256), (128, 128), (64, 64)])
def test_matmul_bf16_misaligned_bases_stage_elementwise(cuda, tile):
    """TMA-aligned dims whose bases start 2 bytes into a buffer: staged
    element by element, same result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m = 128 if tile[0] == 128 else 16
    bn = 128 if tile[1] == 256 else 64
    k, n = 192, 320
    x0, y0 = _matmul_on_card(m, k, n, "bfloat16", cuda, seed=7)
    x = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda)[1:]
    y = torch.empty(k * n + 1, dtype=torch.bfloat16, device=cuda)[1:]
    x, y = x.view(m, k).copy_(x0), y.view(k, n).copy_(y0)
    assert "staging=elementwise" in mm.configuration(x, y, bm=64, bn=bn,
                                                     bk=64)
    assert f"tile={tile[0]}x{tile[1]}x" in mm.configuration(x, y, bm=64,
                                                           bn=bn, bk=64)
    got = _launched_once(mm, lambda: mm.matmul(x, y, bm=64, bn=bn, bk=64))
    _bf16_matmul_holds(got, x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 256])
def test_matmul_bf16_deep_k_within_one_rounding(cuda, m):
    """K = 4096: one bfloat16 rounding of the float32 plain version plus the
    float32 summation bound, decode and wide configurations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _matmul_on_card(m, 4096, 512, "bfloat16", cuda, seed=11)
    got = _launched_once(mm, lambda: ops.matmul(x, y, bm=128, bn=128,
                                                bk=128))
    _bf16_matmul_holds(got, x, y)


# (name, B, Hq, Hkv, Sq, Skv, D, kwargs): every row sees a key
FLASH_BF16_CASES = [
    ("d64-window", 1, 4, 2, 200, 200, 64, dict(window=40)),
    ("d64-cross-causal", 2, 4, 1, 96, 64, 64, {}),
    ("d128-softcap", 1, 8, 2, 150, 150, 128, dict(softcap=30.0)),
    ("d128-ragged", 2, 6, 3, 333, 333, 128, {}),
    ("d128-cross-noncausal", 2, 4, 2, 100, 356, 128, dict(causal=False)),
    ("d256-cross-noncausal", 2, 4, 1, 70, 130, 256, dict(causal=False)),
    ("d256-window-softcap", 1, 8, 1, 300, 300, 256,
     dict(window=100, softcap=50.0)),
]


def _flash_bf16_holds(got, q, k, v, kw):
    """Within FLASH_TOL of the plain version, and within 1e-4 + one
    bfloat16 rounding of the float32 plain version (chip_smoke.py's
    check)."""
    want = ref.flash_attention(q, k, v, **kw)
    tol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    want32 = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert bool(((got.float() - want32).abs()
                 <= TOL["float32"] + 2.0 ** -8 * want32.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd-view"])
@pytest.mark.parametrize("case", FLASH_BF16_CASES,
                         ids=[c[0] for c in FLASH_BF16_CASES])
def test_flash_bf16_mma_matches_plain(cuda, case, layout):
    """Contiguous (B, H, S, D), and the model's (B, S, H, D) activations
    viewed as (B, H, S, D)."""
    _, b, hq, hkv, sq, skv, d, kw = case
    assert fa.route(torch.bfloat16) == "mma.sync"
    arrays = make_flash_inputs(sq + d, b, hq, hkv, sq, skv, d)
    if layout == "bhsd":
        q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                   for a in arrays)
    else:
        q, k, v = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
                   .to(cuda, torch.bfloat16).transpose(1, 2) for a in arrays)
    got = _launched_once(fa, lambda: fa.flash_attention(q, k, v, **kw))
    assert got.stride() == q.stride()
    _flash_bf16_holds(got, q, k, v, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bf16_rows_without_a_key_are_exactly_zero(cuda, d):
    """Window 32 with Sq > Skv: rows from Skv + 31 on see no key and are
    exactly 0; the others hold the tight check."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               make_flash_inputs(d, 1, 4, 2, 160, 64, d))
    got = _launched_once(fa, lambda: fa.flash_attention(q, k, v, window=32))
    assert torch.count_nonzero(got[:, :, 64 + 32 - 1:]) == 0
    _flash_bf16_holds(got[:, :, :64 + 32 - 1], q[:, :, :64 + 32 - 1], k, v,
                      dict(window=32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bf16_block_fits_an_sm(cuda, d):
    """The block's registers and shared memory let at least one reside."""
    assert fa.occupancy(d) >= 1


# ---------------------------------------------------------------------------
# sampling and speculative decoding on the card (plain torch ops there)
# ---------------------------------------------------------------------------

def _same_on_card(fn, cuda, *cpu_args):
    got = fn(*(a.to(cuda) for a in cpu_args))
    want = fn(*cpu_args)
    return got.cpu(), want


@pytest.mark.cuda
def test_threefry_keys_and_bits_card_equal_cpu(cuda):
    from repro_torch.serve import prng
    from repro_torch.serve.sampling import subkey_chain

    keys = prng.split(prng.prng_key(3), 8)
    for fn in (lambda k: prng.random_bits(k, (256000,)),
               lambda k: prng.split(k, 3),
               lambda k: prng.fold_in(k, 12345),
               lambda k: torch.cat(subkey_chain(k, 4), dim=1),
               lambda k: prng.uniform(k, (256000,)).view(torch.int32)):
        got, want = _same_on_card(fn, cuda, keys)
        assert torch.equal(got, want)
    got, want = _same_on_card(lambda k: prng.gumbel(k, (256000,)), cuda,
                              keys)
    unit = torch.clamp(want.abs(), min=1.0).double() * 2.0 ** -23
    assert ((got.double() - want.double()).abs() / unit).max() <= 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("params", [dict(temperature=0.9, top_p=0.95),
                                    dict(temperature=0.8, top_k=50)])
def test_vocab_wide_draws_card_equal_cpu(cuda, params):
    from repro_torch.serve import prng
    from repro_torch.serve.sampling import SamplingParams, sample_tokens

    sp = SamplingParams(**params)
    logits = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (8, 256000)) * 4).astype(np.float32))
    for seed in range(4):
        keys = prng.split(prng.prng_key(seed), 8)
        got, want = _same_on_card(
            lambda k, l: sample_tokens(k, l, sp), cuda, keys, logits)
        assert torch.equal(got, want)


def _smoke_serving(seed):
    """Smoke gemma-2b bundles on the CPU and the card with the same
    float32 weights, drawn on the CPU from a seeded generator."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import build

    cfg = smoke_config(ARCHS["gemma-2b"])
    cpu = build(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(seed))
    card = build(cfg, device="cuda")
    return cpu, params, card, _tree_to(params, "cuda")


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def _drain(eng, seed=4):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, size=n).astype(
        np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(zip([5, 19, 11, 27, 8], [9, 5, 12, 7, 1]))]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    return [r.out_tokens for r in reqs]


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["native", "int8"])
def test_sampled_drain_card_equals_cpu(cuda, no_tf32, kv):
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cpu, params, card, cparams = _smoke_serving(0)
    flags = RuntimeFlags(kv_dtype=kv)
    cpu, card = build(cpu.cfg, flags, "cpu"), build(card.cfg, flags, "cuda")
    sp = SamplingParams(temperature=0.9, top_p=0.95)
    outs, keys = [], []
    for bundle, p, dev in ((cpu, params, "cpu"), (card, cparams, "cuda")):
        eng = ServeEngine(bundle, p, 2, 64, prefill_chunk=8, sampling=sp,
                          seed=3, device=dev)
        outs.append(_drain(eng))
        keys.append(eng.keys.cpu())
    assert outs[0] == outs[1]
    assert torch.equal(keys[0], keys[1]) and keys[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_p=0.95)])
def test_spec_drain_equals_vanilla_on_the_card(cuda, no_tf32, sampling):
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    _, _, card, params = _smoke_serving(0)
    _, _, _, dparams = _smoke_serving(1)          # a draft from another seed
    sp = SamplingParams(**sampling)
    vanilla = ServeEngine(card, params, 2, 64, prefill_chunk=8, sampling=sp,
                          seed=3)
    spec = ServeEngine(card, params, 2, 64, prefill_chunk=8, sampling=sp,
                       seed=3, draft_bundle=card, draft_params=dparams,
                       spec_k=3)
    assert _drain(spec) == _drain(vanilla)
    st = spec.stats
    assert st.spec_steps > 0 and 0 <= st.draft_accepted <= st.draft_tokens
    a = spec.alloc
    assert a.pages_in_use + len(a.free) == a.num_pages - a.reserved
    assert all(r >= 1 for r in a.ref.values())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["paged", "dense"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_hybrid_drain_card_equals_cpu(cuda, no_tf32, arch, backend):
    """Smoke hybrid stacks, float32 weights drawn on the CPU: the card's
    greedy tokens equal the CPU's.  Paged recurrentgemma-9b runs K1 once
    per attention layer a tick over its ring (window 16: the 27-token
    prompt turns it); mamba2-130m has no attention layer and no pool, and
    launches nothing."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ATTN
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine

    cfg = smoke_config(ARCHS[arch])
    cpu = build(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    outs = []
    for bundle, p in ((cpu, params),
                      (build(cfg, device="cuda"), _tree_to(params, "cuda"))):
        eng = ServeEngine(bundle, p, 2, 64, cache_backend=backend,
                          prefill_chunk=8, device=str(bundle.device))
        before = pa.LAUNCHES
        outs.append(_drain(eng))
    n_attn = sum(s.mixer == ATTN for s in cfg.layer_pattern) * \
        cfg.num_pattern_blocks
    launches = pa.LAUNCHES - before
    if backend == "paged":
        assert launches == n_attn * eng.stats.decode_steps
        assert (launches > 0) == (arch == "recurrentgemma-9b")
        if arch == "recurrentgemma-9b":
            assert eng.stats.ring_pages_reused > 0
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the paper's Tables 9 and 10, the roofline rows, the advisor, the fit
# ---------------------------------------------------------------------------

PAPER_SWEEPS = ("database", "conv", "roofline")
# the structural columns of a row: what does not depend on timing
PAPER_COLUMNS = ("paper_u280_gbps", "paper_cpu_s", "paper_fpga2ch_s",
                 "paper_fpga32ch_s", "note", "advice", "bytes_moved",
                 "status", "reason", "source", "compute_ms", "memory_ms",
                 "collective_ms", "dominant", "useful_flops_ratio", "frac",
                 "working_set_bytes")


def _structural(run):
    return [(r.sweep, r.name, r.pattern, r.knobs,
             {k: r.extras.get(k) for k in PAPER_COLUMNS})
            for r in run.results]


@pytest.mark.cuda
def test_paper_tables_card_rows_equal_cpu_rows(cuda):
    from repro_torch.bench import run_sweeps
    runs = [run_sweeps(names=list(PAPER_SWEEPS), fast=True, echo=False,
                       device=dev) for dev in ("cpu", "cuda")]
    for run in runs:
        assert not run.failures, run.failures
    assert _structural(runs[1]) == _structural(runs[0])
    for r in runs[1].results:
        if r.extras.get("bytes_moved"):
            assert 0 < r.gbps_measured < 1.05 * 3350, r.name


@pytest.mark.cuda
def test_fused_conv_matches_numpy_on_the_card(cuda):
    from repro_torch.bench.sweeps import conv
    rng = np.random.default_rng(3)
    tile = rng.standard_normal((74, 74)).astype(np.float32)
    ker = np.ones((11, 11), np.float32) / 121
    got = conv.conv_valid(torch.from_numpy(tile).to(cuda)[None, None],
                          torch.from_numpy(ker).to(cuda)[None, None])
    np.testing.assert_allclose(got[0, 0].cpu().numpy(),
                               conv.naive_conv(tile, ker), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def card_fit():
    """The fit of the memory rows that calibrate reads, at the card's own
    sizes (1 GiB working sets), and the median HBM ns/hop they measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.bench import calibrate, run_sweeps
    from repro_torch.bench.calibrate import CALIBRATION_SWEEPS
    run = run_sweeps(names=list(CALIBRATION_SWEEPS), echo=False,
                     device="cuda")
    assert not run.failures, run.failures
    hops = sorted(float(r.extras["ns_per_hop"]) for r in run.results
                  if r.name.startswith("latency_region_"))
    return calibrate(run=run), hops[len(hops) // 2]


@pytest.mark.cuda
def test_card_fit_is_physical(card_fit):
    cal, hop_ns = card_fit
    assert 0.5 <= cal.spec.latency_s * 1e9 / hop_ns <= 2.0, \
        (cal.spec.latency_s, hop_ns)
    assert 0.5 <= cal.spec.hbm_bw / 3.35e12 <= 1.05, cal.spec.hbm_bw


@pytest.mark.cuda
def test_advisor_on_the_card_equals_the_cpu(card_fit):
    from repro_torch.bench import run_sweeps
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME
    from repro_torch.core.advisor import advise_model, render_report
    runs = [run_sweeps(names=["roofline"], echo=False, device=dev)
            for dev in ("cpu", "cuda")]
    assert _structural(runs[1]) == _structural(runs[0])
    cal, _ = card_fit
    for arch, shape in (("gemma-2b", "decode_32k"),
                        ("gemma2-27b", "train_4k")):
        reports = advise_model(ARCHS[arch], SHAPES_BY_NAME[shape],
                               calibration=cal)
        assert all(r.predicted_gbps > 0 and r.measured_vs_predicted
                   for r in reports)
        assert "meas/pred" in render_report(reports).splitlines()[0]


# ---------------------------------------------------------------------------
# preemption: the host tier's page copies and chaos drains
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_page_swap_round_trip_is_bitwise(cuda, kv):
    """The engine's gather (``index_select`` into pinned host memory) and
    scatter (``index_copy_`` at other page ids) move a bf16 pool's and an
    int8 pool's pages and scale lanes bit for bit, on the card as on the
    CPU, and the checksum reads the same bytes on both."""
    from repro_torch.configs import ARCHS, override, smoke_config
    from repro_torch.models import RuntimeFlags, build
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.hosttier import checksum_pages, tree_leaves

    cfg = override(smoke_config(ARCHS["gemma-2b"]), param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    flags = RuntimeFlags(kv_dtype="int8" if kv == "int8" else "native")
    src, dst = [3, 5, 7, 1, 12], [9, 2, 11, 4, 6]
    g = torch.Generator().manual_seed(0)
    got = {}
    for dev in ("cpu", "cuda"):
        bundle = build(cfg, flags, device=dev)
        eng = ServeEngine(bundle, bundle.init(torch.Generator(
            device=dev).manual_seed(0)), 2, 64, page_size=8, device=dev)
        g.manual_seed(0)
        for _, leaf in tree_leaves(eng.cache):
            fill = (torch.randint(-127, 128, leaf.shape, generator=g)
                    if leaf.dtype == torch.int8
                    else torch.randn(leaf.shape, generator=g))
            leaf.copy_(fill.to(leaf.dtype))
        data = eng._gather_to_host(src)
        for _, t in tree_leaves(data):
            assert t.device.type == "cpu"
            assert t.is_pinned() == (dev == "cuda")
        eng._scatter_from_host(dst, data)
        moved = {p: leaf.index_select(1 if p[0] == "blocks" else 0,
                                      torch.tensor(dst, device=dev)).cpu()
                 for p, leaf in tree_leaves(eng.cache)}
        origin = {p: t.narrow(1 if p[0] == "blocks" else 0, 0, len(src))
                  for p, t in tree_leaves(data)}
        for p in moved:
            assert torch.equal(moved[p].view(torch.uint8),
                               origin[p].contiguous().view(torch.uint8)), p
        got[dev] = (moved, checksum_pages(data, len(src)))
    assert got["cpu"][1] == got["cuda"][1]
    for p in got["cpu"][0]:
        assert torch.equal(got["cpu"][0][p].view(torch.uint8),
                           got["cuda"][0][p].view(torch.uint8)), p


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "swap", "recompute"])
@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_p=0.95)])
def test_chaos_drain_card_equals_cpu(cuda, no_tf32, mode, sampling):
    """A smoke gemma-2b drain under chaos (storms, phantom exhaustion,
    corrupted swaps) gives the same tokens, keys and counters on the card
    as on the CPU, and the undisturbed drain's tokens."""
    import dataclasses

    from repro_torch.serve import ChaosConfig, ChaosEngine, ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cpu, params, card, cparams = _smoke_serving(0)
    sp = SamplingParams(**sampling)
    runs = []
    for bundle, p, dev in ((cpu, params, "cpu"), (card, cparams, "cuda")):
        eng = ServeEngine(bundle, p, 2, 64, prefill_chunk=8, sampling=sp,
                          seed=3, device=dev)
        want = _drain(eng)
        eng.reset()
        got = _drain(ChaosEngine(eng, ChaosConfig(
            seed=5, preempt_prob=0.5, exhaust_prob=0.3, corrupt_prob=0.3,
            mode=mode)))
        assert got == want and eng.stats.preemptions > 0
        runs.append((got, dataclasses.asdict(eng.stats), eng.keys.cpu()))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][2], runs[1][2])


# ---------------------------------------------------------------------------
# the cluster front end and the disaggregated pools
# ---------------------------------------------------------------------------

KILL_SCHEDULE = dict(seed=5, crash_rounds=4, brownout_rounds=4,
                     brownout_latency_s=1.0,
                     kill_at=((0, 0, "admit"), (0, 1, "admit"),
                              (2, 1, "crash"), (12, 0, "brownout")))


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_p=0.95)])
def test_cluster_kill_schedule_card_equals_cpu(cuda, no_tf32, sampling):
    """Two smoke gemma-2b replicas (one weight tree) drain open-loop
    traffic undisturbed and under the ``cluster_serve`` kill schedule: on
    the card as on the CPU, the tokens, keys, every ServeStats and
    ClusterStats field and the percentiles agree, and the chaos drain's
    tokens are the undisturbed ones (float32)."""
    import dataclasses

    from repro_torch.serve import (ClusterChaos, ClusterChaosConfig,
                                   ClusterFrontEnd, ServeEngine,
                                   TrafficConfig, generate_traffic)
    from repro_torch.serve.sampling import SamplingParams

    cpu, params, card, cparams = _smoke_serving(0)
    tcfg = TrafficConfig(seed=23, n_requests=8, rate=1.2, burst_rate_mult=3.0,
                         phase_rounds=4.0, n_prefixes=3, prefix_len=16,
                         tail_lo=3, tail_hi=9, out_lo=6, out_hi=12)
    runs = []
    for bundle, p, dev in ((cpu, params, "cpu"), (card, cparams, "cuda")):
        front = ClusterFrontEnd([ServeEngine(
            bundle, p, 2, 64, window=4, prefill_chunk=8,
            sampling=SamplingParams(**sampling), seed=3, device=dev)
            for _ in range(2)])
        got = []
        for chaos in (None, ClusterChaos(ClusterChaosConfig(
                **KILL_SCHEDULE))):
            front.reset()
            sched = generate_traffic(tcfg, bundle.cfg.vocab_size)
            front.run(sched, chaos=chaos)
            got.append([list(r.out_tokens) for _, r in sched])
        assert got[0] == got[1] and front.cstats.failovers >= 1
        runs.append((got, dataclasses.asdict(front.cstats),
                     [dataclasses.asdict(e.stats) for e in front.engines],
                     torch.cat([e.keys.cpu() for e in front.engines]),
                     front.percentiles()))
    (g0, c0, s0, k0, p0), (g1, c1, s1, k1, p1) = runs
    assert (g0, c0, s0, p0) == (g1, c1, s1, p1)
    assert torch.equal(k0, k1)


@pytest.mark.cuda
@pytest.mark.parametrize("corrupt", [0.0, 1.0])
def test_disagg_drain_card_equals_cpu(cuda, no_tf32, corrupt):
    """A smoke gemma-2b prefill -> decode hand-off (every transfer
    corrupted in transit, or none): on the card as on the CPU the tokens,
    every ServeStats and DisaggStats field agree, and equal a colocated
    drain's tokens (float32)."""
    import dataclasses

    from repro_torch.serve import (DisaggChaos, DisaggChaosConfig,
                                   DisaggConfig, DisaggPool, ServeEngine)

    cpu, params, card, cparams = _smoke_serving(0)
    runs = []
    for bundle, p, dev in ((cpu, params, "cpu"), (card, cparams, "cuda")):
        def make():
            return ServeEngine(bundle, p, 2, 64, window=4, prefill_chunk=8,
                               device=dev)
        want = _drain(make())
        pool = DisaggPool([make()], [make()], DisaggConfig(force="disagg"))
        got = _drain(_pool_view(pool, DisaggChaos(DisaggChaosConfig(
            seed=5, corrupt_prob=corrupt))))
        assert got == want
        s = pool.stats()
        # four hand-offs: the 1-token request retires in the prefill pool
        assert (s.transfer_fallbacks if corrupt else s.prefill_imports) == 4
        runs.append((got, dataclasses.asdict(pool.dstats),
                     [dataclasses.asdict(e.stats) for e in pool.engines]))
    assert runs[0] == runs[1]


def _pool_view(pool, chaos):
    """``_drain``'s view of a pool: requests go to ``submit`` and the drain
    runs under ``chaos``."""
    class View:
        add_request = pool.submit

        @staticmethod
        def run_to_completion():
            return pool.run(chaos=chaos)
    return View


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=True, softcap=5.0),
                                dict(causal=True, window=24),
                                dict(causal=False)])
def test_chunked_attention_backward_card_equals_cpu(cuda, no_tf32, kw):
    """The trainable chunked attention (an autograd function, plain torch
    ops, no kernel of the port) on the card: output and q/k/v gradients
    within 1e-5 of the CPU's on a ragged length that pads."""
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 45, 8, 32), (2, 45, 2, 32), (2, 45, 2, 32),
                             (2, 45, 8, 32)))
    p = attn.AttnParams(impl="chunked", bq=16, bkv=16, scale=0.2, **kw)
    got = []
    for dev in ("cpu", cuda):
        tq, tk, tv = (torch.from_numpy(x).to(dev).requires_grad_(True)
                      for x in (q, k, v))
        out = attn.chunked_attention(tq, tk, tv, p)
        out.backward(torch.from_numpy(do).to(dev))
        got.append([t.detach().cpu() for t in (out, tq.grad, tk.grad,
                                               tv.grad)])
    for a, b in zip(*got):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_smoke_train_step_card_equals_cpu(cuda, no_tf32):
    """One train step of smoke gemma-2b (the launcher's flags, float32)
    from the same params on the card and on the CPU: the loss and
    ``grad_norm`` within 1e-5 relative, AdamW's first moment ((1 - b1)
    times the clipped gradient) per leaf within 1e-4 of its largest
    magnitude, every param within 2 lr after AdamW (one step moves a
    param by about lr whatever its gradient), and no kernel of the port
    launched (the reference's training path reaches none)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.dist import POLICIES
    from repro_torch.dist.steps import make_train_step
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.tree import leaves, tree_map

    cfg = smoke_config(ARCHS["gemma-2b"])
    rng = np.random.default_rng(12)
    tok = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    mods = (pa, fa, da, mm, sc, st, rg, pc)
    before = [m.LAUNCHES for m in mods]
    init = build(cfg, FLAGS, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = []
    for dev in ("cpu", cuda):
        bundle = build(cfg, FLAGS, device=dev)
        step, _, _, _ = make_train_step(bundle, Mesh(("data", "model"),
                                                     (1, 1), (dev,)),
                                        POLICIES["fsdp_tp"],
                                        AdamWConfig(lr=1e-3))
        params = tree_map(lambda t: t.detach().to(dev, copy=True), init)
        b = {k: torch.from_numpy(x).to(dev)
             for k, x in (("tokens", tok[:, :-1]), ("labels", tok[:, 1:]))}
        params, opt, m = step(params, adamw.init(params), b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [t.detach().cpu() for t in leaves(opt.m)],
                    [t.detach().cpu() for t in leaves(params)]))
    assert [m.LAUNCHES for m in mods] == before
    (l_cpu, gn_cpu, m_cpu, p_cpu), (l_card, gn_card, m_card, p_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(gn_card - gn_cpu) <= 1e-5 * gn_cpu
    for a, b in zip(m_cpu, m_card):
        assert float((a - b).abs().max()) <= 1e-4 * (
            float(a.abs().max()) or 1.0)
    for a, b in zip(p_cpu, p_card):
        assert float((a - b).abs().max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp_sp"])
def test_smoke_mesh_train_step_card_equals_cpu(cuda, no_tf32, policy):
    """One step of smoke gemma2-27b (the launcher's flags, float32) on a
    (2, 2) mesh whose four devices are the card, against the same step on
    a (2, 2) mesh of the CPU: loss and ``grad_norm`` within 1e-5
    relative, AdamW's first moment per leaf within 1e-4 of its largest,
    the blocks on the card, no kernel of the port launched."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.dist import POLICIES
    from repro_torch.dist.sharding import assemble
    from repro_torch.dist.steps import make_train_step, shard_state
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import FLAGS
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import leaves

    cfg = smoke_config(ARCHS["gemma2-27b"])
    rng = np.random.default_rng(13)
    tok = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    mods = (pa, fa, da, mm, sc, st, rg, pc)
    before = [m.LAUNCHES for m in mods]
    init = build(cfg, FLAGS, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = []
    for dev in ("cpu", cuda):
        dev = torch.device(dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = Mesh(("data", "model"), (2, 2), (dev,) * 4)
        bundle = build(cfg, FLAGS, device=dev)
        step, p_sh, _, _ = make_train_step(bundle, mesh, POLICIES[policy],
                                           AdamWConfig(lr=1e-3))
        params, opt = shard_state(
            {k: v for k, v in init.items()}, p_sh, mesh)
        b = {k: torch.from_numpy(x) for k, x in (("tokens", tok[:, :-1]),
                                                  ("labels", tok[:, 1:]))}
        params, opt, m = step(params, opt, b)
        assert all(blk.device == dev for x in leaves(params)
                   for blk in x.blocks)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [assemble(x, "cpu") for x in leaves(opt.m)]))
    assert [m.LAUNCHES for m in mods] == before
    (l_cpu, gn_cpu, m_cpu), (l_card, gn_card, m_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(gn_card - gn_cpu) <= 1e-5 * gn_cpu
    for a, b in zip(m_cpu, m_card):
        assert float((a - b).abs().max()) <= 1e-4 * (
            float(a.abs().max()) or 1.0)
