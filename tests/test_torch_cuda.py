"""The port's CUDA kernels on the card, held against their plain versions.

These tests import neither JAX nor the JAX package, so they run on a host
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card they skip: a CUDA kernel has no CPU mode.  The case tables
and input makers of ``paged_attention`` (K1) and ``flash_attention`` (K2)
are shared with ``test_torch_kernels.py``, which holds the plain versions
against the JAX package on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

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
