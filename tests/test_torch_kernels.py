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

``flash_attention`` (K2) likewise: the port's plain version against the
reference's Pallas kernel in interpret mode, with the reference's blocks at
16 or 32, at 2e-4 in float32 and 3e-2 in bfloat16 (the tolerances of
``tests/test_kernels.py``'s flash tests).  Every row of these cases sees a
key: where none does, the port returns 0 and the Pallas kernel a value
that depends on its block padding, so such rows are not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from test_torch_cuda import (CASES, FLASH_CASES, FLASH_TOL, TOL,
                             make_flash_inputs, make_inputs)


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


@pytest.mark.parametrize("b, n_tok, want", [
    (8, 1024, 32),     # main path: 66 blocks per row wanted, 32 tiles cap it
    (5, 32, 1),        # one tile: one block writes the output itself
    (528, 1024, 1),    # the batch alone gives 4 blocks per SM
    (1, 8192, 256),    # one long row: a block per tile
])
def test_kernel_split_rule(monkeypatch, b, n_tok, want):
    """How many blocks share a row's token walk, on a 132-SM card."""
    monkeypatch.setattr(tpa, "_sm_count", lambda index: 132)
    assert tpa._splits_for(torch.device("cuda", 0), b, 1, n_tok) == want


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
