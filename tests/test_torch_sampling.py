"""The port's threefry PRNG and sampler against live ``jax.random`` and
``repro.serve.sampling`` on the CPU.

- keys (``prng_key``, ``fold_in``, ``split``) and raw bits equal JAX's
  exactly, over many seeds and shapes (vocab-wide 256000, odd sizes,
  several dimensions); so do ``uniform``'s floats;
- ``gumbel`` within 2 ulp of JAX's, counted at ``max(|g|, 1)``: ``log``
  rounds its last bit differently in XLA and in torch, and near g = 0 one
  ulp of the inner log is many ulps of the result;
- ``categorical`` draws equal JAX's, for one key over a batch of logits
  and for a batch of keys (``jax.vmap``);
- ``mask_logits`` bit for bit, ``sample_token(s)``, ``split_keys`` and
  ``subkey_chain`` equal to the reference's; ``SamplingParams``' errors.

Everything is compared with calls made here, never with stored vectors.
The port follows jax 0.9.0 with ``jax_threefry_partitionable`` on: the
first test fails loudly on a JAX that runs another mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as js
from repro_torch.serve import prng
from repro_torch.serve import sampling as ts

SEEDS = [0, 1, 3, 7, 42, 12345, 2**31 - 1, -5, 2**32 - 1, 2**33 + 5]
SHAPES = [(1,), (2,), (7,), (3, 5), (2, 3, 4), (1000,), (4097,), (256000,)]

# the reference test's grid, then the card phases' settings
PARAM_GRID = [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.9, 13, 0.8),
    (2.5, 0, 0.5), (0.9, 0, 0.95), (0.8, 50, 1.0), (3.0, 0, 0.98),
]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_jax_runs_the_ported_prng_mode():
    assert jax.config.jax_threefry_partitionable is True
    assert not jax.config.jax_enable_x64
    assert str(jax.random.key_impl(jax.random.key(0))) == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(), _np(_jkey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    key = prng.prng_key(seed)
    for data in (0, 1, 5, 77, 123456, 2**31, 2**32 - 1):
        want = _np(jax.random.fold_in(_jkey(seed), data))
        assert np.array_equal(prng.fold_in(key, data).numpy(), want), data
    # a batch of keys folded with a batch of data, as jax.vmap does
    data = np.arange(9, dtype=np.uint32) * 1000003
    keys = jax.vmap(lambda d: jax.random.fold_in(_jkey(seed), d))(data)
    got = prng.fold_in(key[None].expand(9, 2), torch.from_numpy(
        data.astype(np.int64)))
    assert np.array_equal(got.numpy(), _np(keys))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches_jax(seed, num):
    want = _np(jax.random.split(_jkey(seed), num))
    assert np.array_equal(prng.split(prng.prng_key(seed), num).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:6])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_match_jax(seed, shape):
    want = _np(jax.random.bits(_jkey(seed), shape, jnp.uint32))
    got = prng.random_bits(prng.prng_key(seed), shape)
    assert got.shape == tuple(shape)
    assert np.array_equal(got.numpy(), want)


def test_random_bits_of_a_key_batch_match_vmap():
    jkeys = jax.random.split(_jkey(9), 5)
    want = _np(jax.vmap(lambda k: jax.random.bits(k, (3, 7), jnp.uint32))(
        jkeys))
    got = prng.random_bits(torch.from_numpy(_np(jkeys)), (3, 7))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.5, 3.7),
                                    (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_matches_jax(seed, bounds):
    lo, hi = bounds
    for shape in ((11,), (4, 9), (256000,)):
        want = np.asarray(jax.random.uniform(_jkey(seed), shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(prng.prng_key(seed), shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), shape


def _ulps_at_least_one(got, want):
    """|got - want| in ulps of max(|want|, 1)."""
    unit = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / unit


@pytest.mark.parametrize("seed", SEEDS[:6])
@pytest.mark.parametrize("shape", [(13,), (8, 33), (256000,)])
def test_gumbel_within_two_ulp_of_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(_jkey(seed), shape, jnp.float32))
    got = prng.gumbel(prng.prng_key(seed), shape).numpy()
    assert np.isfinite(got).all()
    assert _ulps_at_least_one(got, want).max() <= 2.0


@pytest.mark.parametrize("seed", SEEDS[:6])
@pytest.mark.parametrize("shape", [(5,), (3, 17), (2, 256000), (4, 1001)])
def test_categorical_matches_jax(seed, shape):
    """One key over a whole logits array, as ``jax.random.categorical``."""
    logits = (np.random.default_rng(seed & 0xFFFF).standard_normal(shape)
              * 3).astype(np.float32)
    want = np.asarray(jax.random.categorical(_jkey(seed), logits))
    got = prng.categorical(prng.prng_key(seed), torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab", [7, 256, 256000])
def test_categorical_of_a_key_batch_matches_vmap(vocab):
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal((6, vocab)) * 2).astype(np.float32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(_jkey(3), i))(
        jnp.arange(6))
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, logits))
    got = prng.categorical(torch.from_numpy(_np(jkeys)),
                           torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), want)


def test_keys_must_be_int64_pairs():
    with pytest.raises(ValueError, match="int64"):
        prng.split(torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        prng.random_bits(torch.zeros(2, dtype=torch.int32), (4,))


# ---------------------------------------------------------------------------
# the sampler against repro.serve.sampling
# ---------------------------------------------------------------------------

def _params(grid):
    return js.SamplingParams(*grid), ts.SamplingParams(*grid)


@pytest.mark.parametrize("grid", PARAM_GRID)
@pytest.mark.parametrize("vocab", [256, 4097])
def test_mask_logits_bit_identical_to_reference(grid, vocab):
    """The reference test's rows (25 draws of 256 logits) and wider ones."""
    jp, tp = _params(grid)
    rng = np.random.default_rng(0)
    for t in range(25):
        logits = (rng.standard_normal(vocab) * 3).astype(np.float32)
        want = np.asarray(js.mask_logits(jnp.asarray(logits), jp))
        got = ts.mask_logits(torch.from_numpy(logits), tp).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), t


@pytest.mark.parametrize("grid", PARAM_GRID[4:])
def test_mask_logits_vocab_wide_rows(grid):
    """A (4, 256000) batch, row by row as the reference's vmap masks."""
    jp, tp = _params(grid)
    logits = (np.random.default_rng(5).standard_normal((4, 256000))
              * 4).astype(np.float32)
    want = np.asarray(jax.vmap(lambda l: js.mask_logits(l, jp))(logits))
    got = ts.mask_logits(torch.from_numpy(logits), tp).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("grid", PARAM_GRID + [(0.0, 0, 1.0)])
def test_sample_token_matches_reference(grid):
    jp, tp = _params(grid)
    rng = np.random.default_rng(1)
    for t in range(25):
        logits = (rng.standard_normal(256) * 3).astype(np.float32)
        key = jax.random.fold_in(_jkey(42), t)
        want = int(js.sample_token(key, jnp.asarray(logits), jp))
        got = ts.sample_token(prng.fold_in(prng.prng_key(42), t),
                              torch.from_numpy(logits), tp)
        assert got.dtype == torch.int64 and int(got) == want, t


@pytest.mark.parametrize("grid", PARAM_GRID + [(0.0, 0, 1.0)])
@pytest.mark.parametrize("vocab", [300, 256000])
def test_sample_tokens_matches_reference(grid, vocab):
    jp, tp = _params(grid)
    logits = (np.random.default_rng(vocab).standard_normal((5, vocab))
              * 3).astype(np.float32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(_jkey(8), i))(
        jnp.arange(5))
    want = np.asarray(js.sample_tokens(jkeys, jnp.asarray(logits), jp))
    got = ts.sample_tokens(torch.from_numpy(_np(jkeys)),
                           torch.from_numpy(logits), tp)
    assert np.array_equal(got.numpy(), want)


def test_greedy_is_argmax_and_ignores_keys():
    logits = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (3, 128)) * 2).astype(np.float32))
    for seed in range(4):
        keys = prng.split(prng.prng_key(seed), 3)
        got = ts.sample_tokens(keys, logits, ts.GREEDY)
        assert torch.equal(got, torch.argmax(logits, dim=-1))


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_split_keys_matches_reference(seed):
    jkeys = jax.random.split(_jkey(seed), 4)
    jc, jsub = js.split_keys(jkeys)
    tc, tsub = ts.split_keys(torch.from_numpy(_np(jkeys)))
    assert np.array_equal(tc.numpy(), _np(jc))
    assert np.array_equal(tsub.numpy(), _np(jsub))


@pytest.mark.parametrize("n", [1, 4, 7])
def test_subkey_chain_matches_reference(n):
    jkeys = jax.random.split(_jkey(n), 3)
    jsubs, jcarried = js.subkey_chain(jkeys, n)
    tsubs, tcarried = ts.subkey_chain(torch.from_numpy(_np(jkeys)), n)
    assert tsubs.shape == (3, n, 2) and tcarried.shape == (3, n + 1, 2)
    assert np.array_equal(tsubs.numpy(), _np(jsubs))
    assert np.array_equal(tcarried.numpy(), _np(jcarried))


@pytest.mark.parametrize("kwargs,match", [
    (dict(temperature=-0.1), "temperature"), (dict(top_k=-1), "top_k"),
    (dict(top_p=0.0), "top_p"), (dict(top_p=1.5), "top_p")])
def test_sampling_params_errors_match_reference(kwargs, match):
    with pytest.raises(ValueError, match=match):
        js.SamplingParams(**kwargs)
    with pytest.raises(ValueError, match=match):
        ts.SamplingParams(**kwargs)


def test_sampling_params_defaults_match_reference():
    assert ts.GREEDY.greedy and ts.SamplingParams().greedy
    assert not ts.SamplingParams(temperature=0.5).greedy
    assert (ts.GREEDY.temperature, ts.GREEDY.top_k, ts.GREEDY.top_p) == (
        js.GREEDY.temperature, js.GREEDY.top_k, js.GREEDY.top_p)
    assert np.float32(ts.NEG_INF) == js.NEG_INF
