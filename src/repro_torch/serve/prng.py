"""JAX's threefry2x32 PRNG in PyTorch, bit for bit.

The reference samples with ``jax.random``; this module reproduces the
parts of it the serving engine walks, so that a sampled drain of the port
draws the reference's tokens and carries the reference's keys.  It
follows jax 0.9.0 with ``jax_threefry_partitionable=True`` in 32-bit mode
(``jax_enable_x64`` off), the only mode ported:

- :func:`threefry2x32`: the 20-round Threefry-2x32 hash (rotations 13, 15,
  26, 6 / 17, 29, 16, 24; key schedule with ``0x1BD11BDA``);
- :func:`prng_key`: ``jax.random.PRNGKey(seed)``: the seed truncated to 32
  bits, then split into (high, low) words, so ``(0, seed mod 2**32)``;
- :func:`fold_in`: the hash of the count ``(0, data)``;
- :func:`split`: the hash of ``(0, i)`` for ``i < num`` (the partitionable
  ``_threefry_split_foldlike``);
- :func:`random_bits`: 32 bits per element, ``y0 ^ y1`` of the hash of a
  64-bit iota over the shape, as ``(high, low)`` words;
- :func:`uniform`: ``bits >> 9 | 0x3f800000`` as a float in [1, 2), minus
  1, scaled to [minval, maxval), then ``max(minval, .)``;
- :func:`gumbel` (JAX's mode ``"low"``): ``-log(-log(uniform(tiny, 1)))``;
- :func:`categorical`: the argmax of logits plus Gumbel noise.

A key is a ``(..., 2)`` int64 tensor holding two uint32 words; every
function takes a batch of keys and acts on each, as ``jax.vmap`` would.
Words are carried in int64 (torch's ``uint32`` lacks ``+``, ``<<`` and
``>>`` on the CPU, and ``int32``'s ``>>`` is arithmetic): every add and
rotate is masked back to 32 bits, and only non-negative values shift.
Nothing here keeps global state: keys live on the caller's device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the smallest normal float32: gumbel's lower bound, so log(u) is finite
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counts ``(x0, x1)`` under the key ``(k0, k1)``:
    int64 tensors of uint32 words, broadcast together.  Returns the two
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a (2,) int64 key."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _words(keys: torch.Tensor, extra_dims: int):
    """A key batch's two words, shaped to broadcast over ``extra_dims``
    trailing dimensions."""
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"keys must be (..., 2) int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    lead = keys.shape[:-1] + (1,) * extra_dims
    return keys[..., 0].reshape(lead), keys[..., 1].reshape(lead)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with ``data`` (an int, or an
    integer tensor broadcast against the key batch)."""
    k0, k1 = _words(keys, 0)
    if isinstance(data, torch.Tensor):
        d = data.to(device=keys.device, dtype=torch.int64) & MASK
    else:
        d = torch.tensor(int(data) & MASK, dtype=torch.int64,
                         device=keys.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of each key: (..., num, 2)."""
    k0, k1 = _words(keys, 1)
    lo = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def _iota_2x32(shape: Sequence[int], device) -> tuple:
    """A 64-bit iota over ``shape`` as (high, low) uint32 words."""
    n = math.prod(shape)
    c = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return c >> 32, c & MASK


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: (..., *shape) int64 in [0, 2**32)."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _words(keys, len(shape))
    hi, lo = _iota_2x32(shape, keys.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., *shape) in [minval,
    maxval)."""
    bits = random_bits(keys, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    # XLA contracts ``floats * (hi - lo) + lo`` into one fused multiply-add:
    # in float64 the product of two float32 values is exact, so one
    # rounding to float32 follows, as the fused operation's
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode ``"low"``."""
    return -torch.log(-torch.log(uniform(keys, shape, TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: each key draws the
    noise for the logits below its batch index (a (2,) key draws noise of
    ``logits``' whole shape, as JAX does; a (B, 2) batch with (B, V)
    logits draws each row with its own key, as ``jax.vmap`` does).
    Returns int64 indices."""
    noise = gumbel(keys, logits.shape[keys.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
