"""Token selection for the serving engine: greedy argmax or sampling.

The port of ``repro.serve.sampling``.  Semantics (applied in this order):

- ``temperature`` scales logits; ``0.0`` is exact argmax (the first
  maximal index on ties), which never touches a key, so a greedy engine
  consumes no random state;
- ``top_k`` keeps the k highest logits (every logit tied with the k-th is
  kept);
- ``top_p`` keeps the smallest prefix of the descending distribution whose
  mass reaches p (the top token is always kept).

The draw is :func:`repro_torch.serve.prng.categorical` (Gumbel-max) over
the masked logits, with JAX's threefry keys: one split per emitted token,
so the carried key advances exactly with the output stream, which is what
makes speculative decoding key-exact with vanilla decoding.  Everything
runs on the logits' device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.serve import prng

# large-negative instead of -inf: masked logits stay NaN-free under the
# Gumbel add
NEG_INF = -1e30
# XLA rewrites a cumulative sum into a scan over blocks of this many
# elements (its reduce-window rewriter, as the CPU backend configures it)
SCAN_BASE = 16


@dataclass(frozen=True)
class SamplingParams:
    """Per-engine sampling configuration.  ``temperature=0`` is greedy
    argmax; ``top_k=0`` and ``top_p=1.0`` disable their filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def select_greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...) int64 argmax tokens."""
    return torch.argmax(logits, dim=-1)


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in float32, added in
    XLA's order: blocks of :data:`SCAN_BASE` summed left to right, the
    block totals scanned the same way, and each block offset by the
    totals before it.  Every step is one IEEE addition, so the result is
    the same on the CPU and on the card (``torch.cumsum`` accumulates in
    float64 on the CPU and in a tree on the card)."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // SCAN_BASE)
    blocks = torch.nn.functional.pad(x, (0, nb * SCAN_BASE - n)).reshape(
        *x.shape[:-1], nb, SCAN_BASE)
    inner = _running_sum(blocks)
    outer = _running_sum(inner[..., -1])
    before = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    out = inner + before[..., None]
    return out.reshape(*x.shape[:-1], nb * SCAN_BASE)[..., :n]


def mask_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked float32 logits over the last
    axis.  Kept entries are exactly ``logits / temperature``, one IEEE
    division (by a tensor on the logits' device: a CUDA division by a host
    scalar multiplies by its reciprocal instead); dropped entries become
    :data:`NEG_INF`."""
    l = logits.float() / torch.tensor(params.temperature, dtype=torch.float32,
                                      device=logits.device)
    v = l.shape[-1]
    if 0 < params.top_k < v:
        kth = torch.sort(l, dim=-1).values[..., v - params.top_k, None]
        l = torch.where(l < kth, NEG_INF, l)
    if params.top_p < 1.0:
        sl = torch.sort(l, dim=-1, descending=True).values
        e = torch.exp(sl - sl[..., :1])
        probs = e / e.sum(dim=-1, keepdim=True)
        csum = _running_sum(probs)
        # keep while the exclusive prefix mass is below p: the smallest
        # covering set, and the top token is always in it
        keep = (csum - probs) < params.top_p
        cutoff = torch.where(keep, sl, torch.inf).min(dim=-1,
                                                      keepdim=True).values
        l = torch.where(l < cutoff, NEG_INF, l)
    return l


def sample_tokens(keys: torch.Tensor, logits: torch.Tensor,
                  params: SamplingParams) -> torch.Tensor:
    """Batched draw: keys (B, 2), logits (B, V) -> (B,) int64 tokens.
    Greedy ignores the keys."""
    if params.greedy:
        return select_greedy(logits)
    return prng.categorical(keys, mask_logits(logits, params))


def sample_token(key: torch.Tensor, logits: torch.Tensor,
                 params: SamplingParams) -> torch.Tensor:
    """One token id (a 0-dim int64 tensor) from a (V,) logits row with a
    (2,) key."""
    return sample_tokens(key[None], logits[None], params)[0]


def split_keys(keys: torch.Tensor):
    """Advance a (B, 2) key batch one step: returns (carried, subkeys)."""
    s = prng.split(keys, 2)
    return s[:, 0], s[:, 1]


def subkey_chain(keys: torch.Tensor, n: int):
    """Walk each slot's split chain ``n`` steps without consuming it.

    Returns ``(subs, carried)``: subs (B, n, 2), the subkey that samples
    the i-th emitted token, and carried (B, n+1, 2), the key a slot holds
    after emitting i tokens (``carried[:, 0]`` is the input key)."""
    subs, carried = [], [keys]
    for _ in range(n):
        nk, sub = split_keys(carried[-1])
        subs.append(sub)
        carried.append(nk)
    return torch.stack(subs, dim=1), torch.stack(carried, dim=1)
