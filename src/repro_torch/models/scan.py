"""A parallel prefix scan with an associative operator, grouped as
``jax.lax.associative_scan`` groups it.

The recurrent mixers run their time recurrences (RG-LRU's ``h_t = a_t
h_{t-1} + b_t``, SSD's chunk-state passing) as a scan whose operator
composes two affine steps.  :func:`associative_scan` follows JAX's
odd/even recursion step for step: combine adjacent pairs, scan the
half-length sequence, fill in the even positions, interleave.  The
products and sums are therefore grouped as in the reference, and a
sequence of S steps costs O(log S) levels of whole-tensor operations
rather than S dependent steps.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def _every_other(x: torch.Tensor, start: int, stop, dim: int) -> torch.Tensor:
    """``x[start:stop:2]`` along ``dim``."""
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, 2)
    return x[tuple(idx)]


def _slice(x: torch.Tensor, start: int, stop, dim: int) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim``; ``a`` may be one longer."""
    n = b.shape[dim]
    both = torch.stack([_slice(a, 0, n, dim), b], dim=dim + 1)
    out = both.flatten(dim, dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, _slice(a, n, None, dim)], dim=dim)
    return out


def associative_scan(combine: Callable[[Elems, Elems], Elems],
                     elems: Sequence[torch.Tensor], dim: int) -> Elems:
    """Inclusive scan of ``elems`` (tensors of equal length along ``dim``)
    under ``combine(left, right)``, which maps two tuples of slices to one
    and must be associative.  Returns a tuple like ``elems`` whose k-th
    entry along ``dim`` combines entries 0..k."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_every_other(e, 0, n - 1, dim) for e in elems),
                      tuple(_every_other(e, 1, None, dim) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    rest = tuple(_every_other(e, 2, None, dim) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_slice(o, 0, -1, dim) for o in odd), rest)
    else:
        even = combine(odd, rest)
    even = tuple(torch.cat([_slice(e, 0, 1, dim), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))
