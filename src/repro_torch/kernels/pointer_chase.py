"""Pointer-chase latency engine on the card: the wrapper of the CUDA kernel
in ``csrc/pointer_chase.cu`` (the port of the Pallas kernel
``repro.kernels.pointer_chase.pointer_chase``), and the chains it walks.

``table`` (n, 1) int32 is one chain, as in the reference; (C, n, 1) is C
independent chains walked at once, one per request in flight (the
reference's outstanding sweep).  The wrapper takes CUDA tensors only;
:func:`repro_torch.kernels.ops.pointer_chase` sends CPU tensors to the
plain version.  ``LAUNCHES`` counts the kernel's launches.

Chains: :func:`make_chain` is the reference's Sattolo cycle, equal to it
bit for bit, but its swaps run one after another on the host (about a
second per 2^18 entries).  :func:`make_chain_randperm` chains a seeded
``torch.randperm`` in order (``table[perm[k]] = perm[k + 1]``), which is
one cycle for any permutation, and builds a card-sized chain on the card
in milliseconds.  :func:`chain` picks between them by size and says which.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import build

LAUNCHES = 0

# chains up to this many entries are the reference's Sattolo cycle
SATTOLO_MAX_N = 1 << 20


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------

def _chain_of(perm: torch.Tensor) -> torch.Tensor:
    """The single cycle that visits ``perm`` in order: next[perm[k]] =
    perm[k + 1], and the last entry closes the cycle; (n, 1) int32."""
    table = torch.empty(perm.shape[0], dtype=torch.int32, device=perm.device)
    table[perm] = torch.roll(perm, -1).to(torch.int32)
    return table[:, None]


def make_chain(n: int, seed: int = 0) -> torch.Tensor:
    """A single-cycle random permutation chain (Sattolo), host-built, equal
    bit for bit to ``repro.kernels.pointer_chase.make_chain``.  The draws
    ``rng.integers(0, i)`` for i = n-1 .. 1 are made in one call (numpy
    draws the same numbers as the reference's scalar calls); the swaps run
    in order."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, np.arange(n - 1, 0, -1)).tolist() if n > 1 else []
    perm = list(range(n))
    for i, j in zip(range(n - 1, 0, -1), draws):
        perm[i], perm[j] = perm[j], perm[i]
    return _chain_of(torch.tensor(perm, dtype=torch.int64))


def make_chain_randperm(n: int, seed: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> torch.Tensor:
    """A single-cycle chain from a seeded ``torch.randperm`` made on
    ``device``; (n, 1) int32 there."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return _chain_of(torch.randperm(n, generator=gen, device=device))


def chain(n: int, seed: int = 0,
          device: Optional[Union[str, torch.device]] = None
          ) -> Tuple[torch.Tensor, str]:
    """(table on ``device``, builder): the reference's Sattolo cycle up to
    ``SATTOLO_MAX_N`` entries, a chained ``randperm`` above."""
    if n <= SATTOLO_MAX_N:
        return make_chain(n, seed).to(device), "sattolo"
    return make_chain_randperm(n, seed, device), "randperm"


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.cache
def _launcher():
    fn = build.load("pointer_chase").pointer_chase_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, vp, ll, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def pointer_chase(table: torch.Tensor, *, steps: int) -> torch.Tensor:
    """Follow ``addr = table[addr]`` from 0 for ``steps`` hops.

    table: (n, 1) or (C, n, 1) int32 on a CUDA device -> the visited trace,
    (steps, 1) or (C, steps, 1).  An entry outside [0, n) ends its chain:
    that hop and the later ones read -1."""
    global LAUNCHES
    if table.device.type != "cuda":
        raise ValueError(f"the pointer_chase kernel takes CUDA tensors, got "
                         f"{table.device}")
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    if table.dim() not in (2, 3) or table.shape[-1] != 1:
        raise ValueError(f"table must be (n, 1) or (C, n, 1), got "
                         f"{tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    chains = table.shape[0] if table.dim() == 3 else 1
    n = table.shape[-2]
    if not 0 < steps < 2**31 or not 0 < n < 2**31 or chains >= 2**31:
        raise ValueError(f"steps {steps}, n {n} and {chains} chains must "
                         f"be in [1, 2^31)")
    out = torch.empty(table.shape[:-2] + (steps, 1), dtype=torch.int32,
                      device=table.device)
    if chains == 0:
        return out
    with torch.cuda.device(table.device):
        err = _launcher()(table.data_ptr(), out.data_ptr(), n, steps, chains,
                          torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointer_chase kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
