"""The copies between the shards of one tensor-parallel group, in shard
order: every copy of activations, weights or state a step makes (not
the tables and positions each shard is handed), in the attention and
MLP forms (:mod:`repro_torch.models.transformer`,
:mod:`repro_torch.models.sharded`) and in the forms that split more
than heads: the MoE layer over experts, the RG-LRU over its width and
the SSD mixer over its heads (:func:`repro_torch.models.moe.apply_tp`,
:func:`repro_torch.models.rglru.forward_tp`,
:func:`repro_torch.models.ssm.forward_tp`).

One process drives every shard.  A group is either a serving engine's
device list (:class:`DeviceGroup`: a copy is ``Tensor.to``) or a data
row of a training mesh (:class:`RowGroup`: a copy is
:func:`repro_torch.dist.fsdp.move`, which autograd and the dry-run's
accounting see).  Shard 0 is the group's home: the residual stream and
the replicated routing live there.  Devices may repeat; a copy between
two shards on one device moves nothing, but it is counted all the same
in :data:`COPIES` (bytes by kind), the figure a group of distinct cards
would move.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import List, Optional, Sequence

import torch

# bytes copied between distinct shards, by kind, since the last reset
COPIES: Counter = Counter()


def reset_copies() -> None:
    COPIES.clear()


class DeviceGroup:
    """A serving engine's shards: shard s on ``devices[s]``."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.n = len(self.devices)

    def _move(self, t, src: int, dst: int):
        return t.to(self.devices[dst])

    def on(self, s: int):
        return contextlib.nullcontext()


class RowGroup:
    """The columns of one data row of a mesh
    (:class:`~repro_torch.dist.fsdp.Row`)."""

    def __init__(self, row):
        self.row = row
        self.n = row.plan.cols
        self.devices = row.devs

    def _move(self, t, src: int, dst: int):
        return self.row.move(t, src, dst)

    def on(self, s: int):
        from repro_torch.dist import fsdp
        return fsdp.on(self.row.cols[s])


def move(g, t: torch.Tensor, src: int, dst: int, kind: str) -> torch.Tensor:
    """``t`` (held by shard ``src``) as shard ``dst`` holds it, its bytes
    counted under ``kind`` when the shards differ."""
    if src == dst:
        return t
    COPIES[kind] += t.numel() * t.element_size()
    return g._move(t, src, dst)


def broadcast(g, t: torch.Tensor, kind: str, src: int = 0) -> list:
    """``t`` on every shard."""
    return [move(g, t, src, s, kind) for s in range(g.n)]


def reduce_sum(g, parts: Sequence[torch.Tensor], kind: str,
               dst: int = 0) -> torch.Tensor:
    """The shards' partials added on ``dst`` in shard order."""
    out = move(g, parts[0], 0, dst, kind)
    for s, p in enumerate(parts[1:], 1):
        out = out + move(g, p, s, dst, kind)
    return out


def reduce_max(g, parts: Sequence[torch.Tensor], kind: str,
               dst: int = 0) -> torch.Tensor:
    """The elementwise maximum of the shards' parts on ``dst`` (exact in
    any order; taken in shard order)."""
    out = move(g, parts[0], 0, dst, kind)
    for s, p in enumerate(parts[1:], 1):
        out = torch.maximum(out, move(g, p, s, dst, kind))
    return out


def all_gather(g, parts: Sequence[torch.Tensor], dim: int, kind: str,
               to: Optional[Sequence[int]] = None) -> List:
    """The shards' slices concatenated on ``dim`` in shard order, on each
    shard of ``to`` (default: every shard); None for the others."""
    to = range(g.n) if to is None else to
    out = [None] * g.n
    for d in to:
        out[d] = torch.cat([move(g, p, s, d, kind)
                            for s, p in enumerate(parts)], dim=dim)
    return out


def span(full: int, n: int, s: int):
    """Shard s's contiguous share ``[lo, hi)`` of ``full`` items split
    over ``n`` shards as evenly as they go (the policy's blocks where
    ``n`` divides ``full``)."""
    return s * full // n, (s + 1) * full // n


def take(g, blocks: Sequence[torch.Tensor], full: int, dim: int, lo: int,
         hi: int, dst: int, kind: str) -> torch.Tensor:
    """Columns ``[lo, hi)`` along ``dim`` of a tensor of ``full`` columns
    stored as one contiguous block per shard, in shard order (``blocks[s]``
    on shard s; the blocks may differ in width, and every shard holds the
    tensor whole when a block is ``full`` wide), on shard ``dst``: its own
    block's columns read in place, the rest copied from the shards that
    hold them."""
    if blocks[dst].shape[dim] == full:
        return blocks[dst].narrow(dim, lo, hi - lo)
    parts, a0 = [], 0
    for s, blk in enumerate(blocks):
        a1 = a0 + blk.shape[dim]
        a, b = max(lo, a0), min(hi, a1)
        if a < b:
            parts.append(move(g, blk.narrow(dim, a - a0, b - a), s, dst,
                              kind))
        a0 = a1
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def local(g, copies: Sequence, s: int, dim: int, lo: int, hi: int,
          kind: str) -> torch.Tensor:
    """Columns ``[lo, hi)`` along ``dim`` of a tensor that every shard
    holds whole (``copies[s]``) or only the first one does (``copies[s]``
    None), on shard s: read in place, or copied from the first shard."""
    own = copies[s]
    if own is not None:
        return own.narrow(dim, lo, hi - lo)
    return move(g, copies[0].narrow(dim, lo, hi - lo), 0, s, kind)
