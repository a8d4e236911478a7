"""Host-memory KV tier: the swap target of preempted requests (the port of
``repro.serve.hosttier``).

One level below the page pools: when the scheduler evicts a victim whose
context is dear to recompute, the engine gathers the victim's whole pages
(k/v and the int8 scale lanes) from the card into host memory and parks
them here; a resume reserves fresh pages and copies the bytes back
through the page table.  Entries are CPU tensors keyed by rid, in pinned
memory when they came from the card (so both copies are DMA).

Every entry carries a CRC32 over the raw bytes of its *real* pages (the
gather pads the page list to a power of two with null-page ids; the null
page changes under masked decode writes, so padding is left out).
:meth:`HostKVTier.get` re-checks it, so a corrupted swap (the chaos
harness injects exactly this) is caught before a stale row reaches the
card, and the engine resumes by recompute instead.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch


def page_axis(path: Sequence[str], leaf: torch.Tensor) -> int:
    """Which axis of a paged-cache leaf indexes pages.

    Pool leaves are ``*_pages`` ``(..., P, page, Hkv, D)`` and int8 scale
    lanes ``*_scale`` ``(..., P, page)``; the pattern blocks' leaves
    (``cache["blocks"]``) carry a leading layer axis, the remainder's
    (``cache["rem"]``) none.  Swappable stacks are pure full attention
    (the engine checks), so every leaf is one of the two.  ``path`` is
    the leaf's keys from the root; the last one names it."""
    name = str(path[-1]) if len(path) else ""
    if name.endswith("_pages"):
        ax = leaf.ndim - 4
    elif name.endswith("_scale"):
        ax = leaf.ndim - 2
    else:
        raise ValueError(
            f"leaf {name!r} is not a page-pool leaf: host swap serves pure "
            "full-attention stacks whose cache is pages + scale lanes only")
    if ax not in (0, 1):
        raise ValueError(f"leaf {name!r}: unexpected rank {leaf.ndim}")
    return ax


def tree_leaves(tree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a nested dict of tensors in a fixed order: keys
    sorted at every level, as JAX flattens a dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict of tensors, same structure."""
    return {k: (tree_map(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def checksum_pages(data, n_pages: int) -> int:
    """CRC32 over each leaf's first ``n_pages`` along its page axis, as raw
    bytes (bfloat16 has no numpy dtype), leaves in :func:`tree_leaves`
    order."""
    crc = 0
    for path, leaf in tree_leaves(data):
        ax = page_axis(path, leaf)
        real = leaf.narrow(ax, 0, n_pages)
        # a layer axis first: each layer's span is contiguous on its own,
        # and their bytes in order are the whole span's
        for part in (real.unbind(0) if ax == 1 else (real,)):
            crc = zlib.crc32(part.contiguous().view(torch.uint8).numpy(),
                             crc)
    return crc


@dataclass
class HostKVEntry:
    rid: int
    n_pages: int          # real pages (data is padded to pow2 beyond this)
    length: int           # live KV rows the pages cover
    data: Any             # nested dict of CPU tensors
    checksum: int
    nbytes: int


def make_transfer_entry(rid: int, data, n_pages: int,
                        length: int) -> HostKVEntry:
    """Package gathered pages as a self-checking transfer buffer.

    The format a swap-out parks in the local tier, built on its own: a
    disaggregated hand-off ships these entries from a prefill engine to a
    decode engine with the checksum beside the bytes, and whoever installs
    the entry (:meth:`HostKVTier.put_entry`) checks it on readback.
    ``data`` is a nested dict of CPU tensors (the engine's gather copies
    them off the card), which the entry owns from here on."""
    nbytes = int(sum(x.numel() * x.element_size()
                     for _, x in tree_leaves(data)))
    return HostKVEntry(rid=rid, n_pages=n_pages, length=length, data=data,
                       checksum=checksum_pages(data, n_pages), nbytes=nbytes)


def corrupt_entry(entry: HostKVEntry) -> None:
    """Flip one byte inside the checksummed span (the bit-rot model).
    Byte 0 is element [0, ..., 0] of the first leaf: page 0 of the
    gathered data, the first real page, always checksummed."""
    _, leaf = next(tree_leaves(entry.data))
    leaf.view(torch.uint8).view(-1)[0] ^= 0xFF


@dataclass
class HostKVTier:
    """rid -> swapped page data, with checksum-verified readback.

    ``latency_s`` sleeps on every put and get: the chaos harness models a
    slow host link with it, to show that the schedule (not only the data)
    survives a laggy tier.
    """

    latency_s: float = 0.0
    _entries: Dict[int, HostKVEntry] = field(default_factory=dict)
    bytes_out: int = 0     # cumulative device->host
    bytes_in: int = 0      # cumulative host->device (verified gets)

    def _stall(self) -> None:
        if self.latency_s > 0:
            time.sleep(self.latency_s)

    def put(self, rid: int, data, n_pages: int, length: int) -> HostKVEntry:
        """Own the gathered pages (writable: the chaos harness corrupts
        entries in place) and checksum their real-page span."""
        self._stall()
        entry = make_transfer_entry(rid, data, n_pages, length)
        self._entries[rid] = entry
        self.bytes_out += entry.nbytes
        return entry

    def put_entry(self, entry: HostKVEntry) -> None:
        """Install a transfer entry as it is, checksum and all: a
        disaggregated import lands pages shipped from another engine here,
        with NO new checksum, so damage taken in transit is caught by the
        next :meth:`get` exactly like bit-rot in the local tier."""
        self._stall()
        self._entries[entry.rid] = entry
        self.bytes_out += entry.nbytes

    def get(self, rid: int) -> Tuple[Optional[HostKVEntry], bool]:
        """(entry, ok).  ``ok`` is False when the stored checksum no longer
        matches: the caller must resume by recompute and :meth:`pop` the
        entry, which stays until then, so a failed swap-in never loses
        the eviction's only record."""
        self._stall()
        entry = self._entries.get(rid)
        if entry is None:
            return None, False
        ok = checksum_pages(entry.data, entry.n_pages) == entry.checksum
        if ok:
            self.bytes_in += entry.nbytes
        return entry, ok

    def pop(self, rid: int) -> None:
        self._entries.pop(rid, None)

    def rids(self) -> list:
        return list(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.bytes_out = 0
        self.bytes_in = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    @property
    def bytes_held(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def corrupt(self, rid: int) -> bool:
        """Flip one byte inside the checksummed span of ``rid``'s entry
        (the chaos harness's bit-rot).  False when the rid holds none."""
        entry = self._entries.get(rid)
        if entry is None:
            return False
        corrupt_entry(entry)
        return True
