"""What the two decode kernels' tensor-core routes share (``csrc/
decode_core.cuh``): the shape of a block, the rule that splits a (sequence,
kv head)'s token walk across blocks, and the arrival counters of the split
merge.

A block of the tensor-core route holds the 16 query rows and, for each of
its ``warps`` warps, a ring of ``stages`` tiles of ``TILE`` tokens (K and
V; K1's int8 pages also the tile's scales), at least as large as the
warp's rows of the block's closing merge.
The split merge runs inside the launch.  With 2 to 8 splits they form one
thread-block cluster and the first block merges them through distributed
shared memory.  Otherwise (and on the CUDA-core routes) every block writes
global partials and the last block of a (sequence, kv head) to finish
merges them, found by an int32 arrival counter per (sequence, kv head) that
the merging block resets to 0.  The counters live in one buffer per device
and stream, zeroed once when it is allocated, so a call needs no memset
launch and no host synchronisation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.memmodel import H100

TILE = 16             # tokens of a warp tile (kTile in the header)
MAX_GROUP = 16        # query heads per kv head: the mma's M (kMaxGroup)
MIN_STAGES = 2        # kMinStages: a warp's ring is at least double-buffered
MAX_STAGES = 8        # kMaxStages
MAX_SPLITS = 64       # kMaxSplits: blocks sharing a (sequence, kv head)
MAX_CLUSTER_SPLITS = 8   # kMaxClusterSplits: a portable cluster
SMEM_BYTES = H100.smem_bytes      # shared memory a block can use
STATIC_SMEM = 2048                # the kernels' static shared arrays, about
MIN_TILES_PER_WARP = 2            # so a warp's ring overlaps copies
ACC_PAD = 8                       # kAccPad: floats padding a merge row


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """What one launch of a decode kernel runs: its route, the tokens of a
    tile (a warp's on the tensor cores, the block's on the CUDA cores), the
    tiles in flight in a ring, the warps of a block, and the pages'
    element type where it is not q's (K1's int8 pages)."""
    route: str          # "mma.sync" or "cuda-cores"
    tile: int
    stages: int
    warps: int
    pages: str = ""     # "int8", or "" for pages of q's dtype

    def __str__(self) -> str:
        return (f"{self.route} tile={self.tile} stages={self.stages} "
                f"warps={self.warps}"
                + (f" pages={self.pages}" if self.pages else ""))


def recv_bytes(d: int) -> int:
    """The cluster merge's receive buffers (``MmaLayout::kRecvBytes``)."""
    return (MAX_GROUP * (d // 4 + MAX_CLUSTER_SPLITS) * 16
            + MAX_CLUSTER_SPLITS * MAX_GROUP * 8)


def stage_bytes(d: int, kv_bytes: int = 2) -> int:
    """A ring stage: a tile's K and V rows of ``kv_bytes`` an element, and
    for int8 pages (``kv_bytes`` 1) its 16 k_scale and 16 v_scale floats
    (``MmaLayout::kStageBytes``)."""
    return 2 * TILE * d * kv_bytes + (2 * TILE * 4 if kv_bytes == 1 else 0)


def merge_bytes(d: int) -> int:
    """A warp's rows of the block's closing merge, 16 x (D + ACC_PAD)
    floats, written over its ring (``MmaLayout::kMergeBytes``)."""
    return 16 * (d + ACC_PAD) * 4


def warp_ring_bytes(d: int, stages: int, kv_bytes: int = 2) -> int:
    """A warp's region: its ring, or its merge rows where they are larger
    (two int8 stages are; ``MmaLayout::warp_ring``)."""
    return max(stages * stage_bytes(d, kv_bytes), merge_bytes(d))


def mma_smem(d: int, warps: int, stages: int, kv_bytes: int = 2) -> int:
    """Dynamic shared memory of a tensor-core block: the 16 bfloat16 query
    rows, each warp's region (:func:`warp_ring_bytes`) and the cluster
    merge's receive buffers (``MmaLayout::smem``)."""
    return (16 * d * 2 + warps * warp_ring_bytes(d, stages, kv_bytes)
            + recv_bytes(d))


def mma_stages_fit(d: int, warps: int, extra: int = 0,
                   kv_bytes: int = 2) -> int:
    """The most stages a warp's ring can have beside ``extra`` bytes (0
    where not even the warps' merge rows fit)."""
    room = SMEM_BYTES - STATIC_SMEM - 16 * d * 2 - recv_bytes(d) - extra
    if room < warps * merge_bytes(d):
        return 0
    return room // (warps * stage_bytes(d, kv_bytes))


def split_count(rows: int, tiles: int, warps: int, sms: int) -> int:
    """Blocks that share one (sequence, kv head)'s token walk of ``tiles``
    tiles, when ``rows`` (sequence, kv head) pairs each get that many: at
    most one block per SM in all (the split merge costs more than a second
    resident block gains), while every warp of a full row still walks
    ``MIN_TILES_PER_WARP`` tiles, and at most ``MAX_SPLITS``.  It reads
    shapes only, never valid_len."""
    want = sms // rows
    cap = tiles // (MIN_TILES_PER_WARP * warps)
    return max(1, min(want, cap, MAX_SPLITS))


def merge_kind(route: str, splits: int) -> str:
    """How a launch merges its splits: ``none`` (one split), ``cluster``
    (2 to 8 splits on the tensor cores: a thread-block cluster) or
    ``counter`` (global partials and an arrival counter)."""
    if splits == 1:
        return "none"
    return ("cluster" if route == "mma.sync"
            and splits <= MAX_CLUSTER_SPLITS else "counter")


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters on ``device`` for launches on
    its current stream, all 0 between launches.  Allocated (zeroed) on the
    first call and when ``n`` outgrows them; after that every call returns
    the same buffer, so a captured launch keeps its address."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf
