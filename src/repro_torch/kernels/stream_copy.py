"""Sequential-stream engine on the card: the wrapper of the CUDA kernel in
``csrc/stream_copy.cu`` (the port of the Pallas kernel
``repro.kernels.stream_copy.stream_copy``).

Two routes, chosen from the shapes before the launch by
:func:`kernel_config`:

- ``bulk`` (both bases 16-byte aligned, a tile row's bytes a multiple of
  16): TMA bulk copies through a ring of shared-memory stages, on a grid
  sized to the card.  A tile is a sequence of contiguous requests in
  address order; one request is the paper's burst and the ring its BRAM
  cost.  Blocks take requests from a counter that is zero between
  launches (one per stream, :func:`decode_core.arrival_counters`).
- ``element``: one block per tile moving single elements, ``UNROLL``
  independent loads per thread before it stores.

:func:`kernel_knobs` says what a call does.  The wrapper takes CUDA
tensors only; :func:`repro_torch.kernels.ops.stream_copy` sends CPU
tensors to the plain version.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_core

LAUNCHES = 0

UNROLL = 4           # element route: independent loads per thread
BULK_UNIT = 16       # bulk copies move 16-byte multiples from 16-byte bases
CHUNK_BYTES = 16 << 10     # the largest request, one ring stage
RING_PER_SM = 96 << 10     # ring bytes per SM, over its resident blocks
BLOCK_STAGES = 4           # stages a block is sized for
MIN_STAGES, MAX_STAGES = 2, 32       # kMaxStages in the source
MIN_BLOCKS_PER_SM, MAX_BLOCKS_PER_SM = 2, 8
H100_SMS = 132             # the card the port targets (kernel_knobs on CPU)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MODES = ("copy", "rw")


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launchers():
    lib = build.load("stream_copy")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    element = lib.stream_copy_element_launch
    element.argtypes = [vp, vp, ll, ll, ll, ll, i, i, vp]
    bulk = lib.stream_copy_bulk_launch
    bulk.argtypes = [vp, vp, ll, ll, ll, ll, i, i, ll, ll, i, vp, vp]
    for fn in (element, bulk):
        fn.restype = ctypes.c_int
    return element, bulk


def _resolve(rows: int, cols: int, block_rows: int, block_cols: int):
    """The ``(br, bc)`` tile as the Pallas kernel resolves it:
    ``block_cols`` 0 means whole rows, ``block_rows`` is capped at the
    row count; both must divide the array."""
    bc = cols if block_cols in (0, None) else block_cols
    br = min(block_rows, rows)
    if br < 1 or bc < 1 or rows % br or cols % bc:
        raise ValueError(f"tile ({br}, {bc}) does not divide the array "
                         f"{(rows, cols)}")
    return br, bc


def tile(x: torch.Tensor, block_rows: int, block_cols: int):
    """The ``(br, bc)`` tile of a call (see :func:`_resolve`)."""
    if x.dim() != 2:
        raise ValueError(f"stream_copy takes a 2-D array, got shape "
                         f"{tuple(x.shape)}")
    return _resolve(*x.shape, block_rows, block_cols)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """What one launch runs.  ``bulk``: ``grid`` blocks, each with a ring
    of ``stages`` stages of ``chunk_bytes``; a tile is ``segments``
    contiguous ranges of ``segment_bytes`` (one range for a tile of whole
    rows, else one a tile row), each cut into ``pieces`` requests of at
    most ``chunk_bytes``.  ``element``: one block per tile, no ring."""
    route: str                 # "bulk" or "element"
    grid: int
    block_rows: int
    block_cols: int
    row_bytes: int
    tile_col_bytes: int
    chunk_bytes: int = 0
    stages: int = 0
    blocks_per_sm: int = 0
    segments: int = 0
    segment_bytes: int = 0
    pieces: int = 0
    requests: int = 0

    @property
    def ring_bytes(self) -> int:
        return self.stages * self.chunk_bytes

    def request(self, q: int):
        """(byte offset, bytes) of bulk request ``q``: the kernel's
        ``request`` in ``csrc/stream_copy.cu``."""
        t, w = divmod(q, self.segments * self.pieces)
        seg, p = divmod(w, self.pieces)
        ti, tj = divmod(t, self.row_bytes // self.tile_col_bytes)
        off = ((ti * self.block_rows + seg) * self.row_bytes
               + tj * self.tile_col_bytes + p * self.chunk_bytes)
        return off, min(self.chunk_bytes,
                        self.segment_bytes - p * self.chunk_bytes)

    def __str__(self) -> str:
        if self.route == "element":
            return (f"element tile=({self.block_rows},{self.block_cols}) "
                    f"grid={self.grid} unroll={UNROLL}")
        return (f"bulk tile=({self.block_rows},{self.block_cols}) "
                f"grid={self.grid} ({self.blocks_per_sm}/SM) "
                f"request={self.chunk_bytes}B stages={self.stages} "
                f"ring={self.ring_bytes}B requests={self.requests}")


def kernel_config(rows: int, cols: int, itemsize: int, block_rows: int,
                  block_cols: int, aligned: bool,
                  sm_count: int = H100_SMS) -> KernelConfig:
    """The route and configuration of a call on a ``(rows, cols)`` array of
    ``itemsize``-byte elements whose bases are 16-byte aligned when
    ``aligned``, on a card of ``sm_count`` SMs.  Pure: it runs without a
    card.

    Rule: the bulk route when the bases are aligned and a tile row's bytes
    are a multiple of 16, else the element route.  A bulk request is a
    tile's contiguous range, cut at ``CHUNK_BYTES``.  Each SM holds
    ``RING_PER_SM`` bytes of ring in as many blocks of ``BLOCK_STAGES``
    stages as fit, at least ``MIN_BLOCKS_PER_SM`` and at most
    ``MAX_BLOCKS_PER_SM``, each ring then as deep as the bytes allow: two
    blocks of 3 x 16 KiB at large tiles, three of 4 x 8 KiB at 8 KiB
    tiles, eight with deeper rings for requests under 3 KiB.  On an
    H100 one block an SM doubled (``rw``) more slowly, its threads' pass
    over a stage holding up its own copies, and a larger ring was no
    faster.  The grid is those blocks on every SM, or one a request when
    there are fewer requests.  A tile of whole rows of 16 KiB or more is
    the same run of 16 KiB requests whatever its size, so such tiles of
    one array launch the same kernel."""
    br, bc = _resolve(rows, cols, block_rows, block_cols)
    row_bytes, tile_col_bytes = cols * itemsize, bc * itemsize
    tiles = (rows // br) * (cols // bc)
    if not aligned or tile_col_bytes % BULK_UNIT:
        return KernelConfig("element", tiles, br, bc, row_bytes,
                            tile_col_bytes)
    whole = bc == cols
    segments = 1 if whole else br
    segment_bytes = br * row_bytes if whole else tile_col_bytes
    chunk = min(segment_bytes, CHUNK_BYTES)
    pieces = -(-segment_bytes // chunk)
    requests = tiles * segments * pieces
    per_sm = max(MIN_BLOCKS_PER_SM, min(
        MAX_BLOCKS_PER_SM, RING_PER_SM // (BLOCK_STAGES * chunk)))
    stages = max(MIN_STAGES, min(MAX_STAGES,
                                 RING_PER_SM // (per_sm * chunk)))
    return KernelConfig("bulk", min(requests, sm_count * per_sm), br, bc,
                        row_bytes, tile_col_bytes, chunk, stages, per_sm,
                        segments, segment_bytes, pieces, requests)


def _aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % BULK_UNIT == 0


def _sm_count(x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        return H100_SMS
    return decode_core.sm_count(x.device.index or 0)


def config(x: torch.Tensor, block_rows: int = 256,
           block_cols: int = 0) -> KernelConfig:
    """:func:`kernel_config` for a call on ``x`` (an output from the
    allocator is always 16-byte aligned)."""
    br, bc = tile(x, block_rows, block_cols)
    return kernel_config(*x.shape, x.element_size(), br, bc, _aligned(x),
                         _sm_count(x))


def kernel_knobs(x: torch.Tensor, block_rows: int = 256,
                 block_cols: int = 0) -> dict:
    """What the kernel does for this call: its route, the bytes of one
    access and of one contiguous request (the burst), the requests in
    flight per block, and the shared memory of a block's ring (the paper's
    BRAM column).  On the element route a block's tile is its burst and
    each thread keeps ``UNROLL`` loads in flight.  On a CUDA tensor the
    bulk route also names its blocks resident on the whole card
    (``kernel_resident_blocks``: its grid, sized to the SMs so that every
    block is resident at once)."""
    cfg = config(x, block_rows, block_cols)
    if cfg.route == "element":
        return dict(kernel_route="element",
                    kernel_unit_bytes=x.element_size(),
                    kernel_burst_bytes=(cfg.block_rows * cfg.tile_col_bytes),
                    kernel_outstanding=UNROLL, kernel_smem_bytes=0)
    out = dict(kernel_route="bulk", kernel_unit_bytes=BULK_UNIT,
               kernel_burst_bytes=cfg.chunk_bytes,
               kernel_outstanding=cfg.stages,
               kernel_smem_bytes=cfg.ring_bytes)
    if x.device.type == "cuda":
        out["kernel_resident_blocks"] = cfg.grid
    return out


def stream_copy(x: torch.Tensor, *, block_rows: int = 256,
                block_cols: int = 0, mode: str = "copy") -> torch.Tensor:
    """x: (rows, cols) float32, bfloat16 or int8 on a CUDA device ->
    a copy (``mode="copy"``) or ``x * 2`` (``mode="rw"``)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the stream_copy kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"dtype must be float32, bfloat16 or int8, got "
                         f"{x.dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    br, bc = tile(x, block_rows, block_cols)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, cols = x.shape
    if (rows // br) * (cols // bc) >= 2**31:
        raise ValueError(f"{rows // br} x {cols // bc} tiles exceed one "
                         f"launch's grid")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    cfg = config(x, br, bc)
    if cfg.requests + cfg.grid >= 2**31:
        raise ValueError(f"{cfg.requests} bulk requests exceed the "
                         f"kernel's int32 counter")
    element, bulk = _launchers()
    args = (x.data_ptr(), out.data_ptr(), rows, cols, br, bc,
            DTYPE_CODE[x.dtype], int(mode == "rw"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if cfg.route == "element":
            err = element(*args, stream)
        else:
            counters = decode_core.arrival_counters(x.device, 2)
            err = bulk(*args, cfg.grid, cfg.chunk_bytes, cfg.stages,
                       counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stream_copy kernel launch failed ({cfg.route} "
                           f"route): CUDA error {err}")
    LAUNCHES += 1
    return out
