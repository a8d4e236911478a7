"""Random-access engine on the card: the wrapper of the CUDA kernel in
``csrc/random_gather.cu`` (the port of the Pallas kernel
``repro.kernels.random_gather.random_gather``), and the paper's LFSR
address generator (``repro.kernels.random_gather.lfsr_indices``), bit for
bit.

``block_rows`` rows form one unit and ``idx`` indexes units, as the Pallas
kernel's block index does: out's i-th unit is x's ``idx[i]``-th unit.  A
group of lanes copies one unit with the widest aligned word (16, 4, 2 or 1
bytes).  The wrapper takes CUDA tensors only;
:func:`repro_torch.kernels.ops.random_gather` sends CPU tensors to the
plain version.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Union

import torch

from repro_torch.kernels import build, decode_core

LAUNCHES = 0

DTYPES = (torch.float32, torch.bfloat16, torch.int8)
THREADS = 256        # kThreads in the source: lanes of one block

# maximal-length Galois LFSR taps (the reference's)
_TAPS = {16: 0xB400, 24: 0xE10000, 32: 0xA3000000}
_MASK32 = 0xFFFFFFFF


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


# ---------------------------------------------------------------------------
# the LFSR
# ---------------------------------------------------------------------------

def _apply_int(cols: List[int], s: int) -> int:
    """A GF(2)-linear map on 32-bit words (``cols[j]`` is the image of bit
    j) applied to one word."""
    r, j = 0, 0
    while s:
        if s & 1:
            r ^= cols[j]
        s >>= 1
        j += 1
    return r


def _apply(cols: List[int], v: torch.Tensor) -> torch.Tensor:
    """The same map applied to every word of an int64 tensor of 32-bit
    values."""
    out = torch.zeros_like(v)
    for j, c in enumerate(cols):
        if c:
            out ^= ((v >> j) & 1) * c
    return out


def lfsr_indices(n: int, *, bits: int = 24, seed: int = 0xACE1,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> torch.Tensor:
    """n indices in [0, 2^min(bits, 31)) from a Galois LFSR (paper Alg. 4),
    equal bit for bit to the reference's: the state starts at ``seed | 1``,
    each step shifts right and XORs the taps when the dropped bit was 1,
    and every state after a step is emitted, masked to ``min(bits, 31)``
    bits, as int32.

    One step is linear over GF(2), so the k-th state is A^k applied to the
    seed.  The states are built by doubling: from the first m, the next m
    are A^m applied to them, a handful of whole-tensor operations per
    doubling instead of n sequential steps.  ``device`` is where the
    indices are made (default: the CPU)."""
    taps = _TAPS[bits]
    step = [taps] + [1 << (j - 1) for j in range(1, 32)]
    out_mask = (1 << min(bits, 31)) - 1
    if n <= 0:
        return torch.empty(0, dtype=torch.int32, device=device)
    states = torch.tensor([_apply_int(step, (seed | 1) & _MASK32)],
                          dtype=torch.int64, device=device)
    power = step                                 # A^m, m = len(states)
    while states.numel() < n:
        m = states.numel()
        states = torch.cat([states, _apply(power, states[:n - m])])
        power = [_apply_int(power, c) for c in power]
    return (states & out_mask).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.cache
def _launcher():
    fn = build.load("random_gather").random_gather_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ll, ll, ll, i, vp]
    fn.restype = ctypes.c_int
    return fn


def units(x: torch.Tensor, block_rows: int):
    """(bytes of one unit, number of units) of a 2-D table."""
    if x.dim() != 2:
        raise ValueError(f"random_gather takes a 2-D table, got shape "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape
    if block_rows < 1 or rows % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide {rows} "
                         f"rows")
    return block_rows * cols * x.element_size(), rows // block_rows


def word_bytes(x: torch.Tensor, unit_bytes: int) -> int:
    """Bytes a thread moves per access: the widest of 16, 4, 2 that divides
    both a unit of ``unit_bytes`` and x's address, else 1."""
    for w in (16, 4, 2):
        if unit_bytes % w == 0 and x.data_ptr() % w == 0:
            return w
    return 1


@functools.cache
def _occupancy(kernel: str):
    fn = getattr(build.load(kernel), f"{kernel}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(kernel: str, device: torch.device, word: int) -> int:
    """Blocks of ``kernel`` (``random_gather`` or ``strided_copy``, its
    body for ``word``-byte accesses) that one SM of ``device`` holds at
    once: the CUDA occupancy calculator, through the source's
    ``<kernel>_blocks_per_sm``."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _occupancy(kernel)(word, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{kernel} occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value


def kernel_knobs(x: torch.Tensor, block_rows: int = 1,
                 n_idx: Optional[int] = None) -> dict:
    """What the kernel does for this table: bytes per access, lanes per
    gathered unit, and units in flight per block (``kernel_outstanding``:
    each of a block's lanes holds a load of its unit).  On a CUDA table,
    with the gather's index count ``n_idx``, also the blocks resident on
    the whole card (``kernel_resident_blocks``: the launch's grid, at most
    what the SMs hold at once)."""
    unit, _ = units(x, block_rows)
    word = word_bytes(x, unit)
    lanes = 1
    while lanes < 32 and 2 * lanes <= unit // word:
        lanes *= 2
    out = dict(kernel_unit_bytes=word, kernel_lanes_per_index=lanes,
               kernel_outstanding=THREADS // lanes)
    if x.device.type == "cuda" and n_idx:
        grid = -(-n_idx // (THREADS // lanes))
        index = x.device.index or 0
        out["kernel_resident_blocks"] = min(
            grid, blocks_per_sm("random_gather", x.device, word)
            * decode_core.sm_count(index))
    return out


def random_gather(x: torch.Tensor, idx: torch.Tensor, *,
                  block_rows: int = 1) -> torch.Tensor:
    """x: (rows, cols) float32, bfloat16 or int8; idx: (n,) int32 unit
    indices in [0, rows / block_rows), on one CUDA device ->
    (n * block_rows, cols)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the random_gather kernel takes CUDA tensors, got "
                         f"{x.device}")
    if idx.device != x.device:
        raise ValueError(f"idx is on {idx.device}, x on {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32, bfloat16 or int8, got "
                         f"{x.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be a 1-D int32 vector, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    unit, nunits = units(x, block_rows)
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    n = idx.shape[0]
    out = torch.empty((n * block_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    if n == 0 or unit == 0:
        return out
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                          nunits, unit, word_bytes(x, unit),
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"random_gather kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
