"""Strided-traversal engine on the card: the wrapper of the CUDA kernel in
``csrc/strided_copy.cu`` (the port of the Pallas kernel
``repro.kernels.strided_copy.strided_copy``).

Output block-row ``i`` is input block-row ``(i * stride) mod nblocks``; a
stride not coprime with ``nblocks`` repeats blocks (no permutation), as in
the reference.  One block of threads moves one block-row, 16-byte vectors
where it is 16-byte aligned.  The wrapper takes CUDA tensors only;
:func:`repro_torch.kernels.ops.strided_copy` sends CPU tensors to the plain
version.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, decode_core
from repro_torch.kernels.random_gather import blocks_per_sm, word_bytes

LAUNCHES = 0

DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher():
    fn = build.load("strided_copy").strided_copy_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, vp, ll, ll, ll, i, vp]
    fn.restype = ctypes.c_int
    return fn


def blocks(x: torch.Tensor, block_rows: int):
    """(rows per block, number of blocks), as the Pallas kernel resolves
    them: ``block_rows`` is capped at the row count and must divide it."""
    if x.dim() != 2:
        raise ValueError(f"strided_copy takes a 2-D array, got shape "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    br = min(block_rows, rows)
    if br < 1 or rows % br:
        raise ValueError(f"block_rows {br} does not divide {rows} rows")
    return br, rows // br


def kernel_knobs(x: torch.Tensor, block_rows: int = 8,
                 stride: int = 1) -> dict:
    """What the kernel does for this call: bytes per access, the block-row
    a block of threads moves (its burst, one request in flight a block),
    and ``kernel_stride`` 1 when the stride is coprime with the block
    count: every block-row is then read once, whole and contiguous, so no
    byte the card fetches is skipped (otherwise the row's stride).  On a
    CUDA tensor also the blocks resident on the whole card
    (``kernel_resident_blocks``)."""
    br, nblocks = blocks(x, block_rows)
    block_bytes = br * x.shape[1] * x.element_size()
    word = word_bytes(x, block_bytes)
    out = dict(kernel_unit_bytes=word, kernel_burst_bytes=block_bytes,
               kernel_outstanding=1,
               kernel_stride=1 if math.gcd(stride, nblocks) == 1 else stride)
    if x.device.type == "cuda":
        index = x.device.index or 0
        out["kernel_resident_blocks"] = min(
            nblocks, blocks_per_sm("strided_copy", x.device, word)
            * decode_core.sm_count(index))
    return out


def strided_copy(x: torch.Tensor, *, block_rows: int = 8,
                 stride: int = 1) -> torch.Tensor:
    """x: (rows, cols) float32, bfloat16 or int8 on a CUDA device."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the strided_copy kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32, bfloat16 or int8, got "
                         f"{x.dtype}")
    br, nblocks = blocks(x, block_rows)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if nblocks >= 2**31:
        raise ValueError(f"{nblocks} blocks exceed one launch's grid")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    block_bytes = br * x.shape[1] * x.element_size()
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), out.data_ptr(), nblocks,
                          stride % nblocks, block_bytes,
                          word_bytes(x, block_bytes),
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"strided_copy kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
