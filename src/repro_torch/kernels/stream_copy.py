"""Sequential-stream engine on the card: the wrapper of the CUDA kernel in
``csrc/stream_copy.cu`` (the port of the Pallas kernel
``repro.kernels.stream_copy.stream_copy``).

One block of threads moves one ``(block_rows, block_cols)`` tile: the
tile's bytes are the paper's burst, a thread's access is a 16-byte vector
where the tile's rows are 16-byte aligned (one element otherwise), and a
thread issues ``UNROLL`` independent loads before it stores.
:func:`kernel_knobs` says which of these a call used.  The wrapper takes
CUDA tensors only; :func:`repro_torch.kernels.ops.stream_copy` sends CPU
tensors to the plain version.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = 0

THREADS = 256        # per block, as in the source
UNROLL = 4           # independent loads per thread, as in the source
VEC_BYTES = 16
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MODES = ("copy", "rw")


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher():
    fn = build.load("stream_copy").stream_copy_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, vp, ll, ll, ll, ll, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def tile(x: torch.Tensor, block_rows: int, block_cols: int):
    """The ``(br, bc)`` tile of a call, as the Pallas kernel resolves it:
    ``block_cols`` 0 means whole rows, ``block_rows`` is capped at the
    row count; both must divide the array."""
    if x.dim() != 2:
        raise ValueError(f"stream_copy takes a 2-D array, got shape "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape
    bc = cols if block_cols in (0, None) else block_cols
    br = min(block_rows, rows)
    if br < 1 or bc < 1 or rows % br or cols % bc:
        raise ValueError(f"tile ({br}, {bc}) does not divide the array "
                         f"{tuple(x.shape)}")
    return br, bc


def _vectorised(x: torch.Tensor, bc: int) -> bool:
    return (bc * x.element_size()) % VEC_BYTES == 0 and \
        x.data_ptr() % VEC_BYTES == 0


def kernel_knobs(x: torch.Tensor, block_rows: int = 256,
                 block_cols: int = 0) -> dict:
    """What the kernel does for this call: bytes per access, bytes of one
    block's tile, loads in flight per thread."""
    br, bc = tile(x, block_rows, block_cols)
    return dict(kernel_unit_bytes=VEC_BYTES if _vectorised(x, bc)
                else x.element_size(),
                kernel_burst_bytes=br * bc * x.element_size(),
                kernel_outstanding=UNROLL)


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
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), out.data_ptr(), rows, cols, br, bc,
                          DTYPE_CODE[x.dtype], int(mode == "rw"),
                          int(_vectorised(x, bc)),
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_copy kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
