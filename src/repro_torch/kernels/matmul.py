"""Tiled matrix product on the card: the wrapper of the CUDA kernel in
``csrc/matmul.cu`` (the port of the Pallas kernel
``repro.kernels.matmul.matmul``).

The tiles ``(bm, bn, bk)`` are the kernel's own, taken at run time: one
block per ``(bm, bn)`` output tile, walking K in steps of ``bk``.  A step
is staged in shared memory whole when its float32 A and B tiles fit the
shared memory of a block, else in sub-steps of ``kc`` rows, ``kc`` halved
from ``bk`` until they fit (:func:`staging`).  ``bm`` and ``bn`` above 128
raise: a thread keeps at most 8 x 8 outputs in registers.

The wrapper checks what it is given, allocates the output, launches on
PyTorch's current stream and raises if the launch was refused.  It takes
CUDA tensors only; :func:`repro_torch.kernels.ops.matmul` sends CPU tensors
to the plain version in :mod:`repro_torch.kernels.ref`.  ``LAUNCHES``
counts the kernel's launches, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.memmodel import H100
from repro_torch.kernels import build

LAUNCHES = 0

MAX_TILE = 128        # bm, bn: 16 threads x 8 outputs along each axis
SMEM_BYTES = H100.smem_bytes   # shared memory a block can use
MAX_M_TILES = 65535   # grid.y

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher():
    fn = build.load("matmul").matmul_launch
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 3 + [i] * 8 + [vp]
    fn.restype = ctypes.c_int
    return fn


def staging(bm: int, bn: int, bk: int) -> int:
    """Rows of K staged at once (``kc``): ``bk`` when a float32 stage of A
    (padded to bm + 1 columns) and B fits the shared memory of a block,
    else ``bk`` halved (rounding up) until it does."""
    for name, t in (("bm", bm), ("bn", bn)):
        if not 1 <= t <= MAX_TILE:
            raise ValueError(f"{name}={t}: the matmul kernel takes tiles of "
                             f"1 to {MAX_TILE}")
    if bk < 1:
        raise ValueError(f"bk={bk}: must be >= 1")
    kc = bk
    while kc * (bm + 1 + bn) * 4 > SMEM_BYTES:
        kc = -(-kc // 2)
    return kc


def _check(x, y, bm):
    if x.device.type != "cuda":
        raise ValueError(f"the matmul kernel takes CUDA tensors, got x on "
                         f"{x.device}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0] \
            or 0 in x.shape or y.shape[1] == 0:
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (M, K) and y "
                         f"{tuple(y.shape)} (K, N), none empty")
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise ValueError(f"x and y must both be float32 or both bfloat16, "
                         f"got {x.dtype} and {y.dtype}")
    for name, t in (("x", x), ("y", y)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if -(-x.shape[0] // bm) > MAX_M_TILES:
        raise ValueError(f"M={x.shape[0]} in tiles of bm={bm} is more than "
                         f"{MAX_M_TILES} row tiles")


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
           bk: int) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, float32 accumulation.
    See :func:`repro_torch.kernels.ref.matmul`."""
    global LAUNCHES
    kc = staging(bm, bn, bk)
    _check(x, y, bm)
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
            kc, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
