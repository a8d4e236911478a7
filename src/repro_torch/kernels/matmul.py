"""Tiled matrix product on the card: the wrapper of the CUDA kernel in
``csrc/matmul.cu`` (the port of the Pallas kernel
``repro.kernels.matmul.matmul``).

The wrapper routes by dtype (:func:`route`).  bfloat16 runs on the tensor
cores: ``wgmma`` from shared memory fed by a TMA ring, in one of the
configurations compiled into ``csrc/matmul.cu`` (:func:`compiled_configs`),
which :func:`kernel_config` picks from the shape and the plan's ``bn``.  float32 runs on the CUDA cores, whose tiles ``(bm, bn,
bk)`` are the plan's own, taken at run time: one block per ``(bm, bn)``
output tile, walking K in steps of ``bk``, a step staged in shared memory
whole when its float32 A and B tiles fit the shared memory of a block, else
in sub-steps of ``kc`` rows (:func:`staging`); ``bm`` and ``bn`` above 128
raise there.  (A float32 product on the tensor cores would be TF32.)

The wrapper checks what it is given, allocates the output, launches on
PyTorch's current stream and raises if the launch was refused; nothing
falls back from one route to the other.  It takes CUDA tensors only;
:func:`repro_torch.kernels.ops.matmul` sends CPU tensors to the plain
version in :mod:`repro_torch.kernels.ref`.  ``LAUNCHES`` counts the
kernel's launches, so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import torch

from repro_torch.core.memmodel import H100
from repro_torch.kernels import build

LAUNCHES = 0

MAX_TILE = 128        # float32 bm, bn: 16 threads x 8 outputs along each axis
SMEM_BYTES = H100.smem_bytes   # shared memory a block can use
MAX_M_TILES = 65535   # grid.y

ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda-cores"}
TILE_K = 64           # a stage's K: one 128-byte swizzled row of bfloat16
DECODE_M = 64         # M at or below this takes the decode configuration


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher(name):
    fn = getattr(build.load("matmul"), name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 3 + [i] * 7 + [vp]
    fn.restype = ctypes.c_int
    return fn


def route(dtype: torch.dtype) -> str:
    """The kernel body a dtype runs on: ``"wgmma"`` (tensor cores) for
    bfloat16, ``"cuda-cores"`` for float32."""
    if dtype not in ROUTES:
        raise ValueError(f"x and y must both be float32 or both bfloat16, "
                         f"got {dtype}")
    return ROUTES[dtype]


def staging(bm: int, bn: int, bk: int) -> int:
    """float32 route: rows of K staged at once (``kc``): ``bk`` when a
    float32 stage of A (padded to bm + 1 columns) and B fits the shared
    memory of a block, else ``bk`` halved (rounding up) until it does."""
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


@functools.cache
def compiled_configs() -> dict:
    """(tile_m, tile_n) -> ring stages of each bfloat16 configuration, read
    from the one list of them, ``MATMUL_BF16_CONFIGS`` in the kernel's
    source."""
    line = re.search(r"^#define MATMUL_BF16_CONFIGS\(X\)(.*)$",
                     build.sources()["matmul"].read_text(), re.M).group(1)
    triples = re.findall(r"X\((\d+), (\d+), (\d+)\)", line)
    return {(int(tm), int(tn)): int(st) for tm, tn, st in triples}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """A compiled configuration of the bfloat16 route (its K tile is
    ``TILE_K``)."""
    tile_m: int
    tile_n: int
    stages: int
    staging: str        # "tma" or "elementwise"

    def __str__(self) -> str:
        return (f"wgmma tile={self.tile_m}x{self.tile_n}x{TILE_K} "
                f"stages={self.stages} staging={self.staging}")


def kernel_config(m: int, n: int, k: int, bn: int, *,
                  aligned: bool = True) -> KernelConfig:
    """The bfloat16 route's configuration for x (m, k) @ y (k, n) when the
    plan's column tile is ``bn``.

    Rule: M <= 64 takes the decode configuration, a 64 x 64 tile with an
    8-stage ring (bound by y's bytes: N/64 blocks each stream their K-walk
    of y, so no split of K is needed).  Otherwise the tile is 128 rows, and
    256 columns when bn >= 128 and N >= 256, else 128.  The plan's bm and
    bk choose nothing here: the tiles are fixed, and a stage's K is always
    ``TILE_K``.  Staging is TMA when K and N are multiples of 8 (rows of
    16-byte multiples) and ``aligned`` (both bases 16-byte aligned), else
    element by element."""
    for name, v in (("m", m), ("n", n), ("k", k), ("bn", bn)):
        if v < 1:
            raise ValueError(f"{name}={v}: must be >= 1")
    if m <= DECODE_M:
        tile = (64, 64)
    else:
        tile = (128, 256 if bn >= 128 and n >= 256 else 128)
    tma = aligned and k % 8 == 0 and n % 8 == 0
    return KernelConfig(*tile, compiled_configs()[tile],
                        "tma" if tma else "elementwise")


def _aligned(x, y) -> bool:
    return x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0


def configuration(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int,
                  bk: int) -> str:
    """What a call with these operands and tiles runs: the route and its
    configuration (bfloat16) or its tiles and ``kc`` (float32)."""
    m, k = x.shape
    n = y.shape[1]
    if route(x.dtype) == "wgmma":
        return str(kernel_config(m, n, k, bn, aligned=_aligned(x, y)))
    return f"cuda-cores tiles=({bm},{bn},{bk}) kc={staging(bm, bn, bk)}"


def _check(x, y):
    """Refuses what the kernel cannot take: the operands' shapes, dtypes and
    layout first (so they are checked on any device), then their device."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0] \
            or 0 in x.shape or y.shape[1] == 0:
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (M, K) and y "
                         f"{tuple(y.shape)} (K, N), none empty")
    if y.dtype != x.dtype:
        raise ValueError(f"x and y must both be float32 or both bfloat16, "
                         f"got {x.dtype} and {y.dtype}")
    route(x.dtype)
    for name, t in (("x", x), ("y", y)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"the matmul kernel takes CUDA tensors, got x on "
                         f"{x.device}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
           bk: int) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, float32 accumulation.
    See :func:`repro_torch.kernels.ref.matmul`."""
    global LAUNCHES
    _check(x, y)
    m, k = x.shape
    n = y.shape[1]
    if route(x.dtype) == "wgmma":
        cfg = kernel_config(m, n, k, bn, aligned=_aligned(x, y))
        tile_m, name = cfg.tile_m, "matmul_bf16_launch"
        args = (cfg.tile_m, cfg.tile_n, cfg.stages,
                int(cfg.staging == "tma"))
    else:
        tile_m, name = bm, "matmul_f32_launch"
        args = (bm, bn, bk, staging(bm, bn, bk))
    if -(-m // tile_m) > MAX_M_TILES:
        raise ValueError(f"M={m} in tiles of {tile_m} is more than "
                         f"{MAX_M_TILES} row tiles")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher(name)(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *args,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
