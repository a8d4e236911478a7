"""Blockwise (flash) attention on the card: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (the port of the Pallas kernel
``repro.kernels.flash_attention.flash_attention``).

The wrapper routes by dtype (:func:`route`): bfloat16 runs on the tensor
cores (``mma.sync`` m16n8k16, FlashAttention-2 style, P split into bfloat16
high and low parts for the P V product), float32 on the CUDA cores.  It
checks what it is given, allocates the output with q's strides (so the
model's ``(B, S, H, D)`` activations, viewed as ``(B, H, S, D)``, go in and
come out without a copy), launches on PyTorch's current stream and raises
if the launch was refused; nothing falls back from one route to the other.
It takes CUDA tensors only; :func:`repro_torch.kernels.ops.flash_attention`
sends CPU tensors to the plain version in :mod:`repro_torch.kernels.ref`.
The kernel picks its own tiles (64 query rows; 64-key tiles, 32 at D 256 on
the tensor cores; :data:`DESIGN`); the reference's ``bq``/``bkv`` block
choice does not reach it.  ``LAUNCHES`` counts the kernel's launches, so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0

HEAD_DIMS = (64, 128, 256)     # instantiated in the source
ROUTES = {torch.bfloat16: "mma.sync", torch.float32: "cuda-cores"}
# the tensor-core route's design: its tiles and P V's precision
DESIGN = ("tile=64 rows x 64 keys (32 at D 256) split between 2 warps per 16 "
          "rows, 8 warps, K/V in a 3-stage cp.async ring, heaviest tiles "
          "first, P V precision=bf16 hi+lo")


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher(name):
    fn = getattr(build.load("flash_attention"), name)
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn.argtypes = [vp] * 4 + [i] * 6 + [ll] * 12 + [f, f, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def route(dtype: torch.dtype) -> str:
    """The kernel body a dtype runs on: ``"mma.sync"`` (tensor cores) for
    bfloat16, ``"cuda-cores"`` for float32."""
    if dtype not in ROUTES:
        raise ValueError(f"q must be float32 or bfloat16, got {dtype}")
    return ROUTES[dtype]


def occupancy(d: int) -> int:
    """Blocks of the bfloat16 route resident on one SM at head dim ``d``,
    as the CUDA runtime computes it for the built kernel (needs a card)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"D={d} not in {HEAD_DIMS}")
    fn = build.load("flash_attention").flash_attention_bf16_occupancy
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    blocks = fn(d)
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed at D={d}")
    return blocks


def _check(q, k, v, softcap, window):
    """Refuses what the kernel cannot take: dtypes, shapes and options first
    (so they are checked on any device), then devices and row alignment."""
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be q's dtype ({q.dtype}), got "
                             f"{t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} must be (B, Hq, Sq, D), "
                         f"k/v {tuple(k.shape)} / {tuple(v.shape)} "
                         f"(B, Hkv, Skv, D)")
    b, hq, _, d = q.shape
    bk, hkv, _, dk = k.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv or d not in HEAD_DIMS:
        raise ValueError(f"unsupported geometry B={b}/{bk} Hq={hq} Hkv={hkv} "
                         f"D={d}/{dk} (needs equal B and D, Hq % Hkv == 0, "
                         f"D in {HEAD_DIMS})")
    route(q.dtype)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, got "
                         f"q on {q.device}")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (st * size) % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned with a "
                             f"unit D stride; got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype, with q's strides.  See :func:`repro_torch.kernels.ref.
    flash_attention` for the semantics."""
    global LAUNCHES
    _check(q, k, v, softcap, window)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)     # a dense view keeps q's strides
    if b == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        name = ("flash_attention_bf16_launch" if route(q.dtype) == "mma.sync"
                else "flash_attention_f32_launch")
        err = _launcher(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3],
            scale if scale is not None else d ** -0.5, softcap or 0.0,
            int(bool(causal)), window or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
