"""Paged-KV decode attention on the card: the wrapper of the CUDA kernel in
``csrc/paged_attention.cu`` (the port of the Pallas kernel
``repro.kernels.paged_attention.paged_attention``).

The wrapper checks what it is given, allocates the output (and, when the
token walk is split across blocks, the split partials), launches on
PyTorch's current stream and raises if the launch was refused.  It takes
CUDA tensors only; :func:`repro_torch.kernels.ops.paged_attention` sends CPU
tensors to the plain version in :mod:`repro_torch.kernels.ref`.
``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0

MAX_GROUP = 16        # query heads per kv head (kMaxGroup in the source)
MAX_HEAD_DIM = 512    # kMaxHeadDim in the source
TILE = 32             # tokens per tile (kTile in the source)
BLOCKS_PER_SM = 4     # split the token walk until the grid has this many

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher():
    fn = build.load("paged_attention").paged_attention_launch
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 9 + [i] * 6 + [f, f] + [i] * 4 + [vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits_for(device: torch.device, b: int, hkv: int, n_tok: int) -> int:
    """Blocks that share one (sequence, kv head)'s token walk: enough for
    ``BLOCKS_PER_SM`` blocks per SM, at most one per tile of the table."""
    tiles = -(-n_tok // TILE)
    want = -(-BLOCKS_PER_SM * _sm_count(device.index) // (b * hkv))
    return max(1, min(tiles, want))


def _check(q, k_pages, v_pages, page_table, valid_len, k_scale, v_scale,
           softcap, window):
    if q.device.type != "cuda":
        raise ValueError(f"the paged_attention kernel takes CUDA tensors, got "
                         f"q on {q.device}")
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages, page_table=page_table,
                 valid_len=valid_len)
    if k_scale is not None or v_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t is None:
            raise ValueError("k_scale and v_scale must be passed together")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} must be (B, Hq, D), "
                         f"k/v_pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} (P, page, Hkv, D)")
    b, hq, d = q.shape
    pool, page, hkv, dk = k_pages.shape
    if dk != d or hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP \
            or d > MAX_HEAD_DIM:
        raise ValueError(f"unsupported geometry Hq={hq} Hkv={hkv} D={d} "
                         f"(pages D={dk}; needs Hq % Hkv == 0, "
                         f"Hq/Hkv <= {MAX_GROUP}, D <= {MAX_HEAD_DIM})")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"page_table must be int32 (B={b}, N), got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if valid_len.dtype != torch.int32 or tuple(valid_len.shape) != (b,):
        raise ValueError(f"valid_len must be int32 (B={b},), got "
                         f"{valid_len.dtype} {tuple(valid_len.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    quant = k_scale is not None
    if k_pages.dtype == torch.int8:
        if not quant:
            raise ValueError("int8 pages need k_scale and v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (pool, page):
                raise ValueError(f"{name} must be float32 (P={pool}, "
                                 f"page={page}), got {t.dtype} "
                                 f"{tuple(t.shape)}")
    elif k_pages.dtype != q.dtype or quant:
        raise ValueError(f"pages must be q's dtype ({q.dtype}) without "
                         f"scales, or int8 with scales; got {k_pages.dtype}"
                         f"{' with scales' if quant else ''}")
    if (d * k_pages.element_size()) % 16 or any(
            t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError(f"page rows must be 16-byte aligned: D={d} of "
                         f"{k_pages.dtype} is {d * k_pages.element_size()} "
                         f"bytes, a multiple of 16 is needed")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    valid_len: torch.Tensor, *, scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); page_table: (B, N) int32;
    valid_len: (B,) int32 -> (B, Hq, D) in q's dtype.  See
    :func:`repro_torch.kernels.ref.paged_attention` for the semantics."""
    global LAUNCHES
    _check(q, k_pages, v_pages, page_table, valid_len, k_scale, v_scale,
           softcap, window)
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    n = page_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    quant = k_scale is not None
    splits = _splits_for(q.device, b, hkv, n * page)
    # split partials; freeing them when this returns is safe: the caching
    # allocator hands their memory only to later work on this stream
    work = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            page_table.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
            work.data_ptr() if work is not None else None,
            b, hq, hkv, d, page, n,
            scale if scale is not None else d ** -0.5,
            softcap or 0.0, window or 0, splits,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
