"""Flash-decode attention on the card: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` (the port of the Pallas kernel
``repro.kernels.decode_attention.decode_attention``).

The tuned plan's two knobs reach the kernel: ``bkv`` K/V rows per tile
(the burst, staged in shared memory with 16-byte ``cp.async`` copies) and
``depth`` tiles in flight (the outstanding count).  The ring of ``depth``
tiles must fit the shared memory of a block (227 KiB on the H100, beside
the query rows and the scores): the rule is that the kernel runs
``min(depth, what fits)`` stages, and a tile of which not even one stage
fits raises.  :func:`tiles` says what a call runs.

The wrapper checks what it is given, allocates the output (and, when the
token walk is split across blocks, the split partials), launches on
PyTorch's current stream and raises if the launch was refused.  It takes
CUDA tensors only; :func:`repro_torch.kernels.ops.decode_attention` sends
CPU tensors to the plain version in :mod:`repro_torch.kernels.ref`.
``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.core.memmodel import H100
from repro_torch.kernels import build

LAUNCHES = 0

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16        # query heads per kv head (kMaxGroup in the source)
MAX_STAGES = 32       # tiles in flight (kMaxStages in the source)
SMEM_BYTES = H100.smem_bytes   # shared memory a block can use
BLOCKS_PER_SM = 4     # split the token walk until the grid has this many
DEFAULT_DEPTH = 2     # tiles in flight when no plan gives a depth

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher():
    fn = build.load("decode_attention").decode_attention_launch
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 6 + [i] * 8 + [f, f, i, vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stages_for(g: int, d: int, itemsize: int, bkv: int, depth: int) -> int:
    """Stages of the ring the kernel runs: the plan's depth, capped by what
    fits the shared memory of a block beside the query rows and scores;
    raises when not one tile of ``bkv`` rows fits."""
    if bkv < 1 or depth < 1:
        raise ValueError(f"bkv and depth must be >= 1, got {bkv}, {depth}")
    fixed = g * d * 4 + -(-g * bkv * 4 // 16) * 16
    stage = 2 * bkv * d * itemsize
    fit = (SMEM_BYTES - fixed) // stage
    if fit < 1:
        raise ValueError(f"a tile of bkv={bkv} K/V rows of D={d} "
                         f"({stage} bytes, beside {fixed} of query rows and "
                         f"scores) does not fit the {SMEM_BYTES} bytes of "
                         f"shared memory of a block")
    return min(depth, fit, MAX_STAGES)


def tiles(q: torch.Tensor, k: torch.Tensor, bkv: int,
          depth: int) -> Dict[str, int]:
    """What a launch on these tensors runs: rows per tile, the depth asked
    for, the stages of the ring, and the blocks that split each (sequence,
    kv head)'s token walk (enough for ``BLOCKS_PER_SM`` blocks per SM, at
    most one per tile)."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    stages = stages_for(hq // hkv, d, q.element_size(), bkv, depth)
    want = -(-BLOCKS_PER_SM * _sm_count(q.device.index or 0) // (b * hkv))
    splits = max(1, min(-(-t // bkv), want))
    return dict(bkv=bkv, depth=depth, stages=stages, splits=splits)


def _check(q, k, v, valid_len, softcap):
    if q.device.type != "cuda":
        raise ValueError(f"the decode_attention kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    for name, t in (("k", k), ("v", v), ("valid_len", valid_len)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid_len", valid_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} must be (B, Hq, D), "
                         f"k/v {tuple(k.shape)} / {tuple(v.shape)} "
                         f"(B, T, Hkv, D)")
    b, hq, d = q.shape
    bk, t, hkv, dk = k.shape
    if bk != b or dk != d or t == 0 or hkv == 0 or hq % hkv \
            or hq // hkv > MAX_GROUP or d not in HEAD_DIMS:
        raise ValueError(f"unsupported geometry B={b}/{bk} T={t} Hq={hq} "
                         f"Hkv={hkv} D={d}/{dk} (needs equal B and D, T > 0, "
                         f"Hq % Hkv == 0, Hq/Hkv <= {MAX_GROUP}, D in "
                         f"{HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t_ in (("k", k), ("v", v)):
        if t_.dtype != q.dtype:
            raise ValueError(f"{name} must be q's dtype ({q.dtype}), got "
                             f"{t_.dtype}")
        if t_.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if valid_len.dtype != torch.int32 or tuple(valid_len.shape) != (b,):
        raise ValueError(f"valid_len must be int32 (B={b},), got "
                         f"{valid_len.dtype} {tuple(valid_len.shape)}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None, bkv: int = 8,
                     depth: int = DEFAULT_DEPTH) -> torch.Tensor:
    """q: (B, Hq, D); k/v: (B, T, Hkv, D); valid_len: (B,) int32 ->
    (B, Hq, D) in q's dtype.  See :func:`repro_torch.kernels.ref.
    decode_attention` for the semantics; a row with ``valid_len == 0`` is
    exactly 0 here."""
    global LAUNCHES
    _check(q, k, v, valid_len, softcap)
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0:
        return out
    run = tiles(q, k, bkv, depth)
    splits = run["splits"]
    # split partials; freeing them when this returns is safe: the caching
    # allocator hands their memory only to later work on this stream
    work = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), work.data_ptr() if work is not None else None,
            b, hq, hkv, t, d, bkv, run["stages"], splits,
            scale if scale is not None else d ** -0.5, softcap or 0.0,
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
