"""Paged-KV decode attention on the card: the wrapper of the CUDA kernel in
``csrc/paged_attention.cu`` (the port of the Pallas kernel
``repro.kernels.paged_attention.paged_attention``).

Two routes (:func:`route`): bfloat16 q with bfloat16 or int8 pages at D
64, 128 or 256 runs on the tensor cores (``mma.sync``; warps that own token
slices, each with its own ring of 16-token tiles; int8 tiles become exact
bfloat16 fragments in registers, their scales applied outside the products;
see ``csrc/decode_core.cuh``); float32, float32 q with int8 pages and other
head dims on the CUDA cores.  Both merge the split partials inside the one
launch.  :func:`split_count` and :func:`kernel_config` say what a call
runs.

The wrapper checks what it is given, allocates the output and the split
partials (``torch.empty``), launches on PyTorch's current stream and raises
if the launch was refused.  It never synchronises, reads nothing back from
the card and allocates nothing else per call (the split merge's arrival
counters are one buffer per device, zeroed once), so a decode window can be
captured in a CUDA graph.  It takes CUDA tensors only;
:func:`repro_torch.kernels.ops.paged_attention` sends CPU tensors to the
plain version in :mod:`repro_torch.kernels.ref`.  ``LAUNCHES`` counts the
kernel's launches, so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_core as core
from repro_torch.kernels.decode_core import KernelConfig

LAUNCHES = 0

MAX_GROUP = core.MAX_GROUP    # query heads per kv head (kMaxGroup)
MAX_HEAD_DIM = 512    # kMaxHeadDim in the source
MMA_HEAD_DIMS = (64, 128, 256)
MMA_WARPS = 4         # tensor-core route: warps a block
MMA_STAGES = 3        # tensor-core route: a warp's ring
WHOLE_TABLE = 2048    # tensor-core route: a table row kept whole (kWholeTable)
TILE = 32             # CUDA-core route: tokens per tile (kTile)
BLOCKS_PER_SM = 4     # CUDA-core route: split the walk until the grid has this

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher(name: str):
    fn = getattr(build.load("paged_attention"), name)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "paged_attention_mma_launch":
        fn.argtypes = [vp] * 10 + [i] * 10 + [f, f, i, i, vp]
    else:
        fn.argtypes = [vp] * 10 + [i] * 6 + [f, f] + [i] * 4 + [vp]
    fn.restype = ctypes.c_int
    return fn


def occupancy(d: int, warps: int, stages: int, page: int, n_pages: int,
              splits: int, kv_dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of the tensor-core route resident on an SM, as the card
    reports (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs a
    card)."""
    fn = build.load("paged_attention").paged_attention_mma_occupancy
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    return fn(d, _DTYPE_CODE[kv_dtype], warps, stages, page, n_pages, splits)


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int) -> str:
    """``mma.sync`` for bfloat16 q with bfloat16 or int8 pages at D 64, 128
    or 256 (the tensor cores), else ``cuda-cores``."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and d in MMA_HEAD_DIMS):
        return "mma.sync"
    return "cuda-cores"


def pid_capacity(page: int, n_pages: int, splits: int) -> int:
    """Page ids a tensor-core block holds in shared memory: the table's
    whole row (loaded beside valid_len) up to ``WHOLE_TABLE`` pages, else
    its share of the table's 16-token tiles, plus one page where the share
    starts mid-page (``pid_capacity`` in the source)."""
    if n_pages <= WHOLE_TABLE:
        return n_pages
    per = -(-(-(-n_pages * page // core.TILE)) // splits)
    return -(-per * core.TILE // page) + 1


def split_count(route_: str, b: int, hkv: int, page: int, n_pages: int,
                sms: int) -> int:
    """Blocks that share one (sequence, kv head)'s walk of its table (N
    pages of ``page`` tokens), from the shapes alone.  Tensor cores
    (``route_`` ``mma.sync``): :func:`decode_core.split_count` over the
    table's 16-token tiles.  CUDA cores: enough for ``BLOCKS_PER_SM``
    blocks per SM, at most one per 32-token tile of the table."""
    n_tok = n_pages * page
    if route_ == "mma.sync":
        return core.split_count(b * hkv, -(-n_tok // core.TILE), MMA_WARPS,
                                sms)
    want = -(-BLOCKS_PER_SM * sms // (b * hkv))
    return max(1, min(-(-n_tok // TILE), want, core.MAX_SPLITS))


def kernel_config(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int,
                  page: int, n_pages: int, splits: int) -> KernelConfig:
    """What a call runs: on the tensor cores ``MMA_WARPS`` warps with rings
    of ``MMA_STAGES`` 16-token tiles (int8 pages: ``pages=int8``), fewer
    where the block's page ids (:func:`pid_capacity`) leave less shared
    memory (a table that leaves room for fewer than 2 stages raises); on
    the CUDA cores one 32-token tile at a time in a block of
    ``max(4, D/32)`` warps."""
    if route(q_dtype, kv_dtype, d) == "mma.sync":
        int8 = kv_dtype == torch.int8
        fit = core.mma_stages_fit(
            d, MMA_WARPS, extra=4 * pid_capacity(page, n_pages, splits),
            kv_bytes=1 if int8 else 2)
        if fit < core.MIN_STAGES:
            raise ValueError(f"a table of {n_pages} pages of {page} tokens "
                             f"in {splits} splits leaves a block's shared "
                             f"memory no room for {core.MIN_STAGES} stages "
                             f"at D={d}")
        return KernelConfig("mma.sync", core.TILE, min(MMA_STAGES, fit),
                            MMA_WARPS, "int8" if int8 else "")
    return KernelConfig("cuda-cores", TILE, 1, max(4, -(-d // 32)))


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
    _check(q, k_pages, v_pages, page_table, valid_len, k_scale, v_scale,
           softcap, window)
    d, page, n = q.shape[2], k_pages.shape[1], page_table.shape[1]
    splits = split_count(route(q.dtype, k_pages.dtype, d), q.shape[0],
                         k_pages.shape[2], page, n,
                         core.sm_count(q.device.index or 0))
    cfg = kernel_config(q.dtype, k_pages.dtype, d, page, n, splits)
    return launch(q, k_pages, v_pages, page_table, valid_len, cfg, splits,
                  scale=scale, softcap=softcap, window=window,
                  k_scale=k_scale, v_scale=v_scale)


def launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           page_table: torch.Tensor, valid_len: torch.Tensor,
           cfg: KernelConfig, splits: int, *, scale: Optional[float] = None,
           softcap: Optional[float] = None, window: Optional[int] = None,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch with an explicit configuration and split count (checked
    tensors; :func:`paged_attention` chooses both).  The splits merge as
    :func:`decode_core.merge_kind` says.  Raises if the card refuses the
    launch."""
    global LAUNCHES
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    n = page_table.shape[1]
    if cfg.route == "mma.sync" and (cfg.pages == "int8") != (
            k_pages.dtype == torch.int8):
        raise ValueError(f"configuration {cfg} does not match pages of "
                         f"{k_pages.dtype}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    cluster = core.merge_kind(cfg.route, splits) == "cluster"
    # split partials (none for one split or a cluster merge); freeing them
    # when this returns is safe: the caching allocator hands their memory
    # only to later work on this stream
    counted = splits > 1 and not cluster
    work = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if counted else None)
    scale = scale if scale is not None else d ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        counter = (core.arrival_counters(q.device, b * hkv)
                   if counted else None)
        ptrs = (work.data_ptr() if work is not None else None,
                counter.data_ptr() if counter is not None else None)
        scales = ((k_scale.data_ptr(), v_scale.data_ptr())
                  if k_scale is not None else (None, None))
        if cfg.route == "mma.sync":
            err = _launcher("paged_attention_mma_launch")(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                *scales, page_table.data_ptr(), valid_len.data_ptr(),
                out.data_ptr(), *ptrs, b, hq, hkv, d, page, n, cfg.warps,
                cfg.stages, splits, int(cluster), scale, softcap or 0.0,
                window or 0, _DTYPE_CODE[k_pages.dtype], stream)
        else:
            err = _launcher("paged_attention_cc_launch")(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                *scales, page_table.data_ptr(), valid_len.data_ptr(),
                out.data_ptr(), *ptrs, b, hq, hkv, d, page, n, scale,
                softcap or 0.0, window or 0, splits, _DTYPE_CODE[q.dtype],
                _DTYPE_CODE[k_pages.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
