"""Flash-decode attention on the card: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` (the port of the Pallas kernel
``repro.kernels.decode_attention.decode_attention``).

Two routes, by dtype (:func:`route`): bfloat16 on the tensor cores
(``mma.sync``; warps that own token slices, each with its own ring of
16-token tiles; see ``csrc/decode_core.cuh``) and float32 on the CUDA cores.
The tuned plan's two knobs, ``bkv`` rows per tile and ``depth`` tiles in
flight, are the model's; :func:`kernel_config` maps them onto the
configuration the kernel runs:

- bfloat16: tiles of 16 tokens a warp, 4 warps a block, and a ring deep
  enough to keep the plan's ``bkv * depth`` rows of a (sequence, kv head)
  in flight (at least 2 stages, at most what fits);
- float32: the plan's ``bkv`` rows per tile and ``min(depth, what fits)``
  stages, as the plan says; a tile of which not even one stage fits a
  block's 227 KiB raises.

Both merge the split partials inside the one launch.  :func:`tiles` says
what a call runs.  The wrapper checks what it is given, allocates the
output and the split partials (``torch.empty``), launches on PyTorch's
current stream and raises if the launch was refused; it never synchronises.
It takes CUDA tensors only; :func:`repro_torch.kernels.ops.decode_attention`
sends CPU tensors to the plain version in :mod:`repro_torch.kernels.ref`.
``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_core as core
from repro_torch.kernels.decode_core import KernelConfig

LAUNCHES = 0

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = core.MAX_GROUP    # query heads per kv head (kMaxGroup)
MAX_STAGES = 32       # float32 route: tiles in flight (kMaxRingStages)
SMEM_BYTES = core.SMEM_BYTES  # shared memory a block can use
BLOCKS_PER_SM = 4     # float32 route: split the walk until the grid has this
DEFAULT_DEPTH = 2     # tiles in flight when no plan gives a depth
MMA_WARPS = 4         # bfloat16 route: warps a block

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.cache
def _launcher(name: str):
    fn = getattr(build.load("decode_attention"), name)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = 9 if name == "decode_attention_bf16_launch" else 8
    fn.argtypes = [vp] * 7 + [i] * ints + [f, f, vp]
    fn.restype = ctypes.c_int
    return fn


def occupancy(d: int, warps: int, stages: int) -> int:
    """Blocks of the bfloat16 route resident on an SM, as the card reports
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs a card)."""
    fn = build.load("decode_attention").decode_attention_bf16_occupancy
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(d, warps, stages)


def route(dtype: torch.dtype) -> str:
    """``mma.sync`` (bfloat16, the tensor cores) or ``cuda-cores``
    (float32); anything else is refused."""
    if dtype == torch.bfloat16:
        return "mma.sync"
    if dtype == torch.float32:
        return "cuda-cores"
    raise ValueError(f"q must be float32 or bfloat16, got {dtype}")


def stages_for(g: int, d: int, itemsize: int, bkv: int, depth: int) -> int:
    """Stages of the float32 route's ring: the plan's depth, capped by what
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


def kernel_config(t: int, d: int, g: int, itemsize: int, bkv: int,
                  depth: int) -> KernelConfig:
    """The configuration the kernel runs for a plan's ``bkv`` rows per tile
    and ``depth`` tiles in flight, at T = ``t``, head dim ``d``, ``g``
    query rows per kv head and K/V elements of ``itemsize`` bytes.

    bfloat16 (itemsize 2): ``MMA_WARPS`` warps, each walking tiles of 16
    tokens; its ring keeps the plan's ``bkv * depth`` rows in flight across
    the block's warps (``1 + ceil(bkv * depth / (16 * warps))`` stages),
    with at least 2 stages, at most what fits a block and no more than the
    tiles a warp walks at T (plus one).  float32 (itemsize 4): the plan's
    tile and depth, capped by the shared memory (:func:`stages_for`), with
    ``max(4, D/32)`` warps."""
    if bkv < 1 or depth < 1:
        raise ValueError(f"bkv and depth must be >= 1, got {bkv}, {depth}")
    if itemsize == 2:
        warps = MMA_WARPS
        stages = 1 + -(-bkv * depth // (core.TILE * warps))
        warp_tiles = -(-(-(-t // core.TILE)) // warps)
        stages = min(stages, warp_tiles + 1,
                     core.mma_stages_fit(d, warps), core.MAX_STAGES)
        return KernelConfig("mma.sync", core.TILE,
                            max(stages, core.MIN_STAGES), warps)
    stages = stages_for(g, d, itemsize, bkv, depth)
    return KernelConfig("cuda-cores", bkv, stages, max(4, -(-d // 32)))


def tiles(q: torch.Tensor, k: torch.Tensor, bkv: int,
          depth: int) -> Dict[str, Union[int, str]]:
    """What a launch on these tensors runs: the plan's rows per tile and
    depth, the kernel's configuration (route, tile, stages, warps), the
    blocks that split each (sequence, kv head)'s token walk and how they
    merge."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    cfg = kernel_config(t, d, hq // hkv, q.element_size(), bkv, depth)
    sms = core.sm_count(q.device.index or 0)
    if cfg.route == "mma.sync":
        splits = core.split_count(b * hkv, -(-t // core.TILE), cfg.warps,
                                  sms)
    else:
        want = -(-BLOCKS_PER_SM * sms // (b * hkv))
        splits = max(1, min(-(-t // cfg.tile), want, core.MAX_SPLITS))
    return dict(bkv=bkv, depth=depth, route=cfg.route, tile=cfg.tile,
                stages=cfg.stages, warps=cfg.warps, splits=splits,
                merge=core.merge_kind(cfg.route, splits), config=str(cfg))


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
    route(q.dtype)
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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_len: torch.Tensor, cfg: KernelConfig, splits: int, *,
           softcap: Optional[float] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """One launch with an explicit configuration and split count (checked
    tensors; :func:`decode_attention` chooses both).  The splits merge as
    :func:`decode_core.merge_kind` says.  Raises if the card refuses the
    launch."""
    global LAUNCHES
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
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
    with torch.cuda.device(q.device):
        counter = (core.arrival_counters(q.device, b * hkv)
                   if counted else None)
        if cfg.route == "mma.sync":
            fn, knobs = (_launcher("decode_attention_bf16_launch"),
                         (cfg.warps, cfg.stages, splits, int(cluster)))
        else:
            fn, knobs = (_launcher("decode_attention_f32_launch"),
                         (cfg.tile, cfg.stages, splits))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 valid_len.data_ptr(), out.data_ptr(),
                 work.data_ptr() if work is not None else None,
                 counter.data_ptr() if counter is not None else None,
                 b, hq, hkv, t, d, *knobs,
                 scale if scale is not None else d ** -0.5, softcap or 0.0,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None, bkv: int = 8,
                     depth: int = DEFAULT_DEPTH) -> torch.Tensor:
    """q: (B, Hq, D); k/v: (B, T, Hkv, D); valid_len: (B,) int32 ->
    (B, Hq, D) in q's dtype.  See :func:`repro_torch.kernels.ref.
    decode_attention` for the semantics; a row with ``valid_len == 0`` is
    exactly 0 here."""
    _check(q, k, v, valid_len, softcap)
    run = tiles(q, k, bkv, depth)
    cfg = KernelConfig(run["route"], run["tile"], run["stages"],
                       run["warps"])
    return launch(q, k, v, valid_len, cfg, run["splits"], softcap=softcap,
                  scale=scale)
