"""Dispatch for the models and the memory engines: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (which raises on what it cannot
take).  There is no fallback from the kernel to the plain version.

``decode_attention`` and ``matmul`` take their tiles from the cached
:class:`repro_torch.tune.KernelPlan` when the caller leaves them unset, on
either device, as the reference's wrappers do, so the plan cache gets the
same keys."""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import pointer_chase as _pc
from repro_torch.kernels import random_gather as _rg
from repro_torch.kernels import ref
from repro_torch.kernels import stream_copy as _sc
from repro_torch.kernels import strided_copy as _st
from repro_torch.kernels.pointer_chase import (  # noqa: F401
    make_chain, make_chain_randperm)
from repro_torch.kernels.random_gather import lfsr_indices  # noqa: F401
from repro_torch.tune.cache import plan_for
from repro_torch.tune.plan import dtype_name


def paged_attention(q, k_pages, v_pages, page_table, valid_len, *,
                    scale=None, softcap=None, window=None, k_scale=None,
                    v_scale=None):
    kw = dict(scale=scale, softcap=softcap, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, page_table, valid_len,
                                   **kw)
    if q.device.type == "cuda":
        return _pa.paged_attention(q, k_pages, v_pages, page_table, valid_len,
                                   **kw)
    raise ValueError(f"paged_attention has no path for device {q.device}")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, **kw)
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, **kw)
    raise ValueError(f"flash_attention has no path for device {q.device}")


def stream_copy(x, *, block_rows=256, block_cols=0, mode="copy"):
    if x.device.type == "cpu":
        return ref.stream_copy(x, mode)
    if x.device.type == "cuda":
        return _sc.stream_copy(x, block_rows=block_rows,
                               block_cols=block_cols, mode=mode)
    raise ValueError(f"stream_copy has no path for device {x.device}")


def strided_copy(x, *, block_rows=8, stride=1):
    if x.device.type == "cpu":
        return ref.strided_copy(x, block_rows=block_rows, stride=stride)
    if x.device.type == "cuda":
        return _st.strided_copy(x, block_rows=block_rows, stride=stride)
    raise ValueError(f"strided_copy has no path for device {x.device}")


def random_gather(x, idx, *, block_rows=1):
    if x.device.type == "cpu":
        return ref.random_gather(x, idx, block_rows=block_rows)
    if x.device.type == "cuda":
        return _rg.random_gather(x, idx, block_rows=block_rows)
    raise ValueError(f"random_gather has no path for device {x.device}")


def pointer_chase(table, *, steps):
    if table.device.type == "cpu":
        return ref.pointer_chase(table, steps)
    if table.device.type == "cuda":
        return _pc.pointer_chase(table, steps=steps)
    raise ValueError(f"pointer_chase has no path for device {table.device}")


def decode_tiles(q, k, *, bkv=None, plan=None):
    """(bkv, depth) for a decode call: ``bkv`` left as None resolves from
    the cached plan for ``(T, D, dtype)``; the depth is the plan's
    ``pipeline_depth`` (2 without a plan); bkv is clamped to [1, T]."""
    t, d = k.shape[1], q.shape[-1]
    depth = _da.DEFAULT_DEPTH
    if bkv is None or plan is not None:
        if plan is None:
            plan = plan_for("decode_attention", shape_sig=(t, d),
                            dtype=dtype_name(k.dtype))
        bkv = bkv if bkv is not None else plan.bkv
        depth = plan.pipeline_depth
    return max(1, min(bkv, t)), depth


def decode_attention(q, k, v, valid_len, *, softcap=None, scale=None,
                     bkv=None, plan=None):
    """q: (B, Hq, D); k/v: (B, T, Hkv, D); valid_len: (B,) int32 ->
    (B, Hq, D), tiles as :func:`decode_tiles` resolves them."""
    bkv, depth = decode_tiles(q, k, bkv=bkv, plan=plan)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, valid_len, softcap=softcap,
                                    scale=scale)
    if q.device.type == "cuda":
        return _da.decode_attention(q, k, v, valid_len, softcap=softcap,
                                    scale=scale, bkv=bkv, depth=depth)
    raise ValueError(f"decode_attention has no path for device {q.device}")


def fit(block: int, dim: int) -> int:
    """A plan's tile must divide the actual dim: halve until it does (the
    reference's rule)."""
    block = min(block, dim)
    while dim % block:
        block //= 2
    return max(1, block)


def matmul_tiles(x, y, *, bm=None, bn=None, bk=None, plan=None):
    """(bm, bn, bk) for ``x @ y``: tiles left as None resolve from the
    cached plan for ``(M, N, K, dtype)``, its square tile fitted to each
    dim."""
    m, k = x.shape
    n = y.shape[1]
    if bm is None or bn is None or bk is None:
        if plan is None:
            plan = plan_for("matmul", shape_sig=(m, n, k),
                            dtype=dtype_name(x.dtype))
        bm = bm if bm is not None else fit(plan.bq, m)
        bn = bn if bn is not None else fit(plan.bq, n)
        bk = bk if bk is not None else fit(plan.bq, k)
    return min(bm, m), min(bn, n), min(bk, k)


def matmul(x, y, *, bm=None, bn=None, bk=None, plan=None):
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, float32 accumulation;
    tiles as :func:`matmul_tiles` resolves them."""
    bm, bn, bk = matmul_tiles(x, y, bm=bm, bn=bn, bk=bk, plan=plan)
    if x.device.type == "cpu":
        return ref.matmul(x, y)
    if x.device.type == "cuda":
        return _mm.matmul(x, y, bm=bm, bn=bn, bk=bk)
    raise ValueError(f"matmul has no path for device {x.device}")
