"""Dispatch for the models and the memory engines: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (which raises on what it cannot
take).  There is no fallback from the kernel to the plain version."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import pointer_chase as _pc
from repro_torch.kernels import random_gather as _rg
from repro_torch.kernels import ref
from repro_torch.kernels import stream_copy as _sc
from repro_torch.kernels import strided_copy as _st
from repro_torch.kernels.pointer_chase import (  # noqa: F401
    make_chain, make_chain_randperm)
from repro_torch.kernels.random_gather import lfsr_indices  # noqa: F401


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
