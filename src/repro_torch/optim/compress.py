"""int8 gradient compression with error feedback (the port of
``repro.optim.compress``).

Before the data-parallel reduction each shard quantizes its gradient to
int8 with a scale per leading row (4x fewer wire bytes than float32) and
keeps the quantization residual in an error-feedback buffer, so the bias
cancels over steps (EF-SGD / 1-bit Adam).  :func:`compressed_mean` is the
reduction itself: the mean over shards of each shard's dequantized view
(:mod:`repro_torch.dist.dp_shardmap`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.tree import leaves


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale): one scale per leading row (over every
    other dimension, kept), one for a scalar or a vector; the scale is
    the largest magnitude over 127 (at least 1e-12 / 127), codes rounded
    half to even."""
    x32 = x.float()
    if x.dim() >= 2:
        amax = torch.amax(torch.abs(x32), dim=tuple(range(1, x.dim())),
                          keepdim=True)
    else:
        amax = torch.amax(torch.abs(x32)).reshape((1,) * x.dim())
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """(codes, scale, new error): ``new error = (g + err) - dequant``."""
    corrected = g.float() + err
    q, s = quantize(corrected)
    return q, s, corrected - dequantize(q, s)


def compressed_mean(grads: Sequence[torch.Tensor],
                    errs: Sequence[torch.Tensor], device
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The counterpart of the reference's ``compressed_psum`` over one
    process's shards: each shard ``ef_compress``es its gradient against
    its own residual; the dequantized views are summed in shard order on
    ``device`` and divided by the shard count.  Returns (the mean, each
    shard's new residual on its own device)."""
    total, new_errs = None, []
    for g, e in zip(grads, errs):
        q, s, ne = ef_compress(g, e)
        deq = dequantize(q, s).to(device)
        total = deq if total is None else total + deq
        new_errs.append(ne)
    return total / float(len(grads)), new_errs


def wire_bytes_saved(tree) -> int:
    """float32 -> int8 wire bytes saved for a gradient tree: 3 a value."""
    total = sum(x.numel() for x in leaves(tree))
    return total * 4 - total
