"""GQA/MQA attention over a paged KV cache: the plain gather-then-attend
path that chunked prefill takes (decode goes through the
``paged_attention`` kernel, :mod:`repro_torch.kernels.ops`).

Causal masks, sliding windows, softcap, GQA grouping and per-batch
absolute offsets, as in ``repro.models.attention``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import common

NEG_INF = -1e30


class AttnParams(NamedTuple):
    causal: bool = True
    window: Optional[int] = None
    softcap: Optional[float] = None
    scale: Optional[float] = None


def _mask(q_pos, k_pos, causal, window, kv_valid_len=None):
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos >= k_pos
    if window is not None:
        m &= (q_pos - k_pos) < window
    if kv_valid_len is not None:
        m &= k_pos < kv_valid_len
    return m


def _per_batch(x, device) -> torch.Tensor:
    """A scalar or (B,) offset/length as a (B?, 1, 1) int32 tensor."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1, 1, 1)


def naive_attention(q, k, v, p: AttnParams, q_offset=0, kv_valid_len=None):
    """q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D), float32 scores.

    ``q_offset`` / ``kv_valid_len``: scalar or per-batch (B,) — continuous
    batching serves requests at different positions in one step."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = p.scale if p.scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * scale, k.float())
    s = common.softcap(s, p.softcap)
    q_pos = (_per_batch(q_offset, q.device)
             + torch.arange(sq, dtype=torch.int32, device=q.device)[None, :, None])
    k_pos = torch.arange(skv, dtype=torch.int32, device=q.device)[None, None, :]
    kvl = None if kv_valid_len is None else _per_batch(kv_valid_len, q.device)
    m = _mask(q_pos, k_pos, p.causal, p.window, kvl)
    s = torch.where(m[:, None, None], s, NEG_INF)          # (B?,hkv,g,sq,skv)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def paged_gather_attention(q, k_pages, v_pages, page_table, p: AttnParams,
                           q_offset, kv_valid_len, k_scale=None, v_scale=None):
    """Chunked-prefill (extend) attention over a paged KV cache.

    q: (B, C, Hq, D) — a prompt chunk at absolute offset ``q_offset``;
    k/v_pages: (P, page, Hkv, D); page_table: (B, N).  The table is
    dereferenced with a dense gather: logical page j of row b covers
    absolute positions ``[j*page, (j+1)*page)``, so the gathered view is
    position-exact and the causal mask + ``kv_valid_len`` apply unchanged.
    ``k_scale``/``v_scale`` (P, page) dequantize int8 pages per token."""
    b, n = page_table.shape
    page = k_pages.shape[1]
    tbl = page_table.long()
    kd = k_pages[tbl]                                  # (B, N, page, Hkv, D)
    vd = v_pages[tbl]
    if k_scale is not None:
        kd = kd.float() * k_scale[tbl][..., None, None]
        vd = vd.float() * v_scale[tbl][..., None, None]
    kd = kd.reshape(b, n * page, *k_pages.shape[2:])
    vd = vd.reshape(b, n * page, *v_pages.shape[2:])
    return naive_attention(q, kd.to(q.dtype), vd.to(q.dtype), p,
                           q_offset=q_offset, kv_valid_len=kv_valid_len)
