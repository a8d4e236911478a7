"""Plain PyTorch versions of the kernels: the CPU path, and what the CUDA
kernels are held against on the card.  Twins of the oracles in
``repro.kernels.ref``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, valid_len, *, softcap=None, scale=None):
    """q: (B,Hq,D); k/v: (B,T,Hkv,D); valid_len (B,) -> (B,Hq,D)."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d).float() * scale
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (torch.arange(t, device=q.device)[None, :]
            < valid_len.to(q.device)[:, None])                 # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return o.reshape(b, hq, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, valid_len, *, scale=None,
                    softcap=None, window=None, k_scale=None, v_scale=None):
    """Gather pages into contiguous caches, then masked softmax in float32.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); page_table: (B, N) int32;
    valid_len: (B,) int32 -> (B, Hq, D) in q's dtype.  ``window`` switches
    to ring-table semantics (slot ``j`` holds logical page
    ``cur_L - ((cur_L - j) mod N)``); ``k_scale``/``v_scale`` (P, page)
    dequantize int8 pages per token.  A fully masked row contributes
    exactly 0 (the output is 0, not a uniform average of garbage)."""
    page, hkv, d = k_pages.shape[1:]
    b, n = page_table.shape
    hq = q.shape[1]
    g = hq // hkv
    tbl = page_table.long()
    vl = valid_len.to(torch.int64)
    k = k_pages[tbl].float()                           # (B, N, page, Hkv, D)
    v = v_pages[tbl].float()
    if k_scale is not None:
        k = k * k_scale[tbl][..., None, None]
        v = v * v_scale[tbl][..., None, None]
    j = torch.arange(n, dtype=torch.int64, device=q.device)[None, :]
    if window is None:
        base = (j * page).expand(b, n)
    else:
        cur = torch.clamp(vl - 1, min=0)[:, None] // page         # (B, 1)
        base = (cur - torch.remainder(cur - j, n)) * page
    pos = base[:, :, None] + torch.arange(page, device=q.device)[None, None, :]
    mask = (pos < vl[:, None, None]) & (pos >= 0)
    if window is not None:
        mask &= pos > vl[:, None, None] - 1 - window
    k = k.reshape(b, n * page, hkv, d)
    v = v.reshape(b, n * page, hkv, d)
    mask = mask.reshape(b, n * page)
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d).float() * scale
    s = torch.einsum("bhgd,bthd->bhgt", qg, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.where(mask[:, None, None, :], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bhgt,bthd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)
