"""Plain PyTorch versions of the kernels: the CPU path, and what the CUDA
kernels are held against on the card.  Twins of the oracles in
``repro.kernels.ref``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# the memory engines (K4-K7)
# ---------------------------------------------------------------------------

def stream_copy(x, mode="copy"):
    """The plain version of ``stream_copy``: a copy of x, or ``x * 2``
    (``mode="rw"``; int8 wraps modulo 256).  Tiles do not change it."""
    return x.clone() if mode == "copy" else x * 2


def strided_copy(x, *, block_rows, stride):
    """Output block-row i is input block-row ``(i * stride) mod nblocks``,
    ``block_rows`` rows to a block; blocks repeat when the stride is not
    coprime with nblocks."""
    rows, cols = x.shape
    br = min(block_rows, rows)
    nblocks = rows // br
    src = (torch.arange(nblocks, dtype=torch.int64, device=x.device)
           * stride) % nblocks
    return x.reshape(nblocks, br, cols)[src].reshape(rows, cols)


def random_gather(x, idx, *, block_rows=1):
    """out's i-th unit of ``block_rows`` rows is x's ``idx[i]``-th unit."""
    rows, cols = x.shape
    units = x.reshape(rows // block_rows, block_rows * cols)
    return units[idx.long()].reshape(idx.shape[0] * block_rows, cols)


def pointer_chase(table, steps):
    """``addr = table[addr]`` from 0 for ``steps`` hops: (n, 1) -> the
    (steps, 1) trace; (C, n, 1), C chains walked together -> (C, steps,
    1)."""
    flat = table[..., 0]
    if flat.dim() == 1:
        return pointer_chase(table[None], steps)[0]
    rows = torch.arange(flat.shape[0], device=table.device)
    addr = torch.zeros(flat.shape[0], dtype=torch.int64, device=table.device)
    trace = torch.empty((flat.shape[0], steps), dtype=torch.int32,
                        device=table.device)
    for i in range(steps):
        nxt = flat[rows, addr]
        trace[:, i] = nxt
        addr = nxt.long()
    return trace[..., None]


def matmul(x, y):
    """(M, K) @ (K, N) in float32, output in x's dtype.  On a card, TF32
    must be off (``torch.backends.cuda.matmul.allow_tf32 = False``) for
    this to be a float32 product."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    """The plain version of the ``flash_attention`` kernel, with the
    kernel's semantics.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D) in q's dtype; query head h reads kv head h // (Hq/Hkv).

    The causal mask is aligned top-left (query i sees keys <= i, as the
    Pallas kernel's ``q_pos = i``; ``repro.kernels.ref.attention`` aligns
    it bottom-right instead, so the two agree only when Sq == Skv).  The
    window keeps keys with ``q_pos - k_pos < window``.  A row that sees no
    key is exactly 0."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float() * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention(q, k, v, valid_len, *, softcap=None, scale=None):
    """q: (B,Hq,D); k/v: (B,T,Hkv,D); valid_len (B,) -> (B,Hq,D).

    Line for line the reference's oracle: a row with ``valid_len == 0``
    sees no key and gets the mean of V (the CUDA kernel returns 0 there;
    such rows are checked on their own, never against this)."""
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
