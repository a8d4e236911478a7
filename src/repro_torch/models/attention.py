"""GQA/MQA attention with interchangeable inner loops, as in
``repro.models.attention``:

- ``naive``   — materialized scores in float32; decode (Sq = 1) always
                takes it, and chunked prefill over a paged cache gathers
                the pages and calls it (:func:`paged_gather_attention`);
- ``chunked`` — blockwise online softmax (the paper's `nest` blocking) in
                plain PyTorch, with the reference's blockwise backward
                (:class:`_Flash`, an autograd function: training's
                attention);
- ``unrolled`` — the same blocks with the wholly masked ones skipped, the
                inner loop in a ``flash_inner`` scope: the dry-run's
                roofline mode;
- ``pallas``  — the ``flash_attention`` kernel (K2): CUDA on the card, its
                plain version on the CPU (:mod:`repro_torch.kernels.ops`).

Causal masks, sliding windows, softcap, GQA grouping and absolute
position offsets, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.roofline import FLASH_INNER, named_scope
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.tune.cache import plan_for
from repro_torch.tune.plan import dtype_name

NEG_INF = -1e30


class AttnParams(NamedTuple):
    impl: str = "chunked"          # naive | chunked | unrolled | pallas
    causal: bool = True
    window: Optional[int] = None
    softcap: Optional[float] = None
    scale: Optional[float] = None
    # None = derive from the tuned KernelPlan for this call's shape and
    # dtype (repro_torch.tune, the closed tune->execute loop); ints pin the
    # blocks.  Blocks change rounding, never the math.
    bq: Optional[int] = None
    bkv: Optional[int] = None


def resolve_blocks(p: AttnParams, q, k) -> tuple:
    """(bq, bkv) for ``chunked``: explicit AttnParams win; ``None`` falls
    back to the cached :class:`repro_torch.tune.KernelPlan` for
    ``(Sq, Skv, D, dtype)`` — the autotuner's choice applied as the
    default."""
    if p.bq is not None and p.bkv is not None:
        return p.bq, p.bkv
    plan = plan_for("flash_attention",
                    shape_sig=(q.shape[1], k.shape[1], q.shape[-1]),
                    dtype=dtype_name(q.dtype))
    return (p.bq if p.bq is not None else plan.bq,
            p.bkv if p.bkv is not None else plan.bkv)


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


def naive_attention(q, k, v, p: AttnParams, q_offset=0, kv_valid_len=None,
                    k_positions=None):
    """q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D), float32 scores.

    ``q_offset`` / ``kv_valid_len``: scalar or per-batch (B,) — continuous
    batching serves requests at different positions in one step.
    ``k_positions``: explicit kv positions (B, Skv) for ring-buffer caches
    (negative = an empty row)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = p.scale if p.scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * scale, k.float())
    s = common.softcap(s, p.softcap)
    q_pos = (_per_batch(q_offset, q.device)
             + torch.arange(sq, dtype=torch.int32, device=q.device)[None, :, None])
    if k_positions is None:
        k_pos = torch.arange(skv, dtype=torch.int32,
                             device=q.device)[None, None, :]
    else:
        k_pos = torch.as_tensor(k_positions, dtype=torch.int32,
                                device=q.device)[:, None, :]   # (B, 1, skv)
    kvl = None if kv_valid_len is None else _per_batch(kv_valid_len, q.device)
    m = _mask(q_pos, k_pos, p.causal, p.window, kvl)
    if k_positions is not None:
        m &= k_pos >= 0
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


# ---------------------------------------------------------------------------
# tensor-parallel paged dispatches
# ---------------------------------------------------------------------------
# The serve-side TP split (the paper's multi-bank axis): attention heads
# and the KV page pools split over one mesh axis in contiguous blocks,
# page tables, valid lengths and int8 scale lanes replicate, and each shard
# walks its own stripe of the pools with its own kernel call.  With tp
# dividing both Hq and Hkv, every query group stays on the shard of its kv
# head (the group size is shard-invariant).  Arguments and results are
# per-shard lists, shard s on its own device; the results concatenated on
# the head axis in shard order are the single-device call's, and they stay
# split here because the row-parallel o-projection consumes each shard's
# heads where they are.  Whether a stack may split at all is checked once,
# for the whole stack (:func:`repro_torch.dist.serve.check_tp`), where the
# reference's ``tp_shardable`` chose per call between these and GSPMD.

def tp_paged_attention(q, k_pages, v_pages, page_table, valid_len, *,
                       scale=None, softcap=None, window=None, k_scale=None,
                       v_scale=None):
    """Decode over the split pools: one ``paged_attention`` (K1) call per
    shard, on its head block q[s] (B, Hq/tp, D) and its pool stripe
    (P, page, Hkv/tp, D) with its copy of the table, the valid lengths
    and the scale lanes.  Returns the per-shard outputs."""
    return [kops.paged_attention(
        q[s], k_pages[s], v_pages[s], page_table[s], valid_len[s],
        scale=scale, softcap=softcap, window=window,
        k_scale=None if k_scale is None else k_scale[s],
        v_scale=None if v_scale is None else v_scale[s])
        for s in range(len(q))]


def tp_paged_gather_attention(q, k_pages, v_pages, page_table,
                              p: AttnParams, q_offset, kv_valid_len,
                              k_scale=None, v_scale=None):
    """Extend and verify over the split pools: each shard gathers its own
    stripe through its copy of the table and attends its head block
    q[s] (B, C, Hq/tp, D), so a prefill chunk never moves another shard's
    pages.  Returns the per-shard outputs."""
    return [paged_gather_attention(
        q[s], k_pages[s], v_pages[s], page_table[s], p,
        q_offset=q_offset[s], kv_valid_len=kv_valid_len[s],
        k_scale=None if k_scale is None else k_scale[s],
        v_scale=None if v_scale is None else v_scale[s])
        for s in range(len(q))]


def _padded(q, k, v, p: AttnParams, q_offset, kv_valid_len):
    """(q, k, v padded to whole blocks, their :class:`_FlashMeta`), the
    reference's blocking: blocks no longer than the sequences, padded kv
    rows masked through ``kv_valid_len``."""
    orig_sq, orig_skv = q.shape[1], k.shape[1]
    bq, bkv = resolve_blocks(p, q, k)
    bq, bkv = min(bq, orig_sq), min(bkv, orig_skv)
    pad_q, pad_kv = (-orig_sq) % bq, (-orig_skv) % bkv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        if kv_valid_len is None:
            kv_valid_len = orig_skv
    meta = _FlashMeta(
        causal=p.causal, window=p.window, softcap=p.softcap,
        scale=p.scale if p.scale is not None else q.shape[-1] ** -0.5,
        bq=bq, bkv=bkv, q_offset=int(q_offset),
        kv_valid_len=None if kv_valid_len is None else int(kv_valid_len))
    return q, k, v, meta


def chunked_attention(q, k, v, p: AttnParams, q_offset=0, kv_valid_len=None):
    """Online-softmax double loop over (bq, bkv) blocks with the
    reference's flash-style backward (:class:`_Flash`): the backward
    recomputes each score block from (q, k, v, out, lse) instead of
    keeping every block's accumulators.  q: (B,Sq,Hq,D); k/v:
    (B,Skv,Hkv,D) -> (B,Sq,Hq,D).  ``q_offset``/``kv_valid_len`` are
    scalars.  Non-divisible lengths are padded and masked; every kv block
    is visited, as in the reference (a block masked for a whole row adds
    p = 1 terms that the row's first live block wipes with alpha = 0)."""
    orig_sq = q.shape[1]
    q, k, v, meta = _padded(q, k, v, p, q_offset, kv_valid_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(meta, q, k, v)[:, :orig_sq]
    # serving: the forward alone, with no lse for a backward
    return _flash_fwd_impl(meta, q, k, v, with_lse=False)[0][:, :orig_sq]


def unrolled_attention(q, k, v, p: AttnParams, q_offset=0,
                       kv_valid_len=None):
    """The roofline mode's attention: ``chunked``'s blocks and math, but
    a block wholly in the future, wholly out of the window or wholly past
    ``kv_valid_len`` is skipped, as a production kernel's grid skips it,
    so a traced step counts only the blocks computed.  Each block's work
    runs in a ``flash_inner`` :func:`~repro_torch.core.roofline.
    named_scope`, whose bytes the accounting counts apart.  Autograd
    differentiates the loop op by op (the reference has no custom VJP
    here).  Rows come back in q's dtype."""
    orig_sq = q.shape[1]
    q, k, v, meta = _padded(q, k, v, p, q_offset, kv_valid_len)
    qb, kb, vb, (b, sq, hq, d, skv, hkv, g, nq, nkv) = _blocks(meta, q, k, v)
    bq, bkv, dev = meta.bq, meta.bkv, q.device
    outs = []
    for i in range(nq):
        q_lo = meta.q_offset + i * bq
        q_hi = q_lo + bq - 1
        m = torch.full((b, bq, hkv, g), NEG_INF, device=dev)
        l = torch.zeros((b, bq, hkv, g), device=dev)
        acc = torch.zeros((b, bq, hkv, g, d), device=dev)
        q_pos = _q_pos(meta, i, dev)
        for j in range(nkv):
            k_lo, k_hi = j * bkv, (j + 1) * bkv - 1
            if meta.causal and k_lo > q_hi:
                continue                   # wholly in the future
            if meta.window is not None and q_lo - k_hi >= meta.window:
                continue                   # wholly out of the window
            if meta.kv_valid_len is not None and k_lo >= meta.kv_valid_len:
                continue                   # wholly past the valid rows
            with named_scope(FLASH_INNER):
                s_c, _, msk = _block_scores(meta, qb[:, i], kb[:, j], q_pos,
                                            j)
                s_c = torch.where(msk, s_c, NEG_INF)
                m_n = torch.maximum(m, s_c.amax(dim=-1))
                pr = torch.exp(s_c - m_n[..., None])
                alpha = torch.exp(m - m_n)
                l = l * alpha + pr.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bqhgk,bkhd->bqhgd", pr, vb[:, j])
                m = m_n
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(b, sq, hq, d)
    return out[:, :orig_sq].to(q.dtype)


class _FlashMeta(NamedTuple):
    causal: bool
    window: Optional[int]
    softcap: Optional[float]
    scale: float
    bq: int
    bkv: int
    q_offset: int
    kv_valid_len: Optional[int]


def _blocks(meta: _FlashMeta, q, k, v):
    """float32 blocks: q (B, nq, bq, Hkv, g, D) times the scale, k/v
    (B, nkv, bkv, Hkv, D), and the shape numbers."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nq, nkv = sq // meta.bq, skv // meta.bkv
    qb = q.reshape(b, nq, meta.bq, hkv, g, d).float() * meta.scale
    kb = k.reshape(b, nkv, meta.bkv, hkv, d).float()
    vb = v.reshape(b, nkv, meta.bkv, hkv, d).float()
    return qb, kb, vb, (b, sq, hq, d, skv, hkv, g, nq, nkv)


def _q_pos(meta: _FlashMeta, qi: int, device) -> torch.Tensor:
    """Positions (bq, 1) of q block ``qi``'s rows."""
    return (meta.q_offset + qi * meta.bq
            + torch.arange(meta.bq, device=device)[:, None])


def _block_scores(meta: _FlashMeta, q_blk, k_blk, q_pos, kj: int,
                  with_dsoft: bool = False):
    """(softcapped scores, the softcap's derivative when ``with_dsoft``
    and a softcap is set, else None, mask) of the block of q rows at
    ``q_pos`` and kv block ``kj``; the mask broadcasts over (B, bq, Hkv,
    g, bkv)."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", q_blk, k_blk)
    s_c, dsoft = common.softcap(s, meta.softcap), None
    if with_dsoft and meta.softcap is not None:
        dsoft = 1.0 - torch.square(s_c / meta.softcap)
    k_pos = kj * meta.bkv + torch.arange(meta.bkv, device=s.device)[None, :]
    msk = _mask(q_pos, k_pos, meta.causal, meta.window, meta.kv_valid_len)
    return s_c, dsoft, msk[None, :, None, None, :]


def _flash_fwd_impl(meta: _FlashMeta, q, k, v, with_lse: bool = True):
    """(out (B, Sq, Hq, D) in q's dtype, lse (nq, B, bq, Hkv, g) float32,
    or None unless ``with_lse``); a row with no live key gets lse +1e30,
    so that the backward's recomputed p underflows to exactly 0 there."""
    qb, kb, vb, (b, sq, hq, d, skv, hkv, g, nq, nkv) = _blocks(meta, q, k, v)
    dev = q.device
    outs, lses = [], []
    for i in range(nq):
        m = torch.full((b, meta.bq, hkv, g), NEG_INF, device=dev)
        l = torch.zeros((b, meta.bq, hkv, g), device=dev)
        acc = torch.zeros((b, meta.bq, hkv, g, d), device=dev)
        q_pos = _q_pos(meta, i, dev)
        for j in range(nkv):
            s_c, _, msk = _block_scores(meta, qb[:, i], kb[:, j], q_pos, j)
            s_c = torch.where(msk, s_c, NEG_INF)
            m_n = torch.maximum(m, s_c.amax(dim=-1))
            pr = torch.exp(s_c - m_n[..., None])
            alpha = torch.exp(m - m_n)
            l = l * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", pr, vb[:, j])
            m = m_n
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
        if with_lse:
            lses.append(torch.where(
                l > 0, m + torch.log(torch.clamp(l, min=1e-30)), 1e30))
    out = torch.stack(outs, dim=1).reshape(b, sq, hq, d).to(q.dtype)
    return out, torch.stack(lses) if with_lse else None


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward
    :func:`_flash_fwd_impl`, backward the blockwise recomputation
    (``D_i = rowsum(dO * O)``, ``ds = p (dp - D_i)`` times ``1 -
    (s_c/cap)^2`` under a softcap, dq taken on ``q * scale`` and scaled
    at the end, dk/dv summed per kv block in q-block order)."""

    @staticmethod
    def forward(ctx, meta, q, k, v):
        out, lse = _flash_fwd_impl(meta, q, k, v)
        ctx.meta = meta
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        meta = ctx.meta
        q, k, v, out, lse = ctx.saved_tensors
        qb, kb, vb, (b, sq, hq, d, skv, hkv, g, nq, nkv) = _blocks(
            meta, q, k, v)
        dob = dout.reshape(b, nq, meta.bq, hkv, g, d).float()
        outb = out.reshape(b, nq, meta.bq, hkv, g, d).float()
        db = torch.sum(dob * outb, dim=-1)            # (B, nq, bq, Hkv, g)
        dk = [torch.zeros((b, meta.bkv, hkv, d), device=q.device)
              for _ in range(nkv)]
        dv = [torch.zeros_like(x) for x in dk]
        dqs = []
        for i in range(nq):
            q_blk, do_blk, d_blk = qb[:, i], dob[:, i], db[:, i]
            dq_i = torch.zeros((b, meta.bq, hkv, g, d), device=q.device)
            q_pos = _q_pos(meta, i, q.device)
            for j in range(nkv):
                s_c, dsoft, msk = _block_scores(meta, q_blk, kb[:, j], q_pos,
                                                j, with_dsoft=True)
                pr = torch.where(msk, torch.exp(s_c - lse[i][..., None]), 0.0)
                dv_j = torch.einsum("bqhgk,bqhgd->bkhd", pr, do_blk)
                dp = torch.einsum("bqhgd,bkhd->bqhgk", do_blk, vb[:, j])
                ds = pr * (dp - d_blk[..., None])
                if dsoft is not None:
                    ds = ds * dsoft
                dq_i = dq_i + torch.einsum("bqhgk,bkhd->bqhgd", ds, kb[:, j])
                dk[j] = dk[j] + torch.einsum("bqhgk,bqhgd->bkhd", ds, q_blk)
                dv[j] = dv[j] + dv_j
            dqs.append(dq_i)
        dq = (torch.stack(dqs, dim=1).reshape(b, sq, hq, d)
              * meta.scale).to(q.dtype)
        return (None, dq, torch.stack(dk, dim=1).reshape(b, skv, hkv, d
                                                         ).to(k.dtype),
                torch.stack(dv, dim=1).reshape(b, skv, hkv, d).to(v.dtype))


def pallas_attention(q, k, v, p: AttnParams, q_offset=0, kv_valid_len=None):
    """Full-sequence prefill through the ``flash_attention`` kernel (K2),
    whose causal mask is aligned top-left: no offset, no valid length."""
    if not (isinstance(q_offset, int) and q_offset == 0
            and kv_valid_len is None):
        raise ValueError("the pallas path serves full-block prefill "
                         "(q_offset 0, no kv_valid_len); decode uses naive")
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=p.causal,
                             window=p.window, softcap=p.softcap,
                             scale=p.scale)
    return o.transpose(1, 2)


IMPLS = {
    "naive": naive_attention,
    "chunked": chunked_attention,
    "unrolled": unrolled_attention,
    "pallas": pallas_attention,
}


def attention(q, k, v, p: AttnParams, q_offset=0, kv_valid_len=None):
    if q.shape[1] == 1:  # decode: one query, naive
        return naive_attention(q, k, v, p, q_offset, kv_valid_len)
    return IMPLS[p.impl](q, k, v, p, q_offset, kv_valid_len)
