"""Decoder-only LM: attention (full and sliding-window), RG-LRU and SSD
mixers, with a dense MLP, a mixture of experts or none, on a dense or a
paged KV cache.

The port of ``repro.models.transformer`` for these stacks, five modes:

- ``train`` (:func:`train_loss`): the whole sequence with autograd, no
  cache; each pattern block under ``flags.remat`` (``torch.utils.
  checkpoint``), the loss over sequence chunks (:func:`chunked_ce`),
  the MoE layers' load-balance loss added with ``aux_loss_weight``;
  serving's entry points stay under ``torch.no_grad()``;

- ``prefill`` (:func:`prefill`): a whole (right-padded) prompt; attention
  through ``flags.attn_impl`` (``pallas`` runs the ``flash_attention``
  kernel, K2); returns a dense cache of the prompt's k/v (a windowed layer
  keeps its last ``window`` rows and their positions);
- ``decode`` (:func:`decode_step`): one token per slot written into the
  dense ``(B, max_len)`` cache at its own position (a windowed layer's
  ring buffer of ``min(window, max_len)`` rows at ``pos % rows``, with a
  ``kpos`` lane of positions, ``-10**9`` for an empty row), then naive
  attention over the cache;
- ``paged_extend`` (:func:`paged_prefill_chunk`): a prompt chunk writes its
  k/v through the page table, then attends over the gathered pages with
  :func:`~repro_torch.models.attention.paged_gather_attention`; a windowed
  layer attends over its ring's gathered pages *before* it writes;
  :func:`paged_verify` runs the same mode over a speculative burst and
  returns logits at every position;
- ``paged_decode`` (:func:`paged_decode_step`): one token per slot writes
  through the table, then every attention layer runs the
  ``paged_attention`` kernel (K1, :mod:`repro_torch.kernels.ops`) with the
  softcap, the scale and, on windowed layers, the window over a ring
  table.

A modality frontend's precomputed patch embeddings (``patch_embeds``,
(B, P, d)) are cast to the activation dtype and prepended to the token
embeddings in prefill, so positions run over ``P + S`` (such stacks are
served from the dense cache, as in the reference).  MoE layers
(:mod:`~repro_torch.models.moe`) dispatch by ``flags.moe_impl`` with the
config's capacity factor; serving discards their load-balance loss,
training adds it.

Recurrent mixers (:mod:`~repro_torch.models.rglru`,
:mod:`~repro_torch.models.ssm`) keep dense per-slot state (``h``/``state``
float32, ``conv`` the trailing conv inputs) beside the page pools: prefill
returns it, decode advances it (``paged_decode`` keeps the rows of
inactive slots, so a pending prefill's partial state survives the masked
ticks between its chunks), and a paged prefill chunk continues the
``slot``'s row, restarting it from zeros at offset 0.

``kv_dtype="int8"`` stores k/v as int8 with a float32 scale per token
(:func:`_kv_quant`): dense caches in ``k_scale``/``v_scale`` (B, T) lanes,
page pools in (P, page) lanes that K1 dequantizes.  Attention over the
chunk being written uses the quantize -> dequantize round trip, so one-shot
and chunked prefill agree with what decode reads back.

Parameters keep the reference's layout: per-pattern-position weights
stacked on a leading LAYERS axis (``blocks.p{j}``), remainder layers
unstacked (``rem.r{j}``); the layer loop is a Python loop over that axis.

With ``flags.mesh`` wider than one device along ``flags.tp_axis``
(:meth:`repro_torch.dist.serve.ServeMesh.bind`) every entry point runs
tensor-parallel (:func:`_forward_tp`): params and caches are lists of
per-shard trees (:meth:`~repro_torch.dist.serve.ServeMesh.shard_params`,
``shard_paged_cache``), the residual stream and the norms stay on the
first shard, q/k/v and the MLP's gate/up are column-parallel, the
o-projection and the MLP's down row-parallel (partials summed in shard
order), the embedding and the head split on vocab (logits come back as
the shards' vocab slices), and each shard's attention reads its own
stripe of the pools; a MoE layer runs each shard's experts
(:func:`~repro_torch.models.moe.apply_tp`) and a recurrent mixer each
shard's slice of its width or heads (:func:`~repro_torch.models.rglru.
forward_tp`, :func:`~repro_torch.models.ssm.forward_tp`), its state kept
whole on every shard.
Caches are updated in place (the reference returns a new cache; here the
decode modes return the same dict, mutated), which keeps the cache's
memory at one copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import (ATTN, DENSE, MOE, NONE, RGLRU, SSD,
                                      LayerSpec, ModelConfig)
from repro_torch.dist import tp
from repro_torch.dist.serve import broadcast, check_tp
from repro_torch.kernels import ops as kops
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttnParams, paged_gather_attention
from repro_torch.models.common import (EMBED, HEADS, KV_HEADS, LAYERS, VOCAB,
                                       ParamBuilder, cross_entropy, nll_sum,
                                       rms_norm, rope, softcap)


@dataclass(frozen=True)
class RuntimeFlags:
    """Execution knobs (never affect math, except ``kv_dtype``'s
    quantization).  ``attn_impl`` picks the attention of full-sequence
    prefill (naive | chunked | pallas); ``attn_bq``/``attn_bkv`` pin
    chunked's blocks (None = the tuned plan's,
    :func:`repro_torch.models.attention.resolve_blocks`); the CUDA kernel
    behind ``pallas`` picks its own tiles.  ``moe_impl`` picks the MoE
    dispatch (dense | sorted).  Training reads ``remat`` (none | full |
    dots: what a pattern block's backward recomputes, :func:`_remat`),
    ``loss_chunk`` (the sequence chunk of :func:`chunked_ce`, 0 = one
    shot) and ``aux_loss_weight`` (the MoE load-balance loss's weight in
    :func:`train_loss`).  ``kv_dtype="int8"`` stores the KV cache as int8
    with a float32 scale per token.  ``mesh`` (a :class:`~repro_torch.launch.
    mesh.Mesh`, set by :meth:`~repro_torch.dist.serve.ServeMesh.bind`)
    with more than one device along ``tp_axis`` runs every entry point
    tensor-parallel over per-shard params and caches.  ``policy`` (a
    :class:`~repro_torch.dist.sharding.ShardingPolicy`, set by the step
    builders of :mod:`repro_torch.dist.steps`) runs training and the
    prefill/decode steps over every device of ``mesh``
    (:mod:`repro_torch.models.sharded`)."""

    attn_impl: str = "chunked"
    attn_bq: Optional[int] = None
    attn_bkv: Optional[int] = None
    moe_impl: str = "sorted"         # dense | sorted
    remat: str = "none"              # none | full | dots
    loss_chunk: int = 512
    aux_loss_weight: float = 0.01
    kv_dtype: str = "native"         # native | int8
    mesh: Any = None
    tp_axis: str = "model"
    policy: Any = None


KV_DTYPES = ("native", "int8")
REMATS = ("none", "full", "dots")
# the recurrent mixers: the reference's param name, module, state type
RECURRENT = {SSD: ("ssd", ssm_mod, ssm_mod.SSDState),
             RGLRU: ("rglru", rglru_mod, rglru_mod.LRUState)}


def check_supported(cfg: ModelConfig,
                    flags: Optional[RuntimeFlags] = None) -> None:
    """Every stack of the registry is served (attention, RG-LRU and SSD
    mixers with a dense MLP, a mixture of experts or none; frontend and
    encoder-decoder stacks on the dense cache); raise on an unknown flag
    or layer kind rather than compute something else."""
    if flags is not None:
        if flags.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {flags.kv_dtype!r}; known: "
                             f"{KV_DTYPES}")
        if flags.attn_impl not in attn_mod.IMPLS:
            raise ValueError(f"unknown attn_impl {flags.attn_impl!r}; known: "
                             f"{sorted(attn_mod.IMPLS)}")
        if flags.moe_impl not in moe_mod.IMPLS:
            raise ValueError(f"unknown moe_impl {flags.moe_impl!r}; known: "
                             f"{moe_mod.IMPLS}")
        if flags.remat not in REMATS:
            raise ValueError(f"unknown remat {flags.remat!r}; known: "
                             f"{REMATS}")
    for spec in tuple(cfg.layer_pattern) + tuple(cfg.remainder_specs):
        if ((spec.mixer != ATTN and spec.mixer not in RECURRENT)
                or spec.mlp not in (DENSE, MOE, NONE)):
            raise ValueError(f"{cfg.name}: unknown layer kind {spec}")


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


SENTINEL = -10 ** 9     # the position of an empty ring row


def _kv_quant(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """(B, S, H, D) -> (int8 values, per-token float32 scale (B, S)):
    the scale is the token's largest magnitude over 127 (at least
    1e-6 / 127), values rounded half to even and clipped to +-127.
    ``amax`` (B, S) overrides the largest magnitude: under TP a shard holds
    some of the heads, and the token's amax spans all of them."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=(2, 3))
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, :, None, None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[:, :, None, None]).to(dtype)


def _kv_store_dtype(cfg: ModelConfig, kv_dtype: str) -> torch.dtype:
    return torch.int8 if kv_dtype == "int8" else dtype_of(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(b: ParamBuilder, path: str, spec: LayerSpec, cfg: ModelConfig,
                stacked: int):
    lead = (stacked,) if stacked else ()
    la = (LAYERS,) if stacked else ()
    d, hd = cfg.d_model, cfg.resolved_head_dim
    b.zeros(f"{path}.ln1", lead + (d,), la + (EMBED,))
    if spec.mixer == ATTN:
        b.dense(f"{path}.attn.wq", lead + (d, cfg.num_heads * hd),
                la + (EMBED, HEADS))
        b.dense(f"{path}.attn.wk", lead + (d, cfg.num_kv_heads * hd),
                la + (EMBED, KV_HEADS))
        b.dense(f"{path}.attn.wv", lead + (d, cfg.num_kv_heads * hd),
                la + (EMBED, KV_HEADS))
        b.dense(f"{path}.attn.wo", lead + (cfg.num_heads * hd, d),
                la + (HEADS, EMBED))
    else:
        name, mod, _ = RECURRENT[spec.mixer]
        mod.init(b, f"{path}.{name}", cfg, stacked)
    if spec.mlp == DENSE:
        b.zeros(f"{path}.ln2", lead + (d,), la + (EMBED,))
        mlp_mod.init(b, f"{path}.mlp", d, cfg.d_ff, cfg.activation, stacked)
    elif spec.mlp == MOE:
        b.zeros(f"{path}.ln2", lead + (d,), la + (EMBED,))
        moe_mod.init(b, f"{path}.moe", d, cfg.d_ff, cfg.num_experts,
                     cfg.activation, stacked)


def build_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                 device) -> ParamBuilder:
    """The builder holding the stack's weights and their logical axes."""
    check_supported(cfg)
    b = ParamBuilder(generator, dtype_of(cfg.param_dtype), device)
    b.dense("embed.tok", (cfg.vocab_size, cfg.d_model), (VOCAB, EMBED),
            scale=cfg.d_model ** -0.5)
    nb = cfg.num_pattern_blocks
    for j, spec in enumerate(cfg.layer_pattern):
        _init_layer(b, f"blocks.p{j}", spec, cfg, nb)
    for j, spec in enumerate(cfg.remainder_specs):
        _init_layer(b, f"rem.r{j}", spec, cfg, 0)
    b.zeros("final_norm", (cfg.d_model,), (EMBED,))
    if not cfg.tie_embeddings:
        b.dense("lm_head", (cfg.d_model, cfg.vocab_size), (EMBED, VOCAB))
    return b


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device) -> dict:
    """Fresh weights drawn from ``generator`` (on ``device``); with
    ``device="meta"`` only the paths and shapes."""
    return build_params(cfg, generator, device).params


def _stacked(cfg: ModelConfig, make) -> dict:
    """A cache tree: ``make(spec, lead)`` for every pattern position (lead
    = (LAYERS,)) and every remainder layer (lead = ())."""
    nb = cfg.num_pattern_blocks
    return dict(blocks={f"p{j}": make(spec, (nb,))
                        for j, spec in enumerate(cfg.layer_pattern)},
                rem={f"r{j}": make(spec, ())
                     for j, spec in enumerate(cfg.remainder_specs)})


def _recurrent_state(cfg: ModelConfig, spec: LayerSpec, batch: int, device,
                     lead) -> dict:
    """A recurrent layer's dense per-slot state leaves, zeros."""
    _, mod, _ = RECURRENT[spec.mixer]
    return mod.init_state(cfg, batch, dtype_of(cfg.compute_dtype), device,
                          lead)._asdict()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               kv_dtype: str = "native") -> dict:
    """Dense decode cache, stacked on LAYERS like the params: per attention
    layer ``k``/``v`` of shape (batch, T, Hkv, D) with T = max_len, or
    ``min(window, max_len)`` ring rows and a ``kpos`` (batch, T) int32
    lane (``-10**9`` = empty) for a windowed layer; int8 adds float32
    ``k_scale``/``v_scale`` (batch, T) lanes.  A recurrent layer holds its
    state leaves (batch, ...)."""
    check_supported(cfg)
    kvd = _kv_store_dtype(cfg, kv_dtype)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def make(spec: LayerSpec, lead):
        if spec.mixer != ATTN:
            return _recurrent_state(cfg, spec, batch, device, lead)
        t = (min(spec.sliding_window, max_len)
             if spec.sliding_window is not None else max_len)
        c = {n: torch.zeros(lead + (batch, t, hkv, hd), dtype=kvd,
                            device=device) for n in ("k", "v")}
        if spec.sliding_window is not None:
            c["kpos"] = torch.full(lead + (batch, t), SENTINEL,
                                   dtype=torch.int32, device=device)
        if kv_dtype == "int8":
            for n in ("k_scale", "v_scale"):
                c[n] = torch.zeros(lead + (batch, t), dtype=torch.float32,
                                   device=device)
        return c

    return _stacked(cfg, make)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device, ring_pages: int = 0,
                     kv_dtype: str = "native", batch: int = 1) -> dict:
    """Per-layer page pools ``k_pages``/``v_pages`` of shape
    (P, page, Hkv, D), stacked on LAYERS like the params.  Full-attention
    layers share the ``num_pages`` pool's ids, windowed layers the
    ``ring_pages`` pool's (default: ``num_pages``): one host-side allocator
    and table for each kind.  int8 adds float32 ``k_scale``/``v_scale``
    (P, page) lanes.  Recurrent layers keep dense (batch, ...) state rows
    beside the pools."""
    check_supported(cfg)
    kvd = _kv_store_dtype(cfg, kv_dtype)
    ring_pages = ring_pages or num_pages
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def make(spec: LayerSpec, lead):
        if spec.mixer != ATTN:
            return _recurrent_state(cfg, spec, batch, device, lead)
        p = ring_pages if spec.sliding_window is not None else num_pages
        c = {n: torch.zeros(lead + (p, page_size, hkv, hd), dtype=kvd,
                            device=device) for n in ("k_pages", "v_pages")}
        if kv_dtype == "int8":
            for n in ("k_scale", "v_scale"):
                c[n] = torch.zeros(lead + (p, page_size),
                                   dtype=torch.float32, device=device)
        return c

    return _stacked(cfg, make)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig, spec: LayerSpec,
                 flags: RuntimeFlags) -> AttnParams:
    scale = (cfg.query_pre_attn_scalar ** -0.5
             if cfg.query_pre_attn_scalar is not None
             else cfg.resolved_head_dim ** -0.5)
    return AttnParams(impl=flags.attn_impl, causal=True,
                      window=spec.sliding_window,
                      softcap=cfg.attn_logit_softcap, scale=scale,
                      bq=flags.attn_bq, bkv=flags.attn_bkv)


def _ring_gather(cache, tbl, off, page, dtype):
    """A ring table's live tokens as a contiguous view: (k, v, positions)
    with k/v (B, R*page, Hkv, D) and positions (B, R*page) int32
    (``-10**9`` = a dead row).  Ring slot j holds logical page
    ``cur - ((cur - j) mod R)``, ``cur`` the logical page of the last
    token already written (``off - 1``); stale rows of rotated-out pages
    map to positions >= off and are masked."""
    b, r = tbl.shape
    t = tbl.long()
    kg = cache["k_pages"][t]                          # (B, R, page, Hkv, D)
    vg = cache["v_pages"][t]
    if "k_scale" in cache:
        kg = kg.float() * cache["k_scale"][t][..., None, None]
        vg = vg.float() * cache["v_scale"][t][..., None, None]
    dev = tbl.device
    cur = torch.clamp(off - 1, min=0)[:, None] // page          # (B, 1)
    j = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
    base = (cur - torch.remainder(cur - j, r)) * page           # (B, R)
    kpos = (base[:, :, None]
            + torch.arange(page, dtype=torch.int32, device=dev)[None, None])
    ok = (kpos < off[:, None, None]) & (kpos >= 0)
    kpos = torch.where(ok, kpos, SENTINEL).reshape(b, r * page)
    kg = kg.reshape(b, r * page, *kg.shape[3:]).to(dtype)
    vg = vg.reshape(b, r * page, *vg.shape[3:]).to(dtype)
    return kg, vg, kpos


def _positions(mode: str, pos, bsz: int, s: int, dev):
    """(per-slot offsets (B,) int32, or None in prefill and training;
    every query's absolute position (B, S) int32)."""
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    if mode in ("prefill", "train"):
        return None, steps[None].expand(bsz, s)
    posv = torch.as_tensor(pos, dtype=torch.int32, device=dev
                           ).reshape(-1).expand(bsz)
    return posv, posv[:, None] + steps[None, :]


def _quantize(k, v, flags: RuntimeFlags, amax=(None, None)):
    """(kq, k scale, vq, v scale) of int8 KV, else None."""
    if flags.kv_dtype != "int8":
        return None
    return _kv_quant(k, amax[0]) + _kv_quant(v, amax[1])


class _Shard(NamedTuple):
    """One shard's operands of an attention layer (a single device is one
    shard): roped q and k, v, their int8 round trip (``quant``, None on
    native pages), the shard's cache and its copies of the offsets,
    positions, tables and chunk lengths."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    quant: Optional[tuple]
    cache: Optional[dict]
    posv: Optional[torch.Tensor]
    positions: torch.Tensor
    table: Optional[dict]
    chunk_valid: Optional[torch.Tensor]


def _paged_attn(shards, ap: AttnParams, spec: LayerSpec, mode: str,
                flags: RuntimeFlags):
    """The paged-cache mixer body (both paged modes), over a list of
    shards (one off a mesh); returns each shard's output.

    Full-attention layers read ``table["full"]`` (logical page j covers
    absolute positions [j*page, (j+1)*page)); windowed layers read
    ``table["ring"]`` (``ring_slots`` rotating slots, positions recovered
    from the valid length).  Decode (S=1) writes the token through the
    table, then runs the ``paged_attention`` kernel with the softcap, the
    scale, the window and the int8 scale lanes; extend attends over a
    gathered view: ring layers *before* they write, because a chunk that
    crosses a page boundary rotates out the trailing page that its own
    early queries still read.  Positions outside the chunk (bucket
    padding) and ring positions older than the ring can hold are steered
    to page 0, which the engine reserves as a null page, so masked writes
    never touch live data.  Under TP each shard writes and reads its own
    stripe of the pools (:func:`~repro_torch.models.attention.
    tp_paged_attention`, :func:`~repro_torch.models.attention.
    tp_paged_gather_attention`)."""
    ring = spec.sliding_window is not None
    outs, reads = [], []
    for sh in shards:
        q, k, v, cache = sh.q, sh.k, sh.v, sh.cache
        bsz, s = q.shape[:2]
        page = cache["k_pages"].shape[1]
        tbl = sh.table["ring"] if ring else sh.table["full"]
        n = tbl.shape[1]
        dev = q.device
        posv, positions = sh.posv, sh.positions
        if sh.chunk_valid is None:
            valid = torch.full((bsz,), s, dtype=torch.int32, device=dev)
        else:
            valid = sh.chunk_valid.reshape(-1).to(torch.int32).expand(bsz)
        in_chunk = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
                    < valid[:, None])
        writable = in_chunk
        if ring:
            pidx = torch.remainder(positions // page, n).long()
            if s > 1:
                # a chunk wider than the ring would write two logical
                # pages through one slot; only the trailing (R-1) pages of
                # positions can matter to a later query ((R-1)*page >=
                # window), and they cannot alias: older ones go to the
                # null page
                end = (posv + valid)[:, None]
                writable = in_chunk & (positions >= end - (n - 1) * page)
        else:
            pidx = torch.clamp(positions // page, max=n - 1).long()
        rows = torch.arange(bsz, device=dev)[:, None]
        pids = torch.where(writable, tbl.long()[rows, pidx], 0)
        slots = torch.where(writable, (positions % page).long(), 0)
        if sh.quant is not None:
            kq, ks, vq, vs = sh.quant
        else:
            kq, vq = k, v

        o = None
        if mode != "paged_decode" and ring:
            if sh.quant is not None:
                # the chunk attends over what readers will dequantize (the
                # other paths read it back from the pages)
                k = _kv_dequant(kq, ks, q.dtype)
                v = _kv_dequant(vq, vs, q.dtype)
            kg, vg, kpos = _ring_gather(cache, tbl, posv, page, q.dtype)
            cpos = torch.where(in_chunk, positions, SENTINEL)
            o = attn_mod.naive_attention(
                q, torch.cat([kg, k.to(q.dtype)], dim=1),
                torch.cat([vg, v.to(q.dtype)], dim=1), ap, q_offset=posv,
                k_positions=torch.cat([kpos, cpos], dim=1))

        kp, vp = cache["k_pages"], cache["v_pages"]
        kp[pids, slots] = kq.to(kp.dtype)
        vp[pids, slots] = vq.to(vp.dtype)
        k_scale = v_scale = None
        if sh.quant is not None:
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            k_scale[pids, slots] = ks
            v_scale[pids, slots] = vs
        outs.append(o)
        reads.append((q, kp, vp, tbl, posv, valid, k_scale, v_scale))

    if mode != "paged_decode" and ring:
        return outs
    q, kp, vp, tbl, posv, valid, k_scale, v_scale = (list(c)
                                                     for c in zip(*reads))
    if k_scale[0] is None:
        k_scale = v_scale = None
    if mode == "paged_decode":
        kw = dict(scale=ap.scale, softcap=ap.softcap,
                  window=spec.sliding_window)
        if len(shards) > 1:
            outs = attn_mod.tp_paged_attention(
                [x[:, 0] for x in q], kp, vp, tbl,
                [x + 1 for x in posv], k_scale=k_scale, v_scale=v_scale,
                **kw)
        else:
            outs = [kops.paged_attention(
                q[0][:, 0], kp[0], vp[0], tbl[0], posv[0] + 1,
                k_scale=None if k_scale is None else k_scale[0],
                v_scale=None if v_scale is None else v_scale[0], **kw)]
        return [o[:, None] for o in outs]
    ends = [p + vl for p, vl in zip(posv, valid)]
    if len(shards) > 1:
        return attn_mod.tp_paged_gather_attention(
            q, kp, vp, tbl, ap, q_offset=posv,
            kv_valid_len=ends, k_scale=k_scale, v_scale=v_scale)
    return [paged_gather_attention(
        q[0], kp[0], vp[0], tbl[0], ap, q_offset=posv[0],
        kv_valid_len=ends[0],
        k_scale=None if k_scale is None else k_scale[0],
        v_scale=None if v_scale is None else v_scale[0])]


def _dense_attn(q, k, v, quant, cache, ap: AttnParams, spec: LayerSpec,
                posv, mode: str):
    """The dense-cache mixer body, on roped q/k (training's too, which
    attends over the whole sequence and keeps no cache).  Decode writes
    each slot's k/v into its cache row at its own position (a windowed
    layer at ``pos % rows`` of its ring, recording the position in
    ``kpos``), then
    attends over the row; prefill attends over the whole (right-padded)
    sequence through ``ap.impl`` and hands back the request's cache (a
    windowed layer's last ``window`` rows and their positions)."""
    bsz, s = q.shape[:2]
    dev = q.device
    if quant is not None:
        kq, ks, vq, vs = quant
    else:
        kq, vq = k, v
    if mode == "decode":
        rows = torch.arange(bsz, device=dev)
        kc, vc = cache["k"], cache["v"]
        ring = spec.sliding_window is not None
        idx = (torch.remainder(posv, kc.shape[1]) if ring else posv).long()
        kc[rows, idx] = kq[:, 0].to(kc.dtype)
        vc[rows, idx] = vq[:, 0].to(vc.dtype)
        if ring:
            cache["kpos"][rows, idx] = posv
        if quant is not None:
            cache["k_scale"][rows, idx] = ks[:, 0]
            cache["v_scale"][rows, idx] = vs[:, 0]
            kc = _kv_dequant(kc, cache["k_scale"], k.dtype)
            vc = _kv_dequant(vc, cache["v_scale"], v.dtype)
        if ring:
            o = attn_mod.naive_attention(q, kc, vc, ap, q_offset=posv,
                                         k_positions=cache["kpos"])
        else:
            o = attn_mod.naive_attention(q, kc, vc, ap, q_offset=posv,
                                         kv_valid_len=posv + 1)
        return o, cache
    if mode == "train":
        return attn_mod.attention(q, k, v, ap), None
    if quant is not None:
        # prefill attends over the round trip it stores, so its logits
        # agree with decode and with paged chunked prefill
        k = _kv_dequant(kq, ks, q.dtype)
        v = _kv_dequant(vq, vs, q.dtype)
    o = attn_mod.attention(q, k, v, ap)
    if spec.sliding_window is not None:
        w = min(spec.sliding_window, s)
        sl = slice(s - w, None)
        new = dict(kpos=torch.arange(s - w, s, dtype=torch.int32, device=dev
                                     )[None].expand(bsz, w))
    else:
        sl = slice(None)
        new = {}
    if quant is not None:
        new.update(k=kq[:, sl], k_scale=ks[:, sl], v=vq[:, sl],
                   v_scale=vs[:, sl])
    else:
        new.update(k=k[:, sl], v=v[:, sl])
    return o, new


def _qkv(p, h, cfg: ModelConfig, hq: int, hkv: int, mode: str, pos):
    """One shard's projections (``hq``/``hkv`` heads), roped at each
    query's position: (q, k, v, per-slot offsets, positions)."""
    bsz, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ p["wq"]).reshape(bsz, s, hq, hd)
    k = (h @ p["wk"]).reshape(bsz, s, hkv, hd)
    v = (h @ p["wv"]).reshape(bsz, s, hkv, hd)
    posv, positions = _positions(mode, pos, bsz, s, h.device)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v, posv, positions)


def _apply_attn(p, x, cfg: ModelConfig, spec: LayerSpec, flags: RuntimeFlags,
                mode, cache, pos, table, chunk_valid):
    bsz, s, _ = x.shape
    q, k, v, posv, positions = _qkv(p, x, cfg, cfg.num_heads,
                                    cfg.num_kv_heads, mode, pos)
    quant = None if mode == "train" else _quantize(k, v, flags)
    ap = _attn_params(cfg, spec, flags)
    if mode in ("paged_decode", "paged_extend"):
        o = _paged_attn([_Shard(q, k, v, quant, cache, posv, positions,
                                table, chunk_valid)], ap, spec, mode,
                        flags)[0]
    else:
        o, cache = _dense_attn(q, k, v, quant, cache, ap, spec, posv, mode)
    hd = cfg.resolved_head_dim
    return o.reshape(bsz, s, cfg.num_heads * hd) @ p["wo"], cache


def _slot_state(state_type, cache: dict, pos, slot: int):
    """Slot ``slot``'s state row (batch 1) as a paged prefill chunk
    continues it: at offset 0 (a freshly admitted request) from zeros,
    since the slot may hold its previous occupant's state, or what masked
    decode ticks left.  The test is made on the device, so the chunk
    needs no host sync."""
    fresh = pos.reshape(-1)[:1] == 0
    st = {}
    for n, leaf in cache.items():
        row = leaf[slot:slot + 1]
        st[n] = torch.where(fresh.reshape((1,) * row.dim()),
                            torch.zeros_like(row), row)
    return state_type(**st)


def _write_slot(cache: dict, st, slot: int) -> None:
    for n, leaf in st._asdict().items():
        cache[n][slot:slot + 1] = leaf.to(cache[n].dtype)


def _recurrent_chunk(mod, state_type, p, h, cache: dict, cfg: ModelConfig,
                     pos, slot: int):
    """A paged prefill chunk through a recurrent mixer: the chunk (batch 1)
    continues slot ``slot``'s state row (:func:`_slot_state`), which is
    written back in place."""
    mix, st1 = mod.forward(p, h, cfg, return_state=True,
                           state=_slot_state(state_type, cache, pos, slot))
    _write_slot(cache, st1, slot)
    return mix


def _freeze_inactive(new: dict, old: dict, active) -> dict:
    """Keep the state rows of inactive slots.  Attention pages are
    write-idempotent under a frozen position (or steered to the null
    page), a recurrent update is not: a pending prefill's partial state
    must survive the masked decode ticks between its chunks."""
    if active is None:
        return new
    return {n: torch.where(active.reshape((-1,) + (1,) * (v.dim() - 1)),
                           v, old[n]) for n, v in new.items()}


def _apply_recurrent(spec: LayerSpec, p, h, cfg: ModelConfig, mode, cache,
                     pos, slot, active):
    """A recurrent mixer in each mode: decode advances every row of the
    state (``paged_decode`` only the active ones) in place; a paged chunk
    continues ``slot``'s row; prefill returns the prompt's state; training
    keeps none."""
    name, mod, state_type = RECURRENT[spec.mixer]
    p = p[name]
    if mode in ("decode", "paged_decode"):
        mix, new = mod.decode_step(p, h, state_type(**cache), cfg)
        new = new._asdict()
        if mode == "paged_decode":
            new = _freeze_inactive(new, cache, active)
        for n, v in new.items():
            cache[n].copy_(v)
        return mix, cache
    if mode == "paged_extend":
        if slot is None:
            raise ValueError(f"{cfg.name}: a paged prefill chunk through a "
                             "recurrent layer needs the slot it continues")
        return (_recurrent_chunk(mod, state_type, p, h, cache, cfg, pos,
                                 slot), cache)
    if mode == "train":
        return mod.forward(p, h, cfg), None
    mix, st = mod.forward(p, h, cfg, return_state=True)
    return mix, st._asdict()


def _apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, flags: RuntimeFlags,
                 mode, cache, pos, table, chunk_valid, slot=None,
                 active=None, stats=None):
    """Returns (x, the layer's cache: the one given, written in place, the
    prompt's new k/v or state in prefill, None in training; the MoE
    load-balance loss, float32, or None without a MoE).  ``stats`` (a
    list) collects a MoE layer's routing sums
    (:func:`~repro_torch.models.moe.route_stats`), from which a mesh of
    data rows forms the whole batch's load-balance loss."""
    h = rms_norm(x, p["ln1"])
    if spec.mixer == ATTN:
        mix, cache = _apply_attn(p["attn"], h, cfg, spec, flags, mode, cache,
                                 pos, table, chunk_valid)
    else:
        mix, cache = _apply_recurrent(spec, p, h, cfg, mode, cache, pos,
                                      slot, active)
    x = x + mix
    aux = None
    if spec.mlp == DENSE:
        h = rms_norm(x, p["ln2"])
        x = x + mlp_mod.apply(p["mlp"], h, cfg.activation)
    elif spec.mlp == MOE:
        h = rms_norm(x, p["ln2"])
        out, aux = moe_mod.apply(p["moe"], h, cfg.num_experts_per_tok,
                                 cfg.activation, impl=flags.moe_impl,
                                 capacity_factor=cfg.moe_capacity_factor)
        if stats is not None:
            stats.append(moe_mod.route_stats(p["moe"], h,
                                             cfg.num_experts_per_tok))
        x = x + out
    return x, cache, aux


def _pick(tree, i):
    return {k: (_pick(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def _scale_embedding(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.normalize_embedding:
        # the sqrt(d_model) scale is rounded to the activation dtype first
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return _scale_embedding(cfg, params["embed"]["tok"][tokens.long()])


def _head_weight(params):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"]["tok"].T


def compute_logits(params, cfg: ModelConfig, x: torch.Tensor):
    """Final logits (softcapped).  Under TP (``params`` the shards' trees)
    a vocab-split head gives the shards' vocab slices, a list with each
    slice on its shard's device, which the engine gathers once a step;
    a head the policy left whole (the vocabulary does not divide by tp)
    runs once on the first shard."""
    if not isinstance(params, list):
        return softcap(x @ _head_weight(params), cfg.final_logit_softcap)
    heads = [_head_weight(p) for p in params]
    if heads[0].shape[-1] == cfg.vocab_size:
        return softcap(x @ heads[0], cfg.final_logit_softcap)
    return [softcap(x.to(w.device) @ w, cfg.final_logit_softcap)
            for w in heads]


def _each(logits, fn):
    """``fn`` over a logits tensor, or over each shard's vocab slice."""
    return [fn(x) for x in logits] if isinstance(logits, list) else fn(logits)


def _chunk_nll(head, cap, xb, lb):
    """:func:`nll_sum` of one sequence chunk's logits."""
    return nll_sum(softcap(xb @ head, cap), lb)


def chunked_ce(params, cfg: ModelConfig, x, labels,
               flags: RuntimeFlags) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks of ``min(loss_chunk, S)``
    positions (S must divide by it), each under a checkpoint, so that no
    (B, c, V) logits are kept for the backward; the chunks' sums add in
    order.  ``loss_chunk=0`` computes the logits in one shot."""
    if flags.loss_chunk <= 0:
        return cross_entropy(compute_logits(params, cfg, x), labels)
    from torch.utils.checkpoint import checkpoint
    s = x.shape[1]
    c = min(flags.loss_chunk, s)
    assert s % c == 0, f"sequence {s} does not divide by loss chunk {c}"
    head = _head_weight(params)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, s, c):
        t, n = checkpoint(_chunk_nll, head, cfg.final_logit_softcap,
                          x[:, i:i + c], labels[:, i:i + c],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1)


# ---------------------------------------------------------------------------
# tensor parallelism: per-shard params and caches, driven from one process
# ---------------------------------------------------------------------------

def tp_devices(flags: RuntimeFlags):
    """The shards' devices when ``flags`` carry a mesh wider than one
    device along ``tp_axis``, else None."""
    mesh = flags.mesh
    if mesh is None or mesh.shape.get(flags.tp_axis, 1) <= 1:
        return None
    return mesh.devices_along(flags.tp_axis)


def _embed_tp(params, cfg: ModelConfig, tokens, devs) -> torch.Tensor:
    """The vocab-split lookup: each shard looks up the tokens in its rows
    (zeros for a token outside them) and the partials sum on the first
    shard, which is exact (one nonzero addend an element)."""
    rows = params[0]["embed"]["tok"].shape[0]
    if rows == cfg.vocab_size:                  # the policy left it whole
        return embed_tokens(params[0], cfg, tokens)
    parts = []
    for i, (p, dev) in enumerate(zip(params, devs)):
        t = tokens.to(dev).long() - i * rows
        inside = ((t >= 0) & (t < rows))[..., None]
        got = p["embed"]["tok"][t.clamp(0, rows - 1)]
        parts.append(torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                                          device=dev)))
    return _scale_embedding(cfg, tp.reduce_sum(tp.DeviceGroup(devs), parts,
                                               "embed"))


def _apply_attn_tp(ps, hs, cfg: ModelConfig, spec: LayerSpec,
                   flags: RuntimeFlags, mode, caches, poss, tables, cvs, devs):
    """An attention layer over the shards: column-parallel q/k/v (each
    shard its contiguous head block), each shard's attention over its own
    pool stripe or dense rows, then the row-parallel o-projection's
    partials summed on the first shard.  int8 KV quantizes each token with
    the amax of all its heads (the shards' maxima reduced, then
    broadcast), so the shards store what one device would."""
    n, g = len(devs), tp.DeviceGroup(devs)
    bsz, s, _ = hs[0].shape
    hq, hkv = cfg.num_heads // n, cfg.num_kv_heads // n
    qkv = [_qkv(p, h, cfg, hq, hkv, mode, pos)
           for p, h, pos in zip(ps, hs, poss)]
    if flags.kv_dtype == "int8":
        amax = [tp.broadcast(g, tp.reduce_max(
                    g, [t[j].float().abs().amax(dim=(2, 3)) for t in qkv],
                    "kv amax"), "kv amax")
                for j in (1, 2)]
        quants = [_quantize(t[1], t[2], flags, am)
                  for t, am in zip(qkv, zip(*amax))]
    else:
        quants = [None] * n
    ap = _attn_params(cfg, spec, flags)
    if mode in ("paged_decode", "paged_extend"):
        outs = _paged_attn([_Shard(q, k, v, qt, c, posv, positions, tb, cv)
                            for (q, k, v, posv, positions), qt, c, tb, cv
                            in zip(qkv, quants, caches, tables, cvs)],
                           ap, spec, mode, flags)
    else:
        done = [_dense_attn(q, k, v, qt, c, ap, spec, posv, mode)
                for (q, k, v, posv, _), qt, c in zip(qkv, quants, caches)]
        outs, caches = [o for o, _ in done], [c for _, c in done]
    hd = cfg.resolved_head_dim
    parts = [o.reshape(bsz, s, hq * hd) @ p["wo"] for o, p in zip(outs, ps)]
    return tp.reduce_sum(g, parts, "attn out"), caches


def _apply_recurrent_tp(spec: LayerSpec, ps, h, cfg: ModelConfig, mode,
                        caches, poss, slot, actives, g):
    """A recurrent mixer over the shards (:func:`_apply_recurrent`'s
    modes): each shard computes its slice of the width or of the heads
    (:func:`~repro_torch.models.rglru.forward_tp`,
    :func:`~repro_torch.models.ssm.forward_tp`) and every shard's cache
    holds the whole state, replicated as the reference's paged cache
    layout keeps it, so each shard writes the whole new state after the
    step; a paged chunk restarts a fresh slot's row and a paged decode
    keeps the rows of inactive slots on every shard."""
    name, mod, state_type = RECURRENT[spec.mixer]
    pl = [p[name] for p in ps]
    hs = tp.broadcast(g, h, "mixer in")
    if mode in ("decode", "paged_decode"):
        mix, new = mod.decode_step_tp(pl, hs, [state_type(**c)
                                               for c in caches], cfg, g)
        for c, st, act in zip(caches, new, actives):
            st = st._asdict()
            if mode == "paged_decode":
                st = _freeze_inactive(st, c, act)
            for n, v in st.items():
                c[n].copy_(v)
        return mix, caches
    if mode == "paged_extend":
        if slot is None:
            raise ValueError(f"{cfg.name}: a paged prefill chunk through a "
                             "recurrent layer needs the slot it continues")
        mix, new = mod.forward_tp(
            pl, hs, cfg, g, return_state=True,
            states=[_slot_state(state_type, c, pos, slot)
                    for c, pos in zip(caches, poss)])
        for c, st in zip(caches, new):
            _write_slot(c, st, slot)
        return mix, caches
    mix, new = mod.forward_tp(pl, hs, cfg, g, return_state=True)
    return mix, [st._asdict() for st in new]


def _apply_layer_tp(ps, x, cfg: ModelConfig, spec: LayerSpec,
                    flags: RuntimeFlags, mode, caches, poss, tables, cvs,
                    devs, slot=None, actives=None):
    """One layer over the shards; the residual stream and the norms stay
    on the first shard, whose normed activations are broadcast into each
    column-parallel projection (a MoE layer sends each shard only its
    experts' rows, :func:`~repro_torch.models.moe.apply_tp`)."""
    g = tp.DeviceGroup(devs)
    h = rms_norm(x, ps[0]["ln1"])
    if spec.mixer == ATTN:
        mix, caches = _apply_attn_tp([p["attn"] for p in ps],
                                     tp.broadcast(g, h, "attn in"), cfg, spec,
                                     flags, mode, caches, poss, tables, cvs,
                                     devs)
    else:
        mix, caches = _apply_recurrent_tp(spec, ps, h, cfg, mode, caches,
                                          poss, slot, actives, g)
    x = x + mix
    if spec.mlp == DENSE:
        h = rms_norm(x, ps[0]["ln2"])
        x = x + mlp_mod.apply_tp([p["mlp"] for p in ps],
                                 tp.broadcast(g, h, "mlp in"),
                                 cfg.activation, cfg.d_ff, g)
    elif spec.mlp == MOE:
        h = rms_norm(x, ps[0]["ln2"])
        out, _ = moe_mod.apply_tp([p["moe"] for p in ps], h,
                                  cfg.num_experts_per_tok, cfg.activation, g,
                                  impl=flags.moe_impl,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  d_ff=cfg.d_ff)
        x = x + out
    return x, caches


def _forward_tp(params, cfg: ModelConfig, flags: RuntimeFlags, tokens,
                mode: str, cache, pos, table, chunk_valid, slot, active,
                patch_embeds, devs):
    """:func:`forward` over the shards: ``params`` and ``cache`` are lists
    of per-shard trees (``cache`` None in prefill, whose new per-shard
    caches come back as a list).  ``table`` may already be a per-shard
    list (the engine replicates it when it changes); positions and chunk
    lengths are broadcast here."""
    check_tp(cfg, len(devs))
    home = devs[0]

    def per_shard(x):
        if x is None:
            return [None] * len(devs)
        if isinstance(x, list):
            return x
        return broadcast(x if isinstance(x, dict)
                         else torch.as_tensor(x, device=home), devs)

    x = _embed_tp(params, cfg, tokens.to(home), devs)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(home, x.dtype), x], dim=1)
    poss, tables, cvs, acts = (per_shard(pos), per_shard(table),
                               per_shard(chunk_valid), per_shard(active))
    n = len(devs)
    blocks = {f"p{j}": [] for j, _ in enumerate(cfg.layer_pattern)}
    for i in range(cfg.num_pattern_blocks):
        for j, spec in enumerate(cfg.layer_pattern):
            cs = ([None] * n if cache is None
                  else [_pick(c["blocks"][f"p{j}"], i) for c in cache])
            x, cs = _apply_layer_tp(
                [_pick(p["blocks"][f"p{j}"], i) for p in params], x, cfg,
                spec, flags, mode, cs, poss, tables, cvs, devs, slot, acts)
            blocks[f"p{j}"].append(cs)
    rem = {}
    for j, spec in enumerate(cfg.remainder_specs):
        cs = [None] * n if cache is None else [c["rem"][f"r{j}"]
                                               for c in cache]
        x, rem[f"r{j}"] = _apply_layer_tp(
            [p["rem"][f"r{j}"] for p in params], x, cfg, spec, flags, mode,
            cs, poss, tables, cvs, devs, slot, acts)
    if mode == "prefill":
        cache = [dict(blocks={name: {k: torch.stack([c[i][k] for c in cs])
                                     for k in cs[0][i]}
                              for name, cs in blocks.items()},
                      rem={name: cs[i] for name, cs in rem.items()})
                 for i in range(n)]
    return rms_norm(x, params[0]["final_norm"]), cache


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

MODES = ("train", "prefill", "decode", "paged_decode", "paged_extend")


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy: keep the outputs of the unbatched
    matmuls (the projections and the MLP, ``aten.mm``; the counterpart of
    the reference's ``dots_with_no_batch_dims_saveable``), recompute
    everything else, batched attention products included."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(remat: str, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    ``full`` keeps only the inputs and recomputes the rest in the
    backward, ``dots`` also keeps the unbatched matmuls' outputs
    (selective checkpointing, :func:`_save_matmuls`), ``none`` (or no
    autograd) calls it."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_matmuls)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _layer_remat(flags: RuntimeFlags) -> str:
    """A layer outside the pattern blocks (the remainder layers here, an
    encoder-decoder's layers in :mod:`repro_torch.models.encdec`) is
    recomputed whole in the backward under either remat policy, as the
    reference's ``nothing_saveable`` does."""
    return "none" if flags.remat == "none" else "full"


def _forward_train(params, cfg: ModelConfig, flags: RuntimeFlags, tokens,
                   patch_embeds=None):
    """The full-sequence stack with gradients: (final-normed hidden states,
    the MoE load-balance losses summed over the layers, float32).  Each
    pattern block runs under ``flags.remat``; the remainder layers under
    :func:`_layer_remat`."""
    x = embed_tokens(params, cfg, tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layers(pairs, x, aux):
        """(spec, params) pairs applied in order."""
        for spec, p in pairs:
            x, _, a = _apply_layer(p, x, cfg, spec, flags, "train", None,
                                   None, None, None)
            if a is not None:
                aux = aux + a
        return x, aux

    for i in range(cfg.num_pattern_blocks):
        bp = _pick(params["blocks"], i)
        x, aux = _remat(flags.remat, layers,
                        [(spec, bp[f"p{j}"])
                         for j, spec in enumerate(cfg.layer_pattern)], x, aux)
    for j, spec in enumerate(cfg.remainder_specs):
        x, aux = _remat(_layer_remat(flags), layers,
                        [(spec, params["rem"][f"r{j}"])], x, aux)
    return rms_norm(x, params["final_norm"]), aux


def forward(params, cfg: ModelConfig, flags: RuntimeFlags, tokens, mode: str,
            cache=None, pos=None, table=None, chunk_valid=None, slot=None,
            active=None, patch_embeds=None):
    """tokens: (B, S) -> (final-normed hidden states (B, S, d), cache);
    ``patch_embeds`` (B, P, d), a frontend's, are prepended to the token
    embeddings (then (B, P + S, d)).
    ``train`` builds no cache and keeps the graph for autograd: it
    returns (hidden states, the MoE load-balance loss summed over the
    layers) (:func:`_forward_train`).
    ``prefill`` builds a new dense cache from the prompt (stacked like the
    params); the other modes write ``cache`` in place and return it.
    ``table``/``chunk_valid`` only apply to the paged modes: ``table`` is
    ``{"full": (B, N), "ring": (B, R)}`` (a bare (B, N) table serves a
    stack without windowed layers).  ``slot`` (``paged_extend``) and
    ``active`` (``paged_decode``) apply to recurrent layers only.  With a
    mesh in ``flags`` (:func:`tp_devices`) the stack runs tensor-parallel
    (:func:`_forward_tp`)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the port runs {MODES}")
    if mode == "train":
        return _forward_train(params, cfg, flags, tokens, patch_embeds)
    if table is not None and not isinstance(table, (dict, list)):
        table = dict(full=table)
    devs = tp_devices(flags)
    if devs is not None:
        return _forward_tp(params, cfg, flags, tokens, mode, cache, pos,
                           table, chunk_valid, slot, active, patch_embeds,
                           devs)
    x = embed_tokens(params, cfg, tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    blocks = {f"p{j}": [] for j, _ in enumerate(cfg.layer_pattern)}
    for i in range(cfg.num_pattern_blocks):
        for j, spec in enumerate(cfg.layer_pattern):
            c = (None if cache is None
                 else _pick(cache["blocks"][f"p{j}"], i))
            x, c, _ = _apply_layer(_pick(params["blocks"][f"p{j}"], i), x,
                                   cfg, spec, flags, mode, c, pos, table,
                                   chunk_valid, slot, active)
            blocks[f"p{j}"].append(c)
    rem = {}
    for j, spec in enumerate(cfg.remainder_specs):
        c = None if cache is None else cache["rem"][f"r{j}"]
        x, rem[f"r{j}"], _ = _apply_layer(params["rem"][f"r{j}"], x, cfg,
                                          spec, flags, mode, c, pos, table,
                                          chunk_valid, slot, active)
    if mode == "prefill":
        cache = dict(blocks={name: {n: torch.stack([c[n] for c in cs])
                                    for n in cs[0]}
                             for name, cs in blocks.items()},
                     rem=rem)
    return rms_norm(x, params["final_norm"]), cache


def train_loss(params, cfg: ModelConfig, flags: RuntimeFlags, batch: dict):
    """``batch["tokens"]`` (B, S), ``batch["labels"]`` (B, S + P) (labels
    below 0 are left out), ``batch["patch_embeds"]`` (B, P, d, optional).
    Returns (cross-entropy + ``aux_loss_weight`` x the MoE load-balance
    loss, dict(ce=, aux=)), with the graph kept for autograd.  With a
    mesh of more than one device in ``flags`` it runs over the mesh
    (:func:`repro_torch.models.sharded.train_loss`)."""
    if flags.mesh is not None and len(flags.mesh.devices) > 1:
        from repro_torch.models import sharded
        return sharded.train_loss(params, cfg, flags, batch)
    x, aux = forward(params, cfg, flags, batch["tokens"], "train",
                     patch_embeds=batch.get("patch_embeds"))
    loss = chunked_ce(params, cfg, x, batch["labels"], flags)
    return loss + flags.aux_loss_weight * aux, dict(ce=loss, aux=aux)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, flags: RuntimeFlags, batch: dict):
    """``batch["tokens"]`` (B, S), right-padded to a bucket;
    ``batch["patch_embeds"]`` (B, P, d, optional) a frontend's embeddings,
    prepended; ``batch["valid_len"]`` (scalar or (B,), optional) marks the
    true prompt length (patches included), so the last logits are read at
    ``valid_len - 1`` instead of the pad tail.  Causal attention keeps
    positions < valid_len exact under right padding; cache rows past it
    are masked by the decode step's ``kv_valid_len``.  Returns (cache,
    last logits (B, V))."""
    x, cache = forward(params, cfg, flags, batch["tokens"], "prefill",
                       patch_embeds=batch.get("patch_embeds"))
    vl = batch.get("valid_len")
    if vl is None:
        last = x[:, -1:]
    else:
        bsz = x.shape[0]
        idx = torch.as_tensor(vl, device=x.device).reshape(-1).long(
            ).expand(bsz) - 1
        last = x[torch.arange(bsz, device=x.device), idx][:, None]
    return cache, _each(compute_logits(params, cfg, last), lambda l: l[:, 0])


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, flags: RuntimeFlags, cache: dict,
                tokens, pos):
    """One decode tick on the dense cache.  tokens: (B, 1); pos: scalar or
    (B,) per-slot positions.  Returns (logits (B, V), cache)."""
    x, cache = forward(params, cfg, flags, tokens, "decode", cache, pos)
    return _each(compute_logits(params, cfg, x), lambda l: l[:, 0]), cache


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, flags: RuntimeFlags,
                      cache: dict, tokens, pos, table, active=None):
    """One decode tick against the page pools.  tokens: (B, 1); pos: (B,)
    per-slot positions; table: ``{"full": (B, N), "ring": (B, R)}`` int32
    page tables (padded entries -> the null page; windowed layers read the
    ring table, full-attention layers the full one).  Every attention
    layer appends k/v through its table and runs the ``paged_attention``
    kernel; recurrent layers advance their dense state rows, except where
    ``active`` (B,) bool is False: those rows keep their state.  Returns
    (logits (B, V), cache)."""
    x, cache = forward(params, cfg, flags, tokens, "paged_decode", cache, pos,
                       table, active=active)
    return _each(compute_logits(params, cfg, x), lambda l: l[:, 0]), cache


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, flags: RuntimeFlags,
                        cache: dict, tokens, pos, table, chunk_valid,
                        slot: Optional[int] = None):
    """One chunked-prefill step: ``tokens`` (B, C) is a prompt chunk
    (right-padded to a bucket; ``chunk_valid`` (B,) marks its true length)
    at absolute offset ``pos`` (B,).  Appends the chunk's k/v into the
    pages (full tables and rotating ring tables alike) and returns (cache,
    logits at the chunk's last valid position).  On a stack with recurrent
    layers the chunk (B = 1) continues the state row of engine slot
    ``slot``; at offset 0 the row restarts from zeros."""
    x, cache = forward(params, cfg, flags, tokens, "paged_extend", cache, pos,
                       table, chunk_valid, slot)
    bsz = x.shape[0]
    idx = chunk_valid.reshape(-1).long().expand(bsz) - 1
    last = x[torch.arange(bsz, device=x.device), idx][:, None]
    return cache, _each(compute_logits(params, cfg, last), lambda l: l[:, 0])


@torch.no_grad()
def paged_verify(params, cfg: ModelConfig, flags: RuntimeFlags, cache: dict,
                 tokens, pos, table, chunk_valid, plan=None):
    """Speculative k-token verification: one ``paged_extend`` pass.

    ``tokens`` (B, C) is ``[pending, draft_0 .. draft_{C-2}]`` per slot at
    absolute offset ``pos`` (B,); ``chunk_valid`` (B,) caps how many
    positions each slot writes (the rest go to the null page, as in
    chunked prefill).  Unlike :func:`paged_prefill_chunk` it returns the
    logits at every position, (B, C, V): query i attends rows ``<= pos +
    i`` of the gathered pages, so row i's logits are what
    :func:`paged_decode_step` gives after the same prefix.  ``plan`` is
    the engine's verify plan (``bq`` the width, ``bkv`` the pool's page);
    it must describe the pool read.  Returns (cache, logits)."""
    # every pool leaf is (..., P, page, Hkv, D)
    c0 = cache[0] if isinstance(cache, list) else cache
    page = next(layer["k_pages"].shape[-3] for part in ("blocks", "rem")
                for layer in c0[part].values())
    if plan is not None and plan.page_size != page:
        raise ValueError(f"verify plan pages of {plan.page_size} tokens, "
                         f"the pool's hold {page}")
    x, cache = forward(params, cfg, flags, tokens, "paged_extend", cache, pos,
                       table, chunk_valid)
    return cache, compute_logits(params, cfg, x)
