"""Decoder-only LM, ATTN + DENSE full-attention stacks, on a dense or a
paged KV cache.

The port of ``repro.models.transformer`` for these stacks, four modes:

- ``prefill`` (:func:`prefill`): a whole (right-padded) prompt; attention
  through ``flags.attn_impl`` (``pallas`` runs the ``flash_attention``
  kernel, K2); returns a dense cache of the prompt's k/v;
- ``decode`` (:func:`decode_step`): one token per slot written into the
  dense ``(B, max_len)`` cache at its own position, then naive attention
  over the cache;
- ``paged_extend`` (:func:`paged_prefill_chunk`): a prompt chunk writes its
  k/v through the page table, then attends over the gathered pages with
  :func:`~repro_torch.models.attention.paged_gather_attention`;
- ``paged_decode`` (:func:`paged_decode_step`): one token per slot writes
  through the table, then every attention layer runs the
  ``paged_attention`` kernel (K1, :mod:`repro_torch.kernels.ops`).

Parameters keep the reference's layout: per-pattern-position weights
stacked on a leading LAYERS axis (``blocks.p{j}``), remainder layers
unstacked (``rem.r{j}``); the layer loop is a Python loop over that axis.
Caches are updated in place (the reference returns a new cache; here the
decode modes return the same dict, mutated), which keeps the cache's
memory at one copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttnParams, paged_gather_attention
from repro_torch.models.common import ParamBuilder, rms_norm, rope, softcap


@dataclass(frozen=True)
class RuntimeFlags:
    """Execution knobs (never affect math).  ``attn_impl`` picks the
    attention of full-sequence prefill (naive | chunked | pallas);
    ``attn_bq``/``attn_bkv`` pin chunked's blocks (None = the tuned
    plan's, :func:`repro_torch.models.attention.resolve_blocks`); the CUDA
    kernel behind ``pallas`` picks its own tiles.  ``kv_dtype="int8"`` is
    not ported yet."""

    attn_impl: str = "chunked"
    attn_bq: Optional[int] = None
    attn_bkv: Optional[int] = None
    kv_dtype: str = "native"


def check_supported(cfg: ModelConfig,
                    flags: Optional[RuntimeFlags] = None) -> None:
    """The port serves full-attention ATTN + DENSE decoders with a cache in
    the compute dtype; raise on anything else rather than compute
    something else."""
    if flags is not None:
        if flags.kv_dtype == "int8":
            raise NotImplementedError(
                "kv_dtype='int8' is not ported yet (int8 KV pages and "
                "scale lanes)")
        if flags.kv_dtype != "native":
            raise ValueError(f"unknown kv_dtype {flags.kv_dtype!r}")
        if flags.attn_impl not in attn_mod.IMPLS:
            raise ValueError(f"unknown attn_impl {flags.attn_impl!r}; known: "
                             f"{sorted(attn_mod.IMPLS)}")
    if cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend stacks are not ported")
    for spec in tuple(cfg.layer_pattern) + tuple(cfg.remainder_specs):
        if spec.mixer != ATTN or spec.mlp != DENSE or spec.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} is not ported (full-attention "
                "ATTN + DENSE layers only)")


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(b: ParamBuilder, path: str, cfg: ModelConfig, stacked: int):
    lead = (stacked,) if stacked else ()
    d, hd = cfg.d_model, cfg.resolved_head_dim
    b.zeros(f"{path}.ln1", lead + (d,))
    b.dense(f"{path}.attn.wq", lead + (d, cfg.num_heads * hd))
    b.dense(f"{path}.attn.wk", lead + (d, cfg.num_kv_heads * hd))
    b.dense(f"{path}.attn.wv", lead + (d, cfg.num_kv_heads * hd))
    b.dense(f"{path}.attn.wo", lead + (cfg.num_heads * hd, d))
    b.zeros(f"{path}.ln2", lead + (d,))
    mlp_mod.init(b, f"{path}.mlp", d, cfg.d_ff, cfg.activation, stacked)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device) -> dict:
    """Fresh weights drawn from ``generator`` (on ``device``); with
    ``device="meta"`` only the paths and shapes."""
    check_supported(cfg)
    b = ParamBuilder(generator, dtype_of(cfg.param_dtype), device)
    b.dense("embed.tok", (cfg.vocab_size, cfg.d_model),
            scale=cfg.d_model ** -0.5)
    nb = cfg.num_pattern_blocks
    for j, _ in enumerate(cfg.layer_pattern):
        _init_layer(b, f"blocks.p{j}", cfg, nb)
    for j, _ in enumerate(cfg.remainder_specs):
        _init_layer(b, f"rem.r{j}", cfg, 0)
    b.zeros("final_norm", (cfg.d_model,))
    if not cfg.tie_embeddings:
        b.dense("lm_head", (cfg.d_model, cfg.vocab_size))
    return b.params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Dense decode cache: per-layer ``k``/``v`` of shape
    (batch, max_len, Hkv, D) in the compute dtype, stacked on LAYERS like
    the params."""
    check_supported(cfg)
    dtype = dtype_of(cfg.compute_dtype)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)

    def kv(lead):
        return {n: torch.zeros(lead + shape, dtype=dtype, device=device)
                for n in ("k", "v")}

    nb = cfg.num_pattern_blocks
    return dict(blocks={f"p{j}": kv((nb,))
                        for j, _ in enumerate(cfg.layer_pattern)},
                rem={f"r{j}": kv(())
                     for j, _ in enumerate(cfg.remainder_specs)})


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> dict:
    """Per-layer page pools ``k_pages``/``v_pages`` of shape
    (P, page, Hkv, D), stacked on LAYERS like the params; page ids are
    shared by every layer (one host-side allocator and table)."""
    check_supported(cfg)
    dtype = dtype_of(cfg.compute_dtype)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)

    def pools(lead):
        return {n: torch.zeros(lead + shape, dtype=dtype, device=device)
                for n in ("k_pages", "v_pages")}

    nb = cfg.num_pattern_blocks
    return dict(blocks={f"p{j}": pools((nb,))
                        for j, _ in enumerate(cfg.layer_pattern)},
                rem={f"r{j}": pools(())
                     for j, _ in enumerate(cfg.remainder_specs)})


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


def _paged_attn(q, k, v, cache, ap: AttnParams, pos, table, chunk_valid,
                cfg: ModelConfig, mode: str):
    """The paged-cache mixer body for full-attention layers.

    Logical page j of a row covers absolute positions [j*page, (j+1)*page).
    The new k/v are written through the table first; positions outside the
    chunk (bucket padding) are steered to page 0, which the engine reserves
    as a null page, so masked writes never touch live data.  Decode (S=1)
    then runs the ``paged_attention`` kernel; extend attends over the
    gathered pages."""
    bsz, s = q.shape[:2]
    kp, vp = cache["k_pages"], cache["v_pages"]
    page = kp.shape[1]
    n = table.shape[1]
    dev = q.device
    posv = pos.reshape(-1).to(torch.int32).expand(bsz)
    positions = posv[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if chunk_valid is None:
        valid = torch.full((bsz,), s, dtype=torch.int32, device=dev)
    else:
        valid = chunk_valid.reshape(-1).to(torch.int32).expand(bsz)
    in_chunk = torch.arange(s, device=dev)[None, :] < valid[:, None]
    pidx = torch.clamp(positions // page, max=n - 1).long()
    rows = torch.arange(bsz, device=dev)[:, None]
    pids = torch.where(in_chunk, table.long()[rows, pidx], 0)
    slots = torch.where(in_chunk, (positions % page).long(), 0)
    kp[pids, slots] = k.to(kp.dtype)
    vp[pids, slots] = v.to(vp.dtype)
    if mode == "paged_decode":
        o = kops.paged_attention(q[:, 0], kp, vp, table, posv + 1,
                                 scale=ap.scale, softcap=ap.softcap)[:, None]
    else:
        o = paged_gather_attention(q, kp, vp, table, ap, q_offset=posv,
                                   kv_valid_len=posv + valid)
    return o


def _dense_attn(q, k, v, cache, ap: AttnParams, pos, cfg: ModelConfig,
                mode: str):
    """The dense-cache mixer body.  Decode writes each slot's k/v into its
    cache row at its own position, then attends over the row up to it;
    prefill attends over the whole (right-padded) sequence through
    ``ap.impl`` and hands its k/v back as the request's cache."""
    bsz, s = q.shape[:2]
    dev = q.device
    if mode == "decode":
        posv = torch.as_tensor(pos, dtype=torch.int32, device=dev
                               ).reshape(-1).expand(bsz)
        q = rope(q, posv[:, None], cfg.rope_theta)
        k = rope(k, posv[:, None], cfg.rope_theta)
        rows = torch.arange(bsz, device=dev)
        kc, vc = cache["k"], cache["v"]
        kc[rows, posv.long()] = k[:, 0].to(kc.dtype)
        vc[rows, posv.long()] = v[:, 0].to(vc.dtype)
        o = attn_mod.naive_attention(q, kc, vc, ap, q_offset=posv,
                                     kv_valid_len=posv + 1)
        return o, cache
    positions = torch.arange(s, dtype=torch.int32, device=dev
                             )[None].expand(bsz, s)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attn_mod.attention(q, k, v, ap)
    return o, dict(k=k, v=v)


def _apply_attn(p, x, cfg: ModelConfig, spec: LayerSpec, flags: RuntimeFlags,
                mode, cache, pos, table, chunk_valid):
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(bsz, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    ap = _attn_params(cfg, spec, flags)
    if mode in ("paged_decode", "paged_extend"):
        o = _paged_attn(q, k, v, cache, ap, pos, table, chunk_valid, cfg,
                        mode)
    else:
        o, cache = _dense_attn(q, k, v, cache, ap, pos, cfg, mode)
    return o.reshape(bsz, s, cfg.num_heads * hd) @ p["wo"], cache


def _apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, flags: RuntimeFlags,
                 mode, cache, pos, table, chunk_valid):
    """Returns (x, the layer's cache: the one given, written in place, or
    the prompt's new k/v in prefill)."""
    h = rms_norm(x, p["ln1"])
    mix, cache = _apply_attn(p["attn"], h, cfg, spec, flags, mode, cache, pos,
                             table, chunk_valid)
    x = x + mix
    h = rms_norm(x, p["ln2"])
    return x + mlp_mod.apply(p["mlp"], h, cfg.activation), cache


def _pick(tree, i):
    return {k: (_pick(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["tok"][tokens.long()]
    if cfg.normalize_embedding:
        # the sqrt(d_model) scale is rounded to the activation dtype first
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _head_weight(params):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"]["tok"].T


def compute_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return softcap(x @ _head_weight(params), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

MODES = ("prefill", "decode", "paged_decode", "paged_extend")


def forward(params, cfg: ModelConfig, flags: RuntimeFlags, tokens, mode: str,
            cache=None, pos=None, table=None, chunk_valid=None):
    """tokens: (B, S) -> (final-normed hidden states (B, S, d), cache).
    ``prefill`` builds a new dense cache from the prompt (stacked like the
    params); the other modes write ``cache`` in place and return it.
    ``table``/``chunk_valid`` only apply to the paged modes."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the port runs {MODES}")
    x = embed_tokens(params, cfg, tokens)
    blocks = {f"p{j}": [] for j, _ in enumerate(cfg.layer_pattern)}
    for i in range(cfg.num_pattern_blocks):
        for j, spec in enumerate(cfg.layer_pattern):
            c = (None if cache is None
                 else _pick(cache["blocks"][f"p{j}"], i))
            x, c = _apply_layer(_pick(params["blocks"][f"p{j}"], i), x, cfg,
                                spec, flags, mode, c, pos, table, chunk_valid)
            blocks[f"p{j}"].append(c)
    rem = {}
    for j, spec in enumerate(cfg.remainder_specs):
        c = None if cache is None else cache["rem"][f"r{j}"]
        x, rem[f"r{j}"] = _apply_layer(params["rem"][f"r{j}"], x, cfg, spec,
                                       flags, mode, c, pos, table,
                                       chunk_valid)
    if mode == "prefill":
        cache = dict(blocks={name: {n: torch.stack([c[n] for c in cs])
                                    for n in ("k", "v")}
                             for name, cs in blocks.items()},
                     rem=rem)
    return rms_norm(x, params["final_norm"]), cache


@torch.no_grad()
def prefill(params, cfg: ModelConfig, flags: RuntimeFlags, batch: dict):
    """``batch["tokens"]`` (B, S), right-padded to a bucket;
    ``batch["valid_len"]`` (scalar or (B,), optional) marks the true prompt
    length, so the last logits are read at ``valid_len - 1`` instead of the
    pad tail.  Causal attention keeps positions < valid_len exact under
    right padding; cache rows past it are masked by the decode step's
    ``kv_valid_len``.  Returns (cache, last logits (B, V))."""
    x, cache = forward(params, cfg, flags, batch["tokens"], "prefill")
    vl = batch.get("valid_len")
    if vl is None:
        last = x[:, -1:]
    else:
        bsz = x.shape[0]
        idx = torch.as_tensor(vl, device=x.device).reshape(-1).long(
            ).expand(bsz) - 1
        last = x[torch.arange(bsz, device=x.device), idx][:, None]
    return cache, compute_logits(params, cfg, last)[:, 0]


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, flags: RuntimeFlags, cache: dict,
                tokens, pos):
    """One decode tick on the dense cache.  tokens: (B, 1); pos: scalar or
    (B,) per-slot positions.  Returns (logits (B, V), cache)."""
    x, cache = forward(params, cfg, flags, tokens, "decode", cache, pos)
    return compute_logits(params, cfg, x)[:, 0], cache


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, flags: RuntimeFlags,
                      cache: dict, tokens, pos, table):
    """One decode tick against the page pool.  tokens: (B, 1); pos: (B,)
    per-slot positions; table: (B, N) int32 page table (padded entries ->
    the null page).  Every attention layer appends k/v through the table
    and runs the ``paged_attention`` kernel.  Returns (logits (B, V),
    cache)."""
    x, cache = forward(params, cfg, flags, tokens, "paged_decode", cache, pos,
                       table)
    return compute_logits(params, cfg, x)[:, 0], cache


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, flags: RuntimeFlags,
                        cache: dict, tokens, pos, table, chunk_valid):
    """One chunked-prefill step: ``tokens`` (B, C) is a prompt chunk
    (right-padded to a bucket; ``chunk_valid`` (B,) marks its true length)
    at absolute offset ``pos`` (B,).  Appends the chunk's k/v into the
    pages and returns (cache, logits at the chunk's last valid position)."""
    x, cache = forward(params, cfg, flags, tokens, "paged_extend", cache, pos,
                       table, chunk_valid)
    bsz = x.shape[0]
    idx = chunk_valid.reshape(-1).long().expand(bsz) - 1
    last = x[torch.arange(bsz, device=x.device), idx][:, None]
    return cache, compute_logits(params, cfg, last)[:, 0]
