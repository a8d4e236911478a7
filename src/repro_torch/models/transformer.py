"""Decoder-only LM, ATTN + DENSE full-attention stacks, on a paged KV cache.

The port of the paged modes of ``repro.models.transformer``:

- ``paged_extend`` (:func:`paged_prefill_chunk`): a prompt chunk writes its
  k/v through the page table, then attends over the gathered pages with
  :func:`~repro_torch.models.attention.paged_gather_attention`;
- ``paged_decode`` (:func:`paged_decode_step`): one token per slot writes
  through the table, then every attention layer runs the
  ``paged_attention`` kernel (:mod:`repro_torch.kernels.ops`).

Parameters keep the reference's layout: per-pattern-position weights
stacked on a leading LAYERS axis (``blocks.p{j}``), remainder layers
unstacked (``rem.r{j}``); the layer loop is a Python loop over that axis.
The page pools are updated in place (the reference returns a new cache;
here the returned cache is the same dict, mutated), which keeps the
pools' memory at one copy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import AttnParams, paged_gather_attention
from repro_torch.models.common import ParamBuilder, rms_norm, rope, softcap


def check_supported(cfg: ModelConfig) -> None:
    """The port serves full-attention ATTN + DENSE decoders; raise on any
    other layer kind rather than compute something else."""
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

def _attn_params(cfg: ModelConfig, spec: LayerSpec) -> AttnParams:
    scale = (cfg.query_pre_attn_scalar ** -0.5
             if cfg.query_pre_attn_scalar is not None
             else cfg.resolved_head_dim ** -0.5)
    return AttnParams(causal=True, window=spec.sliding_window,
                      softcap=cfg.attn_logit_softcap, scale=scale)


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


def _apply_attn(p, x, cfg: ModelConfig, spec: LayerSpec, cache, pos, table,
                chunk_valid, mode):
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(bsz, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    o = _paged_attn(q, k, v, cache, _attn_params(cfg, spec), pos, table,
                    chunk_valid, cfg, mode)
    return o.reshape(bsz, s, cfg.num_heads * hd) @ p["wo"]


def _apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, cache, pos, table,
                 chunk_valid, mode):
    h = rms_norm(x, p["ln1"])
    x = x + _apply_attn(p["attn"], h, cfg, spec, cache, pos, table,
                        chunk_valid, mode)
    h = rms_norm(x, p["ln2"])
    return x + mlp_mod.apply(p["mlp"], h, cfg.activation)


def _layers(params, cache, cfg: ModelConfig):
    """(layer params, layer cache, spec) in execution order: pattern blocks
    along the LAYERS axis, then the remainder layers."""
    pick = lambda tree, i: {k: (pick(v, i) if isinstance(v, dict) else v[i])
                            for k, v in tree.items()}
    for i in range(cfg.num_pattern_blocks):
        for j, spec in enumerate(cfg.layer_pattern):
            yield (pick(params["blocks"][f"p{j}"], i),
                   pick(cache["blocks"][f"p{j}"], i), spec)
    for j, spec in enumerate(cfg.remainder_specs):
        yield params["rem"][f"r{j}"], cache["rem"][f"r{j}"], spec


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

def forward(params, cfg: ModelConfig, tokens, mode: str, cache, pos, table,
            chunk_valid=None):
    """tokens: (B, S) -> final-normed hidden states (B, S, d); the cache's
    pools are written in place."""
    x = embed_tokens(params, cfg, tokens)
    for p, c, spec in _layers(params, cache, cfg):
        x = _apply_layer(p, x, cfg, spec, c, pos, table, chunk_valid, mode)
    return rms_norm(x, params["final_norm"])


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, cache: dict, tokens, pos,
                      table):
    """One decode tick against the page pool.  tokens: (B, 1); pos: (B,)
    per-slot positions; table: (B, N) int32 page table (padded entries ->
    the null page).  Every attention layer appends k/v through the table
    and runs the ``paged_attention`` kernel.  Returns (logits (B, V),
    cache)."""
    x = forward(params, cfg, tokens, "paged_decode", cache, pos, table)
    return compute_logits(params, cfg, x)[:, 0], cache


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, cache: dict, tokens, pos,
                        table, chunk_valid):
    """One chunked-prefill step: ``tokens`` (B, C) is a prompt chunk
    (right-padded to a bucket; ``chunk_valid`` (B,) marks its true length)
    at absolute offset ``pos`` (B,).  Appends the chunk's k/v into the
    pages and returns (cache, logits at the chunk's last valid position)."""
    x = forward(params, cfg, tokens, "paged_extend", cache, pos, table,
                chunk_valid)
    bsz = x.shape[0]
    idx = chunk_valid.reshape(-1).long().expand(bsz) - 1
    last = x[torch.arange(bsz, device=x.device), idx][:, None]
    return cache, compute_logits(params, cfg, last)[:, 0]
