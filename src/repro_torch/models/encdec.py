"""Encoder-decoder stack (the seamless-m4t family), as
``repro.models.encdec``.

The encoder runs bidirectional self-attention and an FFN over precomputed
frame embeddings (B, S, d) (the modality frontend is a stub, as in the
reference), with RoPE over the frames; the decoder runs causal
self-attention, cross-attention over the encoder memory and an FFN.  Its
decode cache is split: the self-attention ``k``/``v`` rows of ``max_len``
(written one row per slot at its position, then read through
``naive_attention`` up to ``pos + 1``), and the cross ``ck``/``cv`` of
``enc_len`` rows, computed once at prefill.  Prefill attention goes
through ``flags.attn_impl`` (``pallas`` runs the ``flash_attention``
kernel, K2, on every encoder, decoder-self and cross layer); a decode
step's one query takes ``naive``.  :func:`train_loss` runs the encoder
and the decoder over whole sequences with autograd and no cache (each
layer rematerialised when ``flags.remat`` is on).

Parameters keep the reference's dotted paths (``enc.*``, ``enc_norm``,
``dec.{ln1,self,lnx,cross,ln2,mlp}``, ``final_norm``, ``lm_head`` when the
embeddings are untied) with the LAYERS axis stacked; the layer loops are
Python loops over that axis.  Decode updates the cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import AttnParams
from repro_torch.models.common import (EMBED, HEADS, KV_HEADS, LAYERS,
                                       VOCAB, ParamBuilder, rms_norm, rope)
from repro_torch.models.transformer import (RuntimeFlags, _layer_remat,
                                            _pick, _remat, chunked_ce,
                                            compute_logits, dtype_of)


def _init_attn(b: ParamBuilder, path: str, cfg: ModelConfig, stacked: int):
    lead, la = (stacked,), (LAYERS,)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    b.dense(f"{path}.wq", lead + (d, cfg.num_heads * hd), la + (EMBED, HEADS))
    b.dense(f"{path}.wk", lead + (d, cfg.num_kv_heads * hd),
            la + (EMBED, KV_HEADS))
    b.dense(f"{path}.wv", lead + (d, cfg.num_kv_heads * hd),
            la + (EMBED, KV_HEADS))
    b.dense(f"{path}.wo", lead + (cfg.num_heads * hd, d), la + (HEADS, EMBED))


def build_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                 device) -> ParamBuilder:
    """The builder holding the stack's weights and their logical axes."""
    b = ParamBuilder(generator, dtype_of(cfg.param_dtype), device)
    d = cfg.d_model
    ne, nd = cfg.num_encoder_layers, cfg.num_layers
    b.dense("embed.tok", (cfg.vocab_size, d), (VOCAB, EMBED), scale=d ** -0.5)
    b.zeros("enc.ln1", (ne, d), (LAYERS, EMBED))
    _init_attn(b, "enc.attn", cfg, ne)
    b.zeros("enc.ln2", (ne, d), (LAYERS, EMBED))
    mlp_mod.init(b, "enc.mlp", d, cfg.d_ff, cfg.activation, ne)
    b.zeros("enc_norm", (d,), (EMBED,))
    b.zeros("dec.ln1", (nd, d), (LAYERS, EMBED))
    _init_attn(b, "dec.self", cfg, nd)
    b.zeros("dec.lnx", (nd, d), (LAYERS, EMBED))
    _init_attn(b, "dec.cross", cfg, nd)
    b.zeros("dec.ln2", (nd, d), (LAYERS, EMBED))
    mlp_mod.init(b, "dec.mlp", d, cfg.d_ff, cfg.activation, nd)
    b.zeros("final_norm", (d,), (EMBED,))
    if not cfg.tie_embeddings:
        b.dense("lm_head", (d, cfg.vocab_size), (EMBED, VOCAB))
    return b


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device) -> dict:
    """Fresh weights drawn from ``generator`` (on ``device``); with
    ``device="meta"`` only the paths and shapes."""
    return build_params(cfg, generator, device).params


def _heads(x: torch.Tensor, w: torch.Tensor, heads: int,
           hd: int) -> torch.Tensor:
    bsz, s, _ = x.shape
    return (x @ w).reshape(bsz, s, heads, hd)


def _qkv(p, x, cfg: ModelConfig, positions=None):
    hd = cfg.resolved_head_dim
    q = _heads(x, p["wq"], cfg.num_heads, hd)
    k = _heads(x, p["wk"], cfg.num_kv_heads, hd)
    v = _heads(x, p["wv"], cfg.num_kv_heads, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _proj_out(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    bsz, s = o.shape[:2]
    return o.reshape(bsz, s, cfg.num_heads * cfg.resolved_head_dim) @ p["wo"]


def _attn_params(flags: RuntimeFlags, causal: bool) -> AttnParams:
    return AttnParams(impl=flags.attn_impl, causal=causal, bq=flags.attn_bq,
                      bkv=flags.attn_bkv)


def encode(params, cfg: ModelConfig, flags: RuntimeFlags,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S, d) -> encoder memory (B, S, d) in the compute dtype;
    each layer under ``flags.remat`` when it trains (:func:`_layer_remat`)."""
    ap = _attn_params(flags, causal=False)
    bsz, s, _ = frames.shape
    positions = torch.arange(s, dtype=torch.int32, device=frames.device
                             )[None].expand(bsz, s)
    x = frames.to(dtype_of(cfg.compute_dtype))

    def layer(bp, x):
        h = rms_norm(x, bp["ln1"])
        q, k, v = _qkv(bp["attn"], h, cfg, positions)
        x = x + _proj_out(bp["attn"], attn_mod.attention(q, k, v, ap), cfg)
        h = rms_norm(x, bp["ln2"])
        return x + mlp_mod.apply(bp["mlp"], h, cfg.activation)

    for i in range(cfg.num_encoder_layers):
        x = _remat(_layer_remat(flags), layer, _pick(params["enc"], i), x)
    return rms_norm(x, params["enc_norm"])


def _cross_kv(p, memory: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    return (_heads(memory, p["wk"], cfg.num_kv_heads, hd),
            _heads(memory, p["wv"], cfg.num_kv_heads, hd))


def _decoder(params, cfg: ModelConfig, flags: RuntimeFlags, x, memory=None,
             cache=None, pos=None, mode: str = "prefill"):
    """x: (B, St, d) token embeddings.  ``prefill`` attends over the whole
    sequence and the encoder ``memory`` and returns the new split cache;
    ``train`` does the same and keeps no cache (each layer under
    ``flags.remat``, :func:`_layer_remat`); ``decode`` (St = 1) writes
    each slot's k/v at its own ``pos`` (scalar or (B,)) into ``cache`` in
    place and reads the cross k/v from it."""
    ap_self = _attn_params(flags, causal=True)
    ap_cross = _attn_params(flags, causal=False)
    bsz, st, _ = x.shape
    dev = x.device
    hd = cfg.resolved_head_dim
    if mode == "decode":
        posv = torch.as_tensor(pos, dtype=torch.int32, device=dev
                               ).reshape(-1).expand(bsz)
        positions = posv[:, None]
        rows = torch.arange(bsz, device=dev)
    else:
        positions = torch.arange(st, dtype=torch.int32, device=dev
                                 )[None].expand(bsz, st)
    new = {n: [] for n in ("k", "v", "ck", "cv")}

    def layer(i, bp, x, memory):
        # causal self-attention (cached in decode)
        h = rms_norm(x, bp["ln1"])
        q, k, v = _qkv(bp["self"], h, cfg, positions)
        if mode == "decode":
            kc, vc = cache["dec"]["k"][i], cache["dec"]["v"][i]
            kc[rows, posv.long()] = k[:, 0].to(kc.dtype)
            vc[rows, posv.long()] = v[:, 0].to(vc.dtype)
            o = attn_mod.naive_attention(q, kc, vc, ap_self, q_offset=posv,
                                         kv_valid_len=posv + 1)
            ck, cv = cache["dec"]["ck"][i], cache["dec"]["cv"][i]
        else:
            o = attn_mod.attention(q, k, v, ap_self)
            ck, cv = _cross_kv(bp["cross"], memory, cfg)
            if mode == "prefill":
                for n, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
                    new[n].append(t)
        x = x + _proj_out(bp["self"], o, cfg)
        # cross-attention over the encoder memory
        h = rms_norm(x, bp["lnx"])
        qx = _heads(h, bp["cross"]["wq"], cfg.num_heads, hd)
        x = x + _proj_out(bp["cross"], attn_mod.attention(qx, ck, cv,
                                                          ap_cross), cfg)
        # FFN
        h = rms_norm(x, bp["ln2"])
        return x + mlp_mod.apply(bp["mlp"], h, cfg.activation)

    for i in range(cfg.num_layers):
        x = _remat(_layer_remat(flags), layer, i, _pick(params["dec"], i), x,
                   memory)
    x = rms_norm(x, params["final_norm"])
    if mode == "decode":
        return x, cache
    if mode == "train":
        return x, None
    return x, dict(dec={n: torch.stack(ts) for n, ts in new.items()})


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"][tokens.long()]


def train_loss(params, cfg: ModelConfig, flags: RuntimeFlags, batch: dict):
    """``batch["frames"]`` (B, Se, d), ``batch["dec_tokens"]`` (B, St),
    ``batch["labels"]`` (B, St) -> (cross-entropy, dict(ce=, aux=)), with
    the graph kept for autograd; ``aux`` is a float32 zero (no MoE).
    With a mesh of more than one device in ``flags`` it runs over the
    mesh's data rows (:func:`repro_torch.models.sharded.train_loss`)."""
    if flags.mesh is not None and len(flags.mesh.devices) > 1:
        from repro_torch.models import sharded
        return sharded.train_loss(params, cfg, flags, batch)
    memory = encode(params, cfg, flags, batch["frames"])
    x = _embed(params, batch["dec_tokens"])
    x, _ = _decoder(params, cfg, flags, x, memory=memory, mode="train")
    loss = chunked_ce(params, cfg, x, batch["labels"], flags)
    return loss, dict(ce=loss, aux=torch.zeros((), dtype=torch.float32,
                                               device=loss.device))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, flags: RuntimeFlags, batch: dict):
    """``batch["frames"]`` (B, Se, d) and ``batch["dec_tokens"]`` (B, St)
    -> (split cache: ``k``/``v`` (L, B, St, Hkv, D), ``ck``/``cv`` (L, B,
    Se, Hkv, D); last logits (B, V))."""
    memory = encode(params, cfg, flags, batch["frames"])
    x = _embed(params, batch["dec_tokens"])
    x, cache = _decoder(params, cfg, flags, x, memory=memory, mode="prefill")
    return cache, compute_logits(params, cfg, x[:, -1:])[:, 0]


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, flags: RuntimeFlags, cache: dict,
                tokens, pos):
    """One decode tick on the split cache.  tokens: (B, 1); pos: scalar or
    (B,) per-slot positions.  Returns (logits (B, V), cache)."""
    x = _embed(params, tokens)
    x, cache = _decoder(params, cfg, flags, x, cache=cache, pos=pos,
                        mode="decode")
    return compute_logits(params, cfg, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device) -> dict:
    """The split decode cache, zeros in the compute dtype: self ``k``/``v``
    (L, batch, max_len, Hkv, D), cross ``ck``/``cv`` (L, batch, enc_len,
    Hkv, D)."""
    dtype = dtype_of(cfg.compute_dtype)
    nd, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    return dict(dec={
        n: torch.zeros((nd, batch, t, hkv, hd), dtype=dtype, device=device)
        for n, t in (("k", max_len), ("v", max_len), ("ck", enc_len),
                     ("cv", enc_len))})
