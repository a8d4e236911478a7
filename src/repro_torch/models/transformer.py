"""Decoder-only LM, ATTN + DENSE stacks (full attention and sliding
windows), on a dense or a paged KV cache.

The port of ``repro.models.transformer`` for these stacks, four modes:

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

``kv_dtype="int8"`` stores k/v as int8 with a float32 scale per token
(:func:`_kv_quant`): dense caches in ``k_scale``/``v_scale`` (B, T) lanes,
page pools in (P, page) lanes that K1 dequantizes.  Attention over the
chunk being written uses the quantize -> dequantize round trip, so one-shot
and chunked prefill agree with what decode reads back.

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
    """Execution knobs (never affect math, except ``kv_dtype``'s
    quantization).  ``attn_impl`` picks the attention of full-sequence
    prefill (naive | chunked | pallas); ``attn_bq``/``attn_bkv`` pin
    chunked's blocks (None = the tuned plan's,
    :func:`repro_torch.models.attention.resolve_blocks`); the CUDA kernel
    behind ``pallas`` picks its own tiles.  ``kv_dtype="int8"`` stores the
    KV cache as int8 with a float32 scale per token."""

    attn_impl: str = "chunked"
    attn_bq: Optional[int] = None
    attn_bkv: Optional[int] = None
    kv_dtype: str = "native"         # native | int8


KV_DTYPES = ("native", "int8")


def check_supported(cfg: ModelConfig,
                    flags: Optional[RuntimeFlags] = None) -> None:
    """The port serves ATTN + DENSE decoders (full attention and sliding
    windows) with a cache in the compute dtype or in int8; raise on
    anything else rather than compute something else."""
    if flags is not None:
        if flags.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {flags.kv_dtype!r}; known: "
                             f"{KV_DTYPES}")
        if flags.attn_impl not in attn_mod.IMPLS:
            raise ValueError(f"unknown attn_impl {flags.attn_impl!r}; known: "
                             f"{sorted(attn_mod.IMPLS)}")
    if cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend stacks are not ported")
    for spec in tuple(cfg.layer_pattern) + tuple(cfg.remainder_specs):
        if spec.mixer != ATTN or spec.mlp != DENSE:
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} is not ported (ATTN + DENSE "
                "layers only)")


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


SENTINEL = -10 ** 9     # the position of an empty ring row


def _kv_quant(x: torch.Tensor):
    """(B, S, H, D) -> (int8 values, per-token float32 scale (B, S)):
    the scale is the token's largest magnitude over 127 (at least
    1e-6 / 127), values rounded half to even and clipped to +-127."""
    xf = x.float()
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


def _stacked(cfg: ModelConfig, make) -> dict:
    """A cache tree: ``make(spec, lead)`` for every pattern position (lead
    = (LAYERS,)) and every remainder layer (lead = ())."""
    nb = cfg.num_pattern_blocks
    return dict(blocks={f"p{j}": make(spec, (nb,))
                        for j, spec in enumerate(cfg.layer_pattern)},
                rem={f"r{j}": make(spec, ())
                     for j, spec in enumerate(cfg.remainder_specs)})


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               kv_dtype: str = "native") -> dict:
    """Dense decode cache, stacked on LAYERS like the params: per layer
    ``k``/``v`` of shape (batch, T, Hkv, D) with T = max_len, or
    ``min(window, max_len)`` ring rows and a ``kpos`` (batch, T) int32
    lane (``-10**9`` = empty) for a windowed layer; int8 adds float32
    ``k_scale``/``v_scale`` (batch, T) lanes."""
    check_supported(cfg)
    kvd = _kv_store_dtype(cfg, kv_dtype)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def make(spec: LayerSpec, lead):
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
                     kv_dtype: str = "native") -> dict:
    """Per-layer page pools ``k_pages``/``v_pages`` of shape
    (P, page, Hkv, D), stacked on LAYERS like the params.  Full-attention
    layers share the ``num_pages`` pool's ids, windowed layers the
    ``ring_pages`` pool's (default: ``num_pages``): one host-side allocator
    and table for each kind.  int8 adds float32 ``k_scale``/``v_scale``
    (P, page) lanes."""
    check_supported(cfg)
    kvd = _kv_store_dtype(cfg, kv_dtype)
    ring_pages = ring_pages or num_pages
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def make(spec: LayerSpec, lead):
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


def _paged_attn(q, k, v, cache, ap: AttnParams, spec: LayerSpec, pos, table,
                chunk_valid, cfg: ModelConfig, flags: RuntimeFlags,
                mode: str):
    """The paged-cache mixer body (both paged modes).

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
    never touch live data."""
    bsz, s = q.shape[:2]
    page = cache["k_pages"].shape[1]
    ring = spec.sliding_window is not None
    tbl = table["ring"] if ring else table["full"]
    n = tbl.shape[1]
    dev = q.device
    posv = pos.reshape(-1).to(torch.int32).expand(bsz)
    positions = (posv[:, None]
                 + torch.arange(s, dtype=torch.int32, device=dev)[None, :])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if chunk_valid is None:
        valid = torch.full((bsz,), s, dtype=torch.int32, device=dev)
    else:
        valid = chunk_valid.reshape(-1).to(torch.int32).expand(bsz)
    in_chunk = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
                < valid[:, None])
    writable = in_chunk
    if ring:
        pidx = torch.remainder(positions // page, n).long()
        if s > 1:
            # a chunk wider than the ring would write two logical pages
            # through one slot; only the trailing (R-1) pages of positions
            # can matter to a later query ((R-1)*page >= window), and they
            # cannot alias: older ones go to the null page
            end = (posv + valid)[:, None]
            writable = in_chunk & (positions >= end - (n - 1) * page)
    else:
        pidx = torch.clamp(positions // page, max=n - 1).long()
    rows = torch.arange(bsz, device=dev)[:, None]
    pids = torch.where(writable, tbl.long()[rows, pidx], 0)
    slots = torch.where(writable, (positions % page).long(), 0)

    int8kv = flags.kv_dtype == "int8"
    if int8kv:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
    else:
        kq, vq = k, v

    if mode != "paged_decode" and ring:
        if int8kv:
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
    if int8kv:
        k_scale, v_scale = cache["k_scale"], cache["v_scale"]
        k_scale[pids, slots] = ks
        v_scale[pids, slots] = vs

    if mode == "paged_decode":
        o = kops.paged_attention(q[:, 0], kp, vp, tbl, posv + 1,
                                 scale=ap.scale, softcap=ap.softcap,
                                 window=spec.sliding_window, k_scale=k_scale,
                                 v_scale=v_scale)[:, None]
    elif not ring:
        o = paged_gather_attention(q, kp, vp, tbl, ap, q_offset=posv,
                                   kv_valid_len=posv + valid,
                                   k_scale=k_scale, v_scale=v_scale)
    return o


def _dense_attn(q, k, v, cache, ap: AttnParams, spec: LayerSpec, pos,
                cfg: ModelConfig, flags: RuntimeFlags, mode: str):
    """The dense-cache mixer body.  Decode writes each slot's k/v into its
    cache row at its own position (a windowed layer at ``pos % rows`` of
    its ring, recording the position in ``kpos``), then attends over the
    row; prefill attends over the whole (right-padded) sequence through
    ``ap.impl`` and hands back the request's cache (a windowed layer's
    last ``window`` rows and their positions)."""
    bsz, s = q.shape[:2]
    dev = q.device
    int8kv = flags.kv_dtype == "int8"
    if mode == "decode":
        posv = torch.as_tensor(pos, dtype=torch.int32, device=dev
                               ).reshape(-1).expand(bsz)
        q = rope(q, posv[:, None], cfg.rope_theta)
        k = rope(k, posv[:, None], cfg.rope_theta)
        if int8kv:
            kq, ks = _kv_quant(k)
            vq, vs = _kv_quant(v)
        else:
            kq, vq = k, v
        rows = torch.arange(bsz, device=dev)
        kc, vc = cache["k"], cache["v"]
        ring = spec.sliding_window is not None
        idx = (torch.remainder(posv, kc.shape[1]) if ring else posv).long()
        kc[rows, idx] = kq[:, 0].to(kc.dtype)
        vc[rows, idx] = vq[:, 0].to(vc.dtype)
        if ring:
            cache["kpos"][rows, idx] = posv
        if int8kv:
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
    positions = torch.arange(s, dtype=torch.int32, device=dev
                             )[None].expand(bsz, s)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if int8kv:
        # prefill attends over the round trip it stores, so its logits
        # agree with decode and with paged chunked prefill
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
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
    if int8kv:
        new.update(k=kq[:, sl], k_scale=ks[:, sl], v=vq[:, sl],
                   v_scale=vs[:, sl])
    else:
        new.update(k=k[:, sl], v=v[:, sl])
    return o, new


def _apply_attn(p, x, cfg: ModelConfig, spec: LayerSpec, flags: RuntimeFlags,
                mode, cache, pos, table, chunk_valid):
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(bsz, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    ap = _attn_params(cfg, spec, flags)
    if mode in ("paged_decode", "paged_extend"):
        o = _paged_attn(q, k, v, cache, ap, spec, pos, table, chunk_valid,
                        cfg, flags, mode)
    else:
        o, cache = _dense_attn(q, k, v, cache, ap, spec, pos, cfg, flags,
                               mode)
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
    ``table``/``chunk_valid`` only apply to the paged modes: ``table`` is
    ``{"full": (B, N), "ring": (B, R)}`` (a bare (B, N) table serves a
    stack without windowed layers)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the port runs {MODES}")
    if table is not None and not isinstance(table, dict):
        table = dict(full=table)
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
                                    for n in cs[0]}
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
    """One decode tick against the page pools.  tokens: (B, 1); pos: (B,)
    per-slot positions; table: ``{"full": (B, N), "ring": (B, R)}`` int32
    page tables (padded entries -> the null page; windowed layers read the
    ring table, full-attention layers the full one).  Every attention
    layer appends k/v through its table and runs the ``paged_attention``
    kernel.  Returns (logits (B, V), cache)."""
    x, cache = forward(params, cfg, flags, tokens, "paged_decode", cache, pos,
                       table)
    return compute_logits(params, cfg, x)[:, 0], cache


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, flags: RuntimeFlags,
                        cache: dict, tokens, pos, table, chunk_valid):
    """One chunked-prefill step: ``tokens`` (B, C) is a prompt chunk
    (right-padded to a bucket; ``chunk_valid`` (B,) marks its true length)
    at absolute offset ``pos`` (B,).  Appends the chunk's k/v into the
    pages (full tables and rotating ring tables alike) and returns (cache,
    logits at the chunk's last valid position)."""
    x, cache = forward(params, cfg, flags, tokens, "paged_extend", cache, pos,
                       table, chunk_valid)
    bsz = x.shape[0]
    idx = chunk_valid.reshape(-1).long().expand(bsz) - 1
    last = x[torch.arange(bsz, device=x.device), idx][:, None]
    return cache, compute_logits(params, cfg, last)[:, 0]


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
    page = next(layer["k_pages"].shape[-3] for part in ("blocks", "rem")
                for layer in cache[part].values())
    if plan is not None and plan.page_size != page:
        raise ValueError(f"verify plan pages of {plan.page_size} tokens, "
                         f"the pool's hold {page}")
    x, cache = forward(params, cfg, flags, tokens, "paged_extend", cache, pos,
                       table, chunk_valid)
    return cache, compute_logits(params, cfg, x)
