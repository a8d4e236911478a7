"""Mamba-2's SSD (state-space duality) mixer [arXiv:2405.21060].

The port of ``repro.models.ssm``: the chunked algorithm with one group,
following ``ssd_minimal_discrete``:

- inside each chunk of Q tokens, the quadratic dual: attention-like
  scores ``C B^T`` weighted by the decay matrix ``L[l, s] = exp(cum[l] -
  cum[s])`` for l >= s;
- across chunks, each chunk's terminal state, combined by a log-depth
  :func:`~repro_torch.models.scan.associative_scan`; a carried-in state
  (chunked prefill) is folded in through every chunk's cumulative decay;
- a sequence that is not a multiple of Q is padded with identity steps:
  dt is -1e9 there, so its softplus is 0 (decay 1, input 0) and outputs
  and final state are exact.

The inside runs in float32 and the output is cast to the input's dtype;
``y`` passes through the gated norm ``rms_norm(y * silu(z), norm - 1)``.
Decode is one recurrent state update.

Over a tensor-parallel group (:func:`forward_tp`, :func:`decode_step_tp`)
each shard computes a contiguous block of the heads; see
:func:`_over_heads` for what crosses between shards.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp
from repro_torch.models.common import (CONV, EMBED, FF, HEADS, LAYERS,
                                       ParamBuilder, causal_conv1d,
                                       conv_state_from, rms_norm)
from repro_torch.models.scan import associative_scan

PAD_DT = -1e9            # softplus(PAD_DT + bias) == 0: an identity step


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state size)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


def init(b: ParamBuilder, path: str, cfg: ModelConfig, stacked: int = 0):
    d = cfg.d_model
    d_in, h, _, n = dims(cfg)
    lead = (stacked,) if stacked else ()
    la = (LAYERS,) if stacked else ()
    b.dense(f"{path}.w_in", lead + (d, 2 * d_in + 2 * n + h),
            la + (EMBED, FF))
    b.dense(f"{path}.conv_w", lead + (cfg.ssm_conv_width, d_in + 2 * n),
            la + (CONV, FF), scale=0.5)
    b.zeros(f"{path}.conv_b", lead + (d_in + 2 * n,), la + (FF,))
    b.const(f"{path}.a_log", torch.zeros(lead + (h,)), la + (HEADS,))
    b.ones(f"{path}.d_skip", lead + (h,), la + (HEADS,))
    b.zeros(f"{path}.dt_bias", lead + (h,), la + (HEADS,))
    b.ones(f"{path}.norm", lead + (d_in,), la + (FF,))
    b.dense(f"{path}.w_out", lead + (d_in, d), la + (FF, EMBED))


def _split(p, x: torch.Tensor, cfg: ModelConfig):
    """The input projection's (z, x|B|C, dt) parts."""
    d_in, _, _, n = dims(cfg)
    zxbcdt = x @ p["w_in"]
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n],
            zxbcdt[..., 2 * d_in + 2 * n:])


class SSDState(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) float32
    conv: torch.Tensor    # (B, K-1, d_in + 2N), the compute dtype



def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device, lead=()) -> SSDState:
    d_in, h, hp, n = dims(cfg)
    return SSDState(
        state=torch.zeros(lead + (batch, h, hp, n), dtype=torch.float32,
                          device=device),
        conv=torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, d_in + 2 * n),
                         dtype=dtype, device=device))


def _chunk_states(left, right):
    """Compose two chunks' (decay, terminal state): left first."""
    dl, sl = left
    dr, sr = right
    return dl * dr, sr + dr[..., None, None] * sl


def _gated_out(p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = rms_norm(y * F.silu(z), p["norm"] - 1.0)
    return y @ p["w_out"]


def _conv(p, xbc: torch.Tensor, prev: Optional[torch.Tensor]):
    return F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"], state=prev))


def _chunked(p, xbc: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig,
             h0: Optional[torch.Tensor]):
    """The chunked SSD over the heads of ``p`` (its ``a_log``, ``d_skip``
    and ``dt_bias``: all of them, or one shard's): ``xbc`` (B, S, H'P +
    2N) after the conv, ``dt`` (B, S, H') raw, ``h0`` a carried state
    (B, H', P, N) or None.  Returns (y (B, S, H'P) float32, the final
    state)."""
    bsz, orig_s, _ = xbc.shape
    _, _, hp, n = dims(cfg)
    h = dt.shape[-1]
    d_loc = h * hp
    q = min(cfg.ssm_chunk, orig_s)
    pad = (-orig_s) % q
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=PAD_DT)
    s = orig_s + pad
    nc = s // q
    xs = xbc[..., :d_loc].reshape(bsz, s, h, hp)
    bmat = xbc[..., d_loc:d_loc + n]
    cmat = xbc[..., d_loc + n:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    da = dt * a                                     # (B, S, H) log-decay
    xdt = xs.float() * dt[..., None]                # discretized input

    xc = xdt.reshape(bsz, nc, q, h, hp)
    dac = da.reshape(bsz, nc, q, h)
    bc = bmat.float().reshape(bsz, nc, q, n)
    cc = cmat.float().reshape(bsz, nc, q, n)

    cum = torch.cumsum(dac, dim=2)                  # (B, C, Q, H)
    # inside each chunk: the quadratic dual
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)
    ldec = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xbc.device))
    ldec = torch.where(tri[None, None, :, :, None], ldec, 0.0)
    y_diag = torch.einsum("bclsh,bcshp->bclhp", scores[..., None] * ldec, xc)

    # each chunk's terminal state, then their prefix through the scan
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)          # (B, C, Q, H)
    states_loc = torch.einsum("bcsn,bcshp->bchpn", bc,
                              decay_states[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B, C, H)
    dec_all, st_all = associative_scan(_chunk_states,
                                       (chunk_decay, states_loc), dim=1)
    if h0 is not None:
        h0 = h0[:, None]                                       # (B,1,H,P,N)
        st_all = st_all + dec_all[..., None, None] * h0
        prev = torch.cat([h0, st_all[:, :-1]], dim=1)
    else:
        prev = torch.cat([torch.zeros_like(st_all[:, :1]), st_all[:, :-1]],
                         dim=1)

    # across chunks: the carried states read through C
    y_off = (torch.einsum("bcln,bchpn->bclhp", cc, prev)
             * torch.exp(cum)[..., None])

    y = (y_diag + y_off).reshape(bsz, s, h, hp)
    y = y + p["d_skip"].float()[None, None, :, None] * xs.float()
    return y.reshape(bsz, s, d_loc)[:, :orig_s], st_all[:, -1]


def _recur(p, xbc: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig,
           st: torch.Tensor):
    """:func:`_chunked` of one token, continuing ``st`` (B, H', P, N)."""
    bsz = xbc.shape[0]
    _, _, hp, n = dims(cfg)
    h = dt.shape[-1]
    d_loc = h * hp
    xs = xbc[:, 0, :d_loc].reshape(bsz, h, hp)
    bvec = xbc[:, 0, d_loc:d_loc + n].float()
    cvec = xbc[:, 0, d_loc + n:].float()

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)                                     # (B, H)
    xdt = xs.float() * dt[..., None]
    state = (st * da[..., None, None]
             + xdt[..., None] * bvec[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cvec, state)
    y = y + p["d_skip"].float()[None, :, None] * xs.float()
    return y.reshape(bsz, 1, d_loc), state


def forward(p, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
            state: Optional[SSDState] = None):
    """x: (B, S, d) -> (B, S, d) [, SSDState].  ``state`` continues a
    previous segment (chunked prefill): the conv reads its trailing inputs
    and the chunk-state scan is seeded with ``state.state``, which is one
    unbroken sequence's result."""
    z, xbc, dt = _split(p, x, cfg)
    conv_prev = None if state is None else state.conv
    conv_state = conv_state_from(xbc, cfg.ssm_conv_width, prev=conv_prev)
    y, st = _chunked(p, _conv(p, xbc, conv_prev), dt, cfg,
                     None if state is None else state.state)
    out = _gated_out(p, y.to(x.dtype), z)
    if return_state:
        return out, SSDState(state=st, conv=conv_state)
    return out


def decode_step(p, x: torch.Tensor, st: SSDState, cfg: ModelConfig):
    """x: (B, 1, d) -> ((B, 1, d), the next SSDState)."""
    z, xbc, dt = _split(p, x, cfg)
    conv_state = conv_state_from(xbc, cfg.ssm_conv_width, prev=st.conv)
    y, state = _recur(p, _conv(p, xbc, st.conv), dt, cfg, st.state)
    return (_gated_out(p, y.to(x.dtype), z),
            SSDState(state=state, conv=conv_state))


# ---------------------------------------------------------------------------
# tensor parallelism: each shard a contiguous block of the heads
# ---------------------------------------------------------------------------

def _over_heads(ps, xs, cfg: ModelConfig, g, states, to, step: bool):
    """The mixer on every shard's heads ``[lo, hi)``
    (:func:`~repro_torch.dist.tp.span`: the policy's blocks where the
    shards divide the heads, else as even as they go), continuing
    ``states`` (each shard's whole copy, or the first shard's alone with
    None for the others; None from zeros).

    - The input projection is column-parallel: each shard projects its
      share of the columns (the policy's block, or its span of a ``w_in``
      left whole).  ``[z | x B C | dt]`` is not cut at head boundaries
      (mamba2-130m's 3352 columns halve inside ``x``), so each shard then
      takes its heads' ``z``, ``x`` and ``dt`` and the ``B`` and ``C``
      that every head reads from the shards that projected them
      (``ssd regroup``).
    - The conv's channels ``x|B|C`` are not stored by heads either: each
      shard reads the conv weights of its heads' channels and of B and C
      (``ssd params``, copied where another shard holds them) and
      convolves them; B and C are convolved on every shard.
    - The gated RMS norm spans the whole inner width: the shards' sums of
      squares add on the first shard and come back (``ssd norm``).
    - ``w_out`` is row-parallel over the heads' rows (read as ``ssd
      params`` where its blocks are not head-aligned): its partials add
      on the first shard (``ssd out``), and the new state's heads and
      conv channels are gathered on every shard of ``to`` (``ssd
      state``).

    Returns (out on the first shard, [the whole new SSDState on each
    shard of ``to``, None elsewhere])."""
    d_in, h, hp, n = dims(cfg)
    cols = 2 * d_in + 2 * n + h
    conv_cols = d_in + 2 * n
    heads = [tp.span(h, g.n, s) for s in range(g.n)]

    def param(name, full, lo, hi, s, dim=-1):
        return tp.take(g, [q[name] for q in ps], full, dim, lo, hi, s,
                       "ssd params")

    parts = []
    for s in range(g.n):
        with g.on(s):
            parts.append(xs[s] @ param("w_in", cols, *tp.span(cols, g.n, s),
                                       s))
    to = range(g.n) if to is None else to
    us, sqs, sts, convs = [], [], [], []
    for s, (lo, hi) in enumerate(heads):
        with g.on(s):
            x0, x1 = lo * hp, hi * hp

            def cols_of(a, b):
                return tp.take(g, parts, cols, -1, a, b, s, "ssd regroup")

            def mine(t):
                """Shard s's channels of x|B|C: its heads' x, B and C."""
                return torch.cat([t[..., x0:x1], t[..., d_in:]], dim=-1)

            z = cols_of(x0, x1)
            xbc = torch.cat([cols_of(d_in + x0, d_in + x1),
                             cols_of(2 * d_in, 2 * d_in + 2 * n)], dim=-1)
            dt = cols_of(2 * d_in + 2 * n + lo, 2 * d_in + 2 * n + hi)
            q = {name: torch.cat([param(name, conv_cols, x0, x1, s),
                                  param(name, conv_cols, d_in, conv_cols, s)],
                                 dim=-1)
                 for name in ("conv_w", "conv_b")}
            for name in ("a_log", "d_skip", "dt_bias"):
                q[name] = param(name, h, lo, hi, s)
            conv_prev = h0 = None
            if states is not None:
                conv = [None if st is None else st.conv for st in states]
                conv_prev = torch.cat(
                    [tp.local(g, conv, s, -1, x0, x1, "ssd state"),
                     tp.local(g, conv, s, -1, d_in, conv_cols, "ssd state")],
                    dim=-1)
                h0 = tp.local(g, [None if st is None else st.state
                                  for st in states], s, 1, lo, hi,
                              "ssd state")
            convs.append(conv_state_from(xbc, cfg.ssm_conv_width,
                                         prev=conv_prev))
            xbc = _conv(q, xbc, conv_prev)
            if step:
                y, st = _recur(q, xbc, dt, cfg, h0)
            else:
                y, st = _chunked(q, xbc, dt, cfg, h0)
            u = (y.to(xs[s].dtype) * F.silu(z)).float()
            us.append(u)
            sqs.append(torch.sum(u * u, dim=-1, keepdim=True))
            sts.append(st)
    # rms_norm over the whole inner width: the mean of squares from the
    # shards' sums
    var = tp.broadcast(g, tp.reduce_sum(g, sqs, "ssd norm") / d_in,
                       "ssd norm")
    outs = []
    for s, (lo, hi) in enumerate(heads):
        with g.on(s):
            w = param("norm", d_in, lo * hp, hi * hp, s) - 1.0
            y = (us[s] * torch.rsqrt(var[s] + 1e-6)
                 * (1.0 + w.float())).to(xs[s].dtype)
            outs.append(y @ param("w_out", d_in, lo * hp, hi * hp, s, 0))
    out = tp.reduce_sum(g, outs, "ssd out")
    state = tp.all_gather(g, sts, 1, "ssd state", to)
    # the conv state: the shards' x channels in order, then B and C
    # (the same on every shard)
    xconv = tp.all_gather(g, [c[..., :(hi - lo) * hp]
                              for c, (lo, hi) in zip(convs, heads)], -1,
                          "ssd state", to)
    return out, [None if st is None else
                 SSDState(state=st, conv=torch.cat(
                     [xc, convs[s][..., (heads[s][1] - heads[s][0]) * hp:]],
                     dim=-1))
                 for s, (st, xc) in enumerate(zip(state, xconv))]


def forward_tp(ps, xs, cfg: ModelConfig, g, return_state: bool = False,
               states=None, to=None):
    """:func:`forward` over a tensor-parallel group ``g``
    (:mod:`repro_torch.dist.tp`): shard s holds ``ps[s]`` and its copy of
    the input ``xs[s]`` (B, S, d); continuing a segment, ``states[s]`` is
    its whole copy of the state, or None where only the first shard
    holds one.  Returns (out (B, S, d) on the first shard, the whole new
    state on every shard of ``to`` (default: all; None for the others),
    or None without ``return_state``)."""
    out, new = _over_heads(ps, xs, cfg, g, states,
                           to if return_state else (), False)
    return out, new if return_state else None


def decode_step_tp(ps, xs, states, cfg: ModelConfig, g, to=None):
    """:func:`decode_step` over a tensor-parallel group, as
    :func:`forward_tp`: (out on the first shard, the new states)."""
    return _over_heads(ps, xs, cfg, g, states, to, True)
