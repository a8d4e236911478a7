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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def forward(p, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
            state: Optional[SSDState] = None):
    """x: (B, S, d) -> (B, S, d) [, SSDState].  ``state`` continues a
    previous segment (chunked prefill): the conv reads its trailing inputs
    and the chunk-state scan is seeded with ``state.state``, which is one
    unbroken sequence's result."""
    bsz, orig_s, _ = x.shape
    d_in, h, hp, n = dims(cfg)
    q = min(cfg.ssm_chunk, orig_s)
    pad = (-orig_s) % q

    z, xbc, dt = _split(p, x, cfg)
    conv_prev = None if state is None else state.conv
    conv_state = conv_state_from(xbc, cfg.ssm_conv_width, prev=conv_prev)
    xbc = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                               state=conv_prev))
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=PAD_DT)
    s = orig_s + pad
    nc = s // q
    xs = xbc[..., :d_in].reshape(bsz, s, h, hp)
    bmat = xbc[..., d_in:d_in + n]
    cmat = xbc[..., d_in + n:]

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
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldec = torch.where(tri[None, None, :, :, None], ldec, 0.0)
    y_diag = torch.einsum("bclsh,bcshp->bclhp", scores[..., None] * ldec, xc)

    # each chunk's terminal state, then their prefix through the scan
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)          # (B, C, Q, H)
    states_loc = torch.einsum("bcsn,bcshp->bchpn", bc,
                              decay_states[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B, C, H)
    dec_all, st_all = associative_scan(_chunk_states,
                                       (chunk_decay, states_loc), dim=1)
    if state is not None:
        h0 = state.state[:, None]                              # (B,1,H,P,N)
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
    y = y.reshape(bsz, s, d_in)[:, :orig_s].to(x.dtype)
    out = _gated_out(p, y, z)
    if return_state:
        return out, SSDState(state=st_all[:, -1], conv=conv_state)
    return out


def decode_step(p, x: torch.Tensor, st: SSDState, cfg: ModelConfig):
    """x: (B, 1, d) -> ((B, 1, d), the next SSDState)."""
    bsz = x.shape[0]
    d_in, h, hp, n = dims(cfg)
    z, xbc, dt = _split(p, x, cfg)
    conv_state = conv_state_from(xbc, cfg.ssm_conv_width, prev=st.conv)
    xbc = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                               state=st.conv))
    xs = xbc[:, 0, :d_in].reshape(bsz, h, hp)
    bvec = xbc[:, 0, d_in:d_in + n].float()
    cvec = xbc[:, 0, d_in + n:].float()

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)                                     # (B, H)
    xdt = xs.float() * dt[..., None]
    state = (st.state * da[..., None, None]
             + xdt[..., None] * bvec[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cvec, state)
    y = y + p["d_skip"].float()[None, :, None] * xs.float()
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    return _gated_out(p, y, z), SSDState(state=state, conv=conv_state)
