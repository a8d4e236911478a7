"""Griffin's RG-LRU recurrent block [arXiv:2402.19427] (recurrentgemma).

The port of ``repro.models.rglru``.  Two branches from the residual
stream:

  gate branch:      linear(d -> w) -> GeLU (tanh form)
  recurrent branch: linear(d -> w) -> causal conv1d (K=4) -> RG-LRU
  merged:           (gate * lru_out) @ W_out

RG-LRU, per channel:

  r_t = sigmoid(BD_a(x_t));  i_t = sigmoid(BD_x(x_t))
  log a_t = -c * softplus(Lambda) * r_t          (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

BD_* are block-diagonal linears of 8 blocks.  Over a sequence the
recurrence is a log-depth :func:`~repro_torch.models.scan.associative_scan`;
decode is one step.  The gates and ``h`` are float32; ``h`` is cast to the
compute dtype before the gate product.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (CONV, EMBED, FF, LAYERS,
                                       ParamBuilder, causal_conv1d,
                                       conv_state_from)
from repro_torch.models.scan import associative_scan

C_FACTOR = 8.0
N_BLOCKS = 8
CONV_WIDTH = 4


def width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def init(b: ParamBuilder, path: str, cfg: ModelConfig, stacked: int = 0):
    d, w = cfg.d_model, width(cfg)
    lead = (stacked,) if stacked else ()
    la = (LAYERS,) if stacked else ()
    blk = w // N_BLOCKS
    b.dense(f"{path}.w_gate_in", lead + (d, w), la + (EMBED, FF))
    b.dense(f"{path}.w_rec_in", lead + (d, w), la + (EMBED, FF))
    b.dense(f"{path}.conv_w", lead + (CONV_WIDTH, w), la + (CONV, FF),
            scale=0.5)
    b.zeros(f"{path}.conv_b", lead + (w,), la + (FF,))
    b.dense(f"{path}.bd_a", lead + (N_BLOCKS, blk, blk), la + (None, FF, None))
    b.zeros(f"{path}.bd_a_bias", lead + (w,), la + (FF,))
    b.dense(f"{path}.bd_x", lead + (N_BLOCKS, blk, blk), la + (None, FF, None))
    b.zeros(f"{path}.bd_x_bias", lead + (w,), la + (FF,))
    # Lambda such that a^c spans about (0.9, 0.999), as in the paper
    b.const(f"{path}.lam", torch.full(lead + (w,), 0.66), la + (FF,))
    b.dense(f"{path}.w_out", lead + (w, d), la + (FF, EMBED))


class LRUState(NamedTuple):
    h: torch.Tensor       # (B, w) float32
    conv: torch.Tensor    # (B, 3, w), the compute dtype



def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device, lead=()) -> LRUState:
    w = width(cfg)
    return LRUState(
        h=torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (batch, CONV_WIDTH - 1, w), dtype=dtype,
                         device=device))


def _block_diag(x: torch.Tensor, wmat: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x: (..., w) with w = NB * blk; wmat: (NB, blk, blk)."""
    nb, blk, _ = wmat.shape
    xb = x.reshape(x.shape[:-1] + (nb, blk))
    out = torch.einsum("...nb,nbc->...nc", xb, wmat)
    return out.reshape(x.shape) + bias


def _gates(p, xr: torch.Tensor):
    """(a, gated input), both float32; xr (..., w)."""
    r = torch.sigmoid(_block_diag(xr, p["bd_a"], p["bd_a_bias"]).float())
    i = torch.sigmoid(_block_diag(xr, p["bd_x"], p["bd_x_bias"]).float())
    log_a = -C_FACTOR * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xr.float())
    return a, gated


def _branches(p, x: torch.Tensor, conv_prev: Optional[torch.Tensor]):
    """(gate, conv state to carry, a, gated input) of a segment."""
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    xr = x @ p["w_rec_in"]
    conv_state = conv_state_from(xr, CONV_WIDTH, prev=conv_prev)
    xr = causal_conv1d(xr, p["conv_w"], p["conv_b"], state=conv_prev)
    a, gated = _gates(p, xr)
    return gate, conv_state, a, gated


def _affine(left, right):
    """Compose two steps h -> a h + b: left first."""
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def forward(p, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
            state: Optional[LRUState] = None):
    """x: (B, S, d) -> (B, S, d) [, LRUState].  ``state`` continues a
    previous segment (chunked prefill): the conv reads its trailing inputs
    and the scan folds ``state.h`` in through the cumulative decay, which
    is one unbroken sequence's result."""
    gate, conv_state, a, gated = _branches(
        p, x, None if state is None else state.conv)
    cum_a, h = associative_scan(_affine, (a, gated), dim=1)
    if state is not None:
        h = h + cum_a * state.h[:, None]
    hlast = h[:, -1]
    out = (gate * h.to(x.dtype)) @ p["w_out"]
    if return_state:
        return out, LRUState(h=hlast.float(), conv=conv_state)
    return out


def decode_step(p, x: torch.Tensor, st: LRUState, cfg: ModelConfig):
    """x: (B, 1, d) -> ((B, 1, d), the next LRUState)."""
    gate, conv_state, a, gated = _branches(p, x, st.conv)
    h = a[:, 0] * st.h + gated[:, 0]
    out = (gate * h[:, None].to(x.dtype)) @ p["w_out"]
    return out, LRUState(h=h, conv=conv_state)
