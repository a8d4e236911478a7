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
from repro_torch.dist import tp
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


def _lru_gates(ra: torch.Tensor, ix: torch.Tensor, lam: torch.Tensor,
               xr: torch.Tensor):
    """(a, gated input), both float32, from the two block-diagonal
    products ``ra``/``ix`` (bias added) of ``xr`` (..., w)."""
    r = torch.sigmoid(ra.float())
    i = torch.sigmoid(ix.float())
    log_a = -C_FACTOR * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xr.float())
    return a, gated


def _gates(p, xr: torch.Tensor):
    """(a, gated input), both float32; xr (..., w)."""
    return _lru_gates(_block_diag(xr, p["bd_a"], p["bd_a_bias"]),
                      _block_diag(xr, p["bd_x"], p["bd_x_bias"]), p["lam"],
                      xr)


def _conv_in(p, x: torch.Tensor, conv_prev: Optional[torch.Tensor]):
    """(gate, the recurrent branch after the conv, the conv state to
    carry), over the width of ``p``'s projections (all of it, or one
    shard's slice)."""
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    xr = x @ p["w_rec_in"]
    conv_state = conv_state_from(xr, CONV_WIDTH, prev=conv_prev)
    xr = causal_conv1d(xr, p["conv_w"], p["conv_b"], state=conv_prev)
    return gate, xr, conv_state


def _branches(p, x: torch.Tensor, conv_prev: Optional[torch.Tensor]):
    """(gate, conv state to carry, a, gated input) of a segment."""
    gate, xr, conv_state = _conv_in(p, x, conv_prev)
    a, gated = _gates(p, xr)
    return gate, conv_state, a, gated


def _affine(left, right):
    """Compose two steps h -> a h + b: left first."""
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def _scan(gate, a, gated, h0: Optional[torch.Tensor], dtype):
    """(gate * h in ``dtype``, the last h (B, w) float32) of a segment
    whose recurrence starts from ``h0`` (None: zeros)."""
    cum_a, h = associative_scan(_affine, (a, gated), dim=1)
    if h0 is not None:
        h = h + cum_a * h0[:, None]
    return gate * h.to(dtype), h[:, -1].float()


def _one(gate, a, gated, h0: torch.Tensor, dtype):
    """:func:`_scan` of one token."""
    h = a[:, 0] * h0 + gated[:, 0]
    return gate * h[:, None].to(dtype), h


def forward(p, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
            state: Optional[LRUState] = None):
    """x: (B, S, d) -> (B, S, d) [, LRUState].  ``state`` continues a
    previous segment (chunked prefill): the conv reads its trailing inputs
    and the scan folds ``state.h`` in through the cumulative decay, which
    is one unbroken sequence's result."""
    gate, conv_state, a, gated = _branches(
        p, x, None if state is None else state.conv)
    y, hlast = _scan(gate, a, gated, None if state is None else state.h,
                     x.dtype)
    out = y @ p["w_out"]
    if return_state:
        return out, LRUState(h=hlast, conv=conv_state)
    return out


def decode_step(p, x: torch.Tensor, st: LRUState, cfg: ModelConfig):
    """x: (B, 1, d) -> ((B, 1, d), the next LRUState)."""
    gate, conv_state, a, gated = _branches(p, x, st.conv)
    y, h = _one(gate, a, gated, st.h, x.dtype)
    return y @ p["w_out"], LRUState(h=h, conv=conv_state)


# ---------------------------------------------------------------------------
# tensor parallelism: each shard a contiguous slice of the width
# ---------------------------------------------------------------------------

def _block_cols(g, ps, s: int, name: str, xin: torch.Tensor, b0: int,
                lo: int, hi: int, blk: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of the block-diagonal product ``name`` on
    shard s, from ``xin``, the inputs of the diagonal blocks from ``b0``
    on that those columns fall in.  The policy's spec ``(None, FF, None)``
    stores the *input rows of every block* split over the shards, so the
    rows of its columns that the other shards hold are copied here
    (``rglru block rows``)."""
    outs = []
    for b in range(lo // blk, (hi - 1) // blk + 1):
        c0, c1 = max(lo, b * blk) - b * blk, min(hi, (b + 1) * blk) - b * blk
        wb = tp.take(g, [q[name][b, :, c0:c1] for q in ps], blk, 0, 0, blk,
                     s, "rglru block rows")
        outs.append(xin[..., (b - b0) * blk:(b - b0 + 1) * blk] @ wb)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return out + tp.take(g, [q[name + "_bias"] for q in ps], blk * N_BLOCKS,
                         -1, lo, hi, s, "rglru params")


def _over_width(ps, xs, cfg: ModelConfig, g, states, to, step: bool):
    """The mixer on every shard's slice ``[lo, hi)`` of the width
    (:func:`~repro_torch.dist.tp.span`), continuing ``states`` (each
    shard's whole copy, or the first shard's alone with None for the
    others; None from zeros).

    - ``w_gate_in``/``w_rec_in``, the conv, ``lam`` and the biases are
      read on the slice: in place where the policy's blocks are the
      slices, else copied (``rglru params``).
    - A gate column reads its whole diagonal block's inputs.  Where a
      slice holds part of a block (the shards do not divide the 8
      blocks), the conv's outputs of the rest of the block are copied
      from the shards that computed them (``rglru block inputs``).
    - ``w_out`` is row-parallel: its partials add on the first shard
      (``rglru out``), and the new state's slices are gathered on every
      shard of ``to`` (``rglru state``).

    Returns (out on the first shard, [the whole new LRUState on each
    shard of ``to``, None elsewhere])."""
    w = width(cfg)
    blk = w // N_BLOCKS
    bounds = [tp.span(w, g.n, s) for s in range(g.n)]

    def state(name, s, lo, hi):
        """Shard s's slice of the carried state's leaf ``name``."""
        if states is None:
            return None
        return tp.local(g, [None if st is None else getattr(st, name)
                            for st in states], s, -1, lo, hi, "rglru state")

    gates, xrs, convs = [], [], []
    for s, (lo, hi) in enumerate(bounds):
        with g.on(s):
            p = {n: tp.take(g, [q[n] for q in ps], w, d, lo, hi, s,
                            "rglru params")
                 for n, d in (("w_gate_in", -1), ("w_rec_in", -1),
                              ("conv_w", -1), ("conv_b", -1))}
            gate, xr, conv = _conv_in(p, xs[s], state("conv", s, lo, hi))
            gates.append(gate)
            xrs.append(xr)
            convs.append(conv)
    outs, hs = [], []
    for s, (lo, hi) in enumerate(bounds):
        with g.on(s):
            b0 = lo // blk
            xin = tp.take(g, xrs, w, -1, b0 * blk, -(-hi // blk) * blk, s,
                          "rglru block inputs")
            a, gated = _lru_gates(
                _block_cols(g, ps, s, "bd_a", xin, b0, lo, hi, blk),
                _block_cols(g, ps, s, "bd_x", xin, b0, lo, hi, blk),
                tp.take(g, [q["lam"] for q in ps], w, -1, lo, hi, s,
                        "rglru params"),
                xrs[s])
            h0 = state("h", s, lo, hi)
            if step:
                y, h = _one(gates[s], a, gated, h0, xs[s].dtype)
            else:
                y, h = _scan(gates[s], a, gated, h0, xs[s].dtype)
            outs.append(y @ tp.take(g, [q["w_out"] for q in ps], w, 0, lo,
                                    hi, s, "rglru params"))
            hs.append(h)
    out = tp.reduce_sum(g, outs, "rglru out")
    h = tp.all_gather(g, hs, -1, "rglru state", to)
    conv = tp.all_gather(g, convs, -1, "rglru state", to)
    return out, [None if a is None else LRUState(h=a, conv=b)
                 for a, b in zip(h, conv)]


def forward_tp(ps, xs, cfg: ModelConfig, g, return_state: bool = False,
               states=None, to=None):
    """:func:`forward` over a tensor-parallel group ``g``
    (:mod:`repro_torch.dist.tp`): shard s holds ``ps[s]`` and its copy of
    the input ``xs[s]`` (B, S, d); continuing a segment, ``states[s]`` is
    its whole copy of the state, or None where only the first shard
    holds one.  Returns (out (B, S, d) on the first shard, the whole new
    state on every shard of ``to`` (default: all; None for the others),
    or None without ``return_state``)."""
    out, new = _over_width(ps, xs, cfg, g, states,
                           to if return_state else (), False)
    return out, new if return_state else None


def decode_step_tp(ps, xs, states, cfg: ModelConfig, g, to=None):
    """:func:`decode_step` over a tensor-parallel group, as
    :func:`forward_tp`: (out on the first shard, the new states)."""
    return _over_width(ps, xs, cfg, g, states, to, True)
