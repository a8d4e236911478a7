"""Mixture-of-Experts FFN with two dispatch strategies, as
``repro.models.moe``, in plain torch ops (the reference has no Pallas
kernel here):

- ``dense``: every expert computes every token, combined by gate weights;
- ``sorted``: capacity-based sort dispatch.  Tokens are grouped, sorted by
  expert id within each group (stably), packed into a (groups, E, capacity,
  d) buffer whose overflow row is dropped before the expert FFN and read
  back as zero, run through batched expert matmuls, and combined back with
  their gates.

Routing is a float32 softmax router, top-k, gates renormalised; the
Switch-style load-balance loss is returned beside the output.

The sorted combine is deterministic: each token gathers its k
contributions at its positions in the sorted list, taken in ascending
order (its experts in ascending id, the order the reference's
scatter-add adds them), and adds them in that order (no atomics, so two
runs on a card agree).

Over a tensor-parallel group each shard holds a contiguous block of the
experts (:func:`apply_tp`): the routing runs once, each shard gets its
experts' rows and sends back their outputs, and the combine is the
one-device one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import EMBED, EXPERT, FF, LAYERS, ParamBuilder
from repro_torch.models.mlp import _ACT

IMPLS = ("dense", "sorted")


def init(b: ParamBuilder, path: str, d: int, f: int, n_exp: int,
         activation: str, stacked: int = 0) -> None:
    """``router`` (d, E), ``w_gate`` (gated activations only) and ``w_up``
    (E, d, f), ``w_down`` (E, f, d); stacked>0 prepends a LAYERS axis."""
    lead = (stacked,) if stacked else ()
    la = (LAYERS,) if stacked else ()
    b.dense(f"{path}.router", lead + (d, n_exp), la + (EMBED, None))
    if activation in ("swiglu", "geglu"):
        b.dense(f"{path}.w_gate", lead + (n_exp, d, f),
                la + (EXPERT, EMBED, FF))
    b.dense(f"{path}.w_up", lead + (n_exp, d, f), la + (EXPERT, EMBED, FF))
    b.dense(f"{path}.w_down", lead + (n_exp, f, d), la + (EXPERT, FF, EMBED))


def _route(p, x: torch.Tensor, k: int):
    """x: (..., d) -> (gates (..., k) float32, ids (..., k), router probs
    (..., E) float32)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids, probs


def _lb_loss(probs: torch.Tensor, ids: torch.Tensor,
             n_exp: int) -> torch.Tensor:
    """Switch load-balance loss: E * dot(mean prob, mean assignment)."""
    me = probs.reshape(-1, n_exp).mean(dim=0)
    assign = F.one_hot(ids.reshape(-1), n_exp).float().mean(dim=0)
    return n_exp * torch.sum(me * assign)


def _sums(ids: torch.Tensor, probs: torch.Tensor, n_exp: int):
    """:func:`route_stats` of a routing's ids and probs."""
    return (probs.reshape(-1, n_exp).sum(dim=0),
            F.one_hot(ids.reshape(-1), n_exp).float().sum(dim=0),
            probs.numel() // n_exp, ids.numel())


def route_stats(p, x: torch.Tensor, k: int):
    """The sums :func:`_lb_loss` takes its means of, over the tokens of
    ``x``: (router probs summed per expert (E,), assignments counted per
    expert (E,), both float32; the token count; the assignment count).
    Added over slices of a batch, they give :func:`lb_from_stats` the
    whole batch's loss."""
    n_exp = p["router"].shape[-1]
    _, ids, probs = _route(p, x, k)
    return _sums(ids, probs, n_exp)


def lb_from_stats(prob_sum: torch.Tensor, assign_sum: torch.Tensor,
                  tokens: int, assignments: int) -> torch.Tensor:
    """:func:`_lb_loss` from :func:`route_stats`' sums."""
    n_exp = prob_sum.shape[-1]
    return n_exp * torch.sum((prob_sum / tokens) * (assign_sum / assignments))


def _expert_ffn(p, h: torch.Tensor, activation: str) -> torch.Tensor:
    """h: (G, E, C, d), a batched per-expert FFN."""
    act = _ACT[activation]
    up = torch.einsum("gecd,edf->gecf", h, p["w_up"])
    if "w_gate" in p:
        hh = act(torch.einsum("gecd,edf->gecf", h, p["w_gate"])) * up
    else:
        hh = act(up)
    return torch.einsum("gecf,efd->gecd", hh, p["w_down"])


def _dense_part(p, x: torch.Tensor, w: torch.Tensor,
                activation: str) -> torch.Tensor:
    """The dense dispatch over the experts of ``p`` (all of them, or one
    shard's block) with their gate weights ``w`` (B, S, E): x (B, S, d)
    -> their weighted sum (B, S, d)."""
    act = _ACT[activation]
    up = torch.einsum("bsd,edf->bsef", x, p["w_up"])
    if "w_gate" in p:
        hh = act(torch.einsum("bsd,edf->bsef", x, p["w_gate"])) * up
    else:
        hh = act(up)
    # the reference's einsum("bsef,efd,bse->bsd") in the order its
    # contraction path takes (the gates into hh first, in x.dtype), without
    # a three-operand einsum's path search on every call
    hh = hh * w.to(x.dtype)[..., None]
    return torch.einsum("bsef,efd->bsd", hh, p["w_down"])


def _gate_weights(gates, ids, n_exp: int) -> torch.Tensor:
    """(B, S, E) float32: each expert's gate, zero where not picked."""
    return (F.one_hot(ids, n_exp).float() * gates[..., None]).sum(-2)


def apply_dense(p, x: torch.Tensor, k: int, activation: str):
    """Weighted sum over all experts.  x: (B, S, d) -> (out, aux)."""
    n_exp = p["router"].shape[-1]
    gates, ids, probs = _route(p, x, k)
    out = _dense_part(p, x, _gate_weights(gates, ids, n_exp), activation)
    return out, _lb_loss(probs, ids, n_exp)


def capacity(k: int, g_sz: int, capacity_factor: float, n_exp: int) -> int:
    """Expert slots per group, the reference's expression (a float floor)."""
    return int(max(k, k * g_sz * capacity_factor // n_exp))


def dispatch(ids: torch.Tensor, k: int, g_sz: int, cap: int, n_exp: int):
    """The sort dispatch of (B, S, k) expert ids in groups of ``g_sz``
    tokens: (order, tok_of, keep, slot), each (G, g_sz * k).  ``order``
    sorts the group's assignments stably by expert id, ``tok_of`` is each
    sorted assignment's token in its group, ``keep`` marks the assignments
    within their expert's capacity (a rank below ``cap``; later tokens,
    pad tokens at a padded tail among them, drop first), and ``slot`` is
    each one's row in the (E * cap + 1)-row buffer, the last row taking
    the overflow."""
    n_grp = ids.numel() // (g_sz * k)
    ids_g = ids.reshape(n_grp, g_sz * k)
    order = torch.argsort(ids_g, dim=-1, stable=True)
    sorted_ids = torch.gather(ids_g, -1, order)
    tok_of = order // k
    # rank within an expert = position - first occurrence of its id
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = torch.arange(g_sz * k, device=ids.device)[None, :] - first
    keep = rank < cap
    slot = torch.where(keep, sorted_ids * cap + rank, n_exp * cap)
    return order, tok_of, keep, slot


def _pack(x: torch.Tensor, ids: torch.Tensor, k: int, group_size: int,
          capacity_factor: float, n_exp: int):
    """The sort dispatch's send buffer: (h (G, E, cap, d), the
    :func:`dispatch` tuple); the overflow row of the buffer is dropped."""
    bsz, s, d = x.shape
    g_sz = min(group_size, s)
    n_grp = (bsz * s) // g_sz
    cap = capacity(k, g_sz, capacity_factor, n_exp)
    disp = dispatch(ids, k, g_sz, cap, n_exp)
    _, tok_of, _, slot = disp
    xt = x.reshape(n_grp, g_sz, d)
    # pack -> (G, E*cap + 1, d); the overflow row is never read
    src = torch.gather(xt, 1, tok_of[..., None].expand(-1, -1, d))
    buf = torch.zeros((n_grp, n_exp * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), src)
    return buf[:, :-1].reshape(n_grp, n_exp, cap, d), disp


def _combine(out_e: torch.Tensor, gates, disp, k: int,
             shape) -> torch.Tensor:
    """The sort dispatch's combine: each token's kept contributions of
    ``out_e`` (G, E, cap, d), gated, added in ascending expert order."""
    order, _, keep, slot = disp
    n_grp, n_exp, cap, d = out_e.shape
    g_sz = order.shape[-1] // k
    gates_g = gates.reshape(n_grp, g_sz * k).to(out_e.dtype)
    # the overflow slot reads zeros
    flat = torch.cat([out_e.reshape(n_grp, n_exp * cap, d),
                      torch.zeros((n_grp, 1, d), dtype=out_e.dtype,
                                  device=out_e.device)], dim=1)
    picked = torch.gather(flat, 1, slot[..., None].expand(-1, -1, d))
    sorted_gates = torch.gather(gates_g, -1, order)
    contrib = picked * torch.where(keep, sorted_gates,
                                   torch.zeros_like(sorted_gates))[..., None]
    # each token's k positions in the sorted list, ascending (its experts
    # in ascending id, the order the reference's scatter-add adds them)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(g_sz * k, device=order.device
                                ).expand_as(order))
    pos = inv.reshape(n_grp, g_sz, k).sort(dim=-1).values
    by_tok = torch.gather(contrib, 1, pos.reshape(n_grp, g_sz * k, 1)
                          .expand(-1, -1, d)).reshape(n_grp, g_sz, k, d)
    out = torch.zeros((n_grp, g_sz, d), dtype=out_e.dtype,
                      device=out_e.device)
    for j in range(k):
        out = out + by_tok[:, :, j]
    return out.reshape(shape)


def apply_sorted(p, x: torch.Tensor, k: int, activation: str,
                 group_size: int = 1024, capacity_factor: float = 1.25):
    """Capacity-based sort dispatch.  x: (B, S, d) -> (out, aux)."""
    n_exp = p["router"].shape[-1]
    gates, ids, probs = _route(p, x, k)
    aux = _lb_loss(probs, ids, n_exp)
    h, disp = _pack(x, ids, k, group_size, capacity_factor, n_exp)
    out_e = _expert_ffn(p, h, activation)                     # (G, E, cap, d)
    return _combine(out_e, gates, disp, k, x.shape), aux


def apply(p, x: torch.Tensor, k: int, activation: str, impl: str = "sorted",
          group_size: int = 1024, capacity_factor: float = 1.25):
    if impl == "dense":
        return apply_dense(p, x, k, activation)
    return apply_sorted(p, x, k, activation, group_size, capacity_factor)


def apply_tp(ps, x: torch.Tensor, k: int, activation: str, g,
             impl: str = "sorted", group_size: int = 1024,
             capacity_factor: float = 1.25, d_ff: Optional[int] = None,
             stats: Optional[list] = None):
    """The MoE layer over a tensor-parallel group ``g``
    (:mod:`repro_torch.dist.tp`) whose shard s holds ``ps[s]``: the
    router whole, and a contiguous block of the experts (the ``tp``
    policy's spec ``(EXPERT, EMBED, FF)``).  ``x`` (B, S, d) is on the
    first shard, where the float32 routing runs once and the load-balance
    loss comes from it (the one-device loss); ``stats``, where given,
    gets that routing's :func:`route_stats`.  Returns (out on the first
    shard, aux).

    - ``dense``: each shard gets the input and its experts' gate weights,
      and sends back its experts' weighted sum; the partials add in shard
      order.
    - ``sorted``: the global sort, ranks and ``keep`` mask of
      :func:`dispatch` (capacity from the global expert count) pack the
      send buffer on the first shard; each shard gets its experts' rows
      (the sending half of the all-to-all), runs its experts, and its
      outputs come back in shard order (the returning half) to the
      one-device combine, so overflowed rows add zero as they do on one
      device.

    Where the expert count does not divide, the policy splits ``d_ff``
    (given as ``d_ff``) instead: every shard runs every expert on its ff
    block and the partials add.  Weights left whole run on the first
    shard alone."""
    from repro_torch.dist import tp
    n_exp = ps[0]["router"].shape[-1]
    per = ps[0]["w_up"].shape[-3]
    e_split = per < n_exp
    f_split = d_ff is not None and ps[0]["w_up"].shape[-1] < d_ff
    run = range(g.n) if e_split or f_split else range(1)
    gates, ids, probs = _route(ps[0], x, k)
    if stats is not None:
        stats.append(_sums(ids, probs, n_exp))
    aux = _lb_loss(probs, ids, n_exp)

    def mine(t, dim, s):
        """Shard s's experts of ``t`` along ``dim``, sent to it."""
        if e_split:
            t = t.narrow(dim, s * per, per)
        return tp.move(g, t, 0, s, "moe dispatch")

    if impl == "dense":
        w = _gate_weights(gates, ids, n_exp)
        parts = []
        for s in run:
            with g.on(s):
                parts.append(_dense_part(ps[s], tp.move(g, x, 0, s,
                                                        "moe dispatch"),
                                         mine(w, -1, s), activation))
        return tp.reduce_sum(g, parts, "moe combine"), aux
    h, disp = _pack(x, ids, k, group_size, capacity_factor, n_exp)
    outs = []
    for s in run:
        with g.on(s):
            outs.append(_expert_ffn(ps[s], mine(h, 1, s), activation))
    out_e = (tp.all_gather(g, outs, 1, "moe combine", to=(0,))[0] if e_split
             else tp.reduce_sum(g, outs, "moe combine"))
    return _combine(out_e, gates, disp, k, x.shape), aux
