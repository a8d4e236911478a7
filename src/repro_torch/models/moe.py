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
"""
from __future__ import annotations

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


def route_stats(p, x: torch.Tensor, k: int):
    """The sums :func:`_lb_loss` takes its means of, over the tokens of
    ``x``: (router probs summed per expert (E,), assignments counted per
    expert (E,), both float32; the token count; the assignment count).
    Added over slices of a batch, they give :func:`lb_from_stats` the
    whole batch's loss."""
    n_exp = p["router"].shape[-1]
    _, ids, probs = _route(p, x, k)
    return (probs.reshape(-1, n_exp).sum(dim=0),
            F.one_hot(ids.reshape(-1), n_exp).float().sum(dim=0),
            probs.numel() // n_exp, ids.numel())


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


def apply_dense(p, x: torch.Tensor, k: int, activation: str):
    """Weighted sum over all experts.  x: (B, S, d) -> (out, aux)."""
    n_exp = p["router"].shape[-1]
    gates, ids, probs = _route(p, x, k)
    w = (F.one_hot(ids, n_exp).float() * gates[..., None]).sum(-2)  # (B,S,E)
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
    out = torch.einsum("bsef,efd->bsd", hh, p["w_down"])
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


def apply_sorted(p, x: torch.Tensor, k: int, activation: str,
                 group_size: int = 1024, capacity_factor: float = 1.25):
    """Capacity-based sort dispatch.  x: (B, S, d) -> (out, aux)."""
    bsz, s, d = x.shape
    n_exp = p["router"].shape[-1]
    gates, ids, probs = _route(p, x, k)
    aux = _lb_loss(probs, ids, n_exp)

    g_sz = min(group_size, s)
    n_grp = (bsz * s) // g_sz
    cap = capacity(k, g_sz, capacity_factor, n_exp)
    order, tok_of, keep, slot = dispatch(ids, k, g_sz, cap, n_exp)

    xt = x.reshape(n_grp, g_sz, d)
    gates_g = gates.reshape(n_grp, g_sz * k).to(x.dtype)
    # pack -> (G, E*cap + 1, d); the overflow row is never read
    src = torch.gather(xt, 1, tok_of[..., None].expand(-1, -1, d))
    buf = torch.zeros((n_grp, n_exp * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), src)
    h = buf[:, :-1].reshape(n_grp, n_exp, cap, d)

    out_e = _expert_ffn(p, h, activation)                     # (G, E, cap, d)

    flat = torch.cat([out_e.reshape(n_grp, n_exp * cap, d),
                      torch.zeros((n_grp, 1, d), dtype=x.dtype,
                                  device=x.device)], dim=1)   # overflow -> 0
    picked = torch.gather(flat, 1, slot[..., None].expand(-1, -1, d))
    sorted_gates = torch.gather(gates_g, -1, order)
    contrib = picked * torch.where(keep, sorted_gates,
                                   torch.zeros_like(sorted_gates))[..., None]
    # each token's k positions in the sorted list, ascending (its experts
    # in ascending id, the order the reference's scatter-add adds them)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(g_sz * k, device=x.device).expand_as(order))
    pos = inv.reshape(n_grp, g_sz, k).sort(dim=-1).values
    by_tok = torch.gather(contrib, 1, pos.reshape(n_grp, g_sz * k, 1)
                          .expand(-1, -1, d)).reshape(n_grp, g_sz, k, d)
    out = torch.zeros((n_grp, g_sz, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + by_tok[:, :, j]
    return out.reshape(bsz, s, d), aux


def apply(p, x: torch.Tensor, k: int, activation: str, impl: str = "sorted",
          group_size: int = 1024, capacity_factor: float = 1.25):
    if impl == "dense":
        return apply_dense(p, x, k, activation)
    return apply_sorted(p, x, k, activation, group_size, capacity_factor)
