"""AdamW with global-norm clipping (the port of ``repro.optim.adamw``).

The state's ``m`` and ``v`` are float32 trees shaped like the params, and
``step`` an int32 0-d tensor.  :func:`update` works on one leaf at a time,
as the reference does, and writes the params, ``m`` and ``v`` in place, so
that a full-width model keeps one copy of each (the port keeps caches in
place for the same reason); it still returns ``(params, state,
metrics)``.  Every scalar (the bias corrections, the clip scale, the
learning rate and its schedule) is a float32 tensor computed as the
reference computes it, so the update rounds as the reference's does.

A leaf stored over a mesh (:class:`~repro_torch.dist.sharding.Sharded`)
is updated block by block, each on its own device, with its moments
stored in the same blocks (ZeRO-3 falls out of the layout); the global
norm adds each leaf's blocks' sums of squares in block order, the leaves
in the one-device order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.sharding import Sharded
from repro_torch.tree import leaves, leaves_with_paths, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # step (int32 0-d tensor) -> float32 factor on lr
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def _blocks(x) -> list:
    return x.blocks if isinstance(x, Sharded) else [x]


def init(params) -> AdamWState:
    """Zero moments in float32 beside each param (in its blocks, for a
    leaf stored over a mesh), step 0 on the first leaf's device."""
    first = _blocks(leaves(params)[0])[0]

    def zeros(p):
        z = lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device)
        return p.map_blocks(z) if isinstance(p, Sharded) else z(p)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in the reference's order (dict keys sorted), a leaf's blocks in
    block order; on the first leaf's device."""
    total = 0
    home = None
    for x in leaves(tree):
        for b in _blocks(x):
            home = b.device if home is None else home
            total = total + torch.sum(torch.square(b.float())).to(home)
    return torch.sqrt(total)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig
           ) -> Tuple[dict, AdamWState, dict]:
    """One AdamW step: returns (params, state, dict(grad_norm=, lr=)),
    params and moments updated in place.  Weight decay applies to leaves
    of two or more dimensions; the schedule reads the new step."""
    dev = state.step.device
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.minimum(_f32(1.0, dev),
                              torch.div(_f32(cfg.clip_norm, dev),
                                        torch.clamp(gnorm, min=1e-9)))
    lr = _f32(cfg.lr, dev)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(step)
    stepf = step.float()
    c1 = 1.0 - torch.pow(_f32(cfg.b1, dev), stepf)
    c2 = 1.0 - torch.pow(_f32(cfg.b2, dev), stepf)
    decay_on = bool(cfg.weight_decay)
    g_of = dict(leaves_with_paths(grads))
    m_of = dict(leaves_with_paths(state.m))
    v_of = dict(leaves_with_paths(state.v))
    for p, g, m, v in (
            blocks for path, leaf in leaves_with_paths(params)
            for blocks in zip(_blocks(leaf), _blocks(g_of[path]),
                              _blocks(m_of[path]), _blocks(v_of[path]))):
        if scale is not None:
            g = g * scale.to(g.device, g.dtype)
        g32 = g.float()
        # in place where the reference's expression rounds the same:
        # b1 m + (1 - b1) g, b2 v + (1 - b2) g^2, (m / c1) / (sqrt(v / c2)
        # + eps) [+ wd p], p - lr delta
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
        delta = torch.div(m, c1.to(m.device)).div_(
            torch.div(v, c2.to(v.device)).sqrt_().add_(cfg.eps))
        p32 = p.float()
        if decay_on and p.dim() >= 2:
            delta.add_(p32 * cfg.weight_decay)
        delta.mul_(lr.to(p.device))
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p32 - delta).to(p.dtype))
        # this leaf's temporaries go before the next leaf makes its own
        del g, g32, delta, p32
    metrics = dict(grad_norm=gnorm, lr=lr)
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
