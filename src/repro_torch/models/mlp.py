"""Dense FFN: SwiGLU / GeGLU / plain-GELU variants, on one device or split
over tensor-parallel shards (:func:`apply_tp`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tp
from repro_torch.models.common import EMBED, FF, LAYERS, ParamBuilder

# GELU is the tanh approximation, as the reference's
# ``jax.nn.gelu(approximate=True)`` (torch's default is the exact erf form)
_ACT = {
    "swiglu": F.silu,
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def init(b: ParamBuilder, path: str, d: int, f: int, activation: str,
         stacked: int = 0) -> None:
    """stacked>0 prepends a LAYERS axis."""
    lead = (stacked,) if stacked else ()
    la = (LAYERS,) if stacked else ()
    if activation in ("swiglu", "geglu"):
        b.dense(f"{path}.w_gate", lead + (d, f), la + (EMBED, FF))
    b.dense(f"{path}.w_up", lead + (d, f), la + (EMBED, FF))
    b.dense(f"{path}.w_down", lead + (f, d), la + (FF, EMBED))


def apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = _ACT[activation]
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
    return h @ p["w_down"]


def apply_tp(ps, hs, activation: str, d_ff: int, g) -> torch.Tensor:
    """The FFN over TP shards: each shard holds a contiguous ff block of
    gate/up (column-parallel) and the matching rows of down
    (row-parallel), so its :func:`apply` on its copy of the input is a
    partial of the output; the partials sum on the first shard of the
    group ``g`` (:mod:`repro_torch.dist.tp`) in shard order.
    Where the policy left ff whole (d_ff does not divide by tp) the FFN
    runs once, on the first shard."""
    if ps[0]["w_down"].shape[-2] == d_ff:
        return apply(ps[0], hs[0], activation)
    return tp.reduce_sum(g, [apply(p, h, activation) for p, h in zip(ps, hs)],
                         "mlp out")
