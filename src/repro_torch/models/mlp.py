"""Dense FFN: SwiGLU / GeGLU / plain-GELU variants."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamBuilder

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
    if activation in ("swiglu", "geglu"):
        b.dense(f"{path}.w_gate", lead + (d, f))
    b.dense(f"{path}.w_up", lead + (d, f))
    b.dense(f"{path}.w_down", lead + (f, d))


def apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = _ACT[activation]
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
    return h @ p["w_down"]
