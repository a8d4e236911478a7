"""Shared model components: norms, RoPE, softcap, init helpers.

Parameters are a nested dict of tensors built through :class:`ParamBuilder`
under the reference's dotted paths (``embed.tok``, ``blocks.p0.attn.wq``,
...), with per-pattern-position weights stacked on a leading LAYERS axis,
so a reference param tree maps onto the port leaf for leaf
(:mod:`repro_torch.bridge`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


class ParamBuilder:
    """Collects parameters under nested dict paths.

    ``generator`` draws every weight (a ``torch.Generator`` on ``device``);
    ``device="meta"`` builds shape-only tensors (no memory, no draws), which
    is how the weight bridge learns the expected paths and shapes."""

    def __init__(self, generator: Optional[torch.Generator], dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: dict = {}

    def _put(self, path: str, value: torch.Tensor) -> None:
        parts = path.split(".")
        p = self.params
        for part in parts[:-1]:
            p = p.setdefault(part, {})
        p[parts[-1]] = value

    def dense(self, path: str, shape: Sequence[int],
              scale: Optional[float] = None) -> None:
        """Truncated normal in [-2, 2] times ``scale`` (default
        ``1/sqrt(fan_in)``), drawn in float32 and cast to the param dtype."""
        if self.device.type == "meta":
            self._put(path, torch.empty(tuple(shape), dtype=self.dtype,
                                        device=self.device))
            return
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.empty(tuple(shape), dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.generator)
        self._put(path, (w * std).to(self.dtype))

    def zeros(self, path: str, shape: Sequence[int]) -> None:
        self._put(path, torch.zeros(tuple(shape), dtype=self.dtype,
                                    device=self.device))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """float32 math, ``x * (1 + w)``, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x: (B, S, H, D); positions: (B, S).
    Angles in float32; the output has ``x``'s dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq            # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
