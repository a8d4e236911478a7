"""Shared model components: norms, RoPE, softcap, the depthwise causal
convolution of the recurrent mixers, the cross-entropy loss, init helpers.

Parameters are a nested dict of tensors built through :class:`ParamBuilder`
under the reference's dotted paths (``embed.tok``, ``blocks.p0.attn.wq``,
...), with per-pattern-position weights stacked on a leading LAYERS axis,
so a reference param tree maps onto the port leaf for leaf
(:mod:`repro_torch.bridge`).  The builder also records a parallel tree of
*logical axis names* per tensor (the reference's), which
:mod:`repro_torch.dist.sharding` maps onto mesh axes; model code never
names a mesh axis.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# logical axis names (the reference's)
BATCH, SEQ, EMBED, HEADS, KV_HEADS, HEAD_DIM, FF, VOCAB = (
    "batch", "seq", "embed", "heads", "kv_heads", "head_dim", "ff", "vocab")
EXPERT, LAYERS, STATE, CONV = "expert", "layers", "state", "conv"

Axes = Sequence[Optional[str]]


class ParamBuilder:
    """Collects (parameter, logical axes) pairs under nested dict paths:
    ``params`` holds the tensors, ``specs`` the same tree of axis-name
    tuples (one name, or None, per dimension).

    ``generator`` draws every weight (a ``torch.Generator`` on ``device``);
    ``device="meta"`` builds shape-only tensors (no memory, no draws), which
    is how the weight bridge learns the expected paths and shapes."""

    def __init__(self, generator: Optional[torch.Generator], dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: dict = {}
        self.specs: dict = {}

    def _put(self, path: str, value: torch.Tensor, axes: Axes) -> None:
        if len(axes) != value.dim():
            raise ValueError(f"{path}: {len(axes)} axis names for a "
                             f"{value.dim()}-d tensor")
        parts = path.split(".")
        p, s = self.params, self.specs
        for part in parts[:-1]:
            p = p.setdefault(part, {})
            s = s.setdefault(part, {})
        p[parts[-1]] = value
        s[parts[-1]] = tuple(axes)

    def dense(self, path: str, shape: Sequence[int], axes: Axes,
              scale: Optional[float] = None) -> None:
        """Truncated normal in [-2, 2] times ``scale`` (default
        ``1/sqrt(fan_in)``), drawn in float32 and cast to the param dtype.
        A stacked 3-D (LAYERS, ...) weight is drawn one layer at a time, so
        the float32 draw never holds more than one layer (a full-width
        stack of 23 MLP weights would need 16 GB of it at once); a 4-D
        one, stacked experts, is drawn whole (granite-moe-3b-a800m's
        (32, 40, 1536, 512): 4.0 GB of float32; two layers of
        grok-1-314b's (8, 6144, 32768): 12.9 GB, which an 80 GB card
        holds beside the 23 GB of weights)."""
        if self.device.type == "meta":
            self._put(path, torch.empty(tuple(shape), dtype=self.dtype,
                                        device=self.device), axes)
            return
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        out = torch.empty(tuple(shape), dtype=self.dtype, device=self.device)
        parts = out if len(shape) == 3 else out[None]
        for part in parts:
            w = torch.empty(part.shape, dtype=torch.float32,
                            device=self.device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.generator)
            part.copy_(w.mul_(std))
        self._put(path, out, axes)

    def zeros(self, path: str, shape: Sequence[int], axes: Axes) -> None:
        self._put(path, torch.zeros(tuple(shape), dtype=self.dtype,
                                    device=self.device), axes)

    def ones(self, path: str, shape: Sequence[int], axes: Axes) -> None:
        self._put(path, torch.ones(tuple(shape), dtype=self.dtype,
                                   device=self.device), axes)

    def const(self, path: str, value: torch.Tensor, axes: Axes) -> None:
        """``value`` in the param dtype; on the meta device only its
        shape."""
        if self.device.type == "meta":
            self._put(path, torch.empty(tuple(value.shape), dtype=self.dtype,
                                        device=self.device), axes)
            return
        self._put(path, value.to(device=self.device, dtype=self.dtype), axes)


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


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal convolution.  x: (B, S, C); w: (K, C); ``state``
    (B, K-1, C): the trailing inputs of the previous segment (decode,
    chunked prefill), else zeros.  Taps are summed in the reference's
    order, tap 0 first."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+K-1, C)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    if bias is not None:
        out = out + bias
    return out


def conv_state_from(x: torch.Tensor, k: int,
                    prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The trailing K-1 inputs to carry as the next segment's conv state
    (fewer when ``x`` is shorter and there is no ``prev``, as in the
    reference)."""
    if prev is not None:
        x = torch.cat([prev, x], dim=1)
    return x[:, -(k - 1):]


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, z_loss: float = 0.0):
    """(summed next-token negative log-likelihood in float32, count) over
    the counted positions: labels below 0 (-100) and positions where
    ``mask`` is false are left out; ``z_loss`` adds ``z_loss * lse**2``
    per counted position."""
    logits = logits.float()
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask.bool()
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * valid
    if z_loss:
        nll = nll + z_loss * torch.square(lse) * valid
    return nll.sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 (:func:`nll_sum` over its
    count, at least 1)."""
    tot, cnt = nll_sum(logits, labels, mask, z_loss)
    return tot / torch.clamp(cnt, min=1)
