"""Learning-rate schedules: multiplicative factors on the peak lr (the
port of ``repro.optim.schedule``).  Each maps an int32 step tensor to a
float32 factor, computed in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``."""
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(
            torch.tensor(math.pi, dtype=torch.float32, device=s.device)
            * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def wsd(warmup: int, total: int, decay_frac: float = 0.1,
        floor: float = 0.05):
    """Warmup, then stable at 1, then a linear decay to ``floor`` over the
    last ``decay_frac`` of ``total`` (the 'WSD' schedule)."""
    decay_start = int(total * (1 - decay_frac))

    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(warmup, 1)
        dec = 1.0 - (1 - floor) * torch.clamp(
            (s - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        out = torch.where(s < warmup, warm, torch.ones_like(s))
        return torch.where(s > decay_start, dec, out)
    return f
