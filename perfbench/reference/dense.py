"""The dense decoder's feed-forward layer: SwiGLU."""
from __future__ import annotations

import torch.nn.functional as F


def ffn(p: dict, h, dims: dict, lin):
    m = p["mlp"]
    return lin(F.silu(lin(h, m["w_gate"])) * lin(h, m["w_up"]), m["w_down"])
