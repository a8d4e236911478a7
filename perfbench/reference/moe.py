"""The mixture of experts' feed-forward layer: a float32 softmax router,
the top ``num_experts_per_tok`` experts of each token with their gates
renormalised to sum to one, each expert a SwiGLU computed only over the
tokens routed to it."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ffn(p: dict, h, dims: dict, lin):
    m = p["moe"]
    k = dims["num_experts_per_tok"]
    probs = torch.softmax(lin(h, m["router"]), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(h)
    for e in range(dims["num_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = lin(F.silu(lin(x, m["w_gate"][e])) * lin(x, m["w_up"][e]),
                m["w_down"][e])
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out
