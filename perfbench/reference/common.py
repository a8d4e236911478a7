"""The decoder both model kinds share, written from the configuration's
equations in plain float32 PyTorch, with no cache and no batching: RMS
norm applied as ``x * (1 + w)``, rotary embeddings over the whole head
(half-split), grouped-query causal attention, a pre-norm residual stack,
a final norm and the embedding as the tied LM head.

``linear(x, w)`` computes every projection; :func:`fp8_linear` is the
control, each operand rounded to float8 (e4m3) with a scale per row of
``x`` and per column of ``w``, then multiplied in float32.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

Linear = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
F8_MAX = 448.0


def exact_float32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _to_f8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _to_f8(x, -1) @ _to_f8(w, -2)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1."""
    s, _, d = x.shape
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 256) -> torch.Tensor:
    """Causal grouped-query attention.  q (S, Hq, D); k, v (S, Hkv, D)."""
    s, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(s, hkv, g, d) * d ** -0.5
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(s, a + block)
        sc = torch.einsum("qhgd,khd->hgqk", qg[a:b], k[:b])
        mask = kpos[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        out[a:b] = torch.einsum("hgqk,khd->qhgd", pr, v[:b]).reshape(
            b - a, hq, d)
    return out


def layer_weights(tree: dict, i: int) -> dict:
    """Layer ``i`` of the stacked tree, as float32."""
    def pick(t):
        return {k: pick(v) if isinstance(v, dict) else v[i].float()
                for k, v in t.items()}
    return pick(tree["blocks"]["p0"])


def hidden_states(weights: dict, dims: dict, ffn, tokens: torch.Tensor,
                  lin: Linear = linear) -> torch.Tensor:
    """Final-normed hidden states (S, d) of the sequence ``tokens``."""
    eps = float(dims["norm_eps"])
    hq, hkv, hd = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    s = tokens.shape[0]
    x = weights["embed"]["tok"][tokens.long()].float()
    for i in range(dims["num_layers"]):
        p = layer_weights(weights, i)
        h = rms_norm(x, p["ln1"], eps)
        a = p["attn"]
        q = rope(lin(h, a["wq"]).reshape(s, hq, hd), dims["rope_theta"])
        k = rope(lin(h, a["wk"]).reshape(s, hkv, hd), dims["rope_theta"])
        v = lin(h, a["wv"]).reshape(s, hkv, hd)
        x = x + lin(attention(q, k, v).reshape(s, hq * hd), a["wo"])
        h = rms_norm(x, p["ln2"], eps)
        x = x + ffn(p, h, dims, lin)
        del p
    return rms_norm(x, weights["final_norm"], eps)


def head(weights: dict) -> torch.Tensor:
    """The LM head as float32 (d, V): the tied embedding's transpose."""
    if "lm_head" in weights:
        return weights["lm_head"].float()
    return weights["embed"]["tok"].float().T


def served_gaps(weights: dict, dims: dict, ffn, prompt: torch.Tensor,
                served: torch.Tensor, control: Optional[Linear] = None,
                block: int = 256, w_head: Optional[torch.Tensor] = None):
    """Run the reference once over ``prompt ++ served[:-1]`` and return,
    for each served token, how far its logit lies below the reference's
    best at its position (float32, (n,)).  With ``control`` (a lower
    precision linear), also the gaps of the tokens the control puts first
    at the same positions."""
    tokens = torch.cat([prompt, served[:-1]])
    start = prompt.shape[0] - 1
    w_head = head(weights) if w_head is None else w_head
    h = hidden_states(weights, dims, ffn, tokens)[start:]
    hc = (hidden_states(weights, dims, ffn, tokens, control)[start:]
          if control is not None else None)
    gaps, cgaps = [], []
    for a in range(0, h.shape[0], block):
        lg = h[a:a + block] @ w_head
        best = lg.max(dim=-1).values
        tok = served[a:a + block].long()
        gaps.append(best - lg.gather(1, tok[:, None])[:, 0])
        if hc is not None:
            pick = control(hc[a:a + block], w_head).argmax(dim=-1)
            cgaps.append(best - lg.gather(1, pick[:, None])[:, 0])
    gaps = torch.cat(gaps)
    return (gaps, torch.cat(cgaps)) if hc is not None else (gaps, None)
