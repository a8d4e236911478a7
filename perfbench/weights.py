"""The weights of a run, drawn from the seed on the device by the
benchmark, in the port's parameter layout and the configuration's dtype.

One draw per leaf (stacked layers and experts are single leaves), so a
3.8 B-parameter model is a dozen calls.  Projections and experts are
normal with standard deviation ``1/sqrt(fan_in)``, the embedding
``d_model ** -0.5``; the norms' weights (applied as ``x * (1 + w)``) are
normal with standard deviation 0.1, so the check covers them too.  The
same tree is handed to the program and, cast to float32, to the
reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NORM_STD = 0.1


def layout(dims: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf: ``kind`` is ``embed``, ``dense``
    or ``norm``."""
    d, hd, L = dims["d_model"], dims["head_dim"], dims["num_layers"]
    hq, hkv, f, v = (dims["num_heads"], dims["num_kv_heads"], dims["d_ff"],
                     dims["vocab_size"])
    out = [("embed.tok", (v, d), "embed"),
           ("blocks.p0.ln1", (L, d), "norm"),
           ("blocks.p0.attn.wq", (L, d, hq * hd), "dense"),
           ("blocks.p0.attn.wk", (L, d, hkv * hd), "dense"),
           ("blocks.p0.attn.wv", (L, d, hkv * hd), "dense"),
           ("blocks.p0.attn.wo", (L, hq * hd, d), "dense"),
           ("blocks.p0.ln2", (L, d), "norm")]
    e = dims.get("num_experts", 0)
    if e:
        out += [("blocks.p0.moe.router", (L, d, e), "dense"),
                ("blocks.p0.moe.w_gate", (L, e, d, f), "dense"),
                ("blocks.p0.moe.w_up", (L, e, d, f), "dense"),
                ("blocks.p0.moe.w_down", (L, e, f, d), "dense")]
    else:
        out += [("blocks.p0.mlp.w_gate", (L, d, f), "dense"),
                ("blocks.p0.mlp.w_up", (L, d, f), "dense"),
                ("blocks.p0.mlp.w_down", (L, f, d), "dense")]
    out.append(("final_norm", (d,), "norm"))
    if not dims.get("tie_embeddings", True):
        out.append(("lm_head", (d, v), "dense"))
    return out


def _put(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def draw(dims: dict, seed: int, dtype: torch.dtype, device) -> Dict:
    """The weight tree of ``dims`` from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for path, shape, kind in layout(dims):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if kind == "embed":
            t.mul_(dims["d_model"] ** -0.5)
        elif kind == "dense":
            t.mul_(shape[-2] ** -0.5)
        else:
            t.mul_(NORM_STD)
        _put(tree, path, t)
    return tree


def leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, path + ".")
        else:
            yield path, v


def check_against(tree: dict, abstract: dict) -> None:
    """Raise unless ``tree`` has the paths, shapes and dtypes of the
    program's own parameter tree (``abstract``, on the meta device)."""
    mine = {p: (tuple(t.shape), t.dtype) for p, t in leaves(tree)}
    theirs = {p: (tuple(t.shape), t.dtype) for p, t in leaves(abstract)}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"the drawn weights do not match the program's "
                         f"layout: {diff[:6]}")
