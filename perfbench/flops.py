"""Operations and bytes of the model's work, from its dimensions alone.

The counts are what the work needs, whatever implements it: a linear layer
counts at its active parameters (a MoE layer at its ``top_k`` experts and
its router, not at every expert a dense dispatch computes), attention over
each query's actual context, and the LM head only for the rows whose
logits are read.  ``dims`` is a configuration file's ``model`` block.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def linear_flops_per_token(dims: dict) -> int:
    """2 x the active weights one token multiplies, over every layer,
    without the embedding lookup and the LM head."""
    d, hd = dims["d_model"], dims["head_dim"]
    hq, hkv, f = dims["num_heads"], dims["num_kv_heads"], dims["d_ff"]
    attn = d * hd * (hq + 2 * hkv) + hq * hd * d
    if dims.get("num_experts", 0):
        mlp = dims["num_experts_per_tok"] * 3 * d * f + d * dims["num_experts"]
    else:
        mlp = 3 * d * f
    return 2 * dims["num_layers"] * (attn + mlp)


def head_flops(dims: dict) -> int:
    """One row of logits."""
    return 2 * dims["d_model"] * dims["vocab_size"]


def attention_flops(dims: dict, keys: int) -> int:
    """Scores and weighted values of one query over ``keys`` keys, every
    layer."""
    return 4 * dims["num_layers"] * dims["num_heads"] * dims["head_dim"] * keys


def decode_tick_flops(dims: dict, contexts: Sequence[int]) -> int:
    """One decode tick: each active slot's token attends over its context
    (prompt plus tokens so far, the new one included) and reads logits."""
    per = linear_flops_per_token(dims) + head_flops(dims)
    return sum(per + attention_flops(dims, c) for c in contexts)


def prefill_chunk_flops(dims: dict, offset: int, length: int) -> int:
    """One prefill chunk of ``length`` tokens at ``offset``: causal
    attention (query ``p`` over ``p + 1`` keys) and one row of logits."""
    keys = length * offset + length * (length + 1) // 2
    return (length * linear_flops_per_token(dims) + head_flops(dims)
            + attention_flops(dims, keys))


def k1_launch(dims: dict, contexts: Sequence[int], itemsize: int
              ) -> Tuple[int, int]:
    """(bytes, flops) one paged-attention launch (one layer of one decode
    tick) needs: the K and V rows of each active slot's context, its query
    and its output, each once; scores and weighted values."""
    hq, hkv, hd = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    kv = sum(contexts) * hkv * hd * 2 * itemsize
    qo = len(contexts) * hq * hd * 2 * itemsize
    return kv + qo, 4 * hq * hd * sum(contexts)


def k1_ticks(dims: dict, ticks: Iterable[Sequence[int]], itemsize: int
             ) -> Tuple[int, int]:
    """(bytes, flops) of every K1 launch of the given decode ticks: one
    launch per layer a tick."""
    b = f = 0
    for contexts in ticks:
        if not contexts:
            continue
        lb, lf = k1_launch(dims, contexts, itemsize)
        b += lb * dims["num_layers"]
        f += lf * dims["num_layers"]
    return b, f
