"""Token selection for the serving engine: greedy argmax.

The port of the greedy branch of ``repro.serve.sampling``: temperature 0
is exact argmax (the first maximal index on ties) and consumes no random
state.  Temperature, top-k and top-p sampling are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0

    def __post_init__(self):
        if self.temperature != 0.0:
            raise NotImplementedError(
                "only greedy selection (temperature=0) is ported")


GREEDY = SamplingParams()


def select_greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 argmax tokens."""
    return torch.argmax(logits, dim=-1)
