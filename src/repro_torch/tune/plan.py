"""KernelPlan and the page-size rule of the paged KV pool.

The port of the rule in ``repro.tune.plan.derive_paged_plan``: paged
decode gathers each sequence's pages through a table, so the page is the
memory transaction; the page is the smallest power-of-two token count whose
rows reach 512 bytes, at least 8 tokens, and at most half the sequence
budget rounded up to a power of two.  The pool stores ``dtype``, so a
narrower store holds more tokens per page.  (The reference's autotuner and
memory model, which also set a pipeline depth for the TPU, are not ported.)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.memmodel import next_pow2


@dataclass(frozen=True)
class KernelPlan:
    """One kernel configuration.  For ``paged_attention`` the kv block
    ``bkv`` is the page, which shapes the pool itself."""

    kernel: str
    bq: int
    bkv: int
    dtype: str = "bfloat16"
    head_dim: int = 128

    @property
    def page_size(self) -> int:
        return self.bkv


def derive_paged_plan(*, max_len: int, head_dim: int,
                      dtype: str = "bfloat16") -> KernelPlan:
    row = max(1, head_dim * getattr(torch, dtype).itemsize)
    page = next_pow2(-(-512 // row))
    page = max(8, min(page, max(8, next_pow2(max_len) // 2)))
    return KernelPlan(kernel="paged_attention", bq=1, bkv=page, dtype=dtype,
                      head_dim=head_dim)
