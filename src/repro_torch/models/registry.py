"""ModelBundle: the model's interface to the serving engine.

``build(cfg, device=None)`` returns a bundle bound to one device: ``cuda``
unless the caller names another (``device="cpu"`` runs the plain PyTorch
path).  Without a card and without an explicit device it raises."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: torch.Generator) -> dict:
        """Fresh weights drawn from ``generator`` (a generator on the
        bundle's device)."""
        return transformer.init_params(self.cfg, generator, self.device)

    def init_paged_cache(self, num_pages: int, page_size: int) -> dict:
        return transformer.init_paged_cache(self.cfg, num_pages, page_size,
                                            self.device)

    def paged_decode_step(self, params, cache, tokens, pos, table):
        return transformer.paged_decode_step(params, self.cfg, cache, tokens,
                                             pos, table)

    def paged_prefill_chunk(self, params, cache, tokens, pos, table,
                            chunk_valid):
        return transformer.paged_prefill_chunk(params, self.cfg, cache,
                                               tokens, pos, table,
                                               chunk_valid)


def build(cfg: ModelConfig, device: Optional[str] = None) -> ModelBundle:
    transformer.check_supported(cfg)
    return ModelBundle(cfg=cfg, device=resolve_device(device))
