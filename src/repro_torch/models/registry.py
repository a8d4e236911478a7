"""ModelBundle: the model's interface to the serving engine.

``build(cfg, flags=None, device=None)`` returns a bundle bound to one
device: ``cuda`` unless the caller names another (``device="cpu"`` runs the
plain PyTorch path).  Without a card and without an explicit device it
raises.  ``flags`` (:class:`~repro_torch.models.transformer.RuntimeFlags`)
picks prefill's attention; the default is the reference's, ``chunked``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.transformer import RuntimeFlags


@dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    flags: RuntimeFlags = RuntimeFlags()

    def init(self, generator: torch.Generator) -> dict:
        """Fresh weights drawn from ``generator`` (a generator on the
        bundle's device)."""
        return transformer.init_params(self.cfg, generator, self.device)

    # -- dense KV backend ------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, self.device,
                                      kv_dtype=self.flags.kv_dtype)

    def prefill(self, params, batch: dict):
        return transformer.prefill(params, self.cfg, self.flags, batch)

    def decode_step(self, params, cache, tokens, pos):
        return transformer.decode_step(params, self.cfg, self.flags, cache,
                                       tokens, pos)

    # -- paged KV backend ------------------------------------------------
    def paged_supported(self) -> bool:
        """Every stack the port accepts serves from the shared page pools:
        full-attention layers grow a page table, windowed layers keep a
        rotating ring of pages, int8 KV stores scale lanes."""
        return True

    def init_paged_cache(self, num_pages: int, page_size: int,
                         ring_pages: int = 0) -> dict:
        return transformer.init_paged_cache(self.cfg, num_pages, page_size,
                                            self.device,
                                            ring_pages=ring_pages,
                                            kv_dtype=self.flags.kv_dtype)

    def paged_decode_step(self, params, cache, tokens, pos, table):
        return transformer.paged_decode_step(params, self.cfg, self.flags,
                                             cache, tokens, pos, table)

    def paged_prefill_chunk(self, params, cache, tokens, pos, table,
                            chunk_valid):
        return transformer.paged_prefill_chunk(params, self.cfg, self.flags,
                                               cache, tokens, pos, table,
                                               chunk_valid)

    def paged_verify(self, params, cache, tokens, pos, table, chunk_valid,
                     plan=None):
        return transformer.paged_verify(params, self.cfg, self.flags, cache,
                                        tokens, pos, table, chunk_valid,
                                        plan)


def build(cfg: ModelConfig, flags: Optional[RuntimeFlags] = None,
          device: Optional[str] = None) -> ModelBundle:
    flags = flags or RuntimeFlags()
    transformer.check_supported(cfg, flags)
    return ModelBundle(cfg=cfg, device=resolve_device(device), flags=flags)
