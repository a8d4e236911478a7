"""ModelBundle: the model's interface to the serving engine and the
trainer.

``build(cfg, flags=None, device=None)`` returns a bundle bound to one
device: ``cuda`` unless the caller names another (``device="cpu"`` runs the
plain PyTorch path).  Without a card and without an explicit device it
raises.  ``flags`` (:class:`~repro_torch.models.transformer.RuntimeFlags`)
picks prefill's attention (the default is the reference's, ``chunked``)
and the MoE dispatch.  An encoder-decoder config
(:mod:`~repro_torch.models.encdec`) dispatches ``init``, ``train_loss``,
``prefill``, ``decode_step`` and ``init_cache`` to its own stack.
``input_specs(cell)`` and ``cache_specs(cell)`` describe a shape cell's
inputs and decode cache as meta tensors (shapes and dtypes, no memory),
which the step builders and the dry-run read."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PREFILL, TRAIN, ModelConfig, ShapeCell
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import RuntimeFlags, dtype_of


def stack_of(cfg: ModelConfig):
    """The module of a config's dense entry points."""
    return encdec if cfg.enc_dec else transformer


def param_build(cfg: ModelConfig):
    """The config's param builder on the meta device (paths, shapes,
    dtypes and logical axes; no memory)."""
    return stack_of(cfg).build_params(cfg, None, "meta")


@dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    flags: RuntimeFlags = RuntimeFlags()

    @property
    def _stack(self):
        """The module of the config's dense entry points."""
        return stack_of(self.cfg)

    def init(self, generator: torch.Generator) -> dict:
        """Fresh weights drawn from ``generator`` (a generator on the
        bundle's device)."""
        return self._stack.init_params(self.cfg, generator, self.device)

    def abstract_params(self):
        """(the params on the meta device: paths, shapes and dtypes with
        no memory, their logical-axes tree), the reference's
        ``abstract_params()``."""
        b = param_build(self.cfg)
        return b.params, b.specs

    def param_specs(self) -> dict:
        """The params' logical-axes tree (a tuple of axis names, or None,
        per dimension of each leaf), built on the meta device: the
        counterpart of the reference's ``abstract_params()[1]``, which
        :mod:`repro_torch.dist.sharding` maps onto mesh axes."""
        return param_build(self.cfg).specs

    def train_loss(self, params, batch: dict):
        """(loss, dict(ce=, aux=)) of a training batch, differentiable
        (:func:`~repro_torch.models.transformer.train_loss`)."""
        return self._stack.train_loss(params, self.cfg, self.flags, batch)

    # -- dense KV backend ------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   enc_len: Optional[int] = None) -> dict:
        """The dense decode cache; an encoder-decoder's is split, with
        ``enc_len`` cross rows (default ``max_len``)."""
        if self.cfg.enc_dec:
            return encdec.init_cache(self.cfg, batch, max_len,
                                     enc_len or max_len, self.device)
        return transformer.init_cache(self.cfg, batch, max_len, self.device,
                                      kv_dtype=self.flags.kv_dtype)

    def input_specs(self, cell: ShapeCell) -> dict:
        """Meta stand-ins for every data input of ``cell``, the
        reference's shapes and dtypes: a train or prefill cell's tokens
        (and labels; an encoder-decoder's frames and decoder tokens; a
        frontend's patch embeddings, at most half the sequence), a decode
        cell's one token per slot and a scalar position."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        meta = lambda shape, dt=torch.int32: torch.empty(shape, dtype=dt,
                                                         device="meta")
        cdt = dtype_of(cfg.compute_dtype)
        if cell.kind in (TRAIN, PREFILL):
            if cfg.enc_dec:
                d = dict(frames=meta((b, s, cfg.d_model), cdt),
                         dec_tokens=meta((b, s)))
            elif cfg.frontend:
                p = min(cfg.num_frontend_tokens, s // 2)
                d = dict(patch_embeds=meta((b, p, cfg.d_model), cdt),
                         tokens=meta((b, s - p)))
            else:
                d = dict(tokens=meta((b, s)))
            if cell.kind == TRAIN:
                d["labels"] = meta((b, s))
            return d
        return dict(tokens=meta((b, 1)), pos=meta(()))

    def cache_specs(self, cell: ShapeCell) -> dict:
        """The decode cache of ``cell`` (batch ``global_batch``, length
        ``seq_len``; an encoder-decoder's cross rows too) on the meta
        device."""
        if self.cfg.enc_dec:
            return encdec.init_cache(self.cfg, cell.global_batch,
                                     cell.seq_len, cell.seq_len, "meta")
        return transformer.init_cache(self.cfg, cell.global_batch,
                                      cell.seq_len, "meta",
                                      kv_dtype=self.flags.kv_dtype)

    def prefill(self, params, batch: dict):
        return self._stack.prefill(params, self.cfg, self.flags, batch)

    def decode_step(self, params, cache, tokens, pos):
        return self._stack.decode_step(params, self.cfg, self.flags, cache,
                                       tokens, pos)

    # -- paged KV backend ------------------------------------------------
    def paged_supported(self) -> bool:
        """Every decoder-only stack serves from the shared page pools:
        full-attention layers grow a page table, windowed layers keep a
        rotating ring of pages, recurrent layers keep dense per-slot state
        beside the pools, int8 KV stores scale lanes.  Encoder-decoder
        stacks (a split cache) and modality frontends fall back to the
        dense cache, as in the reference."""
        return not (self.cfg.enc_dec or self.cfg.frontend)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         ring_pages: int = 0, batch: int = 1) -> dict:
        return transformer.init_paged_cache(self.cfg, num_pages, page_size,
                                            self.device,
                                            ring_pages=ring_pages,
                                            kv_dtype=self.flags.kv_dtype,
                                            batch=batch)

    def paged_decode_step(self, params, cache, tokens, pos, table,
                          active=None):
        return transformer.paged_decode_step(params, self.cfg, self.flags,
                                             cache, tokens, pos, table,
                                             active)

    def paged_prefill_chunk(self, params, cache, tokens, pos, table,
                            chunk_valid, slot=None):
        return transformer.paged_prefill_chunk(params, self.cfg, self.flags,
                                               cache, tokens, pos, table,
                                               chunk_valid, slot)

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
