"""Architecture registry: ``--arch <id>`` resolves through :data:`ARCHS`.

The port serves the full-attention ATTN + DENSE decoders of
``repro.configs``: gemma-2b and phi4-mini-3.8b.  The other architectures
join as their layers are ported."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, DENSE, LayerSpec, ModelConfig, override, smoke_config,
)
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.phi4_mini_3p8b import CONFIG as PHI4_MINI_3P8B

ARCHS = {c.name: c for c in (GEMMA_2B, PHI4_MINI_3P8B)}
