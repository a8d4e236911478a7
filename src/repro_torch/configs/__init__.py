"""Architecture registry: ``--arch <id>`` resolves through :data:`ARCHS`.

The port serves the full-attention ATTN + DENSE decoders; gemma-2b is the
first of them.  The other architectures of ``repro.configs`` join as their
layers are ported."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, DENSE, LayerSpec, ModelConfig, override, smoke_config,
)
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B

ARCHS = {c.name: c for c in (GEMMA_2B,)}
