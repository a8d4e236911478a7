"""Architecture registry: ``--arch <id>`` resolves through :data:`ARCHS`.

The port serves the ATTN + DENSE decoders of ``repro.configs``: gemma-2b,
gemma2-27b (sliding-window/global pairs, both softcaps), internlm2-20b and
phi4-mini-3.8b.  The other architectures join as their layers are
ported."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, DENSE, LayerSpec, ModelConfig, override, smoke_config,
)
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.phi4_mini_3p8b import CONFIG as PHI4_MINI_3P8B

ARCHS = {c.name: c for c in (GEMMA_2B, GEMMA2_27B, INTERNLM2_20B,
                             PHI4_MINI_3P8B)}
