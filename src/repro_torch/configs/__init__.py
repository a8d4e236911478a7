"""Architecture registry: ``--arch <id>`` resolves through :data:`ARCHS`.

All ten architectures of ``repro.configs``, as data: the advisor, the
parameter accounting and the roofline sweep read every one, and the port
builds and serves every one (``models.build``): the attention decoders,
the hybrid recurrent stacks, the MoE stacks, pixtral-12b's patch prefix
and seamless-m4t-medium's encoder-decoder."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, DENSE, MOE, NONE, RGLRU, SSD, TRAIN, PREFILL, DECODE,
    LM_SHAPES, SHAPES_BY_NAME, LayerSpec, ModelConfig, ShapeCell,
    override, shape_applicable, smoke_config,
)

from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.phi4_mini_3p8b import CONFIG as PHI4_MINI_3P8B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.grok1_314b import CONFIG as GROK1_314B
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM

ARCHS = {
    c.name: c
    for c in (
        MAMBA2_130M, GEMMA_2B, GEMMA2_27B, PHI4_MINI_3P8B, INTERNLM2_20B,
        RECURRENTGEMMA_9B, GRANITE_MOE_3B, GROK1_314B, PIXTRAL_12B,
        SEAMLESS_M4T_MEDIUM,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Yield every applicable (config, shape) cell with skip reasons."""
    for cfg in ARCHS.values():
        for cell in LM_SHAPES:
            ok, why = shape_applicable(cfg, cell)
            yield cfg, cell, ok, why
