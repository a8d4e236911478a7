"""Configuration dataclasses (the port's copy of ``repro.configs.base``).

Plain frozen dataclasses with the same fields and defaults as the
reference, so a config prints, hashes and diffs the same way in both
packages.  The port serves the ATTN + DENSE full-attention decoders; the
other mixer and mlp kinds are named here so every field of the reference
has its counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# mixer kinds
ATTN = "attn"            # softmax attention (GQA / MQA / MHA)
SSD = "ssd"              # Mamba-2 state-space-duality mixer
RGLRU = "rglru"          # Griffin RG-LRU recurrent mixer

# mlp kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a (mixer, mlp) pair."""

    mixer: str = ATTN
    mlp: str = DENSE
    sliding_window: Optional[int] = None     # None = full (global) attention

    @property
    def is_local_attn(self) -> bool:
        return self.mixer == ATTN and self.sliding_window is not None


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # None => d_model // num_heads

    # layer pattern (repeats to num_layers); default = uniform attn+dense
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # ffn / embedding
    activation: str = "swiglu"       # swiglu | geglu | gelu
    tie_embeddings: bool = False
    normalize_embedding: bool = False  # gemma scales embeddings by sqrt(d_model)

    # attention extras
    rope_theta: float = 10_000.0
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # Mamba-2 / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # RG-LRU
    lru_width: Optional[int] = None

    # encoder-decoder
    enc_dec: bool = False
    num_encoder_layers: int = 0

    # modality frontends
    frontend: Optional[str] = None   # None | "patches" | "frames"
    num_frontend_tokens: int = 0

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_pattern_blocks(self) -> int:
        """Full pattern repetitions (stacked on the LAYERS axis)."""
        return self.num_layers // self.pattern_len

    @property
    def remainder_specs(self) -> Tuple[LayerSpec, ...]:
        """Trailing layers beyond the stacked blocks (unstacked params)."""
        rem = self.num_layers % self.pattern_len
        return tuple(self.layer_pattern[i] for i in range(rem))


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.layer_pattern
    updates = dict(
        num_layers=len(pat) if not cfg.enc_dec else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        num_encoder_layers=2 if cfg.enc_dec else 0,
        num_frontend_tokens=8 if cfg.frontend else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.num_experts:
        updates.update(num_experts=4, num_experts_per_tok=2)
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.lru_width:
        updates.update(lru_width=64)
    new_pat = tuple(
        replace(s, sliding_window=(16 if s.sliding_window is not None else None))
        for s in pat)
    return replace(cfg, layer_pattern=new_pat, **updates)


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    return replace(cfg, **kw)

