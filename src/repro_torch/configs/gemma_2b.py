"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    layer_pattern=(LayerSpec(),),
    activation="geglu",
    tie_embeddings=True,
    normalize_embedding=True,
    rope_theta=10_000.0,
)
