"""phi4-mini-3.8b — RoPE SwiGLU GQA [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    layer_pattern=(LayerSpec(),),
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
