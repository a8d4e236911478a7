"""granite-moe-3b-a800m — fine-grained MoE [hf:ibm-granite].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 40
experts top-8.  (The source config line says 40 experts top-8; its prose
says 32; the config line is followed.)
"""
from repro_torch.configs.base import MOE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    layer_pattern=(LayerSpec(mlp=MOE),),
    num_experts=40,
    num_experts_per_tok=8,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
