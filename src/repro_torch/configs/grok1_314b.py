"""grok-1-314b — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 (per expert) vocab=131072, MoE 8e
top-2, GeGLU-style gated experts (3 matrices — this is what lands the total at
~314B params; 6·64·3·6144·32768·8 ≈ 309B + attention + embeddings).
"""
from repro_torch.configs.base import MOE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    layer_pattern=(LayerSpec(mlp=MOE),),
    num_experts=8,
    num_experts_per_tok=2,
    activation="geglu",
    attn_logit_softcap=30.0,   # grok uses attn logit softcapping
    final_logit_softcap=30.0,
    rope_theta=10_000.0,
)
