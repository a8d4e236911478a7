"""gemma2-27b — local+global alternating attention, logit softcaps [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.  Layer pattern is a
(local sliding-window 4096, global) pair scanned 23 times.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    layer_pattern=(
        LayerSpec(sliding_window=4096),
        LayerSpec(sliding_window=None),
    ),
    activation="geglu",
    tie_embeddings=True,
    normalize_embedding=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=144.0,   # d_model / num_heads = 4608/32
    rope_theta=10_000.0,
)
