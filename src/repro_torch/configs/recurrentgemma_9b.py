"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000.  Pattern is
(recurrent, recurrent, local-attn window 2048); 38 = 12 triples + 2 remainder
recurrent layers (matches the HF ``block_types[i % 3]`` layout exactly).
Sub-quadratic (bounded attention window) => runs long_500k.
"""
from repro_torch.configs.base import ATTN, RGLRU, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    layer_pattern=(
        LayerSpec(mixer=RGLRU),
        LayerSpec(mixer=RGLRU),
        LayerSpec(mixer=ATTN, sliding_window=2048),
    ),
    lru_width=4096,
    activation="geglu",
    tie_embeddings=True,
    normalize_embedding=True,
    rope_theta=10_000.0,
)
