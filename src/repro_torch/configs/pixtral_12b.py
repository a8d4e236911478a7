"""pixtral-12b — pixtral-ViT frontend + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  The vision
frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (B, P, d_model) that the backbone prepends to the text tokens; the
cell's seq_len is the total (patch + text) sequence length.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    layer_pattern=(LayerSpec(),),
    activation="swiglu",
    rope_theta=1_000_000.0,
    frontend="patches",
    num_frontend_tokens=1024,   # e.g. a 512x512 image at patch 16 => 32x32
)
