"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  The audio frontend
is a STUB: the encoder consumes precomputed frame embeddings
(B, S, d_model).  12 encoder + 12 decoder layers; decoder layers add
cross-attention over the encoder memory.  Decode shapes lower ``serve_step``
(decoder self-attn KV cache + cross-attn to a seq_len-long encoder memory).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    layer_pattern=(LayerSpec(),),
    activation="gelu",
    enc_dec=True,
    num_encoder_layers=12,
    frontend="frames",
    rope_theta=10_000.0,
)
