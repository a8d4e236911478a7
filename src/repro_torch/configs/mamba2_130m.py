"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060].

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128.  Pure SSM: every layer is a
Mamba-2 mixer with no FFN (d_ff=0).  Sub-quadratic => runs long_500k.
"""
from repro_torch.configs.base import SSD, NONE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # d_inner / ssm_head_dim = 1536/64
    num_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=(LayerSpec(mixer=SSD, mlp=NONE),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    tie_embeddings=True,
    activation="gelu",
)
