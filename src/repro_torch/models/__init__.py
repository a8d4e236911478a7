"""Models: the ATTN + DENSE decoder on a paged KV cache."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
