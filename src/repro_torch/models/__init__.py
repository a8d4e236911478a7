"""Models: decoders of attention (full and sliding-window), RG-LRU and SSD
layers on a dense or a paged KV cache."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
from repro_torch.models.transformer import RuntimeFlags  # noqa: F401
