"""Models: decoders of attention (full and sliding-window), RG-LRU and SSD
layers with a dense MLP, a mixture of experts or none, on a dense or a
paged KV cache, with a modality frontend's patch prefix; and the
encoder-decoder stack on its split dense cache."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
from repro_torch.models.transformer import RuntimeFlags  # noqa: F401
