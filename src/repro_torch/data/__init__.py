"""Synthetic training data (the port of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
