"""Optimizer: AdamW with global-norm clipping, learning-rate schedules,
and int8 gradient compression with error feedback (the port of
``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: F401
                                     init, update)
from repro_torch.optim import compress, schedule  # noqa: F401
