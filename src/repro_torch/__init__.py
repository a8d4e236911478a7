"""memroof on PyTorch: the port of :mod:`repro` to PyTorch and CUDA (Hopper).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``configs``, ``models``, ``kernels``, ``serve``, ``tune``,
``launch``) module for module and imports nothing of it.  Every Pallas
kernel on a ported path becomes a CUDA kernel written by hand for
``sm_90a`` (``kernels/csrc``), with a plain PyTorch version beside it that
the CPU path runs.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  Without a card and without an explicit device this
    raises rather than quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is visible: repro_torch entry points run on "
                "'cuda' by default; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
