"""Weight bridge: a param tree of the reference package, handed over as
numpy arrays under the same dotted paths (``embed.tok``,
``blocks.p0.attn.wq``, ... with the LAYERS axis stacked), becomes the
port's tensors.  Both packages then compute the same function, which is
how the tests hold the port against the reference."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device) -> dict:
    """A nested dict of numpy arrays (any float dtype, bfloat16 included)
    -> the port's param dict on ``device`` in ``cfg.param_dtype``.  Raises
    unless the paths and shapes are exactly the port's own."""
    want = flatten(transformer.init_params(cfg, None, "meta"))
    got = flatten(tree)
    if set(want) != set(got):
        raise ValueError(f"param paths differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    dtype = transformer.dtype_of(cfg.param_dtype)
    out: dict = {}
    for path, ref in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        t = torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                        dtype=dtype)
        node = out
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return out
