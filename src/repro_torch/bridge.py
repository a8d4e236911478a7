"""Weight bridge: a param tree of the reference package, handed over as
numpy arrays under the same dotted paths (``embed.tok``,
``blocks.p0.attn.wq``, ... with the LAYERS axis stacked), becomes the
port's tensors.  Both packages then compute the same function, which is
how the tests hold the port against the reference; the optimizer state
crosses the same way (:func:`opt_state_from_numpy`)."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.optim.adamw import AdamWState


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
    mod = encdec if cfg.enc_dec else transformer
    want = flatten(mod.init_params(cfg, None, "meta"))
    got = flatten(tree)
    if set(want) != set(got):
        raise ValueError(f"param paths differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    return _nest(got, want, device, transformer.dtype_of(cfg.param_dtype))


def _nest(got: Dict[str, object], want: Dict[str, torch.Tensor], device,
          dtype: torch.dtype) -> dict:
    """{dotted path: array} with ``want``'s paths -> the nested dict of
    tensors on ``device`` in ``dtype``; raises on a shape that is not
    ``want``'s."""
    out: dict = {}
    for path, ref in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        node = out
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=dtype)
    return out


def opt_state_from_numpy(state, params: dict, device):
    """The reference's ``AdamWState`` (``step``, ``m``, ``v``, as numpy or
    anything ``np.asarray`` reads) -> the port's
    :class:`~repro_torch.optim.adamw.AdamWState` on ``device``: the step
    an int32 0-d tensor, the moments float32 trees with ``params``' paths
    (which must be exactly theirs)."""
    def tree(moments):
        got, want = flatten(moments), flatten(params)
        if set(got) != set(want):
            raise ValueError(f"moment paths differ from the params': "
                             f"{sorted(set(got) ^ set(want))}")
        return _nest(got, want, device, torch.float32)

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step=step, m=tree(state.m), v=tree(state.v))
