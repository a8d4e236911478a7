"""Data parallelism with explicit collectives and int8 + error-feedback
gradients (the port of ``repro.dist.dp_shardmap``).

One process drives every shard of the mesh's data axis, as
:class:`~repro_torch.dist.serve.ServeMesh` drives a tensor-parallel
group: each shard computes the gradient of its slice of the batch (axis
0) on its own device (the devices may repeat: two shards on one card, or
``["cpu", "cpu"]``), and the reduction is written out in shard order on
the first shard's device: the mean of the shards' float32 gradients, or,
with ``compress_grads``, the mean of each shard's int8 view of its
error-corrected gradient (:func:`repro_torch.optim.compress.
compressed_mean`), a 4x cut in the bytes a real all-reduce would move.
Every shard then holds the same reduced gradient and applies the same
AdamW update; the params and optimizer state are replicated, so it is
applied once, to the one copy.

Error-feedback buffers carry a leading per-shard axis
(:func:`init_error_feedback`: ``(n, *param.shape)`` float32 beside each
param): each shard owns its residual, which keeps the compression
unbiased per contributor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.dist.serve import reduce_sum
from repro_torch.optim import adamw, compress
from repro_torch.tree import leaves, leaves_with_paths, unflatten_like

AXIS = "data"


def init_error_feedback(params, num_devices: Optional[int] = None):
    """Zero float32 residuals, one slice per data-parallel shard, beside
    each param.  ``num_devices`` must equal the size of the mesh axis the
    step reduces over; the default (every visible card, at least one) is
    only right when the whole host is one data-parallel axis."""
    n = (num_devices if num_devices is not None
         else max(1, torch.cuda.device_count()))
    return unflatten_like(params, {
        path: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                          device=p.device)
        for path, p in leaves_with_paths(params)})


def make_dp_train_step(loss_fn: Callable, mesh,
                       opt_cfg: adamw.AdamWConfig,
                       compress_grads: bool = False,
                       axis_name: str = AXIS):
    """step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics).

    ``loss_fn(params, batch) -> scalar``; ``batch`` leaves split along
    axis 0 over the shards of ``axis_name``; params and optimizer state
    are one replicated copy on the first shard's device, updated in
    place, as are the residuals.  Metrics: ``loss`` (the shards' mean),
    ``grad_norm``, ``lr`` and, compressed, ``wire_bytes_saved``.  Mesh
    axes other than ``axis_name`` would compute redundantly: this is data
    parallelism only."""
    sizes = dict(mesh.shape)
    if axis_name not in sizes:
        raise ValueError(
            f"mesh has axes {sorted(sizes)}, expected data axis "
            f"{axis_name!r}")
    n_shards = sizes[axis_name]
    devs = mesh.devices_along(axis_name)
    home = devs[0]

    def step(params, opt_state, err, batch):
        for e in leaves(err):
            if e.shape[0] != n_shards:
                raise ValueError(
                    f"error-feedback leaves carry {e.shape[0]} residual "
                    f"slices but mesh axis {axis_name!r} has {n_shards} "
                    f"shard(s); build them with init_error_feedback(params, "
                    f"num_devices={n_shards})")
        named = leaves_with_paths(params)
        losses, grads = [], []
        for s, dev in enumerate(devs):
            mine = [p.detach().to(dev).requires_grad_(True) for _, p in named]
            tree = unflatten_like(params, {path: p for (path, _), p
                                           in zip(named, mine)})
            part = {k: torch.chunk(v, n_shards, dim=0)[s].to(dev)
                    for k, v in batch.items()}
            loss = loss_fn(tree, part)
            gs = torch.autograd.grad(loss, mine, allow_unused=True)
            losses.append(loss.detach())
            grads.append([torch.zeros(p.shape, dtype=torch.float32,
                                      device=dev) if g is None else g.float()
                          for p, g in zip(mine, gs)])
            del mine, tree, gs
        loss = reduce_sum(losses, home) / float(n_shards)
        err_of = dict(leaves_with_paths(err))
        reduced = {}
        for i, (path, p) in enumerate(named):
            shard_g = [g[i] for g in grads]
            if compress_grads:
                e = err_of[path]
                red, new_e = compress.compressed_mean(
                    shard_g, [e[s].to(dev) for s, dev in enumerate(devs)],
                    home)
                for s, ne in enumerate(new_e):
                    e[s].copy_(ne)
            else:
                red = reduce_sum(shard_g, home) / float(n_shards)
            reduced[path] = red
            for g in grads:
                g[i] = None
        new_p, new_opt, om = adamw.update(unflatten_like(params, reduced),
                                          opt_state, params, opt_cfg)
        metrics = dict(loss=loss, **om)
        if compress_grads:
            metrics["wire_bytes_saved"] = torch.tensor(
                float(compress.wire_bytes_saved(params)),
                dtype=torch.float32, device=home)
        return new_p, new_opt, err, metrics

    return step
