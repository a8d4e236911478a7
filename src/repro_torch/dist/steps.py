"""The train step over a one-device mesh (the port of ``repro.dist.
steps``' ``make_train_step``).

The step computes the loss and its gradients with autograd, adds
microbatches' float32 gradients in order and divides by their count
(with the synthetic LM's always-valid labels that is the full-batch
step, the mean of per-slice means), then applies AdamW in place.  The
sharding trees it returns are the policy's specs over the mesh (on one
device every entry replicates), which is what the trainer and the
checkpoint read.  A mesh of more than one device waits for ROADMAP A10b
(FSDP x TP under the single controller); the prefill and decode step
builders wait with it.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import ShardingPolicy
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_paths, tree_map, unflatten_like


def value_and_grad(loss_fn, params, *args):
    """(loss detached, aux detached, float32-or-native gradient tree) of
    ``loss_fn(params, *args) -> (loss, aux dict)``; gradients come from
    ``torch.autograd.grad``, so nothing accumulates in ``.grad`` and the
    graph is freed when they are taken.  A param the loss does not reach
    gets zeros."""
    named = leaves_with_paths(params)
    for _, p in named:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, aux = loss_fn(params, *args)
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = unflatten_like(params, {
        path: (torch.zeros_like(p) if g is None else g)
        for (path, p), g in zip(named, gs)})
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}, grads)


def make_train_step(bundle, mesh, policy: ShardingPolicy,
                    opt_cfg: adamw.AdamWConfig, microbatches: int = 1):
    """(step_fn, param specs, optimizer-state specs, batch_sharder).

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``;
    params and the moments are updated in place.  ``batch_sharder`` maps
    a batch (anything with shapes) to the policy's data-parallel specs.
    ``microbatches=m`` cuts the batch into m equal slices along axis 0."""
    if len(mesh.devices) > 1:
        raise NotImplementedError(
            f"training over a mesh of {len(mesh.devices)} devices "
            f"({dict(mesh.shape)}) is ROADMAP A10b (FSDP x TP under the "
            "single controller); the port trains on one device, or data-"
            "parallel through repro_torch.dist.dp_shardmap")
    abs_params, specs = bundle.abstract_params()
    p_shard = policy.param_shardings(mesh, abs_params, specs)
    o_shard = adamw.AdamWState(step=(), m=p_shard, v=p_shard)

    def batch_sharder(abs_batch):
        return policy.batch_shardings(mesh, abs_batch)

    m = max(1, int(microbatches))

    def step(params, opt_state, batch):
        loss = aux = grads = None
        for i in range(m):
            mb = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            li, ai, gi = value_and_grad(bundle.train_loss, params, mb)
            gi = tree_map(lambda g: g.float(), gi)
            if grads is None:           # the reference's zeros + the first
                loss, aux, grads = li, ai, gi
            else:
                loss = loss + li
                aux = {k: aux[k] + v for k, v in ai.items()}
                grads = tree_map(lambda a, g: a.add_(g), grads, gi)
            del gi
        if m > 1:
            loss = loss / m
            aux = {k: v / m for k, v in aux.items()}
            grads = tree_map(lambda g: g.div_(m), grads)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        del grads
        return params, opt_state, dict(loss=loss, **aux, **om)

    return step, p_shard, o_shard, batch_sharder
