"""The train, prefill and decode steps over a mesh (the port of
``repro.dist.steps``).

Each builder returns the step and the spec trees callers place state by
(:class:`~repro_torch.train.loop.Trainer`, the checkpoint's restore,
the dry-run's accounting): the policy's per-leaf specs over the mesh.

On one device the train step computes the loss and its gradients with
autograd, adds microbatches' float32 gradients in order and divides by
their count (with the synthetic LM's always-valid labels that is the
full-batch step, the mean of per-slice means), then applies AdamW in
place.  Over a mesh of more than one device the state is stored as
:class:`~repro_torch.dist.sharding.Sharded` blocks by the policy's specs
(``Trainer.init_state`` cuts it), each data row of the mesh takes its
slice of the batch and each microbatch slices every row's slice
(:mod:`repro_torch.models.sharded` runs the stack); gradients are taken
with respect to the blocks, so AdamW updates each block where it is
stored.

The prefill and decode steps run the policy's params the same way; the
decode cache is sharded on its batch dim only (:func:`cache_shardings`)
and written in place (the reference donates it).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import (Sharded, ShardingPolicy, cut_tree,
                                       spec_for)
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_paths, tree_map, unflatten_like


def value_and_grad(loss_fn, params, *args):
    """(loss detached, aux detached, float32-or-native gradient tree) of
    ``loss_fn(params, *args) -> (loss, aux dict)``; gradients come from
    ``torch.autograd.grad``, so nothing accumulates in ``.grad`` and the
    graph is freed when they are taken.  A param the loss does not reach
    gets zeros.  A leaf stored over a mesh gets its gradient in the same
    blocks."""
    named = leaves_with_paths(params)
    flat = [b for _, p in named
            for b in (p.blocks if isinstance(p, Sharded) else [p])]
    for b in flat:
        if not b.requires_grad:
            b.requires_grad_(True)
    loss, aux = loss_fn(params, *args)
    gs = list(torch.autograd.grad(loss, flat, allow_unused=True))
    gs = [torch.zeros_like(b) if g is None else g for b, g in zip(flat, gs)]
    out = {}
    for path, p in named:
        if isinstance(p, Sharded):
            n = len(p.blocks)
            out[path] = Sharded(p.shape, gs[0].dtype, p.spec, p.mesh,
                                gs[:n], p.owners)
            del gs[:n]
        else:
            out[path] = gs.pop(0)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            unflatten_like(params, out))


def with_policy(bundle, mesh, policy: ShardingPolicy):
    """The bundle bound to ``mesh`` under ``policy``: its flags carry
    both, so the model's entry points run over the mesh, and its device
    is the mesh's first."""
    flags = dataclasses.replace(bundle.flags, mesh=mesh, policy=policy)
    return dataclasses.replace(bundle, flags=flags, device=mesh.devices[0])


def _float(g):
    return g.map_blocks(lambda b: b.float()) if isinstance(g, Sharded) \
        else g.float()


def _add_(a, g):
    if isinstance(a, Sharded):
        for x, y in zip(a.blocks, g.blocks):
            x.add_(y)
        return a
    return a.add_(g)


def _div_(a, m):
    for b in (a.blocks if isinstance(a, Sharded) else [a]):
        b.div_(m)
    return a


def _micro(v, m: int, i: int):
    return v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_train_step(bundle, mesh, policy: ShardingPolicy,
                    opt_cfg: adamw.AdamWConfig, microbatches: int = 1):
    """(step_fn, param specs, optimizer-state specs, batch_sharder).

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``;
    params and the moments are updated in place.  Over a mesh of more
    than one device the params and moments are trees of ``Sharded``
    blocks cut by the specs returned here, and ``batch`` is whole or
    placed per data row (:func:`repro_torch.models.sharded.place_batch`).
    ``batch_sharder`` maps a batch (anything with shapes) to the
    policy's data-parallel specs.  ``microbatches=m`` cuts the batch
    (each data row's slice of it) into m equal slices along axis 0."""
    many = len(mesh.devices) > 1
    if many:
        bundle = with_policy(bundle, mesh, policy)
    abs_params, specs = bundle.abstract_params()
    p_shard = policy.param_shardings(mesh, abs_params, specs)
    o_shard = adamw.AdamWState(step=(), m=p_shard, v=p_shard)

    def batch_sharder(abs_batch):
        return policy.batch_shardings(mesh, abs_batch)

    m = max(1, int(microbatches))

    def step(params, opt_state, batch):
        if many:
            from repro_torch.models.sharded import place_batch
            batch = place_batch(batch, bundle.flags)
            slices = [{k: [_micro(t, m, i) for t in v]
                       for k, v in batch.items()} for i in range(m)]
        else:
            slices = [{k: _micro(v, m, i) for k, v in batch.items()}
                      for i in range(m)]
        loss = aux = grads = None
        for mb in slices:
            li, ai, gi = value_and_grad(bundle.train_loss, params, mb)
            gi = tree_map(_float, gi)
            if grads is None:           # the reference's zeros + the first
                loss, aux, grads = li, ai, gi
            else:
                loss = loss + li
                aux = {k: aux[k] + v for k, v in ai.items()}
                grads = tree_map(_add_, grads, gi)
            del gi
        if m > 1:
            loss = loss / m
            aux = {k: v / m for k, v in aux.items()}
            grads = tree_map(lambda g: _div_(g, m), grads)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        del grads
        return params, opt_state, dict(loss=loss, **aux, **om)

    return step, p_shard, o_shard, batch_sharder


def shard_state(params, p_shard, mesh):
    """A whole param tree cut into the blocks of ``p_shard`` over
    ``mesh``, with fresh AdamW moments in the same blocks (on one device:
    the tree itself)."""
    if len(mesh.devices) > 1:
        params = cut_tree(params, p_shard, mesh)
    return params, adamw.init(params)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def batch_dim(path) -> int:
    """The batch dim of a decode-cache leaf at ``path``: 1 under
    ``blocks``/``dec`` (a leading LAYERS axis), else 0."""
    return 1 if any(str(p) in ("blocks", "dec") for p in path) else 0


def cache_shardings(mesh, cache_abs, policy: ShardingPolicy):
    """Batch-dim data-parallel specs of a decode-cache tree: stacked
    leaves (under ``blocks``/``dec``) carry batch at axis 1, remainder and
    encoder leaves at axis 0.  Only the batch dim is sharded (KV length
    and heads stay with the slot, so the per-slot decode write never
    crosses shards); a batch that does not divide is replicated."""
    out = {}
    for path, a in leaves_with_paths(cache_abs):
        bd = batch_dim(path)
        axes = [None] * len(a.shape)
        if len(a.shape) > bd:
            axes[bd] = "batch"
        out[path] = spec_for(tuple(a.shape), axes, policy.batch_rules, mesh)
    return unflatten_like(cache_abs, out)


def make_prefill_step(bundle, mesh, policy: ShardingPolicy, cell):
    """(step, param specs); ``step(params, batch) -> (cache, last
    logits (B, V))``.  Over a mesh of more than one device ``params``
    are ``Sharded`` blocks by the specs (or whole tensors, cut on entry)
    and the cache comes back cut on its batch dim
    (:func:`cache_shardings`)."""
    many = len(mesh.devices) > 1
    if many:
        bundle = with_policy(bundle, mesh, policy)
    abs_params, specs = bundle.abstract_params()
    p_shard = policy.param_shardings(mesh, abs_params, specs)

    def step(params, batch):
        if many:
            from repro_torch.models import sharded
            return sharded.prefill(params, bundle.cfg, bundle.flags, batch)
        return bundle.prefill(params, batch)

    return step, p_shard


def make_decode_step(bundle, mesh, policy: ShardingPolicy, cell):
    """(step, param specs, cache specs).

    ``step(params, cache, tokens, pos) -> (logits, cache)`` with the cache
    written in place (the reference donates it: decode is the
    steady-state loop).  ``pos`` may be a scalar (batch-uniform decode)
    or a per-slot vector (continuous batching).  Over a mesh of more than
    one device the cache is a tree of ``Sharded`` blocks cut by the cache
    specs (``cut_tree(cache, cache_specs, mesh)``)."""
    many = len(mesh.devices) > 1
    if many:
        bundle = with_policy(bundle, mesh, policy)
    abs_params, specs = bundle.abstract_params()
    p_shard = policy.param_shardings(mesh, abs_params, specs)
    c_shard = cache_shardings(mesh, bundle.cache_specs(cell), policy)

    def step(params, cache, tokens, pos):
        if many:
            from repro_torch.models import sharded
            return sharded.decode_step(params, bundle.cfg, bundle.flags,
                                       cache, tokens, pos)
        return bundle.decode_step(params, cache, tokens, pos)

    return step, p_shard, c_shard
