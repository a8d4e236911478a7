"""Logical-axis sharding: the rule tables, per-tensor specs and the policy
registry (the port of ``repro.dist.sharding``).

Model code never names a mesh axis: :class:`~repro_torch.models.common.
ParamBuilder` records *logical* axis names per tensor, and a
:class:`ShardingPolicy` maps them onto mesh axes here.  A rule fires only
when the dimension divides by the mesh axes' product and the mesh axis is
not already used by an earlier dimension of the same tensor; anything
unmatched stays replicated, so a policy written for a large mesh degrades
to a small one or to an odd-sized smoke model.

A spec is a tuple with one entry per dimension: ``None`` (replicated), a
mesh axis name, or a tuple of them (the reference's ``PartitionSpec``
entries).  Where the reference hands a spec to GSPMD, the port stores a
tensor as the distinct blocks its spec cuts it into (:class:`Sharded`,
:func:`cut`, :func:`assemble`): block b along a dimension split over
mesh axes ``(a1, a2)`` is the b-th of ``size(a1) * size(a2)`` contiguous
equal slices, and it sits on the mesh device whose coordinates along
those axes spell b (row-major) and are 0 along every axis the spec does
not name.  A tensor the spec replicates along an axis is stored once,
not once per device along it.  The activation rules only describe
layouts: :meth:`ShardingPolicy.sharder` says where an activation lives,
and the single controller's layer code (:mod:`repro_torch.models.
transformer`) places it there itself.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

# a rule maps one logical axis name to one mesh axis or an ordered tuple
# of mesh axes (batch -> ("pod", "data"))
Rule = Tuple[str, Union[str, Tuple[str, ...]]]
Rules = Tuple[Rule, ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# ---------------------------------------------------------------------------
# rule tables (the reference's)
# ---------------------------------------------------------------------------

# FSDP x TP: "model" splits the wide per-layer dims, "data" the embed dim
PARAM_RULES_FSDP: Rules = (
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("expert", "model"),
    ("vocab", "model"),
    ("embed", "data"),
)

# pure tensor parallelism: params split across "model", replicated across
# "data"
PARAM_RULES_TP: Rules = tuple(
    (l, m) for l, m in PARAM_RULES_FSDP if l != "embed")

# activations: batch spans the data-parallel axes, the wide dims follow
# the TP split of the weights that produce them
ACT_RULES_TP: Rules = (
    ("batch", ("pod", "data")),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("expert", "model"),
    ("vocab", "model"),
)

# sequence parallelism: residual-stream activations also split seq over
# "model" ("seq" wins the axis on (batch, seq, embed) tensors)
ACT_RULES_SP: Rules = (("batch", ("pod", "data")), ("seq", "model")) + tuple(
    r for r in ACT_RULES_TP if r[0] != "batch")

# the data-parallel batch rule alone
BATCH_RULES: Rules = (("batch", ("pod", "data")),)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (or anything with a ``.shape`` map)."""
    return dict(mesh.shape)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Rules, mesh) -> Spec:
    """The spec of one tensor from its logical axes.

    For each dimension, left to right, the first rule naming its logical
    axis contributes its mesh axes; a mesh axis is used at most once per
    tensor, and only while the product of the axes assigned so far still
    divides the dimension.  A scalar gives ``()``; an unmatched dimension
    ``None``."""
    sizes = _mesh_sizes(mesh)
    rule_map = {}
    for logical, mesh_axes in rules:
        rule_map.setdefault(
            logical,
            (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes))
    used: set = set()
    parts = []
    for dim, logical in zip(shape, axes):
        assigned: Tuple[str, ...] = ()
        total = 1
        for axis in rule_map.get(logical, ()):
            size = sizes.get(axis)
            if size is None or axis in used:
                continue
            if dim % (total * size) != 0:
                continue
            assigned += (axis,)
            total *= size
        used.update(assigned)
        if not assigned:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(assigned)
    return tuple(parts)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_coords(mesh, k: int) -> dict:
    """{axis: coordinate} of the mesh's k-th device (row-major, the last
    axis fastest)."""
    out = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        out[name] = k % size
        k //= size
    return out


def mesh_index(mesh, coords: dict) -> int:
    """The flat index of the device at ``coords`` (axes left out are 0)."""
    k = 0
    for name, size in zip(mesh.axis_names, mesh.sizes):
        k = k * size + coords.get(name, 0)
    return k


class Sharded:
    """One tensor stored as the distinct blocks its ``spec`` cuts it into
    over ``mesh``: ``blocks`` in row-major order of the block ``grid``
    (blocks per dimension), block i on ``mesh.devices[owners[i]]``, each
    owning its storage.  ``shape`` and ``dtype`` are the whole tensor's."""

    def __init__(self, shape, dtype, spec, mesh, blocks: List[torch.Tensor],
                 owners: List[int]):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = tuple(spec)
        self.mesh = mesh
        self.blocks = list(blocks)
        self.owners = list(owners)

    @property
    def grid(self) -> Tuple[int, ...]:
        return block_grid(self.spec, self.mesh)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def block_bytes(self) -> List[Tuple[int, int]]:
        """[(owner, bytes)] of every block."""
        return [(o, b.numel() * b.element_size())
                for o, b in zip(self.owners, self.blocks)]

    def map_blocks(self, fn) -> "Sharded":
        """A Sharded of the same layout with ``fn`` over each block."""
        out = [fn(b) for b in self.blocks]
        return Sharded(self.shape, out[0].dtype, self.spec, self.mesh, out,
                       self.owners)

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, grid={self.grid})")


def block_grid(spec, mesh) -> Tuple[int, ...]:
    """Blocks per dimension of a spec over ``mesh``."""
    sizes = _mesh_sizes(mesh)
    return tuple(math.prod(sizes[a] for a in spec_axes(e)) for e in spec)


def block_owner(spec, mesh, coord: Sequence[int]) -> int:
    """The flat mesh index of the device that owns the block at grid
    ``coord``: its coordinates along the spec's axes spell the block
    index (row-major within an entry), 0 along every other axis."""
    sizes = _mesh_sizes(mesh)
    coords = {}
    for entry, b in zip(spec, coord):
        for a in reversed(spec_axes(entry)):
            coords[a] = b % sizes[a]
            b //= sizes[a]
    return mesh_index(mesh, coords)


def block_slices(shape, grid, coord) -> Tuple[slice, ...]:
    return tuple(slice(b * (n // g), (b + 1) * (n // g))
                 for n, g, b in zip(shape, grid, coord))


def cut(t: torch.Tensor, spec, mesh) -> Sharded:
    """``t`` cut into the blocks ``spec`` gives over ``mesh``, each a copy
    (never a view of ``t`` nor of another block) on its owner's device."""
    spec = tuple(spec)
    grid = block_grid(spec, mesh)
    blocks, owners = [], []
    for coord in itertools.product(*(range(g) for g in grid)):
        k = block_owner(spec, mesh, coord)
        part = t[block_slices(t.shape, grid, coord)]
        blocks.append(part.to(mesh.devices[k], copy=True).contiguous())
        owners.append(k)
    return Sharded(t.shape, t.dtype, spec, mesh, blocks, owners)


def assemble(x, device=None) -> torch.Tensor:
    """The whole tensor of a :class:`Sharded` on ``device`` (default: the
    first block's); a plain tensor comes back moved."""
    if not isinstance(x, Sharded):
        return x if device is None else x.to(device)
    device = x.device if device is None else torch.device(device)
    grid = x.grid

    def build(prefix):
        if len(prefix) == len(grid):
            i = 0
            for g, b in zip(grid, prefix):
                i = i * g + b
            return x.blocks[i].to(device)
        d = len(prefix)
        parts = [build(prefix + (j,)) for j in range(grid[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return build(())


def is_spec(x) -> bool:
    """True for one spec (a plain tuple of None, axis names and tuples of
    them), the leaf of a spec tree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def cut_tree(tree, specs, mesh):
    """:func:`cut` over a tree (dicts, NamedTuples) and its spec tree; a
    scalar (spec ``()``) stays one tensor, moved to the mesh's first
    device."""
    from repro_torch.tree import leaves_with_paths, unflatten_like
    spec_of = dict(leaves_with_paths(specs, is_leaf=is_spec))
    out = {}
    for path, t in leaves_with_paths(tree):
        spec = spec_of[path]
        out[path] = (t.to(mesh.devices[0], copy=True) if len(spec) == 0
                     else cut(t, spec, mesh))
    return unflatten_like(tree, out)


def assemble_tree(tree, device=None):
    """:func:`assemble` over every leaf of a tree."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: assemble(x, device), tree)


def _map_specs(fn, params, specs):
    """``fn(leaf, axes)`` over a nested dict of tensors and its parallel
    tree of logical-axes tuples."""
    return {k: (_map_specs(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in params.items()}


def param_shardings(mesh, params, specs, rules: Rules):
    """The tree of per-leaf specs matching ``params`` (tensors, meta ones
    included, or anything with a ``.shape``); ``specs`` is its parallel
    tree of logical axes (:meth:`ModelBundle.param_specs`)."""
    return _map_specs(lambda p, ax: spec_for(tuple(p.shape), ax, rules, mesh),
                      params, specs)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardingPolicy:
    """One named distribution strategy: how params, activations and the
    data batch map onto mesh axes, and how many parallel access engines
    the mesh gives it."""

    name: str
    param_rules: Rules
    act_rules: Rules
    batch_rules: Rules = BATCH_RULES
    description: str = ""

    def param_shardings(self, mesh, params, specs):
        """The per-leaf specs of ``params`` (tensors, meta ones included)
        under the param rules: what the trainer cuts the state by, the
        checkpoint restores onto and the dry-run counts."""
        return param_shardings(mesh, params, specs, self.param_rules)

    def sharder(self, mesh):
        """The activation layout under ``act_rules``: ``shd(x, axes)`` is
        the spec of an activation ``x`` (anything with a ``.shape``) with
        logical ``axes``, which says where it lives (batch over the data
        rows, the wide dims over the model columns, and, under sequence
        parallelism, the residual stream's seq over the model columns).
        The reference's sharder constrains the array to that layout; the
        port's layer code reads it and places the activation itself."""
        def shd(x, axes):
            return spec_for(tuple(x.shape), axes, self.act_rules, mesh)
        return shd

    def batch_sharding(self, mesh, aval) -> Spec:
        """The spec of one data-batch leaf: axis 0 is the global batch."""
        ndim = len(aval.shape)
        axes = ("batch",) + (None,) * (ndim - 1) if ndim else ()
        return spec_for(tuple(aval.shape), axes, self.batch_rules, mesh)

    def batch_shardings(self, mesh, batch):
        return {k: (self.batch_shardings(mesh, v) if isinstance(v, dict)
                    else self.batch_sharding(mesh, v))
                for k, v in batch.items()}

    @staticmethod
    def _axes_product(mesh, rules: Rules) -> int:
        sizes = _mesh_sizes(mesh)
        known = {a for _, axes in rules
                 for a in ((axes,) if isinstance(axes, str) else axes)}
        n = 1
        for axis, size in sizes.items():
            if axis in known:
                n *= size
        return max(1, n)

    def engines(self, mesh) -> int:
        """Parallel access engines this policy runs on ``mesh``: the
        product of the mesh axes its rules name (the paper's multi-engine
        knob, Tables 3-5; it assumes tensor dims divide the axes)."""
        return self._axes_product(
            mesh, self.param_rules + self.act_rules + self.batch_rules)

    def param_engines(self, mesh) -> int:
        """Shards each parameter is split across (1 for pure DP)."""
        return self._axes_product(mesh, self.param_rules)

    def data_engines(self, mesh) -> int:
        """Shards the data batch is split across (the DP degree)."""
        return self._axes_product(mesh, self.batch_rules)


POLICIES = {
    p.name: p
    for p in (
        ShardingPolicy(
            name="dp", param_rules=(), act_rules=BATCH_RULES,
            description="pure data parallelism: params/opt replicated, "
                        "batch split over (pod, data)"),
        ShardingPolicy(
            name="tp", param_rules=PARAM_RULES_TP, act_rules=ACT_RULES_TP,
            description="tensor parallelism only: wide dims over 'model', "
                        "params replicated across 'data'"),
        ShardingPolicy(
            name="fsdp_tp", param_rules=PARAM_RULES_FSDP,
            act_rules=ACT_RULES_TP,
            description="FSDP over 'data' x TP over 'model' (the deployable "
                        "default; optimizer state shards like params)"),
        ShardingPolicy(
            name="fsdp_tp_sp", param_rules=PARAM_RULES_FSDP,
            act_rules=ACT_RULES_SP,
            description="fsdp_tp + sequence-parallel residual activations "
                        "(seq over 'model' between matmul regions)"),
    )
}
