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
entries).  The reference's GSPMD activation ``sharder`` has no
counterpart: under explicit tensor parallelism the layer code places
activations itself (:mod:`repro_torch.models.transformer`), so the
activation rules here only describe layouts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

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
        return param_shardings(mesh, params, specs, self.param_rules)

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
