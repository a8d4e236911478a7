"""Distribution layer: sharding policies, the serving mesh, the train
step and data-parallel training.

A :class:`~repro_torch.dist.sharding.ShardingPolicy` maps the models'
*logical* axis names onto mesh axes (with a divisibility fallback), and
:class:`~repro_torch.dist.serve.ServeMesh` spreads one serving engine
over a tensor-parallel device group, driven from one process with the
collectives written out as device-to-device copies.
:func:`~repro_torch.dist.steps.make_train_step` builds the train step
over a one-device mesh, and :mod:`~repro_torch.dist.dp_shardmap` trains
data-parallel with explicit collectives (int8 + error-feedback
gradients optional), one process driving every shard; over a mesh of
more devices the train, prefill and decode steps run FSDP x TP
(:mod:`~repro_torch.dist.fsdp`, :mod:`repro_torch.models.sharded`).
:mod:`~repro_torch.dist.tp` holds the copies between the shards of the
layer forms that split experts, a recurrence's width or its heads.
"""
from repro_torch.dist.sharding import (  # noqa: F401
    ACT_RULES_SP, ACT_RULES_TP, BATCH_RULES, PARAM_RULES_FSDP, PARAM_RULES_TP,
    POLICIES, ShardingPolicy, param_shardings, spec_for,
)
from repro_torch.dist.serve import ServeMesh  # noqa: F401
from repro_torch.dist import sharding  # noqa: F401
