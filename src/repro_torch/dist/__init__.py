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
gradients optional), one process driving every shard.  Sharded FSDP x TP
training, the elastic restore onto another mesh and the prefill/decode
step builders wait for ROADMAP A10b.
"""
from repro_torch.dist.sharding import (  # noqa: F401
    ACT_RULES_SP, ACT_RULES_TP, BATCH_RULES, PARAM_RULES_FSDP, PARAM_RULES_TP,
    POLICIES, ShardingPolicy, param_shardings, spec_for,
)
from repro_torch.dist.serve import ServeMesh  # noqa: F401
from repro_torch.dist import sharding  # noqa: F401
