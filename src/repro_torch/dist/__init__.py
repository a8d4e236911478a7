"""Distribution layer: sharding policies and the serving mesh.

A :class:`~repro_torch.dist.sharding.ShardingPolicy` maps the models'
*logical* axis names onto mesh axes (with a divisibility fallback), and
:class:`~repro_torch.dist.serve.ServeMesh` spreads one serving engine
over a tensor-parallel device group, driven from one process with the
collectives written out as device-to-device copies.  The reference's
pjit step builders (``dist.steps``) and explicit-collective data
parallelism (``dist.dp_shardmap``) wait for the port of training
(ROADMAP A10).
"""
from repro_torch.dist.sharding import (  # noqa: F401
    ACT_RULES_SP, ACT_RULES_TP, BATCH_RULES, PARAM_RULES_FSDP, PARAM_RULES_TP,
    POLICIES, ShardingPolicy, param_shardings, spec_for,
)
from repro_torch.dist.serve import ServeMesh  # noqa: F401
from repro_torch.dist import sharding  # noqa: F401
