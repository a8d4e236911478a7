"""repro_torch.tune — the closed tune -> plan -> execute loop (paper §5
applied to the code), the port of ``repro.tune``.

``core.autotune`` picks knobs from the analytic or calibrated memory model
(:mod:`repro_torch.core.memmodel`); this package turns them into persisted
:class:`KernelPlan`s that the kernels (:mod:`repro_torch.kernels.ops`) and
the model's attention (:mod:`repro_torch.models.attention`) take as their
defaults.

Quick use::

    from repro_torch.tune import plan_for
    plan = plan_for("decode_attention", shape_sig=(1024, 128))
    plan.bkv, plan.pipeline_depth, plan.predicted_gbps
"""
from repro_torch.tune.cache import (DEFAULT_PATH, PlanCache,  # noqa: F401
                                    default_cache, plan_for,
                                    set_default_cache)
from repro_torch.tune.plan import (KERNELS, KernelPlan,  # noqa: F401
                                   derive_attention_plan, derive_decode_plan,
                                   derive_matmul_plan, derive_paged_plan,
                                   derive_plan, next_pow2, plan_key,
                                   spec_fingerprint)

__all__ = [
    "KernelPlan", "KERNELS", "plan_key", "spec_fingerprint",
    "derive_plan", "derive_attention_plan", "derive_decode_plan",
    "derive_matmul_plan", "derive_paged_plan",
    "PlanCache", "DEFAULT_PATH", "default_cache", "set_default_cache",
    "plan_for",
]
