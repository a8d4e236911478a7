"""Kernel plans: the page-size rule of the paged KV pool."""
from repro_torch.tune.plan import KernelPlan, derive_paged_plan, next_pow2  # noqa: F401
