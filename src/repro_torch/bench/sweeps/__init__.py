"""The ported sweeps — one module per paper table/figure (the seven memory
sweeps, Table 9's ``database``, Table 10's ``conv``, the analytic
``roofline``), then the serving sweeps (``serve`` and ``kernel_plan``,
``paged_serve``, ``spec_serve``, ``preempt_serve``, ``cluster_serve``,
``dist_serve``, ``disagg_serve``): 17 modules, 18 sweeps, registered in
the reference's order (``repro.bench.sweeps``).
Importing this package populates
:data:`repro_torch.bench.registry.REGISTRY`.

Every sweep keeps the reference's rows at ``fast`` (names, patterns, knobs
and bytes moved; the CPU tests compare them) and runs at the card's own
sizes otherwise: every working set that should live in HBM is at least 20
times the card's 50 MiB L2, or the card would measure its cache.
"""
from repro_torch.bench.sweeps import (  # noqa: F401  (import order == run order)
    latency, outstanding, unit_size, stride, burst, num_kernels,
    random_access, database, conv, roofline, serve, paged_serve, spec_serve,
    dist_serve, preempt_serve, cluster_serve, disagg_serve,
)

__all__ = [
    "latency", "outstanding", "unit_size", "stride", "burst", "num_kernels",
    "random_access", "database", "conv", "roofline", "serve", "paged_serve",
    "spec_serve", "dist_serve", "preempt_serve", "cluster_serve",
    "disagg_serve",
]
