"""The paper's contribution, on Hopper: memory-access patterns, the
analytic memory model (Eqs. 1-6), the benchmarking engines and the
per-site advisor."""
from repro_torch.core.memmodel import H100, HopperSpec  # noqa: F401
from repro_torch.core.patterns import (ADVICE, Advice, Knobs,  # noqa: F401
                                       Pattern, SiteReport)
