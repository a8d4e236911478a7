"""Paper Table 2 (latency per channel) + Fig. 6 (latency vs stride).

Pointer-chase ns/hop per chain (the reference's channel analogue: one
chain per seed) and vs chain stride, through K7.  Model = T_l (memmodel).
At ``fast`` the reference's sizes (2^12 entries, its Sattolo chains); on
the card 2^26 entries (256 MiB, chained ``randperm``), so a random chain's
hops go to HBM, 2^13 hops each.
"""
import math

import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops
from repro_torch.kernels import pointer_chase as _pc


def _strided_chain(n, stride, device):
    """next = (cur + stride) mod n; full cycle when gcd(stride, n) == 1."""
    idx = (torch.arange(n, device=device) + stride) % n
    return idx.to(torch.int32)[:, None]


@register("latency", "Table 2 / Fig 6")
def run(ctx: SweepContext) -> None:
    steps = 1 << (10 if ctx.fast else 13)
    n = 1 << (12 if ctx.fast else 26)
    knobs = Knobs(unit_bytes=4, outstanding=1)

    def chase(t):
        return ops.pointer_chase(t, steps=steps)

    for region in range(4 if ctx.fast else 8):
        table, builder = _pc.chain(n, region, ctx.device)
        t = ctx.timeit(chase, table)
        ctx.emit(f"latency_region_{region}", pattern=Pattern.CHASE,
                 knobs=knobs, timing=t, bytes_moved=steps * 4,
                 ns_per_hop=f"{t.best_s/steps*1e9:.1f}",
                 t_l_model_ns=f"{ctx.spec.latency_s*1e9:.0f}",
                 chain=builder, table_bytes=n * 4)
        del table

    for stride in (1, 2, 3, 4, 8, 9, 10, 18):
        m = n if math.gcd(stride, n) == 1 else n + 1
        t = ctx.timeit(chase, _strided_chain(m, stride, ctx.device))
        ctx.emit(f"latency_stride_{stride}", pattern=Pattern.CHASE,
                 knobs=Knobs(unit_bytes=4, stride=stride, outstanding=1),
                 timing=t, bytes_moved=steps * 4,
                 ns_per_hop=f"{t.best_s/steps*1e9:.1f}")
