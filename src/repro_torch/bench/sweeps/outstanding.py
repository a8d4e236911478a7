"""Paper Fig. 5 + Table 5: effect of outstanding transactions.

Requests in flight = independent chains walked at once by K7, one thread
per chain: per-chain latency is constant, so aggregate hops/s scale with
the in-flight count until the memory system saturates.  The model column
gives the knee NO* = ceil(T_l * BW / burst) (Eq. 4); the shared-memory
column is the paper's BRAM-consumption column.  At ``fast`` the
reference's sizes (chains of 2^10, Sattolo); on the card 64 chains of
2^22 entries (64 x 16 MiB, chained ``randperm``), 2^12 hops.
"""
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.memmodel import min_outstanding_for_peak
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops
from repro_torch.kernels import pointer_chase as _pc

DEPTHS = (1, 2, 4, 8, 16, 32, 64)


@register("outstanding", "Fig 5 / Table 5")
def run(ctx: SweepContext) -> None:
    n = 1 << (10 if ctx.fast else 22)
    steps = 1 << (9 if ctx.fast else 12)
    base = None
    burst = 64 * 1024
    no_star = min_outstanding_for_peak(burst, ctx.spec)
    chains = [_pc.chain(n, seed=i, device=ctx.device) for i in
              range(max(DEPTHS))]
    tables = torch.stack([c[0] for c in chains])
    builder = chains[0][1]
    del chains
    for no in DEPTHS:
        t = ctx.timeit(lambda tb: ops.pointer_chase(tb, steps=steps),
                       tables[:no])
        hops_s = no * steps / t.best_s
        base = base or hops_s
        knobs = Knobs(burst_bytes=burst, outstanding=no)
        ctx.emit(f"outstanding_{no}", pattern=Pattern.SEQUENTIAL, knobs=knobs,
                 timing=t, bytes_moved=no * steps * 4,
                 hops_per_s=f"{hops_s:.2e}",
                 speedup_vs_1=f"{hops_s/base:.2f}",
                 smem_bytes=knobs.smem_bytes(),
                 no_star_64kb=no_star,
                 no_star_1mb=min_outstanding_for_peak(1 << 20, ctx.spec),
                 chain=builder, ns_per_hop=f"{t.best_s/steps*1e9:.1f}")
