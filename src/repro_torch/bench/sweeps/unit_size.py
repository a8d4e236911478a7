"""Paper Fig. 7: throughput vs unit size (transaction width).

Random row gather (K6) with growing row bytes, plus the dtype variant of
unit size through K4.  At ``fast`` the reference's sizes; on the card
min(2^24, 1 GiB / unit) rows and 2^20 indices.  Units under 64 B reach
only 2^24 rows (64 and 256 MiB): the 24-bit LFSR addresses no more.  The
card moves 32-byte sectors, so a 4-byte unit costs 8 times its useful
bytes; the measured column stays useful bytes, as in the reference.  The
dtype rows copy 1 GiB of each dtype.
"""
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core import engines
from repro_torch.core.patterns import Knobs, Pattern


@register("unit_size", "Fig 7")
def run(ctx: SweepContext) -> None:
    units = (4, 16, 64, 256, 1024) if ctx.fast else \
        (4, 16, 64, 256, 1024, 4096)
    for u in units:
        r = engines.bw_random(
            n_rows=1 << 12 if ctx.fast else min(1 << 24, (1 << 30) // u),
            cols=max(1, u // 4), n_idx=1 << (12 if ctx.fast else 20),
            spec=ctx.spec, device=ctx.device)
        ctx.emit(f"unit_{u}B", pattern=Pattern.RANDOM,
                 knobs=Knobs(unit_bytes=u, outstanding=8),
                 us=r.wall_s * 1e6, bytes_moved=r.bytes_moved,
                 gbps_measured=r.gbps_measured,
                 gbps_predicted=r.gbps_model, **r.extras)
    # dtype variant of unit size (int8 vs bf16 vs f32 rows)
    for dt, tag in ((torch.int8, "s8"), (torch.bfloat16, "bf16"),
                    (torch.float32, "f32")):
        size = dt.itemsize
        r = engines.bw_sequential(
            rows=2048 if ctx.fast else (1 << 30) // (1024 * size), cols=1024,
            dtype=dt, spec=ctx.spec, device=ctx.device)
        ctx.emit(f"unit_dtype_{tag}", pattern=Pattern.SEQUENTIAL,
                 knobs=Knobs(unit_bytes=128 * size),
                 us=r.wall_s * 1e6, bytes_moved=r.bytes_moved,
                 gbps_measured=r.gbps_measured,
                 gbps_predicted=r.gbps_model, **r.extras)
