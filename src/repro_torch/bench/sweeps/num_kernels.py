"""Paper Table 6: number of kernels vs throughput.

One stream split over k launches of K4, one after another on the current
stream, each over its own rows.  The model column is the idealized linear
multi-engine aggregate (``aggregate_bw``); measured falling below it at
high k is the paper's dispatch-overhead finding.  At ``fast`` the
reference's 2048 x 512; on the card 2^18 x 1024 float32 (1 GiB).
"""
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.memmodel import aggregate_bw
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops


@register("num_kernels", "Table 6")
def run(ctx: SweepContext) -> None:
    rows, cols = (2048, 512) if ctx.fast else (1 << 18, 1024)
    x = torch.ones((rows, cols), dtype=torch.float32, device=ctx.device)
    nbytes = x.numel() * 4 * 2
    for k in (1, 2, 4, 8, 16, 32):
        parts = x.split(rows // k)

        def run_all(parts=parts):
            return [ops.stream_copy(p) for p in parts][-1]

        t = ctx.timeit(run_all)
        knobs = Knobs(burst_bytes=(rows // k) * cols * 4, engines=k)
        ctx.emit(f"kernels_{k}", pattern=Pattern.SEQUENTIAL, knobs=knobs,
                 timing=t, bytes_moved=nbytes,
                 gbps_predicted=aggregate_bw(Pattern.SEQUENTIAL, knobs,
                                             ctx.spec) / 1e9,
                 note="fewer_wider_engines_win")
