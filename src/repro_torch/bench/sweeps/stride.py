"""Paper Figs. 8/9: throughput vs stride (Loop + Dataflow engines).

Loop = K5, the strided block walk; Dataflow = an explicit index vector
into K6 over the block view (address generation decoupled from access,
like the paper's FIFO-linked dataflow kernel).  At ``fast`` the
reference's 2048 x 256; on the card 8 * (2^15 + 1) rows of 1024 float32
(1 GiB): an odd block count makes every stride of the sweep coprime with
it, so each block is read exactly once and the rows count the bytes the
card moves (with 2^15 blocks, stride 32 would read 1/32 of them, 32 MiB,
out of the L2).  Each row names the kernel's geometry
(``kernel_*``: K5's block-row, or K6's lanes and units in flight, and for
both ``kernel_stride`` 1 while every block-row is read once, whole), which
the calibration reads on the card.
"""
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops
from repro_torch.kernels import random_gather as _rg
from repro_torch.kernels import strided_copy as _st


@register("stride", "Figs 8-9")
def run(ctx: SweepContext) -> None:
    rows, cols = (2048, 256) if ctx.fast else (8 * ((1 << 15) + 1), 1024)
    x = torch.ones((rows, cols), dtype=torch.float32, device=ctx.device)
    nbytes = x.numel() * 4 * 2
    nblocks = rows // 8
    xf = x.reshape(nblocks, 8 * cols)
    for stride in (1, 2, 4, 8, 16, 32):
        knobs = Knobs(unit_bytes=8 * cols * 4, stride=stride)
        # Loop engine (strided block walk)
        t = ctx.timeit(lambda a, s=stride: ops.strided_copy(
            a, block_rows=8, stride=s), x)
        # Dataflow engine (explicit address vector -> gather)
        idx = ((torch.arange(nblocks, device=ctx.device) * stride)
               % nblocks).to(torch.int32)
        t2 = ctx.timeit(lambda a, i: ops.random_gather(a, i), xf, idx)
        loop = _st.kernel_knobs(x, block_rows=8, stride=stride)
        ctx.emit(f"stride_{stride}_loop", pattern=Pattern.STRIDED,
                 knobs=knobs, timing=t, bytes_moved=nbytes, **loop)
        # the gather reads each indexed block-row whole, like the loop
        ctx.emit(f"stride_{stride}_dataflow", pattern=Pattern.STRIDED,
                 knobs=knobs, timing=t2, bytes_moved=nbytes,
                 **_rg.kernel_knobs(xf, n_idx=nblocks),
                 kernel_stride=loop["kernel_stride"])
