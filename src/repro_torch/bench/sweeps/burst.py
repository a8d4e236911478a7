"""Paper Fig. 10 + Tables 3/4: burst size effect + buffer cost.

The tile is ``block_rows`` whole rows.  The reference times one XLA copy
for every row (its timing is block-independent); on the card the tile is a
real knob, so each row times K4 at its own tile.  On K4's bulk route
(``kernel_route``) a tile is a run of contiguous TMA bulk requests: the
burst (``kernel_burst_bytes``) is one request, the whole tile up to one
16 KiB ring stage; ``kernel_outstanding`` is the requests in flight per
block (the ring's stages) and ``kernel_smem_bytes`` a block's ring, the
paper's BRAM column.  A tile of whole rows is contiguous, so the rows of
16 KiB tiles and up all run the same launch (16 KiB requests, the same
grid and ring): on the card the sweep compares 8 KiB against 16 KiB
bursts, and the larger rows repeat the 16 KiB one.  The ``smem_bytes`` column is the model's buffer
(burst x outstanding).  At ``fast`` the reference's 1024 x 512; on the
card 2^18 x 1024 float32 (1 GiB).
"""
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.memmodel import smem_ok
from repro_torch.core.patterns import Knobs, Pattern
from repro_torch.kernels import ops
from repro_torch.kernels import stream_copy as _sc


@register("burst", "Fig 10 / Tables 3-4")
def run(ctx: SweepContext) -> None:
    rows, cols = (1024, 512) if ctx.fast else (1 << 18, 1024)
    x = torch.ones((rows, cols), dtype=torch.float32, device=ctx.device)
    nbytes = x.numel() * 4 * 2
    for block_rows in (2, 4, 8, 16, 32, 64, 128):
        # correctness of the blocked walk
        got = ops.stream_copy(x[:256], block_rows=block_rows)
        if not torch.equal(got, x[:256]):
            raise AssertionError(f"stream_copy at block_rows {block_rows} "
                                 f"is not a copy")
        t = ctx.timeit(lambda a, br=block_rows: ops.stream_copy(
            a, block_rows=br), x)
        knobs = Knobs(burst_bytes=block_rows * cols * 4, outstanding=2)
        ctx.emit(f"burst_{block_rows}rows", pattern=Pattern.SEQUENTIAL,
                 knobs=knobs, timing=t, bytes_moved=nbytes,
                 burst_bytes=knobs.burst_bytes,
                 smem_bytes=knobs.smem_bytes(),
                 fits_smem=smem_ok(knobs, ctx.spec),
                 **_sc.kernel_knobs(x, block_rows))
