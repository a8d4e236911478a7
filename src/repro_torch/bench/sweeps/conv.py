"""Paper Table 10 + §6.1: 11x11 convolution over a 1920x1080 matrix.

Rows mirror the paper's three implementations, as in the reference:
  cpu       — naive numpy sliding-window on the host (the paper's CPU row;
              it runs on the host by definition, whatever the device)
  fused     — one library convolution (the reference's XLA conv, which
              runs outside any Pallas kernel; here ``F.conv2d``, a
              cross-correlation with no padding, like XLA's "VALID", in
              float32 without TF32)
  split     — row-partitioned conv: 8 row shards, each zero-padded by
              K - 1 rows at the bottom, one call each (the paper's
              32-channel row; per-shard dispatch overhead vs parallelism;
              the reference's row name)

Bandwidth columns count input read + output write once per pass — an
*effective* streaming bandwidth, so the conv rows calibrate against the
sequential model like every other sweep.  The paper's 1920x1080 image is
the Table 10 workload at every scale but ``fast``: 7.9 MiB in and out, it
fits the card's L2.
"""
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bench.registry import SweepContext, register
from repro_torch.bench.schema import Timing
from repro_torch.core.patterns import Knobs, Pattern


def conv_valid(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (N, 1, H, W), k (1, 1, K, K) -> (N, 1, H-K+1, W-K+1): the fused
    row's cross-correlation, in float32 (TF32 off for this call)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(x, k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def split_shards(image: torch.Tensor, K: int, n: int = 8):
    """The split row's inputs: ``n`` row shards of an (H, W) image, each
    zero-padded by K - 1 rows at the bottom, as (1, 1, rows, W)."""
    return [F.pad(s, (0, 0, 0, K - 1))[None, None]
            for s in torch.split(image, image.shape[0] // n, dim=0)]


def naive_conv(tile: np.ndarray, ker: np.ndarray) -> np.ndarray:
    """The CPU row's sliding window over a (th + K - 1, tw + K - 1) tile."""
    K = ker.shape[0]
    th, tw = tile.shape[0] - K + 1, tile.shape[1] - K + 1
    out = np.zeros((th, tw), np.float32)
    for i in range(K):
        for j in range(K):
            out += tile[i:i + th, j:j + tw] * ker[i, j]
    return out


@register("conv", "Table 10")
def run(ctx: SweepContext) -> None:
    H, W = (480, 270) if ctx.fast else (1080, 1920)
    K = 11
    img = np.random.default_rng(0).standard_normal((H, W)).astype(np.float32)
    ker = np.ones((K, K), np.float32) / (K * K)
    out_hw = (H - K + 1) * (W - K + 1)
    nbytes = (H * W + out_hw) * 4  # read image once + write result once
    flops = 2 * H * W * K * K

    # cpu: naive strided windows (small tile to keep runtime sane)
    th, tw = (64, 64)
    tile = img[:th + K - 1, :tw + K - 1]
    t0 = time.perf_counter()
    naive_conv(tile, ker)
    cpu_wall = (time.perf_counter() - t0) * (H * W) / (th * tw)
    ctx.emit("conv_cpu_naive", pattern=Pattern.STRIDED,
             knobs=Knobs(unit_bytes=tw * 4, stride=K),
             timing=Timing(best_s=cpu_wall, mean_s=cpu_wall, trials=1),
             bytes_moved=nbytes,
             gflops=f"{flops/cpu_wall/1e9:.2f}", paper_cpu_s=0.06,
             working_set_bytes=nbytes)

    image = torch.from_numpy(img).to(ctx.device)
    x = image[None, None]
    kk = torch.from_numpy(ker).to(ctx.device)[None, None]
    t = ctx.timeit(conv_valid, x, kk)
    ctx.emit("conv_xla_fused", pattern=Pattern.SEQUENTIAL,
             knobs=Knobs(burst_bytes=W * 4 * 8), timing=t, bytes_moved=nbytes,
             gflops=f"{flops/t.best_s/1e9:.2f}", paper_fpga2ch_s=2.04,
             speedup_vs_cpu=f"{cpu_wall/t.best_s:.1f}",
             working_set_bytes=nbytes)

    # split: row-shards, separate dispatches (multi-kernel analogue)
    pads = split_shards(image, K)

    def run_split():
        outs = [conv_valid(p, kk) for p in pads]
        return outs[-1]

    run_split()
    t = ctx.timeit(run_split)
    ctx.emit("conv_split_16", pattern=Pattern.SEQUENTIAL,
             knobs=Knobs(burst_bytes=W * 4 * 8, engines=8), timing=t,
             bytes_moved=nbytes,
             gflops=f"{flops/t.best_s/1e9:.2f}", paper_fpga32ch_s=21.0,
             note="per_shard_dispatch_overhead", working_set_bytes=nbytes)
