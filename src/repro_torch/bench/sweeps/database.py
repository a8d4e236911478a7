"""Paper Table 9: database access patterns (rs_tra / rr_tra / r_acc / nest).

Framework-level instantiations, as in the reference:
  rs_tra — repeated sequential weight streaming (epoch re-reads)
  rr_tra — repeated random traversal (shuffled epochs over the same table)
  r_acc  — embedding-row gather
  nest   — interleaved multi-cursor sequential = chunked attention

The reference computes every row with plain XLA ops, no Pallas kernel, so
the port computes them with plain PyTorch ops: the rows measure what the
framework's own operators do with each pattern.  ``r_acc`` draws its rows
with the paper's LFSR (the reference's indices, bit for bit) and gathers
them by indexing.  ``rr_tra``'s permutation only orders the traversal, so
a seeded ``torch.randperm`` stands in for the reference's
``jax.random.permutation``: the numbers differ, every row is read once all
the same.  ``rs_tra`` keeps the reference's expression,
``sum(t * (i+1))`` over 3 epochs: eager PyTorch writes and re-reads each
product, so the row reads well under the card's rate against the bytes it
declares (3 reads of the table).

At ``fast`` the reference's sizes.  On the card a 1 GiB table (2^19 x 512
float32; the reference's full 2^14 x 512 is 32 MiB and would sit in the
50 MiB L2) and, for ``nest``, B 8, S 16384, 8 heads, D 64 in float32: q, K
and V of 256 MiB each.  Each row names its ``working_set_bytes``: the
table, or q, K, V and the output.
"""
import torch

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.patterns import ADVICE, Knobs, Pattern
from repro_torch.kernels.random_gather import lfsr_indices
from repro_torch.models.attention import AttnParams, chunked_attention


@register("database", "Table 9")
def run(ctx: SweepContext) -> None:
    dev = ctx.device
    n, d = (1 << 12, 256) if ctx.fast else (1 << 19, 512)
    table = torch.ones((n, d), dtype=torch.float32, device=dev)
    nbytes = table.numel() * 4

    # rs_tra: stream the table repeatedly (3 epochs)
    t = ctx.timeit(lambda a: sum(torch.sum(a * (i + 1)) for i in range(3)),
                   table)
    ctx.emit("rs_tra", pattern=Pattern.RS_TRA, knobs=Knobs(),
             timing=t, bytes_moved=3 * nbytes,
             paper_u280_gbps=13.26,
             advice=ADVICE[Pattern.RS_TRA].knob_moves[0],
             working_set_bytes=nbytes)

    # rr_tra: shuffled traversal each epoch
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(n, generator=gen, device=dev)
    t = ctx.timeit(lambda a, p: torch.sum(a[p]), table, perm)
    ctx.emit("rr_tra", pattern=Pattern.RR_TRA, knobs=Knobs(unit_bytes=d * 4),
             timing=t, bytes_moved=nbytes,
             paper_u280_gbps=3.51,
             advice=ADVICE[Pattern.RR_TRA].knob_moves[0],
             working_set_bytes=nbytes)

    # r_acc: sparse random row access (small working fraction)
    idx = lfsr_indices(n // 8, bits=24, device=dev) % n
    t = ctx.timeit(lambda a, i: a[i], table, idx)
    ctx.emit("r_acc", pattern=Pattern.R_ACC, knobs=Knobs(unit_bytes=d * 4),
             timing=t, bytes_moved=idx.shape[0] * d * 4 * 2,
             paper_u280_gbps=0.68,
             advice=ADVICE[Pattern.R_ACC].knob_moves[0],
             working_set_bytes=nbytes)
    del table, perm, idx

    # nest: blocked multi-cursor (chunked attention)
    b, s, h, hd = (1, 512, 4, 64) if ctx.fast else (8, 16384, 8, 64)
    q, k, v = (torch.ones((b, s, h, hd), dtype=torch.float32, device=dev)
               for _ in range(3))
    p = AttnParams(bq=256, bkv=256)
    t = ctx.timeit(lambda *a: chunked_attention(*a, p), q, k, v)
    moved = (q.numel() + 2 * (s // 256) * k.numel() + q.numel()) * 4
    ctx.emit("nest", pattern=Pattern.NEST, knobs=Knobs(),
             timing=t, bytes_moved=moved,
             paper_u280_gbps=421.89,
             advice=ADVICE[Pattern.NEST].knob_moves[0],
             working_set_bytes=4 * q.numel() * 4)
