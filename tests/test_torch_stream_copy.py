"""K4's launch configuration (``stream_copy.kernel_config`` and
``kernel_knobs``) on the CPU: the route each shape takes, the bulk route's
requests, ring and grid, and that the requests of every tile cover its
bytes exactly once, at the memory phase's card-scale shapes (the burst
sweep's tiles, the timed shapes, the ``num_kernels`` parts and the dtype
rows) and at the card tests' shapes.  The kernel itself is held against
its plain version on the card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import stream_copy as sc

SMEM_PER_BLOCK = 227 * 1024      # H100: shared memory one block can use
SMEM_PER_SM = 228 * 1024         # H100: shared memory of one SM
GIB_ROWS = 1 << 18               # 2^18 x 1024 float32 = 1 GiB

# (rows, cols, itemsize, block_rows, block_cols)
BURST = [(GIB_ROWS, 1024, 4, br, 0) for br in (2, 4, 8, 16, 32, 64, 128)]
TIMED = [(GIB_ROWS, 1024, 4, 256, 0)]
NUM_KERNELS = [(GIB_ROWS // k, 1024, 4, 256, 0) for k in (1, 2, 4, 8, 16, 32)]
DTYPE_ROWS = [((1 << 30) // (1024 * e), 1024, e, 256, 0) for e in (1, 2, 4)]
CARD = [(rows, cols, e, br, bc)
        for rows, cols, br, bc in ((128, 128, 8, 0), (256, 512, 64, 0),
                                   (64, 384, 8, 128), (4096, 1024, 256, 0),
                                   (600, 1040, 300, 0), (32, 12288, 4, 6144),
                                   (128, 1024, 256, 0))
        for e in (1, 2, 4)]
MEMORY_PHASE = BURST + TIMED + NUM_KERNELS + DTYPE_ROWS


def _id(shape):
    return "x".join(str(v) for v in shape)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("cols,block_cols", [
    (7, 0), (8, 0), (16, 0), (1040, 0), (1024, 512), (1024, 4), (96, 12),
    (12288, 6144), (6, 3)])
@pytest.mark.parametrize("aligned", [True, False])
def test_route_is_element_exactly_when_alignment_fails(itemsize, cols,
                                                       block_cols, aligned):
    cfg = sc.kernel_config(64, cols, itemsize, 8, block_cols, aligned)
    row_bytes = (block_cols or cols) * itemsize
    fails = not aligned or row_bytes % 16 != 0
    assert cfg.route == ("element" if fails else "bulk")
    if fails:
        assert cfg.grid == (64 // 8) * (cols // (block_cols or cols))
        assert cfg.ring_bytes == 0


@pytest.mark.parametrize("sm_count", [132, 114, 1])
@pytest.mark.parametrize("shape", MEMORY_PHASE + CARD,
                         ids=_id)
def test_bulk_requests_ring_and_grid(shape, sm_count):
    cfg = sc.kernel_config(*shape, True, sm_count)
    assert cfg.route == "bulk"
    assert cfg.chunk_bytes % 16 == 0 and cfg.chunk_bytes > 0
    assert cfg.segment_bytes % 16 == 0
    assert sc.MIN_STAGES <= cfg.stages <= sc.MAX_STAGES
    # the ring, its barriers and the published request ids fit a block,
    # and blocks_per_sm of them fit one SM
    block_smem = cfg.ring_bytes + 16 * cfg.stages + 8 * sc.MAX_STAGES
    assert block_smem <= SMEM_PER_BLOCK
    assert cfg.blocks_per_sm * (block_smem + 1024) <= SMEM_PER_SM
    assert cfg.ring_bytes <= sc.RING_PER_SM
    assert 1 <= cfg.grid <= min(cfg.requests, sm_count * cfg.blocks_per_sm)
    assert cfg.requests + cfg.grid < 2**31


@pytest.mark.parametrize("shape", MEMORY_PHASE + CARD, ids=_id)
def test_requests_cover_each_tile_exactly_once(shape):
    rows, cols, itemsize, block_rows, block_cols = shape
    cfg = sc.kernel_config(*shape, True)
    assert cfg.route == "bulk"
    br, bc = cfg.block_rows, cfg.block_cols
    q = np.arange(cfg.requests)
    off, length = (np.array(v, dtype=np.int64) for v in
                   zip(*(cfg.request(int(i)) for i in q)))
    assert (length > 0).all() and (length <= cfg.chunk_bytes).all()
    assert (off % 16 == 0).all() and (length % 16 == 0).all()
    # requests are numbered tile by tile; each lies inside its tile's rows
    per_tile = cfg.segments * cfg.pieces
    tile = q // per_tile
    tiles_per_row = cols // bc
    base = ((tile // tiles_per_row) * br * cfg.row_bytes
            + (tile % tiles_per_row) * bc * itemsize)
    rel = off - base
    row, col = rel // cfg.row_bytes, rel % cfg.row_bytes
    if bc == cols:        # a tile of whole rows is one contiguous range
        assert (rel >= 0).all() and (rel + length <= br * cfg.row_bytes).all()
    else:                 # else one range per tile row
        assert (row >= 0).all() and (row < br).all()
        assert (col + length <= bc * itemsize).all()
    # within a tile no two requests overlap, and together they hold the
    # tile's bytes
    order = np.lexsort((rel, tile))
    t_s, r_s, l_s = tile[order], rel[order], length[order]
    same = t_s[1:] == t_s[:-1]
    assert (r_s[:-1][same] + l_s[:-1][same] <= r_s[1:][same]).all()
    tiles = (rows // br) * tiles_per_row
    held = np.bincount(tile, weights=length, minlength=tiles)
    assert (held == br * bc * itemsize).all()
    # and in address order when a tile holds whole rows
    if bc == cols:
        assert (np.diff(off) == length[:-1]).all()


def test_large_tiles_cut_at_a_ring_stage_small_ones_deepen_the_ring():
    big = sc.kernel_config(GIB_ROWS, 1024, 4, 256, 0, True)
    assert (big.chunk_bytes, big.pieces, big.stages, big.blocks_per_sm) == \
        (sc.CHUNK_BYTES, 64, 3, 2)
    small = sc.kernel_config(GIB_ROWS, 1024, 4, 2, 0, True)
    assert (small.chunk_bytes, small.pieces, small.stages,
            small.blocks_per_sm) == (8192, 1, 4, 3)
    tiny = sc.kernel_config(64, 384, 4, 8, 4, True)
    assert tiny.chunk_bytes == 16 and tiny.stages == sc.MAX_STAGES
    assert tiny.blocks_per_sm == sc.MAX_BLOCKS_PER_SM


@pytest.mark.parametrize("block_rows", [8, 16, 32, 64, 128])
def test_burst_rows_of_16_kib_and_up_run_one_launch(block_rows):
    """A tile of whole rows is contiguous, so from one 16 KiB stage up the
    burst sweep's rows are the same run of requests on the same grid as
    its 16 KiB row: on the card the knob reaches the kernel only below
    one stage."""
    at_16k = sc.kernel_config(GIB_ROWS, 1024, 4, 4, 0, True)
    cfg = sc.kernel_config(GIB_ROWS, 1024, 4, block_rows, 0, True)
    assert (cfg.grid, cfg.chunk_bytes, cfg.stages, cfg.requests) == (
        at_16k.grid, at_16k.chunk_bytes, at_16k.stages, at_16k.requests)
    for q in np.linspace(0, cfg.requests - 1, 257).astype(int):
        assert cfg.request(int(q)) == at_16k.request(int(q))
    below = sc.kernel_config(GIB_ROWS, 1024, 4, 2, 0, True)
    assert below.chunk_bytes == 8192 < cfg.chunk_bytes


@pytest.mark.parametrize("shape", [
    (49152 // 32, 1024, 4, 256, 0),          # a part of the split-32 case
    (4096, 1024, 4, 4, 0), (8192, 1024, 4, 4, 0), (2048, 1024, 4, 4, 0)],
    ids=_id)
def test_card_counter_cases_take_tickets(shape):
    """The card cases that hold the counter's reset exact (the float32
    32-way split and the back-to-back launches) have more requests than
    their grid on an H100, so every launch hands out requests from the
    counter."""
    cfg = sc.kernel_config(*shape, True, sc.H100_SMS)
    assert cfg.route == "bulk" and cfg.requests > cfg.grid


def test_kernel_config_refuses_tiles_that_do_not_divide():
    with pytest.raises(ValueError, match="divide"):
        sc.kernel_config(64, 32, 4, 24, 0, True)
    with pytest.raises(ValueError, match="divide"):
        sc.kernel_config(64, 32, 4, 8, 12, True)


@pytest.mark.parametrize("block_rows", [2, 4, 8, 16, 32, 64, 128])
def test_kernel_knobs_report_the_bulk_configuration(block_rows):
    """The burst sweep's rows at ``--fast`` (1024 x 512 float32 on the
    CPU): the knobs are the configuration the card would run."""
    x = torch.ones((1024, 512))
    assert x.data_ptr() % 16 == 0
    cfg = sc.kernel_config(1024, 512, 4, block_rows, 0, True, sc.H100_SMS)
    assert sc.kernel_knobs(x, block_rows) == dict(
        kernel_route="bulk", kernel_unit_bytes=16,
        kernel_burst_bytes=cfg.chunk_bytes,
        kernel_outstanding=cfg.stages, kernel_smem_bytes=cfg.ring_bytes)
    assert cfg.chunk_bytes == min(block_rows * 512 * 4, sc.CHUNK_BYTES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_kernel_knobs_of_the_element_route(dtype):
    """A base one element into a buffer, and rows of 7 elements."""
    buf = torch.zeros(64 * 256 + 1, dtype=dtype)
    offset = buf[1:].view(64, 256)
    knobs = sc.kernel_knobs(offset, 16)
    assert knobs == dict(kernel_route="element",
                         kernel_unit_bytes=offset.element_size(),
                         kernel_burst_bytes=16 * 256 * offset.element_size(),
                         kernel_outstanding=sc.UNROLL, kernel_smem_bytes=0)
    assert sc.kernel_knobs(torch.zeros((96, 7), dtype=dtype),
                           32)["kernel_route"] == "element"
