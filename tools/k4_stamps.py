#!/usr/bin/env python3
"""Where K4's first CUDA body (one block per tile) lost time at 1 MiB
tiles.  Needs one CUDA card; run from the root of a checkout:

    python3 tools/k4_stamps.py

It builds ``tools/k4_stamps.cu`` into ``build/`` and, on a 1 GiB float32
array, prints one JSON object a line:

1. ``time``: best-of-5 CUDA-event times (``core.engines.trial_walls``:
   the L2 flushed and the card spinning before each call) of the first
   body and of the port's K4 (``kernels.ops.stream_copy``) at 1 MiB and
   8 KiB tiles, beside ``Tensor.copy_``.  Two passes, the second in the
   reverse order.
2. ``stamps``: each block's start and end at 1 MiB tiles: the spread of
   block times, the blocks still running as the launch goes on, and the
   mean end on SMs holding 7 and 8 blocks; at 8 KiB tiles the tiles
   finished per tenth of the launch.

The last line is the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ROWS, COLS = 1 << 18, 1024
UNITS = ROWS * COLS // 4          # 16-byte units of the array
TILES = {"1 MiB": 1 << 16, "8 KiB": 1 << 9}     # tile -> its units
PORT_BLOCK_ROWS = {"1 MiB": 256, "8 KiB": 2}


def main():
    import torch
    if not torch.cuda.is_available():
        print("k4_stamps needs a CUDA card", file=sys.stderr)
        return 2
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.core import engines
    from repro_torch.kernels import build, ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib_path = os.path.join(ROOT, "build", "k4_stamps.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                    *build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(ROOT, "tools", "k4_stamps.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.k4_first_body.argtypes = [vp, vp, ll, ll, vp, vp]
    dev = torch.device("cuda")
    x = torch.randn((ROWS, COLS), device=dev)
    out = torch.empty_like(x)

    def first_body(tile_units, stamps=None):
        def f(a):
            err = lib.k4_first_body(
                a.data_ptr(), out.data_ptr(), UNITS // tile_units,
                tile_units, None if stamps is None else stamps.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return f

    def emit(**d):
        print(json.dumps(d), flush=True)

    cases = [("Tensor.copy_", lambda a: out.copy_(a))]
    for tile, units in TILES.items():
        out.zero_()
        first_body(units)(x)
        torch.cuda.synchronize()
        assert torch.equal(out, x)
        cases.append((f"first body, {tile} tiles", first_body(units)))
        br = PORT_BLOCK_ROWS[tile]
        assert torch.equal(ops.stream_copy(x, block_rows=br), x)
        cases.append((f"port's K4, {tile} tiles",
                      lambda a, br=br: ops.stream_copy(a, block_rows=br)))
    for rep, order in enumerate((cases, cases[::-1])):
        for name, fn in order:
            ms = 1e3 * min(engines.trial_walls(fn, x, device=dev, trials=5))
            emit(part="time", case=name, rep=rep, ms=ms)

    for tile, units in TILES.items():
        tiles = UNITS // units
        st = torch.zeros(3 * tiles, dtype=torch.int64, device=dev)
        engines.flush_l2(dev)
        torch.cuda.synchronize()
        first_body(units, st)(x)
        torch.cuda.synchronize()
        s = st.view(tiles, 3).cpu().double()
        t0 = s[:, 0].min()
        start, end, sm = s[:, 0] - t0, s[:, 1] - t0, s[:, 2].long()
        span = float(end.max())
        if tile == "8 KiB":
            hist = torch.histc(end.float(), bins=10, min=0, max=span)
            emit(part="stamps", case=f"first body, {tile} tiles",
                 span_ms=span / 1e6,
                 tiles_finished_per_tenth=[int(v) for v in hist])
            continue
        dur = (end - start) / 1e6
        per_sm = torch.bincount(sm)
        by_load = {}
        for n in sorted(set(per_sm[per_sm > 0].tolist())):
            on = torch.isin(sm, (per_sm == n).nonzero().flatten())
            by_load[n] = dict(sms=int((per_sm == n).sum()),
                              mean_end_ms=float(end[on].mean()) / 1e6)
        running = {f"{f:.2f}": int(((start <= f * span)
                                    & (end > f * span)).sum())
                   for f in (0.5, 0.7, 0.8, 0.9, 0.95)}
        emit(part="stamps", case=f"first body, {tile} tiles",
             span_ms=span / 1e6, last_start_ms=float(start.max()) / 1e6,
             block_ms_min=float(dur.min()), block_ms_median=float(dur.median()),
             block_ms_max=float(dur.max()),
             running_at_fraction_of_span=running, blocks_per_sm=by_load)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
