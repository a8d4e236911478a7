"""The whole model step's share of the card's bf16 peak over the profiled
slice: the operations the slice's tokens needed (decode ticks at each
slot's context, prefill chunks at their offsets; :mod:`perfbench.flops`)
over the slice's seconds times 989 TFLOP/s, in percent."""

from perfbench import flops
from perfbench.peaks import H100


def read(r):
    s = r["slice"]
    if not s.get("n_device_ops"):
        return None
    dims = r["dims"]
    work = sum(flops.decode_tick_flops(dims, c) for c in s["ticks"])
    work += sum(flops.prefill_chunk_flops(dims, o, n) for o, n in s["chunks"])
    return 100.0 * work / (s["window_s"] * H100["bf16_flops"])
