"""The paged-attention kernel's (K1's) share of its roofline over the
profiled slice: the least time its launches could take (the larger of the
bytes they need over 3.35 TB/s and their operations over the bf16 peak;
:func:`perfbench.flops.k1_ticks`: each active slot's K and V rows, its
query and output, once a launch) over the device time of the kernels
named ``paged_attention`` in the trace, in percent."""

from perfbench import flops
from perfbench.peaks import H100


def read(r):
    s = r["slice"]
    k1_s = s.get("matched_s", {}).get("paged_attention", 0.0)
    if not k1_s:
        return None
    nbytes, nflops = flops.k1_ticks(r["dims"], s["ticks"], r["kv_itemsize"])
    least = max(nbytes / H100["hbm_bytes_per_s"], nflops / H100["bf16_flops"])
    return 100.0 * least / k1_s
