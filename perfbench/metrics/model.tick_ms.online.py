"""Milliseconds a decode tick over the window of the traced run, outside
the profiled slice (whose host-side recording slows the host): each
decode window's span, synchronised on both sides, over its ticks."""


def read(r):
    w = r["decode_windows"]
    ticks = sum(t for _, t in w)
    return 1e3 * sum(s for s, _ in w) / ticks if ticks else None
