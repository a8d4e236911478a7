"""Mean milliseconds of one prefill chunk over the window of the traced
run, outside the profiled slice (whose host-side recording slows the
host): each chunk's span, synchronised on both sides."""


def read(r):
    c = r["prefill_chunks"]
    return 1e3 * sum(c) / len(c) if c else None
