"""Peak live KV bytes of the run (``ServeEngine.live_kv_bytes_peak``: the
pool pages in use at their peak), in GiB."""


def read(r):
    return r["live_kv_bytes_peak"] / 2 ** 30
