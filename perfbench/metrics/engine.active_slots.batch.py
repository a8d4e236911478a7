"""Mean slots decoding a tick over the traced slice (``ServeStats``): the
tokens the slice's decode ticks emitted (tokens out less the one each
finished prefill emits) over its decode ticks."""


def read(r):
    st = r["slice"].get("stats")
    if not st or not st["decode_steps"]:
        return None
    return (st["tokens_out"] - st["prefills"]) / st["decode_steps"]
