"""Share of the prompt tokens admitted in the window that the prefix cache
served from shared pages (``ServeStats``), in percent."""


def read(r):
    st = r["window_stats"]
    if not st["prompt_tokens"]:
        return None
    return 100.0 * st["prefix_hit_tokens"] / st["prompt_tokens"]
