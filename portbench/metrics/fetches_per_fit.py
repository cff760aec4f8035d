"""Host fetches of the loop's flags per fit in the window, from the fused
loop's own per-fit counts (``loop_stats["fetches"]``)."""


def read(ctx):
    w = ctx["window"]
    return w["fetches"] / w["fits"] if w["fits"] else None
