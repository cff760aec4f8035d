"""Full evaluations plus probes per fit in the window, from the fused
loop's own per-fit counts (``loop_stats["full"] + loop_stats["probe"]``)."""


def read(ctx):
    w = ctx["window"]
    return w["evals"] / w["fits"] if w["fits"] else None
