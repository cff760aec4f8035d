"""The Gram's share of its roofline in the traced fits: its least time
from its shapes alone (``roofline.gram_least_s`` of each launch's n x q
block: per full evaluation one Gram of every TOA row and one of every
ECORR epoch row, per pulsar), over the device time of the kernels that
``layers/gram.json`` names. Nothing to read where no Gram ran."""

from portbench import roofline
from portbench.trace import layer_kernels, matching


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof.get("gram_pairs"):
        return None
    sec, count = matching(prof["kernels"], layer_kernels("gram"))
    if not count or not sec:
        return None
    least = prof["gram_pairs"] * sum(roofline.gram_least_s(n, q)
                                     for n, q in ctx["gram_shapes"])
    return 100.0 * least / sec
