"""The device's idle share of a fit: 1 - (device busy time of the traced
fits) / (the same fits' wall time, run unprofiled just before), as a
percentage. The profiler stretches the host's time, so the traced fits'
own wall is not the divisor; the same starts on both sides do the same
work."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof["busy_s"] or not prof.get("plain_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["plain_s"])
