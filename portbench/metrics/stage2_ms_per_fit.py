"""Device milliseconds per traced fit of stage 2: every pulsar's Grams,
ECORR elimination and reductions, from each member's stage boundary to
the end of the Grams. Read from the program's counter
``fit.device.stage2_ms``, which the fused loop adds up, while a profiler
records, from events captured at the stage boundaries inside its graph.
Nothing to read where the program keeps no such counter."""


def read(ctx):
    from pint_tpu_torch import telemetry

    prof = ctx.get("profile")
    ms = telemetry.counters_snapshot().get("fit.device.stage2_ms")
    if not prof or not prof["fits"] or ms is None:
        return None
    return ms / prof["fits"]
