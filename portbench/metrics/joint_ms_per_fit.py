"""Device milliseconds per traced fit of the joint solve: the arrow
elimination, the GW core, the step and the uncertainties, from the end
of the Grams to the end of each joint evaluation. Read from the
program's counter ``fit.device.joint_ms``, which the fused loop adds up,
while a profiler records, from events captured at the stage boundaries
inside its graph. Nothing to read where the program keeps no such
counter."""


def read(ctx):
    from pint_tpu_torch import telemetry

    prof = ctx.get("profile")
    ms = telemetry.counters_snapshot().get("fit.device.joint_ms")
    if not prof or not prof["fits"] or ms is None:
        return None
    return ms / prof["fits"]
