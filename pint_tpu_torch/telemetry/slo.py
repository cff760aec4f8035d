"""SLO ledger: per-class latency objectives and burn counters.

Counterpart of ``pint_tpu.telemetry.slo``. Each request class has a
latency objective declared as a knob: ``read`` (a predict request,
``PINT_TORCH_SLO_READ_S``), ``fit`` (a sessionless fit, submit to
result, ``PINT_TORCH_SLO_FIT_S``), ``session`` (a sessionful fit,
``PINT_TORCH_SLO_SESSION_S``) and ``longjob`` (catalog fit, start to
terminal state, ``PINT_TORCH_SLO_LONGJOB_S``). Callers call :func:`observe` where they already measure latency (the
catalog job does at its terminal state), so the ledger costs one
counter pair per request and nothing when telemetry is off.

``slo.<cls>.total`` counts observed requests; ``slo.<cls>.burn``
counts the ones that missed the objective (latency above target, or an
explicit miss such as a failed job). :func:`snapshot` folds both into
per-class burn rates.
"""

from __future__ import annotations

from pint_tpu_torch import config
from pint_tpu_torch.telemetry import core, counters

#: request classes with a declared latency objective (one knob each).
CLASSES = ("read", "fit", "session", "longjob")


def target_s(cls: str) -> float:
    """The declared latency objective [s] for a request class."""
    # literal knob names, so the knob-registry scan can verify them
    if cls == "read":
        return config.env_float("PINT_TORCH_SLO_READ_S")
    if cls == "fit":
        return config.env_float("PINT_TORCH_SLO_FIT_S")
    if cls == "session":
        return config.env_float("PINT_TORCH_SLO_SESSION_S")
    if cls == "longjob":
        return config.env_float("PINT_TORCH_SLO_LONGJOB_S")
    raise KeyError(cls)


def observe(cls: str, latency_s: float, *, missed: bool = False) -> None:
    """Ledger one served request of class ``cls``: it counts toward
    ``slo.<cls>.total``, and burns when its latency exceeded the class
    objective or the caller knows it missed. No-op when telemetry is
    off."""
    if not core.enabled():
        return
    counters.inc(f"slo.{cls}.total")
    if missed or latency_s > target_s(cls):
        counters.inc(f"slo.{cls}.burn")


def snapshot() -> dict:
    """Per-class ledger state: target, totals, burns, burn rate."""
    snap = counters.counters_snapshot()
    out = {}
    for cls in CLASSES:
        total = snap.get(f"slo.{cls}.total", 0)
        burn = snap.get(f"slo.{cls}.burn", 0)
        out[cls] = {
            "target_s": target_s(cls),
            "total": int(total),
            "burn": int(burn),
            "burn_rate": round(burn / total, 6) if total else 0.0,
        }
    return out
