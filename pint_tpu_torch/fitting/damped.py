"""Damped Gauss-Newton outer loop over a fused fit step.

Counterpart of ``pint_tpu.fitting.damped.downhill_iterate``, with the
reference's loop counters, telemetry spans (``fit.step`` around each full
evaluation, ``fit.probe`` around each probe) and flight-recorder trace.
One step call evaluates the chi2 at the input
parameters AND proposes a Gauss-Newton step, so judging a trial point
costs one step. This host loop is the oracle of the fused loop
(:mod:`pint_tpu_torch.fitting.device_loop`): the same accept / halve /
converge decisions, counters and trace entries.

The step contract: ``iterate(deltas) -> (new_deltas, info)`` where
``info["chi2_at_input"]`` is the (noise-marginalized) chi2 of the
residuals at ``deltas`` and ``new_deltas`` is the proposed full step
from there. ``chi2_at(deltas) -> float`` is an optional cheap probe
evaluating only that chi2 (no design matrix, no solve); halved trial
points are judged with it, and a probe-accepted point is re-evaluated
once with the full step, whose value is authoritative.

The reference's ``downhill_iterate_pipelined`` is not ported: it
overlaps a CPU stage 1 with an accelerator stage 2, and here both
stages run on one device.
"""

from __future__ import annotations

import math

from pint_tpu_torch import telemetry
from pint_tpu_torch.telemetry import recorder

# the loop's event counters (the reference's fit.* telemetry counters)
COUNTERS = ("iterations", "accepts", "halvings", "probe_evals",
            "probe_rejects")


def downhill_iterate(iterate, deltas0: dict, *, maxiter: int = 20,
                     min_chi2_decrease: float = 1e-3,
                     max_step_halvings: int = 8, chi2_at=None,
                     counters: dict | None = None):
    """Run a damped Gauss-Newton loop; returns (deltas, info, chi2, converged).

    Take the proposed step; while chi2 increases, halve it. Stop when no
    downhill step exists (converged at a minimum of the linearized model)
    or the decrease falls below ``min_chi2_decrease``. ``info`` is the
    step output evaluated *at the returned deltas*; ``chi2`` is the
    actual chi2 there. A non-finite full evaluation ends the fit at the
    last kept point with ``info["diverged"]`` set.

    ``counters``, when given, is filled with the loop's events: the
    :data:`COUNTERS` and the outcome (``converged``,
    ``maxiter_exhausted``, ``diverged``: 1 for the one that happened).
    When the flight recorder is on, one trace record is emitted
    (:func:`pint_tpu_torch.telemetry.recorder.last_trace`). With
    telemetry on, the counters also go to ``fit.<name>`` and the outcome
    to ``fit.converged``/``fit.maxiter_exhausted``/``fit.diverged``.
    """
    cnt = dict.fromkeys(COUNTERS, 0)
    rec = recorder.host_trace()
    with telemetry.span("fit.step"):
        new_deltas, info = iterate(deltas0)
    chi2 = float(info["chi2_at_input"])
    if rec:
        rec.eval(chi2, 1.0)
    deltas = deltas0
    converged = False
    diverged = not math.isfinite(chi2)
    for _ in (() if diverged else range(max(1, maxiter))):
        cnt["iterations"] += 1
        dx = {k: new_deltas[k] - deltas[k] for k in deltas}
        lam, applied = 1.0, False
        trial = trial_new = trial_info = None
        for _h in range(max_step_halvings):
            if _h > 0:
                cnt["halvings"] += 1
                if rec:
                    rec.halving()
            trial = {k: deltas[k] + lam * dx[k] for k in deltas}
            if _h == 0 or chi2_at is None:
                with telemetry.span("fit.step"):
                    trial_new, trial_info = iterate(trial)
                trial_chi2 = float(trial_info["chi2_at_input"])
                if rec:
                    rec.eval(trial_chi2, lam)
                if not math.isfinite(trial_chi2):
                    diverged = True
                    break
            else:
                cnt["probe_evals"] += 1
                trial_new = trial_info = None
                with telemetry.span("fit.probe"):
                    trial_chi2 = float(chi2_at(trial))
                if rec:
                    rec.probe_eval()
            if trial_chi2 <= chi2 + 1e-12:
                if trial_info is None:
                    # accepted via the cheap probe: one full evaluation at
                    # the accepted point supplies the next proposal; its
                    # chi2 is authoritative, so an uphill value there
                    # keeps halving instead of applying the step
                    with telemetry.span("fit.step"):
                        trial_new, trial_info = iterate(trial)
                    trial_chi2 = float(trial_info["chi2_at_input"])
                    if rec:
                        rec.eval(trial_chi2, lam)
                    if not math.isfinite(trial_chi2):
                        diverged = True
                        break
                    if trial_chi2 > chi2 + 1e-12:
                        cnt["probe_rejects"] += 1
                        lam *= 0.5
                        continue
                applied = True
                cnt["accepts"] += 1
                if rec:
                    rec.accept()
                break
            lam *= 0.5
        if diverged:
            break
        if not applied:
            # no downhill direction left: we are at (numerical) optimum
            converged = True
            break
        decrease = chi2 - trial_chi2
        deltas, chi2 = trial, trial_chi2
        new_deltas, info = trial_new, trial_info
        if decrease < min_chi2_decrease:
            converged = True
            break
    outcome = dict(converged=int(converged and not diverged),
                   maxiter_exhausted=int(not (converged or diverged)),
                   diverged=int(diverged))
    if counters is not None:
        counters.update(cnt, **outcome)
    note_fit_counters(cnt, outcome)
    if rec:
        rec.emit()
    return deltas, dict(info, diverged=diverged), chi2, converged


def note_fit_counters(cnt: dict, outcome: dict) -> None:
    """Add one fit's loop events and outcome to the ``fit.*`` telemetry
    counters (nothing when telemetry is off)."""
    if not telemetry.enabled():
        return
    for k, v in list(cnt.items()) + list(outcome.items()):
        if v:
            telemetry.inc(f"fit.{k}", v)
