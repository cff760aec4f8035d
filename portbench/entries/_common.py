"""What every entry shares: the program's tables and models from the raw
arrivals, a request's start, and one answer's record."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Answer:
    """One finished request: each pulsar's fitted ``{name: ((hi, lo),
    uncertainty)}``, the chi2 the program reported (a float, or a list of
    one per pulsar), whether it converged with a finite chi2, and the
    fused loop's per-fit counts."""

    values: list
    chi2: object
    ok: bool
    stats: dict = field(default_factory=dict)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def problems(raws, device) -> tuple[list, float]:
    """The program's (table, model) of each pulsar, built from the raw
    arrivals as a user's script builds them, and the seconds the tables
    took (ending in a synchronize)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    models = [get_model(r.par) for r in raws]
    sync(device)
    t0 = time.perf_counter()
    tables = [build_TOAs_from_arrays(
        DD(r.mjd_hi, r.mjd_lo), freq_mhz=r.freq_mhz, error_us=r.error_us,
        obs_names=("gbt",), flags=r.flags, eph=m.ephem, device=device)
        for r, m in zip(raws, models)]
    sync(device)
    return list(zip(tables, models)), time.perf_counter() - t0


class Starts:
    """Sets each model to a request's start: the par's values, each free
    parameter moved by its kick (``kicks[p][name]``, in its units)."""

    def __init__(self, models):
        self.models = models
        self.truth = [{k: m[k].value for k in m.free_params} for m in models]

    def apply(self, kicks) -> None:
        for m, truth, kick in zip(self.models, self.truth, kicks):
            for k, v in truth.items():
                m[k].value = v
                if k in kick:
                    m[k].add_delta(kick[k])

    def answers(self) -> list:
        return [{k: (m[k].value, m[k].uncertainty) for k in m.free_params}
                for m in self.models]


def loop_counts(loop_stats: dict) -> dict:
    """A fused fit's evaluations (full steps and probes) and host fetches."""
    return {"evals": loop_stats.get("full", 0) + loop_stats.get("probe", 0),
            "fetches": loop_stats.get("fetches", 0)}
