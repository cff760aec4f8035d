"""Headless pintk state machine (reference: pint.pintk.pulsar.Pulsar).

Counterpart of ``pint_tpu.pintk.controller``. Every GUI capability is a
method here: prefit/postfit residuals, TOA selection and deletion,
fit-flag toggles, fitting the selection, random-model envelopes,
orbital-phase x-axes, the par/tim text panes, and writing par/tim files.
The numerics run through the package's fitters on the device the table
lies on; the view layer (:mod:`pint_tpu_torch.pintk.app`) only draws.
"""

from __future__ import annotations

import copy

import numpy as np

from pint_tpu_torch.fitting import Fitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import calculate_random_models
from pint_tpu_torch.toas import write_TOA_file

X_AXES = ("mjd", "orbital phase", "serial", "day of year", "frequency")
Y_AXES = ("prefit", "postfit")


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class PintkController:
    """Model/TOAs/fit state behind the pintk GUI; the fits run on the
    device the TOA table lies on."""

    def __init__(self, toas, model):
        self.all_toas = toas
        self.base_model = model
        self.model = copy.deepcopy(model)
        self.postfit_model = None
        self.fitter = None
        self.selected = np.ones(len(toas), dtype=bool)
        self.deleted = np.zeros(len(toas), dtype=bool)
        self.random_dphase = None
        self._prefit_cache = None
        self._postfit_cache = None
        self._avg_cache = {}

    # ---------------------------------------------------------------- state
    @property
    def n_active(self) -> int:
        return int((~self.deleted).sum())

    def active_toas(self):
        return self.all_toas.select(~self.deleted)

    def prefit_resids(self) -> Residuals:
        if self._prefit_cache is None:
            self._prefit_cache = Residuals(self.active_toas(), self.model)
        return self._prefit_cache

    def postfit_resids(self) -> Residuals | None:
        if self.postfit_model is None:
            return None
        if self._postfit_cache is None:
            self._postfit_cache = Residuals(self.active_toas(),
                                            self.postfit_model)
        return self._postfit_cache

    def _invalidate(self):
        self._prefit_cache = None
        self._postfit_cache = None
        self._avg_cache = {}

    # ------------------------------------------------------------ selection
    def select_range(self, mjd_lo: float, mjd_hi: float, *,
                     extend: bool = False) -> int:
        """Select active TOAs in [mjd_lo, mjd_hi]; returns count selected."""
        mjds = self.all_toas.get_mjds()
        box = (mjds >= mjd_lo) & (mjds <= mjd_hi) & (~self.deleted)
        self.selected = (self.selected | box) if extend else box
        return int(self.selected.sum())

    def select_all(self):
        self.selected = ~self.deleted

    def delete_selected(self) -> int:
        """Mark the selected TOAs deleted; returns how many remain."""
        self.deleted |= self.selected
        self.selected = np.zeros_like(self.selected)
        self.random_dphase = None  # envelope shape no longer matches
        self._invalidate()
        return self.n_active

    def undelete_all(self):
        self.deleted[:] = False
        self._invalidate()

    # ------------------------------------------------------------- fit flags
    def fit_flags(self) -> dict[str, bool]:
        """{param: free?} for every fittable numeric parameter."""
        return {p.name: not p.frozen for p in self.model.params.values()
                if p.is_numeric and p.fittable}

    def set_fit_flag(self, name: str, free: bool):
        self.model.params[name].frozen = not free
        if self.postfit_model is not None and name in self.postfit_model.params:
            self.postfit_model.params[name].frozen = not free

    # ------------------------------------------------------------------ fit
    def fit(self, maxiter: int = 4) -> dict:
        """Fit the active TOAs; the postfit model becomes the new prefit
        on the next call (like hitting Fit twice in the reference)."""
        start = self.postfit_model or self.model
        fit_model = copy.deepcopy(start)
        toas = self.active_toas()
        self.fitter = Fitter.auto(toas, fit_model)
        chi2 = self.fitter.fit_toas(maxiter=maxiter)
        self.postfit_model = fit_model
        self.random_dphase = None
        self._postfit_cache = None
        self._avg_cache.pop("postfit", None)
        return {"chi2": float(chi2), "dof": self.fitter.resids.dof,
                "wrms_us": self.fitter.resids.rms_weighted_s() * 1e6,
                "fitter": type(self.fitter).__name__}

    def reset(self):
        """Back to the as-loaded model; clears fits/deletions/selection."""
        self.model = copy.deepcopy(self.base_model)
        self.postfit_model = None
        self.fitter = None
        self.random_dphase = None
        self.undelete_all()
        self.select_all()

    # ---------------------------------------------------------- random models
    def random_models(self, n: int = 30, seed: int | None = 0) -> np.ndarray:
        """(n, n_active) time-envelope draws from the fit covariance [s]."""
        if self.fitter is None:
            raise ValueError("fit first: random models need a covariance")
        self.random_dphase = calculate_random_models(
            self.fitter, self.active_toas(), Nmodels=n, seed=seed,
            return_time=True)
        return self.random_dphase

    # ------------------------------------------------------------- plot data
    def x_data(self, axis: str = "mjd") -> tuple[np.ndarray, str]:
        """X values for the active TOAs + axis label."""
        toas = self.active_toas()
        mjds = toas.get_mjds()
        if axis == "mjd":
            return mjds, "MJD"
        if axis == "serial":
            return np.arange(mjds.size, dtype=float), "TOA number"
        if axis == "day of year":
            # true calendar day-of-year (the reference's seasonal view),
            # not a fold over the MJD epoch
            days = np.floor(mjds).astype(np.int64)
            dates = np.datetime64("1858-11-17") + days.astype("timedelta64[D]")
            year_start = dates.astype("datetime64[Y]").astype("datetime64[D]")
            doy = (dates - year_start).astype(np.float64) + 1.0 + (mjds - days)
            return doy, "Day of year"
        if axis == "frequency":
            return _host(toas.freq_mhz), "Frequency (MHz)"
        if axis == "orbital phase":
            model = self.postfit_model or self.model
            comp = next((c for c in model.components
                         if getattr(c, "binary_model_name", None)), None)
            if comp is None:
                raise ValueError("model has no binary component")
            name = "TASC" if "TASC" in model.params else "T0"
            epoch = model[name].hi + model[name].lo
            pb = model["PB"].hi + model["PB"].lo
            return ((mjds - epoch) / pb) % 1.0, "Orbital phase"
        raise ValueError(f"unknown x axis {axis!r}; have {X_AXES}")

    def _resids_for(self, which: str) -> Residuals:
        if which == "prefit":
            return self.prefit_resids()
        if which == "postfit":
            r = self.postfit_resids()
            if r is None:
                raise ValueError("no postfit model yet: fit first")
            return r
        raise ValueError(f"unknown y axis {which!r}; have {Y_AXES}")

    def y_data(self, which: str = "prefit") -> tuple[np.ndarray, np.ndarray, str]:
        """(residuals_us, errors_us, label) for the active TOAs."""
        r = self._resids_for(which)
        return (_host(r.time_resids) * 1e6,
                _host(r.get_errors_s()) * 1e6,
                f"{which} residual (us)")

    def averaged_y_data(self, which: str = "prefit"
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        """Epoch-averaged residuals (plk 'avg' view; Residuals.ecorr_average).

        Returns (mjds, residuals_us, errors_us, label).
        """
        r = self._resids_for(which)
        if which not in self._avg_cache:  # invalidated with the resids
            self._avg_cache[which] = r.ecorr_average()
        avg = self._avg_cache[which]
        return (avg["mjds"], avg["time_resids"] * 1e6,
                avg["errors"] * 1e6, f"avg {which} residual (us)")

    # ------------------------------------------------------------ text panes
    # (reference: pint.pintk.paredit / timedit — in-GUI par/tim text
    # editing round-tripping through the normal load paths)
    def get_par_text(self) -> str:
        """Editable par text of the current (pre-fit) model."""
        return self.model.as_parfile()

    def apply_par_text(self, text: str):
        """Replace the working model with one parsed from edited text.

        Round-trips through :func:`pint_tpu_torch.models.get_model`,
        exactly what loading the file would do, so invalid edits raise
        before any state is touched. Clears fit state (the old postfit
        model belongs to the old parameterization) but keeps TOA
        selection and deletion, like the reference's paredit Apply.
        """
        model = get_model(text)
        self.model = model
        self.base_model = copy.deepcopy(model)
        self.postfit_model = None
        self.fitter = None
        self.random_dphase = None
        self._invalidate()

    def get_tim_text(self) -> str:
        """Editable tempo2-format text of ALL loaded TOAs (incl. deleted)."""
        return write_TOA_file(self.all_toas)

    def apply_tim_text(self, text: str):
        """Replace the TOA table with one parsed from edited text.

        Round-trips through the normal tim pipeline (clock chain, TDB,
        posvels via :func:`pint_tpu_torch.toas.get_TOAs`, with the model's
        ephemeris, on the current table's device). Selection and deletion
        reset: row identity is not preserved across an arbitrary edit.
        """
        import os
        import tempfile

        from pint_tpu_torch.toas import get_TOAs

        fd, path = tempfile.mkstemp(suffix=".tim")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            toas = get_TOAs(path, ephem=self.model.ephem,
                            device=self.all_toas.device)
        finally:
            os.unlink(path)
        self.all_toas = toas
        self.selected = np.ones(len(toas), dtype=bool)
        self.deleted = np.zeros(len(toas), dtype=bool)
        self.fitter = None
        self.postfit_model = None
        self.random_dphase = None
        self._invalidate()

    # ---------------------------------------------------------------- output
    def write_par(self, path: str) -> str:
        model = self.postfit_model or self.model
        text = model.as_parfile()
        with open(path, "w") as f:
            f.write(text)
        return text

    def write_tim(self, path: str):
        write_TOA_file(self.active_toas(), path)

    def summary(self) -> str:
        if self.fitter is not None:
            return self.fitter.get_summary()
        r = self.prefit_resids()
        return (f"{self.model.name}: {self.n_active} TOAs, prefit "
                f"wrms {r.rms_weighted_s() * 1e6:.3f} us, "
                f"chi2 {r.chi2:.2f} / dof {r.dof}")
