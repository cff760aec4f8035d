"""Fitter base: holds (toas, model), the residuals and the fit results.

Counterpart of ``pint_tpu.fitting.fitter.Fitter``. A fit solves for
small float64 deltas per free parameter and the host applies them to
the DD base values exactly (:meth:`Param.add_delta`), so float64 linear
algebra never erodes the parameters' double-double state.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.residuals import Residuals


class Fitter:
    """Base fitter: holds (toas, model), exposes fit_toas."""

    def __init__(self, toas, model):
        self.toas = toas
        self.model = model
        self.resids = self._new_resids()
        self.parameter_covariance_matrix: np.ndarray | None = None
        self.fit_params: list[str] = []
        self.converged = False
        # a fit that produced a non-finite chi2 is flagged, never
        # silently "converged"
        self.diverged = False
        self.diverged_reason: str | None = None

    def _new_resids(self) -> Residuals:
        return Residuals(self.toas, self.model)

    def fit_toas(self, maxiter: int = 1, **kw) -> float:
        raise NotImplementedError
