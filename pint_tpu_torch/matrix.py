"""Labeled design / covariance / correlation matrices.

Counterpart of ``pint_tpu.matrix`` (reference: ``pint.pint_matrix`` ::
DesignMatrix, CovarianceMatrix, CorrelationMatrix and the wideband
``combine_design_matrices_by_quantity``/``_by_param``). Labels are
``(param name, unit string)`` pairs on plain float64 host arrays: the
host-side reporting layer on top of the fitters' tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _param_units(model, names: list[str]) -> list[str]:
    out = []
    for n in names:
        if n == "Offset":
            out.append("s")
        elif n in model.params:
            out.append(model.params[n].units or "")
        else:
            out.append("")
    return out


@dataclasses.dataclass
class DesignMatrix:
    """(n, p) derivative matrix with labeled parameter columns.

    ``quantity`` is what the rows differentiate ("toa" residuals in
    seconds, or "dm" in pc/cm^3) — the key wideband combination merges
    on. Reference: pint.pint_matrix.DesignMatrix.
    """

    matrix: np.ndarray
    params: list[str]
    units: list[str]
    quantity: str = "toa"
    quantity_unit: str = "s"

    @classmethod
    def from_model(cls, model, toas, params: list[str] | None = None,
                   quantity: str = "toa") -> "DesignMatrix":
        if quantity == "toa":
            M, names = model.designmatrix(toas, params)
            qunit = "s"
        elif quantity == "dm":
            M, names = model.dm_designmatrix(toas, params)
            qunit = "pc cm^-3"
        else:
            raise ValueError(f"unknown design-matrix quantity {quantity!r}")
        return cls(M.cpu().numpy(), list(names),
                   _param_units(model, list(names)), quantity, qunit)

    @property
    def shape(self) -> tuple[int, int]:
        return self.matrix.shape

    def derivative_params(self) -> list[str]:
        return list(self.params)

    def get_unit(self, param: str) -> str:
        return self.units[self.params.index(param)]

    def labels(self) -> list[tuple[str, str]]:
        return list(zip(self.params, self.units))


def combine_design_matrices_by_quantity(matrices: list[DesignMatrix]
                                        ) -> DesignMatrix:
    """Stack row blocks of different quantities over one parameter set.

    The wideband joint fit stacks the TOA block on top of the DM block;
    all blocks must share the same parameter columns (order included).
    Reference: pint.pint_matrix.combine_design_matrices_by_quantity.
    """
    if not matrices:
        raise ValueError("no design matrices given")
    first = matrices[0]
    for m in matrices[1:]:
        if m.params != first.params:
            raise ValueError(
                f"parameter columns differ: {m.params} vs {first.params}")
    return DesignMatrix(
        np.concatenate([m.matrix for m in matrices], axis=0),
        list(first.params), list(first.units),
        quantity="+".join(m.quantity for m in matrices),
        quantity_unit="+".join(m.quantity_unit for m in matrices))


def combine_design_matrices_by_param(matrices: list[DesignMatrix]
                                     ) -> DesignMatrix:
    """Concatenate parameter-column blocks over one quantity/row axis.

    Shared columns must be bitwise identical (they come from the same
    model and table); new columns append. Reference:
    pint.pint_matrix.combine_design_matrices_by_param.
    """
    if not matrices:
        raise ValueError("no design matrices given")
    out = matrices[0]
    for m in matrices[1:]:
        if m.matrix.shape[0] != out.matrix.shape[0]:
            raise ValueError("row (quantity) axes differ")
        new_cols, new_params, new_units = [], [], []
        for j, p in enumerate(m.params):
            if p in out.params:
                if not np.array_equal(m.matrix[:, j],
                                      out.matrix[:, out.params.index(p)]):
                    raise ValueError(f"conflicting columns for {p}")
                continue
            new_cols.append(m.matrix[:, j])
            new_params.append(p)
            new_units.append(m.units[j])
        if new_cols:
            out = DesignMatrix(
                np.concatenate([out.matrix, np.stack(new_cols, 1)], axis=1),
                out.params + new_params, out.units + new_units,
                out.quantity, out.quantity_unit)
    return out


@dataclasses.dataclass
class CovarianceMatrix:
    """(p, p) parameter covariance with labels; prettyprint + correlation.

    Reference: pint.pint_matrix.CovarianceMatrix / CorrelationMatrix
    (and pint.utils' covariance-to-correlation helpers).
    """

    matrix: np.ndarray
    params: list[str]
    units: list[str]

    @classmethod
    def from_fitter(cls, fitter) -> "CovarianceMatrix":
        if fitter.parameter_covariance_matrix is None:
            raise ValueError("fit_toas() has not been run")
        names = ["Offset"] + list(fitter.fit_params)
        cov = np.asarray(fitter.parameter_covariance_matrix)
        if cov.shape[0] == len(names) - 1:  # fitter dropped the offset row
            names = list(fitter.fit_params)
        return cls(cov, names, _param_units(fitter.model, names))

    @property
    def shape(self) -> tuple[int, int]:
        return self.matrix.shape

    def get_label_names(self) -> list[str]:
        return list(self.params)

    def get_uncertainties(self) -> np.ndarray:
        return np.sqrt(np.diag(self.matrix))

    def to_correlation_matrix(self) -> "CorrelationMatrix":
        sig = self.get_uncertainties()
        denom = np.outer(sig, sig)
        corr = np.divide(self.matrix, denom,
                         out=np.zeros_like(self.matrix), where=denom != 0)
        return CorrelationMatrix(corr, list(self.params),
                                 [""] * len(self.params))

    def prettyprint(self, prec: int = 3) -> str:
        return _pretty(self.matrix, self.params, prec, sci=True)


@dataclasses.dataclass
class CorrelationMatrix(CovarianceMatrix):
    def prettyprint(self, prec: int = 3) -> str:
        return _pretty(self.matrix, self.params, prec, sci=False)


def _pretty(mat: np.ndarray, names: list[str], prec: int, *, sci: bool) -> str:
    """Lower-triangle table like the reference's correlation printout."""
    w = max(max((len(n) for n in names), default=4), prec + (8 if sci else 4))
    fmt = f"{{:>{w}.{prec}e}}" if sci else f"{{:>{w}.{prec}f}}"
    lines = []
    for i, n in enumerate(names):
        cells = [fmt.format(mat[i, j]) for j in range(i + 1)]
        lines.append(f"{n:<12}" + " ".join(cells))
    lines.append(" " * 12 + " ".join(f"{n:>{w}}" for n in names))
    return "\n".join(lines)
