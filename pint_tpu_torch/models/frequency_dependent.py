"""FD: frequency-dependent profile-evolution delay polynomials.

Counterpart of ``pint_tpu.models.frequency_dependent.FD``. Unmodeled
pulse-profile evolution with observing frequency is absorbed by

    delay = sum_i FD_i * log(nu / 1 GHz)^i ,   i = 1..n  [s]
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import (Component, check_contiguous_series,
                                             f64, has_series_term, safe_log_nu)
from pint_tpu_torch.models.parameter import float_param
from pint_tpu_torch.ops.dd import DD


class FD(Component):
    category = "frequency_dependent"
    is_delay = True

    def __init__(self, num_terms: int = 0):
        super().__init__()
        self.num_terms = num_terms
        for i in range(1, num_terms + 1):
            self.add_param(float_param(f"FD{i}", units="s", index=i,
                                       desc=f"FD delay coefficient {i}"))

    @classmethod
    def applicable(cls, pf) -> bool:
        # any FD<k>: a gapped series must reach from_parfile's error
        return has_series_term(pf, "FD")

    @classmethod
    def from_parfile(cls, pf) -> "FD":
        n = 0
        while pf.get(f"FD{n + 1}") is not None:
            n += 1
        check_contiguous_series(pf, "FD", n, base=1)
        self = cls(num_terms=n)
        self.setup_from_parfile(pf)
        return self

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        valid, log_nu = safe_log_nu(toas)
        # Horner over FD_n..FD_1, no constant term
        acc = torch.zeros_like(log_nu)
        for i in reversed(range(1, self.num_terms + 1)):
            acc = (acc + f64(p, f"FD{i}")) * log_nu
        return torch.where(valid, acc, torch.zeros_like(acc))
