"""One pulsar's damped GLS fit through ``HybridGLSFitter``: the fused
loop, with both Grams of each full step on the ds32 kernel."""

from __future__ import annotations

import math

from portbench.entries._common import Answer, Starts, loop_counts, problems, sync

# the reference judges each pulsar alone (no GW background)
GW = False


class Entry:
    def __init__(self, raws, cfg, device):
        from pint_tpu_torch.fitting.hybrid import HybridGLSFitter

        pairs, self.data_build_s = problems(raws, device)
        (table, model), = pairs
        self.device = device
        self.fitter = HybridGLSFitter(table, model, device=device)
        self.starts = Starts([model])

    def fit(self, kicks, maxiter: int) -> Answer:
        self.starts.apply(kicks)
        chi2 = self.fitter.fit_toas(maxiter=maxiter)
        sync(self.device)
        ok = bool(self.fitter.converged) and math.isfinite(chi2)
        return Answer(self.starts.answers(), [chi2], ok,
                      loop_counts(self.fitter.loop_stats))

    def close(self) -> None:
        from pint_tpu_torch.fitting import device_loop

        del self.fitter, self.starts
        device_loop.clear_cache()
