"""The joint GLS fit of a whole array with the Hellings-Downs GW
background through ``PTAGLSFitter``: the stacked Gram-kernel route, one
captured joint evaluation replayed per step."""

from __future__ import annotations

import math

from portbench.entries._common import Answer, Starts, loop_counts, problems, sync

# the reference judges the array jointly, with the configuration's GW term
GW = True


class Entry:
    def __init__(self, raws, cfg, device):
        from pint_tpu_torch.parallel.pta import PTAGLSFitter

        pairs, self.data_build_s = problems(raws, device)
        gw = cfg["gw"]
        self.device = device
        self.fitter = PTAGLSFitter(pairs, gw_log10_amp=gw["log10_amp"],
                                   gw_gamma=gw["gamma"], gw_nharm=gw["nharm"],
                                   device=device)
        self.starts = Starts([m for _, m in pairs])

    def fit(self, kicks, maxiter: int) -> Answer:
        self.starts.apply(kicks)
        chi2 = self.fitter.fit_toas(maxiter=maxiter)
        sync(self.device)
        ok = bool(self.fitter.converged) and math.isfinite(chi2)
        return Answer(self.starts.answers(), chi2, ok,
                      loop_counts(self.fitter.loop_stats))

    def close(self) -> None:
        from pint_tpu_torch.fitting import device_loop

        del self.fitter, self.starts
        device_loop.clear_cache()
