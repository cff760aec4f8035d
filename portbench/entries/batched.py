"""Independent GLS fits of many pulsars at once through
``BatchedPulsarFitter``: one vmapped step per evaluation in the fused
batched loop, no GW term and no Gram kernel."""

from __future__ import annotations

import numpy as np

from portbench.entries._common import Answer, Starts, loop_counts, problems, sync

# the reference judges each pulsar alone (no GW background)
GW = False


class Entry:
    def __init__(self, raws, cfg, device):
        from pint_tpu_torch.parallel.batch import BatchedPulsarFitter

        pairs, self.data_build_s = problems(raws, device)
        self.device = device
        self.fitter = BatchedPulsarFitter(pairs, device=device)
        self.starts = Starts([m for _, m in pairs])

    def fit(self, kicks, maxiter: int) -> Answer:
        self.starts.apply(kicks)
        chi2 = np.asarray(self.fitter.fit_toas(maxiter=maxiter), dtype=float)
        sync(self.device)
        ok = bool(np.all(self.fitter.converged) and np.all(np.isfinite(chi2)))
        return Answer(self.starts.answers(), [float(c) for c in chi2], ok,
                      loop_counts(self.fitter.loop_stats))

    def close(self) -> None:
        from pint_tpu_torch.fitting import device_loop

        del self.fitter, self.starts
        device_loop.clear_cache()
