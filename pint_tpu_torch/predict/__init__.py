"""pint_tpu_torch.predict: the read path.

Counterpart of ``pint_tpu.predict``. Phase and spin-frequency predictions
served from cached fit state, never touching the fit loop:

* :mod:`pint_tpu_torch.predict.engine`: the device polycos engine
  (window coefficients from one evaluation of every node, batched
  evaluation with a device ``searchsorted``);
* :mod:`pint_tpu_torch.predict.cache`: the segment cache, keyed
  ``(session, fingerprint, time window)``, LRU under a byte budget and
  invalidated on session commit;
* :class:`ReadService`: the ladder. A cache hit is evaluated on the
  device; a miss is served by the exact dense model evaluation while the
  window is generated; a model without a TZR anchor is served dense; and
  ``PINT_TORCH_READ_PATH=0`` serves everything through the host
  ``Polycos`` (the kill switch).

The serving tier (:class:`pint_tpu_torch.serve.scheduler.PredictRequest`,
the read lane that never waits on fit drains, the read SLO and the
``type="read"`` records) is :mod:`pint_tpu_torch.serve`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch import config, telemetry
from pint_tpu_torch.predict import engine  # noqa: F401
from pint_tpu_torch.predict.cache import SegmentCache, read_cache_budget  # noqa: F401
from pint_tpu_torch.predict.engine import (  # noqa: F401
    COEFF_PARITY_CYCLES, FREQ_PARITY_REL, PHASE_PARITY_CYCLES, ChebWindow,
    eval_window, generate_cheb_window, read_path_enabled)


def max_windows_per_request() -> int:
    """Cap on fresh cache windows one request may generate; query rows
    beyond it are served dense (counted)."""
    return config.env_int("PINT_TORCH_READ_MAX_WINDOWS")


@dataclasses.dataclass
class ReadOutput:
    """One read's payload and provenance (the service envelope, status,
    latency and deadline, is the scheduler's ``PredictResult``)."""

    phase_int: np.ndarray    # absolute pulse number
    phase_frac: np.ndarray   # fractional phase in [0, 1)
    freq_hz: np.ndarray      # apparent (topocentric) spin frequency
    source: str              # "cheb" | "dense" | "mixed" | "host_polycos"
    cache_hit: bool          # every window served from the segment cache
    windows: int = 0         # cache windows this request touched
    window_hits: int = 0
    window_misses: int = 0
    fallback_queries: int = 0  # rows served by the dense fallback


def dense_predict(model, mjds, *, obs: str = "@", freq_mhz: float = 1400.0,
                  device=None) -> tuple:
    """Direct model-phase evaluation, the read path's exact fallback, on
    ``device`` (``None``: the card).

    One table over ``[mjds, mjds + 1 s]`` and one phase evaluation; the
    apparent spin frequency is the 1 s forward phase difference, formed
    part-wise. Returns ``(phase_int, phase_frac in [0, 1), freq_hz)``.
    """
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
    n = mjds.size
    both = np.concatenate([mjds, mjds + 1.0 / 86400.0])
    with telemetry.span("predict.dense", queries=n):
        toas = build_TOAs_from_arrays(
            DD(both, np.zeros(both.size)),
            freq_mhz=np.full(both.size, float(freq_mhz)),
            error_us=np.full(both.size, 1.0), obs_names=(obs,),
            eph=model.ephem, device=resolve_device(device))
        ph = model.phase(toas, abs_phase=model.has_component("AbsPhase"))
    pi, hi, lo = torch.stack([ph.int_part, ph.frac.hi,
                              ph.frac.lo]).cpu().numpy()
    # part-wise 1 s forward difference: ~1e9-cycle absolute phases
    # collapsed to one float64 first would bury the ~F0-cycle signal
    freq = (pi[n:] - pi[:n]) + (hi[n:] - hi[:n]) + (lo[n:] - lo[:n])
    ints = pi[:n].copy()
    frac = hi[:n] + lo[:n]
    carry = np.floor(frac)
    ints += carry
    frac = frac - carry
    # a fraction of -eps wraps to exactly 1.0 after the carry
    wrap = frac >= 1.0
    return ints + wrap, np.where(wrap, frac - 1.0, frac), freq


class ReadService:
    """The read path's host-side driver: cache consultation, the ladder
    and the kill switch. Owned by the scheduler (one per
    :class:`~pint_tpu_torch.serve.scheduler.ThroughputScheduler`); its
    cache is attached to the session cache for commit invalidation.

    ``device`` places every generated artifact, every evaluation and
    every dense fallback (``None``: the card); the scheduler passes the
    last device of its pool, so that with several cards reads do not
    queue behind fits.
    """

    def __init__(self, cache: SegmentCache | None = None, device=None):
        self.cache = cache if cache is not None else SegmentCache()
        self.device = device

    # -- the ladder ----------------------------------------------------
    def predict(self, model, mjds, *, obs: str = "@",
                freq_mhz: float = 1400.0, skey=None,
                version: int = 0) -> ReadOutput:
        """Serve one read. ``skey`` keys the cache (the scheduler
        passes ``(session_id, fp8)`` or a value-digested model key);
        ``version`` is the session's commit version (0 sessionless)."""
        mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
        if mjds.size == 0:
            raise ValueError("predict needs at least one query time")
        if not np.all(np.isfinite(mjds)):
            raise ValueError("non-finite query MJD")
        if not read_path_enabled():
            return self._predict_host(model, mjds, obs=obs,
                                      freq_mhz=freq_mhz, skey=skey,
                                      version=version)
        if not engine.eligible(model):
            telemetry.inc("serve.read.ineligible")
            telemetry.inc("serve.read.fallbacks", mjds.size)
            pi, pf, fr = dense_predict(model, mjds, obs=obs,
                                       freq_mhz=freq_mhz,
                                       device=self.device)
            return ReadOutput(pi, pf, fr, source="dense",
                              cache_hit=False,
                              fallback_queries=int(mjds.size))
        span_min = engine.segment_minutes()
        n_seg = engine.window_segments()
        ncoeff = engine.read_ncoeff()
        wd = engine.window_days()
        win_idx = np.floor(mjds / wd).astype(np.int64)
        unique = np.unique(win_idx)
        cap = max_windows_per_request()
        pi = np.zeros(mjds.size)
        pf = np.zeros(mjds.size)
        fr = np.zeros(mjds.size)
        hits = misses = builds = 0
        fb = np.zeros(mjds.size, dtype=bool)
        for w in unique:
            sel = win_idx == w
            key = (skey, obs, round(float(freq_mhz), 3), int(w),
                   ("cheb", span_min, n_seg, ncoeff))
            e = self.cache.lookup(key, version)
            if e is None:
                # miss: launch the window's generation (no sync) so the
                # next read of this window hits, and serve this one's
                # rows through the exact dense path. The per-request
                # cap counts fresh builds only.
                misses += 1
                telemetry.inc("serve.read.cache_misses")
                fb |= sel
                if builds >= cap:
                    telemetry.inc("serve.read.window_cap")
                    continue
                builds += 1
                win = engine.generate_cheb_window(
                    model, float(w) * wd, n_seg=n_seg,
                    segment_length_min=span_min, ncoeff=ncoeff,
                    obs=obs, freq_mhz=freq_mhz, device=self.device)
                self.cache.admit(key, win, win.nbytes, version)
                telemetry.inc("serve.read.warms")
                continue
            hits += 1
            telemetry.inc("serve.read.cache_hits")
            wpi, wpf, wfr, ok = eval_window(e.window, mjds[sel])
            rows = np.flatnonzero(sel)
            pi[rows] = wpi
            pf[rows] = wpf
            fr[rows] = wfr
            fb[rows[~ok]] = True  # belt and braces: out-of-span rows
        n_fb = int(fb.sum())
        if n_fb:
            telemetry.inc("serve.read.fallbacks", n_fb)
            dpi, dpf, dfr = dense_predict(model, mjds[fb], obs=obs,
                                          freq_mhz=freq_mhz,
                                          device=self.device)
            pi[fb], pf[fb], fr[fb] = dpi, dpf, dfr
        source = ("cheb" if n_fb == 0 and misses == 0
                  else "dense" if hits == 0 else "mixed")
        return ReadOutput(pi, pf, fr, source=source,
                          cache_hit=(misses == 0 and n_fb == 0
                                     and hits > 0),
                          windows=int(unique.size), window_hits=hits,
                          window_misses=misses, fallback_queries=n_fb)

    # -- kill switch ---------------------------------------------------
    def _predict_host(self, model, mjds, *, obs, freq_mhz, skey,
                      version) -> ReadOutput:
        """``PINT_TORCH_READ_PATH=0``: the host ``Polycos`` path over the
        same window grid (cached like the device artifacts, invalidated
        alike)."""
        from pint_tpu_torch.polycos import Polycos

        telemetry.inc("serve.read.host_path")
        if not engine.eligible(model):
            telemetry.inc("serve.read.ineligible")
            telemetry.inc("serve.read.fallbacks", mjds.size)
            pi, pf, fr = dense_predict(model, mjds, obs=obs,
                                       freq_mhz=freq_mhz,
                                       device=self.device)
            return ReadOutput(pi, pf, fr, source="dense",
                              cache_hit=False,
                              fallback_queries=int(mjds.size))
        span_min = engine.segment_minutes()
        n_seg = engine.window_segments()
        ncoeff = engine.read_ncoeff()
        wd = engine.window_days()
        win_idx = np.floor(mjds / wd).astype(np.int64)
        unique = np.unique(win_idx)
        pi = np.zeros(mjds.size)
        pf = np.zeros(mjds.size)
        fr = np.zeros(mjds.size)
        hits = misses = 0
        for w in unique:
            sel = win_idx == w
            key = (skey, obs, round(float(freq_mhz), 3), int(w),
                   ("host", span_min, n_seg, ncoeff))
            e = self.cache.lookup(key, version)
            if e is None:
                misses += 1
                telemetry.inc("serve.read.cache_misses")
                pcs = Polycos.generate_polycos(
                    model, float(w) * wd, float(w + 1) * wd, obs=obs,
                    segment_length_min=span_min, ncoeff=ncoeff,
                    freq_mhz=freq_mhz, device=self.device)
                nbytes = 8 * n_seg * (ncoeff + 4)
                self.cache.admit(key, pcs, nbytes, version, host=True)
            else:
                hits += 1
                telemetry.inc("serve.read.cache_hits")
                pcs = e.window
            rows = np.flatnonzero(sel)
            ints, fracs = pcs.eval_abs_phase(mjds[sel])
            pi[rows] = ints
            pf[rows] = fracs
            fr[rows] = pcs.eval_spin_freq(mjds[sel])
        return ReadOutput(pi, pf, fr, source="host_polycos",
                          cache_hit=misses == 0,
                          windows=int(unique.size), window_hits=hits,
                          window_misses=misses)


__all__ = [
    "COEFF_PARITY_CYCLES", "ChebWindow", "FREQ_PARITY_REL",
    "PHASE_PARITY_CYCLES", "ReadOutput", "ReadService", "SegmentCache",
    "dense_predict", "engine", "eval_window", "generate_cheb_window",
    "max_windows_per_request", "read_cache_budget", "read_path_enabled",
]
