"""On-device polycos engine: the read path's compute core.

Counterpart of ``pint_tpu.predict.engine``. A fitted model answers "what
is the pulse phase and spin frequency at time t" in two steps that never
touch the fit loop:

* **Generation** (:func:`generate_cheb_window`): the polynomial
  coefficients of every segment of one cache window from one evaluation
  of the composed phase function over every node of the window. The node
  grid is :func:`pint_tpu_torch.polycos.segment_nodes`, the one the host
  ``Polycos`` fits, so the two differ in approximation only. The
  midpoint-referenced phase differences are formed part-wise (exact
  integers, then the double-double fraction differences), the linear
  ``dt * 60 * F0`` term is taken out, and a Chebyshev analysis composed
  with the change to monomials (one (ncoeff, n_nodes) matrix) makes the
  tempo-convention coefficients of all segments in one matmul. The work
  is launched without a host sync: a cache miss serves its own request
  through the dense path while the window's kernels run, and
  :meth:`ChebWindow.ready` is an event query.
* **Evaluation** (:func:`eval_window`): phase and apparent frequency at
  many query times at once: ``torch.searchsorted`` finds each query's
  nearest segment, its coefficients are gathered and one Horner pass
  gives the polynomial and its derivative. The query axis pads to its
  pow-2 bucket, and the result comes back in one copy to the host.

The Chebyshev analysis and the host path's scaled-Vandermonde least
squares differ, so coefficients agree to the shared truncation error,
not bit for bit. The parity bounds are :data:`PHASE_PARITY_CYCLES` on
evaluated phase against both the host ``Polycos`` and the dense model,
:data:`FREQ_PARITY_REL` on frequency, and :data:`COEFF_PARITY_CYCLES` on
each coefficient's contribution ``|dc_p| * tscale^p``.

Kill switch: ``PINT_TORCH_READ_PATH=0`` (read per call) sends every read
to the host ``Polycos`` path (:class:`pint_tpu_torch.predict
.ReadService`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch import bucketing, config, telemetry
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.polycos import MIN_PER_DAY, segment_nodes

#: read-parity bound on evaluated phase, engine against the host
#: ``Polycos`` and against the dense model evaluation [cycles]
PHASE_PARITY_CYCLES = 1e-7
#: apparent spin frequency, engine against the host ``Polycos`` [relative]
FREQ_PARITY_REL = 1e-9
#: per-coefficient contribution |dc_p| * tscale^p [cycles]
COEFF_PARITY_CYCLES = 1e-6


def read_path_enabled() -> bool:
    """Read-path kill switch (read per call): ``PINT_TORCH_READ_PATH=0``
    serves every predict through the host ``Polycos``."""
    return config.env_on("PINT_TORCH_READ_PATH")


def segment_minutes() -> float:
    """Segment length of the read artifact [minutes]."""
    return config.env_float("PINT_TORCH_READ_SEGMENT_MIN")


def window_segments() -> int:
    """Segments per cache window."""
    return config.env_int("PINT_TORCH_READ_WINDOW_SEGMENTS")


def read_ncoeff() -> int:
    """Polynomial order of the read artifact (tempo NCOEFF)."""
    return config.env_int("PINT_TORCH_READ_NCOEFF")


def window_days() -> float:
    """Span of one cache window [days]; windows tile the MJD axis from 0,
    so queries of one configuration near one epoch share an artifact."""
    return window_segments() * segment_minutes() / MIN_PER_DAY


def projection_matrix(ncoeff: int, n_nodes: int) -> np.ndarray:
    """(ncoeff, n_nodes) map from node values to monomial coefficients.

    Chebyshev analysis at the nodes x_k = cos(theta_k), theta_k = pi
    (2k+1) / (2 n_nodes) (a_j = (2/N) sum_k y_k cos(j theta_k), a_0
    halved), composed with the Chebyshev-to-monomial change of basis in
    x = dt / scale.
    """
    k = np.arange(n_nodes)
    theta = np.pi * (2 * k + 1) / (2 * n_nodes)
    D = (2.0 / n_nodes) * np.cos(np.outer(np.arange(ncoeff), theta))
    D[0] *= 0.5
    C2M = np.zeros((ncoeff, ncoeff))
    for j in range(ncoeff):
        e = np.zeros(j + 1)
        e[j] = 1.0
        C2M[: j + 1, j] = np.polynomial.chebyshev.cheb2poly(e)
    return C2M @ D


@dataclasses.dataclass
class ChebWindow:
    """One cache window's read artifact: per-segment polynomial
    coefficients as device tensors (``dev``: ``tmids``, ``coeffs`` (S, C),
    ``rphase_int``, ``rphase_frac``, ``f0``), with a host copy of the
    midpoints. ``event`` is recorded after the generation's kernels on
    the card (None on the CPU)."""

    mjd_start: float
    mjd_end: float
    span_min: float
    ncoeff: int
    obs: str
    freq_mhz: float
    tmids: np.ndarray
    dev: dict
    f0_ref: float
    nbytes: int
    event: object = None

    def ready(self) -> bool:
        """Has the generation finished on the device? Never blocks."""
        return self.event is None or self.event.query()

    def to_polycos(self, psrname: str = "PSR", dm: float = 0.0):
        """The window as a host :class:`~pint_tpu_torch.polycos.Polycos`
        (writable as a tempo polyco.dat)."""
        from pint_tpu_torch.polycos import Polycos

        return Polycos.from_arrays(
            self.tmids, self.dev["coeffs"].cpu().numpy(),
            self.dev["rphase_int"].cpu().numpy(),
            self.dev["rphase_frac"].cpu().numpy(), f0_ref=self.f0_ref,
            span_min=self.span_min, obs=self.obs, freq_mhz=self.freq_mhz,
            psrname=psrname, dm=dm)


def eligible(model) -> bool:
    """Can this model feed the engine? Absolute phase needs the TZR
    anchor, and the tempo format needs a spin frequency."""
    return model.has_component("AbsPhase") and "F0" in model.params


def generate_cheb_window(model, mjd_start: float, *, n_seg: int,
                         segment_length_min: float, ncoeff: int,
                         obs: str = "@", freq_mhz: float = 1400.0,
                         device=None) -> ChebWindow:
    """Generate one window's coefficients on ``device`` (``None``: the
    card), without a host sync: the node table is built on the host, and
    the phase evaluation and projection are launched on the device's
    current stream, whose tensors every later read of the window uses."""
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.fitting.device_loop import fingerprint_id
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    dev = resolve_device(device)
    tmids, mjd_nodes, dt_min, _tscale = segment_nodes(
        mjd_start, n_seg, segment_length_min, ncoeff)
    n_nodes = dt_min.shape[1]
    mjds = mjd_nodes.ravel()
    f64 = dict(dtype=torch.float64, device=dev)
    with telemetry.span("predict.generate", segments=n_seg):
        toas = build_TOAs_from_arrays(
            DD(mjds, np.zeros(mjds.size)),
            freq_mhz=np.full(mjds.size, float(freq_mhz)),
            error_us=np.full(mjds.size, 1.0), obs_names=(obs,),
            eph=model.ephem, device=dev)
        bucketing.note_program("predict_cheb", (fingerprint_id(model),),
                               (n_seg, n_nodes, ncoeff))
        ph = model.phase_fn_toas(abs_phase=True, device=dev)(
            model.base_dd(dev), {}, toas)
        pi = ph.int_part.reshape(n_seg, n_nodes + 1)
        hi = ph.frac.hi.reshape(n_seg, n_nodes + 1)
        lo = ph.frac.lo.reshape(n_seg, n_nodes + 1)
        # node - midpoint phase, part-wise (the host generator's rule)
        dphi = ((pi[:, 1:] - pi[:, :1]) + (hi[:, 1:] - hi[:, :1])
                + (lo[:, 1:] - lo[:, :1]))
        f0 = torch.tensor(model.f0_f64, **f64)
        y = dphi - torch.as_tensor(dt_min, **f64) * (60.0 * f0)
        P = torch.as_tensor(projection_matrix(ncoeff, n_nodes), **f64)
        # the analysis domain is exactly dt = scale * x, scale = span / 2
        scale = segment_length_min / 2.0
        powers = torch.arange(ncoeff, **f64)
        coeffs = (y @ P.T) / scale ** powers
        out = {"tmids": torch.as_tensor(tmids, **f64), "coeffs": coeffs,
               "rphase_int": pi[:, 0], "rphase_frac": hi[:, 0] + lo[:, 0],
               "f0": f0}
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
    telemetry.inc("serve.read.segment_builds")
    span_days = segment_length_min / MIN_PER_DAY
    return ChebWindow(
        mjd_start=float(mjd_start),
        mjd_end=float(mjd_start + n_seg * span_days),
        span_min=float(segment_length_min), ncoeff=int(ncoeff), obs=obs,
        freq_mhz=float(freq_mhz), tmids=tmids, dev=out,
        f0_ref=float(model.f0_f64),
        nbytes=8 * (n_seg * ncoeff + 3 * n_seg + 1), event=event)


def eval_cheb(tmids, coeffs, rp_int, rp_frac, f0, half_span_days, mjds):
    """Evaluate at query times ``mjds`` (device tensors): each query's
    nearest segment by ``searchsorted``, its coefficients gathered, one
    Horner pass for the polynomial and its derivative. Returns
    ``(phase_int, phase_frac in [0, 1), freq, in_span)``."""
    S = tmids.shape[0]
    C = coeffs.shape[1]
    if S > 1:
        idx = torch.clamp(torch.searchsorted(tmids, mjds), 1, S - 1)
        left = idx - 1
        idx = torch.where(torch.abs(mjds - tmids[left])
                          <= torch.abs(mjds - tmids[idx]), left, idx)
    else:
        idx = torch.zeros(mjds.shape, dtype=torch.int64, device=mjds.device)
    dt = (mjds - tmids[idx]) * MIN_PER_DAY
    c = coeffs[idx]
    poly = c[:, C - 1]
    for p in range(C - 2, -1, -1):
        poly = poly * dt + c[:, p]
    dpoly = c[:, C - 1] * (C - 1)
    for p in range(C - 2, 0, -1):
        dpoly = dpoly * dt + c[:, p] * p
    # the big linear term apart from the small pieces (the host
    # PolycoEntry.eval_abs_phase convention)
    big = dt * (60.0 * f0)
    big_i = torch.floor(big)
    small = rp_frac[idx] + poly + (big - big_i)
    carry = torch.floor(small)
    phase_int = rp_int[idx] + big_i + carry
    phase_frac = small - carry
    # small = -eps gives carry -1 and a fraction that rounds to 1.0
    wrap = phase_frac >= 1.0
    phase_int = phase_int + wrap
    phase_frac = torch.where(wrap, phase_frac - 1.0, phase_frac)
    freq = f0 + dpoly / 60.0
    in_span = torch.abs(mjds - tmids[idx]) <= half_span_days + 1e-9
    return phase_int, phase_frac, freq, in_span


def eval_window(window: ChebWindow, mjds: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate one window at query MJDs: ``(phase_int, phase_frac in
    [0, 1), freq_hz, in_span)`` as host arrays, on the window's device.

    The query axis pads to its pow-2 bucket (the padding repeats the
    first midpoint, always in span); the one copy of the stacked result
    to the host is the read's only sync.
    """
    mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
    n = mjds.size
    nb = bucketing.bucket_size(n)
    q = mjds if nb == n else np.concatenate(
        [mjds, np.full(nb - n, window.tmids[0])])
    dev = window.dev
    bucketing.note_program("predict_eval", None,
                           (len(window.tmids), window.ncoeff, nb))
    half_days = window.span_min / MIN_PER_DAY / 2.0
    pi, pf, fr, ok = eval_cheb(
        dev["tmids"], dev["coeffs"], dev["rphase_int"], dev["rphase_frac"],
        dev["f0"], half_days, torch.as_tensor(q, device=dev["f0"].device))
    out = torch.stack([pi, pf, fr, ok.to(torch.float64)]).cpu().numpy()
    return out[0, :n], out[1, :n], out[2, :n], out[3, :n] > 0.5
