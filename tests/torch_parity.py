"""Shared inputs of the parity tests between pint_tpu and pint_tpu_torch.

Both packages get the same numbers: the reference simulates a table
(JAX on the CPU), and its parameter values and TOA columns travel to the
port as numpy arrays through ``pint_tpu_torch.interop.state_from_numpy``.
"""

import contextlib
import pathlib
import re

import numpy as np
import pytest
import torch

# The bench par, verbatim (bench.py PAR): equatorial astrometry with RAJ
# and DECJ fitted, EPHEM DE421 (the analytic fallback on both sides),
# TZRSITE 1 (GBT); its TOAs are observed at GBT.
PAR_FULL = """
PSRJ           J1748-2021E
RAJ             17:48:52.75  1
DECJ           -20:21:29.0  1
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
EFAC 1.1
ECORR 1.2
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 30
"""
REPO = pathlib.Path(__file__).resolve().parents[1]
BENCH_PY = REPO / "bench.py"

# torch's intra-op pool, and MKL's with it, as a process of its own sizes
# them on an 8-core host. The suite runs each worker on one thread (the
# root conftest.py); a test that compares one thread with a pool, or
# whose bars were measured at MKL's summation order on this pool, sets
# it for its block.
POOL_THREADS = 8


@contextlib.contextmanager
def pool_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(POOL_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


# The bench par (bench.py PAR) with barycentric TOAs: no RAJ/DECJ/
# POSEPOCH/EPHEM, TZRSITE @.
PAR_BARY = """
PSRJ           J1748-2021E
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
DM              223.9  1
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE @
EFAC 1.1
ECORR 1.2
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 30
"""


def epoch_mjds(n: int, rng) -> np.ndarray:
    """n MJDs in 4-TOA epochs within 0.5 s, MJD 50000-58000 (the bench's)."""
    n_ep = max(1, (n + 3) // 4)
    centers = np.sort(rng.uniform(50000.0, 58000.0, size=n_ep))
    return (centers[:, None]
            + rng.uniform(0, 0.5 / 86400.0, (n_ep, 4))).ravel()[:n]


# The reference's own fitter cases. tests/test_fit_wls.py's PAR: the
# bench par without noise, RAJ/DECJ/F0/F1/DM fitted.
PAR_WLS = """
PSRJ           J1748-2021E
RAJ             17:48:52.75  1
DECJ           -20:21:29.0  1
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
"""
# tests/test_noise_gls.py's BASE_PAR (DM frozen) and its noise lines
PAR_NOISE_BASE = PAR_WLS.replace("DM              223.9  1",
                                 "DM              223.9")
NOISE_LINES = "EFAC -f fake 1.5\nEQUAD -f fake 0.8\n"
ECORR_LINES = "ECORR -f fake 1.2\n"
RED_LINES = "TNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 12\n"
# tests/test_utils_matrix.py's PAR: RAJ/DECJ frozen
PAR_MATRIX = PAR_WLS.replace("17:48:52.75  1", "17:48:52.75").replace(
    "-20:21:29.0  1", "-20:21:29.0")

# par text -> the site its TOAs are observed at
SITES = {PAR_FULL: "gbt", PAR_BARY: "@"}


def simulate_reference(n: int, seed: int = 0, par: str = PAR_BARY,
                       site: str | None = None):
    """(model, toas) of the reference: n TOAs simulated from `par` with
    1 us white noise at 1400/430 MHz, at `site`, by default GBT for
    PAR_FULL and the barycenter for other pars."""
    from pint_tpu.models import get_model
    from pint_tpu.ops.dd import DD
    from pint_tpu.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    model = get_model(par)
    mjds = epoch_mjds(n, rng)
    toas = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), model,
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs=site or SITES.get(par, "@"), add_noise=True,
        seed=int(rng.integers(2 ** 31)), niter=2)
    return model, toas


def params_of(model) -> dict:
    """The reference model's numeric parameter values as (hi, lo) pairs."""
    return {k: (p.hi, p.lo) for k, p in model.params.items() if p.is_numeric}


def columns_of(toas) -> dict:
    """The reference table's columns as numpy arrays."""
    return {
        "tdb.hi": np.asarray(toas.tdb.hi), "tdb.lo": np.asarray(toas.tdb.lo),
        "utc.hi": np.asarray(toas.utc.hi), "utc.lo": np.asarray(toas.utc.lo),
        "freq_mhz": np.asarray(toas.freq_mhz),
        "error_us": np.asarray(toas.error_us),
        "obs_pos_ls": np.asarray(toas.obs_pos_ls),
        "obs_vel_c": np.asarray(toas.obs_vel_c),
        "planet_pos_ls": {k: np.asarray(v) for k, v in toas.planet_pos_ls.items()},
        "phase_offset": np.asarray(toas.phase_offset),
        "pulse_number": np.asarray(toas.pulse_number),
        "flags": toas.flags, "obs_names": toas.obs_names,
        "obs_index": np.asarray(toas.obs_index),
        "jump_group": np.asarray(toas.jump_group),
        "ephem_name": toas.ephem_name, "clock_applied": toas.clock_applied,
    }


def port_state(ref_model, ref_toas, device="cpu", par: str = PAR_BARY):
    """(model, toas) of the port carrying the reference's exact state."""
    from pint_tpu_torch.interop import state_from_numpy
    from pint_tpu_torch.models import get_model

    model = get_model(par)
    toas = state_from_numpy(params_of(ref_model), columns_of(ref_toas),
                            model=model, device=device)
    return model, toas


@pytest.fixture
def cuda_device():
    """The CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def with_flag(toas, flag="f", value="fake"):
    """The reference table with one tim-file flag added to every TOA (as
    tests/test_noise_gls.py::_with_flag does)."""
    import dataclasses

    from pint_tpu.toas import Flags

    return dataclasses.replace(
        toas, flags=Flags(dict(d, **{flag: value}) for d in toas.flags))


def _as_number(token: str):
    """A par/summary token as a float (sexagesimal d:m:s as seconds), or
    None; and the number of digits after its decimal point."""
    t = token.replace("D", "E")
    parts = t.split(":")
    try:
        if len(parts) == 3:
            sign = -1.0 if parts[0].startswith("-") else 1.0
            v = sign * (abs(float(parts[0])) * 3600.0 + float(parts[1]) * 60.0
                        + float(parts[2]))
        else:
            v = float(t)
    except ValueError:
        return None, 0
    mantissa = parts[-1].split("E")[0]
    decimals = len(mantissa.split(".")[1]) if "." in mantissa else 0
    exp = int(t.split("E")[1]) if "E" in t else 0
    return v, 10.0 ** (exp - decimals)


# a number (sexagesimal d:m:s too, exponent D or E) or any other character
_TOKEN = re.compile(r"[-+]?(?:\d+:\d+:)?\d*\.?\d+(?:[eEdD][-+]?\d+)?|\S")


def assert_text_close(a: str, b: str, rtol: float) -> None:
    """Two reports agree line by line and token by token: words equal, or
    numbers within `rtol` relative or one unit of their last printed digit
    (a last-digit rounding flip)."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), (len(la), len(lb))
    for x, y in zip(la, lb):
        tx, ty = _TOKEN.findall(x), _TOKEN.findall(y)
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            if u == v:
                continue
            (nu, du), (nv, dv) = _as_number(u), _as_number(v)
            assert nu is not None and nv is not None, (x, y)
            assert abs(nu - nv) <= rtol * max(abs(nu), abs(nv)) + 1.01 * max(du, dv), (x, y)


def gbt_reference_table(n: int, seed: int = 0, mjd_range=(54000.0, 56000.0)):
    """n GBT TOAs built (not simulated) by the reference at two receivers:
    half at Rcvr_800 (730-910 MHz), half at Rcvr1_2 (1150-1650 MHz), the
    receiver in each TOA's ``-fe`` flag."""
    from pint_tpu.ops.dd import DD
    from pint_tpu.toas import build_TOAs_from_arrays

    rng = np.random.default_rng(seed)
    mjd = np.sort(rng.uniform(*mjd_range, n))
    low = rng.random(n) < 0.5
    freq = np.where(low, rng.uniform(730.0, 910.0, n),
                    rng.uniform(1150.0, 1650.0, n))
    flags = tuple({"fe": "Rcvr_800" if lo else "Rcvr1_2"} for lo in low)
    return build_TOAs_from_arrays(DD(mjd, np.zeros(n)), freq_mhz=freq,
                                  error_us=np.ones(n), obs_names=("gbt",),
                                  flags=flags, eph="DE421")


def carried(par: str, ref_toas, device="cpu"):
    """(reference model, port model, port table): both models built from
    `par`, the port's table carrying the reference's columns."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu_torch.interop import state_from_numpy
    from pint_tpu_torch.models import get_model

    ref_model, model = jget_model(par), get_model(par)
    toas = state_from_numpy(params_of(ref_model), columns_of(ref_toas),
                            model=model, device=device)
    return ref_model, model, toas


def component_parity(ref_model, ref_toas, model, toas, name: str):
    """The delay (or phase, or DM) of component `name` in both packages at
    the same parameters, and its derivatives in the component's free
    parameters: (reference value, port value, {param: (ref col, port
    col)}). A delay component sees the delays of the components before it
    (the reference's accumulated delay, given to both); the derivatives
    are jacfwd's, the reference's run op by op (``jax.disable_jit``)."""
    import jax
    import jax.numpy as jnp

    jp, p = ref_model.base_dd(), model.base_dd(toas.device)
    jc, c = ref_model.get_component(name), model.get_component(name)
    acc, aux = jnp.zeros(len(ref_toas)), {}
    with jax.disable_jit():
        # the delays before a delay component; all of them for a phase one
        for other in ref_model.delay_components() if c.is_delay or c.is_phase else ():
            if type(other).__name__ == name:
                break
            acc = acc + other.delay(jp, ref_toas, acc, aux)
        tacc = torch.as_tensor(np.array(acc), device=toas.device)
        taux = {k: torch.as_tensor(np.array(v), device=toas.device)
                for k, v in aux.items()}

        def ref_fn(d):
            q = ref_model.resolve(jp, d)
            if c.is_delay:
                return jc.delay(q, ref_toas, acc, dict(aux))
            if c.is_phase:
                ph = jc.phase(q, ref_toas, acc, dict(aux))
                return ph.int_part + (ph.frac.hi + ph.frac.lo)
            return jc.dm_value(q, ref_toas)

        def fn(d):
            q = model.resolve(p, d)
            if c.is_delay:
                return c.delay(q, toas, tacc, dict(taux))
            if c.is_phase:
                ph = c.phase(q, toas, tacc, dict(taux))
                return ph.int_part + (ph.frac.hi + ph.frac.lo)
            return c.dm_value(q, toas)

        names = [q.name for q in c.params if not q.frozen and q.fittable]
        J_ref = jax.jacfwd(ref_fn)({k: jnp.zeros(()) for k in names}) if names else {}
        ref_value = np.asarray(ref_fn({}))
    J = torch.func.jacfwd(fn)(model.zero_deltas(names, toas.device)) if names else {}
    cols = {k: (np.asarray(J_ref[k]), J[k].cpu().numpy()) for k in names}
    return ref_value, fn({}).cpu().numpy(), cols


def assert_columns_close(cols, rtol=1e-10, zero=()):
    """Each column within `rtol` of its largest reference entry; the
    columns named in `zero` are zero in both."""
    for k, (a, b) in cols.items():
        scale = np.max(np.abs(a))
        if k in zero:
            assert scale == 0.0 and not np.any(b), k
            continue
        assert scale > 0.0, f"{k}: the reference's column is zero"
        gap = np.max(np.abs(a - b)) / scale
        print(f"  d/d{k}: {gap:.3e} of max|column|")
        assert gap <= rtol, k


# ----------------------------------------------------------------------
# the serving tier's parity cases (tests/test_torch_serve.py and the
# session, faults and predict files)
# ----------------------------------------------------------------------

# PAR_BARY without noise: F0, F1 and DM fitted, a TZR anchor
PAR_SERVE = "\n".join(line for line in PAR_BARY.splitlines()
                      if not line.startswith(("EFAC", "ECORR", "TNRED"))
                      ) + "\n"
# PAR_SERVE with the noise lines of tests/test_serve.py (the TOAs flagged
# -f fake)
SERVE_NOISE = """
EFAC -f fake 1.2
ECORR -f fake 1.1
"""


def serve_table(n: int, seed: int, par: str = PAR_SERVE, flag: bool = False):
    """(reference table, port table) of n simulated barycentric TOAs, the
    port's carrying the reference's columns (``flag``: every TOA flagged
    ``-f fake``)."""
    from pint_tpu_torch.interop import state_from_numpy
    from pint_tpu_torch.models import get_model

    jm, jt = simulate_reference(n, seed=seed, par=par)
    if flag:
        jt = with_flag(jt)
    return jt, state_from_numpy(params_of(jm), columns_of(jt),
                                model=get_model(par), device="cpu")


def serve_models(par: str = PAR_SERVE, pert_f0: float = 2e-10):
    """(reference model, port model) from `par`, F0 moved by `pert_f0`."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu_torch.models import get_model

    jm, m = jget_model(par), get_model(par)
    jm["F0"].add_delta(pert_f0)
    m["F0"].add_delta(pert_f0)
    return jm, m
