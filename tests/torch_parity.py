"""Shared inputs of the parity tests between pint_tpu and pint_tpu_torch.

Both packages get the same numbers: the reference simulates a table
(JAX on the CPU), and its parameter values and TOA columns travel to the
port as numpy arrays through ``pint_tpu_torch.interop.state_from_numpy``.
"""

import numpy as np
import pytest
import torch

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


def simulate_reference(n: int, seed: int = 0):
    """(model, toas) of the reference: n barycentric TOAs simulated from
    PAR_BARY with 1 us white noise at 1400/430 MHz."""
    from pint_tpu.models import get_model
    from pint_tpu.ops.dd import DD
    from pint_tpu.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    model = get_model(PAR_BARY)
    mjds = epoch_mjds(n, rng)
    toas = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), model,
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
        error_us=1.0, obs="@", add_noise=True,
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
        "flags": toas.flags, "obs_names": toas.obs_names,
        "obs_index": np.asarray(toas.obs_index),
    }


def port_state(ref_model, ref_toas, device="cpu"):
    """(model, toas) of the port carrying the reference's exact state."""
    from pint_tpu_torch.interop import state_from_numpy
    from pint_tpu_torch.models import get_model

    model = get_model(PAR_BARY)
    toas = state_from_numpy(params_of(ref_model), columns_of(ref_toas),
                            model=model, device=device)
    return model, toas


@pytest.fixture
def cuda_device():
    """The CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
