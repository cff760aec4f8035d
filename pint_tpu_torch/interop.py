"""Carry a model state and a TOA table over from plain numpy arrays.

The reference package and this one exchange data only as numpy arrays,
so the tests can fit the very same table with both. Parameter values
travel as exact (hi, lo) float64 pairs and TOA columns as the table's
hi/lo words, so nothing is rounded on the way.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.toas import TOAs, build_TOAs_from_arrays


def state_from_numpy(params: dict, toa_columns: dict, *, model,
                     device=None) -> TOAs:
    """Set `model`'s parameters from `params` and build a TOAs table.

    ``params`` maps a parameter name to its value as an exact
    ``(hi, lo)`` pair of float64 (names the model lacks raise
    ``KeyError``). ``toa_columns`` holds ``"tdb.hi"``, ``"tdb.lo"``,
    ``"utc.hi"``, ``"utc.lo"``, ``"freq_mhz"``, ``"error_us"`` and
    optionally ``"flags"`` (per-TOA dicts), ``"phase_offset"`` and
    ``"obs_names"``/``"obs_index"``. The sites must be barycentric, where
    tdb and utc are one time; differing columns raise ``ValueError``.
    ``device=None`` means the CUDA card.
    """
    for name, (hi, lo) in params.items():
        model[name].value = (float(np.float64(hi)), float(np.float64(lo)))
    hi = np.asarray(toa_columns["utc.hi"], dtype=np.float64)
    lo = np.asarray(toa_columns["utc.lo"], dtype=np.float64)
    if not (np.array_equal(hi, np.asarray(toa_columns["tdb.hi"]))
            and np.array_equal(lo, np.asarray(toa_columns["tdb.lo"]))):
        raise ValueError("tdb and utc columns differ: only barycentric "
                         "tables (tdb = utc) can be carried over")
    return build_TOAs_from_arrays(
        DD(hi, lo),
        freq_mhz=np.asarray(toa_columns["freq_mhz"], dtype=np.float64),
        error_us=np.asarray(toa_columns["error_us"], dtype=np.float64),
        obs_index=toa_columns.get("obs_index"),
        obs_names=tuple(toa_columns.get("obs_names", ("@",))),
        flags=toa_columns.get("flags"),
        phase_offset=toa_columns.get("phase_offset"),
        device=device,
    )
