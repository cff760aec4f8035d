"""Carry a model state and a TOA table over from plain numpy arrays.

The reference package and this one exchange data only as numpy arrays,
so the tests can fit the very same table with both. Parameter values
travel as exact (hi, lo) float64 pairs and TOA columns as the table's
hi/lo words and float64 arrays, so nothing is rounded on the way.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.toas import Flags, TOAs


def state_from_numpy(params: dict, toa_columns: dict, *, model,
                     device=None) -> TOAs:
    """Set `model`'s parameters from `params` and build a TOAs table.

    ``params`` maps a parameter name to its value as an exact
    ``(hi, lo)`` pair of float64 (names the model lacks raise
    ``KeyError``). ``toa_columns`` holds ``"tdb.hi"``, ``"tdb.lo"``,
    ``"utc.hi"``, ``"utc.lo"``, ``"freq_mhz"``, ``"error_us"``,
    ``"obs_pos_ls"`` and ``"obs_vel_c"`` (n, 3), ``"planet_pos_ls"``
    (name -> (n, 3)), and optionally ``"flags"`` (per-TOA dicts),
    ``"phase_offset"``, ``"pulse_number"``, ``"obs_names"``/``"obs_index"``,
    ``"jump_group"``, ``"ephem_name"`` and ``"clock_applied"``; the
    wideband DM columns ``"dm_values"``/``"dm_errors"`` (written into
    each TOA's ``-pp_dm``/``-pp_dme`` flag as the shortest exact
    decimal) and ``"aux_columns"`` (name -> (n,) array, e.g. the photon
    weights ``"photon_weight"``). The columns are taken as they are:
    nothing is recomputed. Mask parameters (DMEFAC, DMEQUAD, DMJUMP)
    travel in ``params`` like any other; their selectors are the par
    file's. ``device=None`` means the CUDA card.
    """
    for name, (hi, lo) in params.items():
        model[name].value = (float(np.float64(hi)), float(np.float64(lo)))
    dev = resolve_device(device)

    def col(key):
        return torch.as_tensor(np.array(toa_columns[key], dtype=np.float64),
                               device=dev)

    n = int(np.shape(toa_columns["tdb.hi"])[0])
    flags = [dict(f) for f in (toa_columns.get("flags") or ({} for _ in range(n)))]
    for key, flag in (("dm_values", "pp_dm"), ("dm_errors", "pp_dme")):
        if toa_columns.get(key) is not None:
            for f, v in zip(flags, np.asarray(toa_columns[key], np.float64)):
                f[flag] = repr(float(v))
    flags = Flags(flags)
    pulse_number = toa_columns.get("pulse_number")
    if pulse_number is None:
        pulse_number = [float(f.get("pn", "nan")) for f in flags]
    return TOAs(
        tdb=DD(col("tdb.hi"), col("tdb.lo")),
        utc=DD(col("utc.hi"), col("utc.lo")),
        freq_mhz=col("freq_mhz"),
        error_us=col("error_us"),
        obs_pos_ls=col("obs_pos_ls"),
        obs_vel_c=col("obs_vel_c"),
        phase_offset=torch.as_tensor(
            np.array(toa_columns.get("phase_offset", np.zeros(n)), np.float64),
            device=dev),
        planet_pos_ls={k: torch.as_tensor(np.array(v, np.float64), device=dev)
                       for k, v in toa_columns["planet_pos_ls"].items()},
        pulse_number=torch.as_tensor(np.array(pulse_number, np.float64),
                                     device=dev),
        obs_index=np.asarray(toa_columns.get("obs_index", np.zeros(n)), np.int32),
        jump_group=np.asarray(toa_columns.get("jump_group", np.zeros(n)), np.int32),
        obs_names=tuple(toa_columns.get("obs_names", ("@",))),
        flags=flags,
        ephem_name=str(toa_columns.get("ephem_name", "builtin_analytic")),
        clock_applied=bool(toa_columns.get("clock_applied", True)),
        aux_columns={k: torch.as_tensor(np.array(v, np.float64), device=dev)
                     for k, v in (toa_columns.get("aux_columns") or {}).items()},
    )


def problems_from_numpy(problems, *, device=None) -> list:
    """The port's ``(toas, model)`` list of a PTA problem set carried
    over as numpy data: each entry of ``problems`` is ``(par, params,
    toa_columns)``, the pulsar's par text, its parameter values as
    :func:`state_from_numpy` takes them and its TOA columns. Each model
    is built from its par text and set to those values; each table holds
    the columns as they are. ``device=None`` means the CUDA card."""
    from pint_tpu_torch.models import get_model

    out = []
    for par, params, columns in problems:
        model = get_model(par)
        toas = state_from_numpy(params, columns, model=model, device=device)
        out.append((toas, model))
    return out
