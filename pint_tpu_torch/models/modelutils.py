"""Astrometry frame conversion: equatorial <-> ecliptic models.

Counterpart of ``pint_tpu.models.modelutils``
(``model_equatorial_to_ecliptic``, ``model_ecliptic_to_equatorial``).
The rotation is the fixed IAU obliquity about the ICRS
x-axis (the same OBLIQUITY_RAD every ecliptic-frame component here
uses), applied to the position unit vector exactly and to the
proper-motion / positional-uncertainty 2-vectors via the local
tangent-plane rotation angle.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import OBLIQUITY_RAD
from pint_tpu_torch.models.timing_model import TimingModel


def _rot_x(eps: float) -> np.ndarray:
    c, s = np.cos(eps), np.sin(eps)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]])


def _unit(lon: float, lat: float) -> np.ndarray:
    cl = np.cos(lat)
    return np.array([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)])


def _lonlat(v: np.ndarray) -> tuple[float, float]:
    lon = float(np.arctan2(v[1], v[0])) % (2.0 * np.pi)
    return lon, float(np.arcsin(np.clip(v[2], -1.0, 1.0)))


def _tangent_basis(lon: float, lat: float) -> tuple[np.ndarray, np.ndarray]:
    """(east, north) unit vectors of the local tangent plane."""
    e = np.array([-np.sin(lon), np.cos(lon), 0.0])
    n = np.array([-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon),
                  np.cos(lat)])
    return e, n


def _convert(model: TimingModel, *, to_ecliptic: bool) -> TimingModel:
    from pint_tpu_torch.models.astrometry import (AstrometryEcliptic,
                                                  AstrometryEquatorial)

    src_cls, dst_cls = ((AstrometryEquatorial, AstrometryEcliptic)
                        if to_ecliptic
                        else (AstrometryEcliptic, AstrometryEquatorial))
    src = model.get_component(src_cls.__name__)
    if src is None:
        have = model.get_component(dst_cls.__name__)
        if have is not None:
            return model  # already in the target frame
        raise ValueError("model has no astrometry component")
    lon_n, lat_n, pme_n, pmn_n = (("RAJ", "DECJ", "PMRA", "PMDEC")
                                  if to_ecliptic
                                  else ("ELONG", "ELAT", "PMELONG", "PMELAT"))
    dlon_n, dlat_n, dpme_n, dpmn_n = (("ELONG", "ELAT", "PMELONG", "PMELAT")
                                      if to_ecliptic
                                      else ("RAJ", "DECJ", "PMRA", "PMDEC"))
    R = _rot_x(OBLIQUITY_RAD if to_ecliptic else -OBLIQUITY_RAD)

    lon = src.param(lon_n).value_f64
    lat = src.param(lat_n).value_f64
    v = R @ _unit(lon, lat)
    lon2, lat2 = _lonlat(v)

    # tangent-plane rotation: source (east, north) expressed in the
    # destination basis — rotates PM vectors and 2x2 uncertainties
    e1, n1 = _tangent_basis(lon, lat)
    e2, n2 = _tangent_basis(lon2, lat2)
    e1r, n1r = R @ e1, R @ n1
    Q = np.array([[e2 @ e1r, e2 @ n1r], [n2 @ e1r, n2 @ n1r]])

    pm = Q @ np.array([src.param(pme_n).value_f64,
                       src.param(pmn_n).value_f64])

    dst = dst_cls()
    dst.param(dlon_n).value = (lon2, 0.0)
    dst.param(dlat_n).value = (lat2, 0.0)
    dst.param(dpme_n).value = (float(pm[0]), 0.0)
    dst.param(dpmn_n).value = (float(pm[1]), 0.0)
    for name in ("PX", "POSEPOCH"):
        dst.param(name).value = src.param(name).value
        dst.param(name).uncertainty = src.param(name).uncertainty
        dst.param(name).frozen = src.param(name).frozen
    for s_name, d_name in ((lon_n, dlon_n), (lat_n, dlat_n),
                           (pme_n, dpme_n), (pmn_n, dpmn_n)):
        dst.param(d_name).frozen = src.param(s_name).frozen
    # rotate angular uncertainties through the same tangent-plane map
    # (all angle uncertainties are stored in radians internally; the
    # longitude sigma scales by cos(lat) into arc units and back)
    slon = src.param(lon_n).uncertainty or 0.0
    slat = src.param(lat_n).uncertainty or 0.0
    if slon or slat:
        sig = np.abs(Q) @ np.array([abs(slon) * np.cos(lat), abs(slat)])
        dst.param(dlon_n).uncertainty = float(sig[0] / max(np.cos(lat2),
                                                           1e-12))
        dst.param(dlat_n).uncertainty = float(sig[1])
    spm_e = src.param(pme_n).uncertainty or 0.0
    spm_n = src.param(pmn_n).uncertainty or 0.0
    if spm_e or spm_n:
        spm = np.abs(Q) @ np.array([spm_e, spm_n])
        dst.param(dpme_n).uncertainty = float(spm[0])
        dst.param(dpmn_n).uncertainty = float(spm[1])

    comps = [dst if c is src else c for c in model.components]
    out = TimingModel(comps, name=model.name, header=dict(model.header))
    out.validate()
    return out


def model_equatorial_to_ecliptic(model: TimingModel) -> TimingModel:
    """RAJ/DECJ/PMRA/PMDEC -> ELONG/ELAT/PMELONG/PMELAT (new model)."""
    return _convert(model, to_ecliptic=True)


def model_ecliptic_to_equatorial(model: TimingModel) -> TimingModel:
    """ELONG/ELAT/PMELONG/PMELAT -> RAJ/DECJ/PMRA/PMDEC (new model)."""
    return _convert(model, to_ecliptic=False)
