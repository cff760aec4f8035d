"""Binary-model conversion: ELL1-family <-> DD parameterizations.

Counterpart of ``pint_tpu.models.binaryconvert.convert_binary``, which
re-expresses an orbit in another model family. The closed-form maps:

    ECC = sqrt(EPS1^2 + EPS2^2)     OM = atan2(EPS1, EPS2)
    T0  = TASC + PB * OM / (2 pi)

and their inverses; first-derivative parameters (EPS1DOT/EPS2DOT <->
EDOT/OMDOT) and 1-sigma uncertainties transform through the exact
Jacobians. Variant Shapiro parameterizations map to (M2, SINI):
orthometric H3/H4/STIG via Freire & Wex 2010, DDS SHAPMAX via
SINI = 1 - exp(-SHAPMAX). Parameters shared by both families (PB/FB*,
A1, XDOT, M2, SINI, PBDOT, ...) are copied by name; anything set that
cannot be represented raises instead of vanishing.
"""

from __future__ import annotations

import logging

import numpy as np

from pint_tpu_torch.constants import SEC_PER_JULIAN_YEAR, SECS_PER_DAY, T_SUN_S
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.ops import dd as ddm

log = logging.getLogger(__name__)

# parameters consumed by the closed-form maps (not "dropped")
_TRANSFORMED = {"EPS1", "EPS2", "TASC", "EPS1DOT", "EPS2DOT",
                "ECC", "OM", "T0", "EDOT", "OMDOT", "FB0",
                "H3", "H4", "STIG", "SHAPMAX"}


def _apply_shapiro_map(src, dst) -> None:
    """Variant Shapiro parameterization -> (M2, SINI) with sigmas.

    Orthometric (ELL1H/DDH, Freire & Wex 2010): with stig = STIG (or
    H4/H3), sin i = 2 stig/(1+stig^2) and T_sun M2 = H3/stig^3.
    DDS: SINI = 1 - exp(-SHAPMAX). Uncertainties propagate through the
    exact partials; free/frozen state follows the source parameters.
    """
    def _used(prm):
        return bool(prm.value_f64 or prm.uncertainty or not prm.frozen)

    if src.has_param("SHAPMAX") and _used(src.param("SHAPMAX")):
        # DDS: only SINI is reparameterized; M2 is shared and copies over
        sm = src.param("SHAPMAX")
        sini = 1.0 - float(np.exp(-sm.value_f64))
        q = dst.param("SINI")
        q.value = (sini, 0.0)
        q.uncertainty = float(np.exp(-sm.value_f64) * (sm.uncertainty or 0))
        q.frozen = sm.frozen
        log.info("mapped SHAPMAX to SINI=%.6g", sini)
        return
    if not (src.has_param("H3") and _used(src.param("H3"))):
        return
    h3p = src.param("H3")
    h3, sh3 = h3p.value_f64, h3p.uncertainty or 0.0
    if src.has_param("STIG") and src.param("STIG").value_f64:
        sp = src.param("STIG")
        stig, sstig = sp.value_f64, sp.uncertainty or 0.0
        stig_frozen = sp.frozen
        sm2_rel = np.hypot(sh3 / h3, 3.0 * sstig / stig)
    elif src.has_param("H4") and src.param("H4").value_f64:
        h4p = src.param("H4")
        h4, sh4 = h4p.value_f64, h4p.uncertainty or 0.0
        stig = h4 / h3
        sstig = abs(stig) * np.hypot(sh4 / h4, sh3 / h3)
        stig_frozen = h4p.frozen
        # M2 = H3^4 / (T_sun H4^3)
        sm2_rel = np.hypot(4.0 * sh3 / h3, 3.0 * sh4 / h4)
    else:
        return
    sini = 2.0 * stig / (1.0 + stig ** 2)
    m2 = h3 / stig ** 3 / T_SUN_S
    q = dst.param("SINI")
    q.value = (float(sini), 0.0)
    q.uncertainty = float(abs(2.0 * (1.0 - stig ** 2)
                              / (1.0 + stig ** 2) ** 2) * sstig)
    q.frozen = stig_frozen
    q = dst.param("M2")
    q.value = (float(m2), 0.0)
    q.uncertainty = float(abs(m2) * sm2_rel)
    q.frozen = h3p.frozen and stig_frozen
    log.info("mapped orthometric Shapiro to M2=%.6g Msun, SINI=%.6g",
             m2, sini)


# consumed by the Shapiro map / FB0->PB fill alone (the within-family
# paths convert nothing else, so e.g. ELL1k's OMDOT must raise there)
_SHAPIRO_CONSUMED = {"H3", "H4", "STIG", "SHAPMAX", "FB0"}


def _copy_shared(src, dst, consumed: set = _TRANSFORMED) -> None:
    """Copy same-named params; refuse to silently drop used variant params.

    Variant-specific physics (GAMMA, LNEDOT, ELL1k's OMDOT, ...) with no
    representation on the target — set, carrying an uncertainty, or left
    free for fitting — would silently change the predicted TOAs or the
    fit, so that is an error (converting such models requires zeroing or refitting them
    explicitly).
    """
    dst_names = {p.name for p in dst.params}
    dropped = []
    for p in src.params:
        if p.name in dst_names:
            q = dst.param(p.name)
            q.value = p.value
            q.uncertainty = p.uncertainty
            q.frozen = p.frozen
        elif (p.name not in consumed and p.is_numeric
              and (p.value_f64 != 0.0 or p.uncertainty or not p.frozen)):
            dropped.append(p.name)
    if dropped:
        raise ValueError(
            f"conversion {type(src).__name__} -> {type(dst).__name__} "
            f"would silently drop set/free parameters {dropped}; convert "
            "from the base ELL1/DD parameterization instead")


def convert_binary(model: TimingModel, target: str) -> TimingModel:
    """New TimingModel with the binary re-expressed as ``target``.

    ``target``: "DD" or "ELL1". Conversion is exact in the orbital
    parameters; note the two families' *physics* differ at O(ECC^2)
    (ELL1 truncates), so residuals agree only for small eccentricity.
    """
    from pint_tpu_torch.models.binary.dd import BinaryDD
    from pint_tpu_torch.models.binary.ell1 import BinaryELL1

    target = target.upper()
    if target not in ("DD", "ELL1"):
        raise ValueError(f"convert_binary target {target!r}: DD or ELL1")
    src = next((c for c in model.components
                if getattr(c, "binary_model_name", None)), None)
    if src is None:
        raise ValueError("model has no binary component")
    if src.binary_model_name == target:
        return model

    pb_d = src.param("PB").value_f64
    fb_source = False
    if pb_d <= 0 and src.has_param("FB0") and src.param("FB0").value_f64:
        pb_d = 1.0 / (src.param("FB0").value_f64 * SECS_PER_DAY)
        fb_source = True

    src_is_ell1 = src.has_param("EPS1")

    if target == "DD" and not src_is_ell1:
        # within-family (DDS/DDH/BT/... -> DD): the orbit is already in
        # ECC/OM/T0 form; only the Shapiro parameterization changes
        dst = BinaryDD()
        _copy_shared(src, dst, consumed=_SHAPIRO_CONSUMED)
        _apply_shapiro_map(src, dst)
        return _finish(model, src, dst, "DD", fb_source, pb_d)
    if target == "ELL1" and src_is_ell1:
        # within-family (ELL1H/ELL1k -> ELL1)
        dst = BinaryELL1()
        _copy_shared(src, dst, consumed=_SHAPIRO_CONSUMED)
        _apply_shapiro_map(src, dst)
        return _finish(model, src, dst, "ELL1", fb_source, pb_d)

    if target == "DD":
        e1 = src.param("EPS1").value_f64
        e2 = src.param("EPS2").value_f64
        s1 = src.param("EPS1").uncertainty or 0.0
        s2 = src.param("EPS2").uncertainty or 0.0
        ecc = float(np.hypot(e1, e2))
        om_rad = float(np.arctan2(e1, e2)) % (2.0 * np.pi)
        dst = BinaryDD()
        _copy_shared(src, dst)
        _apply_shapiro_map(src, dst)
        dst.param("ECC").value = (ecc, 0.0)
        dst.param("OM").value = (float(np.degrees(om_rad)), 0.0)
        # T0 = TASC + PB * om / 2pi, exact in DD (TASC is a DD MJD)
        tasc = src.param("TASC").as_dd()
        t0 = ddm.add(tasc, pb_d * om_rad / (2.0 * np.pi))
        dst.param("T0").value = (float(t0.hi), float(t0.lo))
        if ecc > 0:
            dst.param("ECC").uncertainty = float(
                np.hypot(e1 * s1, e2 * s2) / ecc)
            som = float(np.hypot(e2 * s1, e1 * s2) / ecc ** 2)  # rad
            dst.param("OM").uncertainty = float(np.degrees(som))
            stasc = src.param("TASC").uncertainty or 0.0
            dst.param("T0").uncertainty = float(
                np.hypot(stasc, pb_d * som / (2.0 * np.pi)))
        for n_src, n_dst in (("EPS1", "ECC"), ("EPS2", "OM"),
                             ("TASC", "T0")):
            dst.param(n_dst).frozen = src.param(n_src).frozen
        if src.has_param("EPS1DOT"):
            p1, p2 = src.param("EPS1DOT"), src.param("EPS2DOT")
            d1, d2 = p1.value_f64, p2.value_f64
            sd1, sd2 = p1.uncertainty or 0.0, p2.uncertainty or 0.0
            used = (d1 or d2 or sd1 or sd2
                    or not p1.frozen or not p2.frozen)
            if used and ecc == 0:
                raise ValueError(
                    "EPS1DOT/EPS2DOT are set/free but ECC = 0: the "
                    "EDOT/OMDOT decomposition is undefined at zero "
                    "eccentricity")
            if used:
                dst.param("EDOT").value = (
                    float((e1 * d1 + e2 * d2) / ecc), 0.0)
                omdot_rad_s = (d1 * e2 - d2 * e1) / ecc ** 2
                dst.param("OMDOT").value = (
                    float(np.degrees(omdot_rad_s) * SEC_PER_JULIAN_YEAR),
                    0.0)
                dst.param("EDOT").uncertainty = float(
                    np.hypot(e1 * sd1, e2 * sd2) / ecc)
                dst.param("OMDOT").uncertainty = float(np.degrees(
                    np.hypot(e2 * sd1, e1 * sd2) / ecc ** 2)
                    * SEC_PER_JULIAN_YEAR)
                dst.param("EDOT").frozen = p1.frozen
                dst.param("OMDOT").frozen = p2.frozen
        new_binary = "DD"
    else:
        ecc = src.param("ECC").value_f64
        om_deg = src.param("OM").value_f64
        om_rad = np.radians(om_deg) % (2.0 * np.pi)
        if ecc > 0.01:
            log.warning(
                "converting ECC=%.3g to ELL1: the small-eccentricity "
                "model drops O(e^2) terms (use utils.ELL1_check)", ecc)
        dst = BinaryELL1()
        _copy_shared(src, dst)
        _apply_shapiro_map(src, dst)
        dst.param("EPS1").value = (float(ecc * np.sin(om_rad)), 0.0)
        dst.param("EPS2").value = (float(ecc * np.cos(om_rad)), 0.0)
        t0 = src.param("T0").as_dd()
        tasc = ddm.sub(t0, pb_d * om_rad / (2.0 * np.pi))
        dst.param("TASC").value = (float(tasc.hi), float(tasc.lo))
        secc = src.param("ECC").uncertainty or 0.0
        som_rad = np.radians(src.param("OM").uncertainty or 0.0)
        if secc or som_rad:
            dst.param("EPS1").uncertainty = float(np.hypot(
                np.sin(om_rad) * secc, ecc * np.cos(om_rad) * som_rad))
            dst.param("EPS2").uncertainty = float(np.hypot(
                np.cos(om_rad) * secc, ecc * np.sin(om_rad) * som_rad))
        st0 = src.param("T0").uncertainty or 0.0
        if st0 or som_rad:
            dst.param("TASC").uncertainty = float(np.hypot(
                st0, pb_d * som_rad / (2.0 * np.pi)))
        for n_src, n_dst in (("ECC", "EPS1"), ("OM", "EPS2"),
                             ("T0", "TASC")):
            dst.param(n_dst).frozen = src.param(n_src).frozen
        if src.has_param("EDOT") and src.has_param("OMDOT"):
            pe, po = src.param("EDOT"), src.param("OMDOT")
            edot, omdot = pe.value_f64, po.value_f64
            se = pe.uncertainty or 0.0
            so = np.radians(po.uncertainty or 0.0) / SEC_PER_JULIAN_YEAR
            used = (edot or omdot or se or so
                    or not pe.frozen or not po.frozen)
            if used:
                omdot_rad_s = np.radians(omdot) / SEC_PER_JULIAN_YEAR
                dst.param("EPS1DOT").value = (
                    float(edot * np.sin(om_rad)
                          + ecc * np.cos(om_rad) * omdot_rad_s), 0.0)
                dst.param("EPS2DOT").value = (
                    float(edot * np.cos(om_rad)
                          - ecc * np.sin(om_rad) * omdot_rad_s), 0.0)
                dst.param("EPS1DOT").uncertainty = float(np.hypot(
                    np.sin(om_rad) * se, ecc * np.cos(om_rad) * so))
                dst.param("EPS2DOT").uncertainty = float(np.hypot(
                    np.cos(om_rad) * se, ecc * np.sin(om_rad) * so))
                dst.param("EPS1DOT").frozen = pe.frozen
                dst.param("EPS2DOT").frozen = po.frozen
        new_binary = "ELL1"

    return _finish(model, src, dst, new_binary, fb_source, pb_d)


def _finish(model, src, dst, new_binary, fb_source, pb_d) -> TimingModel:
    if fb_source and dst.param("PB").value_f64 <= 0:
        # FB0-parameterized source (BTX): the target families carry PB,
        # sigma via the trivial Jacobian dPB/dFB0 = -1/(FB0^2 * 86400 s)
        fb = src.param("FB0")
        dst.param("PB").value = (float(pb_d), 0.0)
        dst.param("PB").frozen = fb.frozen
        if fb.uncertainty:
            dst.param("PB").uncertainty = float(
                fb.uncertainty / (fb.value_f64 ** 2 * SECS_PER_DAY))

    comps = [dst if c is src else c for c in model.components]
    header = dict(model.header)
    header["BINARY"] = new_binary
    out = TimingModel(comps, name=model.name, header=header)
    out.validate()
    return out
