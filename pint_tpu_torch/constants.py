"""Shared physical and calendrical constants (single source of truth).

Values match the ones the reference uses via astropy/erfa (IAU 2012 au,
IAU 2006 obliquity, tempo-compatible dispersion constant).
"""

import numpy as np

C_M_S = 299792458.0  # speed of light [m/s], exact
AU_M = 149597870700.0  # astronomical unit [m], IAU 2012, exact
AU_LIGHT_S = AU_M / C_M_S  # 1 au in light-seconds (499.00478383615643)

SECS_PER_DAY = 86400.0
DAYS_PER_JULIAN_YEAR = 365.25
SEC_PER_JULIAN_YEAR = DAYS_PER_JULIAN_YEAR * SECS_PER_DAY
JULIAN_MILLENNIUM_DAYS = 365250.0

MJD_J2000 = 51544.5  # TT
TT_MINUS_TAI_S = 32.184  # exact by definition

# Obliquity of the ecliptic at J2000, IAU 2006 (arcsec -> rad); the same
# constant the reference ships as ecliptic.dat "IERS2010".
OBLIQUITY_RAD = float(np.deg2rad(84381.406 / 3600.0))

# GM_sun/c^3 [s] (Shapiro time constant), IAU nominal solar mass parameter
T_SUN_S = 4.925490947e-6

# tempo/tempo2/PINT-compatible dispersion constant [s MHz^2 pc^-1 cm^3]
DM_CONST = 1.0 / 2.41e-4
