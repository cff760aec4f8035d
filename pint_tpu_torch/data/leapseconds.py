"""Leap-second (TAI-UTC) step table.

A copy of ``pint_tpu.data.leapseconds``. Values are the canonical IERS
announcements since 1972; TAI-UTC has been 37 s since 2017-01-01 and no
further leap second is scheduled as of mid-2026.

To update after a future leap second: append (MJD of 00:00 UTC on the
effective date, new TAI-UTC seconds).
"""

# (MJD at which the new offset takes effect, TAI-UTC in seconds from then on)
_TABLE = [
    (41317.0, 10.0),  # 1972-01-01
    (41499.0, 11.0),  # 1972-07-01
    (41683.0, 12.0),  # 1973-01-01
    (42048.0, 13.0),  # 1974-01-01
    (42413.0, 14.0),  # 1975-01-01
    (42778.0, 15.0),  # 1976-01-01
    (43144.0, 16.0),  # 1977-01-01
    (43509.0, 17.0),  # 1978-01-01
    (43874.0, 18.0),  # 1979-01-01
    (44239.0, 19.0),  # 1980-01-01
    (44786.0, 20.0),  # 1981-07-01
    (45151.0, 21.0),  # 1982-07-01
    (45516.0, 22.0),  # 1983-07-01
    (46247.0, 23.0),  # 1985-07-01
    (47161.0, 24.0),  # 1988-01-01
    (47892.0, 25.0),  # 1990-01-01
    (48257.0, 26.0),  # 1991-01-01
    (48804.0, 27.0),  # 1992-07-01
    (49169.0, 28.0),  # 1993-07-01
    (49534.0, 29.0),  # 1994-07-01
    (50083.0, 30.0),  # 1996-01-01
    (50630.0, 31.0),  # 1997-07-01
    (51179.0, 32.0),  # 1999-01-01
    (53736.0, 33.0),  # 2006-01-01
    (54832.0, 34.0),  # 2009-01-01
    (56109.0, 35.0),  # 2012-07-01
    (57204.0, 36.0),  # 2015-07-01
    (57754.0, 37.0),  # 2017-01-01
]

LEAP_MJD = [row[0] for row in _TABLE]
LEAP_TAI_MINUS_UTC = [row[1] for row in _TABLE]
