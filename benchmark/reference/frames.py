"""J2000 -> GEO rotation at a photo time (host float64).

A frozen copy of the chain the original auromat uses (Hapgood 1992 as in
NASA's cxform: IAU-76 style precession with cxform's sign of theta, then
the Greenwich sidereal rotation), written from its formulas. The program's
own copy is the only other model of this chain, so the benchmark keeps one
that later changes to the program cannot move.
"""

from math import cos, radians, sin

import numpy as np

JD_J2000 = 2451545.0
SECONDS_PER_DAY = 86400.0


def julian_date(t):
    """UTC datetime -> Julian date (Fliegel & Van Flandern)."""
    y, m = t.year, t.month
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    jd0 = int(365.25 * (y + 4716)) + int(30.6001 * (m + 1)) + t.day + b - 1524.5
    return jd0 + (t.hour + (t.minute + (t.second + t.microsecond / 1e6)
                            / 60.0) / 60.0) / 24.0


def _rz(t):
    c, s = cos(t), sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _ry(t):
    c, s = cos(t), sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def j2000_to_geo(t):
    """3x3 float64 matrix taking J2000 (GCRS) vectors to GEO at time ``t``."""
    et = (julian_date(t) - JD_J2000) * SECONDS_PER_DAY
    t0 = et / SECONDS_PER_DAY / 36525.0
    precession = (_rz(radians(0.64062 * t0 + 0.00030 * t0 * t0))
                  @ _ry(radians(0.55675 * t0 - 0.00012 * t0 * t0))
                  @ _rz(radians(0.64062 * t0 + 0.00008 * t0 * t0)))
    jd = et / SECONDS_PER_DAY - 0.5
    hours = (jd - int(jd)) * 24.0
    if hours < 0.0:
        hours += 24.0
    theta = 100.461 + 36000.770 * t0 + 360.0 * (hours / 24.0)
    return _rz(-radians(theta)) @ precession
