"""Celestial/terrestrial reference-frame rotation matrices (host side).

The Hapgood (1992) rotation chain J2000 -> GEI -> GEO / GSE -> GSM -> SM as
popularised by NASA's cxform library. The reference reimplements the same
chain with pre-multiplied matrices (auromat/coordinates/transform.py:487-738);
here it is written directly in terms of standard right-handed axis rotations.

These are a handful of 3x3 float64 matrices per frame timestamp — strictly
host-side numpy. The per-pixel application of the matrices happens on device
(see auromat_tpu_torch.ops.georef).

Convention note: the Hapgood "frame rotation by angle t about axis Z" equals
the standard point-rotation matrix Rz(-t); all matrices below are expressed
with standard Rx/Ry/Rz so every sign is explicit.
"""

from datetime import datetime
from math import atan, atan2, cos, pi, radians, sin, sqrt

import numpy as np

from auromat_tpu_torch.coordinates import igrf
from auromat_tpu_torch.timeutil import (
    ephemeris_seconds,
    fractional_year_index,
    hours_since_midnight,
    julian_centuries_since_j2000,
)


def rot_x(t: float) -> np.ndarray:
    c, s = cos(t), sin(t)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y(t: float) -> np.ndarray:
    c, s = cos(t), sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z(t: float) -> np.ndarray:
    c, s = cos(t), sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def magnetic_pole_lon(et: float) -> float:
    """Longitude of Earth's magnetic (centred-dipole) pole, radians.

    Reference: auromat/coordinates/transform.py:497-508.
    """
    fyi, fy = fractional_year_index(et)
    return atan2(igrf.h11(fyi, fy), igrf.g11(fyi, fy)) + pi


def magnetic_pole_lat(et: float) -> float:
    """Latitude of Earth's magnetic (centred-dipole) pole, radians.

    Reference: auromat/coordinates/transform.py:510-523.
    """
    fyi, fy = fractional_year_index(et)
    lam0 = magnetic_pole_lon(et)
    g01, g11, h11 = igrf.g01(fyi, fy), igrf.g11(fyi, fy), igrf.h11(fyi, fy)
    return pi / 2 - atan((g11 * cos(lam0) + h11 * sin(lam0)) / g01)


def sun_ecliptic_lon_deg(et: float) -> float:
    """Sun's ecliptic longitude in degrees (Hapgood low-precision series)."""
    t0 = julian_centuries_since_j2000(et)
    m = 357.528 + 35999.050 * t0
    lam = 280.460 + 36000.772 * t0
    return lam + (1.915 - 0.0048 * t0) * sin(radians(m)) + 0.020 * sin(radians(2 * m))


def obliquity_deg(et: float) -> float:
    """Obliquity of the ecliptic in degrees."""
    return 23.439 - 0.013 * julian_centuries_since_j2000(et)


def mat_precession(et: float) -> np.ndarray:
    """J2000 -> GEI (mean of date) precession matrix ``P``.

    Reference: auromat/coordinates/transform.py:568-581.

    NOTE (intentional parity quirk): the middle factor is ``rot_y(+theta)``,
    whereas the textbook IAU-76 J2000->MOD matrix in this active convention
    is ``rz(z) @ ry(-theta) @ rz(zeta)`` (see ephem.teme_to_gcrs_matrix).
    The +theta sign reproduces the reference's cxform-derived chain
    bit-exactly, and every consumer (GEO/SM conversions, and their golden
    parity tests) uses this same chain consistently -- do not "fix" the sign
    here in isolation.
    """
    t0 = julian_centuries_since_j2000(et)
    za = radians(0.64062 * t0 + 0.00030 * t0 * t0)
    theta = radians(0.55675 * t0 - 0.00012 * t0 * t0)
    zc = radians(0.64062 * t0 + 0.00008 * t0 * t0)
    return rot_z(za) @ rot_y(theta) @ rot_z(zc)


def mat_gei_to_geo(et: float) -> np.ndarray:
    """GEI -> GEO matrix ``T1`` (Greenwich sidereal rotation).

    Reference: auromat/coordinates/transform.py:583-590.
    """
    t0 = julian_centuries_since_j2000(et)
    theta = 100.461 + 36000.770 * t0 + 360.0 * (hours_since_midnight(et) / 24.0)
    return rot_z(-radians(theta))


def mat_gei_to_gse(et: float) -> np.ndarray:
    """GEI -> GSE matrix ``T2``.

    Reference: auromat/coordinates/transform.py:592-599.
    """
    return rot_z(-radians(sun_ecliptic_lon_deg(et))) @ rot_x(-radians(obliquity_deg(et)))


def _dipole_axis_gse(et: float) -> np.ndarray:
    """Unit vector of the dipole axis expressed in GSE (``Qe``).

    Reference: auromat/coordinates/transform.py:601-620.
    """
    lat = magnetic_pole_lat(et)
    lon = magnetic_pole_lon(et)
    qg = np.array([cos(lat) * cos(lon), cos(lat) * sin(lon), sin(lat)])
    return mat_gei_to_gse(et) @ mat_gei_to_geo(et).T @ qg


def mat_gse_to_gsm(et: float) -> np.ndarray:
    """GSE -> GSM matrix ``T3``. Reference: transform.py:622-629."""
    qe = _dipole_axis_gse(et)
    psi = atan2(qe[1], qe[2])
    return rot_x(psi)


def mat_gsm_to_sm(et: float) -> np.ndarray:
    """GSM -> SM matrix ``T4``. Reference: transform.py:631-638."""
    qe = _dipole_axis_gse(et)
    mu = atan2(qe[0], sqrt(qe[1] * qe[1] + qe[2] * qe[2]))
    return rot_y(-mu)


def mat_geo_to_mag(et: float) -> np.ndarray:
    """GEO -> MAG matrix ``T5``. Reference: transform.py:640-647."""
    return rot_y(magnetic_pole_lat(et) - pi / 2) @ rot_z(-magnetic_pole_lon(et))


def mat_j2000_to_geo(et: float) -> np.ndarray:
    """Pre-multiplied J2000 -> GEO chain (T1 @ P)."""
    return mat_gei_to_geo(et) @ mat_precession(et)


def mat_j2000_to_sm(et: float) -> np.ndarray:
    """Pre-multiplied J2000 -> SM chain (T4 @ T3 @ T2 @ P)."""
    return (
        mat_gsm_to_sm(et) @ mat_gse_to_gsm(et) @ mat_gei_to_gse(et) @ mat_precession(et)
    )


def mat_geo_to_sm(et: float) -> np.ndarray:
    """Pre-multiplied GEO -> SM chain (T4 @ T3 @ T2 @ T1^T)."""
    return (
        mat_gsm_to_sm(et)
        @ mat_gse_to_gsm(et)
        @ mat_gei_to_gse(et)
        @ mat_gei_to_geo(et).T
    )


def _et(date) -> float:
    if isinstance(date, datetime):
        return ephemeris_seconds(date)
    return float(date)


class FrameMatrices:
    """All frame matrices for one timestamp, computed once.

    This is the per-frame scalar calibration bundled alongside WCS parameters
    and fed to the device georeferencing kernels.
    """

    def __init__(self, date):
        et = _et(date)
        self.et = et
        # compute each sub-chain matrix once and compose (the standalone
        # mat_j2000_to_* functions would redo P/T1/T2/Qe 4-10x)
        p = mat_precession(et)
        t1 = mat_gei_to_geo(et)
        t2 = mat_gei_to_gse(et)
        lat, lon = magnetic_pole_lat(et), magnetic_pole_lon(et)
        qg = np.array([cos(lat) * cos(lon), cos(lat) * sin(lon), sin(lat)])
        qe = t2 @ t1.T @ qg
        t3 = rot_x(atan2(qe[1], qe[2]))
        t4 = rot_y(-atan2(qe[0], sqrt(qe[1] * qe[1] + qe[2] * qe[2])))
        t4321 = t4 @ t3 @ t2
        self.j2000_to_geo = t1 @ p
        self.j2000_to_sm = t4321 @ p
        self.geo_to_sm = t4321 @ t1.T

    @property
    def geo_to_j2000(self) -> np.ndarray:
        return self.j2000_to_geo.T

    @property
    def sm_to_geo(self) -> np.ndarray:
        return self.geo_to_sm.T


def north_geomagnetic_pole_location(date) -> tuple:
    """Approximate (lat, lon) of the north geomagnetic pole, degrees.

    Reference: auromat/coordinates/transform.py:740-753.
    """
    et = _et(date)
    lat = np.rad2deg(magnetic_pole_lat(et))
    lon = np.rad2deg(magnetic_pole_lon(et))
    lon = (lon + 180.0) % 360.0 - 180.0
    return float(lat), float(lon)
