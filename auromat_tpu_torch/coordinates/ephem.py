"""TLE parsing, SGP4 propagation and the ephemeris calculator.

Counterpart of ``auromat_tpu.coordinates.ephem``, the same code: the
scalar propagator runs in numpy float64 on the host, where one position
per frame is cheaper than a device round trip.

Replaces the reference's pyephem/libastro dependency (auromat/coordinates/
ephem.py:14-156): a pure-numpy implementation of the standard SGP4
near-Earth propagator (Vallado et al. 2006 revision of Spacetrack Report #3,
WGS-72 constants) plus the TEME->GCRS frame correction (precession + IAU-1980
truncated nutation + equation of the equinoxes).

Accuracy: SGP4 itself is good to ~1 km for fresh ISS TLEs; the truncated
nutation adds <50 m. Matches the reference's quality target ("TLE more than
24h from photo time triggers a staleness warning", ephem.py:146-147).
"""

import math
import warnings
from bisect import bisect_left
from datetime import datetime, timedelta

import numpy as np

from auromat_tpu_torch.timeutil import julian_date

# WGS-72 gravitational constants (the standard for SGP4)
_XKE = 0.0743669161331734132  # sqrt(GM) in (earth radii)^1.5 / min
_J2 = 0.001082616
_J3 = -0.00000253881
_J4 = -0.00000165597
_RE_KM = 6378.135
_K2 = 0.5 * _J2
_A3OVK2 = -_J3 / _K2


class TLE:
    """One two-line element set."""

    def __init__(self, line1, line2, name=None):
        self.name = (name or "").strip()
        self.line1 = line1.rstrip()
        self.line2 = line2.rstrip()
        self.norad_id = int(line1[2:7])
        year = int(line1[18:20])
        year += 1900 if year >= 57 else 2000
        day_frac = float(line1[20:32])
        self.epoch = datetime(year, 1, 1) + timedelta(days=day_frac - 1.0)
        self.bstar = _tle_float(line1[53:61])
        self.inclo = math.radians(float(line2[8:16]))
        self.nodeo = math.radians(float(line2[17:25]))
        self.ecco = float("0." + line2[26:33].strip())
        self.argpo = math.radians(float(line2[34:42]))
        self.mo = math.radians(float(line2[43:51]))
        self.no = float(line2[52:63]) * 2 * math.pi / 1440.0  # rad/min

    def __repr__(self):
        return f"TLE({self.norad_id} @ {self.epoch.isoformat()})"


def _tle_float(field):
    """Decode TLE exponent fields like ' 13844-3' -> 0.13844e-3."""
    field = field.strip()
    if not field or field in ("+", "-"):
        return 0.0
    mantissa = field[:-2].replace(" ", "")
    exp = field[-2:]
    if "e" in field.lower() or "." in field:
        return float(field)
    sign = -1.0 if mantissa.startswith("-") else 1.0
    mantissa = mantissa.lstrip("+-")
    return sign * float("0." + mantissa) * 10.0 ** int(exp)


def parse_tle_file(path_or_lines):
    """Parse a file (or iterable of lines) of 2-line or 3-line TLEs."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    lines = [l.rstrip("\n") for l in lines if l.strip()]
    tles = []
    name = None
    i = 0
    while i < len(lines):
        l = lines[i]
        if l.startswith("1 ") and i + 1 < len(lines) and lines[i + 1].startswith("2 "):
            tles.append(TLE(l, lines[i + 1], name))
            name = None
            i += 2
        else:
            name = l
            i += 1
    return tles


def tle_checksum_ok(line):
    """Verify the modulo-10 checksum of a TLE line."""
    if len(line) < 69 or not line[68].isdigit():
        return False
    total = 0
    for c in line[:68]:
        if c.isdigit():
            total += int(c)
        elif c == "-":
            total += 1
    return total % 10 == int(line[68])


class SGP4:
    """Near-Earth SGP4 propagator initialised from one TLE.

    Call with minutes since the TLE epoch; returns the TEME position (km)
    and velocity (km/s).
    """

    def __init__(self, tle: TLE):
        self.tle = tle
        ecco = tle.ecco
        inclo = tle.inclo
        no_kozai = tle.no

        cosio = math.cos(inclo)
        cosio2 = cosio * cosio
        eosq = ecco * ecco
        betao2 = 1.0 - eosq
        betao = math.sqrt(betao2)

        # un-Kozai the mean motion
        a1 = (_XKE / no_kozai) ** (2.0 / 3.0)
        d1 = 0.75 * _J2 * (3.0 * cosio2 - 1.0) / (betao * betao2)
        del1 = d1 / (a1 * a1)
        a0 = a1 * (1.0 - del1 * (1.0 / 3.0 + del1 * (1.0 + 134.0 / 81.0 * del1)))
        del0 = d1 / (a0 * a0)
        self.no = no_kozai / (1.0 + del0)
        self.ao = a0 / (1.0 - del0)

        self.isimp = 0
        rp = self.ao * (1.0 - ecco)
        if rp < (220.0 / _RE_KM + 1.0):
            self.isimp = 1

        s4 = 1.0 + 78.0 / _RE_KM
        qzms24 = ((120.0 - 78.0) / _RE_KM) ** 4
        perige = (rp - 1.0) * _RE_KM
        if perige < 156.0:
            s4 = perige - 78.0
            if perige < 98.0:
                s4 = 20.0
            qzms24 = ((120.0 - s4) / _RE_KM) ** 4
            s4 = s4 / _RE_KM + 1.0

        pinvsq = 1.0 / (self.ao * self.ao * betao2 * betao2)
        tsi = 1.0 / (self.ao - s4)
        self.eta = self.ao * ecco * tsi
        etasq = self.eta * self.eta
        eeta = ecco * self.eta
        psisq = abs(1.0 - etasq)
        coef = qzms24 * tsi**4
        coef1 = coef / psisq**3.5
        c2 = (
            coef1 * self.no
            * (self.ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
               + 0.375 * _J2 * tsi / psisq * (3.0 * cosio2 - 1.0)
               * (8.0 + 3.0 * etasq * (8.0 + etasq)))
        )
        self.c1 = tle.bstar * c2
        self.c3 = 0.0
        if ecco > 1.0e-4:
            # STR#3: C3 = COEF*TSI*A3OVK2*XNODP*SINIO/EO
            self.c3 = coef * tsi * _A3OVK2 * self.no * math.sin(inclo) / ecco
        x1mth2 = 1.0 - cosio2
        self.c4 = (
            2.0 * self.no * coef1 * self.ao * betao2
            * (self.eta * (2.0 + 0.5 * etasq) + ecco * (0.5 + 2.0 * etasq)
               - _J2 * tsi / (self.ao * psisq)
               * (-3.0 * (3.0 * cosio2 - 1.0)
                  * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
                  + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
                  * math.cos(2.0 * tle.argpo)))
        )
        self.c5 = (
            2.0 * coef1 * self.ao * betao2
            * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq)
        )

        theta4 = cosio2 * cosio2
        temp1 = 1.5 * _J2 * pinvsq * self.no
        temp2 = 0.5 * temp1 * _J2 * pinvsq
        temp3 = -0.46875 * _J4 * pinvsq * pinvsq * self.no
        self.mdot = (
            self.no + 0.5 * temp1 * betao * (3.0 * cosio2 - 1.0)
            + 0.0625 * temp2 * betao * (13.0 - 78.0 * cosio2 + 137.0 * theta4)
        )
        self.argpdot = (
            -0.5 * temp1 * (1.0 - 5.0 * cosio2)
            + 0.0625 * temp2 * (7.0 - 114.0 * cosio2 + 395.0 * theta4)
            + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * theta4)
        )
        xhdot1 = -temp1 * cosio
        self.nodedot = (
            xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * cosio2)
                      + 2.0 * temp3 * (3.0 - 7.0 * cosio2)) * cosio
        )
        self.omgcof = tle.bstar * self.c3 * math.cos(tle.argpo)
        self.xmcof = 0.0
        if ecco > 1.0e-4:
            self.xmcof = -(2.0 / 3.0) * coef * tle.bstar / eeta
        self.nodecf = 3.5 * betao2 * xhdot1 * self.c1
        self.t2cof = 1.5 * self.c1
        # STR#3: XLCOF = 0.125*A3OVK2*SINIO*(3+5COSIO)/(1+COSIO),
        #        AYCOF = 0.25*A3OVK2*SINIO
        if abs(cosio + 1.0) > 1.5e-12:
            self.xlcof = (
                0.125 * _A3OVK2 * math.sin(inclo)
                * (3.0 + 5.0 * cosio) / (1.0 + cosio)
            )
        else:
            self.xlcof = (
                0.125 * _A3OVK2 * math.sin(inclo) * (3.0 + 5.0 * cosio) / 1.5e-12
            )
        self.aycof = 0.25 * _A3OVK2 * math.sin(inclo)
        self.delmo = (1.0 + self.eta * math.cos(tle.mo)) ** 3
        self.sinmao = math.sin(tle.mo)
        self.x7thm1 = 7.0 * cosio2 - 1.0
        self.cosio = cosio
        self.sinio = math.sin(inclo)

        if self.isimp != 1:
            c1sq = self.c1 * self.c1
            self.d2 = 4.0 * self.ao * tsi * c1sq
            temp = self.d2 * tsi * self.c1 / 3.0
            self.d3 = (17.0 * self.ao + s4) * temp
            self.d4 = (
                0.5 * temp * self.ao * tsi * (221.0 * self.ao + 31.0 * s4) * self.c1
            )
            self.t3cof = self.d2 + 2.0 * c1sq
            self.t4cof = 0.25 * (3.0 * self.d3 + self.c1 * (12.0 * self.d2 + 10.0 * c1sq))
            self.t5cof = 0.2 * (
                3.0 * self.d4 + 12.0 * self.c1 * self.d3 + 6.0 * self.d2 * self.d2
                + 15.0 * c1sq * (2.0 * self.d2 + c1sq)
            )

    def __call__(self, tsince_min):
        """Propagate: minutes since epoch -> (r_teme_km (3,), v_teme_km_s (3,))."""
        tle = self.tle
        xmdf = tle.mo + self.mdot * tsince_min
        argpdf = tle.argpo + self.argpdot * tsince_min
        nodedf = tle.nodeo + self.nodedot * tsince_min
        argpm = argpdf
        mm = xmdf
        t2 = tsince_min * tsince_min
        nodem = nodedf + self.nodecf * t2
        tempa = 1.0 - self.c1 * tsince_min
        tempe = tle.bstar * self.c4 * tsince_min
        templ = self.t2cof * t2

        if self.isimp != 1:
            delomg = self.omgcof * tsince_min
            delm = self.xmcof * (
                (1.0 + self.eta * math.cos(xmdf)) ** 3 - self.delmo
            )
            temp = delomg + delm
            mm = xmdf + temp
            argpm = argpdf - temp
            t3 = t2 * tsince_min
            t4 = t3 * tsince_min
            tempa -= self.d2 * t2 + self.d3 * t3 + self.d4 * t4
            tempe += tle.bstar * self.c5 * (math.sin(mm) - self.sinmao)
            templ += self.t3cof * t3 + t4 * (self.t4cof + tsince_min * self.t5cof)

        am = self.ao * tempa * tempa
        em = tle.ecco - tempe
        if em < 1.0e-6:
            em = 1.0e-6
        xlm = mm + argpm + nodem + self.no * templ
        sinim, cosim = self.sinio, self.cosio

        # long-period periodics
        axnl = em * math.cos(argpm)
        temp = 1.0 / (am * (1.0 - em * em))
        aynl = em * math.sin(argpm) + temp * self.aycof
        xl = xlm + temp * self.xlcof * axnl

        # Kepler's equation
        u = (xl - nodem) % (2 * math.pi)
        eo1 = u
        for _ in range(10):
            sineo1 = math.sin(eo1)
            coseo1 = math.cos(eo1)
            tem5 = 1.0 - coseo1 * axnl - sineo1 * aynl
            tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / tem5
            if abs(tem5) >= 0.95:
                tem5 = 0.95 if tem5 > 0 else -0.95
            eo1 += tem5
            if abs(tem5) < 1.0e-12:
                break

        # short-period periodics
        ecose = axnl * coseo1 + aynl * sineo1
        esine = axnl * sineo1 - aynl * coseo1
        el2 = axnl * axnl + aynl * aynl
        pl = am * (1.0 - el2)
        rl = am * (1.0 - ecose)
        rdotl = math.sqrt(am) * esine / rl
        rvdotl = math.sqrt(pl) / rl
        betal = math.sqrt(1.0 - el2)
        temp = esine / (1.0 + betal)
        sinu = am / rl * (sineo1 - aynl - axnl * temp)
        cosu = am / rl * (coseo1 - axnl + aynl * temp)
        su = math.atan2(sinu, cosu)
        sin2u = (cosu + cosu) * sinu
        cos2u = 1.0 - 2.0 * sinu * sinu
        temp = 1.0 / pl
        temp1 = 0.5 * _J2 * temp
        temp2 = temp1 * temp

        cosisq = cosim * cosim
        x1mth2 = 1.0 - cosisq
        mrt = (
            rl * (1.0 - 1.5 * temp2 * betal * (3.0 * cosisq - 1.0))
            + 0.5 * temp1 * x1mth2 * cos2u
        )
        su -= 0.25 * temp2 * self.x7thm1 * sin2u
        xnode = nodem + 1.5 * temp2 * cosim * sin2u
        xinc = self.tle.inclo + 1.5 * temp2 * cosim * sinim * cos2u
        mvt = rdotl - self.no * temp1 * x1mth2 * sin2u / _XKE
        rvdot = rvdotl + self.no * temp1 * (x1mth2 * cos2u + 1.5 * (3.0 * cosisq - 1.0)) / _XKE

        # orientation vectors
        sinsu = math.sin(su)
        cossu = math.cos(su)
        snod = math.sin(xnode)
        cnod = math.cos(xnode)
        sini = math.sin(xinc)
        cosi = math.cos(xinc)
        xmx = -snod * cosi
        xmy = cnod * cosi
        ux = xmx * sinsu + cnod * cossu
        uy = xmy * sinsu + snod * cossu
        uz = sini * sinsu
        vx = xmx * cossu - cnod * sinsu
        vy = xmy * cossu - snod * sinsu
        vz = sini * cossu

        r = np.array([ux, uy, uz]) * mrt * _RE_KM
        v = (np.array([vx, vy, vz]) * rvdot + np.array([ux, uy, uz]) * mvt) * (
            _RE_KM * _XKE / 60.0
        )
        return r, v


# ---------------------------------------------------------------------------
# TEME -> GCRS/J2000
# ---------------------------------------------------------------------------


def _nutation_angles(t):
    """Truncated IAU-1980 nutation (4 largest terms), radians."""
    d2r = math.pi / 180.0
    om = (125.04452 - 1934.136261 * t) * d2r
    lm = (218.31654591 + 481267.88134236 * t) * d2r
    ls = (280.46645 + 36000.76983 * t) * d2r
    dpsi = (
        -17.20 * math.sin(om) - 1.32 * math.sin(2 * ls)
        - 0.23 * math.sin(2 * lm) + 0.21 * math.sin(2 * om)
    ) / 3600.0 * d2r
    deps = (
        9.20 * math.cos(om) + 0.57 * math.cos(2 * ls)
        + 0.10 * math.cos(2 * lm) - 0.09 * math.cos(2 * om)
    ) / 3600.0 * d2r
    eps0 = (23.439291 - 0.0130042 * t) * d2r
    return dpsi, deps, eps0


def teme_to_gcrs_matrix(date: datetime) -> np.ndarray:
    """Rotation matrix TEME -> GCRS (~J2000) for the given date."""
    jd = julian_date(date)
    t = (jd - 2451545.0) / 36525.0
    dpsi, deps, eps0 = _nutation_angles(t)
    eps = eps0 + deps
    # equation of the equinoxes (TEME's x-axis is offset from TOD by -Eqeq)
    eqeq = dpsi * math.cos(eps0)

    def rx(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def rz(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    tod_from_teme = rz(eqeq)
    # nutation: TOD -> MOD. Vallado's [N] = ROT1(-eps0) ROT3(dpsi) ROT1(eps)
    # with passive ROTn(a) == active r_n(-a), i.e. in the active convention
    # used here: rx(eps0) rz(-dpsi) rx(-eps). (An earlier version had all
    # three signs flipped -- a 1.3 km error at ISS radius.)
    mod_from_tod = rx(eps0) @ rz(-dpsi) @ rx(-eps)
    # precession: MOD -> J2000 (IAU-76). Forward J2000->MOD is
    # ROT3(-z) ROT2(theta) ROT3(-zeta) == active rz(z) ry(-theta) rz(zeta);
    # the inverse used here is its transpose. (An earlier version applied
    # the forward matrix instead -- a 2x-precession / ~40 km error.)
    d2r = math.pi / 180.0
    zeta = (2306.2181 * t + 0.30188 * t * t) / 3600.0 * d2r
    theta = (2004.3109 * t - 0.42665 * t * t) / 3600.0 * d2r
    z = (2306.2181 * t + 1.09468 * t * t) / 3600.0 * d2r

    def ry(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    j2000_from_mod = rz(-zeta) @ ry(theta) @ rz(-z)
    return j2000_from_mod @ mod_from_tod @ tod_from_teme


class EphemerisCalculator:
    """Spacecraft GCRS positions from a TLE archive file.

    Mirrors auromat/coordinates/ephem.py:16-156: selects the nearest TLE per
    date (binary search), propagates with SGP4, warns when the nearest epoch
    is more than ``maxEpochDistance`` away.
    """

    def __init__(self, tle_path_or_list, norad_id=None, maxEpochDistance=timedelta(hours=24)):
        if isinstance(tle_path_or_list, (list, tuple)):
            tles = list(tle_path_or_list)
        else:
            tles = parse_tle_file(tle_path_or_list)
        if norad_id is not None:
            tles = [t for t in tles if t.norad_id == norad_id]
        if not tles:
            raise ValueError("no TLEs available")
        self.tles = sorted(tles, key=lambda t: t.epoch)
        self._epochs = [t.epoch for t in self.tles]
        self.maxEpochDistance = maxEpochDistance
        self._propagators = {}  # id(tle) -> initialised SGP4

    @property
    def firstDate(self):
        return self._epochs[0]

    @property
    def lastDate(self):
        return self._epochs[-1]

    def contains(self, date):
        return self.firstDate <= date <= self.lastDate

    def get_tle(self, date) -> TLE:
        i = bisect_left(self._epochs, date)
        candidates = [j for j in (i - 1, i) if 0 <= j < len(self.tles)]
        best = min(candidates, key=lambda j: abs((self._epochs[j] - date).total_seconds()))
        dist = abs(self._epochs[best] - date)
        if dist > self.maxEpochDistance:
            warnings.warn(
                f"nearest TLE epoch is {dist} away from {date}; "
                "propagation accuracy degrades"
            )
        return self.tles[best]

    def __call__(self, date):
        """GCRS position (km, shape (3,)) of the spacecraft at ``date``."""
        tle = self.get_tle(date)
        prop = self._propagators.get(id(tle))
        if prop is None:
            prop = self._propagators[id(tle)] = SGP4(tle)
        tsince = (date - tle.epoch).total_seconds() / 60.0
        r_teme, _ = prop(tsince)
        return teme_to_gcrs_matrix(date) @ r_teme

    # reference API alias (ephem.py:125)
    getPosition = __call__
