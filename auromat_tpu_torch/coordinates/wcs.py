"""FITS WCS celestial projections as torch tensor code.

Counterpart of ``auromat_tpu.coordinates.wcs``. The reference implements
a fast custom TAN unprojection (auromat/coordinates/wcs.py:66-157) and
falls back to astropy for anything else (reference wcs.py:18-64). Here
the full FITS Paper II projection catalogue is first-party math —
zenithal (TAN/SIN/ZEA/ARC/STG + AZP/SZP/ZPN/AIR), cylindrical
(CAR/CEA/MER/CYP), conic (COP/COE/COD/COO), pseudo-cylindrical
(SFL/PAR/MOL/AIT), pseudo-conic (BON/PCO), quad-cube (TSC/QSC) and
HEALPix (HPX + the XPH butterfly) — built by :func:`make_wcs` and driven
through :func:`pix2world`/:func:`world2pix`; only CSC (a third-party
polynomial coefficient table, not math) is excluded. The fused
georeference path stays TAN-only (astrometry.net always emits
RA---TAN/DEC--TAN solutions).

The WCS classes are host-side containers: header constants are Python
floats. Their per-pixel methods and the module's functions are eager
elementwise tensor code that computes in the dtype and on the device of
the pixel (or angle) tensors they are given; ``where`` evaluates both
branches, so every divisor of an untaken branch is guarded. The iterative
inverses (PCO's 45 bisection rounds, MOL's 12 Newton steps) are that many
full-size eager operations.

Math (FITS Paper II, Calabretta & Greisen 2002):
  pixel offsets -> CD matrix -> projection-plane (x, y) in degrees
  native spherical: phi = arg(-y, x); theta from the projection's radial
  function R_theta (TAN: (180/pi)/tan -> theta = atan(180/(pi R)))
  celestial: rotate by the Euler z-x-z matrix
  Rz(ra_ref + 90) @ Rx(90 - dec_ref) @ Rz(-(lonpole - 90))   [degrees]
"""

import math

import numpy as np
import torch

from auromat_tpu_torch.coordinates.transform import mat_entries

_RAD_PER_R = math.pi / 180.0  # projection-plane degrees -> radians


def celestial_rotation_matrix(ra_ref_deg, dec_ref_deg, lonpole_deg):
    """Native-spherical -> celestial rotation (host-side, float64).

    Matches euler_matrix(ra+90, 90-dec, -(lonpole-90), 'rzxz') of the
    reference (auromat/coordinates/wcs.py:133-139), i.e.
    Rz(a) @ Rx(b) @ Rz(c).
    """
    a = np.deg2rad(ra_ref_deg + 90.0)
    b = np.deg2rad(90.0 - dec_ref_deg)
    c = np.deg2rad(-(lonpole_deg - 90.0))

    def rz(t):
        ct, st = np.cos(t), np.sin(t)
        return np.array([[ct, -st, 0.0], [st, ct, 0.0], [0.0, 0.0, 1.0]])

    def rx(t):
        ct, st = np.cos(t), np.sin(t)
        return np.array([[1.0, 0.0, 0.0], [0.0, ct, -st], [0.0, st, ct]])

    return rz(a) @ rx(b) @ rz(c)


def _ctype_code(header):
    """Projection code from a CTYPE1/CTYPE2 lon/lat pair, or None.

    Accepts any FITS celestial pair — RA---xxx/DEC--xxx and the
    generic <X>LON-xxx/<X>LAT-xxx systems (GLON/GLAT galactic,
    ELON/ELAT ecliptic, ...) with matching projection codes; the math
    is frame-agnostic (the "celestial" frame is whatever lon/lat
    system the header declares). Longitude must be axis 1 (axis-swapped
    headers are not supported)."""
    c1 = header.get("CTYPE1") or ""
    c2 = header.get("CTYPE2") or ""
    if not (isinstance(c1, str) and isinstance(c2, str)
            and len(c1) >= 6 and len(c2) >= 6
            and c1[4] == "-" and c2[4] == "-" and c1[5:] == c2[5:]):
        return None
    lon = c1[:4].rstrip("-")
    lat = c2[:4].rstrip("-")
    pair_ok = (lon, lat) == ("RA", "DEC") or (
        lon.endswith("LON") and lat.endswith("LAT")
        and lon[:-3] == lat[:-3])
    return c1[5:] if pair_ok else None


def _cd_matrix(header):
    """The 2x2 linear-transformation matrix from any of its FITS
    spellings: CDi_j directly; PCi_j x CDELTi (Paper I defaults:
    PC = identity, CDELT = 1, absent cards = 0/identity entries); or
    legacy CROTA2 + CDELTi (CD = [[cd1 cos, -cd2 sin], [cd1 sin,
    cd2 cos]]). astrometry.net always writes CD; the reference reads
    the other spellings through astropy (reference wcs.py:18-64)."""
    if any(f"CD{i}_{j}" in header for i in (1, 2) for j in (1, 2)):
        g = lambda k: float(header.get(k, 0.0))
        return np.array([[g("CD1_1"), g("CD1_2")],
                         [g("CD2_1"), g("CD2_2")]])
    d1 = float(header.get("CDELT1", 1.0))
    d2 = float(header.get("CDELT2", 1.0))
    if any(f"PC{i}_{j}" in header for i in (1, 2) for j in (1, 2)):
        g = lambda k, dflt: float(header.get(k, dflt))
        pc = np.array([[g("PC1_1", 1.0), g("PC1_2", 0.0)],
                       [g("PC2_1", 0.0), g("PC2_2", 1.0)]])
        return np.diag([d1, d2]) @ pc
    rho = np.deg2rad(float(header.get("CROTA2", 0.0)))
    return np.array([[d1 * np.cos(rho), -d2 * np.sin(rho)],
                     [d1 * np.sin(rho), d2 * np.cos(rho)]])


def _parse_celestial_header(wcs, header, family_desc):
    """Shared FITS-card parsing for the projection families whose
    fiducial is NOT the native pole (cylindrical/conic/pseudo-*/
    quad-cube/HEALPix): validates the lon/lat CTYPE pair
    (:func:`_ctype_code`) against ``wcs.SUPPORTED`` and sets
    projection, ra_ref/dec_ref, px_ref/py_ref, cd (any FITS spelling,
    :func:`_cd_matrix`), width, height."""
    code = _ctype_code(header)
    if code not in wcs.SUPPORTED:
        raise ValueError(
            f"only lon/lat (RA---/DEC--, xLON-/xLAT-) {family_desc} "
            f"projections {wcs.SUPPORTED} are supported here; got "
            f"{header.get('CTYPE1')!r}/{header.get('CTYPE2')!r}")
    wcs.projection = code
    wcs.ra_ref = float(header["CRVAL1"])
    wcs.dec_ref = float(header["CRVAL2"])
    wcs.px_ref = float(header["CRPIX1"])
    wcs.py_ref = float(header["CRPIX2"])
    wcs.cd = _cd_matrix(header)
    wcs.width = int(header["IMAGEW"]) if "IMAGEW" in header else None
    wcs.height = int(header["IMAGEH"]) if "IMAGEH" in header else None


def _finish_native_pole(wcs, header, theta0_deg):
    """Shared LONPOLE/LATPOLE handling + native-pole solve for the same
    families: applies the Paper II LONPOLE default for the given
    fiducial native latitude theta0 and sets lonpole, latpole, rotmat."""
    default_lonpole = 0.0 if wcs.dec_ref >= theta0_deg else 180.0
    wcs.lonpole = float(header.get("LONPOLE", default_lonpole))
    wcs.latpole = float(header.get("LATPOLE", 90.0))
    ap, dp = _native_pole(wcs.ra_ref, wcs.dec_ref, wcs.lonpole,
                          wcs.latpole, theta0_deg)
    wcs.rotmat = celestial_rotation_matrix(ap, dp, wcs.lonpole)


def _native_pole(ra0_deg, dec0_deg, lonpole_deg, latpole_deg, theta0_deg):
    """Celestial coordinates of the native pole for a projection whose
    fiducial native point is (phi0, theta0) = (0, theta0) — the general
    FITS Paper II eqs. 8-10 (host-side float64).

        delta_p = atan2(sin th0, cos th0 cos phi_p)
                  +- acos[ sin dec0 / sqrt(1 - cos^2 th0 sin^2 phi_p) ]
        alpha_p = ra0 - atan2(sin phi_p cos th0,
                              sin th0 cos delta_p
                              - cos th0 sin delta_p cos phi_p)

    with the +- branch closest to LATPOLE. Specializes to the zenithal
    identity (theta0 = 90 -> pole = CRVAL).

    :returns: (alpha_p_deg, delta_p_deg)
    """
    th0 = np.deg2rad(theta0_deg)
    d0 = np.deg2rad(dec0_deg)
    phip = np.deg2rad(lonpole_deg)
    lp = np.deg2rad(latpole_deg)
    den = np.sqrt(max(1.0 - np.cos(th0) ** 2 * np.sin(phip) ** 2, 0.0))
    if den < 1e-12:
        # theta0 = 0 with LONPOLE = +-90: the constraint degenerates to
        # sin(dec0) = 0 and leaves delta_p entirely unconstrained —
        # Paper II says the LATPOLE card supplies it directly
        if abs(np.sin(d0)) > 1e-12:
            raise ValueError(
                f"no native pole solution: LONPOLE={lonpole_deg} with "
                f"theta0={theta0_deg} requires CRVAL2=0; got {dec0_deg}")
        if abs(latpole_deg) > 90.0 + 1e-12:
            raise ValueError(
                f"degenerate native-pole geometry needs LATPOLE in "
                f"[-90, 90]; got {latpole_deg}")
        dp = lp
    else:
        arg = np.sin(d0) / den
        if abs(arg) > 1.0 + 1e-12:
            raise ValueError(
                f"no native pole solution: CRVAL2={dec0_deg} with "
                f"LONPOLE={lonpole_deg}, theta0={theta0_deg} "
                "(|sin dec0| exceeds the reachable range)")
        c = np.arccos(np.clip(arg, -1.0, 1.0))
        t = np.arctan2(np.sin(th0), np.cos(th0) * np.cos(phip))
        # the two roots live mod 2 pi: wrap into (-pi, pi] BEFORE the
        # validity test, else the southern branch is unreachable
        cands = [(v + np.pi) % (2.0 * np.pi) - np.pi for v in (t + c, t - c)]
        cands = [v for v in cands if abs(v) <= np.pi / 2 + 1e-12]
        if not cands:
            raise ValueError(
                f"no valid native pole latitude: CRVAL2={dec0_deg}, "
                f"LONPOLE={lonpole_deg}, theta0={theta0_deg}")
        # closest to LATPOLE; on an exact tie Paper II takes the more
        # NORTHERLY root (descending sort makes min() meet it first)
        dp = min(sorted(cands, reverse=True), key=lambda v: abs(v - lp))
    ap = np.deg2rad(ra0_deg) - np.arctan2(
        np.sin(phip) * np.cos(th0),
        np.sin(th0) * np.cos(dp) - np.cos(th0) * np.sin(dp) * np.cos(phip))
    return np.rad2deg(ap), np.rad2deg(dp)


class ZenithalWcs:
    """Host-side container for a zenithal-projection WCS solution.

    Supports the common zenithal family — TAN (gnomonic), SIN
    (orthographic), ZEA (equal-area), ARC (equidistant), STG
    (stereographic) — the projections the reference reaches through its
    astropy fallback (reference wcs.py:18-64). Built from a
    FITS/astrometry.net header dict (see :mod:`auromat_tpu_torch.io.fits`); the heavy
    per-pixel math runs in :func:`pix2world_cartesian`.
    """

    SUPPORTED = ("TAN", "SIN", "ZEA", "ARC", "STG")

    def __init__(self, header):
        code = _ctype_code(header)
        latpole = float(header.get("LATPOLE", 0.0))
        dec_ref = float(header.get("CRVAL2", 0.0))
        # For zenithal projections the native pole IS the reference point,
        # so delta_p = CRVAL2 and LATPOLE carries no information: wcslib
        # writes the computed value (= CRVAL2) into the card, astrometry.net
        # writes 0. Accept both spellings; anything else on a header is
        # malformed enough to refuse rather than silently ignore.
        latpole_ok = latpole == 0.0 or abs(latpole - dec_ref) < 1e-9
        if code not in self.SUPPORTED or not latpole_ok:
            raise ValueError(
                f"only lon/lat zenithal projections {self.SUPPORTED} "
                f"with LATPOLE in (0, CRVAL2) are supported; got "
                f"{header.get('CTYPE1')!r}/{header.get('CTYPE2')!r} "
                f"LATPOLE={header.get('LATPOLE', 0.0)}"
            )
        self.projection = code
        self.ra_ref = float(header["CRVAL1"])
        self.dec_ref = float(header["CRVAL2"])
        self.px_ref = float(header["CRPIX1"])
        self.py_ref = float(header["CRPIX2"])
        self.lonpole = float(header.get("LONPOLE", 180.0))
        self.cd = _cd_matrix(header)
        self.width = int(header["IMAGEW"]) if "IMAGEW" in header else None
        self.height = int(header["IMAGEH"]) if "IMAGEH" in header else None
        self.rotmat = celestial_rotation_matrix(self.ra_ref, self.dec_ref, self.lonpole)

    @classmethod
    def from_calibration(cls, projection, cd, rotmat, px_ref, py_ref):
        """A radial zenithal WCS from calibration values alone (the laws
        of ``SUPPORTED`` have no constants beyond these); the header-only
        attributes (reference angles, image size) are None."""
        if projection not in ZenithalWcs.SUPPORTED:
            raise ValueError(
                f"projection {projection!r} needs its WCS object (pass "
                f"wcs=); only {ZenithalWcs.SUPPORTED} are defined by the "
                f"calibration")
        wcs = cls.__new__(cls)
        wcs.projection = projection
        wcs.ra_ref = wcs.dec_ref = wcs.lonpole = None
        wcs.px_ref, wcs.py_ref = float(px_ref), float(py_ref)
        wcs.cd = np.asarray(cd, dtype=np.float64)
        wcs.width = wcs.height = None
        wcs.rotmat = np.asarray(rotmat, dtype=np.float64)
        return wcs

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native spherical (phi, theta)
        radians; out-of-domain points yield NaN theta."""
        r = torch.sqrt(x * x + y * y)
        phi = torch.atan2(x, -y)
        return phi, _theta_from_r(self.projection, r)

    def dirs_from_plane(self, x, y):
        """Trig-free native unit direction (l, m, n) from plane coords.

        Algebraic elimination of the phi/theta round-trip for the radial
        zenithal laws: the generic per-pixel path then
        costs ~1 sqrt instead of ~6 transcendentals (atan2 + theta(r) +
        4x sin/cos). Values equal native_from_plane + cos/sin to roundoff
        with the SAME NaN domains (SIN beyond the disc, ZEA beyond the
        antipode circle, ARC beyond r=180). Returns None for subclasses
        whose law is not radial (AZP/SZP/ZPN/AIR, XPH) — and for TAN,
        whose generic route is gated BIT-IDENTICAL to tan_pix2world's
        trig formulation (TAN georeferencing does not pass here; it runs
        the fused path of :mod:`auromat_tpu_torch.ops.georef`). :func:`pix2world_cartesian`
        falls back to the spherical route on None.
        """
        if self.projection not in ("SIN", "ZEA", "ARC", "STG"):
            return None
        q = math.pi / 180.0
        r2 = x * x + y * y
        if self.projection == "SIN":
            # the 0*n terms tie every component to the domain NaN (beyond
            # the disc native_from_plane NaNs ALL of phi/theta-derived
            # math, and pix2world's ra must not stay finite there)
            n = torch.sqrt(1.0 - (q * q) * r2)
            return -q * y + 0.0 * n, q * x + 0.0 * n, n
        if self.projection == "ZEA":
            rho2 = (math.pi / 360.0) ** 2 * r2
            k = q * torch.sqrt(1.0 - rho2)  # NaN beyond the antipode circle
            return -k * y, k * x, 1.0 - 2.0 * rho2 + 0.0 * k
        if self.projection == "STG":
            t2 = (math.pi / 360.0) ** 2 * r2
            inv = 1.0 / (1.0 + t2)
            g = q * inv
            return -g * y, g * x, (1.0 - t2) * inv
        # ARC: n = cos(q r), (l, m) = sin(q r)/r * (-y, x); guard the
        # exact-centre 0/0 (sin(qr)/r -> q) and the r > 180 domain edge
        r = torch.sqrt(r2)
        zeta = q * r
        s = torch.sin(zeta)
        g = torch.where(r > 0.0, s / torch.clamp(r, min=1e-30), q)
        n = torch.where(r <= 180.0, torch.cos(zeta), math.nan)
        return -g * y + 0.0 * n, g * x + 0.0 * n, n

    def plane_from_native(self, phi, theta):
        """Native spherical (rad) -> projection-plane (x, y) degrees;
        unprojectable directions yield NaN."""
        r = _r_from_theta(self.projection, theta)
        return r * torch.sin(phi), -r * torch.cos(phi)


class TanWcs(ZenithalWcs):
    """TAN-only WCS container — the contract of the fused georef fast path
    (astrometry.net always emits RA---TAN/DEC--TAN solutions)."""

    def __init__(self, header):
        if not (
            header.get("CTYPE1") == "RA---TAN"
            and header.get("CTYPE2") == "DEC--TAN"
        ):
            raise ValueError(
                "only RA---TAN/DEC--TAN with LATPOLE=0 is supported; got "
                f"{header.get('CTYPE1')}/{header.get('CTYPE2')} "
                "(generic zenithal projections: use ZenithalWcs + pix2world)"
            )
        super().__init__(header)


class CylindricalWcs:
    """Host-side container for a cylindrical-projection WCS solution.

    Covers the common cylindrical family — CAR (plate carree), CEA
    (cylindrical equal area, PV2_1 = lambda), MER (Mercator) — which the
    reference reaches only through its astropy fallback (reference
    wcs.py:18-64). Exposes the same surface as :class:`ZenithalWcs`
    (attrs + native_from_plane/plane_from_native), so :func:`pix2world`,
    :func:`world2pix` and :func:`pix2world_cartesian` work unchanged.

    Cylindrical projections have their fiducial point at native
    (phi0, theta0) = (0, 0) — NOT at the native pole — so the native pole
    (alpha_p, delta_p) must be solved from CRVAL + LONPOLE/LATPOLE
    (FITS Paper II eqs. 8-10, specialized to theta0 = 0, phi0 = 0):

        delta_p = t +- acos(sin(dec0) / |cos(phi_p)|),
                  t = 0 if cos(phi_p) > 0 else pi
        alpha_p = ra0 - atan2(sin(phi_p), -sin(delta_p) cos(phi_p))

    with the +-branch chosen closest to LATPOLE (default +90). The
    native->celestial rotation is then the same Euler z-x-z matrix as the
    zenithal case, parameterized by (alpha_p, delta_p, LONPOLE).
    """

    SUPPORTED = ("CAR", "CEA", "MER", "CYP")

    def __init__(self, header):
        _parse_celestial_header(self, header, "cylindrical")
        code = self.projection
        # CEA's lambda: PV2_1 (wcslib) with 1.0 (Lambert) default
        self.cea_lambda = float(header.get("PV2_1", 1.0))
        if code == "CEA" and not 0.0 < self.cea_lambda <= 1.0:
            raise ValueError(f"CEA PV2_1 must be in (0, 1]; got "
                             f"{self.cea_lambda}")
        # CYP (cylindrical perspective, Paper II section 5.2.1):
        # PV2_1 = mu (projection point at -mu radii on the axis),
        # PV2_2 = lambda (cylinder radius in spherical radii); both
        # default 1 (Gall's stereographic is mu=1, lambda=sqrt(2)/2)
        self.cyp_mu = float(header.get("PV2_1", 1.0)) if code == "CYP" \
            else None
        self.cyp_lambda = float(header.get("PV2_2", 1.0)) if code == "CYP" \
            else None
        if code == "CYP":
            if self.cyp_lambda <= 0.0:
                raise ValueError(f"CYP PV2_2 (lambda) must be positive; "
                                 f"got {self.cyp_lambda}")
            if abs(self.cyp_mu + self.cyp_lambda) < 1e-12:
                raise ValueError(
                    f"CYP PV2_1 (mu) = -PV2_2 (lambda) = {self.cyp_mu} "
                    "puts the projection point on the cylinder")
        _finish_native_pole(self, header, 0.0)

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta) radians
        (FITS Paper II section 5.2)."""
        if self.projection == "CYP":
            phi = (x / self.cyp_lambda) * _RAD_PER_R
            eta = y * _RAD_PER_R / (self.cyp_mu + self.cyp_lambda)
            s = eta * self.cyp_mu / torch.sqrt(eta * eta + 1.0)
            # |s| > 1 -> NaN (off the map for |mu| > 1)
            theta = torch.atan(eta) + torch.asin(
                torch.where(torch.abs(s) <= 1.0, s, math.nan))
            return phi, theta
        phi = x * _RAD_PER_R
        if self.projection == "CAR":
            theta = y * _RAD_PER_R
        elif self.projection == "CEA":
            s = y * _RAD_PER_R * self.cea_lambda
            theta = torch.asin(s)  # |s| > 1 -> NaN (outside the map)
        else:  # MER
            theta = 2.0 * torch.atan(torch.exp(y * _RAD_PER_R)) - math.pi / 2
        return phi, theta

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y) degrees.

        phi is wrapped into [-180, 180) so world2pix lands on the
        principal map copy around CRPIX.
        """
        x = torch.remainder(torch.rad2deg(phi) + 180.0, 360.0) - 180.0
        if self.projection == "CAR":
            y = torch.rad2deg(theta)
        elif self.projection == "CEA":
            y = torch.rad2deg(torch.sin(theta)) / self.cea_lambda
        elif self.projection == "CYP":
            den = self.cyp_mu + torch.cos(theta)
            y = ((180.0 / math.pi) * (self.cyp_mu + self.cyp_lambda)
                 * torch.sin(theta) / torch.where(den > 0.0, den, math.nan))
            return x * self.cyp_lambda, y
        else:  # MER: y = (180/pi) ln tan(pi/4 + theta/2); poles -> +-inf
            y = torch.rad2deg(torch.log(torch.tan(math.pi / 4 + theta / 2.0)))
        return x, y


class ConicWcs:
    """Host-side container for a conic-projection WCS solution.

    Covers the FITS conic family (Paper II section 5.3) — COP (conic
    perspective), COE (conic equal area / Albers), COD (conic
    equidistant), COO (conic orthomorphic / Lambert conformal) — which
    the reference reaches only through its astropy fallback (reference
    wcs.py:18-64). Same surface as :class:`ZenithalWcs`
    (native_from_plane / plane_from_native), so :func:`pix2world`,
    :func:`world2pix` and :func:`pix2world_cartesian` work unchanged.

    All four share the conic form about the cone constant C:

        x = R(theta) sin(C phi),  y = -R(theta) cos(C phi) + Y0

    with Y0 = R(theta_a) so the fiducial native point (0, theta_a) lands
    on the origin; theta_a = PV2_1 (required), eta = PV2_2 (default 0)
    give standard parallels theta_a -+ eta. The fiducial has
    theta0 = theta_a != 90, so the native pole comes from the general
    Paper II eqs. 8-10 (:func:`_native_pole`).
    """

    SUPPORTED = ("COP", "COE", "COD", "COO")

    def __init__(self, header):
        _parse_celestial_header(self, header, "conic")
        code = self.projection
        if "PV2_1" not in header:
            raise ValueError(
                f"conic projection {code} requires PV2_1 (theta_a, the "
                "midpoint of the standard parallels)")
        self.theta_a = float(header["PV2_1"])
        self.eta = float(header.get("PV2_2", 0.0))
        if not 0.0 < abs(self.theta_a) <= 90.0:
            raise ValueError(f"conic PV2_1 must be in (0, 90]; got "
                             f"{self.theta_a} (theta_a = 0 degenerates "
                             "the cone into a cylinder — use CAR/CEA/MER)")
        th1, th2 = self.theta_a - self.eta, self.theta_a + self.eta
        if not (-90.0 <= th1 <= 90.0 and -90.0 <= th2 <= 90.0):
            raise ValueError(
                f"standard parallels theta_a -+ eta = {th1}, {th2} out of "
                "[-90, 90]")
        # Paper II default for theta0 = theta_a:
        # LONPOLE 0 if dec0 >= theta_a else 180
        _finish_native_pole(self, header, self.theta_a)

        # cone constants (host float64, radians internally)
        ta, e = np.deg2rad(self.theta_a), np.deg2rad(self.eta)
        t1, t2 = ta - e, ta + e
        deg = 180.0 / math.pi
        if code == "COP":
            if abs(self.eta) >= 90.0:
                raise ValueError(f"COP PV2_2 must satisfy |eta| < 90; got "
                                 f"{self.eta}")
            self.C = np.sin(ta)
            self._cope = np.cos(e)
            self.Y0 = deg * self._cope / np.tan(ta)
        elif code == "COE":
            self.C = (np.sin(t1) + np.sin(t2)) / 2.0
            self._s1s2 = np.sin(t1) * np.sin(t2)
            self.Y0 = (deg / self.C) * np.sqrt(
                1.0 + self._s1s2 - 2.0 * self.C * np.sin(ta))
        elif code == "COD":
            if abs(self.eta) > 1e-12:
                self.C = np.sin(ta) * np.sin(e) / e
                self.Y0 = deg * e / np.tan(e) / np.tan(ta)
            else:
                self.C = np.sin(ta)
                self.Y0 = deg / np.tan(ta)
        else:  # COO: Lambert conformal; R = psi * tan((90-theta)/2)^C
            tau1 = np.tan((math.pi / 2 - t1) / 2.0)
            tau2 = np.tan((math.pi / 2 - t2) / 2.0)
            if abs(self.eta) > 1e-12:
                if not (abs(th1) < 90.0 - 1e-9 and abs(th2) < 90.0 - 1e-9):
                    raise ValueError(
                        "COO with two standard parallels requires both "
                        f"strictly inside (-90, 90); got {th1}, {th2}")
                self.C = (np.log(np.cos(t2) / np.cos(t1))
                          / np.log(tau2 / tau1))
            else:
                self.C = np.sin(ta)
            if abs(self.eta) <= 1e-12 and tau1 < 1e-12:
                # theta_1 = 90: cos(t1)/tan((90-t1)/2) -> 2, C -> 1 — the
                # exact STG (stereographic) limit of the conformal cone
                self._psi = 2.0 * deg
            else:
                self._psi = deg * np.cos(t1) / (self.C * tau1 ** self.C)
            self.Y0 = self._psi * np.tan((math.pi / 2 - ta) / 2.0) ** self.C
        # plain Python floats: a numpy float64 would do, but a float can
        # never promote a float32 call
        for k in ("C", "Y0", "_cope", "_s1s2", "_psi"):
            if hasattr(self, k):
                setattr(self, k, float(getattr(self, k)))

    def _r_from_theta(self, theta):
        """Conic R(theta) in projection-plane degrees (theta radians)."""
        ta = math.radians(self.theta_a)
        deg = 180.0 / math.pi
        if self.projection == "COP":
            # perspective from the sphere centre onto the secant cone:
            # valid only within a quarter turn of theta_a
            d = theta - ta
            r = deg * self._cope * (1.0 / math.tan(ta) - torch.tan(d))
            return torch.where(torch.abs(d) < math.pi / 2, r, math.nan)
        if self.projection == "COE":
            s = 1.0 + self._s1s2 - 2.0 * self.C * torch.sin(theta)
            return (deg / self.C) * torch.sqrt(torch.clamp(s, min=0.0))
        if self.projection == "COD":
            return self.Y0 + (self.theta_a - torch.rad2deg(theta))
        # COO
        return self._psi * torch.tan((math.pi / 2 - theta) / 2.0) ** self.C

    def _theta_from_r(self, r):
        """Inverse of :meth:`_r_from_theta` (r degrees -> theta radians);
        out-of-domain radii yield NaN."""
        ta = math.radians(self.theta_a)
        rad = math.pi / 180.0
        if self.projection == "COP":
            th = ta + torch.atan(1.0 / math.tan(ta) - r * rad / self._cope)
            return torch.where(torch.abs(th) <= math.pi / 2, th, math.nan)
        if self.projection == "COE":
            s = (1.0 + self._s1s2 - (self.C * r * rad) ** 2) / (2.0 * self.C)
            return torch.asin(s)  # |s| > 1 -> NaN (outside the map)
        if self.projection == "COD":
            th = torch.deg2rad(self.theta_a + self.Y0 - r)
            return torch.where(torch.abs(th) <= math.pi / 2, th, math.nan)
        # COO: R = psi tau^C, tau = tan((90-theta)/2) >= 0
        tau = (r / self._psi) ** (1.0 / self.C)
        return math.pi / 2 - 2.0 * torch.atan(tau)

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta) radians
        (FITS Paper II section 5.3); off-cone points yield NaN."""
        dy = self.Y0 - y
        r = math.copysign(1.0, self.theta_a) * torch.hypot(x, dy)
        # r == 0 is the cone apex: phi undefined, keep theta if exact
        phi = torch.atan2(x / r, dy / r) / self.C
        return phi, self._theta_from_r(r)

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y) degrees."""
        r = self._r_from_theta(theta)
        a = self.C * phi
        return r * torch.sin(a), self.Y0 - r * torch.cos(a)


class PseudoCylindricalWcs:
    """Host-side container for a pseudo-cylindrical-projection WCS.

    Covers the FITS pseudo-cylindrical family (Paper II section 5.4) —
    SFL (Sanson-Flamsteed/sinusoidal), PAR (parabolic/Craster), MOL
    (Mollweide), AIT (Hammer-Aitoff) — the all-sky equal-area projections
    the reference reaches only through its astropy fallback (reference
    wcs.py:18-64). Same surface as :class:`ZenithalWcs`
    (native_from_plane / plane_from_native), so :func:`pix2world`,
    :func:`world2pix` and :func:`pix2world_cartesian` work unchanged.

    Like the cylindrical family these have their fiducial at native
    (phi0, theta0) = (0, 0), so the native pole comes from the general
    Paper II eqs. 8-10 solve (:func:`_native_pole` at theta0 = 0); x
    additionally depends on theta (the meridians converge).

    MOL's forward y(theta) requires solving the transcendental
    2 gamma + sin 2 gamma = pi sin theta — done with a fixed-iteration
    Newton (init gamma = theta; the derivative 2 + 2 cos 2 gamma only
    vanishes at the poles, where the init is already the root).
    """

    SUPPORTED = ("SFL", "PAR", "MOL", "AIT")

    def __init__(self, header):
        _parse_celestial_header(self, header, "pseudo-cylindrical")
        _finish_native_pole(self, header, 0.0)

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta) radians
        (FITS Paper II section 5.4); out-of-map points yield NaN."""
        if self.projection == "SFL":
            theta = y * _RAD_PER_R
            theta = torch.where(torch.abs(theta) <= math.pi / 2, theta, math.nan)
            phi = x * _RAD_PER_R / torch.cos(theta)
            return phi, theta
        if self.projection == "PAR":
            theta = 3.0 * torch.asin(y / 180.0)
            theta = torch.where(torch.abs(theta) <= math.pi / 2, theta, math.nan)
            phi = x * _RAD_PER_R / (2.0 * torch.cos(2.0 * theta / 3.0) - 1.0)
            return phi, theta
        if self.projection == "MOL":
            sg = y * math.pi / (180.0 * math.sqrt(2.0))
            g = torch.asin(sg)  # |y| beyond the map rim -> NaN
            theta = torch.asin((2.0 * g + torch.sin(2.0 * g)) / math.pi)
            phi = x * _RAD_PER_R * math.pi / (2.0 * math.sqrt(2.0)
                                             * torch.cos(g))
            return phi, theta
        # AIT (Paper II eqs. 105-107, radian plane coordinates)
        X = x * _RAD_PER_R
        Y = y * _RAD_PER_R
        z2 = 1.0 - (X / 4.0) ** 2 - (Y / 2.0) ** 2
        # principal ellipse: Z^2 >= 1/2 (outside lies no valid (phi, theta))
        z2 = torch.where(z2 >= 0.5, z2, math.nan)
        z = torch.sqrt(z2)
        theta = torch.asin(Y * z)
        phi = 2.0 * torch.atan2(z * X / 2.0, 2.0 * z2 - 1.0)
        return phi, theta

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y) degrees.

        phi is wrapped into [-pi, pi) so world2pix lands on the principal
        map copy around CRPIX.
        """
        phi = torch.remainder(phi + math.pi, 2.0 * math.pi) - math.pi
        deg = 180.0 / math.pi
        if self.projection == "SFL":
            return deg * phi * torch.cos(theta), deg * theta
        if self.projection == "PAR":
            return (deg * phi * (2.0 * torch.cos(2.0 * theta / 3.0) - 1.0),
                    180.0 * torch.sin(theta / 3.0))
        if self.projection == "MOL":
            g = _mol_gamma(theta)
            x = (2.0 * math.sqrt(2.0) / math.pi) * deg * phi * torch.cos(g)
            y = math.sqrt(2.0) * deg * torch.sin(g)
            return x, y
        # AIT
        gf = torch.sqrt(2.0 / (1.0 + torch.cos(theta) * torch.cos(phi / 2.0)))
        x = 2.0 * deg * gf * torch.cos(theta) * torch.sin(phi / 2.0)
        y = deg * gf * torch.sin(theta)
        return x, y


class GeneralZenithalWcs(ZenithalWcs):
    """The remaining zenithal projections — AZP (zenithal perspective,
    tilted), SZP (slant zenithal perspective), ZPN (zenithal polynomial),
    AIR (Airy) — completing the zenithal family of FITS Paper II section
    5.1 (the reference reaches these only through its astropy fallback,
    reference wcs.py:18-64).

    All four share the zenithal fiducial (phi0, theta0) = (0, 90), so the
    native pole is CRVAL and the celestial rotation is identical to
    :class:`ZenithalWcs`; only the plane <-> native maps differ. AZP and
    SZP are not radially symmetric (the tilt/slant breaks it), so they
    override the full maps rather than the radial law:

    AZP (PV2_1 = mu >= 0 distance of the projection point behind the
    sphere centre in radii, PV2_2 = gamma tilt of the plane in degrees):
        R = (180/pi) (mu+1) cos(theta)
            / (mu + sin(theta) + cos(theta) cos(phi) tan(gamma))
        x = R sin(phi), y = -R cos(phi)/cos(gamma)
    inverted through rho = R' / ((180/pi)(mu+1) + y sin(gamma)),
    psi = arg(rho, 1), omega = asin(rho mu / sqrt(rho^2+1)),
    theta = psi - omega (the solution nearer the pole; the second branch
    psi + omega - 180 is used when the first leaves [-90, 90]).
    mu = 0 is exactly TAN, mu = 1 exactly STG, mu -> inf approaches SIN.

    SZP (PV2_1 = mu, PV2_2 = phi_c, PV2_3 = theta_c): projection from the
    point P = -mu * unit(phi_c, theta_c) onto the plane z = 1 (native
    cartesian x = cos th sin phi, y = -cos th cos phi, z = sin th).
    Implemented geometrically: the forward map is the ray-plane
    intersection, the inverse the ray-sphere quadratic with the
    more-poleward root. theta_c = 90 reduces exactly to AZP(mu, gamma=0).

    ZPN (PV2_0..PV2_20 = polynomial coefficients P_m):
        R = (180/pi) * sum_m P_m * zeta^m,  zeta = (90 - theta) in rad
    valid out to the first stationary point of the polynomial (computed
    host-side; beyond it the law is not invertible). The inverse is a
    grid-seeded Newton solve (:func:`_invert_monotone_radial`).
    P_1 = 1 with all others zero is exactly ARC.

    AIR (PV2_1 = theta_b, default 90):
        R = -2 (180/pi) [ ln(cos xi)/tan(xi)
                          + (ln(cos xi_b)/tan^2(xi_b)) tan(xi) ],
        xi = (90 - theta)/2, with the xi_b -> 0 limit coefficient -1/2.
    Inverse by the same grid-seeded Newton.
    """

    SUPPORTED = ("AZP", "SZP", "ZPN", "AIR")

    def __init__(self, header):
        super().__init__(header)
        code = self.projection
        if code == "AZP":
            self.mu = float(header.get("PV2_1", 0.0))
            self.gamma = float(header.get("PV2_2", 0.0))
            if self.mu == -1.0:
                raise ValueError("AZP PV2_1 (mu) = -1 puts the projection "
                                 "point on the plane")
            if not abs(self.gamma) < 90.0:
                raise ValueError(f"AZP PV2_2 (gamma) must satisfy "
                                 f"|gamma| < 90; got {self.gamma}")
        elif code == "SZP":
            self.mu = float(header.get("PV2_1", 0.0))
            self.phi_c = float(header.get("PV2_2", 0.0))
            self.theta_c = float(header.get("PV2_3", 90.0))
            tc = np.deg2rad(self.theta_c)
            pc = np.deg2rad(self.phi_c)
            # projection point P = -mu * unit(phi_c, theta_c); zp is the
            # Paper II card-level constant 1 - P_z
            self.xp = -self.mu * np.cos(tc) * np.sin(pc)
            self.yp = self.mu * np.cos(tc) * np.cos(pc)
            self.zp = self.mu * np.sin(tc) + 1.0
            self.xp, self.yp, self.zp = (float(v) for v in
                                         (self.xp, self.yp, self.zp))
            if abs(self.zp) < 1e-12:
                raise ValueError(
                    f"SZP projection point lies in the projection plane "
                    f"(mu={self.mu}, theta_c={self.theta_c})")
        elif code == "ZPN":
            coeffs = [float(header.get(f"PV2_{m}", 0.0)) for m in range(21)]
            while len(coeffs) > 1 and coeffs[-1] == 0.0:
                coeffs.pop()
            if not any(c != 0.0 for c in coeffs[1:]):
                raise ValueError("ZPN needs at least one nonzero PV2_m "
                                 "coefficient with m >= 1")
            self.poly = np.asarray(coeffs, dtype=np.float64)
            self._dpoly = self.poly[1:] * np.arange(1, len(self.poly))
            # monotone validity range: out to the derivative's first
            # nonpositive point on (0, pi] (host-side dense scan)
            zs = np.linspace(0.0, math.pi, 8193)
            dv = np.polyval(self._dpoly[::-1], zs)
            if dv[1] <= 0.0:
                raise ValueError(
                    f"ZPN polynomial {coeffs} is not increasing at the "
                    "pole — not an invertible radial law")
            bad = np.nonzero(dv <= 0.0)[0]
            bad = bad[bad > 0]
            self.zeta_max = float(zs[bad[0] - 1]) if bad.size else math.pi
        else:  # AIR
            self.theta_b = float(header.get("PV2_1", 90.0))
            if not -90.0 < self.theta_b <= 90.0:
                raise ValueError(f"AIR PV2_1 (theta_b) must be in "
                                 f"(-90, 90]; got {self.theta_b}")
            xib = np.deg2rad(90.0 - self.theta_b) / 2.0
            self.air_c = float(np.log(np.cos(xib)) / np.tan(xib) ** 2
                               if xib > 1e-6 else -0.5)
            # monotone validity range of R(xi) on [0, pi/2)
            xs = np.linspace(0.0, math.pi / 2 - 1e-6, 8193)[1:]
            dr = (-2.0) * (-1.0 - np.log(np.cos(xs)) / np.sin(xs) ** 2
                           + self.air_c / np.cos(xs) ** 2)
            bad = np.nonzero(dr <= 0.0)[0]
            if bad.size and bad[0] == 0:
                # unreachable for the accepted theta_b range (dr -> 1 -
                # 2*air_c > 0 at xi -> 0); enforce the invariant loudly
                # rather than wrap bad[0]-1 to xs[-1] (the OPPOSITE of
                # the correct near-zero validity bound)
                raise ValueError(
                    f"AIR radial law is not increasing at the pole for "
                    f"theta_b={self.theta_b} — not an invertible R(xi)")
            self.xi_max = float(xs[bad[0] - 1]) if bad.size else float(xs[-1])

    # -- AIR / ZPN radial laws (zeta-or-xi in radians -> R in degrees) --

    def _zpn_r(self, zeta):
        return (180.0 / math.pi) * _horner(self.poly, zeta)

    def _zpn_dr(self, zeta):
        return (180.0 / math.pi) * _horner(self._dpoly, zeta)

    def _air_r(self, xi):
        t = torch.tan(xi)
        term = torch.where(xi > 1e-6,
                         torch.log(torch.cos(torch.where(xi > 1e-6, xi, 0.0))) /
                         torch.where(xi > 1e-6, t, 1.0),
                         -xi / 2.0)
        return -2.0 * (180.0 / math.pi) * (term + self.air_c * t)

    def _air_dr(self, xi):
        s2 = torch.sin(xi) ** 2
        term = torch.where(xi > 1e-6,
                         torch.log(torch.cos(torch.where(xi > 1e-6, xi, 0.0))) /
                         torch.where(xi > 1e-6, s2, 1.0),
                         -0.5)
        return -2.0 * (180.0 / math.pi) * (
            -1.0 - term + self.air_c / torch.cos(xi) ** 2)

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta) radians
        (FITS Paper II section 5.1); out-of-domain points yield NaN."""
        code = self.projection
        deg = 180.0 / math.pi
        if code == "AZP":
            g = math.radians(self.gamma)
            phi = torch.atan2(x, -y * math.cos(g))
            rr = torch.hypot(x, y * math.cos(g))
            rho = rr / (deg * (self.mu + 1.0) + y * math.sin(g))
            psi = torch.atan2(torch.ones_like(rho), rho)
            s = rho * self.mu / torch.sqrt(rho * rho + 1.0)
            om = torch.asin(torch.where(torch.abs(s) <= 1.0, s, math.nan))
            t1 = psi - om
            t2 = psi + om - math.pi
            hp = math.pi / 2 + 1e-12
            theta = torch.where(torch.abs(t1) <= hp, t1,
                              torch.where(torch.abs(t2) <= hp, t2, math.nan))
            return phi, torch.clip(theta, -math.pi / 2, math.pi / 2)
        if code == "SZP":
            X = x * _RAD_PER_R
            Y = y * _RAD_PER_R
            pz = 1.0 - self.zp
            dx = X - self.xp
            dy = Y - self.yp
            dz = self.zp  # 1 - pz
            a = dx * dx + dy * dy + dz * dz
            b = self.xp * dx + self.yp * dy + pz * dz
            c = self.xp ** 2 + self.yp ** 2 + pz ** 2 - 1.0
            disc = b * b - a * c
            root = torch.sqrt(torch.where(disc >= 0.0, disc, math.nan))
            u = (-b + math.copysign(1.0, dz) * root) / a  # more-poleward intersection
            sx = self.xp + u * dx
            sy = self.yp + u * dy
            sz = pz + u * dz
            phi = torch.atan2(sx, -sy)
            theta = torch.asin(torch.clip(sz, -1.0, 1.0))
            return phi, torch.where(torch.isnan(root), math.nan, theta)
        phi = torch.atan2(x, -y)
        rr = torch.hypot(x, y)
        if code == "ZPN":
            zeta = _invert_monotone_radial(
                self._zpn_r, self._zpn_dr, rr, self.zeta_max)
            return phi, math.pi / 2 - zeta
        xi = _invert_monotone_radial(
            self._air_r, self._air_dr, rr, self.xi_max)
        return phi, math.pi / 2 - 2.0 * xi

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y) degrees;
        invisible/unprojectable directions yield NaN."""
        code = self.projection
        deg = 180.0 / math.pi
        if code == "AZP":
            g = math.radians(self.gamma)
            den = (self.mu + torch.sin(theta)
                   + torch.cos(theta) * torch.cos(phi) * math.tan(g))
            rr = deg * (self.mu + 1.0) * torch.cos(theta) / den
            vis = den > 0.0
            if abs(self.mu) > 1.0:
                # the horizon seen from the projection point: the far cap
                # around the native pole is the mapped side
                vis &= torch.sin(theta) >= -1.0 / self.mu
            rr = torch.where(vis, rr, math.nan)
            return rr * torch.sin(phi), -rr * torch.cos(phi) / math.cos(g)
        if code == "SZP":
            sx = torch.cos(theta) * torch.sin(phi)
            sy = -torch.cos(theta) * torch.cos(phi)
            sz = torch.sin(theta)
            pz = 1.0 - self.zp
            den = sz - pz
            t = self.zp / den
            vis = t > 0.0
            qx = torch.where(vis, self.xp + t * (sx - self.xp), math.nan)
            qy = torch.where(vis, self.yp + t * (sy - self.yp), math.nan)
            return deg * qx, deg * qy
        if code == "ZPN":
            zeta = math.pi / 2 - theta
            rr = torch.where(zeta <= self.zeta_max + 1e-12,
                           self._zpn_r(zeta), math.nan)
        else:  # AIR
            xi = (math.pi / 2 - theta) / 2.0
            rr = torch.where(xi <= self.xi_max + 1e-12,
                           self._air_r(xi), math.nan)
        return rr * torch.sin(phi), -rr * torch.cos(phi)


def _horner(coeffs, x):
    """Polynomial sum_m coeffs[m] x^m by Horner's rule; the coefficients
    ride as Python floats, so the result has the dtype of ``x``."""
    acc = torch.zeros_like(x)
    for c in reversed([float(c) for c in coeffs]):
        acc = acc * x + c
    return acc


def _interp(x, xp, fp):
    """Piecewise-linear interpolant of the increasing samples (xp, fp) at
    ``x``, clamped to fp[0]/fp[-1] outside [xp[0], xp[-1]] as
    ``numpy.interp`` clamps; NaN stays NaN."""
    i = torch.clip(torch.searchsorted(xp, x.contiguous(), right=True),
                   1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    flat = torch.abs(dx) <= torch.finfo(xp.dtype).tiny
    f = torch.where(flat, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _invert_monotone_radial(f, df, target, x_max, n_grid=256, n_newton=4):
    """Invert a monotone-increasing radial law f on [0, x_max].

    Seeds by inverse linear interpolation on a fixed grid, then polishes
    with Newton steps (f and df must be jnp-traceable). Targets outside
    [f(0), f(x_max)] return NaN. Used by the ZPN/AIR/PCO inverses where
    FITS Paper II gives no closed form.
    """
    xs = torch.linspace(0.0, x_max, n_grid, dtype=target.dtype,
                        device=target.device)
    fx = f(xs)
    x = _interp(target, fx, xs)
    for _ in range(n_newton):
        d = df(x)
        step = torch.where(torch.abs(d) > 1e-14, (f(x) - target) / d, 0.0)
        x = torch.clip(x - step, 0.0, x_max)
    eps = 1e-9 * (torch.abs(fx[-1]) + 1.0)
    ok = (target >= fx[0] - eps) & (target <= fx[-1] + eps)
    return torch.where(ok, x, math.nan)


def _mol_gamma(theta, iters=12):
    """Solve Mollweide's 2g + sin 2g = pi sin(theta) for g by Newton.

    Init g = theta; the derivative 2 + 2 cos 2g vanishes only at the
    poles, where g = theta is already the exact root (guarded divisor
    keeps the iteration a no-op there). 12 iterations reach f64
    round-off over the whole open interval.
    """
    target = math.pi * torch.sin(theta)
    g = theta
    for _ in range(iters):
        f = 2.0 * g + torch.sin(2.0 * g) - target
        df = 2.0 + 2.0 * torch.cos(2.0 * g)
        g = g - f / torch.clamp(df, min=1e-14)
    return g


class PseudoConicWcs:
    """Host-side container for the FITS pseudo-conic projections — BON
    (Bonne equal area, PV2_1 = theta_1 != 0) and PCO (polyconic) — FITS
    Paper II section 5.5 (the reference reaches these only through its
    astropy fallback, reference wcs.py:18-64). Same surface as
    :class:`ZenithalWcs`, so :func:`pix2world`/:func:`world2pix` work
    unchanged.

    Both have their fiducial at native (phi0, theta0) = (0, 0), so the
    native pole comes from the general Paper II eqs. 8-10
    (:func:`_native_pole`).

    BON: R = Y0 - theta_deg with Y0 = (180/pi) cot(theta_1) + theta_1_deg;
    A = (180/pi) phi cos(theta) / R; (x, y) = (R sin A, Y0 - R cos A).
    theta_1 = +-90 is Werner's projection; theta_1 -> 0 degenerates to
    SFL (use SFL — theta_1 = 0 is refused).

    PCO: x = (180/pi) cot(theta) sin(E), y = (180/pi) (theta +
    cot(theta) (1 - cos E)), E = phi sin(theta); each parallel is a
    circular arc of radius cot(theta) centred on (0, theta + cot theta),
    true-scale along the central meridian. The inverse solves
    tan(theta) (X^2 + (Y-theta)^2) = 2 (Y-theta) by grid-seeded Newton.
    """

    SUPPORTED = ("BON", "PCO")

    def __init__(self, header):
        _parse_celestial_header(self, header, "pseudo-conic")
        code = self.projection
        if code == "BON":
            if "PV2_1" not in header:
                raise ValueError("BON requires PV2_1 (theta_1, the "
                                 "standard parallel)")
            self.theta_1 = float(header["PV2_1"])
            if not 0.0 < abs(self.theta_1) <= 90.0:
                raise ValueError(
                    f"BON PV2_1 must be in (0, 90]; got {self.theta_1} "
                    "(theta_1 = 0 degenerates to the sinusoidal — "
                    "use SFL)")
            t1 = np.deg2rad(self.theta_1)
            self.Y0 = float((180.0 / math.pi) * np.cos(t1) / np.sin(t1)
                            + self.theta_1)
        _finish_native_pole(self, header, 0.0)

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta) radians
        (FITS Paper II section 5.5); out-of-domain points yield NaN."""
        deg = 180.0 / math.pi
        if self.projection == "BON":
            s = math.copysign(1.0, self.theta_1)
            rr = s * torch.hypot(x, self.Y0 - y)
            theta = torch.deg2rad(self.Y0 - rr)
            theta = torch.where(torch.abs(theta) <= math.pi / 2 + 1e-12,
                              theta, math.nan)
            a = torch.atan2(x / rr, (self.Y0 - y) / rr)  # radians
            ct = torch.cos(theta)
            phi = torch.where(ct > 1e-12, a * rr / (deg * ct), 0.0)
            return phi, theta
        # PCO
        X = x * _RAD_PER_R
        Y = y * _RAD_PER_R
        # solve g(th) = tan(th) (X^2 + (Y-th)^2) - 2 (Y-th) = 0.
        # g is strictly increasing: g' = sec^2(X^2+d^2) - 2 tan(th) d + 2
        # >= (sec d - sin)^2 + 2 - sin^2 >= 1, so bisection is safe and
        # memory-flat (an earlier grid-scan version materialized
        # (npix, 512) temporaries — OOM on full frames)
        lim = math.pi / 2 - 1e-6

        def g_of(th):
            d = Y - th
            return torch.tan(th) * (X * X + d * d) - 2.0 * d

        lo = torch.full_like(X, -lim)
        hi = torch.full_like(X, lim)
        for _ in range(45):
            mid = 0.5 * (lo + hi)
            neg = g_of(mid) < 0.0
            lo = torch.where(neg, mid, lo)
            hi = torch.where(neg, hi, mid)
        th = 0.5 * (lo + hi)
        for _ in range(2):
            d = Y - th
            g = torch.tan(th) * (X * X + d * d) - 2.0 * d
            dg = (X * X + d * d) / torch.cos(th) ** 2 \
                - 2.0 * torch.tan(th) * d + 2.0
            th = torch.clip(th - g / dg, -lim, lim)
        tanth = torch.tan(th)
        e = torch.atan2(X * tanth, 1.0 - (Y - th) * tanth)
        small = torch.abs(Y) < 1e-9
        phi = torch.where(small, X,
                        e / torch.where(small, 1.0, torch.sin(th)))
        theta = torch.where(small, 0.0, th)
        return phi, theta

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y) degrees.

        phi is wrapped into [-pi, pi) so world2pix lands on the principal
        map copy around CRPIX.
        """
        phi = torch.remainder(phi + math.pi, 2.0 * math.pi) - math.pi
        deg = 180.0 / math.pi
        if self.projection == "BON":
            rr = self.Y0 - torch.rad2deg(theta)
            # the arc angle E = phi cos(theta) / rho with rho = rr in
            # radians, i.e. (180/pi) phi cos(theta) / rr — already radians
            e = deg * phi * torch.cos(theta) / rr
            return rr * torch.sin(e), self.Y0 - rr * torch.cos(e)
        # PCO
        st = torch.sin(theta)
        safe = torch.abs(st) > 1e-9
        cot = torch.cos(theta) / torch.where(safe, st, 1.0)
        e = phi * st
        x = torch.where(safe, cot * torch.sin(e), phi)
        y = torch.where(safe, theta + cot * (1.0 - torch.cos(e)), 0.0)
        return deg * x, deg * y


class QuadCubeWcs:
    """Host-side container for the closed-form quad-cube projections —
    TSC (tangential spherical cube: gnomonic per face) and QSC
    (quadrilateralized spherical cube: the exactly equal-area O'Neill &
    Laubscher closed form) — FITS Paper II section 5.6 (the reference
    reaches these only through its astropy fallback, reference
    wcs.py:18-64). CSC, the COBE polynomial *approximation* of the same
    cube, is deliberately unsupported: its defining coefficient tables
    are not first-party math (see :func:`make_wcs`), and QSC/TSC cover
    the family exactly.

    Cube layout (Paper II fig. 32): six 90x90-degree faces unfolded as a
    sideways cross — face 1 (centred on native (0, 0)) at plane (0, 0),
    faces 2, 3, 4 (centres at native longitude 90, 180, 270) at x = 90,
    180, 270, face 0 (north) at (0, +90), face 5 (south) at (0, -90).
    On the inverse path x is normalized into [-45, 315) so a header that
    draws face 4 at x = -90 still decodes. Face-local direction cosines
    (xi, eta, zeta) with zeta toward the face centre:

        face 0: (m, -l, n)   face k=1..4 (centre phi_k): rotate l, m by
        face 5: (m,  l, -n)  phi_k: (cos th sin(phi-phi_k), sin th, ...)

    chosen so every unfolded edge (0-1, 1-2, 2-3, 3-4, 5-1) is
    continuous. Fiducial (phi0, theta0) = (0, 0), native pole via the
    general Paper II eqs. 8-10.

    QSC forward on a face (|xi| >= |eta| branch; the other is symmetric):

        omega = eta / xi
        u = sgn(xi) 45 sqrt( (1 - zeta) / (1 - 1/sqrt(2 + omega^2)) )
        v = u (12/pi) [ atan(omega) - asin( omega / sqrt(2 (1+omega^2)) ) ]

    inverted in closed form via omega = sin(psi) / (cos(psi) - 1/sqrt 2),
    psi = (pi/12)(v/u), then zeta = 1 - (u/45)^2 (1 - 1/sqrt(2+omega^2)).
    """

    SUPPORTED = ("TSC", "QSC")

    #: plane offsets of face centres (degrees), faces 0..5
    _X0 = np.array([0.0, 0.0, 90.0, 180.0, 270.0, 0.0])
    _Y0 = np.array([90.0, 0.0, 0.0, 0.0, 0.0, -90.0])

    def __init__(self, header):
        _parse_celestial_header(self, header, "quad-cube")
        _finish_native_pole(self, header, 0.0)

    @staticmethod
    def _face_locals(phi, theta):
        """Direction -> (face index, xi, eta, zeta) arrays."""
        l_ = torch.cos(theta) * torch.cos(phi)
        m_ = torch.cos(theta) * torch.sin(phi)
        n_ = torch.sin(theta)
        # candidates in face order 0..5: the face normal components
        zetas = torch.stack([n_, l_, m_, -l_, -m_, -n_], dim=-1)
        face = torch.argmax(zetas, dim=-1)
        zeta = torch.gather(zetas, -1, face[..., None])[..., 0]
        xis = torch.stack([m_, m_, -l_, -m_, l_, m_], dim=-1)
        etas = torch.stack([-l_, n_, n_, n_, n_, l_], dim=-1)
        xi = torch.gather(xis, -1, face[..., None])[..., 0]
        eta = torch.gather(etas, -1, face[..., None])[..., 0]
        return face, xi, eta, zeta

    @staticmethod
    def _direction_from_locals(face, xi, eta, zeta):
        """(face, xi, eta, zeta) -> native (phi, theta)."""
        ls = torch.stack([-eta, zeta, -xi, -zeta, xi, eta], dim=-1)
        ms = torch.stack([xi, xi, zeta, -xi, -zeta, xi], dim=-1)
        ns = torch.stack([zeta, eta, eta, eta, eta, -zeta], dim=-1)
        l_ = torch.gather(ls, -1, face[..., None])[..., 0]
        m_ = torch.gather(ms, -1, face[..., None])[..., 0]
        n_ = torch.gather(ns, -1, face[..., None])[..., 0]
        phi = torch.atan2(m_, l_)
        theta = torch.asin(torch.clip(n_, -1.0, 1.0))
        return phi, theta

    def _qsc_forward(self, xi, eta, zeta):
        """Face-local cosines -> face-local (u, v) degrees (QSC law)."""
        major = torch.where(torch.abs(xi) >= torch.abs(eta), xi, eta)
        minor = torch.where(torch.abs(xi) >= torch.abs(eta), eta, xi)
        cen = torch.abs(major) < 1e-15  # face centre: u = v = 0
        om = minor / torch.where(cen, 1.0, major)
        t = 1.0 - 1.0 / torch.sqrt(2.0 + om * om)
        u = torch.sign(major) * 45.0 * torch.sqrt(
            torch.clamp(1.0 - zeta, min=0.0) / t)
        v = u * (12.0 / math.pi) * (
            torch.atan(om) - torch.asin(om / torch.sqrt(2.0 + 2.0 * om * om)))
        u = torch.where(cen, 0.0, u)
        v = torch.where(cen, 0.0, v)
        swap = torch.abs(xi) < torch.abs(eta)
        return torch.where(swap, v, u), torch.where(swap, u, v)

    @staticmethod
    def _qsc_inverse(xl, yl):
        """Face-local (x, y) degrees -> face-local cosines (xi, eta,
        zeta) (closed-form QSC inverse)."""
        major = torch.where(torch.abs(xl) >= torch.abs(yl), xl, yl)
        minor = torch.where(torch.abs(xl) >= torch.abs(yl), yl, xl)
        cen = torch.abs(major) < 1e-15
        psi = (math.pi / 12.0) * minor / torch.where(cen, 1.0, major)
        om = torch.sin(psi) / (torch.cos(psi) - 1.0 / math.sqrt(2.0))
        zeta = 1.0 - (major / 45.0) ** 2 * (
            1.0 - 1.0 / torch.sqrt(2.0 + om * om))
        zeta = torch.where(cen, 1.0, zeta)
        s2 = torch.clamp(1.0 - zeta * zeta, min=0.0)
        a = torch.sign(major) * torch.sqrt(s2 / (1.0 + om * om))
        b = om * a
        swap = torch.abs(xl) < torch.abs(yl)
        xi = torch.where(cen, 0.0, torch.where(swap, b, a))
        eta = torch.where(cen, 0.0, torch.where(swap, a, b))
        return xi, eta, zeta

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta)
        radians; points outside the unfolded cross yield NaN."""
        xn = torch.remainder(x + 45.0, 360.0) - 45.0
        on_eq = torch.abs(y) <= 45.0 + 1e-12
        # NaN -> 0 before the integer cast (its result is undefined for
        # NaN; such points are masked below through ``ok``)
        kk = torch.clip(torch.nan_to_num(torch.floor((xn + 45.0) / 90.0)),
                        0.0, 3.0).to(torch.int64)
        polar_ok = torch.abs(xn) <= 45.0 + 1e-12
        face = torch.where(on_eq, kk + 1, torch.where(y > 0, 0, 5))
        ok = on_eq | polar_ok
        xl = torch.where(on_eq, xn - kk.to(xn.dtype) * 90.0, xn)
        yl = torch.where(on_eq, y, y - torch.where(y > 0, 90.0, -90.0))
        ok &= (torch.abs(xl) <= 45.0 + 1e-12) & (torch.abs(yl) <= 45.0 + 1e-12)
        if self.projection == "TSC":
            xi = xl / 45.0
            eta = yl / 45.0
            norm = torch.sqrt(xi * xi + eta * eta + 1.0)
            xi, eta, zeta = xi / norm, eta / norm, 1.0 / norm
        else:
            xi, eta, zeta = self._qsc_inverse(xl, yl)
        phi, theta = self._direction_from_locals(face, xi, eta, zeta)
        bad = ~ok
        return (torch.where(bad, math.nan, phi),
                torch.where(bad, math.nan, theta))

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y)
        degrees on the unfolded cross."""
        face, xi, eta, zeta = self._face_locals(phi, theta)
        if self.projection == "TSC":
            xl = 45.0 * xi / zeta
            yl = 45.0 * eta / zeta
        else:
            xl, yl = self._qsc_forward(xi, eta, zeta)
        x0 = torch.as_tensor(self._X0, dtype=xl.dtype, device=xl.device)[face]
        y0 = torch.as_tensor(self._Y0, dtype=xl.dtype, device=xl.device)[face]
        return x0 + xl, y0 + yl


class HealpixWcs:
    """Host-side container for the HPX (HEALPix) projection — Calabretta
    & Roukema 2007 / wcslib; PV2_1 = H (longitude facets, default 4),
    PV2_2 = K (latitude rows, default 3). The reference reaches HPX only
    through its astropy fallback (reference wcs.py:18-64). Same surface
    as :class:`ZenithalWcs`, so :func:`pix2world`/:func:`world2pix` work
    unchanged.

    With z = sin(theta): the equatorial zone |z| <= (K-1)/K maps as
    x = phi, y = (90 K / H) z; the polar zones map each facet onto a
    triangle: sigma = sqrt(K (1 - |z|)), x = phi_c + (phi - phi_c) sigma,
    y = sign(theta) (90/H) (K + 1 - 2 sigma), where phi_c is the centre
    of the polar facet containing phi. Fiducial (phi0, theta0) = (0, 0).
    """

    SUPPORTED = ("HPX",)

    def __init__(self, header):
        _parse_celestial_header(self, header, "HEALPix")
        self.H = float(header.get("PV2_1", 4.0))
        self.K = float(header.get("PV2_2", 3.0))
        if self.H <= 0.0 or self.K <= 0.0:
            raise ValueError(f"HPX PV2_1 (H) and PV2_2 (K) must be "
                             f"positive; got H={self.H}, K={self.K}")
        _finish_native_pole(self, header, 0.0)

    def _facet_centre(self, xdeg):
        """Longitude of the polar-facet centre containing xdeg."""
        h = self.H
        return -180.0 + (2.0 * torch.floor((xdeg + 180.0) * h / 360.0)
                         + 1.0) * 180.0 / h

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta)
        radians; the polar gores outside the facets yield NaN."""
        h, k = self.H, self.K
        y_eq = 90.0 * (k - 1.0) / h  # |y| at the zone boundary
        eq = torch.abs(y) <= y_eq + 1e-12
        # equatorial zone
        z_e = y * h / (90.0 * k)
        # polar zones
        sig = ((k + 1.0) - torch.abs(y) * h / 90.0) / 2.0
        ok_p = (sig >= -1e-12) & (sig <= 1.0 + 1e-12)
        sig_c = torch.clip(sig, 0.0, 1.0)
        z_p = torch.sign(y) * (1.0 - sig_c * sig_c / k)
        xc = self._facet_centre(x)
        pole = sig_c < 1e-12
        phi_p = torch.where(pole, xc, xc + (x - xc) / torch.where(pole, 1.0,
                                                              sig_c))
        ok_p &= torch.abs(x - xc) <= 180.0 * sig_c / h + 1e-9
        z = torch.where(eq, z_e, z_p)
        phi = torch.deg2rad(torch.where(eq, x, phi_p))
        ok = eq | ok_p
        theta = torch.asin(torch.clip(z, -1.0, 1.0))
        bad = ~ok
        return (torch.where(bad, math.nan, phi),
                torch.where(bad, math.nan, theta))

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y)
        degrees; phi wrapped into [-180, 180)."""
        h, k = self.H, self.K
        pd = torch.remainder(torch.rad2deg(phi) + 180.0, 360.0) - 180.0
        z = torch.sin(theta)
        eq = torch.abs(z) <= (k - 1.0) / k
        y_e = (90.0 * k / h) * z
        sig = torch.sqrt(torch.clamp(k * (1.0 - torch.abs(z)), min=0.0))
        xc = self._facet_centre(pd)
        x_p = xc + (pd - xc) * sig
        y_p = torch.sign(theta) * (90.0 / h) * (k + 1.0 - 2.0 * sig)
        return (torch.where(eq, pd, x_p), torch.where(eq, y_e, y_p))


class XphWcs(ZenithalWcs):
    """HEALPix polar, aka "butterfly" (XPH; Calabretta & Lowe 2013,
    PASA 30): the HEALPix H=4, K=3 map rearranged into four wings around
    the north pole. The reference reaches XPH only through its astropy
    fallback (reference wcs.py:18-64).

    Construction (per-wing rigid motion of the HPX plane): the sphere is
    split into four longitude quarters m = 0..3 with central meridians
    phi_c = 90 m - 135. Within a wing, (u, v) are the HPX facet-column
    coordinates translated so the north pole sits at the origin
    (xi = phi - phi_c in [-45, 45]; with z = sin theta):

      equatorial |z| <= 2/3:  u = xi,        v = 67.5 z - 90
      north z > 2/3:          u = xi sigma,  v = -45 sigma
      south z < -2/3:         u = xi sigma,  v = 45 sigma - 180
      sigma = sqrt(3 (1 - |z|))

    so v runs from 0 (north pole) through -90 (equator) to -180 (south
    pole), matching :class:`HealpixWcs` exactly (u = x_HPX - phi_c,
    v = y_HPX - 90). The wing is then rotated by phi_c — the direct
    continuation of the zenithal azimuth rule x = R sin(phi),
    y = -R cos(phi), with the azimuth quantized to the wing's central
    meridian: x = u cos(phi_c) - v sin(phi_c), y = u sin(phi_c)
    + v cos(phi_c). The wings point along the plane diagonals with the
    polar gores opening along the axes; the south poles sit at the four
    points (+-180/sqrt2, +-180/sqrt2). Equal-area with the same constant
    Jacobian 67.5 deg^2 per unit (phi_deg, z) as HPX. Fiducial
    (phi0, theta0) = (0, 90) — zenithal-style, so the native pole is
    CRVAL and the celestial rotation is inherited unchanged from
    :class:`ZenithalWcs`. No PV parameters.
    """

    SUPPORTED = ("XPH",)

    @staticmethod
    def _wing_centre_sincos(m):
        # phi_c = 90 m - 135 -> sin/cos are exact +-1/sqrt(2) patterns;
        # computed via the angle for clarity (host/trace-time cheap).
        phic = 90.0 * m - 135.0
        t = torch.deg2rad(phic)
        return phic, torch.sin(t), torch.cos(t)

    def native_from_plane(self, x, y):
        """Projection-plane (x, y) degrees -> native (phi, theta)
        radians; the gores along the axes and points beyond the wing
        tips yield NaN."""
        # wing from the diagonal quadrant (half-open on the axes)
        m = torch.where(x < 0.0, torch.where(y < 0.0, 1.0, 0.0),
                        torch.where(y < 0.0, 2.0, 3.0)).to(x.dtype)
        phic, s, c = self._wing_centre_sincos(m)
        u = x * c + y * s
        v = -x * s + y * c
        north = v >= -45.0
        south = v < -135.0
        # polar zones: sigma from the radial coordinate
        sig = torch.where(north, -v / 45.0, (v + 180.0) / 45.0)
        sig_c = torch.clip(sig, 0.0, 1.0)
        pole = sig_c < 1e-12
        xi_p = torch.where(pole, 0.0, u / torch.where(pole, 1.0, sig_c))
        z_p = torch.where(north, 1.0, -1.0) * (1.0 - sig_c * sig_c / 3.0)
        ok_p = (sig >= -1e-12) & (torch.abs(u) <= 45.0 * sig_c + 1e-9)
        # equatorial band
        z_e = (v + 90.0) / 67.5
        ok_e = torch.abs(u) <= 45.0 + 1e-9
        eq = ~north & ~south
        z = torch.where(eq, z_e, z_p)
        xi = torch.where(eq, u, xi_p)
        ok = torch.where(eq, ok_e, ok_p) & (v <= 1e-9) & (v >= -180.0 - 1e-9)
        phi = torch.deg2rad(phic + xi)
        theta = torch.asin(torch.clip(z, -1.0, 1.0))
        bad = ~ok
        return (torch.where(bad, math.nan, phi),
                torch.where(bad, math.nan, theta))

    def plane_from_native(self, phi, theta):
        """Native (phi, theta) radians -> projection-plane (x, y)
        degrees; phi wrapped into [-180, 180)."""
        pd = torch.remainder(torch.rad2deg(phi) + 180.0, 360.0) - 180.0
        m = torch.clip(torch.floor((pd + 180.0) / 90.0), 0.0, 3.0)
        phic, s, c = self._wing_centre_sincos(m)
        xi = pd - phic
        z = torch.sin(theta)
        eq = torch.abs(z) <= 2.0 / 3.0
        sig = torch.sqrt(torch.clamp(3.0 * (1.0 - torch.abs(z)), min=0.0))
        u = torch.where(eq, xi, xi * sig)
        v = torch.where(eq, 67.5 * z - 90.0,
                      torch.where(theta >= 0.0, -45.0 * sig,
                                45.0 * sig - 180.0))
        return u * c - v * s, u * s + v * c


#: projection code -> WCS class, the dispatch table of :func:`make_wcs`
_WCS_FAMILIES = {
    **{c: ZenithalWcs for c in ZenithalWcs.SUPPORTED},
    **{c: GeneralZenithalWcs for c in GeneralZenithalWcs.SUPPORTED},
    **{c: CylindricalWcs for c in CylindricalWcs.SUPPORTED},
    **{c: ConicWcs for c in ConicWcs.SUPPORTED},
    **{c: PseudoCylindricalWcs for c in PseudoCylindricalWcs.SUPPORTED},
    **{c: PseudoConicWcs for c in PseudoConicWcs.SUPPORTED},
    **{c: QuadCubeWcs for c in QuadCubeWcs.SUPPORTED},
    **{c: HealpixWcs for c in HealpixWcs.SUPPORTED},
    **{c: XphWcs for c in XphWcs.SUPPORTED},
}


def make_wcs(header):
    """Build the right WCS container for a FITS header.

    Dispatches on the CTYPE projection code across the full FITS Paper
    II catalogue: zenithal (TAN/SIN/ZEA/ARC/STG ->
    :class:`ZenithalWcs`; AZP/SZP/ZPN/AIR ->
    :class:`GeneralZenithalWcs`), cylindrical (CAR/CEA/MER/CYP ->
    :class:`CylindricalWcs`), conic (COP/COE/COD/COO ->
    :class:`ConicWcs`), pseudo-cylindrical (SFL/PAR/MOL/AIT ->
    :class:`PseudoCylindricalWcs`), pseudo-conic (BON/PCO ->
    :class:`PseudoConicWcs`), quad-cube (TSC/QSC ->
    :class:`QuadCubeWcs`) and HEALPix (HPX -> :class:`HealpixWcs`,
    XPH butterfly -> :class:`XphWcs`).
    That is every Paper II projection except CSC — the COBE polynomial
    *approximation* of the quad-cube, whose defining coefficient tables
    are third-party data, not math; TSC/QSC cover the cube exactly.
    (The reference resolves projections through its astropy fallback,
    reference wcs.py:18-64 — astrometry.net output is always TAN.)
    """
    c1 = header.get("CTYPE1") or ""
    code = _ctype_code(header) or (
        c1[5:] if isinstance(c1, str) and len(c1) >= 8 else "")
    cls = _WCS_FAMILIES.get(code)
    if cls is None:
        if code == "CSC":
            hint = (" CSC is the COBE polynomial approximation of the "
                    "quad-cube — use the exact TSC/QSC instead.")
        else:
            hint = ""
        raise NotImplementedError(
            f"projection {code!r} (CTYPE1={c1!r}) is not supported:"
            f"{hint} first-party projections are the zenithal family "
            f"{ZenithalWcs.SUPPORTED + GeneralZenithalWcs.SUPPORTED}, "
            f"the cylindrical family {CylindricalWcs.SUPPORTED}, the "
            f"conic family {ConicWcs.SUPPORTED}, the pseudo-cylindrical "
            f"family {PseudoCylindricalWcs.SUPPORTED}, the pseudo-conic "
            f"family {PseudoConicWcs.SUPPORTED}, the quad-cube family "
            f"{QuadCubeWcs.SUPPORTED} and the HEALPix pair "
            f"{HealpixWcs.SUPPORTED + XphWcs.SUPPORTED}")
    return cls(header)


def _theta_from_r(projection, r):
    """Native latitude theta (rad) from projection-plane radius R (deg).

    Radial inverses of the zenithal R_theta functions (FITS Paper II
    section 5.1); out-of-domain radii yield NaN.
    """
    if projection == "TAN":
        # R = (180/pi)/tan(theta); r=0 -> +inf -> pi/2
        return torch.atan((180.0 / math.pi) / r)
    if projection == "SIN":
        # R = (180/pi) cos(theta); R > 180/pi -> NaN (outside the disc)
        return torch.acos(r * _RAD_PER_R)
    if projection == "ZEA":
        # R = (360/pi) sin((90-theta)/2)
        return math.pi / 2 - 2.0 * torch.asin(r * (_RAD_PER_R / 2.0))
    if projection == "ARC":
        # R = 90 - theta [deg]; full sphere is R <= 180
        th = torch.deg2rad(90.0 - r)
        return torch.where(r <= 180.0, th, math.nan)
    if projection == "STG":
        # R = (360/pi) tan((90-theta)/2)
        return math.pi / 2 - 2.0 * torch.atan(r * (_RAD_PER_R / 2.0))
    raise NotImplementedError(projection)


def _r_from_theta(projection, theta):
    """Projection-plane radius R (deg) from native latitude theta (rad);
    unprojectable directions (e.g. behind the TAN/SIN plane) yield NaN."""
    if projection == "TAN":
        return torch.where(theta > 0,
                         (180.0 / math.pi) / torch.tan(theta), math.nan)
    if projection == "SIN":
        # the far hemisphere mirrors onto the same disc — mask it, same
        # rationale as tan_world2pix
        return torch.where(theta >= 0,
                         (180.0 / math.pi) * torch.cos(theta), math.nan)
    if projection == "ZEA":
        return (360.0 / math.pi) * torch.sin((math.pi / 2 - theta) / 2.0)
    if projection == "ARC":
        return 90.0 - torch.rad2deg(theta)
    if projection == "STG":
        return (360.0 / math.pi) * torch.tan((math.pi / 2 - theta) / 2.0)
    raise NotImplementedError(projection)


def pix2world_dirs(wcs, px, py, origin=0):
    """Pixel coordinates -> unit ICRS direction COMPONENTS (vx, vy, vz)
    for any supported projection — the planar form of
    :func:`pix2world_cartesian`, which the generic georeference chain
    consumes component by component."""
    # header constants ride as Python floats: the chain then computes in
    # the dtype (and on the device) of px/py, float32 staying float32
    dx = px - float(wcs.px_ref - (1 - origin))
    dy = py - float(wcs.py_ref - (1 - origin))
    cd = mat_entries(wcs.cd)
    x = cd[0][0] * dx + cd[0][1] * dy
    y = cd[1][0] * dx + cd[1][1] * dy

    # radial zenithal laws: trig-free algebraic direction (one sqrt vs ~6
    # transcendentals); everything else goes through the spherical route
    dirs = getattr(wcs, "dirs_from_plane", lambda *_: None)(x, y)
    if dirs is not None:
        l_, m_, n_ = dirs
    else:
        phi, theta = wcs.native_from_plane(x, y)
        cos_t = torch.cos(theta)
        l_ = cos_t * torch.cos(phi)
        m_ = cos_t * torch.sin(phi)
        n_ = torch.sin(theta)
    rot = mat_entries(wcs.rotmat)
    vx = rot[0][0] * l_ + rot[0][1] * m_ + rot[0][2] * n_
    vy = rot[1][0] * l_ + rot[1][1] * m_ + rot[1][2] * n_
    vz = rot[2][0] * l_ + rot[2][1] * m_ + rot[2][2] * n_
    return vx, vy, vz


def pix2world_cartesian(wcs, px, py, origin=0):
    """Pixel coordinates -> unit ICRS direction vectors (..., 3) for any
    supported projection; generic counterpart of
    :func:`tan_pix2world_cartesian` (the reference reaches non-TAN
    projections via its astropy fallback, reference wcs.py:18-64)."""
    vx, vy, vz = pix2world_dirs(wcs, px, py, origin)
    return torch.stack([vx, vy, vz], dim=-1)


def _ra_dec(v):
    s = torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2)
    dec = torch.rad2deg(torch.atan2(v[..., 2], s))
    ra = torch.rad2deg(torch.atan2(v[..., 1], v[..., 0]))
    return torch.remainder(ra - 360.0, 360.0), dec


def pix2world(wcs, px, py, origin=0):
    """Pixel coordinates -> (ra, dec) degrees for any supported
    projection, ra wrapped into [0, 360)."""
    return _ra_dec(pix2world_cartesian(wcs, px, py, origin))


def _native_angles(wcs, ra_deg, dec_deg):
    """Celestial degrees (tensors; their device and dtype carry the
    computation) -> native spherical (phi, theta) radians: the rotation
    rotmat.T @ v as explicit multiply-adds (no matrix product, so no TF32
    on the card)."""
    ra = torch.deg2rad(ra_deg)
    dec = torch.deg2rad(dec_deg)
    cos_d = torch.cos(dec)
    vx, vy, vz = cos_d * torch.cos(ra), cos_d * torch.sin(ra), torch.sin(dec)
    rot = mat_entries(wcs.rotmat)
    n0 = rot[0][0] * vx + rot[1][0] * vy + rot[2][0] * vz
    n1 = rot[0][1] * vx + rot[1][1] * vy + rot[2][1] * vz
    n2 = rot[0][2] * vx + rot[1][2] * vy + rot[2][2] * vz
    return torch.atan2(n1, n0), torch.atan2(n2, torch.hypot(n0, n1))


def _pixels_from_plane(wcs, x, y, origin):
    inv = mat_entries(np.linalg.inv(wcs.cd))
    dx = inv[0][0] * x + inv[0][1] * y
    dy = inv[1][0] * x + inv[1][1] * y
    off = 1 - origin
    return dx + float(wcs.px_ref) - off, dy + float(wcs.py_ref) - off


def world2pix(wcs, ra_deg, dec_deg, origin=0):
    """Celestial (ra, dec) degree tensors -> pixel coordinates for any
    supported projection, on the device and in the dtype of the inputs
    (like :func:`pix2world_dirs`); unprojectable directions return NaN."""
    phi, theta = _native_angles(wcs, ra_deg, dec_deg)
    x, y = wcs.plane_from_native(phi, theta)
    return _pixels_from_plane(wcs, x, y, origin)


def tan_pix2world_cartesian(wcs: TanWcs, px, py, origin=0):
    """Pixel coordinates -> unit direction vectors in ICRS, (..., 3).

    :param px, py: pixel coordinate tensors (any shape, same shape)
    :param origin: 0 or 1; FITS CRPIX is 1-based, so origin=0 adds 1
    """
    dx = px - float(wcs.px_ref - (1 - origin))
    dy = py - float(wcs.py_ref - (1 - origin))

    cd = mat_entries(wcs.cd)
    x = cd[0][0] * dx + cd[0][1] * dy
    y = cd[1][0] * dx + cd[1][1] * dy

    r = torch.sqrt(x * x + y * y)
    phi = torch.atan2(x, -y)  # native longitude
    theta = torch.atan((180.0 / math.pi) / r)  # native latitude; r=0 -> +inf -> pi/2

    cos_t = torch.cos(theta)
    l_ = cos_t * torch.cos(phi)
    m_ = cos_t * torch.sin(phi)
    n_ = torch.sin(theta)

    rot = mat_entries(wcs.rotmat)
    vx = rot[0][0] * l_ + rot[0][1] * m_ + rot[0][2] * n_
    vy = rot[1][0] * l_ + rot[1][1] * m_ + rot[1][2] * n_
    vz = rot[2][0] * l_ + rot[2][1] * m_ + rot[2][2] * n_
    return torch.stack([vx, vy, vz], dim=-1)


def tan_pix2world(wcs: TanWcs, px, py, origin=0):
    """Pixel coordinates -> (ra, dec) in degrees, ra wrapped into [0, 360).

    Reference: auromat/coordinates/wcs.py:66-157.
    """
    return _ra_dec(tan_pix2world_cartesian(wcs, px, py, origin))


def tan_world2pix(wcs: TanWcs, ra_deg, dec_deg, origin=0):
    """Celestial (ra, dec) degrees -> pixel coordinates (inverse of
    :func:`tan_pix2world`; forward TAN projection, FITS Paper II).

    Directions >= 90 deg from the tangent point (theta <= 0, behind the
    tangent plane) are unprojectable and return NaN — without this the
    gnomonic formula MIRRORS the far hemisphere into the frame (the
    antipode of the frame centre lands exactly on the frame centre),
    producing ghost stars/constellations in all-sky overlays.
    """
    phi, theta = _native_angles(wcs, ra_deg, dec_deg)
    theta = torch.where(theta > 0, theta, math.nan)
    r = (180.0 / math.pi) / torch.tan(theta)
    return _pixels_from_plane(wcs, r * torch.sin(phi), -r * torch.cos(phi),
                              origin)


def pixel_grid(width, height, start_x=0, start_y=0, corner=True,
               dtype=torch.float64, device="cuda"):
    """Pixel-corner or pixel-centre coordinate grids on ``device`` (the
    card by default; pass ``device="cpu"`` for the CPU).

    Matches the reference grid construction (auromat/coordinates/wcs.py:44-47):
    corner grids start at -0.5 and have one extra row/column.

    :returns: (px, py) tensors of shape (h+1, w+1) or (h, w)
    """
    from auromat_tpu_torch.ops.georef import compute_device

    device = compute_device(device)
    off = -0.5 if corner else 0.0
    extra = 1 if corner else 0
    xs = torch.arange(start_x + off, start_x + off + width + extra,
                      dtype=dtype, device=device)
    ys = torch.arange(start_y + off, start_y + off + height + extra,
                      dtype=dtype, device=device)
    return torch.meshgrid(xs, ys, indexing="xy")


def pixel_directions(wcs: TanWcs, corner=True, dtype=torch.float64,
                     device="cuda"):
    """Direction vectors in ICRS for every pixel corner or centre, on
    ``device``.

    ICRS directions are used directly as GCRS/J2000 (error ~0.01 arcsec vs
    20-100 arcsec/px; reference: auromat/mapping/astrometry.py:245-269).

    :returns: (h+1, w+1, 3) if corner else (h, w, 3)
    """
    if wcs.width is None or wcs.height is None:
        raise ValueError(
            "WCS header has no image dimensions (IMAGEW/IMAGEH); "
            "pixel_directions needs them to build the pixel grid"
        )
    px, py = pixel_grid(wcs.width, wcs.height, corner=corner, dtype=dtype,
                        device=device)
    return tan_pix2world_cartesian(wcs, px, py, origin=0)
