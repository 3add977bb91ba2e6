"""FITS WCS celestial header parsing (host-side numpy, float64).

The header half of ``auromat_tpu.coordinates.wcs``: the CTYPE/CD/CRPIX/
CRVAL parse, the native-pole solve and the native->celestial rotation
matrix that the fused TAN georeference (:mod:`auromat_tpu_torch.ops.georef`)
consumes. The per-pixel projection math of the 27 FITS Paper II
projections is not here; the fused path needs only the TAN header.

Math (FITS Paper II, Calabretta & Greisen 2002):
  pixel offsets -> CD matrix -> projection-plane (x, y) in degrees
  native spherical: phi = arg(-y, x); theta from the projection's radial
  function R_theta (TAN: (180/pi)/tan -> theta = atan(180/(pi R)))
  celestial: rotate by the Euler z-x-z matrix
  Rz(ra_ref + 90) @ Rx(90 - dec_ref) @ Rz(-(lonpole - 90))   [degrees]
"""

import numpy as np


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
    (stereographic). Built from a FITS/astrometry.net header dict (see
    :mod:`auromat_tpu_torch.io.fits`).
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
                f"{header.get('CTYPE1')}/{header.get('CTYPE2')}"
            )
        super().__init__(header)
