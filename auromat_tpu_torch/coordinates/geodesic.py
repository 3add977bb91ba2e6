"""Ellipsoidal geodesics (host numpy, float64): the subset the mapping
data model and resampling use.

A copy of the jax-free ``auromat_tpu.coordinates.geodesic`` (importing it
would import jax through ``auromat_tpu/__init__``): :func:`angular_distance`
(resample resolution, pixel scales), :func:`contains_or_crosses_pole`
(bounding boxes), :func:`distance`/:func:`intermediate`
(``BoundingBox.center``/``size``), and :func:`course`,
:func:`destination` and :func:`line` (the drawing layer's scanline and
azimuth coroutines), over the vectorized Vincenty inverse and direct
problems.
"""

from collections import namedtuple

import numpy as np

from auromat_tpu_torch.constants import WGS84_A, WGS84_B, WGS84_F

Location = namedtuple("Location", ["lat", "lon"])  # degrees

_A = WGS84_A * 1000.0  # meters
_B = WGS84_B * 1000.0
_F = WGS84_F


def _inverse(lat1, lon1, lat2, lon2, iterations=30):
    """Vectorized Vincenty inverse problem.

    :param lat1..lon2: degrees, broadcastable arrays
    :returns: (s meters, sigma rad on auxiliary sphere, azi1 deg, azi2 deg)
    """
    lat1, lon1, lat2, lon2 = map(lambda x: np.asarray(x, dtype=np.float64),
                                 (lat1, lon1, lat2, lon2))
    u1 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat1)))
    u2 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat2)))
    ell = np.deg2rad(lon2 - lon1)
    su1, cu1 = np.sin(u1), np.cos(u1)
    su2, cu2 = np.sin(u2), np.cos(u2)

    lam = ell
    lam_prev = lam
    with np.errstate(invalid="ignore", divide="ignore"):
        for _ in range(iterations):
            lam_prev = lam
            sl, cl = np.sin(lam), np.cos(lam)
            sin_sigma = np.sqrt((cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2)
            cos_sigma = su1 * su2 + cu1 * cu2 * cl
            sigma = np.arctan2(sin_sigma, cos_sigma)
            sin_alpha = np.where(sin_sigma != 0, cu1 * cu2 * sl / np.where(sin_sigma == 0, 1, sin_sigma), 0.0)
            cos2_alpha = 1.0 - sin_alpha**2
            cos_2sm = np.where(cos2_alpha != 0,
                               cos_sigma - 2 * su1 * su2 / np.where(cos2_alpha == 0, 1, cos2_alpha),
                               0.0)
            c = _F / 16 * cos2_alpha * (4 + _F * (4 - 3 * cos2_alpha))
            lam = ell + (1 - c) * _F * sin_alpha * (
                sigma + c * sin_sigma * (cos_2sm + c * cos_sigma * (-1 + 2 * cos_2sm**2))
            )

        big_a, big_b = _vincenty_ab(cos2_alpha)
        d_sigma = _vincenty_delta_sigma(big_b, sin_sigma, cos_sigma, cos_2sm)
        s = _B * big_a * (sigma - d_sigma)
        azi1 = np.rad2deg(np.arctan2(cu2 * sl, cu1 * su2 - su1 * cu2 * cl))
        azi2 = np.rad2deg(np.arctan2(cu1 * sl, -su1 * cu2 + cu1 * su2 * cl))
    s = np.where(sin_sigma == 0, 0.0, s)

    # nearly-antipodal pairs: the lambda fixed-point iteration diverges (its
    # derivative exceeds 1 inside the ~f*pi wedge around the antipode);
    # re-solve those by shooting on the departure azimuth
    bad = ~(np.abs(lam - lam_prev) < 1e-11) & (sin_sigma != 0)
    if np.any(bad):
        s_a, sig_a, a1_a, a2_a = _inverse_antipodal(
            np.broadcast_to(lat1, bad.shape)[bad],
            np.broadcast_to(lon1, bad.shape)[bad],
            np.broadcast_to(lat2, bad.shape)[bad],
            np.broadcast_to(lon2, bad.shape)[bad],
        )
        if bad.ndim == 0:
            return s_a[0], sig_a[0], a1_a[0], a2_a[0]
        s, sigma, azi1, azi2 = (np.array(x, dtype=np.float64, copy=True)
                                for x in np.broadcast_arrays(s, sigma, azi1, azi2))
        s[bad], sigma[bad], azi1[bad], azi2[bad] = s_a, sig_a, a1_a, a2_a
    return s, sigma, azi1, azi2


def _vincenty_ab(cos2_alpha):
    """Vincenty's A/B series coefficients from cos^2(alpha)."""
    u2_ = cos2_alpha * (_A**2 - _B**2) / _B**2
    big_a = 1 + u2_ / 16384 * (4096 + u2_ * (-768 + u2_ * (320 - 175 * u2_)))
    big_b = u2_ / 1024 * (256 + u2_ * (-128 + u2_ * (74 - 47 * u2_)))
    return big_a, big_b


def _vincenty_delta_sigma(big_b, sin_sigma, cos_sigma, cos_2sm):
    return big_b * sin_sigma * (
        cos_2sm + big_b / 4 * (
            cos_sigma * (-1 + 2 * cos_2sm**2)
            - big_b / 6 * cos_2sm * (-3 + 4 * sin_sigma**2)
            * (-3 + 4 * cos_2sm**2)
        )
    )


def _vincenty_distance(cos2_alpha, sigma12, two_sigma_m):
    """Ellipsoidal arc length from auxiliary-sphere quantities."""
    big_a, big_b = _vincenty_ab(cos2_alpha)
    d_sigma = _vincenty_delta_sigma(big_b, np.sin(sigma12), np.cos(sigma12),
                                    np.cos(two_sigma_m))
    return _B * big_a * (sigma12 - d_sigma)


def _antipodal_lam12(alpha1, su1, cu1, su2, cu2):
    """Spherical-triangle forward map for the antipodal shooting solver.

    Given the departure azimuth ``alpha1`` (rad, eastward in (0, pi)) at
    point 1 (normalized: U1 <= 0, |U1| >= |U2|), return the ellipsoidal
    longitude difference lam12 this geodesic accrues when it first reaches
    reduced latitude U2 past its vertex, plus the quantities needed to
    finish the solution. Longitude correction uses Vincenty's C-series
    (error ~f^3, sub-meter)."""
    sa1, ca1 = np.sin(alpha1), np.cos(alpha1)
    sin_a0 = sa1 * cu1
    cos2_a0 = 1.0 - sin_a0**2
    cos_a0 = np.sqrt(cos2_a0)
    sigma1 = np.arctan2(su1, ca1 * cu1)
    # the geodesic crosses latitude U2 before (sigma_a) and past (sigma_b)
    # its vertex; the minimal near-antipodal solution is the crossing whose
    # arc sigma12 lies nearest pi
    with np.errstate(invalid="ignore"):
        sig_a = np.arcsin(np.clip(su2 / np.where(cos_a0 == 0, 1, cos_a0),
                                  -1.0, 1.0))
    sig_b = np.pi - sig_a
    s12_a = np.mod(sig_a - sigma1, 2 * np.pi)
    s12_b = np.mod(sig_b - sigma1, 2 * np.pi)
    use_a = np.abs(s12_a - np.pi) <= np.abs(s12_b - np.pi)
    sigma2 = sigma1 + np.where(use_a, s12_a, s12_b)
    sigma12 = sigma2 - sigma1
    om1 = np.arctan2(sin_a0 * np.sin(sigma1), np.cos(sigma1))
    om2 = np.arctan2(sin_a0 * np.sin(sigma2), np.cos(sigma2))
    dom = np.mod(om2 - om1, 2 * np.pi)
    c = _F / 16 * cos2_a0 * (4 + _F * (4 - 3 * cos2_a0))
    cos_2sm = np.cos(sigma1 + sigma2)
    lam12 = dom - (1 - c) * _F * sin_a0 * (
        sigma12 + c * np.sin(sigma12) * (
            cos_2sm + c * np.cos(sigma12) * (-1 + 2 * cos_2sm**2))
    )
    return lam12, sigma1, sigma2, sin_a0, cos2_a0


def _inverse_antipodal(lat1, lon1, lat2, lon2):
    """Inverse problem for nearly-antipodal pairs via azimuth shooting.

    Normalizes like Karney (swap so |U1| >= |U2|, flip so U1 <= 0, mirror so
    0 <= L <= pi), scans alpha1 for the sign change of lam12(alpha1) - L and
    bisects. Distance from the standard Vincenty sigma-series. Accuracy is
    limited by the C-series longitude term (~f^3): sub-meter, vs the exact
    (Karney) solution; fine for bounding boxes / scanline geometry.
    """
    lat1, lon1, lat2, lon2 = np.atleast_1d(lat1, lon1, lat2, lon2)
    u1 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat1)))
    u2 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat2)))
    ell = np.deg2rad(lon2 - lon1)
    ell = np.mod(ell + np.pi, 2 * np.pi) - np.pi  # (-pi, pi]

    swap = np.abs(u1) < np.abs(u2)
    ua = np.where(swap, u2, u1)
    ub = np.where(swap, u1, u2)
    lonsign = np.where(ell >= 0, 1.0, -1.0)
    ls = np.abs(ell)
    latsign = np.where(ua <= 0, 1.0, -1.0)
    ua = ua * latsign
    ub = ub * latsign

    su1, cu1 = np.sin(ua), np.cos(ua)
    su2, cu2 = np.sin(ub), np.cos(ub)

    # bracket the root of g(alpha1) = lam12 - L by a coarse scan (the branch
    # selection makes g piecewise monotone; scan for any sign change, then
    # bisect with the local orientation)
    n_scan = 128
    alphas = np.linspace(1e-12, np.pi - 1e-12, n_scan)
    g = np.empty((n_scan,) + ua.shape)
    for i, a in enumerate(alphas):
        lam12, _, _, _, _ = _antipodal_lam12(np.full_like(ua, a), su1, cu1,
                                             su2, cu2)
        g[i] = lam12 - ls
    sign_change = np.sign(g[:-1]) != np.sign(g[1:])
    # lam12(alpha1) = L can have SEVERAL roots near the antipode (distinct
    # geodesics through different vertices); each sign-change interval is a
    # candidate, and picking by any g-based score alone can land on a valid
    # but NON-minimal geodesic (observed +30..100 km). Bisect the best few
    # candidates and keep the SHORTEST converged solution.
    score = np.where(sign_change, np.abs(g[:-1]) + np.abs(g[1:]), np.inf)
    order = np.argsort(score, axis=0)
    n_cand = 6

    best_s = np.full(ua.shape, np.inf)
    best_alpha1 = np.zeros(ua.shape)
    any_root = np.zeros(ua.shape, dtype=bool)
    for ci in range(n_cand):
        idx = order[ci]
        bracket = np.take_along_axis(sign_change, idx[None], axis=0)[0]
        # degenerate exact-antipode family: no bracket anywhere, but
        # sup g -> 0 at alpha -> 0: alpha = the scan origin is near-optimal
        no_bracket = np.zeros(ua.shape, dtype=bool)
        if ci == 0:
            no_bracket = ~sign_change.any(axis=0) \
                & (np.min(np.abs(g), axis=0) < 5e-5)
            idx = np.where(bracket, idx, 0)
        cand_ok = bracket | no_bracket
        if not np.any(cand_ok):
            continue
        lo = alphas[idx]
        hi = alphas[idx + 1]
        g_lo = np.take_along_axis(g, idx[None], axis=0)[0]
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            gm, _, _, _, _ = _antipodal_lam12(mid, su1, cu1, su2, cu2)
            gm = gm - ls
            same = np.sign(gm) == np.sign(g_lo)
            lo = np.where(same, mid, lo)
            hi = np.where(same, hi, mid)
        cand_alpha = np.where(no_bracket, alphas[0], 0.5 * (lo + hi))
        c_lam, c_sig1, c_sig2, _, c_cos2a0 = _antipodal_lam12(
            cand_alpha, su1, cu1, su2, cu2)
        # a TRUE root bisects to |g| ~ 1e-12; a branch-switch DISCONTINUITY
        # also flips sign but leaves |g| at the jump size (>= 1e-3 rad) —
        # reject those instead of letting a spurious shorter "solution" win
        converged = np.abs(c_lam - ls) < 1e-4
        cand_ok = cand_ok & converged
        c_s12 = c_sig2 - c_sig1
        cand_s = _vincenty_distance(c_cos2a0, c_s12, c_sig1 + c_sig2)
        # several genuine geodesics coexist inside the antipodal wedge;
        # return the SHORTEST (geographiclib's contract)
        better = cand_ok & (cand_s < best_s)
        best_s = np.where(better, cand_s, best_s)
        best_alpha1 = np.where(better, cand_alpha, best_alpha1)
        any_root = any_root | cand_ok

    solvable = any_root
    alpha1 = best_alpha1
    lam12, sigma1, sigma2, sin_a0, cos2_a0 = _antipodal_lam12(
        alpha1, su1, cu1, su2, cu2)
    sigma12 = sigma2 - sigma1
    s = _vincenty_distance(cos2_a0, sigma12, sigma1 + sigma2)

    # azimuths on the normalized problem (identity cos(alpha) cos(U) =
    # cos(alpha0) cos(sigma))
    cos_a0 = np.sqrt(cos2_a0)
    alpha2 = np.arctan2(sin_a0, cos_a0 * np.cos(sigma2))
    a1 = alpha1.copy()
    a2 = alpha2.copy()
    # undo swap: exchanging endpoints reverses the path: the azimuth at the
    # new point 1 is the arrival azimuth turned 180 deg, and vice versa
    a1_s = np.where(swap, np.pi + a2, a1)
    a2_s = np.where(swap, np.pi + a1, a2)
    # undo hemisphere flip (reflection through the equator: a -> pi - a)
    a1_f = np.where(latsign < 0, np.pi - a1_s, a1_s)
    a2_f = np.where(latsign < 0, np.pi - a2_s, a2_s)
    # note: swap also mirrors the longitude sign for the swapped problem
    # (lon diff from p2 to p1 is -L); composing with the lonsign mirror:
    eff_sign = lonsign * np.where(swap, -1.0, 1.0)
    a1_m = np.where(eff_sign < 0, -a1_f, a1_f)
    a2_m = np.where(eff_sign < 0, -a2_f, a2_f)
    azi1 = np.rad2deg(np.mod(a1_m + np.pi, 2 * np.pi) - np.pi)
    azi2 = np.rad2deg(np.mod(a2_m + np.pi, 2 * np.pi) - np.pi)
    # unsolvable pairs: return NaN loudly instead of a wrong geodesic
    s = np.where(solvable, s, np.nan)
    sigma12 = np.where(solvable, sigma12, np.nan)
    azi1 = np.where(solvable, azi1, np.nan)
    azi2 = np.where(solvable, azi2, np.nan)
    return s, sigma12, azi1, azi2


def _direct(lat1, lon1, azi1, s, iterations=30):
    """Vectorized Vincenty direct problem.

    :param s: distance in meters
    :returns: (lat2 deg, lon2 deg, azi2 deg)
    """
    lat1, lon1, azi1, s = map(lambda x: np.asarray(x, dtype=np.float64),
                              (lat1, lon1, azi1, s))
    alpha1 = np.deg2rad(azi1)
    u1 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat1)))
    su1, cu1 = np.sin(u1), np.cos(u1)
    sa1, ca1 = np.sin(alpha1), np.cos(alpha1)
    sigma1 = np.arctan2(np.tan(u1), ca1)
    sin_alpha = cu1 * sa1
    cos2_alpha = 1 - sin_alpha**2
    big_a, big_b = _vincenty_ab(cos2_alpha)

    sigma = s / (_B * big_a)
    for _ in range(iterations):
        cos_2sm = np.cos(2 * sigma1 + sigma)
        d_sigma = _vincenty_delta_sigma(big_b, np.sin(sigma), np.cos(sigma),
                                        cos_2sm)
        sigma = s / (_B * big_a) + d_sigma

    ss, cs = np.sin(sigma), np.cos(sigma)
    cos_2sm = np.cos(2 * sigma1 + sigma)
    lat2 = np.arctan2(
        su1 * cs + cu1 * ss * ca1,
        (1 - _F) * np.sqrt(sin_alpha**2 + (su1 * ss - cu1 * cs * ca1) ** 2),
    )
    lam = np.arctan2(ss * sa1, cu1 * cs - su1 * ss * ca1)
    c = _F / 16 * cos2_alpha * (4 + _F * (4 - 3 * cos2_alpha))
    ell = lam - (1 - c) * _F * sin_alpha * (
        sigma + c * ss * (cos_2sm + c * cs * (-1 + 2 * cos_2sm**2))
    )
    lon2 = lon1 + np.rad2deg(ell)
    lon2 = (lon2 + 180.0) % 360.0 - 180.0
    azi2 = np.rad2deg(np.arctan2(sin_alpha, -(su1 * ss - cu1 * cs * ca1)))
    return np.rad2deg(lat2), lon2, azi2


def distance(location1, location2):
    """Shortest distance in meters between two (lat, lon) locations."""
    s, _, _, _ = _inverse(location1[0], location1[1], location2[0], location2[1])
    return float(s) if np.ndim(s) == 0 else s


def angular_distance(location1, location2):
    """Arc length in degrees on the auxiliary sphere (geographiclib a12)."""
    _, sigma, _, _ = _inverse(location1[0], location1[1], location2[0], location2[1])
    a = np.rad2deg(sigma)
    return float(a) if np.ndim(a) == 0 else a


def course(location1, location2):
    """Azimuth (degrees) at location1 of the geodesic to location2."""
    _, _, azi1, _ = _inverse(location1[0], location1[1], location2[0], location2[1])
    return float(azi1) if np.ndim(azi1) == 0 else azi1


def destination(location, azimuth, dist):
    """Location after travelling ``dist`` meters on azimuth from location."""
    lat2, lon2, _ = _direct(location[0], location[1], azimuth, dist)
    if np.ndim(lat2) == 0:
        return Location(float(lat2), float(lon2))
    return lat2, lon2


def intermediate(location1, location2, f=0.5):
    """Point at fraction f of the geodesic from location1 to location2."""
    s, _, azi1, _ = _inverse(location1[0], location1[1], location2[0], location2[1])
    lat2, lon2, _ = _direct(location1[0], location1[1], azi1, s * f)
    if np.ndim(lat2) == 0:
        return Location(float(lat2), float(lon2))
    return lat2, lon2


def line(location1, location2, resolution=1000):
    """Points along the geodesic at roughly ``resolution``-meter spacing.

    Reference: auromat/coordinates/geodesic.py:46-78.
    :returns: (n, 2) array of lat, lon in degrees
    """
    s, _, azi1, _ = _inverse(location1[0], location1[1], location2[0], location2[1])
    if not np.isfinite(s):
        raise ValueError(
            "no geodesic solution for this (degenerate antipodal) pair")
    num = int(s // resolution)
    if num < 2:
        return np.array([[location1[0], location1[1]], [location2[0], location2[1]]])
    ds = np.linspace(0.0, float(s), num)
    lat2, lon2, _ = _direct(location1[0], location1[1], float(azi1), ds)
    return np.stack([lat2, lon2], axis=-1)


def _course_delta_sum(points):
    """Sum of signed course deltas around a polygon, in degrees.

    Vectorized version of the element84 pole-containment algorithm
    (reference geodesic.py:122-181).
    """
    points = np.asarray(points, dtype=np.float64)
    assert points.ndim == 2 and points.shape[1] == 2
    closed = np.concatenate([points, points[:1]], axis=0)
    lat1, lon1 = closed[:-1, 0], closed[:-1, 1]
    lat2, lon2 = closed[1:, 0], closed[1:, 1]
    _, _, azi_fwd, _ = _inverse(lat1, lon1, lat2, lon2)
    _, _, azi_bwd, _ = _inverse(lat2, lon2, lat1, lon1)
    courses = np.empty(2 * len(lat1))
    courses[0::2] = azi_fwd
    courses[1::2] = azi_bwd + 180.0

    a1 = np.roll(courses, 1)
    a2 = courses.copy()
    a2 = np.where(a2 < a1, a2 + 360.0, a2)
    left = a2 - a1
    deltas = np.where(left == 180.0, 0.0, np.where(left > 180.0, left - 360.0, left))
    return float(np.around(np.sum(deltas), decimals=1))


def contains_or_crosses_pole(points):
    """Whether the polygon (ordered, unclosed, (n,2) lat/lon deg) contains or
    crosses a pole. Reference: auromat/coordinates/geodesic.py:183-202."""
    delta_sum = _course_delta_sum(points)
    if abs(delta_sum) == 360.0:
        return False
    return True if abs(delta_sum) == 180.0 or delta_sum == 0.0 else False
