"""Coordinate conversions as torch tensor code (counterpart of
``auromat_tpu.coordinates.transform``): the geodetic <-> ECEF pair (and
the ground-level ``geodetic_to_ecef_zero`` of the all-sky stations), the
rigid pole rotation that resampling uses to move a footprint off a pole,
and ECEF -> MLat/MLT. Each function computes in the dtype and on the
device of its inputs; the callers pass float64.
"""

import numpy as np
import torch

from auromat_tpu_torch.constants import WGS84_A, WGS84_B


def geodetic_to_ecef(lat, lon, h, a=WGS84_A, b=WGS84_B):
    """Geodetic (radians, height in the unit of a/b) -> ECEF cartesian.

    Reference: auromat/coordinates/transform.py:156-178.
    """
    e2 = (a * a - b * b) / (a * a)
    sin_lat = torch.sin(lat)
    n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    cos_lat = torch.cos(lat)
    nh = (n + h) * cos_lat
    x = nh * torch.cos(lon)
    y = nh * torch.sin(lon)
    z = (n * (1.0 - e2) + h) * sin_lat
    return x, y, z


def geodetic_to_ecef_zero(lat, lon, a=WGS84_A, b=WGS84_B):
    """:func:`geodetic_to_ecef` with h=0 (reference: transform.py:180-197)."""
    e2 = (a * a - b * b) / (a * a)
    sin_lat = torch.sin(lat)
    n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    nc = n * torch.cos(lat)
    return nc * torch.cos(lon), nc * torch.sin(lon), n * (1.0 - e2) * sin_lat


def station_ecef(lat_deg, lon_deg):
    """Ground-level ECEF (km) of a station at geodetic degrees, as a host
    float64 (3,) array (:func:`geodetic_to_ecef_zero` on CPU float64)."""
    xyz = geodetic_to_ecef_zero(
        torch.tensor(np.deg2rad(lat_deg), dtype=torch.float64),
        torch.tensor(np.deg2rad(lon_deg), dtype=torch.float64))
    return np.array([float(v) for v in xyz])


def ecef_to_geodetic(x, y, z, a=WGS84_A, b=WGS84_B):
    """ECEF -> geodetic (lat, lon) in radians via Bowring's 1985 method.

    Reference: auromat/coordinates/transform.py:199-230. Exactly on the
    rotation axis (x == y == 0) the method divides 0/0 and returns NaN lat,
    as the reference does.
    """
    e2 = (a * a - b * b) / (a * a)
    d = (a * a - b * b) / b
    p2 = x * x + y * y
    p = torch.sqrt(p2)
    r = torch.sqrt(p2 + z * z)
    tu = b * z * (1.0 + d / r) / (a * p)
    tu2 = tu * tu
    cu = 1.0 / torch.sqrt(1.0 + tu2)
    cu3 = cu * cu * cu
    su3 = cu3 * tu2 * tu
    tp = (z + d * su3) / (p - e2 * a * cu3)
    return torch.atan(tp), torch.atan2(y, x)


def rotate_pole(lats, lons, altitude, angle_deg=90.0, axis=(1, 0, 0),
                a=WGS84_A, b=WGS84_B):
    """Rotate geodetic coordinates rigidly around a coordinate axis.

    Used to move data away from a pole before plate-carree gridding
    (reference: auromat/coordinates/transform.py:301-322).

    :param lats, lons: radians, tensors of any shape
    :param altitude: km
    :returns: (lats, lons) in radians
    """
    x, y, z = geodetic_to_ecef(lats, lons, altitude, a, b)
    alpha = np.deg2rad(angle_deg)
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(alpha), np.sin(alpha)
    ux, uy, uz = axis
    rot = (c * np.eye(3) + (1 - c) * np.outer(axis, axis)
           + s * np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]]))
    m = [[float(v) for v in row] for row in rot]
    xr = m[0][0] * x + m[0][1] * y + m[0][2] * z
    yr = m[1][0] * x + m[1][1] * y + m[1][2] * z
    zr = m[2][0] * x + m[2][1] * y + m[2][2] * z
    return ecef_to_geodetic(xr, yr, zr, a, b)


def geo_to_mlat_mlt(vecs, mat_geo_to_sm):
    """ECEF (..., 3) -> (MLat deg, MLT hours).

    Reference: auromat/coordinates/transform.py:432-459.
    """
    m = torch.as_tensor(np.asarray(mat_geo_to_sm), dtype=vecs.dtype,
                        device=vecs.device)
    sm = vecs @ m.T
    x, y, z = sm[..., 0], sm[..., 1], sm[..., 2]
    mlat = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    mlt = torch.rad2deg(torch.atan2(y, x)) * (24.0 / 360.0) + 12.0
    return mlat, mlt
