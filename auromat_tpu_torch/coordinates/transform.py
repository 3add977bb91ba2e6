"""Coordinate conversions as torch tensor code (counterpart of
``auromat_tpu.coordinates.transform``): spherical/cartesian and geodetic/
ECEF pairs, rotations by a host-side 3x3 matrix, the rigid pole rotation
that resampling uses to move a footprint off a pole, J2000/ECEF ->
geodetic and -> MLat/MLT, and the solar-magnetic -> geodetic inverse.
Each function computes in the dtype and on the device of its tensor
inputs; the Mapping-level callers pass float64.

Rotations are written as explicit multiply-adds, never as a matrix
product: a float32 ``@`` on the card goes through cuBLAS, where
``torch.backends.cuda.matmul.allow_tf32`` can cut the operands to 10
mantissa bits.
"""

import numpy as np
import torch

from auromat_tpu_torch.constants import WGS84_A, WGS84_B


def spherical_to_cartesian(r, lat, lon):
    """(r, lat, lon) -> (x, y, z). lat/lon in radians; r may be None (unit sphere).

    Reference semantics: auromat/coordinates/transform.py:89-102.
    """
    cos_lat = torch.cos(lat)
    x = cos_lat * torch.cos(lon)
    y = cos_lat * torch.sin(lon)
    z = torch.sin(lat)
    if r is not None:
        x, y, z = r * x, r * y, r * z
    return x, y, z


def cartesian_to_spherical(x, y, z, with_radius=True):
    """(x, y, z) -> (r, lat, lon) or (lat, lon). Radians.

    Reference semantics: auromat/coordinates/transform.py:104-154.
    """
    s2 = x * x + y * y
    s = torch.sqrt(s2)
    lat = torch.atan2(z, s)
    lon = torch.atan2(y, x)
    if with_radius:
        r = torch.sqrt(s2 + z * z)
        return r, lat, lon
    return lat, lon


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


def mat_entries(mat):
    """A host matrix as nested Python floats: a float takes the dtype of
    the tensor it multiplies, where a float64 tensor constant would
    promote a float32 chain to float64 silently. A tensor is indexed as
    it is."""
    if torch.is_tensor(mat):
        return mat
    return [[float(v) for v in row] for row in np.asarray(mat, dtype=np.float64)]


def apply_rotation(mat, x, y, z):
    """Apply a single 3x3 rotation to component tensors of any shape."""
    m = mat_entries(mat)
    xr = m[0][0] * x + m[0][1] * y + m[0][2] * z
    yr = m[1][0] * x + m[1][1] * y + m[1][2] * z
    zr = m[2][0] * x + m[2][1] * y + m[2][2] * z
    return xr, yr, zr


def apply_rotation_vecs(mat, vecs):
    """Apply a 3x3 rotation to an (..., 3) tensor of vectors (three
    multiply-adds per component, in the dtype of ``vecs``)."""
    return torch.stack(
        apply_rotation(mat, vecs[..., 0], vecs[..., 1], vecs[..., 2]), dim=-1)


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
    xr, yr, zr = apply_rotation(rot, x, y, z)
    return ecef_to_geodetic(xr, yr, zr, a, b)


def sm_lon_to_mlt(smlon_deg):
    """Solar-magnetic longitude (deg) -> magnetic local time (hours).

    Reference: auromat/coordinates/transform.py:373-386.
    """
    return smlon_deg * (24.0 / 360.0) + 12.0


def mlt_to_sm_lon(mlt_hours):
    """Magnetic local time (hours) -> solar-magnetic longitude (deg).

    Reference: auromat/coordinates/transform.py:388-401.
    """
    return (mlt_hours - 12.0) / (24.0 / 360.0)


def j2000_to_latlon(vecs, mat_j2000_to_geo, a=WGS84_A, b=WGS84_B):
    """Cartesian J2000 vectors (..., 3) -> geodetic (lat, lon) in degrees.

    ``mat_j2000_to_geo`` comes from frames.FrameMatrices (host).
    Reference: auromat/coordinates/transform.py:324-343.
    """
    gx, gy, gz = apply_rotation(mat_j2000_to_geo, vecs[..., 0], vecs[..., 1],
                                vecs[..., 2])
    lat, lon = ecef_to_geodetic(gx, gy, gz, a, b)
    return torch.rad2deg(lat), torch.rad2deg(lon)


def latlon_to_j2000(lat_deg, lon_deg, h, mat_j2000_to_geo, a=WGS84_A, b=WGS84_B):
    """Geodetic degrees + height -> cartesian J2000 (..., 3).

    Reference: auromat/coordinates/transform.py:345-371.
    """
    x, y, z = geodetic_to_ecef(torch.deg2rad(lat_deg), torch.deg2rad(lon_deg),
                               h, a, b)
    inv = (mat_j2000_to_geo.T if torch.is_tensor(mat_j2000_to_geo)
           else np.asarray(mat_j2000_to_geo).T)
    return torch.stack(apply_rotation(inv, x, y, z), dim=-1)


def _sm_vecs_to_mlat_mlt(sm):
    lat, lon = cartesian_to_spherical(sm[..., 0], sm[..., 1], sm[..., 2],
                                      with_radius=False)
    return torch.rad2deg(lat), sm_lon_to_mlt(torch.rad2deg(lon))


def j2000_to_mlat_mlt(vecs, mat_j2000_to_sm):
    """Cartesian J2000 (..., 3) -> (MLat deg, MLT hours).

    Reference: auromat/coordinates/transform.py:403-430.
    """
    return _sm_vecs_to_mlat_mlt(apply_rotation_vecs(mat_j2000_to_sm, vecs))


def geo_to_mlat_mlt(vecs, mat_geo_to_sm):
    """ECEF (..., 3) -> (MLat deg, MLT hours).

    Reference: auromat/coordinates/transform.py:432-459.
    """
    return _sm_vecs_to_mlat_mlt(apply_rotation_vecs(mat_geo_to_sm, vecs))


def geodetic_height(x, y, z, lat, a=WGS84_A, b=WGS84_B):
    """Height above the ellipsoid given a point and its geodetic latitude.

    Uses h = p cos(lat) + z sin(lat) - a sqrt(1 - e2 sin^2 lat), which is
    stable at all latitudes.
    """
    e2 = (a * a - b * b) / (a * a)
    p = torch.sqrt(x * x + y * y)
    sin_lat = torch.sin(lat)
    return (p * torch.cos(lat) + z * sin_lat
            - a * torch.sqrt(1.0 - e2 * sin_lat * sin_lat))


def sm_to_latlon(smlat_deg, smlon_deg, mat_sm_to_geo, altitude=0.0,
                 a=WGS84_A, b=WGS84_B):
    """Solar-magnetic spherical degrees -> geodetic degrees.

    Inverse of :func:`geo_to_mlat_mlt` composed with
    :func:`geodetic_to_ecef` at ``altitude``: the SM angles define a ray from
    the Earth's centre; the returned geodetic coordinates are the point on
    that ray at geodetic height ``altitude`` (found with two Newton steps,
    accurate to <1e-9 km).

    Deviation from the reference: auromat/coordinates/transform.py:461-485
    evaluates Bowring on the *unit-radius* point, which is not the inverse of
    its own forward conversion (geodetic lat of a point 1 km from the Earth's
    centre saturates near +-89 deg) and breaks the reference's own
    resampleMLatMLT -> mLatMlt plate-carree round trip. Intersecting the ray
    at the mapping altitude restores the intended semantics.
    """
    x, y, z = spherical_to_cartesian(
        None, torch.deg2rad(smlat_deg), torch.deg2rad(smlon_deg))
    gx, gy, gz = apply_rotation(mat_sm_to_geo, x, y, z)  # unit direction in GEO
    ai, bi = a + altitude, b + altitude
    t = 1.0 / torch.sqrt((gx / ai) ** 2 + (gy / ai) ** 2 + (gz / bi) ** 2)
    lat = lon = None
    for _ in range(2):
        px, py, pz = t * gx, t * gy, t * gz
        lat, lon = ecef_to_geodetic(px, py, pz, a, b)
        h0 = geodetic_height(px, py, pz, lat, a, b)
        t = t + (altitude - h0)
    return torch.rad2deg(lat), torch.rad2deg(lon)


def wrap_longitude(lon_deg):
    """Wrap a degree tensor into [-180, 180) (Angle.wrap_at(180 deg)
    equivalent), on its device."""
    return torch.remainder(lon_deg + 180.0, 360.0) - 180.0


def unit_vectors(vecs, dim=-1):
    """Normalize vectors along a dimension."""
    return vecs / torch.linalg.norm(vecs, dim=dim, keepdim=True)


def angle_between(v1, v2, dim=-1):
    """Angle in radians between unit-vector tensors, clipped into [0, pi].

    Reference: auromat/utils.py:38-46.
    """
    return torch.acos(torch.clip(torch.sum(v1 * v2, dim=dim), -1.0, 1.0))
