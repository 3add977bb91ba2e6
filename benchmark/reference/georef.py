"""Per-pixel georeference in plain PyTorch: pixel -> sky -> emission shell
-> geodetic latitude, longitude and elevation.

Written from the definitions, not from the program: the TAN projection and
the native-to-celestial rotation of FITS WCS Paper II (Calabretta &
Greisen 2002, eqs. 2, 12, 54), the ray's intersection with WGS84 inflated
by the emission altitude, Bowring's geodetic latitude and the original
auromat's elevation (90 deg minus the angle between the reversed ray and
the intersection's position vector). Every operation runs in ``dtype`` on
the device of the pixel coordinates: float64 is the reference; a lower
precision is the control that a comparison has to fail.
"""

import math

import torch

from benchmark.reference.frames import j2000_to_geo

WGS84_A = 6378.137  # km
WGS84_B = WGS84_A * (1.0 - 1.0 / 298.257223563)


def georef(cal, altitude, px, py, dtype=torch.float64):
    """lat, lon, elevation (degrees, NaN where the ray misses the shell) of
    0-based pixel-centre coordinates ``px``, ``py`` of frame ``cal``."""
    dev = px.device
    c = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    px, py = px.to(dtype), py.to(dtype)
    # intermediate world coordinates (degrees); FITS pixels count from 1
    dx = px + c(1.0 - cal.crpix[0])
    dy = py + c(1.0 - cal.crpix[1])
    (c11, c12), (c21, c22) = cal.cd
    x = c(c11) * dx + c(c12) * dy
    y = c(c21) * dx + c(c22) * dy
    # TAN: native longitude and latitude (Paper II eq. 12, 54)
    phi = torch.atan2(x, -y)
    theta = torch.atan2(c(180.0 / math.pi), torch.sqrt(x * x + y * y))
    # native -> celestial, the native pole at CRVAL (zenithal), phi_p = LONPOLE
    ra_p, dec_p = c(math.radians(cal.crval[0])), c(math.radians(cal.crval[1]))
    dphi = phi - c(math.radians(cal.lonpole))
    st, ct = torch.sin(theta), torch.cos(theta)
    ra = ra_p + torch.atan2(-ct * torch.sin(dphi),
                            st * torch.cos(dec_p) - ct * torch.sin(dec_p) * torch.cos(dphi))
    dec = torch.asin(torch.clamp(st * torch.sin(dec_p)
                                 + ct * torch.cos(dec_p) * torch.cos(dphi), -1.0, 1.0))
    vx, vy, vz = torch.cos(dec) * torch.cos(ra), torch.cos(dec) * torch.sin(ra), torch.sin(dec)
    # the ray from the camera meets the inflated ellipsoid (near root)
    a2, b2 = c((WGS84_A + altitude) ** 2), c((WGS84_B + altitude) ** 2)
    ox, oy, oz = (c(v) for v in cal.camera_pos)
    qa = (vx * vx + vy * vy) / a2 + vz * vz / b2
    qb = (ox * vx + oy * vy) / a2 + oz * vz / b2
    qc = (ox * ox + oy * oy) / a2 + oz * oz / b2 - 1.0
    root = torch.sqrt(qb * qb - qa * qc)  # NaN: the ray misses
    t = torch.where(qc > 0, -qb - root, -qb + root) / qa  # outside: near root
    t = torch.where(t >= 0, t, torch.nan)  # behind the camera
    ix, iy, iz = ox + t * vx, oy + t * vy, oz + t * vz
    # GEO, then Bowring's geodetic latitude on WGS84
    m = j2000_to_geo(cal.photo_time)
    gx = c(m[0, 0]) * ix + c(m[0, 1]) * iy + c(m[0, 2]) * iz
    gy = c(m[1, 0]) * ix + c(m[1, 1]) * iy + c(m[1, 2]) * iz
    gz = c(m[2, 0]) * ix + c(m[2, 1]) * iy + c(m[2, 2]) * iz
    a, b = WGS84_A, WGS84_B
    e2, ep2b = c((a * a - b * b) / (a * a)), c((a * a - b * b) / b)
    p = torch.sqrt(gx * gx + gy * gy)
    r = torch.sqrt(gx * gx + gy * gy + gz * gz)
    tan_u = c(b) * gz * (1.0 + ep2b / r) / (c(a) * p)
    cos_u = 1.0 / torch.sqrt(1.0 + tan_u * tan_u)
    sin_u = cos_u * tan_u
    lat = torch.atan((gz + ep2b * sin_u ** 3) / (p - e2 * c(a) * cos_u ** 3))
    lon = torch.atan2(gy, gx)
    # elevation: 90 deg minus the angle between -ray and the intersection
    cos_ang = -(vx * ix + vy * iy + vz * iz) / torch.sqrt(ix * ix + iy * iy + iz * iz)
    elev = 90.0 - torch.rad2deg(torch.acos(torch.clamp(cos_ang, -1.0, 1.0)))
    return torch.rad2deg(lat), torch.rad2deg(lon), elev


def pixel_rows(cal, row0, rows, device, dtype=torch.float64, corners=False):
    """(px, py) of ``rows`` rows from ``row0``: pixel centres, or with
    ``corners`` the (h+1, w+1) lattice of pixel corners (offset -0.5)."""
    off, extra = (-0.5, 1) if corners else (0.0, 0)
    xs = torch.arange(cal.width + extra, dtype=dtype, device=device) + off
    ys = torch.arange(row0, row0 + rows, dtype=dtype, device=device) + off
    return xs[None, :].expand(rows, -1), ys[:, None].expand(-1, xs.numel())
