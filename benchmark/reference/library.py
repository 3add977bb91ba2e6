"""The public library slice by the original auromat's definitions: a
Mapping (corner and centre coordinates, elevation, the masks made
consistent) and its 'mean' resampling onto the global grid at a spherical
resolution, uint8 means rounded half to even."""

import math

import numpy as np
import torch

from benchmark.reference.georef import georef, pixel_rows
from benchmark.reference.grid import add_samples, cells, fixed_grid

BLOCK_ROWS = 256
WGS84_F = 1.0 / 298.257223563


def _frame(cal, altitude, device, corners, dtype):
    outs = ([], [], [])
    height = cal.height + (1 if corners else 0)
    for r0 in range(0, height, BLOCK_ROWS):
        rows = min(BLOCK_ROWS, height - r0)
        px, py = pixel_rows(cal, r0, rows, device, dtype, corners=corners)
        for acc, v in zip(outs, georef(cal, altitude, px, py, dtype)):
            acc.append(v.double().cpu())
    return [torch.cat(a).numpy() for a in outs]


def sanitize(corner_mask, center_mask):
    """Masks made consistent (True = masked): corners with no kept centre
    around them, then centres with any masked corner, then the first rule
    again (the original auromat's mask fixpoint)."""
    h, w = center_mask.shape

    def lonely(zm):
        pad = np.ones((h + 2, w + 2), dtype=bool)
        pad[1:-1, 1:-1] = zm
        return pad[:-1, :-1] & pad[:-1, 1:] & pad[1:, :-1] & pad[1:, 1:]

    cm = corner_mask | lonely(center_mask)
    zm = center_mask | cm[:-1, :-1] | cm[:-1, 1:] | cm[1:, :-1] | cm[1:, 1:]
    return cm | lonely(zm), zm


def mapping(cal, altitude, device, dtype=torch.float64):
    """The Mapping's arrays (host float64 and bool masks)."""
    lats, lons, _ = _frame(cal, altitude, device, True, dtype)
    lats_c, lons_c, elev = _frame(cal, altitude, device, False, dtype)
    cm = np.isnan(lats) | np.isnan(lons)
    zm = np.isnan(lats_c) | np.isnan(lons_c) | np.isnan(elev)
    cm, zm = sanitize(cm, zm)
    return {"lats": lats, "lons": lons, "lats_center": lats_c,
            "lons_center": lons_c, "elevation": elev,
            "corner_mask": cm, "center_mask": zm}


def arc_deg(lat1, lon1, lat2, lon2):
    """Arc between two points on WGS84's auxiliary sphere, degrees (the
    Vincenty inverse problem's sigma), for points far from antipodal."""
    u1 = math.atan((1 - WGS84_F) * math.tan(math.radians(lat1)))
    u2 = math.atan((1 - WGS84_F) * math.tan(math.radians(lat2)))
    ell = math.radians(lon2 - lon1)
    lam = ell
    for _ in range(30):
        sl, cl = math.sin(lam), math.cos(lam)
        sin_s = math.hypot(math.cos(u2) * sl,
                           math.cos(u1) * math.sin(u2) - math.sin(u1) * math.cos(u2) * cl)
        cos_s = math.sin(u1) * math.sin(u2) + math.cos(u1) * math.cos(u2) * cl
        sigma = math.atan2(sin_s, cos_s)
        sin_a = math.cos(u1) * math.cos(u2) * sl / sin_s if sin_s else 0.0
        cos2_a = 1.0 - sin_a * sin_a
        cos_2sm = cos_s - 2 * math.sin(u1) * math.sin(u2) / cos2_a if cos2_a else 0.0
        c = WGS84_F / 16 * cos2_a * (4 + WGS84_F * (4 - 3 * cos2_a))
        lam = ell + (1 - c) * WGS84_F * sin_a * (
            sigma + c * sin_s * (cos_2sm + c * cos_s * (-1 + 2 * cos_2sm * cos_2sm)))
    return math.degrees(sigma)


def resample_grid(m, arcsec_per_px):
    """The target grid of a mapping: its bounding box (the kept corners'
    extremes; the reference refuses boxes across the date line or a pole)
    at ``arcsec_per_px``, lat/lon pixels per degree measured at the box's
    middle latitude."""
    keep = ~m["corner_mask"]
    la, lo = m["lats"][keep], m["lons"][keep]
    south, north, west, east = la.min(), la.max(), lo.min(), lo.max()
    if east - west > 180.0:
        raise ValueError("the reference resamples no box across the date line")
    deg_per_px = arcsec_per_px / 3600.0
    mid = (north + south) / 2
    lon_ppd = arc_deg(mid, west, mid, east) / deg_per_px / (east - west)
    return fixed_grid((1.0 / deg_per_px, lon_ppd), south, north, west, east)


def resample_mean(m, img, grid, device):
    """The resampled grid: corner and centre lattices, uint8 means, float64
    elevation means and the masks, as the resampled Mapping holds them."""
    keep = torch.from_numpy(~m["center_mask"].reshape(-1)).to(device)
    lat = torch.from_numpy(m["lats_center"].reshape(-1)).to(device)
    lon = torch.from_numpy(m["lons_center"].reshape(-1)).to(device)
    flat = torch.where(keep, cells(grid, lat, lon), -1)
    values = torch.cat([img.reshape(-1, 3).double().to(device),
                        torch.from_numpy(m["elevation"].reshape(-1)).to(device)[:, None]],
                       dim=1)
    count = torch.zeros(grid.n_cells, dtype=torch.float64, device=device)
    sums = torch.zeros(grid.n_cells, 4, dtype=torch.float64, device=device)
    add_samples(count, sums, flat, values)
    means = (sums / count[:, None]).cpu().numpy().reshape(grid.n_lat, grid.n_lon, 4)
    with np.errstate(invalid="ignore"):
        rgb = np.clip(np.round(means[..., :3]), 0, 255)
    rgb = np.where(np.isnan(rgb), 0, rgb).astype(np.uint8)
    lats, lons = grid.corners()
    lats_c, lons_c = grid.centres()
    cm, zm = sanitize(np.zeros(lats.shape, dtype=bool), np.isnan(means[..., 3]))
    return {"lats": lats, "lons": lons, "lats_center": lats_c, "lons_center": lons_c,
            "img": rgb, "elevation": means[..., 3], "corner_mask": cm, "center_mask": zm}
