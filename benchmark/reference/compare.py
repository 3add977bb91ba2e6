"""The numbers that decide ``correct``: what a program produced against the
reference, each a reading to hold against a limit (lower is better; NaN
reads as infinity, so it never passes)."""

import math

import numpy as np
import torch

INF = math.inf


def _num(x):
    x = float(x)
    return INF if math.isnan(x) else x


def grid_numbers(count_p, means_p, count_r, sums_r, n_lat, n_lon):
    """A mean grid against the reference's float64 sums.

    - ``samples_moved_pct``: the share of samples that sit in another cell
      than the reference's (half the summed count differences; rows past
      the grid, a band's padding, count in full);
    - ``cells_off_pct``: the share of occupied cells whose count or whose
      R, G or B sum (mean times count, rounded: the sums are integers)
      differs from the reference's;
    - ``elev_p99_deg``: the 99th percentile of the elevation-mean gap over
      the cells both sides occupy (a cell that gained or lost a sample at
      its edge moves its mean by a fraction of the elevation's change
      across it; a chain that misplaces samples or their elevation moves
      it by far more).

    :param count_p, means_p: the program's (rows, n_lon) and (rows, n_lon,
        4) with rows >= n_lat
    :param count_r, sums_r: the reference's (n_lat * n_lon,) and (.., 4)
    """
    if count_p.shape[0] < n_lat or tuple(count_p.shape[1:]) != (n_lon,) \
            or tuple(means_p.shape) != tuple(count_p.shape) + (4,):
        return {"samples_moved_pct": INF, "cells_off_pct": INF, "elev_p99_deg": INF}
    cp_all = count_p.double()
    pad_count = cp_all[n_lat:].sum()
    pad_cells = (cp_all[n_lat:] != 0).sum()
    cp = cp_all[:n_lat].reshape(-1)
    mp = means_p[:n_lat].reshape(-1, 4).double()
    cr, sr = count_r.double(), sums_r.double()
    rgb_p = torch.where(cp[:, None] > 0, torch.round(mp[:, :3] * cp[:, None]), 0.0)
    moved = (cp - cr).abs().sum() + pad_count
    occupied = (cp != 0) | (cr > 0)
    off = (cp != cr) | (rgb_p != sr[:, :3]).any(dim=1)  # NaN != anything
    n_occ = occupied.sum() + pad_cells
    both = (cp > 0) & (cr > 0)
    elev_gap = torch.nan_to_num((mp[:, 3] - sr[:, 3] / cr.clamp(min=1)).abs()[both],
                                nan=INF)
    return {
        "samples_moved_pct": _num(100.0 * moved / (2.0 * cr.sum())),
        "cells_off_pct": _num(100.0 * ((off & occupied).sum() + pad_cells)
                              / n_occ.clamp(min=1)),
        "elev_p99_deg": _num(torch.quantile(elev_gap, 0.99)) if both.any() else INF,
    }


def mapping_numbers(prog, ref):
    """A Mapping's arrays against the reference's (host numpy):
    ``map_coord_err_deg`` the widest lat/lon gap at corners and centres
    that both keep, ``map_elev_err_deg`` the widest elevation gap at
    centres both keep, and ``map_mask_off`` the corner and centre mask
    entries that differ."""
    if prog["lats"].shape != ref["lats"].shape:
        return {"map_coord_err_deg": INF, "map_elev_err_deg": INF, "map_mask_off": INF}
    cm = prog["corner_mask"] | ref["corner_mask"]
    zm = prog["center_mask"] | ref["center_mask"]
    coord = 0.0
    for key, masked in (("lats", cm), ("lons", cm), ("lats_center", zm),
                        ("lons_center", zm)):
        d = np.abs(prog[key] - ref[key])[~masked]
        coord = max(coord, _num(d.max()) if d.size else 0.0)
    de = np.abs(prog["elevation"] - ref["elevation"])[~zm]
    off = ((prog["corner_mask"] != ref["corner_mask"]).sum()
           + (prog["center_mask"] != ref["center_mask"]).sum())
    return {"map_coord_err_deg": coord,
            "map_elev_err_deg": _num(de.max()) if de.size else 0.0,
            "map_mask_off": float(off)}


def resampled_numbers(prog, ref):
    """A resampled grid against the reference's: ``grid_cells_off`` the
    cells whose mask or any uint8 channel differs (every cell where the
    grids' shapes or coordinates differ), ``grid_elev_err_deg`` the widest
    elevation gap over cells both keep."""
    n = ref["img"].shape[0] * ref["img"].shape[1]
    if prog["img"].shape != ref["img"].shape or prog["lats"].shape != ref["lats"].shape:
        return {"grid_cells_off": float(n), "grid_elev_err_deg": INF}
    grid_gap = max(float(np.abs(prog[k] - ref[k]).max()) for k in ("lats", "lons"))
    if not grid_gap < 1e-9:
        return {"grid_cells_off": float(n), "grid_elev_err_deg": INF}
    zp, zr = prog["center_mask"], ref["center_mask"]
    both = ~zp & ~zr
    off = (zp != zr) | (both & (prog["img"] != ref["img"]).any(axis=-1))
    de = np.abs(prog["elevation"] - ref["elevation"])[both]
    elev = INF if np.isnan(de).any() else (float(de.max()) if de.size else 0.0)
    return {"grid_cells_off": float(off.sum()), "grid_elev_err_deg": elev}
